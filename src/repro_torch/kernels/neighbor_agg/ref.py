"""Plain PyTorch version of the neighbour-aggregation kernel and of its
backward.

The same functions as ``csrc/neighbor_agg.cu`` in tensor ops: the CPU
path of ``ops.neighbor_agg`` and the yardstick the card's kernels are
compared with.

Forward, ``mean(x[nbrs >= 0]) @ w``: the mean walks the slots in order
j = 0..K-1 and adds each valid row into a float32 accumulator, as the
TPU kernel's body (``_agg_kernel``) and the CUDA kernel do, then divides
once by ``max(count, 1)``, so the mean equals the kernel's bit for bit.
The product with ``w`` (widened to float32) is one matmul here and a
sum in depth order in the kernel, so the output agrees within float32
rounding, then rounds once to ``x.dtype``.

Backward, for ``x``: ``grad_x[u] = sum of g[b] / max(count_b, 1)`` over
every valid slot (b, j) with ``nbrs[b, j] = u``, where ``g = grad_out @
w^T`` (``sum`` mode, the EmbeddingBag's gradient through a bag's
sum, leaves out the division), in a fixed order that the CUDA kernel
shares: id u's slots, in (b, j) order, are cut into chunks of
``CHUNK`` consecutive slots; each chunk is summed in order from 0.0,
and the chunk partials are added in chunk order from 0.0. An id with
at most ``CHUNK`` slots is one chunk, summed in (b, j) order.
``index_add_`` on the CPU adds in index order,
so the two ``index_add_`` calls below (slots into one partial row per
(id, chunk), then partials into the output) compute exactly that order,
and the kernel's result equals this one bit for bit. On the card
``index_add_`` adds with atomics, in an order that changes from run to
run: there this version is a yardstick of time, not of bits.

Row 5d (``neighbor_agg_csr``) is the same forward over a CSR of the
rows' neighbours: row b's are ``indices[indptr[b]:indptr[b + 1]]``, and
its mean sums them in the backward's chunk order, a row of at most
``CHUNK`` slots in slot order (so its mean is row 5's bit for bit).

A float64 input is summed in float64 (the CPU route only, for
``torch.autograd.gradcheck``); every other dtype in float32.
"""
from __future__ import annotations

import torch

# Slots per chunk of an id's slot list in the backward's summation order
# (``kChunk`` in csrc/neighbor_agg.cu).
CHUNK = 32


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulator's dtype: float64 for float64, else float32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def neighbor_mean_ref(x: torch.Tensor, nbrs: torch.Tensor):
    """x (N, D) float; nbrs (B, K) integer ids in [-1, N), -1 a pad slot.
    Returns ``(mean, count)``: the (B, D) float32 (float64 for a float64
    x) mean of the valid rows ``x[nbrs[b, j]]`` (0 for an all-pad row)
    and the (B,) int32 count of valid slots."""
    B, K = nbrs.shape
    dt = acc_dtype(x.dtype)
    acc = torch.zeros((B, x.shape[1]), dtype=dt, device=x.device)
    cnt = torch.zeros((B,), dtype=torch.int32, device=x.device)
    for j in range(K):
        ids = nbrs[:, j]
        valid = ids >= 0
        rows = x.index_select(0, ids.clamp_min(0).long())
        acc = torch.where(valid[:, None], acc + rows.to(dt), acc)
        cnt += valid
    return acc / cnt.clamp_min(1).to(dt)[:, None], cnt


def neighbor_agg_ref(x: torch.Tensor, nbrs: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    """x (N, D), nbrs (B, K) with -1 pad, w (D, F) -> (B, F) in
    ``x.dtype``: the float32 mean of each row's valid neighbours times
    ``w`` in float32, rounded once."""
    mean, _ = neighbor_mean_ref(x, nbrs)
    return (mean @ w.to(mean.dtype)).to(x.dtype)


def _chunk_sum(contrib: torch.Tensor, ids: torch.Tensor,
               n_rows: int) -> torch.Tensor:
    """(n_rows, D): row u the sum of the rows of ``contrib`` (S, D) whose
    id in ``ids`` (S,) int64, ascending, is u, in the chunk order of the
    module's docstring: u's rows, in their order in ``contrib``, cut into
    chunks of ``CHUNK``, each summed from 0, the partials added in chunk
    order from 0 (two ``index_add_`` calls, which add in index order on
    the CPU)."""
    count = torch.bincount(ids, minlength=n_rows)
    nchunk = (count + CHUNK - 1) // CHUNK
    rank = (torch.arange(ids.numel(), device=contrib.device)
            - (torch.cumsum(count, 0) - count)[ids])
    chunk = (torch.cumsum(nchunk, 0) - nchunk)[ids] + rank // CHUNK
    partial = torch.zeros((int(nchunk.sum()), contrib.shape[1]),
                          dtype=contrib.dtype, device=contrib.device
                          ).index_add_(0, chunk, contrib)
    owner = torch.repeat_interleave(
        torch.arange(n_rows, device=contrib.device), nchunk)
    out = torch.zeros((n_rows, contrib.shape[1]), dtype=contrib.dtype,
                      device=contrib.device)
    return out.index_add_(0, owner, partial)


def _slots_bwd(g: torch.Tensor, b: torch.Tensor, ids: torch.Tensor,
               denom: torch.Tensor | None, n_rows: int) -> torch.Tensor:
    """The backward over the valid slots listed in (b, j) order: slot s
    of row ``b[s]`` names id ``ids[s]``; ``g[b] / denom[b]`` (no
    division for a null ``denom``) summed by id in the chunk order."""
    ids, perm = torch.sort(ids.long(), stable=True)
    b = b[perm]
    contrib = g.index_select(0, b)
    if denom is not None:
        contrib = contrib / denom.index_select(0, b)[:, None]
    return _chunk_sum(contrib, ids, n_rows)


def neighbor_agg_bwd_ref(g: torch.Tensor, nbrs: torch.Tensor,
                         n_rows: int, mean: bool = True) -> torch.Tensor:
    """The gradient of ``x`` through the mean: g (B, D) float32 (the
    output's gradient times ``w^T``), nbrs (B, K). Returns (n_rows, D)
    float32, ``sum of g[b] / max(count_b, 1)`` over the valid slots of
    each row id, in the chunk order of the module's docstring. With
    ``mean=False`` (the gradient through a bag's sum) there is no
    division: ``sum of g[b]``, in the same order."""
    K = nbrs.shape[1]
    flat = nbrs.reshape(-1)
    pos = (flat >= 0).nonzero().squeeze(1)
    denom = ((nbrs >= 0).sum(1).clamp_min(1).to(g.dtype) if mean
             else None)
    return _slots_bwd(g, torch.div(pos, K, rounding_mode="floor"),
                      flat[pos], denom, n_rows)


# ---- row 5d: the same functions over a CSR of the rows' neighbours

def csr_rows(indptr: torch.Tensor) -> torch.Tensor:
    """The row of each of the ``indptr[-1]`` slots of a CSR, in order."""
    B = indptr.numel() - 1
    return torch.repeat_interleave(
        torch.arange(B, device=indptr.device), indptr[1:] - indptr[:-1])


def neighbor_mean_csr_ref(x: torch.Tensor, indptr: torch.Tensor,
                          indices: torch.Tensor):
    """x (N, D) float; row b's neighbours ``indices[indptr[b]:indptr[b +
    1]]``. Returns ``(mean, count)``: the (B, D) float32 (float64 for a
    float64 x) mean of each row's neighbours, summed in the chunk order
    (a row of at most ``CHUNK`` slots in slot order from 0, so equal bit
    for bit to ``neighbor_mean_ref`` of the same row; a longer row in
    chunks of ``CHUNK``, the partials in chunk order), then divided once
    by ``max(count, 1)``; 0 for a row with no slot. count is (B,) int64."""
    B = indptr.numel() - 1
    dt = acc_dtype(x.dtype)
    count = indptr[1:] - indptr[:-1]
    rows = csr_rows(indptr)
    contrib = x.index_select(0, indices[:rows.numel()].long()).to(dt)
    sums = _chunk_sum(contrib, rows, B)
    return sums / count.clamp_min(1).to(dt)[:, None], count


def neighbor_agg_csr_ref(x: torch.Tensor, indptr: torch.Tensor,
                         indices: torch.Tensor,
                         w: torch.Tensor) -> torch.Tensor:
    """Row 5d's plain version: (B, F) in ``x.dtype``, the mean of
    ``neighbor_mean_csr_ref`` times ``w`` in float32, rounded once."""
    mean, _ = neighbor_mean_csr_ref(x, indptr, indices)
    return (mean @ w.to(mean.dtype)).to(x.dtype)


def neighbor_agg_csr_bwd_ref(g: torch.Tensor, indptr: torch.Tensor,
                             indices: torch.Tensor,
                             n_rows: int) -> torch.Tensor:
    """The gradient of x through row 5d's mean: g (B, D) float32 (float64
    too), ``sum of g[b] / max(count_b, 1)`` over the slots naming each
    id, in (b, slot) order cut into chunks: ``neighbor_agg_bwd_ref`` of
    the padded matrix, bit for bit."""
    rows = csr_rows(indptr)
    denom = (indptr[1:] - indptr[:-1]).clamp_min(1).to(g.dtype)
    return _slots_bwd(g, rows, indices[:rows.numel()], denom, n_rows)
