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


def neighbor_agg_bwd_ref(g: torch.Tensor, nbrs: torch.Tensor,
                         n_rows: int, mean: bool = True) -> torch.Tensor:
    """The gradient of ``x`` through the mean: g (B, D) float32 (the
    output's gradient times ``w^T``), nbrs (B, K). Returns (n_rows, D)
    float32, ``sum of g[b] / max(count_b, 1)`` over the valid slots of
    each row id, in the chunk order of the module's docstring. With
    ``mean=False`` (the gradient through a bag's sum) there is no
    division: ``sum of g[b]``, in the same order."""
    B, K = nbrs.shape
    flat = nbrs.reshape(-1)
    pos = (flat >= 0).nonzero().squeeze(1)
    # the valid slots grouped by id, each id's in (b, j) order
    ids, perm = torch.sort(flat[pos].long(), stable=True)
    b = torch.div(pos[perm], K, rounding_mode="floor")
    contrib = g.index_select(0, b)
    if mean:
        denom = (nbrs >= 0).sum(1).clamp_min(1).to(g.dtype)
        contrib = contrib / denom.index_select(0, b)[:, None]
    count = torch.bincount(ids, minlength=n_rows)
    nchunk = (count + CHUNK - 1) // CHUNK
    rank = (torch.arange(ids.numel(), device=g.device)
            - (torch.cumsum(count, 0) - count)[ids])
    chunk = (torch.cumsum(nchunk, 0) - nchunk)[ids] + rank // CHUNK
    partial = torch.zeros((int(nchunk.sum()), g.shape[1]), dtype=g.dtype,
                          device=g.device).index_add_(0, chunk, contrib)
    owner = torch.repeat_interleave(
        torch.arange(n_rows, device=g.device), nchunk)
    out = torch.zeros((n_rows, g.shape[1]), dtype=g.dtype, device=g.device)
    return out.index_add_(0, owner, partial)
