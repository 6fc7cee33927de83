"""The neighbour-aggregation wrappers: the tensors' device picks the kernel.

A CUDA tensor goes to the hand-written Hopper kernels
(``csrc/neighbor_agg.cu``, built by ``kernels._build``); a CPU tensor
goes to the plain versions in ``ref.py``. There is no other switch and
no fallback: a failed build or launch raises. ``neighbor_agg`` is
differentiable (a ``torch.autograd.Function``): its backward computes
``grad_w`` and ``grad_out @ w^T`` with ``torch.matmul``, as the JAX
model's autodiff leaves those products outside any Pallas kernel, and
``grad_x`` with ``neighbor_agg_bwd``, a deterministic kernel that the
JAX package lacks, over a ``SlotIndex`` of the valid slots grouped by
id: the caller may pass one it built with the neighbour matrix
(``models.gnn.in_neighbors`` does), else the backward builds it with
``transpose_index``. ``neighbor_agg.launches`` and
``neighbor_agg_bwd.launches`` count the CUDA launches, so a run can show
that its path went through the kernels.

``neighbor_agg_csr`` (row 5d) is the same function over a CSR of the
rows' neighbours, at any degree: on the card the backward kernel's heavy
pass gives the mean of each row of more than 32 slots (chunk units over
many warps), then a tile kernel sums the other rows, divides by the
count and multiplies each 64-row tile by ``w`` on the tensor cores. Its
backward is row 5's, over the by-source ``SlotIndex`` that
``csr_transpose_index`` builds. ``neighbor_agg_csr.launches`` counts its
calls on the card.

``segment_sum`` (row 5c) is the backward's sum mode over an edge list
(each edge a bag of one slot), on a kernel of its own
(``csrc/segment_sum.cu``: one walk of each warp's edges at any D, with
the widest loads the rows' alignment allows, and no memset): the GNN
archs' sums of messages by an edge index, deterministic where
``index_add_`` adds with float atomics on the card. With ``gather_rows``
(``h[src]``, whose gradient is such a sum) it keeps a GNN training step
free of float atomics; ``segment_sum.launches`` counts its launches.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .._build import load_extension, on_cuda
from .ref import (CHUNK, acc_dtype, neighbor_agg_bwd_ref,
                  neighbor_agg_csr_bwd_ref, neighbor_mean_csr_ref,
                  neighbor_mean_ref)

__all__ = ["SlotIndex", "bwd_args_ok", "chunk_units", "csr_transpose_index",
           "gather_rows", "launch_bwd", "launch_csr", "neighbor_agg",
           "neighbor_agg_bwd", "neighbor_agg_csr", "segment_index",
           "segment_sum", "transpose_index"]

DTYPES = (torch.float32, torch.bfloat16)
# the plain version also takes float64 (torch.autograd.gradcheck)
CPU_DTYPES = DTYPES + (torch.float64,)


class SlotIndex(NamedTuple):
    """The valid slots of a neighbour matrix (B, K) grouped by id, for
    the backward kernel: ``rows[rowptr[u]:rowptr[u + 1]]`` holds the b of
    every slot (b, j) naming id u, in (b, j) order. An id with more than
    ``CHUNK`` slots is split: its chunks (``ref.py``'s order) are units
    ``hptr[u]`` .. ``hptr[u + 1] - 1`` of a list that the card sums on
    many warps, and ``hunit`` maps each unit back to its id."""
    cnt: torch.Tensor     # (B,) int32: valid slots of each row
    rowptr: torch.Tensor  # (n_rows + 1,) int64
    rows: torch.Tensor    # int32, at least rowptr[n_rows] entries
    hptr: torch.Tensor    # (n_rows + 1,) int64: each id's first unit
    hunit: torch.Tensor   # int32, at least hptr[n_rows] entries: unit -> id


def chunk_units(rowptr: torch.Tensor, max_slots: int):
    """``(hptr, hunit)`` of a ``SlotIndex`` from its ``rowptr``, in torch
    ops on rowptr's device and with no sync: ``max_slots``, a host-known
    bound on the valid slots, sizes ``hunit``. An id of n > CHUNK slots
    has ceil(n / CHUNK) < 2 n / CHUNK units, so 2 max_slots // CHUNK
    entries always hold them; the entries past ``hptr[n_rows]`` name
    ``n_rows`` and are never read."""
    count = rowptr[1:] - rowptr[:-1]
    units = torch.where(count > CHUNK, (count + CHUNK - 1) // CHUNK, 0)
    hptr = torch.zeros_like(rowptr)
    torch.cumsum(units, 0, out=hptr[1:])
    cap = torch.arange(2 * max_slots // CHUNK, dtype=hptr.dtype,
                       device=hptr.device)
    hunit = torch.searchsorted(hptr, cap, right=True) - 1
    return hptr, hunit.to(torch.int32)


def transpose_index(nbrs: torch.Tensor, n_rows: int) -> SlotIndex:
    """The ``SlotIndex`` of ``nbrs`` (B, K): a stable sort of its valid
    slots by id, in torch ops on the tensor's device (``nonzero`` syncs
    once)."""
    K = nbrs.shape[1]
    flat = nbrs.reshape(-1)
    pos = (flat >= 0).nonzero().squeeze(1)
    ids, perm = torch.sort(flat[pos], stable=True)
    rows = torch.div(pos[perm], K, rounding_mode="floor").to(torch.int32)
    rowptr = torch.searchsorted(
        ids, torch.arange(n_rows + 1, dtype=ids.dtype, device=ids.device))
    return SlotIndex((nbrs >= 0).sum(1, dtype=torch.int32), rowptr, rows,
                     *chunk_units(rowptr, pos.numel()))


def csr_transpose_index(indptr: torch.Tensor, indices: torch.Tensor,
                        n_rows: int) -> SlotIndex:
    """The ``SlotIndex`` of a CSR (row b's neighbours ``indices[indptr[b]:
    indptr[b + 1]]``, entries past ``indptr[B]`` ignored): its slots
    grouped by id in (b, slot) order, the counts ``indptr[b + 1] -
    indptr[b]``; in torch ops on the tensors' device with no sync (one
    stable sort; the chunk units sized by ``indices``' length). It equals
    ``transpose_index`` of the padded matrix of the same rows."""
    E = indices.shape[0]
    pos = torch.arange(E, dtype=indptr.dtype, device=indptr.device)
    row = torch.searchsorted(indptr, pos, right=True) - 1
    key = torch.where(pos < indptr[-1], indices.long(), n_rows)
    skey, order = torch.sort(key, stable=True)
    rowptr = torch.searchsorted(skey, torch.arange(
        n_rows + 1, dtype=skey.dtype, device=skey.device))
    return SlotIndex((indptr[1:] - indptr[:-1]).to(torch.int32), rowptr,
                     row[order].to(torch.int32), *chunk_units(rowptr, E))


def bwd_args_ok(name: str, g: torch.Tensor, nbrs: torch.Tensor,
                dtype: torch.dtype) -> bool:
    """Check the backward's arguments; True for the card's route."""
    if g.dim() != 2 or nbrs.dim() != 2 or g.shape[0] != nbrs.shape[0]:
        raise ValueError(f"{name} takes g (B, D) and ids (B, K), got "
                         f"{tuple(g.shape)} and {tuple(nbrs.shape)}")
    if not on_cuda(g, name):
        if g.dtype != acc_dtype(dtype) or dtype not in CPU_DTYPES:
            raise ValueError(f"g must be {acc_dtype(dtype)} for a {dtype} "
                             f"result, got {g.dtype}")
        return False
    if g.dtype != torch.float32 or dtype not in DTYPES:
        raise ValueError(f"on the card g must be float32 and dtype one of "
                         f"{DTYPES}, got {g.dtype} and {dtype}")
    return True


def launch_bwd(g: torch.Tensor, nbrs: torch.Tensor, n_rows: int,
               dtype: torch.dtype, index: SlotIndex | None,
               mean: bool) -> torch.Tensor:
    """One launch of the backward kernel on the card, dividing each slot
    by its row's count (``mean``) or not (the EmbeddingBag's ``sum``);
    the wrapper that calls it counts it."""
    return load_extension().neighbor_agg_bwd(
        g.contiguous(), *(index or transpose_index(nbrs, n_rows)),
        dtype == torch.bfloat16, mean)


def neighbor_agg_bwd(g: torch.Tensor, nbrs: torch.Tensor, n_rows: int,
                     dtype: torch.dtype = torch.float32,
                     index: SlotIndex | None = None) -> torch.Tensor:
    """The gradient of x through the neighbour mean: g (B, D) float32
    (``grad_out @ w^T``; float64 on the CPU), nbrs (B, K) int32 with -1
    pad. Returns (n_rows, D) in ``dtype``: ``sum of g[b] /
    max(count_b, 1)`` over the valid slots (b, j) of each id, added in
    the chunk order that ``ref.neighbor_agg_bwd_ref`` defines. ``index``
    is ``transpose_index(nbrs, n_rows)`` when given (the card's route
    reads it; the plain version does not need it). The result is the
    same bits on every run and on either device."""
    if not bwd_args_ok("neighbor_agg_bwd", g, nbrs, dtype):
        return neighbor_agg_bwd_ref(g, nbrs, n_rows).to(dtype)
    out = launch_bwd(g, nbrs, n_rows, dtype, index, True)
    neighbor_agg_bwd.launches += 1
    return out


neighbor_agg_bwd.launches = 0


class _NeighborAgg(torch.autograd.Function):
    """``mean(x[nbrs valid]) @ w`` with its gradient for x and w."""

    @staticmethod
    def forward(ctx, x, nbrs, w, index):
        want_mean = ctx.needs_input_grad[2]
        if on_cuda(x, "neighbor_agg"):
            out, mean = load_extension().neighbor_agg(x, nbrs, w, want_mean)
            neighbor_agg.launches += 1
        else:
            mean, _ = neighbor_mean_ref(x, nbrs)
            out = (mean @ w.to(mean.dtype)).to(x.dtype)
        ctx.save_for_backward(nbrs, w, mean if want_mean else None)
        ctx.n_rows, ctx.x_dtype, ctx.index = x.shape[0], x.dtype, index
        return out

    @staticmethod
    def backward(ctx, grad_out):
        nbrs, w, mean = ctx.saved_tensors
        dt = acc_dtype(ctx.x_dtype)
        g = grad_out.to(dt)
        grad_x = grad_w = None
        if ctx.needs_input_grad[2]:
            grad_w = (mean.t() @ g).to(w.dtype)
        if ctx.needs_input_grad[0]:
            grad_x = neighbor_agg_bwd(g @ w.to(dt).t(), nbrs, ctx.n_rows,
                                      ctx.x_dtype, ctx.index)
        return grad_x, None, grad_w, None


def launch_csr(x: torch.Tensor, indptr: torch.Tensor,
               indices: torch.Tensor, w: torch.Tensor,
               units: tuple[torch.Tensor, torch.Tensor] | None = None):
    """Row 5d on the card: a memset of the tickets, the heavy pass (the
    means of the rows of more than 32 slots, their chunk units over many
    warps) and the tile kernel (the other rows' means, then every 64-row
    tile times ``w`` on the tensor cores). ``units`` is
    ``chunk_units(indptr, indices.shape[0])`` (built here when not given).
    Returns ``(out, mean)``; the wrapper that calls it counts it."""
    return load_extension().neighbor_agg_csr(
        x, indptr, indices, *(units or chunk_units(indptr, indices.shape[0])),
        w)


class _NeighborAggCSR(torch.autograd.Function):
    """Row 5d, ``mean(x[indices[indptr[b]:indptr[b + 1]]]) @ w``, with its
    gradient for x and w (row 5's backward over the by-source index)."""

    @staticmethod
    def forward(ctx, x, indptr, indices, w, index, units):
        want_mean = ctx.needs_input_grad[3]
        if on_cuda(x, "neighbor_agg_csr"):
            out, mean = launch_csr(x, indptr, indices, w, units)
            neighbor_agg_csr.launches += 1
        else:
            mean, _ = neighbor_mean_csr_ref(x, indptr, indices)
            out = (mean @ w.to(mean.dtype)).to(x.dtype)
        ctx.save_for_backward(indptr, indices, w,
                              mean if want_mean else None)
        ctx.n_rows, ctx.x_dtype, ctx.index = x.shape[0], x.dtype, index
        return out

    @staticmethod
    def backward(ctx, grad_out):
        indptr, indices, w, mean = ctx.saved_tensors
        dt = acc_dtype(ctx.x_dtype)
        g = grad_out.to(dt)
        grad_x = grad_w = None
        if ctx.needs_input_grad[3]:
            grad_w = (mean.t() @ g).to(w.dtype)
        if ctx.needs_input_grad[0]:
            gw = g @ w.to(dt).t()
            if not on_cuda(gw, "neighbor_agg_csr"):
                grad_x = neighbor_agg_csr_bwd_ref(gw, indptr, indices,
                                                  ctx.n_rows)
            else:
                index = ctx.index or csr_transpose_index(indptr, indices,
                                                         ctx.n_rows)
                grad_x = load_extension().neighbor_agg_bwd(
                    gw.contiguous(), *index, False, True)
                neighbor_agg_bwd.launches += 1
        return grad_x, None, None, grad_w, None, None


def neighbor_agg_csr(x: torch.Tensor, indptr: torch.Tensor,
                     indices: torch.Tensor, w: torch.Tensor,
                     index: SlotIndex | None = None,
                     units: tuple[torch.Tensor, torch.Tensor] | None = None
                     ) -> torch.Tensor:
    """Row 5d: ``neighbor_agg`` over a CSR of the rows' neighbours, at any
    degree. x (N, D) float32 (float64 too on the CPU); indptr (B + 1)
    int64 from 0, non-decreasing; indices int32 ids in [0, N), at least
    ``indptr[B]`` of them (the rest ignored); w (D, F) float32 or
    bfloat16 (float64 too on the CPU); all contiguous on one device.
    Returns (B, F) in x's dtype: each row's float32 mean times ``w`` in
    float32, 0 for a row with no slot. The mean adds a row's slots in
    ``ref.py``'s chunk order (a row of at most 32 slots in slot order from
    0, bit-equal to ``neighbor_agg``'s mean of the same row; a longer one
    in chunks of 32, the partials in chunk order) and divides once by the
    count; the card's mean equals ``ref.neighbor_mean_csr_ref`` bit for
    bit, and its product (float32 precision from two TF32 products, three
    for a float32 w) agrees with the plain matmul within float32
    rounding. Differentiable in x and w: grad_w is ``mean^T g`` (kept
    float32 mean), grad_x row 5b's mean mode over ``index``, the
    by-source ``csr_transpose_index(indptr, indices, N)``, and ``units``
    the forward's ``chunk_units(indptr, indices.shape[0])`` (each built
    here when not given; ``models.gnn.in_neighbors_csr`` builds both once
    for every layer). No host sync.

    On the card a call makes two kernel launches, the heavy pass (a
    memset of its tickets first; neither when ``units`` has no entry) and
    the tile kernel, and counts one in ``neighbor_agg_csr.launches``; its
    backward (row 5b: the heavy and the light pass) counts one in
    ``neighbor_agg_bwd.launches``. The tile kernel keeps w's panel and a
    tile of means in shared memory, which bounds D (at F >= 128 on an
    H100, about 430 for a bfloat16 w and 280 for a float32 w; past it the
    call raises). An id at or above N is not looked for.
    """
    if x.dim() != 2 or w.dim() != 2 or indptr.dim() != 1 or \
            indices.dim() != 1:
        raise ValueError(f"neighbor_agg_csr takes x (N, D), indptr (B + 1,),"
                         f" indices (E,) and w (D, F), got {tuple(x.shape)},"
                         f" {tuple(indptr.shape)}, {tuple(indices.shape)} "
                         f"and {tuple(w.shape)}")
    if w.shape[0] != x.shape[1]:
        raise ValueError(f"w must be (D, F) with D = {x.shape[1]}, got "
                         f"{tuple(w.shape)}")
    if indptr.dtype != torch.int64 or indices.dtype != torch.int32:
        raise ValueError(f"indptr must be int64 and indices int32, got "
                         f"{indptr.dtype} and {indices.dtype}")
    if indptr.numel() < 1:
        raise ValueError("indptr must hold B + 1 offsets")
    card = on_cuda(x, "neighbor_agg_csr")
    x_ok = (torch.float32,) if card else (torch.float32, torch.float64)
    w_ok = DTYPES if card else CPU_DTYPES
    if x.dtype not in x_ok or w.dtype not in w_ok:
        raise ValueError(f"x must be one of {x_ok} and w one of {w_ok}, "
                         f"got {x.dtype} and {w.dtype}")
    if not all(t.is_contiguous() for t in (x, indptr, indices, w)):
        raise ValueError("x, indptr, indices and w must be contiguous")
    if not (x.device == indptr.device == indices.device == w.device):
        raise ValueError(f"x, indptr, indices and w must share one device, "
                         f"got {x.device}, {indptr.device}, "
                         f"{indices.device} and {w.device}")
    return _NeighborAggCSR.apply(x, indptr, indices, w, index, units)


neighbor_agg_csr.launches = 0


def segment_index(ids: torch.Tensor, n_rows: int) -> SlotIndex:
    """The ``SlotIndex`` of ``ids`` (E,) int32 taken as E bags of one slot
    (-1 a skipped edge): a stable sort of the edges by id, so each id's
    edges stay in edge order, in torch ops on the ids' device and with no
    sync (the offsets by ``searchsorted``, the chunk units sized by E)."""
    E = ids.shape[0]
    valid = ids >= 0
    key = torch.where(valid, ids.long(), n_rows)    # skipped edges last
    skey, order = torch.sort(key, stable=True)
    rowptr = torch.searchsorted(skey, torch.arange(
        n_rows + 1, dtype=skey.dtype, device=skey.device))
    return SlotIndex(valid.to(torch.int32), rowptr, order.to(torch.int32),
                     *chunk_units(rowptr, E))


def _segment_sum(msgs: torch.Tensor, ids: torch.Tensor, n_rows: int,
                 index: SlotIndex | None) -> torch.Tensor:
    """``segment_sum`` without its gradient: one launch of its kernel
    (``csrc/segment_sum.cu``) on the card, counted; ``ref.py`` on the
    CPU."""
    slots = ids[:, None]
    if not bwd_args_ok("segment_sum", msgs, slots, msgs.dtype):
        return neighbor_agg_bwd_ref(msgs, slots, n_rows, mean=False)
    index = index or segment_index(ids, n_rows)
    out = load_extension().segment_sum(msgs, index.rowptr, index.rows,
                                       index.hptr, index.hunit)
    segment_sum.launches += 1
    return out


def _gather(g: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``g[ids]``, 0 where an id is -1: the gradient of a segment sum."""
    rows = g.index_select(0, ids.clamp_min(0).long())
    return torch.where((ids >= 0)[:, None], rows, torch.zeros_like(rows))


class _SegmentSum(torch.autograd.Function):
    """``segment_sum`` with its gradient, the gather ``g[ids]``."""

    @staticmethod
    def forward(ctx, msgs, ids, n_rows, index):
        ctx.save_for_backward(ids)
        return _segment_sum(msgs, ids, n_rows, index)

    @staticmethod
    def backward(ctx, grad_out):
        ids, = ctx.saved_tensors
        return _gather(grad_out.contiguous(), ids), None, None, None


class _GatherRows(torch.autograd.Function):
    """``h[rows]`` with its gradient, ``segment_sum`` by ``ids``."""

    @staticmethod
    def forward(ctx, h, rows, ids, index):
        ctx.save_for_backward(ids)
        ctx.n_rows, ctx.index = h.shape[0], index
        return h.index_select(0, rows)

    @staticmethod
    def backward(ctx, grad_out):
        ids, = ctx.saved_tensors
        return (_segment_sum(grad_out.contiguous(), ids, ctx.n_rows,
                             ctx.index), None, None, None)


def _check_ids(name: str, x: torch.Tensor, ids: torch.Tensor) -> None:
    if x.dim() != 2 or ids.dim() != 1:
        raise ValueError(f"{name} takes a (rows, D) tensor and ids (E,), "
                         f"got {tuple(x.shape)} and {tuple(ids.shape)}")
    if ids.dtype != torch.int32:
        raise ValueError(f"ids must be int32, got {ids.dtype}")
    if x.device != ids.device:
        raise ValueError(f"{name}'s tensors must share one device, got "
                         f"{x.device} and {ids.device}")


def segment_sum(msgs: torch.Tensor, ids: torch.Tensor, n_rows: int,
                index: SlotIndex | None = None) -> torch.Tensor:
    """``jax.ops.segment_sum(msgs, ids, n_rows)`` over the edges whose id
    is not -1: msgs (E, D) float32 (float64 too on the CPU), ids (E,)
    int32 in [-1, n_rows). Returns (n_rows, D) in msgs' dtype. Each edge
    is a bag of one slot, so this is the backward's sum mode
    (``neighbor_agg_bwd`` without the division): each id's edges added in
    the chunk order of ``ref.py``, with no atomics, the same bits on
    every run and on either device, at any D (on the card one launch of
    ``csrc/segment_sum.cu``). ``index``, when given, is
    ``segment_index(ids, n_rows)``. Differentiable in msgs: the gradient
    is ``g[ids]``, 0 for a skipped edge. ``segment_sum.launches`` counts
    the card's launches, those of ``gather_rows``' backward too."""
    _check_ids("segment_sum", msgs, ids)
    if msgs.shape[0] != ids.shape[0]:
        raise ValueError(f"msgs has {msgs.shape[0]} rows for "
                         f"{ids.shape[0]} ids")
    return _SegmentSum.apply(msgs.contiguous(), ids, n_rows, index)


segment_sum.launches = 0


def gather_rows(h: torch.Tensor, rows: torch.Tensor, ids: torch.Tensor,
                index: SlotIndex | None = None) -> torch.Tensor:
    """``h[rows]`` (E, D) for rows (E,) int64 ids in [0, N), whose
    gradient is ``segment_sum(g, ids, N, index)``: ids (E,) int32 equal
    to ``rows`` but -1 on the edges whose gradient the caller knows to be
    zero (masked edges, whose every use ends in a product with their
    mask), which the sum then skips. No float atomics either way."""
    _check_ids("gather_rows", h, ids)
    return _GatherRows.apply(h, rows, ids, index)


def neighbor_agg(x: torch.Tensor, nbrs: torch.Tensor, w: torch.Tensor,
                 index: SlotIndex | None = None) -> torch.Tensor:
    """x (N, D) and w (D, F), each float32 or bfloat16; nbrs (B, K) int32
    ids in [-1, N), -1 a pad slot; all contiguous on one device. Returns
    (B, F) in ``x.dtype``: the float32 mean of each row's valid
    neighbours (0 for an all-pad row) times ``w`` in float32, as
    ``ref.neighbor_agg_ref`` defines it for a finite ``w``. Differentiable
    in x and w; the gradient of w comes in ``w.dtype``; ``index``, when
    given, is ``transpose_index(nbrs, N)`` for the backward. On the CPU,
    x and w may also be float64 (summed in float64).

    Only dtype and shape are checked: an id at or above N is not looked
    for, since that would cost a device sync.
    """
    if x.dim() != 2 or w.dim() != 2 or nbrs.dim() != 2:
        raise ValueError(f"neighbor_agg takes x (N, D), nbrs (B, K) and w "
                         f"(D, F), got {tuple(x.shape)}, {tuple(nbrs.shape)}"
                         f" and {tuple(w.shape)}")
    if w.shape[0] != x.shape[1]:
        raise ValueError(f"w must be (D, F) with D = {x.shape[1]}, got "
                         f"{tuple(w.shape)}")
    if nbrs.dtype != torch.int32:
        raise ValueError(f"nbrs must be int32, got {nbrs.dtype}")
    ok = DTYPES if on_cuda(x, "neighbor_agg") else CPU_DTYPES
    if x.dtype not in ok or w.dtype not in ok:
        raise ValueError(f"x and w must be one of {ok}, got {x.dtype} "
                         f"and {w.dtype}")
    if not (x.is_contiguous() and nbrs.is_contiguous()
            and w.is_contiguous()):
        raise ValueError("x, nbrs and w must be contiguous")
    if not (x.device == nbrs.device == w.device):
        raise ValueError(f"x, nbrs and w must share one device, got "
                         f"{x.device}, {nbrs.device} and {w.device}")
    return _NeighborAgg.apply(x, nbrs, w, index)


neighbor_agg.launches = 0
