"""The EmbeddingBag wrappers: the tensors' device picks the kernel.

A CUDA tensor goes to the hand-written Hopper kernel
(``csrc/embedding_bag.cu``, built by ``kernels._build``); a CPU tensor
goes to the plain version in ``ref.py``. There is no other switch and no
fallback: a failed build or launch raises. ``embedding_bag`` is
differentiable in the table (a ``torch.autograd.Function`` where a
gradient is recorded): its backward, ``embedding_bag_bwd``, runs the
neighbour aggregation's deterministic backward kernel
(``neighbor_agg/csrc/neighbor_agg.cu``) over ``transpose_index(ids, V)``,
in its ``sum`` mode for ``combine="sum"``. ``embedding_bag.launches``
counts the forward's CUDA launches and ``embedding_bag_bwd.launches``
the backward's, so a run can show that its path went through the
kernels.
"""
from __future__ import annotations

import torch

from .._build import load_extension, on_cuda
from ..neighbor_agg.ops import bwd_args_ok, launch_bwd
from ..neighbor_agg.ref import acc_dtype
from .ref import check_combine, embedding_bag_bwd_ref, embedding_bag_ref

__all__ = ["embedding_bag", "embedding_bag_bwd"]


def _forward(table: torch.Tensor, ids: torch.Tensor,
             combine: str) -> torch.Tensor:
    if not on_cuda(table, "embedding_bag"):
        return embedding_bag_ref(table, ids, combine)
    out = load_extension().embedding_bag(table, ids, combine == "mean")
    embedding_bag.launches += 1
    return out


class _EmbeddingBag(torch.autograd.Function):
    """``embedding_bag`` with the table's gradient (none for the ids)."""

    @staticmethod
    def forward(ctx, table, ids, combine):
        ctx.save_for_backward(ids)
        ctx.combine, ctx.V, ctx.dtype = combine, table.shape[0], table.dtype
        return _forward(table, ids, combine)

    @staticmethod
    def backward(ctx, grad_out):
        ids, = ctx.saved_tensors
        g = grad_out.to(acc_dtype(ctx.dtype))
        return (embedding_bag_bwd(g, ids, ctx.V, ctx.combine, ctx.dtype),
                None, None)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, *,
                  combine: str = "mean") -> torch.Tensor:
    """table (V, D) float32 or bfloat16; ids (B, bag) int32 in [-1, V)
    with -1 pad. Returns (B, D) in ``table.dtype`` as
    ``ref.embedding_bag_ref`` defines it, bit for bit on either device.
    Differentiable in the table; on the CPU the table may also be
    float64 (summed in float64).

    Only dtype and shape are checked: an id at or above V is not looked
    for, since that would cost a device sync.
    """
    check_combine(combine)
    if ids.dtype != torch.int32 or ids.dim() != 2 or table.dim() != 2:
        raise ValueError(
            f"embedding_bag takes a 2-D table and 2-D int32 ids, got "
            f"table {tuple(table.shape)} and ids {tuple(ids.shape)} "
            f"{ids.dtype}")
    if table.requires_grad and torch.is_grad_enabled():
        return _EmbeddingBag.apply(table, ids, combine)
    return _forward(table, ids, combine)


embedding_bag.launches = 0


def embedding_bag_bwd(g: torch.Tensor, ids: torch.Tensor, V: int,
                      combine: str = "mean",
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The table's gradient through ``embedding_bag``: g (B, D) float32
    (the output's gradient; float64 on the CPU), ids (B, bag) int32 with
    -1 pad. Returns (V, D) in ``dtype`` (float32 or bfloat16): ``grad[r]
    = sum of g[b] / max(count_b, 1)`` over the valid slots (b, j) with
    ``ids[b, j] = r`` (no division for ``sum``), added in the chunk
    order of ``ref.embedding_bag_bwd_ref`` with no float atomics, so the
    same bits on every run and on either device; 0 for a row no slot
    names."""
    check_combine(combine)
    if not bwd_args_ok("embedding_bag_bwd", g, ids, dtype):
        return embedding_bag_bwd_ref(g, ids, V, combine).to(dtype)
    out = launch_bwd(g, ids, V, dtype, None, combine == "mean")
    embedding_bag_bwd.launches += 1
    return out


embedding_bag_bwd.launches = 0
