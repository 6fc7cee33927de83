"""The EmbeddingBag wrapper: the tensors' device picks the kernel.

A CUDA tensor goes to the hand-written Hopper kernel
(``csrc/embedding_bag.cu``, built by ``kernels._build``); a CPU tensor
goes to the plain version in ``ref.py``. There is no other switch and no
fallback: a failed build or launch raises. ``embedding_bag.launches``
counts the CUDA launches, so a run can show that its path went through
the kernel.
"""
from __future__ import annotations

import torch

from .._build import load_extension, on_cuda
from .ref import COMBINES, embedding_bag_ref

__all__ = ["embedding_bag"]


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, *,
                  combine: str = "mean") -> torch.Tensor:
    """table (V, D) float32 or bfloat16; ids (B, bag) int32 in [-1, V)
    with -1 pad. Returns (B, D) in ``table.dtype`` as
    ``ref.embedding_bag_ref`` defines it, bit for bit on either device.

    Only dtype and shape are checked: an id at or above V is not looked
    for, since that would cost a device sync.
    """
    if combine not in COMBINES:
        raise ValueError(f"combine must be one of {COMBINES}, got "
                         f"{combine!r}")
    if ids.dtype != torch.int32 or ids.dim() != 2 or table.dim() != 2:
        raise ValueError(
            f"embedding_bag takes a 2-D table and 2-D int32 ids, got "
            f"table {tuple(table.shape)} and ids {tuple(ids.shape)} "
            f"{ids.dtype}")
    if not on_cuda(table, "embedding_bag"):
        return embedding_bag_ref(table, ids, combine)
    out = load_extension().embedding_bag(table, ids, combine == "mean")
    embedding_bag.launches += 1
    return out


embedding_bag.launches = 0
