"""The k-way move-gain wrapper: the tensors' device picks the kernel.

A CUDA tensor goes to the hand-written Hopper kernel
(``csrc/kway_gains.cu``, built by ``kernels._build``); a CPU tensor goes
to the plain version in ``ref.py``. There is no other switch and no
fallback: a failed build or launch raises. ``kway_gains.launches``
counts the CUDA launches, so a run can show that its path went through
the kernel.
"""
from __future__ import annotations

import torch

from .._build import load_extension, on_cuda
from .ref import kway_gains_ref

__all__ = ["kway_gains"]


def kway_gains(parts: torch.Tensor, own: torch.Tensor, *,
               k: int) -> torch.Tensor:
    """Move gains of a batch of boundary vertices.

    parts (B, L) int32 neighbour-partition tiles (-1 pad); own (B,)
    int32 current partitions (-1 for pad rows). Returns (B, k) float32
    gains as ``ref.kway_gains_ref`` defines them, bit for bit on either
    device.
    """
    if not on_cuda(parts, "kway_gains"):
        return kway_gains_ref(parts, own, k)
    out = load_extension().kway_gains(parts, own, int(k))
    kway_gains.launches += 1
    return out


kway_gains.launches = 0
