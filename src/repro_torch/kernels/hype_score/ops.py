"""The scoring wrappers: the tensors' device picks the kernel.

A CUDA tensor goes to the hand-written Hopper kernel
(``csrc/score_select.cu`` and ``csrc/scores.cu``, built by
``kernels._build``); a CPU tensor goes to the plain version in
``ref.py``. There is no other switch and no fallback: a failed build or
launch raises. ``hype_score_select.launches`` and
``hype_scores.launches`` count the CUDA launches, so a run can show that
its path went through the kernels.
"""
from __future__ import annotations

import torch

from .._build import load_extension, on_cuda
from .ref import SELECT_PAD, hype_score_select_ref, hype_scores_ref

__all__ = ["SELECT_PAD", "hype_score_select", "hype_scores"]


def hype_scores(nbrs: torch.Tensor, fringe: torch.Tensor) -> torch.Tensor:
    """d_ext score per row of a (B, L) int32 tile (-1 pad) against one
    (s,) int32 fringe (-1 pad); returns (B,) int32 as
    ``ref.hype_scores_ref`` defines it, on either device."""
    if not on_cuda(nbrs, "hype_scores"):
        return hype_scores_ref(nbrs, fringe)
    out = load_extension().scores(nbrs, fringe)
    hype_scores.launches += 1
    return out


def hype_score_select(nbrs: torch.Tensor, fringe: torch.Tensor,
                      bias: torch.Tensor, prev: torch.Tensor, *,
                      select_k: int):
    """Fused scoring + per-phase top-``select_k`` selection.

    nbrs (G, R, L) int32 stacked phase tiles, -1 padded; fringe (G, s)
    int32, any width; bias (G, R) float32 additive row bias (the
    hub penalty, or +inf for a pad row); prev (G, P) float32 held pool
    scores. Returns ``(scores (G, R), sel_idx (G, select_k), sel_val
    (G, select_k), rem (G,))`` as ``ref.hype_score_select_ref`` defines
    them, bit for bit on either device. Where a phase holds a NaN the
    outputs are unspecified, except that every ``sel_idx`` stays in
    ``[0, R + P]``.
    """
    if not on_cuda(nbrs, "hype_score_select"):
        return hype_score_select_ref(nbrs, fringe, bias, prev, select_k)
    out = load_extension().score_select(nbrs, fringe, bias, prev,
                                        int(select_k))
    hype_score_select.launches += 1
    return out  # a tuple from the binding


hype_score_select.launches = 0
hype_scores.launches = 0
