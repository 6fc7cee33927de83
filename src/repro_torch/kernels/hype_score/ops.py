"""The fused score + select wrapper: the tensors' device picks the kernel.

A CUDA tensor goes to the hand-written Hopper kernel
(``csrc/score_select.cu``, built by ``kernels._build``); a CPU tensor
goes to the plain version in ``ref.py``. There is no other switch and no
fallback: a failed build or launch raises. ``hype_score_select.launches``
counts the CUDA launches, so a run can show that its path went through
the kernel.
"""
from __future__ import annotations

import torch

from .ref import SELECT_PAD, hype_score_select_ref

__all__ = ["SELECT_PAD", "hype_score_select"]


def hype_score_select(nbrs: torch.Tensor, fringe: torch.Tensor,
                      bias: torch.Tensor, prev: torch.Tensor, *,
                      select_k: int):
    """Fused scoring + per-phase top-``select_k`` selection.

    nbrs (G, R, L) int32 stacked phase tiles, -1 padded; fringe (G, s)
    int32 (s <= 16 on CUDA); bias (G, R) float32 additive row bias (the
    hub penalty, or +inf for a pad row); prev (G, P) float32 held pool
    scores. Returns ``(scores (G, R), sel_idx (G, select_k), sel_val
    (G, select_k), rem (G,))`` as ``ref.hype_score_select_ref`` defines
    them, bit for bit on either device. Where a phase holds a NaN the
    outputs are unspecified, except that every ``sel_idx`` stays in
    ``[0, R + P]``.
    """
    dev = nbrs.device.type
    if dev == "cpu":
        return hype_score_select_ref(nbrs, fringe, bias, prev, select_k)
    if dev != "cuda":
        raise ValueError(f"hype_score_select runs on cpu or cuda tensors, "
                         f"not {nbrs.device}")
    from .._build import load_extension

    out = load_extension().score_select(nbrs, fringe, bias, prev,
                                        int(select_k))
    hype_score_select.launches += 1
    return tuple(out)


hype_score_select.launches = 0
