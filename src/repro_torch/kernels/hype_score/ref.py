"""Plain PyTorch versions of the scoring kernels.

The same functions as ``csrc/score_select.cu`` and ``csrc/scores.cu`` in
tensor ops: the CPU paths of ``ops.hype_score_select`` and
``ops.hype_scores`` and the yardsticks the card's kernels are compared
with. Selection is an iterative argmin that mirrors the TPU
kernel round for round (lowest index wins a tie, a taken slot becomes
+inf, a NaN in a phase gives index R + P) -- not ``torch.topk``, whose
tie order differs from the reference's stable order.
"""
from __future__ import annotations

import torch

# Scores at or above this are "not a candidate" (padded rows, empty pool
# slots); +inf marks a slot already taken. Any real score, the 1e12 hub
# penalty included, sits far below it.
SELECT_PAD = 1e30


def _external_count(nbrs: torch.Tensor, fringe: torch.Tensor,
                    ) -> torch.Tensor:
    """``#valid - #(valid & in fringe)`` over the last axis, as int32.

    ``fringe`` holds one row of s ids per leading index of ``nbrs``
    (broadcast over the rows); membership ORs the fringe slots, so a
    duplicated fringe id counts a neighbour once.
    """
    valid = nbrs >= 0
    member = torch.zeros_like(valid)
    for j in range(fringe.shape[-1]):
        member |= nbrs == fringe[..., j, None, None]
    member &= valid
    return (valid.sum(-1, dtype=torch.int32)
            - member.sum(-1, dtype=torch.int32))


def hype_scores_ref(nbrs: torch.Tensor, fringe: torch.Tensor
                    ) -> torch.Tensor:
    """d_ext score per row: nbrs (B, L) int32, -1 padded; fringe (s,)
    int32, -1 padded. Returns (B,) int32."""
    return _external_count(nbrs[None], fringe[None])[0]


def hype_score_select_ref(nbrs: torch.Tensor, fringe: torch.Tensor,
                          bias: torch.Tensor, prev: torch.Tensor,
                          select_k: int):
    """Score every fresh row, then take each phase's ``select_k`` best.

    nbrs (G, R, L) int32, -1 padded; fringe (G, s) int32, -1 padded;
    bias (G, R) float32; prev (G, P) float32 held pool scores (+inf =
    empty). Returns ``(scores (G, R) f32, sel_idx (G, select_k) i32,
    sel_val (G, select_k) f32, rem (G,) i32)``: ``sel_idx < R`` names a
    fresh row, ``>= R`` pool slot ``idx - R``; ``rem`` counts the slots
    still below ``SELECT_PAD`` after selection.
    """
    G, R, _ = nbrs.shape
    scores = _external_count(nbrs, fringe).to(torch.float32) + bias
    # clamp keeps NaN, as jnp.minimum does; the scalar bounds are cast
    # to float32, so no tensor constant (and no host copy) is needed
    merged = torch.clamp(torch.cat([scores, prev], dim=1), max=SELECT_PAD)
    n_slots = merged.shape[1]
    pos = torch.arange(n_slots, dtype=torch.int32, device=nbrs.device)
    sel_i, sel_v = [], []
    for _ in range(select_k):
        mv = merged.amin(dim=1, keepdim=True)
        am = torch.where(merged == mv, pos, n_slots).amin(dim=1)
        sel_i.append(am)
        sel_v.append(mv[:, 0])
        merged = torch.where(pos == am[:, None], float("inf"), merged)
    rem = (merged < SELECT_PAD).sum(dim=1, dtype=torch.int32)
    return (scores, torch.stack(sel_i, dim=1).to(torch.int32),
            torch.stack(sel_v, dim=1), rem)
