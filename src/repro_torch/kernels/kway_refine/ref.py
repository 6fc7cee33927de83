"""Plain PyTorch versions of the k-way move-gain kernel's two front ends.

The same functions as ``csrc/kway_gains.cu`` in tensor ops: the CPU path
of ``ops.kway_gains`` and ``ops.kway_gains_csr``, and the yardstick the
card's kernel is compared with. ``kway_gains_ref`` counts with one
scatter-add into a (B, k + 1) histogram (column k collects every value
outside ``[0, k)``), so no (B, k, L) compare intermediate is built.
``kway_gains_csr_ref`` builds the (B, tile_l) neighbour-partition tile of
the refinement screen (``gather_part_tiles``) and counts it the same way.
Exact: every count is an integer below 2**24.
"""
from __future__ import annotations

import torch


def kway_gains_ref(parts: torch.Tensor, own: torch.Tensor,
                   k: int) -> torch.Tensor:
    """``gain[b, q] = #(parts[b] == q) - #(parts[b] == own[b] >= 0)``.

    parts (B, L) int32 neighbour partition ids, -1 padded; own (B,)
    int32 the row's own partition, -1 for a pad row. Returns (B, k)
    float32; column ``own[b]`` is 0 and a pad row (own = -1, parts all
    -1) is all zero, as in the JAX package's ``kway_refine``.
    """
    B = parts.shape[0]
    inside = (parts >= 0) & (parts < k)
    col = torch.where(inside, parts, k).long()
    cnt = torch.zeros((B, k + 1), dtype=torch.int32, device=parts.device)
    cnt.scatter_add_(1, col, torch.ones_like(parts))
    cnt_own = ((parts == own[:, None]) & (parts >= 0)).sum(
        dim=1, dtype=torch.int32)
    return (cnt[:, :k] - cnt_own[:, None]).to(torch.float32)


def gather_part_tiles(indptr, indices, assign, cand, tile_l: int):
    """Neighbour-partition tile for ``cand`` at the fixed width ``tile_l``.

    The refinement sibling of ``core.scoring._gather_fresh_tiles``: the
    same CSR gather, but rows hold the neighbours' partition ids (every
    neighbour, assigned or not, the first ``tile_l`` in CSR order)
    instead of unassigned vertex ids. Pads are -1; every gather index is
    clamped first.
    """
    csafe = torch.where(cand >= 0, cand, 0).long()
    start = indptr[csafe]
    deg = indptr[csafe + 1] - start
    col = torch.arange(tile_l, dtype=indptr.dtype, device=indptr.device)
    valid = (col < deg[:, None]) & (cand >= 0)[:, None]
    nbr = indices[torch.where(valid, start[:, None] + col, 0).long()]
    return torch.where(valid, assign[nbr.long()], -1).to(torch.int32)


def kway_gains_csr_ref(indptr, indices, assign, cand, tile_l: int,
                       k: int) -> torch.Tensor:
    """The gains of the candidates ``cand`` read through the CSR.

    ``kway_gains_ref`` of the tile ``gather_part_tiles`` builds, with
    ``own[b] = assign[cand[b]]`` (-1 for a pad candidate). indptr (n + 1,)
    int32 or int64, indices int32, assign (n + 1,) int32, cand (B,) int32
    -1 padded. Returns (B, k) float32.
    """
    csafe = torch.where(cand >= 0, cand, 0).long()
    own = torch.where(cand >= 0, assign[csafe], -1).to(torch.int32)
    return kway_gains_ref(
        gather_part_tiles(indptr, indices, assign, cand, tile_l), own, k)
