"""The k-way move-gain wrappers: the tensors' device picks the kernel.

A CUDA tensor goes to the hand-written Hopper kernel
(``csrc/kway_gains.cu``, built by ``kernels._build``); a CPU tensor goes
to the plain version in ``ref.py``. There is no other switch and no
fallback: a failed build or launch raises. The kernel has two front
ends: ``kway_gains`` counts a (B, L) tile of partition ids, and
``kway_gains_csr`` (the refinement screen's) reads each candidate's
neighbours through the CSR and the assignment, so the tile is never
built; given the host's delta, it writes it into the assignment first,
so the refinement screen is one device program. Each wrapper's
``launches`` counts its CUDA launches, so a run can show that its path
went through the kernel.
"""
from __future__ import annotations

import torch

from .._build import load_extension, on_cuda
from .ref import kway_gains_csr_ref, kway_gains_ref

__all__ = ["kway_gains", "kway_gains_csr"]


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


def kway_gains_csr(indptr: torch.Tensor, indices: torch.Tensor,
                   assign: torch.Tensor, cand: torch.Tensor, *,
                   tile_l: int, k: int,
                   delta: tuple[torch.Tensor, torch.Tensor] | None = None
                   ) -> torch.Tensor:
    """Move gains of the candidates ``cand``, read through the CSR.

    indptr (n + 1,) int32 or int64 and indices int32 (as
    ``Hypergraph.device_adjacency`` gives them), assign (n + 1,) int32,
    cand (B,) int32 (-1 pad). Row b counts the partitions of the first
    ``min(deg, tile_l)`` neighbours of ``cand[b]`` against its own,
    ``assign[cand[b]]``. Returns (B, k) float32 gains as
    ``ref.kway_gains_csr_ref`` defines them, bit for bit on either
    device; ids must lie in range.

    ``delta``, ``(ids, vals)`` int32 of one length (ids -1 padded and
    otherwise unique), is written into ``assign`` in place first,
    ``assign[ids] = vals`` with the pads landing on the scratch slot n;
    on the card the delta and the gains are one device program (a delta
    kernel, then the gains' kernel as its programmatic dependent, which
    waits for its stores before it reads the assignment), counted once.
    """
    if delta is not None and not all(t.dtype == torch.int32 for t in delta):
        raise ValueError(f"delta must be int32 ids and values, got "
                         f"{delta[0].dtype} and {delta[1].dtype}")
    if not on_cuda(cand, "kway_gains_csr"):
        if delta is not None:
            ids, vals = delta
            n = assign.shape[0] - 1
            assign.index_put_((torch.where(ids >= 0, ids, n).long(),), vals)
        return kway_gains_csr_ref(indptr, indices, assign, cand, tile_l, k)
    out = load_extension().kway_gains_csr(indptr, indices, assign, cand,
                                          int(tile_l), int(k),
                                          *(delta or (None, None)))
    kway_gains_csr.launches += 1
    return out


kway_gains_csr.launches = 0
