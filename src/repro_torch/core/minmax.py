"""Streaming MinMax hypergraph partitioning (Alistarh et al., NIPS'15).

A numpy copy of the JAX package's ``src/repro/core/minmax.py``, draw for
draw: the same seed gives the same assignment in both packages. The
paper's group (III) baseline. Vertices arrive in a random stream; each
goes greedily to the partition with the largest overlap of incident
hyperedges, under a balance constraint:

  * ``minmax_eb``: hyperedge-balanced (the original MinMax): the load of
    a partition is the number of distinct hyperedges incident to it; a
    vertex may only go to partitions within ``slack`` of the least load.
  * ``minmax_nb``: the vertex-balanced variant of the HYPE paper
    (footnote 2: slack of up to 100 vertices).

Per-partition hyperedge incidence is a bit matrix (m x k bits), so the
overlap of one vertex costs O(deg(v) * k/8) bytes. Runs on the host.
"""
from __future__ import annotations

import numpy as np

from .hypergraph import Hypergraph


def _eligible_partitions(mode: str, vsizes: np.ndarray,
                         eloads: np.ndarray, slack: int,
                         cap: int) -> np.ndarray:
    """Eligibility mask for one streamed vertex (slack filter + fallback).

    ``nb`` mode: within ``slack`` of the least vertex-loaded partition
    AND under the hard vertex capacity ``cap``. ``eb`` mode: within
    ``slack`` of the least edge-loaded partition. When the slack filter
    empties, fall back to the least-loaded partitions — in ``nb`` mode
    the fallback must STILL respect ``cap`` (the old fallback dropped
    it, silently over-filling a capped partition); only when every
    partition is at capacity (impossible while vertices remain, kept as
    a never-stall guarantee) does the bare least-loaded rule apply.
    """
    if mode == "nb":
        eligible = vsizes <= vsizes.min() + slack
        eligible &= vsizes < cap
    else:
        eligible = eloads <= eloads.min() + slack
    if not eligible.any():
        if mode == "nb":
            under = vsizes < cap
            if under.any():
                return under & (vsizes == vsizes[under].min())
        return vsizes == vsizes.min()
    return eligible


def minmax_partition(hg: Hypergraph, k: int, *, mode: str = "nb",
                     slack: int = 100, seed: int = 0) -> np.ndarray:
    if mode not in ("nb", "eb"):
        raise ValueError("mode must be 'nb' or 'eb'")
    n, m = hg.n, hg.m
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)

    kbytes = (k + 7) // 8
    # bit j of edge_bits[e, j//8] set <=> edge e touches partition j
    edge_bits = np.zeros((m, kbytes), dtype=np.uint8)
    bit_of = np.zeros((k, kbytes), dtype=np.uint8)
    for p in range(k):
        bit_of[p, p // 8] = np.uint8(1 << (p % 8))

    assignment = np.full(n, -1, dtype=np.int32)
    vsizes = np.zeros(k, dtype=np.int64)     # vertices per partition
    eloads = np.zeros(k, dtype=np.int64)     # distinct edges per partition

    indptr, indices = hg.v2e_indptr, hg.v2e_indices
    cap = -(-n // k) + slack                 # hard vertex capacity (nb mode)

    for v in order:
        v = int(v)
        es = indices[indptr[v]:indptr[v + 1]]
        if es.size:
            masks = edge_bits[es]                       # (deg, kbytes)
            bits = np.unpackbits(masks, axis=1, count=k, bitorder="little")
            overlap = bits.sum(axis=0).astype(np.int64)  # (k,)
        else:
            overlap = np.zeros(k, dtype=np.int64)

        eligible = _eligible_partitions(mode, vsizes, eloads, slack, cap)

        score = np.where(eligible, overlap, -1)
        best = int(np.argmax(score - 1e-9 * vsizes))  # tie-break: least loaded
        assignment[v] = best
        vsizes[best] += 1
        if es.size:
            newly = bits[:, best] == 0
            eloads[best] += int(newly.sum())
            edge_bits[es] |= bit_of[best]

    return assignment


def random_partition(hg: Hypergraph, k: int, seed: int = 0) -> np.ndarray:
    """Balanced random assignment (lower-bound-quality baseline)."""
    rng = np.random.default_rng(seed)
    base = np.arange(hg.n, dtype=np.int64) % k
    return rng.permutation(base).astype(np.int32)


def hashing_partition(hg: Hypergraph, k: int) -> np.ndarray:
    """Deterministic hash assignment (what production systems default to)."""
    v = np.arange(hg.n, dtype=np.uint64)
    h = (v * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(40)
    return (h % np.uint64(k)).astype(np.int32)
