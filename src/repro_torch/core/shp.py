"""Social-Hash-style iterative swap partitioner (Kabiljo et al., VLDB'17).

A numpy copy of the JAX package's ``src/repro/core/shp.py``: the same
seed gives the same assignment in both packages. The paper's group (II)
baseline: start from a balanced random assignment; every vertex finds
the partition that maximizes its hyperedge overlap, and moves are applied
in *balanced swaps*, so partition sizes never change. Each iteration is
O(n_pins * k / 8) through the bit-matrix trick of ``minmax.py``. Runs on
the host.
"""
from __future__ import annotations

import numpy as np

from .hypergraph import Hypergraph
from .minmax import random_partition


def _edge_partition_bits(hg: Hypergraph, assignment: np.ndarray, k: int):
    kbytes = (k + 7) // 8
    part_of_pin = assignment[hg.e2v_indices].astype(np.int64)
    edge_of_pin = np.repeat(np.arange(hg.m, dtype=np.int64), hg.edge_sizes)
    bits = np.zeros((hg.m, kbytes), dtype=np.uint8)
    byte_idx = part_of_pin // 8
    bit_val = (1 << (part_of_pin % 8)).astype(np.uint8)
    np.bitwise_or.at(bits, (edge_of_pin, byte_idx), bit_val)
    return bits


def shp_partition(hg: Hypergraph, k: int, *, iters: int = 16,
                  seed: int = 0, init: np.ndarray | None = None,
                  swap_frac: float = 1.0) -> np.ndarray:
    n = hg.n
    rng = np.random.default_rng(seed)
    assignment = (init.copy() if init is not None
                  else random_partition(hg, k, seed))

    edge_of_pin = np.repeat(np.arange(hg.m, dtype=np.int64), hg.edge_sizes)
    for _ in range(iters):
        bits = _edge_partition_bits(hg, assignment, k)
        # per-vertex overlap with each partition
        unpacked = np.unpackbits(bits, axis=1, count=k, bitorder="little")
        # overlap[v, p] = sum over incident edges of bit p
        deg = hg.vertex_degrees
        overlap = np.zeros((n, k), dtype=np.int32)
        np.add.at(overlap, np.repeat(np.arange(n, dtype=np.int64), deg),
                  unpacked[hg.v2e_indices])
        # Exclude the vertex's own contribution to its current partition:
        # count, per pin, how many pins of that edge sit in the pin's own
        # partition; if the pin is the only one, the edge's bit exists only
        # because of v itself.
        part_of_pin = assignment[hg.e2v_indices].astype(np.int64)
        pin_key = edge_of_pin * np.int64(k) + part_of_pin
        uk, inv, cnts = np.unique(pin_key, return_inverse=True,
                                  return_counts=True)
        solo_pin = (cnts[inv] == 1).astype(np.int32)
        solo = np.zeros(n, dtype=np.int32)
        np.add.at(solo, hg.e2v_indices, solo_pin)
        overlap[np.arange(n), assignment] -= solo
        cur = overlap[np.arange(n), assignment]
        desire = np.argmax(overlap, axis=1).astype(np.int32)
        gain = overlap[np.arange(n), desire] - cur
        movers = np.flatnonzero((desire != assignment) & (gain > 0))
        if movers.size == 0:
            break
        if swap_frac < 1.0:
            movers = rng.choice(movers, size=max(1, int(movers.size * swap_frac)),
                                replace=False)
        # Balanced swapping: for each ordered pair (a, b) match the
        # highest-gain movers a->b with movers b->a and swap both sides.
        src = assignment[movers]
        dst = desire[movers]
        g = gain[movers]
        moved = 0
        # group movers by (src, dst)
        pair_key = src.astype(np.int64) * k + dst
        order = np.lexsort((-g, pair_key))
        movers, src, dst, pair_key = movers[order], src[order], dst[order], pair_key[order]
        starts = np.searchsorted(pair_key, np.arange(k * k, dtype=np.int64))
        ends = np.searchsorted(pair_key, np.arange(1, k * k + 1, dtype=np.int64))
        for a in range(k):
            for b in range(a + 1, k):
                i0, i1 = starts[a * k + b], ends[a * k + b]
                j0, j1 = starts[b * k + a], ends[b * k + a]
                t = min(i1 - i0, j1 - j0)
                if t > 0:
                    sel = np.concatenate([movers[i0:i0 + t], movers[j0:j0 + t]])
                    assignment[sel] = np.concatenate(
                        [np.full(t, b, np.int32), np.full(t, a, np.int32)])
                    moved += 2 * t
        if moved == 0:
            break
    return assignment
