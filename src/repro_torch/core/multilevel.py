"""Multilevel hypergraph partitioners (the hMETIS-style baseline).

The port of ``src/repro/core/multilevel.py``; two entry points share
the coarsening machinery:

* ``multilevel_partition`` (method ``multilevel``): recursive multilevel
  bisection. Coarsen by heavy-connectivity pair matching over small
  hyperedges, bisect the coarsest graph by a weighted greedy fill,
  uncoarsen with the shared k-way refinement at k = 2 on the host
  (``core/refine.py``), and recurse on the two halves. All host numpy.
* ``hype_multilevel_partition`` (method ``hype_multilevel``): direct
  k-way multilevel. Coarsen once, partition the coarsest graph with the
  ``hype_superstep`` engine on the device, then uncoarsen with the k-way
  refinement at every level: weighted windows on the coarse levels (on
  the host), an exact rebalance plus unit-cap refinement at the finest
  (its screen on the device).

The matching loop and the coarse levels' refinement are host numpy and
Python, copied as they are, so they cost the same on any device.
"""
from __future__ import annotations

import numpy as np

from .hypergraph import Hypergraph
from .refine import refine_kway, rebalance_kway

_MAX_MATCH_EDGE = 64      # only edges this small contribute matching pairs
_COARSEST = 160           # stop coarsening below this many vertices
_EPS = 0.05               # bisection balance tolerance


def _pair_weights(hg: Hypergraph):
    """Connectivity weight per vertex pair from ring pairs in small edges."""
    sizes = hg.edge_sizes
    keep = (sizes >= 2) & (sizes <= _MAX_MATCH_EDGE)
    us, vs, ws = [], [], []
    eids = np.flatnonzero(keep)
    for e in eids:
        pins = hg.edge_pins(int(e)).astype(np.int64)
        nxt = np.roll(pins, -1)
        us.append(pins)
        vs.append(nxt)
        ws.append(np.full(pins.size, 1.0 / (pins.size - 1)))
    if not us:
        return (np.empty(0, np.int64),) * 2 + (np.empty(0, np.float64),)
    u = np.concatenate(us); v = np.concatenate(vs); w = np.concatenate(ws)
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    key = lo * np.int64(hg.n) + hi
    uk, inv = np.unique(key, return_inverse=True)
    wsum = np.zeros(uk.size)
    np.add.at(wsum, inv, w)
    return uk // hg.n, uk % hg.n, wsum


def _coarsen_once(hg: Hypergraph, vweights: np.ndarray):
    u, v, w = _pair_weights(hg)
    order = np.argsort(-w, kind="stable")
    matched = np.full(hg.n, -1, dtype=np.int64)
    for i in order:
        a, b = int(u[i]), int(v[i])
        if matched[a] < 0 and matched[b] < 0 and a != b:
            matched[a], matched[b] = b, a
    # build coarse ids
    cid = np.full(hg.n, -1, dtype=np.int64)
    nxt = 0
    for x in range(hg.n):
        if cid[x] >= 0:
            continue
        cid[x] = nxt
        if matched[x] >= 0:
            cid[matched[x]] = nxt
        nxt += 1
    if nxt >= hg.n:   # no contraction happened
        return None
    # rebuild pins under the contraction map
    edge_of_pin = np.repeat(np.arange(hg.m, dtype=np.int64), hg.edge_sizes)
    cpins = cid[hg.e2v_indices]
    chg = Hypergraph.from_pins(nxt, hg.m, cpins, edge_of_pin)
    cw = np.zeros(nxt)
    np.add.at(cw, cid, vweights)
    return chg, cw, cid


def _fm_refine(hg: Hypergraph, side: np.ndarray, vweights: np.ndarray,
               target_a: float, passes: int = 3) -> np.ndarray:
    """2-way refinement of boolean ``side`` (True = side B).

    The shared k-way gain machinery (``core/refine.py``) at k = 2:
    exact cut gains for every boundary vertex in one vectorized pass,
    admitted greedily under edge-disjointness and the ``±_EPS`` weight
    window — the same positive-gain moves the old per-vertex FM loop
    hunted for, without the O(n) Python pass per refinement round.
    """
    total = float(vweights.sum())
    lo = np.array([target_a - _EPS * total,
                   (total - target_a) - _EPS * total])
    hi = np.array([target_a + _EPS * total,
                   (total - target_a) + _EPS * total])
    refined, _ = refine_kway(hg, side.astype(np.int32), 2, passes,
                             weights=vweights, lo=lo, hi=hi,
                             use_device=False)
    return refined.astype(bool)


def _bisect(hg: Hypergraph, vweights: np.ndarray, frac_a: float,
            rng: np.random.Generator) -> np.ndarray:
    """Multilevel 2-way split. Returns bool array (True = side B)."""
    levels = []
    cur, curw = hg, vweights
    while cur.n > _COARSEST:
        res = _coarsen_once(cur, curw)
        if res is None:
            break
        chg, cw, cid = res
        levels.append((cur, curw, cid))
        cur, curw = chg, cw
    # initial partition at coarsest: greedy weighted fill
    total = float(curw.sum())
    target_a = frac_a * total
    order = rng.permutation(cur.n)
    side = np.zeros(cur.n, dtype=bool)
    acc = 0.0
    for v in order:
        if acc + curw[v] <= target_a:
            acc += curw[v]
        else:
            side[v] = True
    side = _fm_refine(cur, side, curw, target_a)
    # uncoarsen
    while levels:
        fine, finew, cid = levels.pop()
        side = side[cid]
        side = _fm_refine(fine, side, finew, frac_a * float(finew.sum()))
    return side


def _sub_hypergraph(hg: Hypergraph, mask: np.ndarray):
    new_id = np.cumsum(mask) - 1
    edge_of_pin = np.repeat(np.arange(hg.m, dtype=np.int64), hg.edge_sizes)
    keep = mask[hg.e2v_indices]
    vp = new_id[hg.e2v_indices[keep]]
    ep = edge_of_pin[keep]
    # re-number edges compactly, drop edges with < 2 remaining pins
    ue, inv = np.unique(ep, return_inverse=True)
    cnt = np.bincount(inv)
    keep_e = cnt[inv] >= 2
    ue2, inv2 = np.unique(inv[keep_e], return_inverse=True)
    sub = Hypergraph.from_pins(int(mask.sum()), int(ue2.size),
                               vp[keep_e], inv2)
    return sub, np.flatnonzero(mask)


def multilevel_partition(hg: Hypergraph, k: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    assignment = np.zeros(hg.n, dtype=np.int32)
    vweights = np.ones(hg.n)

    def rec(sub: Hypergraph, ids: np.ndarray, w: np.ndarray, kk: int, base: int):
        if kk == 1 or sub.n == 0:
            assignment[ids] = base
            return
        k1 = kk // 2
        side = _bisect(sub, w, k1 / kk, rng)
        maskA = ~side
        subA, la = _sub_hypergraph(sub, maskA)
        subB, lb = _sub_hypergraph(sub, side)
        rec(subA, ids[la], w[maskA], k1, base)
        rec(subB, ids[lb], w[side], kk - k1, base + k1)

    rec(hg, np.arange(hg.n, dtype=np.int64), vweights, k, 0)
    return assignment


def hype_multilevel_partition(hg: Hypergraph, k: int, *, device,
                              seed: int = 0, refine_passes: int = 3,
                              coarsest: int = 3000) -> np.ndarray:
    """Direct k-way multilevel partitioning (method ``hype_multilevel``).

    Coarsen by heavy-connectivity matching until the graph drops below
    ``max(coarsest, 8k)`` vertices, produce the initial k-way assignment
    with the device-resident ``hype_superstep`` engine (all k phases
    grown concurrently on the coarsest graph), then uncoarsen: project
    the assignment through each contraction map and run the shared
    k-way refinement (``core/refine.py``) — weighted balance windows on
    the coarse levels, then an exact rebalance plus unit-cap refinement
    at the finest level, so the final assignment keeps the HYPE family's
    ``max - min <= 1`` vertex-balance contract. Seeded-deterministic.
    The coarsest graph's supersteps and the finest level's screen run on
    ``device``; the coarse levels refine on the host, as in JAX.
    """
    if k < 1:
        raise ValueError("k must be >= 1")
    out_small = np.zeros(hg.n, dtype=np.int32)
    if k == 1 or hg.n == 0:
        return out_small
    from ..engines.superstep import (SuperstepParams,
                                     hype_superstep_partition)

    levels = []
    cur, curw = hg, np.ones(hg.n)
    while cur.n > max(coarsest, 8 * k):
        res = _coarsen_once(cur, curw)
        if res is None:
            break
        chg, cw, cid = res
        levels.append((cur, curw, cid))
        cur, curw = chg, cw

    a = hype_superstep_partition(cur, k, SuperstepParams(seed=seed),
                                 device=device)

    def _window(w):
        tgt = float(w.sum()) / k
        return (np.full(k, (1.0 - 2 * _EPS) * tgt),
                np.full(k, (1.0 + 2 * _EPS) * tgt))

    if levels:      # coarse-vertex counts balance, weights may not:
        lo, hi = _window(curw)      # refine under the weighted window
        a, _ = refine_kway(cur, a, k, refine_passes, weights=curw,
                           lo=lo, hi=hi, use_device=False)
    while levels:
        fine, finew, cid = levels.pop()
        a = a[cid]
        if levels:      # intermediate level: still weighted
            lo, hi = _window(finew)
            a, _ = refine_kway(fine, a, k, refine_passes, weights=finew,
                               lo=lo, hi=hi, use_device=False)
    # finest level: unit weights — restore the exact balance contract,
    # then refine under the tight [floor, ceil] caps (device screening)
    a = rebalance_kway(hg, np.asarray(a, dtype=np.int32), k)
    a, _ = refine_kway(hg, a, k, refine_passes, device=device)
    return a.astype(np.int32)
