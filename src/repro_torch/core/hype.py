"""HYPE: hypergraph partitioning via neighborhood expansion (paper §III).

A numpy copy of the JAX package's host partitioner
(``src/repro/core/hype.py``): Algorithms 1-3 with the three
optimizations of §III-B2:

  (a) fringe candidates are drawn from the *smallest* hyperedges incident
      to the core first (min-heap over active hyperedges keyed by size),
  (b) the number of fringe candidates per step is limited to ``r`` (=2),
  (c) external-neighbors scores are lazily cached (never recomputed).

Balancing modes (§III-C):
  * ``vertex``   — exactly |V|/k vertices per partition (default).
  * ``weighted`` — weight w(v) = 1 + deg(v); each partition receives
                   ~(Σw)/k total weight.
  * hyperedge balancing is achieved by partitioning ``hg.flip()``.

It runs on the host only; its assignment equals the JAX package's for
the same graph, params and seed. ``partition(..., "hype")`` and
``"hype_weighted"`` reach it, and ``placement/partitioned_embedding``
places embedding rows with it.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Optional

import numpy as np

from .hypergraph import Hypergraph
from .scoring import batched_dext_numpy


@dataclasses.dataclass
class HypeParams:
    s: int = 10                 # max fringe size (paper Fig. 3)
    r: int = 2                  # fringe candidates per step (paper Fig. 5)
    use_cache: bool = True      # lazy score caching (paper Fig. 6)
    balance: str = "vertex"     # "vertex" | "weighted"
    dext_mode: str = "universe"  # "universe" (paper intent) | "eq1" (literal)
    dext_cap: Optional[int] = None  # optional cap on pins scanned per score
    seed: int = 0


@dataclasses.dataclass
class HypeStats:
    score_computations: int = 0
    cache_hits: int = 0
    edges_scanned: int = 0
    random_restarts: int = 0


class _HypeState:
    """Mutable partitioning state shared across the k growth phases."""

    def __init__(self, hg: Hypergraph, k: int, params: HypeParams):
        self.hg = hg
        self.k = k
        self.p = params
        n, m = hg.n, hg.m
        self.assignment = np.full(n, -1, dtype=np.int32)
        self.in_fringe = np.zeros(n, dtype=bool)
        # Working copy of e2v pins: assigned pins are compacted to the
        # front of each edge slice so they are never rescanned.
        self.pins = hg.e2v_indices.copy()
        self.cursor = hg.e2v_indptr[:-1].copy()       # first live pin per edge
        self.edge_end = hg.e2v_indptr[1:]
        self.edge_sizes = hg.edge_sizes
        self.edge_dead = self.cursor >= self.edge_end  # empty edges are dead
        # Per-partition activation epoch: edge active iff epoch[e] == phase.
        self.edge_epoch = np.full(m, -1, dtype=np.int32)
        # Lazy external-neighbors score cache (cleared per phase, Alg 1 l.6).
        self.cache = np.full(n, -1.0)
        self.rng = np.random.default_rng(params.seed)
        # Random-seed stream: shuffled vertex order with a skip pointer.
        self.rand_order = self.rng.permutation(n)
        self.rand_ptr = 0
        self.stats = HypeStats()

    # ------------------------------------------------------------------ #
    def random_unassigned(self) -> int:
        n = self.hg.n
        while self.rand_ptr < n:
            v = int(self.rand_order[self.rand_ptr])
            self.rand_ptr += 1
            if self.assignment[v] < 0 and not self.in_fringe[v]:
                return v
        # All remaining vertices sit in the fringe; fall back to a scan.
        rem = np.flatnonzero((self.assignment < 0) & ~self.in_fringe)
        if rem.size == 0:
            return -1
        return int(rem[0])

    # ------------------------------------------------------------------ #
    def d_ext(self, v: int) -> float:
        """External-neighbors score d_ext(v, F).

        Eq. 1 in the paper reads |N(v) \\ F|, but the surrounding text
        defines "external" as neighbors *in the remaining vertex universe*
        ("a low number of neighbors in the remaining vertex universe").
        Taking Eq. 1 literally would count core neighbors as external and
        penalize exactly the high-locality vertices, so — like the paper's
        released C++ implementation — we count neighbors that are neither
        in the fringe nor already assigned to any core:

            d_ext(v, F) = |N(v) ∩ V'|    with V' = V \\ F \\ C_0 ... \\ C_i

        ``dext_mode='eq1'`` restores the literal reading for ablations.
        """
        self.stats.score_computations += 1
        hg = self.hg
        lo, hi = hg.v2e_indptr[v], hg.v2e_indptr[v + 1]
        es = hg.v2e_indices[lo:hi]
        if es.size == 0:
            return 0.0
        cap = self.p.dext_cap
        parts = []
        scanned = 0
        for e in es:
            a, b = hg.e2v_indptr[e], hg.e2v_indptr[e + 1]
            parts.append(hg.e2v_indices[a:b])
            scanned += b - a
            if cap is not None and scanned >= cap:
                break
        allp = np.concatenate(parts) if len(parts) > 1 else parts[0]
        uniq = np.unique(allp)
        if self.p.dext_mode == "eq1":
            ext = int((~self.in_fringe[uniq]).sum())
            self_external = not self.in_fringe[v]
        else:
            external = (~self.in_fringe[uniq]) & (self.assignment[uniq] < 0)
            ext = int(external.sum())
            self_external = (not self.in_fringe[v]) and self.assignment[v] < 0
        if self_external:
            ext -= 1  # v itself was counted
        score = float(max(ext, 0))
        if cap is not None and scanned >= cap:
            score += 1e12  # capped vertices compare as "huge neighborhood"
        return score

    def score(self, v: int) -> float:
        """Cached score read (Alg 3 line 2 always reads the cache)."""
        c = self.cache[v]
        if c >= 0.0:
            self.stats.cache_hits += 1
            return float(c)
        sc = self.d_ext(v)
        self.cache[v] = sc
        return sc

    def refresh(self, v: int) -> float:
        """Fringe-update scoring (Alg 2 l.14-16).

        With caching (paper default) the score is computed at most once per
        phase (lazy policy); the ablation ``use_cache=False`` recomputes a
        fresh score on every fringe update instead.
        """
        if self.p.use_cache and self.cache[v] >= 0.0:
            self.stats.cache_hits += 1
            return float(self.cache[v])
        sc = self.d_ext(v)
        self.cache[v] = sc
        return sc

    def refresh_many(self, vs: list) -> None:
        """Batch fringe-update scoring: one vectorized d_ext pass.

        Produces exactly the same scores/stats as per-vertex ``refresh``
        in the default "universe" mode; the eq1 / capped ablation modes
        keep the scalar path (they exist for fidelity, not speed).
        """
        if self.p.dext_mode != "universe" or self.p.dext_cap is not None:
            for v in vs:
                self.refresh(v)
            return
        if self.p.use_cache:
            miss = [v for v in vs if self.cache[v] < 0.0]
            self.stats.cache_hits += len(vs) - len(miss)
        else:
            miss = list(vs)
        if not miss:
            return
        scores = batched_dext_numpy(self.hg, np.asarray(miss, np.int64),
                                    self.in_fringe, self.assignment)
        self.cache[miss] = scores
        self.stats.score_computations += len(miss)


def _grow_partition(st: _HypeState, part: int, target: float,
                    weights: Optional[np.ndarray],
                    warm: bool = False) -> None:
    """Grow core set C_part until it reaches ``target`` size/weight.

    ``warm`` continues a phase that already holds members (a warm start
    from a partition snapshot — the degradation ladder's last rung):
    existing members are activated instead of drawing a seed, and
    growth resumes from their accumulated size/weight.
    """
    hg, p = st.hg, st.p
    heap: list = []            # (edge_size, edge_id) of active hyperedges
    fringe: list = []          # vertex ids, |fringe| <= s
    st.cache[:] = -1.0         # Alg 1 line 6: clear cache per phase

    def activate(v: int) -> None:
        lo, hi = hg.v2e_indptr[v], hg.v2e_indptr[v + 1]
        for e in hg.v2e_indices[lo:hi]:
            e = int(e)
            if st.edge_epoch[e] != part and not st.edge_dead[e]:
                st.edge_epoch[e] = part
                heapq.heappush(heap, (int(st.edge_sizes[e]), e))

    def add_to_core(v: int) -> float:
        st.assignment[v] = part
        st.in_fringe[v] = False
        activate(v)
        return 1.0 if weights is None else float(weights[v])

    acc = 0.0
    if warm:
        members = np.flatnonzero(st.assignment == part)
        if members.size:
            acc = (float(members.size) if weights is None
                   else float(weights[members].sum()))
            if acc >= target:
                return
            for v in members:
                activate(int(v))
    if acc == 0.0:
        # --- Alg 1 line 3: random seed vertex ---
        seed = st.random_unassigned()
        if seed < 0:
            return
        acc = add_to_core(seed)

    while acc < target:
        # ---------------- upd8_fringe (Alg 2) ----------------
        cand: list = []
        requeue: list = []
        while heap and len(cand) < p.r:
            size_e, e = heapq.heappop(heap)
            if st.edge_epoch[e] != part or st.edge_dead[e]:
                continue
            cur, end = int(st.cursor[e]), int(st.edge_end[e])
            pins = st.pins
            while cur < end and len(cand) < p.r:
                st.stats.edges_scanned += 1
                v = int(pins[cur])
                if st.assignment[v] >= 0:
                    # compact assigned pin to the front, never rescan
                    pins[cur] = pins[int(st.cursor[e])]
                    pins[int(st.cursor[e])] = v
                    st.cursor[e] += 1
                    cur += 1
                    continue
                if st.in_fringe[v] or v in cand:
                    cur += 1
                    continue
                cand.append(v)
                cur += 1
            if st.cursor[e] >= end:
                st.edge_dead[e] = True
            elif len(cand) >= p.r:
                requeue.append((size_e, e))   # still has live pins
            else:
                requeue.append((size_e, e))
        for item in requeue:
            heapq.heappush(heap, item)

        # update cache / compute scores for new candidates (Alg 2 l.14-16)
        # and set fringe to top-s by score (Alg 2 l.18-20)
        pool = fringe + cand
        if pool:
            st.refresh_many(pool)
            scored = sorted(pool, key=st.score)
            fringe = scored[:p.s]
            for v in scored[p.s:]:
                st.in_fringe[v] = False      # evicted back to the universe
            for v in fringe:
                st.in_fringe[v] = True
        if not fringe:                        # Alg 2 l.21-22: random restart
            v = st.random_unassigned()
            if v < 0:
                return
            st.stats.random_restarts += 1
            fringe = [v]
            st.in_fringe[v] = True

        # ---------------- upd8_core (Alg 3) ----------------
        best_i = min(range(len(fringe)), key=lambda i: st.score(fringe[i]))
        v = fringe.pop(best_i)
        acc += add_to_core(v)

    # release fringe (§III-B1 step 4)
    for v in fringe:
        st.in_fringe[v] = False


def hype_partition(hg: Hypergraph, k: int,
                   params: Optional[HypeParams] = None,
                   return_stats: bool = False,
                   warm_start: Optional[np.ndarray] = None):
    """Partition ``hg`` into ``k`` parts with HYPE (Alg. 1).

    Returns an int32 assignment array of shape (n,); every vertex is
    assigned to exactly one partition in [0, k).

    ``warm_start`` adopts a (possibly partial, -1 = unassigned)
    assignment before growing: the degradation ladder's last rung
    (``partition_api.partition_resilient``) resumes here from the last
    snapshot when every engine above it failed; values must lie in
    [-1, k).
    """
    if params is None:
        params = HypeParams()
    if k < 1:
        raise ValueError("k must be >= 1")
    st = _HypeState(hg, k, params)
    n = hg.n
    warm = False
    if warm_start is not None:
        wa = np.asarray(warm_start)
        if wa.shape != (n,):
            raise ValueError(
                f"warm_start must have shape ({n},), got {wa.shape}")
        if wa.max(initial=-1) >= k:
            raise ValueError("warm_start names a partition >= k")
        got = wa >= 0
        st.assignment[got] = wa[got].astype(np.int32)
        warm = True

    if params.balance == "vertex":
        weights = None
        base, rem = divmod(n, k)
        targets = [base + (1 if i < rem else 0) for i in range(k)]
    elif params.balance == "weighted":
        weights = 1.0 + hg.vertex_degrees.astype(np.float64)
        total = float(weights.sum())
        targets = [total / k] * k
    else:
        raise ValueError(f"unknown balance mode {params.balance!r}")

    for i in range(k):
        if i == k - 1:
            # Last partition absorbs every remaining vertex so the
            # assignment is always complete (weighted mode may round).
            rem_v = np.flatnonzero(st.assignment < 0)
            st.assignment[rem_v] = i
            st.in_fringe[:] = False
            break
        _grow_partition(st, i, targets[i], weights, warm=warm)

    assert (st.assignment >= 0).all()
    if return_stats:
        return st.assignment, st.stats
    return st.assignment


def hyperedge_balanced_hype(hg: Hypergraph, k: int,
                            params: Optional[HypeParams] = None) -> np.ndarray:
    """Perfect hyperedge balancing via the flip trick (paper §III-C).

    Partitions the flipped hypergraph (hyperedges become vertices), then
    returns the assignment of *hyperedges* to partitions.
    """
    return hype_partition(hg.flip(), k, params)
