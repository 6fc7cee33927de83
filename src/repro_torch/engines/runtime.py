"""Shared engine runtime: host state core, counters, pipeline driver.

The port of ``src/repro/engines/runtime.py``: ``BatchedStats`` (the
counters the ported engines fill), ``EngineRuntime`` (the assignment
mirror, pool membership and the seeded random stream), ``run_pipeline``,
the double-buffered superstep driver at any ``pipeline_depth``, and
``maybe_refine``, the k-way refinement post-pass. Snapshots, resume,
fault plans and the memory-rung retry loop are not ported (ROADMAP.md,
queue 1).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import numpy as np

from ..core.hypergraph import Hypergraph


@dataclasses.dataclass
class BatchedStats:
    kernel_calls: int = 0      # hype_scores calls (the batched engine)
    kernel_rows: int = 0       # candidate rows scored by the kernel
    host_rows: int = 0         # rows scored on the host
    cache_hits: int = 0
    edges_scanned: int = 0     # pins scanned during candidate selection
    random_restarts: int = 0
    steps: int = 0                  # growth steps (the batched engine)
    supersteps: int = 0             # device programs = kernel launches
    tile_l: int = 0                 # the run's neighbour-tile gather width
    device_image_bytes: int = 0     # one-time CSR + assignment + cache
    host_to_device_bytes: int = 0   # per-call id/bias buffers
    cache_invalidations: int = 0    # cached scores decremented by admission
    host_s: float = 0.0             # wall-clock in host packing + harvest
    #                                 mirroring (overlappable)
    device_s: float = 0.0           # wall-clock blocked on device results
    pipeline_stalls: int = 0        # rounds where the host packed nothing
    #                                 and the device went idle
    stale_redraws: int = 0          # pool slots skipped on device because
    #                                 an interleaved superstep had already
    #                                 assigned them
    # device-loop counters (hype_device):
    loop_chunks: int = 0            # host-visible chunks of rounds
    loop_rounds: int = 0            # pack + dispatch rounds run on device
    loop_pack_only: int = 0         # rounds that had nothing to score
    loop_store_peak: int = 0        # peak live rows across phase stores
    loop_state_bytes: int = 0       # device-resident carry (loop state)
    refill_signals: int = 0         # phases whose candidate slots ran out
    #                                 during selection (the kernel's rem)
    # the device loop's CUDA graphs (0 on the CPU; the port's own),
    # summed over a run's capacity attempts:
    graph_captures: int = 0         # rounds captured (one warm-up each)
    graph_replays: int = 0          # replays of the captured rounds
    graph_nodes: int = 0            # nodes of the last captured graph
    graph_capture_s: float = 0.0    # warm-up + capture + instantiate
    # refinement post-pass (None unless refine_passes > 0 ran):
    refine: Optional[object] = None     # core.refine.RefineStats


class EngineRuntime:
    """Mutable host-side state core shared by the device engines."""

    def __init__(self, hg: Hypergraph, k: int, p):
        self.hg = hg
        self.k = k
        self.p = p
        n = hg.n
        self.assignment = np.full(n, -1, dtype=np.int32)
        self.in_pool = np.zeros(n, dtype=bool)     # fringe ∪ held candidates
        self.edge_sizes = np.asarray(hg.edge_sizes, dtype=np.int64)
        self.edge_dead = self.edge_sizes == 0              # no live pins left
        # Host numpy randomness, drawn exactly as the JAX package's
        # EngineRuntime draws it: the seeds, the restart order and the
        # bucket store all come from this generator, so bit-identical
        # assignments depend on taking the same draws in the same order.
        self.rng = np.random.default_rng(p.seed)
        self.rand_order = self.rng.permutation(n)
        self.rand_ptr = 0
        self.stats = BatchedStats()
        # unique-neighbour CSR (memoized on hg); None when the hub
        # expansion guard trips
        self.adj = hg.vertex_adjacency()

    def random_unassigned(self, count: int = 1) -> np.ndarray:
        """Next ``count`` unassigned non-pool vertices of the random stream.

        Vectorized skip-pointer scan over the shuffled order; the pointer
        only advances past consumed positions so no vertex is skipped.
        """
        in_pool = self.in_pool
        n = self.hg.n
        out: list = []
        got = 0
        while self.rand_ptr < n and got < count:
            chunk = self.rand_order[self.rand_ptr:
                                    self.rand_ptr + max(1024, count)]
            ok = np.flatnonzero((self.assignment[chunk] < 0)
                                & ~in_pool[chunk])
            if ok.size >= count - got:
                ok = ok[:count - got]
                self.rand_ptr += int(ok[-1]) + 1
            else:
                self.rand_ptr += chunk.size
            take = chunk[ok].astype(np.int64)
            got += take.size
            if take.size:
                out.append(take)
        if got < count:     # stream exhausted; the stragglers sit earlier
            rem = np.flatnonzero((self.assignment < 0) & ~in_pool)
            if out:
                rem = np.setdiff1d(rem, np.concatenate(out),
                                   assume_unique=True)
            if rem.size:
                out.append(rem[:count - got].astype(np.int64))
        return (np.concatenate(out) if out
                else np.empty(0, dtype=np.int64))


def run_pipeline(hg: Hypergraph, k: int, p, make_state):
    """Grow all ``k`` partitions concurrently; returns (assignment, state).

    Each superstep is one device program that scores the stacked fresh
    candidates of every growing phase and admits each phase's top ``t``
    on the device. Up to ``p.pipeline_depth`` supersteps stay in flight:
    while the device computes superstep N, the host mirrors superstep
    N-1's admissions and packs superstep N+1; proposals that went stale
    in between are skipped on the device. The schedule depends only on
    mirrored results, never on timing, so a run is seeded-deterministic
    at any depth and equals the JAX package's run at the same depth.
    Returns ``(None, None)`` when the state has no device image (the
    caller decides what that means).
    """
    st = make_state(p)
    if st.dev is None:
        return None, None
    kG = st.k
    n = hg.n
    base, rem = divmod(n, k)
    targets = np.zeros(kG, dtype=np.int64)
    targets[:k] = base + (np.arange(k) < rem)
    targets_i32 = targets.astype(np.int32)
    acc = np.zeros(kG, dtype=np.int64)
    R, P, t = p.rows, p.pool_cap, p.t
    delta_cap = max(2 * kG * t, kG)
    depth = max(1, int(p.pipeline_depth))
    fringe = np.full((kG, 1), -1, dtype=np.int32)   # fringe-free scoring

    # seed every phase with one random vertex (paper §III-B1 step 1)
    seeds = st.random_unassigned(int((targets > 0).sum()))
    gi = 0
    for g in range(kG):
        if targets[g] == 0 or gi >= seeds.size:
            continue
        v = seeds[gi:gi + 1]
        gi += 1
        st.assign_now(v, g)
        st.activate_phase(v, g)
        acc[g] += 1

    cur_depth = depth
    inflight: collections.deque = collections.deque()

    def harvest_next() -> int:
        h = inflight.popleft()
        return st.harvest(h, acc, targets, [e.fresh_ids for e in inflight])

    while True:
        progress = 0
        active = np.flatnonzero(acc < targets)
        if active.size == 0:
            break
        while len(inflight) >= cur_depth:   # tail heuristic shrank
            progress += harvest_next()
        t0 = time.perf_counter()
        packed, injected = st.pack_superstep(active, R, P, t, targets, acc)
        progress += injected
        if packed is not None:
            fresh, bias, pool_arr, fresh_ids = packed
            handle = st.dispatch(fresh, bias, pool_arr, fringe, fresh_ids,
                                 targets_i32, delta_cap, t)
        st.stats.host_s += time.perf_counter() - t0
        if packed is not None:
            inflight.append(handle)
        elif inflight:
            st.stats.pipeline_stalls += 1   # device idles this round
        if inflight and (len(inflight) >= cur_depth or packed is None):
            harvested = harvest_next()
            progress += harvested
            # adaptive depth: while a superstep admits less than half
            # its capacity, speculative packs only waste device calls;
            # drop to lock-step until admissions recover. Deterministic:
            # based solely on mirrored results.
            cur_depth = 1 if 2 * harvested < active.size * t else depth
        if progress == 0 and not inflight:
            break   # starved: remaining vertices sit in other pools
    while inflight:     # drain the pipeline before the safety net
        harvest_next()

    # safety net: balance-fill any stragglers into underfull phases
    rem_v = np.flatnonzero(st.assignment < 0)
    if rem_v.size:
        deficit = np.maximum(targets - acc, 0)
        fill = np.repeat(np.arange(kG), deficit)[:rem_v.size]
        st.assignment[rem_v[:fill.size]] = fill.astype(np.int32)
    st.in_pool[:] = False
    # the host assignment is authoritative; the last injections' delta
    # dies with the state
    st.delta_ids, st.delta_vals = [], []
    return st.assignment, st


def maybe_refine(hg: Hypergraph, k: int, params, assignment: np.ndarray,
                 stats: BatchedStats, device) -> np.ndarray:
    """Run the k-way refinement post-pass when ``refine_passes`` > 0.

    Boundary vertices are screened on ``device`` by the ``kway_gains_csr``
    kernel and moved under exact-gain, balance-capped admission, so the
    engine's ``max - min <= 1`` contract survives. ``refine_passes = 0``
    returns the assignment object untouched.
    """
    passes = getattr(params, "refine_passes", 0)
    if passes <= 0 or k <= 1:
        return assignment
    from ..core.refine import refine_kway

    refined, rstats = refine_kway(hg, assignment, k, passes, device=device)
    stats.refine = rstats
    return refined
