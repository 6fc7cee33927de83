"""Batched-candidate HYPE (``hype_batched``): host growth, device scores.

The port of ``src/repro/engines/batched.py``. Partitions grow one after
another; per growth step:

  1. when the candidate pool runs low, draw a bulk batch of candidate
     vertices from the smallest active hyperedges (size-bucketed queues,
     one vectorized pin scan per draw),
  2. gather their unassigned-neighbour lists as dense (b, L) tiles
     (``scoring.neighbor_tile_adj``; assigned pins dropped, hubs capped),
  3. score every cache-miss candidate through the ``hype_scores`` kernel
     on the entry point's device (the tile is built in numpy and
     uploaded per call),
  4. keep scored candidates in a pool sorted by score (the paper's
     s-sized fringe is its top s) and admit the top ``t`` per step.

``t=1`` recovers the sequential admission order. Snapshots are
phase-granular: between phases every transient (score cache, pool,
buckets) is empty, so a checkpoint is the assignment, the edge flags and
the random stream. Each kernel call runs under ``_guarded_kernel``; a
tile poisoned by an injected ``nan`` fault is quarantined and its rows
rescored on the host (``_rescore_rows``), bit-equal to a clean call. A
non-finite score from a call that no fault poisoned is the kernel's own
fault and raises ``RuntimeError``: nothing moves its work to the host.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..core.hypergraph import Hypergraph
from ..core import resilience, scoring
from ..kernels.hype_score.ops import hype_scores
from .runtime import BatchedStats, EngineRuntime, maybe_refine


@dataclasses.dataclass
class BatchedParams:
    """Knobs of the batched engine: the JAX ``BatchedParams`` fields with
    the same defaults and meaning."""
    b: int = 256           # rows per kernel tile (the paper's r=2)
    s: int = 16            # max fringe size (kernel compares vs s slots)
    t: int = 8             # admissions per step; 1 = sequential order
    pool_cap: int = 64     # scored candidates held between steps
    refill_lo: int = 64    # refill the pool when it drops below this
    cap_pins: int = 3072   # pins scanned per candidate before truncation
    kernel_min: int = 16   # min batch worth a device call; smaller
    #                        dribbles score on host (same formula and hub
    #                        truncation convention as the kernel tiles)
    refine_passes: int = 0  # post-pass boundary-refinement passes; 0 = off
    seed: int = 0
    # checkpoint cadence in completed phases (batched) or supersteps
    # (the device engines); 0 = never. A resumed run equals the
    # uninterrupted run with the same cadence.
    snapshot_every: int = 0
    snapshot_dir: Optional[str] = None   # where snapshots are published
    keep_last: int = 3          # snapshots the GC keeps per directory
    resume: Optional[str] = None    # snapshot file or directory; a
    #                                 missing or empty one starts fresh
    fault_plan: Optional[object] = None  # resilience.FaultPlan, a spec
    #                                      string, or None: the
    #                                      REPRO_FAULT_PLAN variable
    max_retries: int = 2        # injected transient faults a call retries
    retry_backoff_s: float = 0.01   # linear backoff between retries


class BatchedState(EngineRuntime):
    """Mutable state for the k growth phases (host side, numpy)."""

    def __init__(self, hg: Hypergraph, k: int, p: BatchedParams, device):
        super().__init__(hg, k, p)
        n, m = hg.n, hg.m
        self.device = torch.device(device)
        self.in_fringe = np.zeros(n, dtype=bool)
        self.cur_fringe = np.empty(0, dtype=np.int64)
        self.cache = np.full(n, -1.0)
        self.edge_epoch = np.full(m, -1, dtype=np.int32)   # activation epoch
        # size-bucketed active-edge queues (the paper's min-heap):
        # buckets[size] is a FIFO of edge-id arrays; scanning pops from the
        # front and re-queues still-live edges at the front, so smallest
        # edges keep being drawn first, like the heap's requeue.
        self.buckets: dict = {}
        self._fringe_buf = np.full(p.s, -1, dtype=np.int32)

    def set_fringe(self, new_fringe: np.ndarray) -> None:
        """Sync the s-sized fringe view (paper's F) used for scoring."""
        self.in_fringe[self.cur_fringe] = False
        self.in_fringe[new_fringe] = True
        self.cur_fringe = new_fringe
        self._fringe_buf[:] = -1
        self._fringe_buf[:new_fringe.size] = new_fringe

    # ------------------------------------------------------------------ #
    def activate(self, vs: np.ndarray, phase: int) -> None:
        """Mark the edges incident to newly admitted vertices active."""
        edges, _ = scoring.gather_csr_rows(
            self.hg.v2e_indptr, self.hg.v2e_indices, vs)
        if edges.size == 0:
            return
        edges = np.unique(edges.astype(np.int64))
        fresh = edges[(self.edge_epoch[edges] != phase)
                      & ~self.edge_dead[edges]]
        if fresh.size == 0:
            return
        self.edge_epoch[fresh] = phase
        sizes = self.edge_sizes[fresh]
        for sz in np.unique(sizes):
            self.buckets.setdefault(int(sz), collections.deque()).append(
                fresh[sizes == sz])

    # ------------------------------------------------------------------ #
    def draw_candidates(self, need: int) -> np.ndarray:
        """Up to ``need`` distinct universe vertices from smallest edges.

        One vectorized pass: pull edges smallest-size-first under a pin
        budget, scan all their pins at once, retire dead edges (no
        unassigned pin left, forever), requeue the still-live ones at
        the bucket fronts so they are rescanned first next time (the
        heap's requeue, without the heap).
        """
        buckets = self.buckets
        in_pool = self.in_pool
        if need <= 0:
            return np.empty(0, dtype=np.int64)
        budget = max(4 * need, 512)
        batches: list = []
        keys: list = []     # (source bucket key, count) pairs, for requeues
        pulled = 0
        for sz in sorted(buckets.keys()):
            q = buckets[sz]
            while q and pulled < budget:
                arr = q.popleft()
                n_take = (budget - pulled + sz - 1) // max(sz, 1)
                if arr.size > n_take:
                    q.appendleft(arr[n_take:])
                    arr = arr[:n_take]
                batches.append(arr)
                keys.append((sz, arr.size))
                pulled += arr.size * max(sz, 1)
            if not q:
                del buckets[sz]
            if pulled >= budget:
                break
        if not batches:
            return np.empty(0, dtype=np.int64)
        edges = np.concatenate(batches)
        pins, prow = scoring.gather_csr_rows(
            self.hg.e2v_indptr, self.hg.e2v_indices, edges)
        pins = pins.astype(np.int64)
        self.stats.edges_scanned += pins.size
        unassigned = self.assignment[pins] < 0
        live = np.bincount(prow[unassigned], minlength=edges.size) > 0
        if not live.all():
            self.edge_dead[edges[~live]] = True     # dead forever
        live_edges = edges[live]
        if live_edges.size:
            # requeue under the key each edge was drawn from
            lkey = np.repeat([k for k, _ in keys],
                             [c for _, c in keys])[live]
            for s in np.unique(lkey):
                buckets.setdefault(
                    int(s), collections.deque()).appendleft(
                        live_edges[lkey == s])
        fresh = unassigned & ~in_pool[pins]
        cand = pins[fresh]
        if cand.size:
            _, first = np.unique(cand, return_index=True)
            cand = cand[np.sort(first)][:need]
        return cand

    # ------------------------------------------------------------------ #
    def score_misses(self, cand: np.ndarray) -> None:
        """Score cache-miss candidates in one batched pass, fill the cache.

        Batches of at least ``kernel_min`` rows go through the
        ``hype_scores`` kernel as (b, L) tiles on ``self.device``;
        smaller dribbles are scored by the exact same formula on host.
        """
        if cand.size == 0:
            return
        miss = cand[self.cache[cand] < 0.0]
        self.stats.cache_hits += cand.size - miss.size
        if miss.size == 0:
            return
        if miss.size >= self.p.kernel_min:
            fringe_dev = torch.from_numpy(self._fringe_buf).to(self.device)
            for lo in range(0, miss.size, self.p.b):
                chunk = miss[lo:lo + self.p.b]
                # two B buckets (64 / b): small top-up batches avoid
                # paying for a full-width tile
                pad_b = 64 if chunk.size <= 64 else self.p.b
                if self.adj is not None:
                    tile, truncated = scoring.neighbor_tile_adj(
                        self.adj, chunk, self.assignment, pad_b=pad_b)
                else:
                    tile, truncated = scoring.neighbor_tile(
                        self.hg, chunk, self.assignment,
                        cap_pins=self.p.cap_pins, pad_b=pad_b)
                ordinal = self.stats.kernel_calls + 1
                out = self._guarded_kernel(
                    lambda: hype_scores(
                        torch.from_numpy(tile).to(self.device),
                        fringe_dev).cpu().numpy(),
                    ordinal).astype(np.float64)
                sc = out[:chunk.size]
                if not np.isfinite(sc).all():
                    # the kernel's int32 counts are always finite: any
                    # other score is its own fault, and nothing rescores it
                    raise RuntimeError(
                        f"the hype_scores kernel gave non-finite scores "
                        f"at kernel call {ordinal} with no injected fault")
                if self.fire_fault(("nan",), ordinal,
                                   f"injected fatal nan tile at kernel "
                                   f"call {ordinal}") is not None:
                    # the injected tile is poisoned whole: quarantine it
                    # and rescore its rows on the host
                    sc[:] = self._rescore_rows(chunk)
                    self.stats.host_rows += int(chunk.size)
                sc[truncated] += scoring.TRUNC_PENALTY
                self.cache[chunk] = sc
                self.stats.kernel_calls += 1
                self.stats.kernel_rows += int(chunk.size)
        else:
            if self.adj is not None:
                sc = scoring.batched_dext_adj(
                    self.adj, miss, self.in_fringe, self.assignment)
            else:
                sc = scoring.batched_dext_numpy(
                    self.hg, miss, self.in_fringe, self.assignment,
                    cap_pins=self.p.cap_pins,
                    max_width=scoring.L_BUCKETS[-1])
            self.stats.host_rows += int(miss.size)
            self.cache[miss] = sc

    def _rescore_rows(self, ids: np.ndarray) -> np.ndarray:
        """Host rescore of quarantined kernel rows.

        Rebuilds the clipped neighbour tile the kernel saw and counts as
        it does (valid entries minus fringe members), so the scores are
        bit-equal to a clean kernel call: its integer counts are exact in
        float32, and the caller adds the hub penalty either way.
        """
        if self.adj is not None:
            tile, _ = scoring.neighbor_tile_adj(
                self.adj, ids, self.assignment)
        else:
            tile, _ = scoring.neighbor_tile(
                self.hg, ids, self.assignment, cap_pins=self.p.cap_pins)
        tile = tile[:ids.size]
        valid = tile >= 0
        ent = np.where(valid, tile, 0)
        return (valid & ~self.in_fringe[ent]).sum(axis=1).astype(
            np.float64)


def _grow_partition(st: BatchedState, phase: int, target: int,
                    warm: bool = False) -> None:
    """Grow core set ``phase`` to ``target`` vertices.

    The step loop keeps a pool of up to ``pool_cap`` scored candidates
    sorted by cached score. Refills happen in bulk (one kernel tile per
    ``b`` rows) whenever the pool runs low; between refills a step is
    "admit the t best, queue their edges". The paper's s-sized fringe is
    the top s of the pool: what the scoring kernel subtracts, exactly
    like F in Eq. 1. ``warm`` continues a phase that already has members
    (a warm start from another engine's snapshot): they are activated
    instead of a seed, and growth resumes from their count.
    """
    p = st.p
    st.cache[:] = -1.0
    st.buckets = {}
    pool = np.empty(0, dtype=np.int64)       # kept sorted by score asc
    pending: list = []                       # admitted, edges not yet queued

    acc = 0
    if warm:
        members = np.flatnonzero(st.assignment == phase)
        acc = int(members.size)
        if acc >= target:
            return
        if acc:
            st.activate(members.astype(np.int64), phase)
    if acc == 0:
        seeds = st.random_unassigned(1)
        if seeds.size == 0:
            return
        st.assignment[seeds] = phase
        st.activate(seeds, phase)
        acc = 1

    while acc < target:
        st.stats.steps += 1
        # ------- refill: bulk-draw and kernel-score new candidates -------
        if pool.size < max(p.t, p.refill_lo):
            if pending:
                st.activate(np.concatenate(pending), phase)
                pending = []
            cand = st.draw_candidates(p.pool_cap - pool.size)
            if cand.size:
                st.score_misses(cand)
                st.in_pool[cand] = True
                pool = np.concatenate([pool, cand])
                pool = pool[np.argsort(st.cache[pool], kind="stable")]
                st.set_fringe(pool[:p.s])
        if pool.size == 0:                    # random restart: seed up to
            # t fresh growth points, so isolated vertices of a shattered
            # remainder do not cost a full step each
            vs = st.random_unassigned(p.t)
            if vs.size == 0:
                return
            st.stats.random_restarts += 1
            pool = vs
            st.in_pool[vs] = True
            st.cache[vs] = 0.0
            st.set_fringe(pool[:p.s])
        # ------- core update: admit the t best pool vertices -------
        nt = min(p.t, target - acc, pool.size)
        admit, pool = pool[:nt], pool[nt:]
        st.assignment[admit] = phase
        st.in_pool[admit] = False
        pending.append(admit)
        st.set_fringe(pool[:p.s])
        acc += int(admit.size)

    # release fringe + pool back to the universe (paper §III-B1 step 4)
    st.set_fringe(np.empty(0, dtype=np.int64))
    st.in_pool[pool] = False


def hype_batched_partition(hg: Hypergraph, k: int,
                           params: Optional[BatchedParams] = None,
                           return_stats: bool = False, *, device):
    """Partition ``hg`` into ``k`` parts with batched-candidate HYPE.

    Returns a complete int32 assignment with ``max - min <= 1`` vertex
    balance (and the ``BatchedStats`` with ``return_stats``). ``device``
    is where the score tiles go (``"cuda"`` or ``"cpu"``). Every
    ``snapshot_every`` completed phases a checkpoint goes to
    ``snapshot_dir``; ``resume`` continues a same-config snapshot bit
    for bit and warm-starts every phase from another engine's.
    """
    if params is None:
        params = BatchedParams()
    if k < 1:
        raise ValueError("k must be >= 1")
    if params.t < 1 or params.b < 1 or params.s < 1:
        raise ValueError("b, s, t must all be >= 1")
    if params.pool_cap < 1:
        raise ValueError("pool_cap must be >= 1")
    if params.snapshot_every > 0 and not params.snapshot_dir:
        raise ValueError("snapshot_every requires snapshot_dir")
    st = BatchedState(hg, k, params, device)
    base, rem = divmod(hg.n, k)
    snap_every = max(0, int(params.snapshot_every or 0))
    config = {"k": k, "t": params.t, "b": params.b, "s": params.s,
              "pool_cap": params.pool_cap, "refill_lo": params.refill_lo,
              "cap_pins": params.cap_pins,
              "kernel_min": params.kernel_min, "seed": params.seed,
              "snapshot_every": snap_every}
    start = 0
    warm = False
    ckpt = (resilience.load_latest(params.resume) if params.resume
            else None)
    if ckpt is not None:
        t0 = time.perf_counter()
        resilience.check_checkpoint(ckpt, hg, k)
        if ckpt.engine == "hype_batched" and ckpt.config == config:
            pay = ckpt.payload
            st.assignment = pay["assignment"].copy()
            st.edge_dead = pay["edge_dead"].copy()
            st.edge_epoch = pay["edge_epoch"].copy()
            st.rand_ptr = int(pay["rand_ptr"])
            st.rng.bit_generator.state = pay["rng_state"]
            st.stats = dataclasses.replace(pay["stats"])
            start = int(pay["next_phase"])
        else:
            wa = resilience.warm_assignment(ckpt)
            got = wa >= 0
            st.assignment[got] = wa[got]
            warm = True
        st.stats.resumed_at = int(ckpt.superstep)
        st.stats.restore_s += time.perf_counter() - t0
    last_snap = start
    for i in range(start, k):
        if i == k - 1:
            rem_v = np.flatnonzero(st.assignment < 0)
            st.assignment[rem_v] = i
            st.in_fringe[:] = False
            break
        _grow_partition(st, i, base + (1 if i < rem else 0), warm=warm)
        if snap_every and i + 1 - last_snap >= snap_every:
            t0 = time.perf_counter()
            st.stats.snapshots += 1
            resilience.save_snapshot(
                params.snapshot_dir,
                resilience.PartitionCheckpoint(
                    "hype_batched", i + 1, hg.fingerprint(), dict(config),
                    {"assignment": st.assignment.copy(),
                     "edge_dead": st.edge_dead.copy(),
                     "edge_epoch": st.edge_epoch.copy(),
                     "rand_ptr": int(st.rand_ptr),
                     "rng_state": st.rng.bit_generator.state,
                     "stats": dataclasses.replace(st.stats),
                     "next_phase": i + 1}),
                keep_last=int(params.keep_last))
            st.stats.snapshot_s += time.perf_counter() - t0
            last_snap = i + 1
    assert (st.assignment >= 0).all()
    assignment = maybe_refine(hg, k, params, st.assignment, st.stats,
                              device)
    if return_stats:
        return assignment, st.stats
    return assignment


__all__ = ["BatchedParams", "BatchedState", "BatchedStats",
           "hype_batched_partition"]
