"""Shared engine runtime: host state core, counters, pipeline driver.

The port of ``src/repro/engines/runtime.py``: ``BatchedStats`` (the
counters the ported engines fill, and ``merge``), ``EngineRuntime`` (the
assignment mirror, pool membership, the seeded random stream, the fault
plan and ``_guarded_kernel``), ``SnapshotMixin`` (capture, exact restore
and cross-engine warm start of the pipeline state), ``run_pipeline``,
the double-buffered superstep driver at any ``pipeline_depth`` with its
snapshots, resume and poisoned-window replay, ``run_pipeline_budgeted``,
its memory-rung retry loop (``core/membudget.py``), and ``maybe_refine``,
the k-way refinement post-pass.

Only injected faults are retried or escalated (``_guarded_kernel``): a
real exception of a kernel, a build or a CUDA call propagates as itself,
where the JAX package retries any exception and then escalates it. On
the card a device-side error is sticky, so a retry cannot help, and the
degradation ladder would carry it down to a rung without the card. The
one exception is memory: a real allocator failure (``is_oom_error``), or
an injected non-fatal ``oom``, raises ``DeviceOOM``, and the retry loop
runs the same engine again at the next memory rung.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import time
from typing import Optional

import numpy as np

from ..core import membudget, resilience
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
    # sharded-engine counters (zero for the single-device engines):
    collectives: int = 0            # all_gather calls (one per superstep)
    collective_bytes: int = 0       # bytes the gathers materialise: the
    #                                 ranks x the global payload a superstep
    admission_conflicts: int = 0    # proposed admissions lost to the
    #                                 lowest-phase-wins rule
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
    graph_off_rounds: int = 0       # rounds run eagerly beside a captured
    #                                 graph (a poisoned round's chunk)
    # resilience counters (core/resilience.py):
    faults_injected: int = 0        # FaultPlan specs that fired this run
    retries: int = 0                # transient-fault retries + poisoned-
    #                                 superstep replays (never counted as
    #                                 extra kernel_calls / supersteps)
    fallbacks: int = 0              # ladder rungs abandoned before this
    #                                 engine ran (partition_resilient)
    snapshots: int = 0              # checkpoints published
    snapshot_s: float = 0.0         # wall-clock publishing checkpoints
    restore_s: float = 0.0          # wall-clock restoring the resume ckpt
    resumed_at: int = -1            # superstep/phase the run resumed
    #                                 from; -1 = fresh start
    # memory-budget counters (core/membudget.py):
    mem_retries: int = 0            # DeviceOOM-driven same-engine retries
    #                                 (real allocator failures + injected
    #                                 non-fatal oom faults)
    plan_rung: int = -1             # memory-plan rung the run executed at;
    #                                 -1 = engine never planned (host path)
    peak_bytes_planned: int = 0     # the plan's modeled peak device bytes
    peak_bytes_observed: int = 0    # max_memory_allocated on the card; the
    #                                 planned bytes on the CPU
    page_uploads: int = 0           # paged-adjacency chunk uploads
    page_hits: int = 0              # chunk requests served LRU-resident
    page_evictions: int = 0         # chunks evicted to stay under budget
    page_bytes: int = 0             # total bytes uploaded by the pager
    # refinement post-pass (None unless refine_passes > 0 ran):
    refine: Optional[object] = None     # core.refine.RefineStats

    # high-water marks and identities: ``merge`` keeps the max
    _MERGE_MAX = ("loop_store_peak", "loop_state_bytes",
                  "peak_bytes_planned", "peak_bytes_observed",
                  "device_image_bytes", "plan_rung", "graph_nodes",
                  "tile_l", "resumed_at")

    def merge(self, other: "BatchedStats") -> "BatchedStats":
        """Combine two runs' counters into a new ``BatchedStats``.

        Additive counters sum; peak and identity fields keep the max;
        the later run's ``refine`` record wins (the earlier one refined
        an assignment that no longer exists). JAX's rule.
        """
        out = BatchedStats()
        for f in dataclasses.fields(BatchedStats):
            a, b = getattr(self, f.name), getattr(other, f.name)
            if f.name == "refine":
                out.refine = b if b is not None else a
            elif f.name in self._MERGE_MAX:
                setattr(out, f.name, max(a, b))
            else:
                setattr(out, f.name, a + b)
        return out


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
        # the knob's plan (one instance shared across a degradation
        # ladder) or a fresh parse of REPRO_FAULT_PLAN for each run
        self.fault_plan = resilience.resolve_fault_plan(p.fault_plan)

    def fire_fault(self, kinds, ordinal: int, fatal_msg=None,
                   oom_msg=None):
        """Fire the plan's first pending spec of ``kinds`` at ``ordinal``.

        Returns the spec (counted in ``faults_injected``), or None. A
        fatal spec raises ``UnrecoverableFault`` with ``fatal_msg``, its
        ``{kind}`` filled in (by default the JAX engines' message for the
        dispatch site); a non-fatal ``oom`` raises ``DeviceOOM`` with
        ``oom_msg`` (by default the dispatch site's), carrying the rung
        this state planned.
        """
        plan = self.fault_plan
        sp = plan.fire(kinds, ordinal) if plan is not None else None
        if sp is None:
            return None
        self.stats.faults_injected += 1
        if sp.fatal:
            raise resilience.UnrecoverableFault(
                fatal_msg.format(kind=sp.kind) if fatal_msg else
                str(resilience.FaultInjected(sp.kind, ordinal, True)))
        if sp.kind == "oom":
            raise membudget.DeviceOOM(
                oom_msg or str(resilience.FaultInjected(sp.kind, ordinal)),
                rung=getattr(self, "mem_rung", None))
        return sp

    def _guarded_kernel(self, fn, ordinal: int, kinds=("dispatch",)):
        """Run a device call under fault injection and bounded retry.

        An injected fault fires before the call (the dispatch site), so
        a retry re-issues the identical computation, which keeps the
        recovery bit-identical to a fault-free run. A fatal spec or an
        exhausted retry budget raises ``UnrecoverableFault`` for the
        ladder. A real allocator failure of ``fn`` (``is_oom_error``)
        raises ``DeviceOOM`` for the memory-rung retry loop; anything else
        ``fn`` raises propagates unchanged.
        """
        attempts = 0
        while True:
            sp = self.fire_fault(kinds, ordinal)
            if sp is None:
                return membudget.oom_guard(fn, "device allocation failed",
                                 getattr(self, "mem_rung", None))
            attempts += 1
            if attempts > int(self.p.max_retries):
                err = resilience.FaultInjected(sp.kind, ordinal)
                raise resilience.UnrecoverableFault(
                    f"retry budget ({self.p.max_retries}) exhausted: "
                    f"{err!r}") from err
            self.stats.retries += 1
            time.sleep(float(self.p.retry_backoff_s) * attempts)

    def random_unassigned(self, count: int = 1,
                          in_pool: Optional[np.ndarray] = None
                          ) -> np.ndarray:
        """Next ``count`` unassigned non-pool vertices of the random stream.

        Vectorized skip-pointer scan over the shuffled order; the pointer
        only advances past consumed positions so no vertex is skipped.
        ``in_pool`` is the pool-membership mask to respect (the sharded
        engine keeps one per phase group); by default the engine-wide one.
        """
        if in_pool is None:
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


class SnapshotMixin:
    """Snapshot and resume of the pipeline state (``PipelineState``).

    Captures the whole engine state at a drained superstep boundary,
    restores it bit for bit for a same-engine, same-config resume, and
    warm-starts growth from another engine's snapshot.
    """

    def capture_payload(self, acc: np.ndarray, cur_depth: int) -> dict:
        """The engine state at a drained superstep boundary.

        The driver drains the pipeline first, so the live state is the
        host bookkeeping plus the settled device image (downloaded here,
        scratch slots included). Static derivatives (adjacency, tile
        width, random order) are rebuilt from the config at restore.
        """
        self._store_flush()
        return {
            "assignment": self.assignment.copy(),
            "acc": acc.copy(),
            "cur_depth": int(cur_depth),
            "in_pool": self.in_pool.copy(),
            "cache_scored": self.cache_scored.copy(),
            "pools": [ids.copy() for ids in self.pools],
            "bq_key": self.bq_key.copy(),
            "bq_edge": self.bq_edge.copy(),
            "seq_back": int(self._seq_back),
            "seq_front": int(self._seq_front),
            "edge_queued": self.edge_queued.copy(),
            "edge_dead": self.edge_dead.copy(),
            "delta_ids": [a.copy() for a in self.delta_ids],
            "delta_vals": [a.copy() for a in self.delta_vals],
            "pending_dirty": [a.copy() for a in self.pending_dirty],
            "rand_ptr": int(self.rand_ptr),
            "rng_state": self.rng.bit_generator.state,
            "dirty_ratchet": int(self._dirty_ratchet),
            "stats": dataclasses.replace(self.stats),
            "dev_assign": self.dev_assign.cpu().numpy(),
            # on the spill rung the authoritative cache is the host mirror
            "dev_cache": (self.host_cache.copy()
                          if self.host_cache is not None
                          else self.dev_cache.cpu().numpy()),
            "dev_acc": self.dev_acc.cpu().numpy(),
        }

    def restore_exact(self, pay: dict):
        """Resume bit for bit from a same-engine, same-config payload.

        Returns ``(acc, cur_depth)`` for the driver. The device image is
        uploaded from the snapshot's copies; the poison flag restarts
        clean (snapshots are taken only at drained, replayed boundaries).
        """
        self.assignment = pay["assignment"].copy()
        self.in_pool = pay["in_pool"].copy()
        self.cache_scored = pay["cache_scored"].copy()
        self.pools = [ids.copy() for ids in pay["pools"]]
        self.bq_key = pay["bq_key"].copy()
        self.bq_edge = pay["bq_edge"].copy()
        self._bq_pending = []
        self._seq_back = np.int64(pay["seq_back"])
        self._seq_front = np.int64(pay["seq_front"])
        self.edge_queued = pay["edge_queued"].copy()
        self.edge_dead = pay["edge_dead"].copy()
        self.delta_ids = [a.copy() for a in pay["delta_ids"]]
        self.delta_vals = [a.copy() for a in pay["delta_vals"]]
        self.pending_dirty = [a.copy() for a in pay["pending_dirty"]]
        self.rand_ptr = int(pay["rand_ptr"])
        self.rng.bit_generator.state = pay["rng_state"]
        self._dirty_ratchet = int(pay["dirty_ratchet"])
        self.stats = dataclasses.replace(pay["stats"])
        self.dev_assign = self._to_device(pay["dev_assign"])
        if self.host_cache is not None:
            # the payload's cache has the device layout's scratch slot
            # unless a spill rung captured it
            self.host_cache = np.array(pay["dev_cache"][:self.hg.n],
                                       dtype=np.float32)
        else:
            self.dev_cache = self._to_device(
                _with_scratch(pay["dev_cache"], self.hg.n, -1.0))
        self.dev_acc = self._to_device(pay["dev_acc"])
        self.dev_poison = self._to_device(np.zeros(1, dtype=np.int32))
        return pay["acc"].copy(), int(pay["cur_depth"])

    def restore_warm(self, warm: np.ndarray) -> np.ndarray:
        """Cross-engine warm start: adopt a (partial) assignment.

        Mirrors it into the device image and activates the incident
        edges of every adopted member, so growth continues from the
        snapshot instead of from scratch (the degradation ladder's path;
        exactness is not claimed). Returns the per-phase totals.
        """
        done = np.flatnonzero(warm >= 0)
        acc = np.zeros(self.k, dtype=np.int64)
        if done.size:
            ph = warm[done].astype(np.int64)
            self.assignment[done] = warm[done]
            acc[:int(ph.max()) + 1] = np.bincount(ph)
            # the scratch slots: -1 past the assignment, 0 past the totals
            self.dev_assign = self._to_device(
                np.append(self.assignment, -1).astype(np.int32))
            self.dev_acc = self._to_device(
                np.append(acc, 0).astype(np.int32))
            self.activate_many(done.astype(np.int64), ph)
        return acc


def _with_scratch(cache: np.ndarray, n: int, pad) -> np.ndarray:
    """A snapshot's cache in the device layout: (n + 1,), the scratch
    slot appended when a spill rung captured it without one."""
    if cache.shape[0] == n:
        return np.append(cache, np.float32(pad)).astype(np.float32)
    return cache


def raise_kernel_poison():
    """A superstep that no injected ``nan`` poisoned scored a real row
    non-finite: the kernel is at fault, and nothing retries it."""
    raise RuntimeError(
        "a superstep scored a real row non-finite with no injected "
        "fault: the hype_score_select kernel emits non-finite scores "
        "for finite inputs")


def _harvest_next(st, inflight: collections.deque, acc: np.ndarray,
                  targets: np.ndarray) -> int:
    """Harvest the oldest in-flight superstep, replaying a poisoned one.

    When the popped superstep was quarantined (a non-finite score,
    normally an injected NaN tile), every superstep dispatched after it
    reverted itself on the sticky poison flag: replay the whole window
    in FIFO order from the handles' clean arguments, so the device sees
    its effects in the same order and the recovery is bit-identical.
    """
    h = inflight.popleft()
    if st.poisoned(h):
        if not h.injected:
            raise_kernel_poison()
        h = st.replay(h)
        redo = list(inflight)
        inflight.clear()
        for old in redo:
            inflight.append(st.replay(old))
    return st.harvest(h, acc, targets, [e.fresh_ids for e in inflight])


def _teardown_pipeline(st, inflight: collections.deque) -> None:
    """Settle an aborted run: wait for every in-flight superstep's copy,
    then drop the handles and the queued host transients, so the process
    is free to start a fresh run."""
    for h in list(inflight):
        if h.ready is not None:
            try:
                h.ready.synchronize()
            except Exception:       # the abort may have broken the call
                pass
    inflight.clear()
    st.delta_ids, st.delta_vals = [], []
    st.pending_dirty = []


def run_pipeline(hg: Hypergraph, k: int, p, make_state, engine: str,
                 devices: int = 0, mem_rung: int = 0,
                 mem_warm: Optional[np.ndarray] = None,
                 mem_retries: int = 0):
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
    caller decides what that means). ``engine`` and ``devices`` name the
    schedule in snapshot configs.

    Every ``p.snapshot_every`` supersteps the driver drains the pipeline
    and publishes a checkpoint to ``p.snapshot_dir``; with ``p.resume``
    naming a same-engine, same-config snapshot the run restores it and
    continues bit for bit as an uninterrupted run with the same cadence
    (another engine's snapshot warm-starts from its assignment). Any
    exception tears the pipeline down before it propagates.

    ``make_state(p, mem_rung)`` builds the state at memory rung
    ``mem_rung`` or the first one from there that fits the budget. A
    ``DeviceOOM`` leaves enriched with the rung this attempt ran at and
    the host assignment mirror (``partial``); ``mem_warm``, a failed
    attempt's mirror, warm-starts the run, and ``mem_retries`` is
    recorded in its stats (``run_pipeline_budgeted``).
    """
    st = make_state(p, mem_rung)
    if st.dev is None:
        return None, None
    st.stats.mem_retries = int(mem_retries)
    kG = st.k
    n = hg.n
    base, rem = divmod(n, k)
    targets = np.zeros(kG, dtype=np.int64)
    targets[:k] = base + (np.arange(k) < rem)
    targets_i32 = targets.astype(np.int32)
    acc = np.zeros(kG, dtype=np.int64)
    R, P, t = p.rows, p.pool_cap, p.t
    delta_cap = max(2 * kG * t, kG)
    # the memory plan may clamp the pipeline to lock-step (rungs from the
    # depth reduction on); at rung 0 it echoes the knob
    depth = max(1, min(int(p.pipeline_depth),
                       int(st.mem_plan.pipeline_depth)))
    fringe = np.full((kG, 1), -1, dtype=np.int32)   # fringe-free scoring
    snap_every = max(0, int(p.snapshot_every or 0))
    # everything that decides the superstep schedule: an exact restore
    # needs all of it to match (the cadence too: the drain at a snapshot
    # is part of the schedule at depth > 1). Of the memory plan only the
    # effective tile width and the depth clamp enter: the chunk, spill
    # and paged rungs are bit-exact per superstep, so a snapshot restores
    # exactly across them
    config = {"k": k, "devices": devices, "t": t, "rows": R,
              "pool_cap": P, "s": p.s, "seed": p.seed,
              "pipeline_depth": depth, "snapshot_every": snap_every,
              "tile_l": int(st.tile_l)}

    cur_depth = depth
    seeded = False
    ckpt = resilience.load_latest(p.resume) if p.resume else None
    if ckpt is not None:
        t0 = time.perf_counter()
        resilience.check_checkpoint(ckpt, hg, k)
        if ckpt.engine == engine and ckpt.config == config:
            acc, cur_depth = st.restore_exact(ckpt.payload)
            seeded = True       # the snapshot carries the seeds
        else:
            acc = st.restore_warm(resilience.warm_assignment(ckpt))
        st.stats.resumed_at = int(ckpt.superstep)
        st.stats.restore_s += time.perf_counter() - t0
    elif mem_warm is not None:
        # a memory-rung retry: adopt the failed attempt's host mirror so
        # the members grown so far survive; the seeding below fills only
        # the phases it left empty
        acc = st.restore_warm(np.asarray(mem_warm, dtype=np.int32))

    if not seeded:
        # seed every empty phase with one random vertex (paper §III-B1
        # step 1); a warm start seeds only the phases it left empty
        seeds = st.random_unassigned(
            int(((acc == 0) & (targets > 0)).sum()))
        gi = 0
        for g in range(kG):
            if targets[g] == 0 or acc[g] > 0 or gi >= seeds.size:
                continue
            v = seeds[gi:gi + 1]
            gi += 1
            st.assign_now(v, g)
            st.activate_phase(v, g)
            acc[g] += 1

    last_snap = int(st.stats.supersteps)
    inflight: collections.deque = collections.deque()
    try:
        while True:
            progress = 0
            if snap_every and st.stats.supersteps - last_snap >= snap_every:
                while inflight:     # drain: snapshots see settled state
                    progress += _harvest_next(st, inflight, acc, targets)
                t0 = time.perf_counter()
                st.stats.snapshots += 1
                payload = st.capture_payload(acc, cur_depth)
                # under a process group one rank writes, and every rank
                # waits for the write before it goes on
                if st.snapshot_writer:
                    resilience.save_snapshot(
                        p.snapshot_dir,
                        resilience.PartitionCheckpoint(
                            engine, int(st.stats.supersteps),
                            hg.fingerprint(), dict(config), payload),
                        keep_last=int(p.keep_last))
                st.snapshot_published()
                st.stats.snapshot_s += time.perf_counter() - t0
                last_snap = int(st.stats.supersteps)
            active = np.flatnonzero(acc < targets)
            if active.size == 0:
                break
            while len(inflight) >= cur_depth:   # tail heuristic shrank
                progress += _harvest_next(st, inflight, acc, targets)
            t0 = time.perf_counter()
            packed, injected = st.pack_superstep(active, R, P, t, targets,
                                                 acc)
            progress += injected
            if packed is not None:
                fresh, bias, pool_arr, fresh_ids = packed
                handle = st.dispatch(fresh, bias, pool_arr, fringe,
                                     fresh_ids, targets_i32, delta_cap, t)
            st.stats.host_s += time.perf_counter() - t0
            if packed is not None:
                inflight.append(handle)
            elif inflight:
                st.stats.pipeline_stalls += 1   # device idles this round
            if inflight and (len(inflight) >= cur_depth or packed is None):
                harvested = _harvest_next(st, inflight, acc, targets)
                progress += harvested
                # adaptive depth: while a superstep admits less than half
                # its capacity, speculative packs only waste device
                # calls; drop to lock-step until admissions recover.
                # Deterministic: based solely on mirrored results.
                cur_depth = 1 if 2 * harvested < active.size * t else depth
            if progress == 0 and not inflight:
                break   # starved: remaining vertices sit in other pools
        while inflight:     # drain the pipeline before the safety net
            _harvest_next(st, inflight, acc, targets)
    except membudget.DeviceOOM as exc:
        # a memory fault mid-run: settle the pipeline, then give the retry
        # loop the rung this attempt ran at and the admissions harvested
        # so far (numpy: nothing of the device image rides the exception)
        _teardown_pipeline(st, inflight)
        if exc.rung is None:
            exc.rung = int(st.mem_plan.rung)
        exc.partial = st.assignment.copy()
        raise
    except BaseException:
        _teardown_pipeline(st, inflight)
        raise

    # safety net: balance-fill any stragglers into underfull phases
    rem_v = np.flatnonzero(st.assignment < 0)
    if rem_v.size:
        deficit = np.maximum(targets - acc, 0)
        fill = np.repeat(np.arange(kG), deficit)[:rem_v.size]
        st.assignment[rem_v[:fill.size]] = fill.astype(np.int32)
    st.release_pools()
    # the host assignment is authoritative; the last injections' delta
    # dies with the state
    st.delta_ids, st.delta_vals = [], []
    st.stats.peak_bytes_observed = int(
        membudget.observed_peak_bytes(st.device)
        or st.stats.peak_bytes_planned)
    return st.assignment, st


def run_pipeline_budgeted(hg: Hypergraph, k: int, p, make_state,
                          engine: str, devices: int = 0):
    """``run_pipeline`` under the memory-rung retry loop.

    A ``DeviceOOM`` (a real allocator failure at the upload, dispatch or
    harvest site, or an injected non-fatal ``oom``) runs the same engine
    again at the next smaller memory plan, warm-started from the failed
    attempt's host assignment mirror, before the degradation ladder
    (``partition_resilient``) is consulted. Only an exhausted rung ladder
    escalates, as ``UnrecoverableFault``. The fault plan is resolved once,
    so a one-shot injected ``oom`` stays consumed across retries.

    Under a process group (the sharded engine) every rank walks the rungs
    together: the state agrees its planned rung across the ranks before
    the upload (an ``all_reduce`` of the rung index, MAX), and an injected
    ``oom`` fires on every rank at the same ordinal.

    The next rung starts after the ``except`` block has let go of the
    exception, and with it of the failed attempt's frames (its state, its
    device image and its queued transfers), so their card memory is back
    in the allocator before the retry allocates.
    """
    fplan = resilience.resolve_fault_plan(p.fault_plan)
    if fplan is not None:
        p = dataclasses.replace(p, fault_plan=fplan)
    rung, warm, retries = 0, None, 0
    while True:
        try:
            return run_pipeline(hg, k, p, make_state, engine, devices,
                                mem_rung=rung, mem_warm=warm,
                                mem_retries=retries)
        except membudget.DeviceOOM as exc:
            failed, partial = exc.rung, exc.partial
        except membudget.MemoryLadderExhausted as exc:
            raise resilience.UnrecoverableFault(
                f"device memory rungs exhausted: {exc}") from exc
        gc.collect()
        retries += 1
        rung = (rung if failed is None else int(failed)) + 1
        if partial is not None and (partial >= 0).any():
            warm = partial


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
