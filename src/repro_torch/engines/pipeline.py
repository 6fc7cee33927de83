"""Shared superstep pipeline state: the host half of the device engines.

The port of ``src/repro/engines/pipeline.py`` for this slice. The host
keeps only ids and flags (assignment mirror, pool id lists, the flat
active-edge bucket store, a has-been-scored bitmask); every *score*
lives in the device cache. ``pack_superstep`` draws the next candidates,
``dispatch`` launches one superstep (asynchronously on CUDA) and
``harvest`` mirrors its admissions, possibly supersteps later.

The device image is uploaded once as torch tensors: the unique-neighbour
CSR (``Hypergraph.device_adjacency``, ``indptr`` int32 below 2**31
pins), the assignment, the score cache, the per-phase admission counter
and the poison flag. Before the upload the memory plan
(``core/membudget.py``) sizes all of it against the budget and picks the
rung: the gather width ``tile_l``, phase chunks ``g_chunk``, the depth
clamp, the score cache spilled to a host float32 mirror
(``host_cache``), or a paged CSR (``paged_adj``, with ``dev`` a
``(None, None)`` sentinel). Every rung runs on the device the state
was given.

Faults (``core/resilience.py``): a ``dispatch`` spec fires before a
superstep's launch and is retried by ``_guarded_kernel``; a ``nan`` spec
poisons the bias of the superstep's fresh rows, so the program's
quarantine reverts it on the device; ``harvest`` (and the driver, for
the whole in-flight window) then replays it from its clean, already
uploaded arguments. A bare ``oom`` spec fires at the image upload, an
``oom@N`` at dispatch N; either, and a real allocator failure at the
upload, a dispatch or a harvest, raises ``DeviceOOM`` for the
memory-rung retry loop.

Transfers: one host-to-device copy per superstep (every small id buffer
packed into one pinned block) and one device-to-host copy (winners,
n_stale and poison in one int32 tensor, and on the spill rung the fresh
scores bit-cast behind them), issued right after the
superstep's own launches, so ``harvest`` blocks on that superstep only
and never on a later one in flight. ``dispatch`` launches nothing that
synchronizes with the device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..core import membudget, resilience, scoring
from ..core.hypergraph import Hypergraph
from .runtime import EngineRuntime, SnapshotMixin, raise_kernel_poison

# Flat bucket-store key layout: one sorted int64 per queued (phase,
# class, edge) activation -- phase in the top bits, the power-of-two
# size-class exponent below it, and a sequence number in the low bits.
# Keeping the store sorted by this key makes "draw smallest classes
# first, FIFO within a class, requeues at the front" a prefix scan per
# phase: back-appends allocate increasing sequence numbers, front
# requeues decreasing ones.
_PH_SHIFT = 50
_CLS_SHIFT = 44
_SEQ_START = np.int64(1) << 43


@dataclasses.dataclass
class _CallArgs:
    """One superstep's host-built buffers, uploaded as device tensors."""
    delta: torch.Tensor
    vals: torch.Tensor
    dirty: torch.Tensor
    dcnt: torch.Tensor
    fresh: torch.Tensor
    bias: torch.Tensor
    pool_arr: torch.Tensor
    fringe: torch.Tensor
    targets: torch.Tensor
    select_k: int
    # the (G, R) fresh ids on the host: the paged rung gathers their rows
    # and the spill rung adopts their scores
    host_fresh: np.ndarray
    # spill rung only: the held pool's scores from the host mirror, taken
    # after this dispatch's decrements, so a replay never applies them
    # twice
    prev: Optional[torch.Tensor] = None


@dataclasses.dataclass
class _Superstep:
    """One in-flight superstep: its result block and what harvest needs.

    ``out`` holds ``winners (G*select_k) | n_stale | poison`` as int32
    (then the (G*R) fresh scores as float32 bits on the spill rung, or
    the superstep's admission conflicts on the sharded engine) --
    a pinned host tensor on CUDA, filled by an async copy that ``ready``
    (a CUDA event) marks done; the device program's own tensor on CPU.
    ``args`` are the superstep's clean arguments, for a replay;
    ``injected`` marks a superstep that an injected ``nan`` poisoned.
    """
    out: torch.Tensor
    ready: Optional[torch.cuda.Event]
    fresh_ids: np.ndarray
    shape: tuple
    args: _CallArgs
    injected: bool = False


class PipelineState(SnapshotMixin, EngineRuntime):
    """The device-resident graph image and per-phase growth state."""

    # injected faults the dispatch site sees ("oom@N" simulates a
    # mid-run allocation failure)
    _fault_kinds = ("dispatch", "oom")
    # memory-rung reductions this engine has programs for
    _mem_features = membudget.SUPERSTEP_FEATURES

    def __init__(self, hg: Hypergraph, k: int, p, device,
                 mem_rung: int = 0):
        super().__init__(hg, k, p)
        self.device = torch.device(device)
        self.dev = None
        self.dev_cache = None       # device score cache (None when spilled)
        self.host_cache = None      # host float32 mirror (spill rung)
        self.paged_adj = None       # membudget.PagedAdjacency (paged rung)
        self.mem_plan = None
        self.g_chunk = 1
        self.mem_rung = int(mem_rung)
        if k >= 1 << (63 - _PH_SHIFT):      # bucket-store key width
            return
        if self.adj is None:        # hub-expansion guard tripped on host
            return
        membudget.reset_peak(self.device)
        deg = np.diff(self.adj[0])
        self.deg = deg
        # One gather width per run: the bucket of the 99.5th-percentile
        # degree. The handful of rows wider than that are truncated and
        # carry the hub penalty.
        self.tile_l = scoring._bucket_width(int(min(
            np.percentile(deg, 99.5) if deg.size else 1,
            scoring.L_BUCKETS[-1])))
        # the memory plan: every device tensor sized BEFORE the upload
        # against the resolved budget; ``mem_rung`` > 0 means an earlier
        # attempt ran out of memory and the retry loop wants a smaller
        # plan. An unconstrained budget at rung 0 keeps the tile choice
        # above. MemoryLadderExhausted propagates to the retry loop.
        rows = p.rows if p.rows else max(8, p.t)
        self.mem_budget = membudget.resolve_budget(
            getattr(p, "mem_budget", None), self.device)
        spec = membudget.MemSpec(
            n=hg.n, adj_pins=int(self.adj[1].size), k=k, rows=int(rows),
            pool_cap=int(p.pool_cap), t=int(p.t), tile_l=int(self.tile_l),
            pipeline_depth=max(1, int(p.pipeline_depth)))
        plan = membudget.plan_memory(spec, self.mem_budget,
                                     self._mem_features,
                                     rung_start=self.mem_rung)
        agreed = self._agree_rung(plan.rung)
        if agreed != plan.rung:
            plan = membudget.plan_memory(spec, self.mem_budget,
                                         self._mem_features,
                                         rung_start=agreed)
        self.mem_plan = plan
        self.mem_rung = plan.rung
        self.tile_l = plan.tile_l
        self.g_chunk = plan.g_chunk
        self.stats.tile_l = self.tile_l
        self.stats.plan_rung = plan.rung
        self.stats.peak_bytes_planned = int(plan.planned_bytes)
        # a simulated allocation failure at the image-upload site
        self.fire_fault(("oom",), 0,
                        "injected fatal OOM during device image upload",
                        "injected OOM during device image upload")
        membudget.oom_guard(lambda: self._upload_image(plan),
                            "device image upload failed", self.mem_rung)
        n, m = hg.n, hg.m
        self.cache_scored = np.zeros(n, dtype=bool)
        self.pools = [np.empty(0, dtype=np.int64) for _ in range(k)]
        # flat (phase, class, edge) bucket store: two parallel arrays
        # sorted by the composite key above
        self.bq_key = np.empty(0, dtype=np.int64)
        self.bq_edge = np.empty(0, dtype=np.int64)
        self._bq_pending: list = []     # rows awaiting the lazy merge
        self._seq_back = np.int64(_SEQ_START)
        self._seq_front = np.int64(_SEQ_START) - 1
        self.edge_queued = np.zeros((k, m), dtype=bool)
        self.delta_ids: list = []
        self.delta_vals: list = []
        self.pending_dirty: list = []   # queued winner decrements
        self._excl_scratch = np.zeros(n, dtype=bool)
        # the dirty-pair pad is pre-sized from the expected per-superstep
        # dirty rate and only ratchets up
        mean_deg = self.adj[1].size / max(hg.n, 1)
        expect = min(hg.n, max(256, int(2 * k * p.t * mean_deg)))
        self._dirty_ratchet = 1 << int(np.ceil(np.log2(expect + 1)))
        self.stats.device_image_bytes = int(sum(
            t.nbytes for t in (*self.dev, self.dev_assign, self.dev_cache,
                               self.dev_acc) if t is not None))

    def _upload_image(self, plan: membudget.MemPlan) -> None:
        """Upload the graph image at ``plan``'s rung: the CSR (or the
        pager that stands in for it), the assignment, the score cache (or
        its host mirror), the admission totals and the poison flag."""
        n, dev = self.hg.n, self.device
        if plan.paged:
            # no resident CSR: the pager uploads id-range chunks on demand
            # under its own LRU byte budget; ``dev`` keeps a non-None
            # sentinel so the driver takes the device path
            self.paged_adj = membudget.PagedAdjacency(
                self.adj, plan.page_bytes, self.stats, dev)
            self.dev = (None, None)
        else:
            # memoized on hg, so a refinement post-pass on the same
            # device reuses it
            self.dev = self.hg.device_adjacency(dev)
        # (n + 1,) / (k + 1,): the last element is the scratch slot that
        # absorbs masked-out scatters (see core/scoring.py)
        self.dev_assign = torch.full((n + 1,), -1, dtype=torch.int32,
                                     device=dev)
        if plan.spill_cache:
            self.host_cache = np.full(n, -1.0, dtype=np.float32)
        else:
            self.dev_cache = torch.full((n + 1,), -1.0,
                                        dtype=torch.float32, device=dev)
        self.dev_acc = torch.zeros(self.k + 1, dtype=torch.int32,
                                   device=dev)
        # sticky NaN-quarantine flag (scoring._poison_guard), and the
        # replay markers: 0 = a normal superstep, 1 = a replay
        self.dev_poison = torch.zeros(1, dtype=torch.int32, device=dev)
        self._reset = (torch.zeros(1, dtype=torch.int32, device=dev),
                       torch.ones(1, dtype=torch.int32, device=dev))

    # ------------------------------------------------------------------ #
    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """Upload a host array of the image (a snapshot's copy)."""
        return torch.from_numpy(np.array(arr)).to(self.device)

    # ---------------------------------------------- hooks of the engines
    # The single-device engine's pool mask is engine-wide and it runs
    # alone; the sharded engine overrides these with its per-group masks
    # and its process group.
    snapshot_writer = True      # this state writes the run's snapshots

    def _agree_rung(self, rung: int) -> int:
        """The memory rung every rank of the run plans (before upload)."""
        return rung

    def snapshot_published(self) -> None:
        """Called on every rank after a snapshot's publish."""

    def release_pools(self) -> None:
        """End-of-run hook: clear every pool-membership mask."""
        self.in_pool[:] = False

    def _pmask(self, g: int) -> np.ndarray:
        """The pool-membership mask that governs phase ``g``'s draws."""
        return self.in_pool

    def _restart_mask(self) -> np.ndarray:
        """The mask a restart must avoid: every pool of the engine.

        Injections reach the device image by an unconditional scatter, so
        they must never name a vertex that an in-flight superstep could
        still admit, i.e. anything in any pool.
        """
        return self.in_pool

    def _release_members(self, vs: np.ndarray, ph: np.ndarray) -> None:
        """Clear pool membership for freshly mirrored winners."""
        self.in_pool[vs] = False

    def _count_dispatch(self, fresh: np.ndarray, select_k: int) -> None:
        """Per-dispatch counter hook; replays never come through here."""

    def _count_harvest(self, handle: "_Superstep", res: np.ndarray) -> None:
        """Per-harvest counter hook; ``res`` is the harvested block."""

    def assign_now(self, vs: np.ndarray, phase: int) -> None:
        """Assign ``vs`` to ``phase``; queue the device delta + dirtying."""
        vs = np.asarray(vs, dtype=np.int64)
        self.assignment[vs] = phase
        self.in_pool[vs] = False
        self.delta_ids.append(vs)
        self.delta_vals.append(np.full(vs.size, phase, dtype=np.int32))

    def activate_phase(self, vs: np.ndarray, phase: int) -> None:
        """Queue the edges incident to newly admitted vertices of a phase."""
        self.activate_many(np.asarray(vs, dtype=np.int64),
                           np.full(len(vs), phase, dtype=np.int64))

    def activate_many(self, vs: np.ndarray, phases: np.ndarray) -> None:
        """Queue incident edges for a whole superstep's admissions at once.

        ``vs``/``phases`` are parallel arrays; one CSR gather + one
        lexsort appends every fresh (phase, edge) activation to the back
        of the flat sorted bucket store.
        """
        edges, owner = scoring.gather_csr_rows(
            self.hg.v2e_indptr, self.hg.v2e_indices, vs)
        if edges.size == 0:
            return
        edges = edges.astype(np.int64)
        ph = phases[owner]
        key = np.unique(ph * np.int64(self.hg.m) + edges)
        ph, edges = key // self.hg.m, key % self.hg.m
        live = ~self.edge_queued[ph, edges] & ~self.edge_dead[edges]
        ph, edges = ph[live], edges[live]
        if edges.size == 0:
            return
        self.edge_queued[ph, edges] = True
        # power-of-two size classes: smallest-first drawing is a
        # heuristic, and ~12 classes keep the (phase, class) segments few
        sizes = self.edge_sizes[edges]
        cls = np.where(
            sizes <= 1, np.int64(0),
            np.ceil(np.log2(np.maximum(sizes, 2))).astype(np.int64))
        order = np.lexsort((cls, ph))
        ph, edges, cls = ph[order], edges[order], cls[order]
        seq = np.arange(self._seq_back, self._seq_back + edges.size,
                        dtype=np.int64)
        self._seq_back += edges.size
        self._store_insert(
            (ph << _PH_SHIFT) | (cls << _CLS_SHIFT) | seq, edges)

    # ------------------------------------------------------ bucket store
    def _store_insert(self, key: np.ndarray, edges: np.ndarray) -> None:
        """Queue rows for the store; merged lazily at the next draw."""
        if key.size:
            self._bq_pending.append((key, edges))

    def _store_flush(self) -> None:
        if not self._bq_pending:
            return
        key = np.concatenate([kk for kk, _ in self._bq_pending])
        edges = np.concatenate([ee for _, ee in self._bq_pending])
        self._bq_pending = []
        order = np.argsort(key, kind="stable")
        key, edges = key[order], edges[order]
        if self.bq_key.size == 0:
            self.bq_key, self.bq_edge = key, edges
            return
        pos = np.searchsorted(self.bq_key, key)
        self.bq_key = np.insert(self.bq_key, pos, key)
        self.bq_edge = np.insert(self.bq_edge, pos, edges)

    def _store_take(self, budget: np.ndarray):
        """Greedy smallest-class-first prefix take for every phase.

        ``budget`` is the per-phase pin budget; each queued edge costs
        its power-of-two class value. Returns the taken rows' ``(edges,
        ph, cls_log)`` columns, phase-major, and drops them from the
        store.
        """
        self._store_flush()
        key = self.bq_key
        empty = np.empty(0, dtype=np.int64)
        if key.size == 0 or not budget.any():
            return empty, empty, empty
        k = self.k
        bounds = np.searchsorted(
            key, np.arange(k + 1, dtype=np.int64) << _PH_SHIFT)
        start = bounds[:k]
        cap = np.minimum(bounds[1:] - start, budget)
        tot = int(cap.sum())
        if tot == 0:
            return empty, empty, empty
        head = np.cumsum(cap) - cap
        local = np.arange(tot, dtype=np.int64) - np.repeat(head, cap)
        rows = np.repeat(start, cap) + local
        ph_r = np.repeat(np.arange(k, dtype=np.int64), cap)
        ckey = key[rows]
        cls_log = (ckey >> _CLS_SHIFT) & np.int64(63)
        csize = np.int64(1) << cls_log
        cum = np.cumsum(csize)
        excl = cum - csize
        base = np.zeros(k, dtype=np.int64)
        has = cap > 0
        base[has] = excl[head[has]]
        take = (excl - base[ph_r]) < budget[ph_r]
        tk = rows[take]
        edges_t, ph_t, cls_t = self.bq_edge[tk], ph_r[take], cls_log[take]
        if tk.size:     # drop taken rows NOW: restarts may insert
            keep = np.ones(key.size, dtype=bool)
            keep[tk] = False
            self.bq_key = key[keep]
            self.bq_edge = self.bq_edge[keep]
        return edges_t, ph_t, cls_t

    def _store_requeue(self, rq_ph: list, rq_cls: list,
                       rq_edge: list) -> None:
        """Requeue still-live taken rows at their queue fronts."""
        if not rq_ph:
            return
        ph = np.concatenate(rq_ph)
        cls = np.concatenate(rq_cls)
        edges = np.concatenate(rq_edge)
        seq = np.arange(self._seq_front - edges.size + 1,
                        self._seq_front + 1, dtype=np.int64)
        self._seq_front -= edges.size
        key = (ph << _PH_SHIFT) | (cls << _CLS_SHIFT) | seq
        order = np.argsort(key, kind="stable")
        self._store_insert(key[order], edges[order])

    def take_delta(self, cap: int):
        """Drain up to ``cap`` queued (id, phase) assignment pairs (FIFO)."""
        if not self.delta_ids:
            return (np.empty(0, dtype=np.int64),
                    np.empty(0, dtype=np.int32))
        ids = np.concatenate(self.delta_ids).astype(np.int64, copy=False)
        vals = np.concatenate(self.delta_vals).astype(np.int32,
                                                      copy=False)
        if ids.size <= cap:
            self.delta_ids, self.delta_vals = [], []
            return ids, vals
        self.delta_ids = [ids[cap:]]
        self.delta_vals = [vals[cap:]]
        return ids[:cap], vals[:cap]

    def _pack_delta_dirty(self, delta_cap, extra_dirty=()):
        """Drain queued assignments into the padded device buffers.

        Pre-aggregates the dirtied-neighbour multiset of the drained
        delta (plus the queued winner decrements in ``extra_dirty``)
        into (unique id, count) pairs padded to a power-of-two bucket.
        Returns ``(delta, vals, dirty, dcnt)``.
        """
        d_ids, d_vals = self.take_delta(delta_cap)
        delta = np.full(delta_cap, -1, dtype=np.int32)
        vals = np.zeros(delta_cap, dtype=np.int32)
        delta[:d_ids.size] = d_ids
        vals[:d_ids.size] = d_vals
        nbrs, _ = scoring.gather_csr_rows(self.adj[0], self.adj[1], d_ids)
        parts = list(extra_dirty)
        if nbrs.size:
            parts.append(nbrs.astype(np.int64))
        if parts:
            counts = np.bincount(np.concatenate(parts))
            uniq = np.flatnonzero(counts)
            self.stats.cache_invalidations += int(uniq.size)
        else:
            uniq = np.empty(0, dtype=np.int64)
            counts = np.empty(0, dtype=np.int64)
        cap = max(self._dirty_ratchet,
                  1 << int(np.ceil(np.log2(max(uniq.size, 1)))))
        self._dirty_ratchet = cap
        dirty = np.full(cap, -1, dtype=np.int32)
        dcnt = np.zeros(cap, dtype=np.float32)
        dirty[:uniq.size] = uniq
        dcnt[:uniq.size] = counts[uniq]
        return delta, vals, dirty, dcnt

    # ---------------------------------------------------- pipeline hooks
    def pack_superstep(self, active, R: int, P: int, t: int,
                       targets: np.ndarray, acc: np.ndarray):
        """Host half of one superstep: draw, dedup, tile-pack, restart.

        One flat store scan + ONE pins gather covers every active
        phase's candidate draw (stage A); a rotation-ordered pass then
        applies the order-sensitive pieces: edge liveness, candidate
        acceptance against the pool mask, and random restarts (stage B).
        Returns ``(packed, injected)`` where ``packed`` is ``(fresh,
        bias, pool_arr, fresh_ids)`` or None when no phase had anything
        to score.
        """
        kG = self.k
        rot = self.stats.supersteps % active.size
        order = np.concatenate([active[rot:], active[:rot]])
        # stage 0: drop ids that went stale from the held pools, then
        # size each phase's draw
        need = np.zeros(kG, dtype=np.int64)
        budget = np.zeros(kG, dtype=np.int64)
        for g in order:
            gi = int(g)
            ids = self.pools[gi]
            if ids.size:
                keep = self.assignment[ids] < 0
                if not keep.all():
                    self._pmask(gi)[ids[~keep]] = False
                    ids = ids[keep]
                    self.pools[gi] = ids
            need[gi] = min(R, P - ids.size)
            if need[gi] > 0:
                budget[gi] = max(4 * need[gi], 512)
        # stage A: one prefix take over the sorted store + one CSR
        # gather for every taken edge of every phase
        edges_t, ph_t, cls_t = self._store_take(budget)
        pins, prow = scoring.gather_csr_rows(
            self.hg.e2v_indptr, self.hg.e2v_indices, edges_t)
        pins = pins.astype(np.int64)
        self.stats.edges_scanned += int(pins.size)
        edge_lo = np.searchsorted(ph_t, np.arange(kG + 1, dtype=np.int64))
        pin_lo = np.searchsorted(prow, edge_lo)
        # per-phase first-occurrence dedup of the pin streams
        if pins.size:
            pph = ph_t[prow]
            _, first = np.unique(pph * np.int64(self.hg.n) + pins,
                                 return_index=True)
            first = np.sort(first)
            cand_all = pins[first]
            cand_lo = np.searchsorted(pph[first],
                                      np.arange(kG + 1, dtype=np.int64))
        else:
            cand_all = pins
            cand_lo = np.zeros(kG + 1, dtype=np.int64)
        # stage B: rotation-ordered liveness / acceptance / restarts
        fresh = np.full((kG, R), -1, dtype=np.int32)
        bias = np.full((kG, R), np.inf, dtype=np.float32)
        pool_arr = np.full((kG, P), -1, dtype=np.int32)
        fresh_parts: list = []
        rq_ph: list = []
        rq_cls: list = []
        rq_edge: list = []
        injected = 0
        packed_any = False
        rmask = None    # the restart's mask, made at most once a pack
        for g in order:
            gi = int(g)
            e0, e1 = int(edge_lo[gi]), int(edge_lo[gi + 1])
            if e1 > e0:     # edge liveness at this phase's turn
                p0, p1 = int(pin_lo[gi]), int(pin_lo[gi + 1])
                unas = self.assignment[pins[p0:p1]] < 0
                live = np.bincount(prow[p0:p1][unas] - e0,
                                   minlength=e1 - e0) > 0
                eg = edges_t[e0:e1]
                if not live.all():
                    self.edge_dead[eg[~live]] = True    # dead forever
                if live.any():
                    rq_ph.append(ph_t[e0:e1][live])
                    rq_cls.append(cls_t[e0:e1][live])
                    rq_edge.append(eg[live])
            pmask = self._pmask(gi)
            cg = cand_all[int(cand_lo[gi]):int(cand_lo[gi + 1])]
            drawn = cg
            if cg.size:
                okc = (self.assignment[cg] < 0) & ~pmask[cg]
                drawn = cg[okc][:need[gi]]
            ids = self.pools[gi]
            miss = np.empty(0, dtype=np.int64)
            if drawn.size:
                pmask[drawn] = True
                if rmask is not None and rmask is not pmask:
                    rmask[drawn] = True     # keep the union mask live
                scored = self.cache_scored[drawn]
                hits, miss = drawn[scored], drawn[~scored]
                if hits.size:       # cross-phase reuse: already cached
                    ids = np.concatenate([ids, hits])
            if ids.size == 0 and miss.size == 0:
                # shattered remainder: seed fresh growth points directly
                if rmask is None:
                    rmask = self._restart_mask()
                vs = self.random_unassigned(
                    min(t, int(targets[gi] - acc[gi])), in_pool=rmask)
                if vs.size:
                    self.stats.random_restarts += 1
                    self.assign_now(vs, gi)
                    self.activate_phase(vs, gi)
                    acc[gi] += vs.size
                    injected += int(vs.size)
                continue
            fresh[gi, :miss.size] = miss
            bias[gi, :miss.size] = np.where(
                self.deg[miss] > self.tile_l, scoring.TRUNC_PENALTY, 0.0)
            pool_arr[gi, :ids.size] = ids
            # every pool_arr slot is a score served from the device cache
            self.stats.cache_hits += int(ids.size)
            self.pools[gi] = np.concatenate([ids, miss])
            fresh_parts.append(miss)
            self.stats.kernel_rows += int(miss.size)
            packed_any = True
        self._store_requeue(rq_ph, rq_cls, rq_edge)
        if not packed_any:
            return None, injected
        fresh_ids = (np.concatenate(fresh_parts) if fresh_parts
                     else np.empty(0, dtype=np.int64))
        return (fresh, bias, pool_arr, fresh_ids), injected

    def _upload(self, *arrays: np.ndarray) -> list:
        """Copy 4-byte host arrays to the device in ONE transfer.

        Returns device tensors of the arrays' shapes and dtypes. On CUDA
        the block is pinned and copied asynchronously (the caching host
        allocator keeps it alive until the copy is done); on the CPU the
        tensors share the numpy memory.
        """
        block = torch.from_numpy(np.concatenate(
            [a.reshape(-1).view(np.int32) for a in arrays]))
        if self.device.type == "cuda":
            block = block.pin_memory().to(self.device, non_blocking=True)
        out, off = [], 0
        for a in arrays:
            t = block[off:off + a.size].view(a.shape)
            if a.dtype == np.float32:
                t = t.view(torch.float32)
            out.append(t)
            off += a.size
        return out

    def _call_program(self, args: _CallArgs,
                      reset: torch.Tensor) -> torch.Tensor:
        """Issue the engine's superstep program; returns its result block.

        Abstract here: each engine module co-locates its device program
        with its state subclass. ``reset`` is 1 for a replay, which
        ignores the sticky poison flag of the superstep it repeats.
        """
        raise NotImplementedError(
            "PipelineState subclasses co-locate their device program")

    def _launch(self, args: _CallArgs, reset: torch.Tensor,
                fresh_ids: np.ndarray, clean: _CallArgs) -> _Superstep:
        """Launch the program and the async copy of its result block."""
        out = self._call_program(args, reset)
        ready = None
        if self.device.type == "cuda":
            pinned = torch.empty(out.shape, dtype=out.dtype,
                                 pin_memory=True)
            pinned.copy_(out, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
            out = pinned
        return _Superstep(out, ready, fresh_ids,
                          (args.fresh.shape[0], args.select_k), clean)

    def dispatch(self, fresh, bias, pool_arr, fringe, fresh_ids,
                 targets_i32, delta_cap: int, select_k: int) -> _Superstep:
        """Launch one superstep on the device (async); returns a handle.

        A ``dispatch`` spec of the fault plan fires here and is retried
        (``_guarded_kernel``); a ``nan`` spec sends the fresh rows' bias
        as NaN, and the handle keeps the clean arguments for the replay.
        """
        tails = self.pending_dirty
        self.pending_dirty = []
        delta, vals, dirty, dcnt = self._pack_delta_dirty(
            delta_cap, extra_dirty=tails)
        host = (delta, vals, dirty, dcnt, fresh, bias, pool_arr, fringe,
                targets_i32)
        self.stats.host_to_device_bytes += sum(a.nbytes for a in host)
        prev = ()
        if self.host_cache is not None:
            # spill rung: the host owns the score cache. Apply the dirty
            # decrements to the float32 mirror now (the IEEE adds the
            # device program would have scattered) and ship the held
            # pool's scores in; the device still masks stale slots itself
            # against the post-injection assignment.
            u = dirty >= 0
            self.host_cache[dirty[u].astype(np.int64)] -= dcnt[u]
            prev = (self.host_cache[np.where(pool_arr >= 0, pool_arr,
                                             0)].astype(np.float32),)
        self.stats.supersteps += 1
        self._count_dispatch(fresh, select_k)
        ordinal = int(self.stats.supersteps)
        up = self._upload(*host, *prev)
        args = _CallArgs(*up[:len(host)], select_k=select_k,
                         host_fresh=fresh, prev=(up[-1] if prev else None))
        send = args
        injected = self.fire_fault(("nan",), ordinal,
                                   f"injected fatal nan tile at superstep "
                                   f"{ordinal}") is not None
        if injected:
            send = dataclasses.replace(args, bias=torch.where(
                args.fresh >= 0, float("nan"), args.bias))
        h = self._guarded_kernel(
            lambda: self._launch(send, self._reset[0], fresh_ids, args),
            ordinal, self._fault_kinds)
        h.injected = injected
        return h

    def _result(self, handle: _Superstep) -> np.ndarray:
        """Block on a superstep's result block; the wait is ``device_s``.
        A real allocator failure surfacing here raises ``DeviceOOM``."""
        t0 = time.perf_counter()
        if handle.ready is not None:
            membudget.oom_guard(handle.ready.synchronize,
                                "superstep harvest failed", self.mem_rung)
        res = handle.out.numpy()
        self.stats.device_s += time.perf_counter() - t0
        return res

    def poisoned(self, handle: _Superstep) -> bool:
        """Whether the superstep reverted itself (a non-finite score, or
        the sticky flag of an earlier poisoned superstep)."""
        kG, t = handle.shape
        return bool(self._result(handle)[kG * t + 1])

    def replay(self, handle: _Superstep) -> _Superstep:
        """Re-issue a quarantined superstep from its clean arguments.

        The poisoned superstep (and every later one in flight: the flag
        is sticky) reverted its device mutations, so the image is the
        state just before it ran, and the same program with the clean
        arguments and ``reset=1`` computes what a fault-free run did.
        Counts as a retry, never as a superstep. Still poisoned after a
        clean replay means the non-finite scores are real: an injected
        superstep raises ``UnrecoverableFault``, as JAX's does; any
        other raises a ``RuntimeError`` naming the kernel, which the
        degradation ladder does not take.
        """
        self.stats.retries += 1
        nh = self._launch(handle.args, self._reset[1], handle.fresh_ids,
                          handle.args)
        if self.poisoned(nh):
            if handle.injected:
                raise resilience.UnrecoverableFault(
                    "superstep still poisoned after a clean replay: the "
                    "non-finite scores did not come from an injected "
                    "fault")
            raise_kernel_poison()
        return nh

    def harvest(self, handle: _Superstep, acc: np.ndarray,
                targets: np.ndarray, exclude=()) -> int:
        """Block on one in-flight superstep and mirror its admissions.

        ``exclude`` carries the fresh-id arrays of the supersteps still
        in flight: their scores were computed *after* this superstep's
        winners were applied, so the queued winner decrements skip them.
        A quarantined handle was replayed first (the driver replays the
        whole in-flight window, ``runtime._harvest_next``).
        """
        res = self._result(handle)
        t0 = time.perf_counter()
        kG, t = handle.shape
        winners = res[:kG * t].reshape(kG, t)
        n_stale = int(res[kG * t])
        if self.host_cache is not None:
            # spill rung: adopt the fresh scores into the host mirror, the
            # pad-dropping scatter of the device cache write, after the
            # poison check (a quarantined superstep was replayed first)
            flat = handle.args.host_fresh.reshape(-1)
            real = flat >= 0
            self.host_cache[flat[real].astype(np.int64)] = \
                res[kG * t + 2:].view(np.float32)[real]
        self.stats.stale_redraws += n_stale
        fresh_ids = handle.fresh_ids
        if fresh_ids.size:
            self.cache_scored[fresh_ids] = True
        flat = winners.reshape(-1).astype(np.int64)
        mask = flat >= 0
        vs = flat[mask]
        progress = int(vs.size)
        if vs.size:
            ph = np.repeat(np.arange(kG, dtype=np.int64), t)[mask]
            self.assignment[vs] = ph.astype(np.int32)
            self._release_members(vs, ph)
            acc += np.bincount(ph, minlength=kG)
            self.activate_many(vs, ph)
            self._queue_decrements(vs, exclude)
            for g in np.unique(ph):
                if acc[g] >= targets[g]:    # phase done: release pool
                    gi = int(g)
                    self._pmask(gi)[self.pools[gi]] = False
                    self.pools[gi] = np.empty(0, dtype=np.int64)
        self._count_harvest(handle, res)
        self.stats.host_s += time.perf_counter() - t0
        return progress

    def _filter_rescored(self, nbrs: np.ndarray, exclude) -> np.ndarray:
        """Drop ids fresh-rescored by a still-in-flight superstep."""
        parts = [e for e in exclude if e.size]
        if not parts or nbrs.size == 0:
            return nbrs
        ex = np.concatenate(parts)
        scratch = self._excl_scratch
        scratch[ex] = True
        out = nbrs[~scratch[nbrs]]
        scratch[ex] = False
        return out

    def _queue_decrements(self, vs: np.ndarray, exclude=()) -> None:
        """Queue the winners' neighbour decrements for the next dispatch."""
        nbrs, _ = scoring.gather_csr_rows(self.adj[0], self.adj[1], vs)
        if nbrs.size == 0:
            return
        nbrs = self._filter_rescored(nbrs.astype(np.int64), exclude)
        if nbrs.size:
            self.pending_dirty.append(nbrs)
