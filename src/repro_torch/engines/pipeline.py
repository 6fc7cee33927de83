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
and the poison flag. The memory plan is
fixed at the JAX package's unconstrained rung-0 choice (the tile width
``tile_l`` below); memory rungs are not ported (ROADMAP.md, queue 1).

Transfers: one host-to-device copy per superstep (every small id buffer
packed into one pinned block) and one device-to-host copy (winners,
n_stale and poison in one int32 tensor), issued right after the
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

from ..core import scoring
from ..core.hypergraph import Hypergraph
from .runtime import EngineRuntime

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


@dataclasses.dataclass
class _Superstep:
    """One in-flight superstep: its result block and what harvest needs.

    ``out`` holds ``winners (G*select_k) | n_stale | poison`` as int32 --
    a pinned host tensor on CUDA, filled by an async copy that ``ready``
    (a CUDA event) marks done; the device program's own tensor on CPU.
    """
    out: torch.Tensor
    ready: Optional[torch.cuda.Event]
    fresh_ids: np.ndarray
    shape: tuple


class PipelineState(EngineRuntime):
    """The device-resident graph image and per-phase growth state."""

    def __init__(self, hg: Hypergraph, k: int, p, device):
        super().__init__(hg, k, p)
        self.device = torch.device(device)
        self.dev = None
        if k >= 1 << (63 - _PH_SHIFT):      # bucket-store key width
            return
        if self.adj is None:        # hub-expansion guard tripped on host
            return
        deg = np.diff(self.adj[0])
        self.deg = deg
        # One gather width per run: the bucket of the 99.5th-percentile
        # degree. The handful of rows wider than that are truncated and
        # carry the hub penalty.
        self.tile_l = scoring._bucket_width(int(min(
            np.percentile(deg, 99.5) if deg.size else 1,
            scoring.L_BUCKETS[-1])))
        self.stats.tile_l = self.tile_l
        n, m = hg.n, hg.m
        dev = self.device
        # the CSR image is memoized on hg, so a refinement post-pass on
        # the same device reuses it
        self.dev = hg.device_adjacency(dev)
        # (n + 1,) / (k + 1,): the last element is the scratch slot that
        # absorbs masked-out scatters (see core/scoring.py)
        self.dev_assign = torch.full((n + 1,), -1, dtype=torch.int32,
                                     device=dev)
        self.dev_cache = torch.full((n + 1,), -1.0, dtype=torch.float32,
                                    device=dev)
        self.dev_acc = torch.zeros(k + 1, dtype=torch.int32, device=dev)
        # sticky NaN-quarantine flag (scoring._poison_guard)
        self.dev_poison = torch.zeros(1, dtype=torch.int32, device=dev)
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
                               self.dev_acc)))

    # ------------------------------------------------------------------ #
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
                    self.in_pool[ids[~keep]] = False
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
        pmask = self.in_pool
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
            cg = cand_all[int(cand_lo[gi]):int(cand_lo[gi + 1])]
            drawn = cg
            if cg.size:
                okc = (self.assignment[cg] < 0) & ~pmask[cg]
                drawn = cg[okc][:need[gi]]
            ids = self.pools[gi]
            miss = np.empty(0, dtype=np.int64)
            if drawn.size:
                pmask[drawn] = True
                scored = self.cache_scored[drawn]
                hits, miss = drawn[scored], drawn[~scored]
                if hits.size:       # cross-phase reuse: already cached
                    ids = np.concatenate([ids, hits])
            if ids.size == 0 and miss.size == 0:
                # shattered remainder: seed fresh growth points directly
                vs = self.random_unassigned(
                    min(t, int(targets[gi] - acc[gi])))
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

    def _call_program(self, args: _CallArgs) -> torch.Tensor:
        """Issue the engine's superstep program; returns its result block.

        Abstract here: each engine module co-locates its device program
        with its state subclass.
        """
        raise NotImplementedError(
            "PipelineState subclasses co-locate their device program")

    def dispatch(self, fresh, bias, pool_arr, fringe, fresh_ids,
                 targets_i32, delta_cap: int, select_k: int) -> _Superstep:
        """Launch one superstep on the device (async); returns a handle."""
        tails = self.pending_dirty
        self.pending_dirty = []
        delta, vals, dirty, dcnt = self._pack_delta_dirty(
            delta_cap, extra_dirty=tails)
        host = (delta, vals, dirty, dcnt, fresh, bias, pool_arr, fringe,
                targets_i32)
        self.stats.host_to_device_bytes += sum(a.nbytes for a in host)
        self.stats.supersteps += 1
        args = _CallArgs(*self._upload(*host), select_k=select_k)
        out = self._call_program(args)
        ready = None
        if self.device.type == "cuda":
            pinned = torch.empty(out.shape, dtype=out.dtype,
                                 pin_memory=True)
            pinned.copy_(out, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
            out = pinned
        return _Superstep(out, ready, fresh_ids, (fresh.shape[0], select_k))

    def harvest(self, handle: _Superstep, acc: np.ndarray,
                targets: np.ndarray, exclude=()) -> int:
        """Block on one in-flight superstep and mirror its admissions.

        ``exclude`` carries the fresh-id arrays of the supersteps still
        in flight: their scores were computed *after* this superstep's
        winners were applied, so the queued winner decrements skip them.
        """
        t0 = time.perf_counter()
        if handle.ready is not None:
            handle.ready.synchronize()
        res = handle.out.numpy()
        self.stats.device_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        kG, t = handle.shape
        winners = res[:kG * t].reshape(kG, t)
        n_stale, poison = int(res[kG * t]), int(res[kG * t + 1])
        if poison:
            raise RuntimeError(
                "superstep produced non-finite scores; quarantine replay "
                "is not ported (ROADMAP.md, queue 1: resilience)")
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
            self.in_pool[vs] = False
            acc += np.bincount(ph, minlength=kG)
            self.activate_many(vs, ph)
            self._queue_decrements(vs, exclude)
            for g in np.unique(ph):
                if acc[g] >= targets[g]:    # phase done: release pool
                    gi = int(g)
                    self.in_pool[self.pools[gi]] = False
                    self.pools[gi] = np.empty(0, dtype=np.int64)
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
