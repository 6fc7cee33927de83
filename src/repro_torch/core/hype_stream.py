"""Single-pass streaming / online HYPE partitioner.

Every engine in the ladder needs the full hypergraph up front; this one
keeps an assignment while vertices *arrive*. Two modes share one state
object:

  * **Streaming pass** (``hype_stream_partition``): vertices arrive in a
    deterministic stream order and are buffered into micro-batches. Each
    micro-batch is one device step (``scoring.stream_step_device``): row
    1 (``hype_score_select``) counts each row's neighbours in all k
    partition *fringes* at once, then the ``stream_commit`` kernel
    commits the batch in order, scoring each vertex's k targets against
    the live **partition sketch** (per-partition hashed edge-presence
    counts, ``(k, 2**sketch_bits)`` int32) with a FREIGHT-style balance
    penalty, under a hard capacity cap. The sketch and sizes stay on the
    device across micro-batches, updated in place; only the (mb, L)
    tiles go down and the (mb,) choices come back.

        score(v, p) = conn(v, p) + fringe_weight * |N(v) ∩ fringe_p|
                      - balance_alpha * size_p * (k / n)

    where ``conn(v, p)`` counts the incident hyperedges whose sketch
    bucket is present in partition ``p``. Ties break to the lowest
    partition id; at ``micro_batch=1`` the schedule is exactly the
    sequential streaming algorithm.

  * **Incremental mode** (``apply_updates``): vertex and edge inserts
    and deletes change the live assignment. Deletes decrement the sketch
    exactly (``sketch[p, b]`` always equals the recount over the current
    pins, ``recompute_sketch``); inserted vertices are admitted through
    the same micro-batch step; and the *dirtied neighbourhoods*, all
    within ``update_radius`` hops of a touched vertex or edge, get one
    candidate-restricted ``refine_kway`` pass, never the whole graph.

Resilience follows the engines' contract: every ``snapshot_every``
micro-batches a ``PartitionCheckpoint`` is published (a same-config
resume continues the stream bit for bit), and a fault plan (the knob or
``REPRO_FAULT_PLAN``) injects faults before a micro-batch's device step,
retried by replaying the batch; a real exception propagates. The device
bytes go through ``membudget.plan_stream_memory``: a tight budget halves
the micro-batch, then drops the tile width. The semantics, bits and
counters are the JAX package's (``src/repro/core/hype_stream.py``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import membudget, refine, resilience, scoring
from .hypergraph import Hypergraph
from .resilience import UnrecoverableFault

# The one-pass quality bound: km1(hype_stream) / km1(offline hype) on the
# quick generators stays under this factor (the JAX package's).
STREAM_KM1_BOUND = 2.0


@dataclasses.dataclass(frozen=True)
class StreamParams:
    """Knobs of the streaming engine (see the module doc)."""
    micro_batch: int = 64       # vertices per device step
    sketch_bits: int = 16       # sketch table width: 2**sketch_bits buckets
    update_radius: int = 2      # dirty-neighbourhood hops in apply_updates
    s: int = 16                 # fringe slots per partition
    balance_alpha: float = 1.0  # FREIGHT-style balance penalty weight
    fringe_weight: float = 0.5  # weight of the fringe-intersection term
    order: str = "random"       # arrival order: "random" (seeded) | "natural"
    seed: int = 0
    snapshot_every: int = 0     # micro-batches between snapshots (0 = off)
    snapshot_dir: Optional[str] = None
    keep_last: int = 3
    resume: Optional[str] = None
    fault_plan: Optional[object] = None
    max_retries: int = 2
    mem_budget: Optional[object] = None


@dataclasses.dataclass
class StreamStats:
    """Counters of one stream (and its later ``apply_updates`` calls)."""
    vertices: int = 0             # vertices admitted by the stream pass
    micro_batches: int = 0
    device_calls: int = 0
    kernel_rows: int = 0          # batch rows scored by row 1
    host_to_device_bytes: int = 0
    stream_s: float = 0.0
    vertices_per_s: float = 0.0   # sustained stream throughput
    # the memory plan
    planned_bytes: int = 0
    plan_micro_batch: int = 0
    plan_tile_l: int = 0
    # resilience
    faults_injected: int = 0
    retries: int = 0
    snapshots: int = 0
    snapshot_s: float = 0.0
    restore_s: float = 0.0
    resumed_at: int = -1          # micro-batch ordinal a resume continued at
    # incremental mode
    updates_applied: int = 0
    inserts: int = 0
    deletes: int = 0
    readmitted: int = 0           # vertices admitted by apply_updates
    refine_moves: int = 0         # bounded-radius re-expansion moves
    rebalance_moves: int = 0      # balance-guard forced moves
    update_s: float = 0.0
    updates_per_s: float = 0.0


@dataclasses.dataclass
class StreamState:
    """The online partitioner's full mutable state.

    ``assignment[v] == -1`` marks a vertex not admitted (not streamed
    yet, or deleted); ``full_assignment()`` fills those deterministically
    for metrics. Between calls ``sketch`` and ``sizes`` are numpy; a
    call uploads them to ``device`` and reads them back. Both modes keep
    ``sketch == recompute_sketch(...)`` exactly.
    """
    hg: Hypergraph
    k: int
    params: StreamParams
    assignment: np.ndarray        # (n,) int32, -1 = not admitted
    sizes: np.ndarray             # (k,) int32 admitted counts
    sketch: np.ndarray            # (k, 2**sketch_bits) int32
    fringe: np.ndarray            # (k, s) int32, -1 = empty slot
    fringe_pos: np.ndarray        # (k,) int64 ring write cursors
    device: torch.device          # where the micro-batch steps run
    cursor: int = 0               # vertices consumed from the stream order
    batch_idx: int = 0            # micro-batch ordinal (1-based after ++)
    stats: StreamStats = dataclasses.field(default_factory=StreamStats)

    def sketch_digest(self) -> str:
        """sha256 of (sketch, sizes): the exact-decrement invariant."""
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(self.sketch).tobytes())
        h.update(np.ascontiguousarray(self.sizes).tobytes())
        return h.hexdigest()[:16]

    def full_assignment(self) -> np.ndarray:
        """Complete assignment: unadmitted slots fill smallest-first
        (lowest partition id on ties, ascending vertex id)."""
        return _fill_unassigned(self.assignment, self.k)


def recompute_sketch(hg: Hypergraph, assignment: np.ndarray, k: int,
                     sketch_bits: int) -> Tuple[np.ndarray, np.ndarray]:
    """From-scratch ``(sketch, sizes)`` of (hg, assignment): one count per
    current pin (v, e) with ``assignment[v] >= 0``."""
    sketch = np.zeros((k, 1 << sketch_bits), dtype=np.int32)
    sizes = np.bincount(assignment[assignment >= 0],
                        minlength=k).astype(np.int32)
    vids = hg.e2v_indices.astype(np.int64)
    eids = np.repeat(np.arange(hg.m, dtype=np.int64), hg.edge_sizes)
    parts = assignment[vids]
    live = parts >= 0
    buckets = scoring.stream_bucket(eids[live], sketch_bits)
    np.add.at(sketch, (parts[live].astype(np.int64), buckets), 1)
    return sketch, sizes


def _fill_unassigned(assignment: np.ndarray, k: int) -> np.ndarray:
    out = np.array(assignment, dtype=np.int32, copy=True)
    holes = np.flatnonzero(out < 0)
    if holes.size == 0:
        return out
    sizes = np.bincount(out[out >= 0], minlength=k).astype(np.int64)
    for v in holes:
        p = int(np.argmin(sizes))      # first-min = lowest id on ties
        out[v] = p
        sizes[p] += 1
    return out


# ----------------------------------------------------------- tile building

def _csr_tile(indptr, indices, ids: np.ndarray, cap: int,
              pad_rows: int) -> np.ndarray:
    """(pad_rows, L) -1-padded tile of CSR rows, truncated at ``cap``.

    Rows keep their CSR (ascending) order; L is the smallest
    ``L_BUCKETS`` entry covering the widest truncated row.
    """
    vals, owner = scoring.gather_csr_rows(indptr, indices, ids)
    counts = np.bincount(owner, minlength=ids.size) if vals.size else \
        np.zeros(ids.size, dtype=np.int64)
    width = int(min(counts.max() if counts.size else 0, cap))
    L = scoring._bucket_width(max(width, 1))
    tile = np.full((pad_rows, L), -1, np.int32)
    if vals.size:
        row_start = np.cumsum(counts) - counts
        offs = np.arange(vals.size, dtype=np.int64) - row_start[owner]
        keep = offs < cap
        tile[owner[keep], offs[keep]] = vals[keep]
    return tile


def _batch_tiles(hg: Hypergraph, adj, batch: np.ndarray, tile_cap: int,
                 pad_rows: int) -> Tuple[np.ndarray, np.ndarray]:
    """Edge and neighbour tiles of a (pad-stripped) micro-batch. Without
    an adjacency (its expansion guard tripped) the neighbour tile is built
    per batch by ``scoring.neighbor_tile``."""
    edge_tile = _csr_tile(hg.v2e_indptr, hg.v2e_indices, batch,
                          tile_cap, pad_rows)
    if adj is not None:
        nbr_tile = _csr_tile(adj[0], adj[1], batch, tile_cap, pad_rows)
    else:
        dummy = np.full(hg.n, -1, np.int32)   # no assigned-filtering
        nbr_tile, _ = scoring.neighbor_tile(hg, batch, dummy,
                                            pad_b=pad_rows)
        if nbr_tile.shape[1] > tile_cap:
            nbr_tile = nbr_tile[:, :tile_cap]
    return edge_tile, nbr_tile


def _device_step(state: StreamState, batch: np.ndarray, tile_l: int,
                 mb: int, adj, sketch_dev, sizes_dev, cap: int,
                 inv_target: np.float32) -> Tuple[np.ndarray, int]:
    """Build a micro-batch's tiles and run its device step; returns the
    (pad-stripped) parts and the bytes the step uploaded."""
    p = state.params
    edge_tile, nbr_tile = _batch_tiles(state.hg, adj, batch, tile_l, mb)
    valid_row = np.zeros(mb, dtype=bool)
    valid_row[:batch.size] = True

    def up(a):
        return torch.from_numpy(a).to(state.device)

    parts_dev, _, _ = scoring.stream_step_device(
        up(edge_tile), up(nbr_tile), up(state.fringe), sketch_dev,
        sizes_dev, up(valid_row), alpha=p.balance_alpha,
        fringe_w=p.fringe_weight, inv_target=float(inv_target), cap=cap,
        sketch_bits=p.sketch_bits)
    nbytes = (edge_tile.nbytes + nbr_tile.nbytes + state.fringe.nbytes
              + valid_row.nbytes)
    return parts_dev.cpu().numpy()[:batch.size], nbytes


# --------------------------------------------------------------- the pass

def _validate_params(p: StreamParams) -> None:
    if p.micro_batch < 1:
        raise ValueError(f"micro_batch must be >= 1, got {p.micro_batch}")
    if not 4 <= p.sketch_bits <= 24:
        raise ValueError(
            f"sketch_bits must be in [4, 24], got {p.sketch_bits}")
    if p.s < 1:
        raise ValueError(f"s must be >= 1, got {p.s}")
    if p.order not in ("random", "natural"):
        raise ValueError(
            f"order must be 'random' or 'natural', got {p.order!r}")
    if p.update_radius < 0:
        raise ValueError(
            f"update_radius must be >= 0, got {p.update_radius}")
    if p.snapshot_every > 0 and not p.snapshot_dir:
        raise ValueError("snapshot_every > 0 requires snapshot_dir")


def _stream_order(n: int, p: StreamParams) -> np.ndarray:
    if p.order == "natural":
        return np.arange(n, dtype=np.int64)
    return np.random.default_rng(p.seed).permutation(n)


def _config_dict(state: StreamState, plan_mb: int, plan_tl: int) -> dict:
    p = state.params
    return {"k": state.k, "micro_batch": plan_mb, "tile_l": plan_tl,
            "sketch_bits": p.sketch_bits, "s": p.s,
            "balance_alpha": p.balance_alpha,
            "fringe_weight": p.fringe_weight, "order": p.order,
            "seed": p.seed}


def _push_fringe(state: StreamState, vs: np.ndarray,
                 parts: np.ndarray) -> None:
    """Ring-append admitted vertices to their partitions' fringes."""
    s = state.fringe.shape[1]
    for p in np.unique(parts[parts >= 0]):
        vp = vs[parts == p]
        pos = int(state.fringe_pos[p])
        if vp.size >= s:
            # only the last s sequential writes survive a full wrap
            start = (pos + vp.size - s) % s
            state.fringe[p, (start + np.arange(s)) % s] = vp[-s:]
        else:
            state.fringe[p, (pos + np.arange(vp.size)) % s] = vp
        state.fringe_pos[p] = pos + vp.size


def _snapshot(state: StreamState, plan_mb: int, plan_tl: int,
              sketch_dev, sizes_dev) -> None:
    t0 = time.perf_counter()
    state.sketch = sketch_dev.cpu().numpy().copy()
    state.sizes = sizes_dev.cpu().numpy().copy()
    ckpt = resilience.PartitionCheckpoint(
        engine="hype_stream", superstep=state.batch_idx,
        fingerprint=state.hg.fingerprint(),
        config=_config_dict(state, plan_mb, plan_tl),
        payload={"assignment": state.assignment.copy(),
                 "sizes": state.sizes.copy(),
                 "sketch": state.sketch.copy(),
                 "fringe": state.fringe.copy(),
                 "fringe_pos": state.fringe_pos.copy(),
                 "cursor": state.cursor,
                 "batch_idx": state.batch_idx})
    resilience.save_snapshot(state.params.snapshot_dir, ckpt,
                             state.params.keep_last)
    state.stats.snapshots += 1
    state.stats.snapshot_s += time.perf_counter() - t0


def _try_resume(state: StreamState, plan_mb: int, plan_tl: int) -> None:
    ckpt = resilience.load_latest(state.params.resume)
    if ckpt is None:
        return
    resilience.check_checkpoint(ckpt, state.hg, state.k)
    if ckpt.engine != "hype_stream" \
            or ckpt.config != _config_dict(state, plan_mb, plan_tl):
        return                      # cross-config snapshots cold-start
    t0 = time.perf_counter()
    pay = ckpt.payload
    state.assignment = np.asarray(pay["assignment"], np.int32).copy()
    state.sizes = np.asarray(pay["sizes"], np.int32).copy()
    state.sketch = np.asarray(pay["sketch"], np.int32).copy()
    state.fringe = np.asarray(pay["fringe"], np.int32).copy()
    state.fringe_pos = np.asarray(pay["fringe_pos"], np.int64).copy()
    state.cursor = int(pay["cursor"])
    state.batch_idx = int(pay["batch_idx"])
    state.stats.resumed_at = state.batch_idx
    state.stats.restore_s = time.perf_counter() - t0


def _fire_faults(plan, state: StreamState, ordinal: int) -> None:
    """The pre-dispatch fault site: an injected fault replays the batch.

    Faults fire before the device step, so the sketch and sizes are never
    half-updated, and the batch is deterministic, so a retry replays it
    bit for bit. A fatal spec or an exhausted retry budget raises
    ``UnrecoverableFault``.
    """
    if plan is None:
        return
    retries = 0
    while True:
        spec = plan.fire(("dispatch", "nan"), ordinal)
        if spec is None:
            return
        state.stats.faults_injected += 1
        if spec.fatal:
            raise UnrecoverableFault(
                f"fatal injected {spec.kind} fault at stream "
                f"micro-batch {ordinal}")
        retries += 1
        state.stats.retries += 1
        if retries > state.params.max_retries:
            raise UnrecoverableFault(
                f"retry budget exhausted at stream micro-batch "
                f"{ordinal} ({retries} injected faults)")


def _run_stream(state: StreamState, order: np.ndarray, cap: int,
                plan_mb: int, plan_tl: int, plan) -> None:
    """Consume ``order[state.cursor:]`` in micro-batches of ``plan_mb``."""
    hg, k, p, st = state.hg, state.k, state.params, state.stats
    adj = hg.vertex_adjacency()
    inv_target = np.float32(k / max(hg.n, 1))
    sketch_dev = torch.tensor(state.sketch, device=state.device)
    sizes_dev = torch.tensor(state.sizes, device=state.device)
    t0 = time.perf_counter()
    snap_every = p.snapshot_every
    while state.cursor < order.size:
        batch = order[state.cursor:state.cursor + plan_mb]
        ordinal = state.batch_idx + 1
        _fire_faults(plan, state, ordinal)
        parts, nbytes = _device_step(state, batch, plan_tl, plan_mb, adj,
                                     sketch_dev, sizes_dev, cap, inv_target)
        st.host_to_device_bytes += nbytes
        state.assignment[batch] = parts
        _push_fringe(state, batch, parts)
        state.cursor += batch.size
        state.batch_idx = ordinal
        st.micro_batches += 1
        st.device_calls += 1
        st.kernel_rows += plan_mb
        st.vertices += batch.size
        if snap_every and state.batch_idx % snap_every == 0:
            _snapshot(state, plan_mb, plan_tl, sketch_dev, sizes_dev)
    state.sketch = sketch_dev.cpu().numpy().copy()
    state.sizes = sizes_dev.cpu().numpy().copy()
    st.stream_s += time.perf_counter() - t0
    st.vertices_per_s = st.vertices / max(st.stream_s, 1e-9)


def hype_stream_partition(hg: Hypergraph, k: int,
                          params: Optional[StreamParams] = None, *,
                          return_stats: bool = False,
                          return_state: bool = False, device=None):
    """One streaming pass over ``hg``; see the module doc.

    Returns the complete int32 assignment; with ``return_stats`` a
    ``(assignment, StreamStats)`` pair, with ``return_state`` a
    ``(assignment, StreamState)`` pair (the state carries ``.stats`` and
    feeds ``apply_updates``). Balance: ``max - min <= k`` through the hard
    ``ceil(n/k)`` capacity cap. ``device`` is ``None`` (the card; raises
    without one), ``"cuda"`` or ``"cpu"``.
    """
    from ..partition_api import resolve_device
    p = params or StreamParams()
    _validate_params(p)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    state = _fresh_state(hg, k, p, resolve_device(device))
    if k == 1 or hg.n == 0:
        state.assignment[:] = 0
        state.sketch, state.sizes = recompute_sketch(
            hg, state.assignment, k, p.sketch_bits)
        return _pack_result(state, return_stats, return_state)

    # the memory plan: the streaming buffers go through the byte planner
    # before the first upload; a tight budget halves the micro-batch,
    # then the tile width
    budget = membudget.resolve_budget(p.mem_budget, state.device)
    spec = membudget.StreamSpec(
        n=hg.n, k=k, micro_batch=p.micro_batch,
        sketch_bits=p.sketch_bits, s=p.s,
        tile_l=scoring.L_BUCKETS[-1])
    plan_mb, plan_tl, planned, _fits = membudget.plan_stream_memory(
        spec, budget)
    state.stats.planned_bytes = planned
    state.stats.plan_micro_batch = plan_mb
    state.stats.plan_tile_l = plan_tl

    plan = resilience.resolve_fault_plan(p.fault_plan)
    if p.resume:
        _try_resume(state, plan_mb, plan_tl)
    order = _stream_order(hg.n, p)
    cap = -(-hg.n // k)
    _run_stream(state, order, cap, plan_mb, plan_tl, plan)
    return _pack_result(state, return_stats, return_state)


def _fresh_state(hg: Hypergraph, k: int, p: StreamParams,
                 device: torch.device) -> StreamState:
    return StreamState(
        hg=hg, k=k, params=p,
        assignment=np.full(hg.n, -1, np.int32),
        sizes=np.zeros(k, np.int32),
        sketch=np.zeros((k, 1 << p.sketch_bits), np.int32),
        fringe=np.full((k, p.s), -1, np.int32),
        fringe_pos=np.zeros(k, np.int64), device=device)


def _pack_result(state: StreamState, return_stats: bool,
                 return_state: bool):
    assignment = state.assignment.copy()
    if return_state:
        return assignment, state
    if return_stats:
        return assignment, state.stats
    return assignment


# --------------------------------------------------------- incremental mode

def _sketch_add(state: StreamState, part: int, edge_ids: np.ndarray,
                sign: int) -> None:
    """Exact sketch increment/decrement for the pins of one vertex."""
    if edge_ids.size == 0:
        return
    buckets = scoring.stream_bucket(edge_ids, state.params.sketch_bits)
    np.add.at(state.sketch[part], buckets, sign)


def _expand_radius(hg: Hypergraph, seeds: np.ndarray,
                   radius: int) -> np.ndarray:
    """Vertices within ``radius`` hops of ``seeds`` (seeds included)."""
    seeds = np.unique(seeds.astype(np.int64))
    if radius <= 0 or seeds.size == 0:
        return seeds
    adj = hg.vertex_adjacency()
    if adj is None:
        return seeds
    frontier, dirty = seeds, seeds
    for _ in range(radius):
        nbrs, _ = scoring.gather_csr_rows(adj[0], adj[1], frontier)
        frontier = np.setdiff1d(np.unique(nbrs.astype(np.int64)), dirty)
        if frontier.size == 0:
            break
        dirty = np.union1d(dirty, frontier)
    return dirty


def _readmit(state: StreamState, new_vs: np.ndarray) -> None:
    """Stream-admit queued vertices against the current sketch/fringe."""
    if new_vs.size == 0:
        return
    hg, k, p, st = state.hg, state.k, state.params, state.stats
    active = int((state.assignment >= 0).sum()) + int(new_vs.size)
    cap = max(-(-active // k), int(state.sizes.max()))
    inv_target = np.float32(k / max(hg.n, 1))
    adj = hg.vertex_adjacency()
    mb = st.plan_micro_batch or p.micro_batch
    tl = st.plan_tile_l or scoring.L_BUCKETS[-1]
    sketch_dev = torch.tensor(state.sketch, device=state.device)
    sizes_dev = torch.tensor(state.sizes, device=state.device)
    for b0 in range(0, new_vs.size, mb):
        batch = new_vs[b0:b0 + mb]
        parts, _ = _device_step(state, batch, tl, mb, adj, sketch_dev,
                                sizes_dev, cap, inv_target)
        state.assignment[batch] = parts
        st.device_calls += 1
        st.readmitted += int(batch.size)
    state.sketch = sketch_dev.cpu().numpy().copy()
    state.sizes = sizes_dev.cpu().numpy().copy()


def _local_refine(state: StreamState, dirty: np.ndarray) -> None:
    """Bounded-radius re-expansion: one candidate-restricted refine pass."""
    if dirty.size == 0 or state.k <= 1:
        return
    hg, k = state.hg, state.k
    before = _fill_unassigned(state.assignment, k)
    refined, _rs = refine.refine_kway(
        hg, before, k, passes=1, candidates=dirty, use_device=False)
    moved = np.flatnonzero((refined != before)
                           & (state.assignment >= 0))
    for v in moved:
        src, dst = int(before[v]), int(refined[v])
        es = hg.vertex_edges(int(v)).astype(np.int64)
        _sketch_add(state, src, es, -1)
        _sketch_add(state, dst, es, +1)
        state.assignment[v] = dst
        state.sizes[src] -= 1
        state.sizes[dst] += 1
        state.stats.refine_moves += 1


def _rebalance_guard(state: StreamState) -> None:
    """Restore the documented ``max - min <= k`` slack after deletes.

    Deterministic: while the slack is violated, move the best-gain
    (lowest id on ties) vertex from the largest partition to the
    smallest, keeping the sketch exact per move.
    """
    hg, k = state.hg, state.k
    adj = hg.vertex_adjacency()
    while True:
        sizes = state.sizes
        p_big = int(np.argmax(sizes))
        p_small = int(np.argmin(sizes))
        if int(sizes[p_big]) - int(sizes[p_small]) <= k:
            return
        cand = np.flatnonzero(state.assignment == p_big)
        if cand.size == 0:
            return
        if adj is not None:
            gains = refine._host_gains(
                adj, cand, _fill_unassigned(state.assignment, k),
                k)[:, p_small]
            v = int(cand[np.lexsort((cand, -gains))[0]])
        else:
            v = int(cand[0])
        es = hg.vertex_edges(v).astype(np.int64)
        _sketch_add(state, p_big, es, -1)
        _sketch_add(state, p_small, es, +1)
        state.assignment[v] = p_small
        state.sizes[p_big] -= 1
        state.sizes[p_small] += 1
        state.stats.rebalance_moves += 1


def apply_updates(state: StreamState,
                  ops: Sequence[Tuple]) -> StreamState:
    """Replay an op log against the live state; returns ``state``.

    Ops (applied in order):

      * ``("add_vertex", edge_ids)``: append vertex ``n`` joining the
        listed existing hyperedges; it is admitted through the streaming
        step at the end of the call.
      * ``("remove_vertex", v)``: drop all pins of ``v``; its slot stays
        (isolated), its sketch counts are decremented exactly and it
        leaves every fringe.
      * ``("add_edge", vertex_ids)``: append hyperedge ``m`` over the
        listed existing vertices; assigned pins increment the sketch.
      * ``("remove_edge", e)``: drop all pins of hyperedge ``e``;
        assigned pins decrement the sketch exactly.

    After the log, new vertices are admitted micro-batch by micro-batch
    on ``state.device``, the dirtied neighbourhoods (``update_radius``
    hops around every touched vertex) get one candidate-restricted
    ``refine_kway`` pass on the host, and a balance guard restores the
    ``max - min <= k`` slack if deletes broke it. The graph is rebuilt
    per op (``from_pins``), as in the JAX package. The sketch invariant
    holds at return.
    """
    t0 = time.perf_counter()
    st = state.stats
    dirty_parts: list = []
    new_vs: list = []
    for op in ops:
        kind = op[0]
        if kind == "add_vertex":
            edge_ids = np.asarray(list(op[1]), dtype=np.int64)
            vid = state.hg.n
            state.hg = state.hg.with_vertices([edge_ids.tolist()])
            state.assignment = np.append(
                state.assignment, np.int32(-1)).astype(np.int32)
            if edge_ids.size:
                pins, _ = scoring.gather_csr_rows(
                    state.hg.e2v_indptr, state.hg.e2v_indices, edge_ids)
                dirty_parts.append(pins.astype(np.int64))
            new_vs.append(vid)
            st.inserts += 1
        elif kind == "remove_vertex":
            v = int(op[1])
            part = int(state.assignment[v])
            es = state.hg.vertex_edges(v).astype(np.int64)
            dirty_parts.append(state.hg.neighbors(v).astype(np.int64))
            if part >= 0:
                _sketch_add(state, part, es, -1)
                state.sizes[part] -= 1
            state.assignment[v] = -1
            state.fringe[state.fringe == v] = -1
            state.hg = state.hg.without_vertices([v])
            new_vs = [u for u in new_vs if u != v]
            st.deletes += 1
        elif kind == "add_edge":
            pins = np.asarray(list(op[1]), dtype=np.int64)
            e = state.hg.m
            state.hg = state.hg.with_edges([pins.tolist()])
            b = int(scoring.stream_bucket(
                np.asarray([e]), state.params.sketch_bits)[0])
            # de-duplicated pins (from_pins semantics)
            for part in state.assignment[np.unique(pins)]:
                if part >= 0:
                    state.sketch[int(part), b] += 1
            dirty_parts.append(pins)
            st.inserts += 1
        elif kind == "remove_edge":
            e = int(op[1])
            pins = state.hg.edge_pins(e).astype(np.int64)
            b = int(scoring.stream_bucket(
                np.asarray([e]), state.params.sketch_bits)[0])
            for part in state.assignment[pins]:
                if part >= 0:
                    state.sketch[int(part), b] -= 1
            dirty_parts.append(pins)
            state.hg = state.hg.without_edges([e])
            st.deletes += 1
        else:
            raise ValueError(f"unknown stream op kind {kind!r}")
    st.updates_applied += len(ops)

    queued = np.asarray(sorted(set(new_vs)), dtype=np.int64)
    _readmit(state, queued)
    dirty = np.concatenate([a for a in dirty_parts if a.size]
                           + [queued]) if (dirty_parts or queued.size) \
        else np.empty(0, np.int64)
    dirty = dirty[dirty < state.hg.n]
    dirty = _expand_radius(state.hg, dirty, state.params.update_radius)
    _local_refine(state, dirty)
    _rebalance_guard(state)
    st.update_s += time.perf_counter() - t0
    st.updates_per_s = st.updates_applied / max(st.update_s, 1e-9)
    return state
