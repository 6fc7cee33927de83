"""Device-resident loop engine (``hype_device``).

The port of ``src/repro/engines/device.py``. The whole k-way growth loop
-- pool upkeep, store draws, scoring, admission, exact cache decrements,
restarts -- runs on the device (``core/device_loop.py``): the host
uploads the graph image once and reads a few scalars per chunk of
supersteps. On the card one round is captured as a CUDA graph and
replayed a chunk at a time. The schedule is the lock-step depth-1
cadence by construction, which makes the engine bit-identical to
``hype_superstep`` at ``pipeline_depth=1``.

The driver builds its first carry from a plain ``PipelineState`` (the
seeded host bookkeeping and the uploaded CSR image); it never dispatches
through the pipeline. Falls back to ``hype_superstep`` on the same device
when the int32 encoding gates reject the graph or the per-phase sequence
space runs out. Snapshots are taken at chunk boundaries (the cadence caps
a chunk), and a run resumes from the carry (same engine and config: bit
for bit) or from the assignment (another engine's: warm). Injected
faults are probed a chunk at a time, as in the JAX engine; a ``nan``
fault's round runs off the captured graph (``core/device_loop.py``).

Memory: the loop has no reduced-memory programs of its own. A budget
whose plan falls below rung 0 hands the run to ``hype_superstep``, and a
device OOM (real, at the upload, in the capture or in a chunk; or an
injected ``oom``) falls down the host pipeline's memory rungs at depth 1,
warm-started from the assignment at the last logical chunk boundary the
host saw (``core/membudget.py``).
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Optional

import numpy as np

from ..core import device_loop, membudget, resilience
from ..core.hypergraph import Hypergraph
from ..core.scoring import gather_csr_rows
from .batched import hype_batched_partition
from .pipeline import PipelineState
from .runtime import BatchedStats, maybe_refine
from .superstep import SuperstepParams, hype_superstep_partition
from .superstep import run_pipeline as superstep_pipeline


@dataclasses.dataclass
class DeviceParams(SuperstepParams):
    """Knobs of the device loop: the JAX ``DeviceParams`` fields with the
    same defaults. ``pipeline_depth`` is ignored (the loop runs the
    depth-1 cadence by construction)."""
    # supersteps per chunk: the host reads flags / progress / acc once a
    # chunk (on the card: the captured round's replays per chunk)
    chunk_supersteps: int = 64
    # score-cache storage on the device: "float32" is bit-identical to
    # the host engines; "float16" halves the cache bytes
    cache_dtype: str = "float32"
    # capacity overrides (None = planned from graph statistics; a flagged
    # cap is doubled and the run repeated, which lands on the same bits)
    store_cap: Optional[int] = None
    act_cap: Optional[int] = None


# Flat CSR walks wider than this take the planner's heuristic width (and
# its rerun ladder) instead of the exact bound.
WALK_LIMIT = 1 << 21


def _walk_cap(deg: np.ndarray, rows: int) -> Optional[int]:
    """The widest flat CSR walk of ``rows`` admissions can need: the sum
    of the ``rows`` largest degrees, as a power of two, or None past
    ``WALK_LIMIT``. A round walks at most k * t admissions at a time
    (winners, or restart draws), so a walk this wide never overflows."""
    top = np.partition(deg, deg.size - rows)[-rows:] if deg.size > rows \
        else deg
    need = device_loop._pow2ceil(max(int(top.sum()), 1))
    return need if need <= WALK_LIMIT else None


def _device_probe_faults(st: PipelineState, lo: int, hi: int) -> None:
    """Fire the plan's dispatch and oom specs for superstep ordinals
    [lo, hi]. The host engines fire them one superstep at a time; the
    loop runs a chunk per host call, so its range is probed up front:
    the same plan, ordinals and escalation. A transient dispatch fault
    fires before the (pure) chunk, so its retry is counted and the chunk
    runs once."""
    for o in range(lo, hi + 1):
        if st.fire_fault(("dispatch", "oom"), o,
                         f"injected fatal {{kind}} fault at superstep {o}",
                         f"injected OOM at superstep {o}"):
            st.stats.retries += 1
            time.sleep(float(st.p.retry_backoff_s))


def _device_probe_nan(st: PipelineState, lo: int, hi: int) -> int:
    """The first ordinal in [lo, hi] of an injected nan spec, or 0. The
    loop poisons that superstep's bias on the device and replays it with
    the clean bias."""
    for o in range(lo, hi + 1):
        if st.fire_fault(("nan",), o,
                         f"injected fatal nan tile at superstep {o}"):
            return o
    return 0


def _device_export(st: PipelineState, k: int, acc: np.ndarray, caps: dict,
                   cache_f16: bool):
    """The first carry from the seeded host state, as numpy in the JAX
    program's layout. Returns ``(carry_np, caps)``; ``caps["sp"]`` grows
    when the host store does not fit."""
    n = st.hg.n
    P = int(st.p.pool_cap)
    st._store_flush()
    enc = device_loop.host_store_to_device(st.bq_key, st.bq_edge, k,
                                           caps["sp"])
    while enc is None:
        caps = dict(caps, sp=caps["sp"] * 2)
        enc = device_loop.host_store_to_device(st.bq_key, st.bq_edge, k,
                                               caps["sp"])
    skey, sedge, sback, sfront = enc
    pool = np.full((k, P), -1, dtype=np.int32)
    pool_n = np.zeros(k, dtype=np.int32)
    for g, ids in enumerate(st.pools):
        pool[g, :ids.size] = ids
        pool_n[g] = ids.size
    # queued decrements: the undrained delta's neighbour multiset plus any
    # queued winner tails (the host drains them at the next dispatch)
    pend = np.zeros(n, dtype=np.int32)
    d_ids, _ = st.take_delta(1 << 60)
    if d_ids.size:
        nbrs, _ = gather_csr_rows(st.adj[0], st.adj[1], d_ids)
        np.add.at(pend, nbrs, 1)
    for a in st.pending_dirty:
        np.add.at(pend, np.asarray(a, dtype=np.int64), 1)
    st.pending_dirty = []
    cache = st.dev_cache[:n].cpu().numpy().astype(np.float32)
    if cache_f16:
        cache = np.clip(cache, -65504.0, 65504.0).astype(np.float16)
    carry = dict(
        assign=st.assignment.astype(np.int32, copy=True),
        cache=cache,
        acc=acc.astype(np.int32, copy=True),
        in_pool=st.in_pool.copy(),
        cache_scored=st.cache_scored.copy(),
        edge_queued=st.edge_queued.copy(),
        edge_dead=st.edge_dead.copy(),
        skey=skey, sedge=sedge, sback=sback, sfront=sfront,
        pool=pool, pool_n=pool_n, pend=pend,
        rand_ptr=np.int32(st.rand_ptr),
        supersteps=np.int32(st.stats.supersteps),
        progress=np.int32(1),
        flags=np.int32(0),
        ss_in_chunk=np.int32(0),
        stats=np.zeros(device_loop.NSTATS, dtype=np.int32),
    )
    return carry, caps


def _device_attempt(hg: Hypergraph, k: int, p: DeviceParams,
                    caps_over: dict, device, graphs: Optional[dict] = None):
    """One capacity attempt of the device loop.

    Returns ``("ok", assignment, st)``, ``("fallback", reason, None)`` or
    ``("overflow", flags, caps)``. Raises ``UnrecoverableFault`` when the
    round an injected ``nan`` poisoned scores non-finite again in its
    replay, and ``RuntimeError`` when a round no fault poisoned scores a
    real row non-finite. ``graphs`` sums the CUDA graph's captures,
    replays, rounds run off it and capture seconds over the attempts of
    one run.
    """
    if graphs is None:
        graphs = dict(captures=0, replays=0, off_rounds=0, capture_s=0.0)
    chunk_max = max(1, int(p.chunk_supersteps))
    cache_f16 = p.cache_dtype == "float16"
    st = PipelineState(hg, k, dataclasses.replace(p, pipeline_depth=1),
                       device)
    if st.dev is None:
        return ("fallback", "no device adjacency", None)
    if st.mem_plan.rung != 0:
        # the budget wants a reduced configuration: the rungs are host
        # pipeline programs, so the whole run goes to that engine
        return ("fallback", "memory plan below rung 0", None)
    n, m = hg.n, hg.m
    base, rem = divmod(n, k)
    targets = np.zeros(k, dtype=np.int64)
    targets[:] = base + (np.arange(k) < rem)
    acc = np.zeros(k, dtype=np.int64)
    R, P, t = int(p.rows), int(p.pool_cap), int(p.t)
    vdeg = np.diff(hg.v2e_indptr).astype(np.int64)
    mean_vdeg = float(vdeg.mean()) if n else 1.0
    mean_adeg = float(st.deg.mean()) if n else 1.0
    sizes = st.edge_sizes
    max_edge = int(sizes.max()) if m else 1
    # the flat walks get their exact bound where it is small enough: the
    # JAX planner's mean-degree widths overflow on hub-heavy graphs
    # (github_like reruns twice), and a rerun starts over
    caps = device_loop.plan_caps(
        n=n, m=m, kG=k, rows=R, t=t, mean_vdeg=mean_vdeg,
        mean_adeg=mean_adeg, max_edge=max_edge, store_cap=p.store_cap,
        act_cap=p.act_cap, rawt_cap=_walk_cap(vdeg, k * t),
        rawd_cap=_walk_cap(st.deg, k * t))
    caps.update(caps_over)
    if not device_loop.supported(n=n, m=m, kG=k, bud=caps["bud"]):
        return ("fallback", "int32 encoding gates", None)

    snap_every = max(0, int(p.snapshot_every or 0))
    config = {"k": k, "devices": 0, "t": t, "rows": R, "pool_cap": P,
              "s": p.s, "seed": p.seed, "pipeline_depth": 1,
              "snapshot_every": snap_every, "tile_l": int(st.tile_l),
              "chunk_supersteps": chunk_max, "cache_dtype": p.cache_dtype}
    engine = "hype_device"
    carry_np = None
    ckpt = resilience.load_latest(p.resume) if p.resume else None
    if ckpt is not None:
        t0 = time.perf_counter()
        resilience.check_checkpoint(ckpt, hg, k)
        if ckpt.engine == engine and ckpt.config == config:
            pay = ckpt.payload
            carry_np = {kk: np.array(vv) for kk, vv in pay["carry"].items()}
            carry_np["flags"] = np.int32(0)
            carry_np["progress"] = np.int32(1)
            caps = dict(pay["caps"])
            caps.update(caps_over)
            st.stats = dataclasses.replace(pay["stats"])
            acc = carry_np["acc"].astype(np.int64)
        else:
            acc = st.restore_warm(resilience.warm_assignment(ckpt))
        st.stats.resumed_at = int(ckpt.superstep)
        st.stats.restore_s += time.perf_counter() - t0

    if carry_np is None:
        # seed every empty phase with one random vertex -- the pipeline
        # driver's loop, so the schedule starts from the same state and
        # random stream position
        seeds = st.random_unassigned(
            int(((acc == 0) & (targets > 0)).sum()))
        gi = 0
        for g in range(k):
            if targets[g] == 0 or acc[g] > 0 or gi >= seeds.size:
                continue
            v = seeds[gi:gi + 1]
            gi += 1
            st.assign_now(v, g)
            st.activate_phase(v, g)
            acc[g] += 1
        carry_np, caps = _device_export(st, k, acc, caps, cache_f16)

    cfg = device_loop.DeviceLoopConfig(
        n=n, m=m, kG=k, rows=R, pool_cap=P, t=t, tile_l=int(st.tile_l),
        bud=caps["bud"], pp=caps["pp"], sp=caps["sp"], act=caps["act"],
        rawt=caps["rawt"], rawd=caps["rawd"], cw=caps["cw"],
        cache_f16=cache_f16)
    cls_edge = np.where(
        sizes <= 1, np.int64(0),
        np.ceil(np.log2(np.maximum(sizes, 2))).astype(np.int64))

    def upload():
        consts = device_loop.consts_to_device(dict(
            adj_indptr=st.dev[0], adj_indices=st.dev[1],
            v2e_indptr=hg.v2e_indptr, v2e_indices=hg.v2e_indices,
            e2v_indptr=hg.e2v_indptr, e2v_indices=hg.e2v_indices,
            cls_edge=cls_edge, deg=st.deg, vdeg=vdeg, targets=targets,
            rand_order=st.rand_order,
            fringe=np.full((k, 1), -1, dtype=np.int32)), st.device)
        return consts, device_loop.DeviceLoop(
            cfg, consts, device_loop.carry_to_device(carry_np, st.device))

    # the upload and the CUDA graph's capture: an OOM here reruns fresh
    # at the next rung (no partial)
    consts, loop = membudget.oom_guard(
        upload, "device loop image upload failed", st.mem_rung)
    graphs["captures"] += loop.graph is not None
    graphs["capture_s"] += loop.capture_s
    st.stats.loop_state_bytes = device_loop.carry_bytes(carry_np)
    st.stats.device_image_bytes = int(sum(
        v.nbytes for v in consts.values())) + st.stats.loop_state_bytes

    def snapshot(ss_now: int) -> np.ndarray:
        t0 = time.perf_counter()
        st.stats.snapshots += 1
        cn = device_loop.carry_to_numpy(loop.carry)
        # the assignment under the key every engine's payload has (the
        # same array: pickled once)
        pay = {"carry": cn, "caps": dict(caps), "assignment": cn["assign"],
               "stats": dataclasses.replace(st.stats)}
        resilience.save_snapshot(
            p.snapshot_dir, resilience.PartitionCheckpoint(
                engine, ss_now, hg.fingerprint(), dict(config), pay),
            keep_last=int(p.keep_last))
        st.stats.snapshot_s += time.perf_counter() - t0
        return cn["assign"]

    # The host loop runs the JAX driver's chunks: each is probed for
    # faults up front, capped at the snapshot cadence, and ends at an
    # injected nan's ordinal. On the card a chunk may take several
    # calls (replays cannot stop early, and pack-only rounds add no
    # superstep); the poisoned superstep runs off the graph.
    ss_now = int(carry_np["supersteps"])
    last_snap = chunk_end = ss_now
    pending = 0         # the ordinal of the chunk's injected nan, or 0
    progress = 1
    acc_h = acc
    host_accum = 0.0
    # the assignment a memory fallback warm-starts from: the seeded host
    # state, then each snapshot's (the host sees no assignment between)
    last_known = st.assignment.copy()
    try:
        while True:
            t_host = time.perf_counter()
            live = bool((acc_h < targets).any()) and progress > 0
            if ss_now >= chunk_end or not live:
                if snap_every and ss_now - last_snap >= snap_every:
                    last_known = snapshot(ss_now)
                    last_snap = ss_now
                if not live:
                    break   # done, or starved: stragglers sit in other pools
                cap = chunk_max
                if snap_every:
                    cap = max(1, min(cap, snap_every - (ss_now - last_snap)))
                _device_probe_faults(st, ss_now + 1, ss_now + cap)
                pending = _device_probe_nan(st, ss_now + 1, ss_now + cap)
                if pending:
                    cap = pending - ss_now      # the poisoned step ends it
                chunk_end = ss_now + cap
            if pending and ss_now == pending - 1:
                sub, poison_at = 1, pending
            else:
                poison_at = 0
                sub = (pending - 1 if pending else chunk_end) - ss_now
                if loop.graph is not None:
                    # cap the replays at a lower bound of the rounds still to
                    # come (a phase gains at most t a round)
                    sub = min(sub, -(-int((targets - acc_h).max()) // t))
                    graphs["replays"] += sub
            host_accum += time.perf_counter() - t_host
            t_dev = time.perf_counter()
            flags, progress, ss_now, acc_h = membudget.oom_guard(
                lambda: loop.run_chunk(sub, poison_at),
                "device loop chunk failed", st.mem_rung)
            st.stats.device_s += time.perf_counter() - t_dev
            st.stats.loop_chunks += 1
            if poison_at:
                pending = 0
            if flags & device_loop.FLAG_POISON:
                if poison_at:   # the injected round's clean replay failed too
                    raise resilience.UnrecoverableFault(
                        f"superstep {poison_at} still poisoned after a clean "
                        f"replay: the kernel emits non-finite scores for "
                        f"finite inputs")
                # a real fault of the kernel: no replay, and not a fault the
                # degradation ladder takes
                raise RuntimeError(
                    "the device loop scored a real row non-finite: the "
                    "hype_score_select kernel emits non-finite scores for "
                    "finite inputs")
            if flags:
                return ("overflow", flags, caps)
    except membudget.DeviceOOM as exc:
        if exc.rung is None:
            exc.rung = int(st.mem_plan.rung)
        exc.partial = last_known
        raise
    st.stats.host_s += host_accum

    # final download + host mirror
    c = loop.carry
    st.assignment = c["assign"][:n].cpu().numpy().copy()
    acc = c["acc"].cpu().numpy().astype(np.int64)
    dstats = c["stats"].cpu().numpy().astype(np.int64)
    s = st.stats
    s.supersteps = int(c["supersteps"])
    s.kernel_calls += s.supersteps
    s.loop_rounds += int(dstats[device_loop.S_ROUNDS])
    s.loop_pack_only += int(dstats[device_loop.S_PACK_ONLY])
    s.loop_store_peak = max(s.loop_store_peak,
                            int(dstats[device_loop.S_STORE_PEAK]))
    s.refill_signals += int(dstats[device_loop.S_REFILL])
    s.kernel_rows += int(dstats[device_loop.S_KERNEL_ROWS])
    s.edges_scanned += int(dstats[device_loop.S_EDGES_SCANNED])
    s.cache_invalidations += int(dstats[device_loop.S_CACHE_INV])
    s.cache_hits += int(dstats[device_loop.S_CACHE_HITS])
    s.random_restarts += int(dstats[device_loop.S_RESTARTS])
    s.stale_redraws += int(dstats[device_loop.S_STALE])
    s.retries += int(dstats[device_loop.S_RETRIES])
    graphs["off_rounds"] += loop.off_rounds
    s.graph_captures = graphs["captures"]
    s.graph_replays = graphs["replays"]
    s.graph_nodes = loop.nodes
    s.graph_capture_s = graphs["capture_s"]
    s.graph_off_rounds = graphs["off_rounds"]
    # safety net: balance-fill any stragglers into underfull phases
    rem_v = np.flatnonzero(st.assignment < 0)
    if rem_v.size:
        deficit = np.maximum(targets - acc, 0)
        fill = np.repeat(np.arange(k), deficit)[:rem_v.size]
        st.assignment[rem_v[:fill.size]] = fill.astype(np.int32)
    st.in_pool[:] = False
    st.stats.peak_bytes_observed = int(
        membudget.observed_peak_bytes(st.device)
        or st.stats.peak_bytes_planned)
    return ("ok", st.assignment, st)


def _run_device_loop(hg: Hypergraph, k: int, p: DeviceParams, device,
                     caps: Optional[dict] = None):
    """Run the device loop with the capacity-doubling rerun ladder.

    ``caps`` overrides planned capacities (``sp``, ``act``, ``rawt``,
    ``rawd``). Returns ``(assignment, st)`` or ``(None, None)`` for the
    caller's fallback. A rerun with a doubled cap lands on the same bits
    (the schedule does not depend on capacities); FLAG_SEQ has no
    doubling answer and falls back.
    """
    caps_over = dict(caps or {})
    graphs = dict(captures=0, replays=0, off_rounds=0, capture_s=0.0)
    for _ in range(5):
        kind, a, b = _device_attempt(hg, k, p, caps_over, device, graphs)
        if kind == "ok":
            return a, b
        if kind == "fallback":
            return None, None
        flags, used = a, b
        if flags & device_loop.FLAG_SEQ:
            return None, None
        for flag, key in ((device_loop.FLAG_STORE, "sp"),
                          (device_loop.FLAG_ACT, "act"),
                          (device_loop.FLAG_RAWT, "rawt"),
                          (device_loop.FLAG_RAWD, "rawd")):
            if flags & flag:
                caps_over[key] = 2 * used[key]
    return None, None


def hype_device_partition(hg: Hypergraph, k: int,
                          params: Optional[DeviceParams] = None,
                          return_stats: bool = False, *, device):
    """Partition ``hg`` with the device-resident loop.

    Bit-identical to ``hype_superstep_partition`` at ``pipeline_depth=1``
    with matching knobs. ``device`` is where the loop runs (``"cuda"``:
    one captured round replayed a chunk at a time; ``"cpu"``: the same
    round eagerly). Falls back to ``hype_superstep_partition`` on the
    same device when the int32 encoding gates reject the graph or the
    sequence space runs out, as the JAX engine does, and to it too when
    ``mem_budget`` plans below rung 0. A device OOM falls down the host
    pipeline's memory rungs from rung 1, at depth 1, warm-started from
    the last logical chunk boundary's assignment, with ``fallbacks`` 1
    (``_oom_fallback``). With ``refine_passes`` > 0 the k-way refinement
    post-pass follows. The fault plan is resolved once, so a spec
    consumed by one attempt does not fire again in the next.
    """
    if params is None:
        params = DeviceParams()
    if params.rows is None:
        params = dataclasses.replace(params, rows=max(8, params.t))
    if k < 1:
        raise ValueError("k must be >= 1")
    if params.t < 1 or params.rows < 1 or params.pool_cap < 1:
        raise ValueError("rows, pool_cap, t must all be >= 1")
    if int(params.chunk_supersteps) < 1:
        raise ValueError("chunk_supersteps must be >= 1")
    if params.cache_dtype not in ("float32", "float16"):
        raise ValueError("cache_dtype must be float32 or float16")
    if params.snapshot_every > 0 and not params.snapshot_dir:
        raise ValueError("snapshot_every requires snapshot_dir")
    if k == 1:
        out = np.zeros(hg.n, dtype=np.int32)
        return (out, BatchedStats()) if return_stats else out
    fplan = resilience.resolve_fault_plan(params.fault_plan)
    if fplan is not None:
        params = dataclasses.replace(params, fault_plan=fplan)
    try:
        assignment, st = _run_device_loop(hg, k, params, device)
        oom = None
    except membudget.DeviceOOM as exc:
        oom = (exc.rung, exc.partial)
    if oom is not None:
        # past the except block: the failed attempt's loop, its captured
        # graph and its carry are unreachable now, so collect them before
        # the next rung allocates
        gc.collect()
        return _oom_fallback(hg, k, params, return_stats, device, *oom)
    if assignment is None:
        return hype_superstep_partition(hg, k, params, return_stats,
                                        device=device)
    assert (assignment >= 0).all()
    assignment = maybe_refine(hg, k, params, assignment, st.stats, device)
    if return_stats:
        return assignment, st.stats
    return assignment


def _oom_fallback(hg: Hypergraph, k: int, params: DeviceParams,
                  return_stats: bool, device, rung: Optional[int],
                  partial: Optional[np.ndarray]):
    """The device loop ran out of memory: run ``hype_superstep``'s host
    pipeline down its memory rungs instead, as the JAX engine does.

    The ladder keeps this engine's lock-step cadence (depth 1) and starts
    at the rung after the failed one, warm-started from ``partial`` (the
    assignment at the last logical chunk boundary), so an OOM at the
    upload reruns fresh and lands on the schedule the loop would have
    run. Each further ``DeviceOOM`` takes the next rung; an exhausted
    ladder raises ``UnrecoverableFault``.
    """
    params = dataclasses.replace(params, pipeline_depth=1)
    rung = 1 if rung is None else int(rung) + 1
    warm = partial if partial is not None and (partial >= 0).any() else None
    retries = 1
    while True:
        try:
            assignment, pst = superstep_pipeline(
                hg, k, params, device=device, mem_rung=rung, mem_warm=warm,
                mem_retries=retries)
            break
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
    if assignment is None:
        return hype_batched_partition(hg, k, params, return_stats,
                                      device=device)
    pst.stats.fallbacks += 1
    assert (assignment >= 0).all()
    assignment = maybe_refine(hg, k, params, assignment, pst.stats, device)
    return (assignment, pst.stats) if return_stats else assignment


__all__ = ["DeviceParams", "hype_device_partition"]
