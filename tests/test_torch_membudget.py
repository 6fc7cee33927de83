"""The port's memory budgeting against the JAX package, on the CPU.

One counterpart for each test of ``tests/test_membudget.py``: budget
parsing and resolution, the pure byte-model planner and its rung ladder,
the paged adjacency image, and the engine's OOM recovery. Each engine
case runs the JAX function in the same test and holds the port to it:
the digest, ``plan_rung``, ``mem_retries``, ``fallbacks``, the planned
bytes and the four page counters, exactly. Then ``hype_device``'s fall
down the host pipeline's rungs (at the upload, and past the first chunk
from a snapshot's assignment) and the streaming planner.
"""
import dataclasses
import hashlib
import signal

import numpy as np
import pytest
import torch

from repro.core import membudget as jax_mb
from repro.core import metrics as jax_metrics
from repro.core import partition_api as jax_api
from repro.core import resilience as jax_res
from repro.data import synthetic as jax_synth
from repro.engines import device as jax_dev
from repro.engines import runtime as jax_runtime
from repro.engines import superstep as jax_ss
from repro_torch import partition_api as api
from repro_torch.core import membudget as mb
from repro_torch.core import metrics, resilience
from repro_torch.core.hypergraph import Hypergraph
from repro_torch.data import synthetic
from repro_torch.engines import device, runtime, superstep

_MEM_FIELDS = ("plan_rung", "mem_retries", "fallbacks", "peak_bytes_planned",
               "page_uploads", "page_hits", "page_evictions", "page_bytes")


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(a, dtype=np.int32).tobytes()).hexdigest()[:16]


def _mem(st) -> dict:
    return {f: getattr(st, f) for f in _MEM_FIELDS}


@pytest.fixture(autouse=True)
def _hang_guard(monkeypatch):
    """The JAX file's 180 s wall-clock guard: a wedged retry loop fails
    the test instead of hanging the suite. No run here may see a chaos
    run's REPRO_FAULT_PLAN or a budget from the environment."""
    monkeypatch.delenv("REPRO_FAULT_PLAN", raising=False)
    monkeypatch.delenv(mb.ENV_BUDGET, raising=False)

    def _alarm(signum, frame):
        raise TimeoutError("test exceeded the 180 s membudget guard")

    old = signal.signal(signal.SIGALRM, _alarm)
    signal.alarm(180)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _pl600(synth):
    return synth.powerlaw_hypergraph(600, 400, seed=11, max_edge=30,
                                     max_degree=20)


@pytest.fixture(scope="module")
def hg():
    return _pl600(synthetic)


@pytest.fixture(scope="module")
def jhg():
    return _pl600(jax_synth)


def _ss(hg, k=5, **kw):
    """The port's hype_superstep on the CPU with its stats."""
    return superstep.hype_superstep_partition(
        hg, k, superstep.SuperstepParams(seed=0, t=8, **kw), True,
        device="cpu")


def _jss(jhg, k=5, **kw):
    return jax_ss.hype_superstep_partition(
        jhg, k, jax_ss.SuperstepParams(seed=0, t=8, **kw), True)


@pytest.fixture(scope="module")
def base_d2(hg):
    """The port's unconstrained depth-2 run (assignment, stats)."""
    return _ss(hg)


@pytest.fixture(scope="module")
def base_d1(hg):
    """The port's unconstrained depth-1 (lock-step) assignment."""
    return _ss(hg, pipeline_depth=1)[0]


# -------------------------------------------------- parsing / taxonomy

@pytest.mark.parametrize("text", [
    None, 0, "", " none ", "unlimited", 12345, "512", "2KB", "2KiB",
    "512MB", "1.5GiB", "2g", np.int64(7)])
def test_parse_budget(text):
    assert mb.parse_budget(text) == jax_mb.parse_budget(text)
    for bad in ("lots", "12 parsecs"):
        with pytest.raises(ValueError, match="unparseable"):
            mb.parse_budget(bad)


def test_is_oom_error():
    class XlaRuntimeError(RuntimeError):
        pass

    class OutOfMemoryError(RuntimeError):
        pass

    cases = [MemoryError(),
             XlaRuntimeError("RESOURCE_EXHAUSTED: Out of memory allocating "
                             "1073741824 bytes"),
             RuntimeError("device out of memory"),
             OutOfMemoryError("alloc failed"),
             ValueError("bad tile width"),
             RuntimeError("INVALID_ARGUMENT: shape")]
    assert ([mb.is_oom_error(e) for e in cases]
            == [jax_mb.is_oom_error(e) for e in cases]
            == [True, True, True, True, False, False])
    # the caching allocator's own error, whatever its message says
    assert mb.is_oom_error(torch.OutOfMemoryError("allocation failed"))
    assert not mb.is_oom_error(RuntimeError("CUDA error: an illegal "
                                            "memory access"))


def test_resolve_budget_priority(monkeypatch):
    monkeypatch.setenv(mb.ENV_BUDGET, "1MB")
    for knob in ("2KiB", None, 0, "none"):
        assert mb.resolve_budget(knob, "cpu") == jax_mb.resolve_budget(knob)
    assert mb.resolve_budget("2KiB", "cpu") == 2048          # knob wins
    assert mb.resolve_budget(None, "cpu") == 10 ** 6         # env next
    assert mb.resolve_budget("none", "cpu") is None          # explicit
    monkeypatch.delenv(mb.ENV_BUDGET)
    # no knob, no env: the probe, which has nothing to say on the CPU
    assert mb.resolve_budget(None, "cpu") is None
    assert mb.probe_device_budget("cpu") is None
    assert mb.observed_peak_bytes("cpu") is None
    probed = mb.resolve_budget(None)
    assert probed is None or probed > 0


# --------------------------------------------------------- pure planner

def _spec(mod, **kw):
    base = dict(n=600, adj_pins=20_000, k=5, rows=8, pool_cap=64, t=8,
                tile_l=512, pipeline_depth=2)
    base.update(kw)
    return mod.MemSpec(**base)


def _plans(plans):
    return [dataclasses.astuple(p) for p in plans]


def test_estimate_bytes_monotone():
    """Planned bytes are monotone in every size input, and equal JAX's
    for every input and override."""
    base = _spec(mb)
    b0 = mb.estimate_plan_bytes(base)
    assert b0 > 0 and b0 == jax_mb.estimate_plan_bytes(_spec(jax_mb))
    for field, bump in [("n", 600), ("adj_pins", 50_000), ("k", 11),
                        ("rows", 24), ("pool_cap", 128), ("t", 24),
                        ("tile_l", 2048), ("pipeline_depth", 3),
                        ("adj_pins", 2 ** 31)]:
        bigger = mb.estimate_plan_bytes(_spec(mb, **{field: bump}))
        assert bigger >= b0, field
        assert bigger == jax_mb.estimate_plan_bytes(
            _spec(jax_mb, **{field: bump}))
    for kw in (dict(tile_l=128), dict(g_chunk=2), dict(pipeline_depth=1),
               dict(spill_cache=True), dict(paged=True, page_bytes=1 << 20)):
        got = mb.estimate_plan_bytes(base, **kw)
        assert got == jax_mb.estimate_plan_bytes(_spec(jax_mb), **kw)
        if "paged" not in kw:
            assert got <= b0


def test_rung_ladder_deterministic_and_cumulative():
    a = mb.rung_ladder(_spec(mb))
    assert a == mb.rung_ladder(_spec(mb))               # deterministic
    assert _plans(a) == _plans(jax_mb.rung_ladder(_spec(jax_mb)))
    assert [p.rung for p in a] == list(range(6))
    assert a[1].g_chunk == 2 and a[2].tile_l < 512
    assert a[3].pipeline_depth == 1
    assert a[4].spill_cache and a[4].g_chunk == 1
    assert a[5].paged and not a[5].spill_cache and a[5].page_bytes > 0
    planned = [p.planned_bytes for p in a]
    assert planned[:4] == sorted(planned[:4], reverse=True)
    assert len(set(planned[:4])) == 4
    assert planned[4] < planned[0]
    # the paged rung's allowance sized from a budget
    for budget in (10 ** 5, 10 ** 7):
        assert _plans(mb.rung_ladder(_spec(mb), budget=budget)) == _plans(
            jax_mb.rung_ladder(_spec(jax_mb), budget=budget))


def test_rung_ladder_feature_gating():
    plans = mb.rung_ladder(_spec(mb), mb.SHARDED_FEATURES)
    assert _plans(plans) == _plans(jax_mb.rung_ladder(
        _spec(jax_mb), jax_mb.SHARDED_FEATURES))
    assert all(not p.spill_cache and not p.paged and p.g_chunk == 1
               for p in plans)
    small = mb.rung_ladder(_spec(mb, tile_l=32))
    assert all(p.tile_l == 32 for p in small)
    assert _plans(small) == _plans(jax_mb.rung_ladder(_spec(jax_mb,
                                                            tile_l=32)))
    assert (mb.SUPERSTEP_FEATURES, mb.SHARDED_FEATURES) == (
        jax_mb.SUPERSTEP_FEATURES, jax_mb.SHARDED_FEATURES)


def test_plan_memory_picks_first_fitting_rung():
    spec, plans = _spec(mb), mb.rung_ladder(_spec(mb))
    p0 = mb.plan_memory(spec, None)
    assert p0.rung == 0 and p0.fits and p0.tile_l == spec.tile_l
    assert mb.plan_memory(spec, plans[0].planned_bytes * 10).rung == 0
    chosen = mb.plan_memory(spec, plans[2].planned_bytes)
    assert chosen.rung == 2 and chosen.fits
    for budget in (None, plans[2].planned_bytes, plans[4].planned_bytes,
                   24_000, 1):
        assert dataclasses.astuple(mb.plan_memory(spec, budget)) == \
            dataclasses.astuple(jax_mb.plan_memory(_spec(jax_mb), budget))


def test_plan_memory_best_effort_when_nothing_fits():
    plan = mb.plan_memory(_spec(mb), 1)
    assert not plan.fits and plan.rung == mb.rung_ladder(_spec(mb))[-1].rung
    assert dataclasses.astuple(plan) == dataclasses.astuple(
        jax_mb.plan_memory(_spec(jax_mb), 1))


def test_plan_memory_rung_start_and_exhaustion():
    assert mb.plan_memory(_spec(mb), None, rung_start=2).rung == 2
    with pytest.raises(mb.MemoryLadderExhausted):
        mb.plan_memory(_spec(mb), None, rung_start=99)
    with pytest.raises(mb.MemoryLadderExhausted):
        mb.plan_memory(_spec(mb), None, rung_start=6)


def test_dtype_narrowing_helpers():
    for v in (2 ** 31 - 1, 2 ** 31):
        assert mb.device_ptr_nbytes(v) == jax_mb.device_ptr_nbytes(v)
    for v in (2 ** 15 - 1, 2 ** 15):
        assert mb.narrow_len_dtype(v) is jax_mb.narrow_len_dtype(v)
    assert mb.narrow_len_dtype(2 ** 15 - 1) is np.int16


# ------------------------------------------------------- paged adjacency

def _synthetic_csr(n=200_000, deg=4, seed=0):
    rng = np.random.default_rng(seed)
    indptr = (np.arange(n + 1, dtype=np.int64) * deg)
    indices = rng.integers(0, n, size=n * deg).astype(np.int32)
    return indptr, indices


def _page_counters(stats):
    return (stats.page_uploads, stats.page_hits, stats.page_evictions,
            stats.page_bytes)


def test_paged_gather_matches_dense_reference():
    indptr, indices = _synthetic_csr()
    stats, jstats = runtime.BatchedStats(), jax_runtime.BatchedStats()
    pa = mb.PagedAdjacency((indptr, indices), page_bytes=1, stats=stats)
    ja = jax_mb.PagedAdjacency((indptr, indices), page_bytes=1,
                               stats=jstats)
    assert (pa.n_chunks, pa.chunk_rows, pa.chunk_pins) == (
        ja.n_chunks, ja.chunk_rows, ja.chunk_pins)
    assert pa.n_chunks > 4
    rng = np.random.default_rng(1)
    ids = rng.integers(0, pa.n, size=64).astype(np.int32)
    ids[::7] = -1                             # pad rows stay all -1
    tile_l = 16
    got = pa.gather(ids, tile_l)
    assert got.dtype == torch.int32
    want = np.full((ids.size, tile_l), -1, np.int32)
    for i, v in enumerate(ids):
        if v >= 0:
            row = indices[indptr[v]:indptr[v + 1]][:tile_l]
            want[i, :row.size] = row
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(np.asarray(ja.gather(ids, tile_l)), want)
    assert _page_counters(stats) == _page_counters(jstats)
    assert stats.page_uploads > 0 and stats.page_bytes > 0


def test_paged_lru_hits_and_evictions():
    indptr, indices = _synthetic_csr()
    stats, jstats = runtime.BatchedStats(), jax_runtime.BatchedStats()
    pa = mb.PagedAdjacency((indptr, indices), page_bytes=1, stats=stats)
    ja = jax_mb.PagedAdjacency((indptr, indices), page_bytes=1,
                               stats=jstats)
    ids = (np.arange(pa.n_chunks) * pa.chunk_rows).astype(np.int32)
    for sel in (ids, ids[-1:], ids[::3], ids):
        pa.gather(sel, 8)
        ja.gather(sel, 8)
        assert _page_counters(stats) == _page_counters(jstats)
        assert pa.resident_bytes == ja.resident_bytes <= pa.page_bytes
    assert stats.page_evictions > 0 and stats.page_hits >= 1


# -------------------------------------------------- engine-level contract

def test_unconstrained_budget_is_rung0_golden(hg, jhg, base_d1):
    a, st = _ss(hg, pipeline_depth=1, mem_budget="none")
    ja, jst = _jss(jhg, pipeline_depth=1, mem_budget="none")
    assert _digest(a) == _digest(base_d1) == _digest(ja)
    assert _mem(st) == _mem(jst)
    assert st.plan_rung == 0 and st.mem_retries == 0
    # on the CPU the observed peak is the planned bytes, as in JAX
    assert st.peak_bytes_observed == st.peak_bytes_planned > 0


def test_tight_budget_forces_rung_without_degradation(hg, jhg, base_d2):
    base_a, base_st = base_d2
    budget = int(base_st.peak_bytes_planned) - 1
    a, st = _ss(hg, mem_budget=budget)
    ja, jst = _jss(jhg, mem_budget=budget)
    assert st.plan_rung >= 1
    assert st.mem_retries == 0 and st.fallbacks == 0
    assert _digest(a) == _digest(base_a) == _digest(ja)
    assert _mem(st) == _mem(jst)
    assert metrics.k_minus_1(hg, a) == jax_metrics.k_minus_1(jhg, ja)


@pytest.mark.parametrize("rung", [1, 2, 3, 4, 5])
def test_forced_rungs_bit_exact(hg, jhg, base_d2, base_d1, rung):
    """Each forced rung lands on JAX's run at that rung: rungs 1-2 keep
    the depth-2 schedule, rungs 3-5 the lock-step one."""
    a, st = superstep.run_pipeline(
        hg, 5, superstep.SuperstepParams(seed=0, t=8, rows=8),
        device="cpu", mem_rung=rung)
    ja, jst = jax_ss.run_pipeline(
        jhg, 5, jax_ss.SuperstepParams(seed=0, t=8, rows=8), mem_rung=rung)
    want = base_d2[0] if rung <= 2 else base_d1
    assert _digest(a) == _digest(want) == _digest(ja), rung
    assert st.stats.plan_rung == rung
    assert _mem(st.stats) == _mem(jst.stats)
    assert st.tile_l == jst.tile_l and st.g_chunk == jst.g_chunk
    if rung == 5:
        assert st.stats.page_uploads > 0 and st.dev == (None, None)
    if rung == 4:
        assert st.dev_cache is None and st.host_cache is not None


@pytest.mark.parametrize("rung", [1, 2, 3, 4, 5])
def test_forced_rungs_equal_jax_when_selection_matters(hg, jhg, rung):
    """JAX's forced-rung case admits every fresh row (rows = t = 8), so
    no score decides anything there. With 16 rows a phase and t = 4 the
    select ranks real scores and the held pool serves cached ones: the
    chunked rung's pad phase (k = 5 in chunks of 3), the spill rung's
    host decrements and the paged rung's masking all decide the bits."""
    p = dict(seed=0, t=4, rows=16)
    a, st = superstep.run_pipeline(hg, 5, superstep.SuperstepParams(**p),
                                   device="cpu", mem_rung=rung)
    ja, jst = jax_ss.run_pipeline(jhg, 5, jax_ss.SuperstepParams(**p),
                                  mem_rung=rung)
    assert _digest(a) == _digest(ja)
    assert _mem(st.stats) == _mem(jst.stats)
    assert st.stats.cache_hits == jst.stats.cache_hits > 0
    # the bit-exact rungs against the rung they reduce
    base = {1: 0, 4: 3, 5: 3}.get(rung)
    if base is not None:
        b, _ = superstep.run_pipeline(hg, 5, superstep.SuperstepParams(**p),
                                      device="cpu", mem_rung=base)
        assert _digest(a) == _digest(b)


def test_paged_rung_runs_csr_exceeding_budget(hg, jhg, base_d1):
    a, st = _ss(hg, mem_budget="24KB")
    ja, jst = _jss(jhg, mem_budget="24KB")
    assert st.plan_rung == 5 and st.page_uploads > 0
    assert _digest(a) == _digest(base_d1) == _digest(ja)
    assert _mem(st) == _mem(jst)


def test_injected_and_real_oom_converge(hg, jhg, base_d2, monkeypatch):
    """An injected non-fatal oom and a real allocator failure at the
    image upload (``torch.OutOfMemoryError``) take one path: one retry
    on the same engine at rung 1, on JAX's digest."""
    inj, sti = _ss(hg, fault_plan="oom")
    jinj, jsti = _jss(jhg, fault_plan="oom")
    assert _mem(sti) == _mem(jsti)

    calls = {"n": 0}
    real = Hypergraph.device_adjacency

    def failing_once(self, *a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise torch.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 9.31 GiB")
        return real(self, *a, **kw)

    fresh = _pl600(synthetic)               # no memoized device image
    monkeypatch.setattr(Hypergraph, "device_adjacency", failing_once)
    rea, str_ = _ss(fresh)
    assert calls["n"] == 2
    assert sti.mem_retries == 1 == str_.mem_retries
    assert sti.plan_rung == str_.plan_rung == 1
    assert _digest(inj) == _digest(rea) == _digest(base_d2[0]) \
        == _digest(jinj)


def test_oom_at_dispatch_warm_starts_next_rung(hg, jhg):
    a, st = _ss(hg, fault_plan="oom@2")
    ja, jst = _jss(jhg, fault_plan="oom@2")
    assert st.mem_retries == 1 and st.plan_rung >= 1 and st.fallbacks == 0
    assert (a >= 0).all() and (a < 5).all()
    sizes = np.bincount(a, minlength=5)
    assert sizes.max() - sizes.min() <= 1
    assert _digest(a) == _digest(ja)
    assert _mem(st) == _mem(jst)


def test_oom_ladder_exhaustion_escalates(hg):
    n_rungs = len(mb.rung_ladder(mb.MemSpec(
        n=hg.n, adj_pins=1, k=5, rows=8, pool_cap=64, t=8,
        tile_l=512, pipeline_depth=2)))
    plan = resilience.FaultPlan(
        [resilience.FaultSpec("oom", 0) for _ in range(n_rungs)])
    with pytest.raises(resilience.UnrecoverableFault,
                       match="memory rungs exhausted"):
        _ss(hg, fault_plan=plan)
    assert not plan.specs                      # every rung consumed one
    jplan = jax_res.FaultPlan(
        [jax_res.FaultSpec("oom", 0) for _ in range(n_rungs)])
    with pytest.raises(jax_res.UnrecoverableFault,
                       match="memory rungs exhausted"):
        _jss(_pl600(jax_synth), fault_plan=jplan)


def test_mem_budget_knob_via_partition(hg, jhg, base_d1):
    a = api.partition(hg, 5, "hype_superstep", device="cpu", seed=0, t=8,
                      mem_budget="24KB")
    ja = jax_api.partition(jhg, 5, "hype_superstep", seed=0, t=8,
                           mem_budget="24KB")
    assert _digest(a) == _digest(base_d1) == _digest(ja)


# ------------------------------------- hype_device down the host rungs

def _dev(hg, k, **kw):
    return device.hype_device_partition(
        hg, k, device.DeviceParams(seed=0, t=8, **kw), True, device="cpu")


def _jdev(jhg, k, **kw):
    return jax_dev.hype_device_partition(
        jhg, k, jax_dev.DeviceParams(seed=0, t=8, **kw), True)


def test_device_oom_falls_down_rung_ladder(hg, jhg):
    """An injected OOM at the first chunk: hype_superstep's pipeline at
    rung 1, depth 1, warm-started from the seeds, as JAX does."""
    a, st = _dev(hg, 16, fault_plan="oom@2")
    ja, jst = _jdev(jhg, 16, fault_plan="oom@2")
    assert (a >= 0).all() and (a < 16).all()
    sizes = metrics.partition_sizes(a, 16)
    assert sizes.max() - sizes.min() <= 1
    assert (st.mem_retries, st.plan_rung, st.fallbacks) == (1, 1, 1)
    assert _digest(a) == _digest(ja)
    assert _mem(st) == _mem(jst)


def test_device_oom_past_first_chunk_warm_starts_from_snapshot(
        hg, jhg, tmp_path):
    """chunk_supersteps=4 and a snapshot every 4: an OOM at superstep 6
    (the second chunk) warm-starts the rungs from the snapshot's
    assignment, the last one the host saw, equal to JAX's."""
    kw = dict(chunk_supersteps=4, snapshot_every=4, fault_plan="oom@6")
    a, st = _dev(hg, 16, snapshot_dir=str(tmp_path / "port"), **kw)
    ja, jst = _jdev(jhg, 16, snapshot_dir=str(tmp_path / "jax"), **kw)
    assert _digest(a) == _digest(ja)
    assert _mem(st) == _mem(jst)
    assert (st.mem_retries, st.plan_rung, st.fallbacks) == (1, 1, 1)
    # the warm start really came from the snapshot: a fresh rung-1 run
    # at depth 1 lands elsewhere
    cold = superstep.run_pipeline(
        hg, 16, superstep.SuperstepParams(seed=0, t=8, rows=8,
                                          pipeline_depth=1),
        device="cpu", mem_rung=1)[0]
    assert _digest(cold) != _digest(a)


def test_device_oom_at_upload_reruns_fresh(hg, jhg, monkeypatch):
    """A real allocator failure while the loop's image is uploaded: no
    partial, so the rung-1 pipeline reruns fresh at depth 1, on the
    depth-1 golden schedule."""
    ja, jst = _jdev(jhg, 16, fault_plan="oom")
    real = device.device_loop.consts_to_device
    calls = {"n": 0}

    def failing_once(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise torch.OutOfMemoryError("CUDA out of memory")
        return real(*a, **kw)

    monkeypatch.setattr(device.device_loop, "consts_to_device",
                        failing_once)
    a, st = _dev(hg, 16)
    assert _digest(a) == _digest(ja)
    assert _mem(st) == _mem(jst)
    assert _digest(a) == _digest(api.partition(
        hg, 16, "hype_superstep", device="cpu", t=8, pipeline_depth=1))


def test_device_budget_below_rung0_runs_superstep_rungs(hg, jhg):
    a, st = _dev(hg, 5, mem_budget="24KB")
    ja, jst = _jdev(jhg, 5, mem_budget="24KB")
    assert _digest(a) == _digest(ja)
    assert _mem(st) == _mem(jst) and st.plan_rung == 5


# ------------------------------------------------------- streaming planner

@pytest.mark.parametrize("budget", [None, 10 ** 9, 2 ** 20, 300_000, 1])
@pytest.mark.parametrize("mb_,bits,tile_l", [(256, 12, 512), (1, 8, 32),
                                              (1024, 16, 2048)])
def test_stream_planner_equals_jax(budget, mb_, bits, tile_l):
    kw = dict(n=10_000, k=16, micro_batch=mb_, sketch_bits=bits, s=16,
              tile_l=tile_l)
    spec, jspec = mb.StreamSpec(**kw), jax_mb.StreamSpec(**kw)
    assert mb.estimate_stream_bytes(spec) == \
        jax_mb.estimate_stream_bytes(jspec)
    assert mb.estimate_stream_bytes(spec, micro_batch=7, tile_l=128) == \
        jax_mb.estimate_stream_bytes(jspec, micro_batch=7, tile_l=128)
    assert mb.plan_stream_memory(spec, budget) == \
        jax_mb.plan_stream_memory(jspec, budget)


def test_real_non_oom_error_is_not_retried(hg, monkeypatch):
    """Only an allocator failure walks the rungs: any other real error
    at the upload propagates as itself, with no retry."""
    class Boom(RuntimeError):
        pass

    def boom(self, *a, **kw):
        raise Boom("upload broke")

    monkeypatch.setattr(Hypergraph, "device_adjacency", boom)
    with pytest.raises(Boom):
        _ss(_pl600(synthetic))
