"""The port's resilience against the JAX package, on the CPU.

Fault plans parsed, fired and resolved from the environment as JAX does;
the snapshot store (round trip, GC, the fingerprint guard, the
``snapshot_dir`` requirement); kill-and-resume bit for bit on every ported
engine (pl600, k=16, t=8, the depth-1 golden); each engine's snapshot
held to the JAX package's at the same ordinal; injected transient, NaN
and memory faults; a real exception propagating as itself; the poisoned
round of the device loop against JAX's program; and the degradation
ladder from ``hype_device`` and ``hype_superstep`` against JAX's
``partition_resilient``.
"""
import dataclasses
import hashlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import device_loop as jax_dl
from repro.core import metrics as jax_metrics
from repro.core import partition_api as jax_api
from repro.core import resilience as jax_res
from repro.data import synthetic as jax_synth
from repro.engines import batched as jax_batched
from repro.engines import device as jax_dev
from repro.engines import superstep as jax_ss
from repro_torch import convert
from repro_torch import partition_api as api
from repro_torch.core import device_loop, resilience
from repro_torch.core.hypergraph import Hypergraph
from repro_torch.data import synthetic
from repro_torch.engines import batched, device, superstep

# the depth-1 digest of pl600 at k=16, t=8 (tests/test_resilience.py:26)
_GOLD_PL600_16_8 = "bbcd2f732e03af91"


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(a, dtype=np.int32).tobytes()).hexdigest()[:16]


def _pl600(synth):
    return synth.powerlaw_hypergraph(600, 400, seed=11, max_edge=30,
                                     max_degree=20)


@pytest.fixture(scope="module")
def hg():
    return _pl600(synthetic)


@pytest.fixture(scope="module")
def jhg():
    return _pl600(jax_synth)


@pytest.fixture(autouse=True)
def _no_env_plan(monkeypatch):
    """A chaos run's REPRO_FAULT_PLAN must not reach the runs below that
    pass no plan."""
    monkeypatch.delenv("REPRO_FAULT_PLAN", raising=False)


# ------------------------------------------------------------ fault plans

def _fields(plan):
    return [(s.kind, s.superstep, s.fatal) for s in plan.specs]


@pytest.mark.parametrize("text", [
    "dispatch@2;nan@4,collective@3", "dispatch@9:fatal; oom", "oom@3",
    "nan@1:fatal", "", " dispatch@0 ; ;", "NaN@7", "oom:fatal,oom"])
def test_fault_plan_parse_equals_jax(text):
    got = resilience.FaultPlan.parse(text)
    assert _fields(got) == _fields(jax_res.FaultPlan.parse(text))
    assert resilience.FAULT_KINDS == jax_res.FAULT_KINDS


@pytest.mark.parametrize("text,match", [
    ("frobnicate@1", "unknown fault kind"),
    ("nan@soon", "bad fault superstep")])
def test_fault_plan_parse_errors_equal_jax(text, match):
    for mod in (resilience, jax_res):
        with pytest.raises(ValueError, match=match):
            mod.FaultPlan.parse(text)


def test_fault_plan_fire_is_one_shot_as_in_jax():
    calls = [(("nan",), 2), (("dispatch",), 1), (("dispatch",), 2),
             (("dispatch",), 2), (("oom",), 99), (("oom",), 99)]
    fired = []
    for mod in (resilience, jax_res):
        plan = mod.FaultPlan.parse("dispatch@2;oom")
        fired.append([None if sp is None else (sp.kind, sp.superstep)
                      for sp in (plan.fire(*c) for c in calls)])
        assert plan.fired and not plan.specs
    assert fired[0] == fired[1]
    assert fired[0] == [None, None, ("dispatch", 2), None, ("oom", 0), None]


def test_fault_plan_env_resolution(monkeypatch):
    assert resilience.resolve_fault_plan(None) is None
    monkeypatch.setenv("REPRO_FAULT_PLAN", "nan@1;dispatch@2")
    plan = resilience.resolve_fault_plan(None)
    assert _fields(plan) == _fields(jax_res.resolve_fault_plan(None))
    assert resilience.resolve_fault_plan(None) is not plan   # fresh
    shared = resilience.FaultPlan.parse("oom")
    assert resilience.resolve_fault_plan(shared) is shared
    assert _fields(resilience.resolve_fault_plan("nan@3")) == [
        ("nan", 3, False)]


def test_env_plan_reaches_the_engines(hg, monkeypatch):
    """The chaos drill: REPRO_FAULT_PLAN drives the port's engine as it
    drives JAX's, and recovery is exact."""
    monkeypatch.setenv("REPRO_FAULT_PLAN", "dispatch@2;nan@4")
    a, st = superstep.hype_superstep_partition(
        hg, 16, superstep.SuperstepParams(seed=0, t=8, pipeline_depth=1),
        True, device="cpu")
    assert _digest(a) == _GOLD_PL600_16_8
    assert (st.faults_injected, st.retries) == (2, 2)


# ------------------------------------------------------- snapshot store

def _mk_ckpt(mod, step, fp="f" * 16):
    return mod.PartitionCheckpoint(
        engine="hype_superstep", superstep=step, fingerprint=fp,
        config={"k": 4}, payload={"assignment": np.arange(6, dtype=np.int32)})


def test_snapshot_roundtrip_and_latest(tmp_path):
    d = str(tmp_path)
    assert resilience.latest_snapshot(d) is None
    assert resilience.load_latest(d) is None
    p2 = resilience.save_snapshot(d, _mk_ckpt(resilience, 2))
    resilience.save_snapshot(d, _mk_ckpt(resilience, 5))
    ck = resilience.load_latest(d)
    assert ck.superstep == 5 and ck.engine == "hype_superstep"
    np.testing.assert_array_equal(resilience.warm_assignment(ck),
                                  np.arange(6))
    assert resilience.load_snapshot(p2).superstep == 2
    assert resilience.load_latest(p2).superstep == 2
    with open(os.path.join(d, "LATEST")) as f:
        assert f.read().strip() == "snap_00000005.ckpt"
    # the same file names and pointer as the JAX store
    jd = str(tmp_path / "jax")
    jax_res.save_snapshot(jd, _mk_ckpt(jax_res, 5))
    assert sorted(os.listdir(jd)) == ["LATEST", "snap_00000005.ckpt"]


def test_snapshot_gc_keeps_last(tmp_path):
    d = str(tmp_path)
    for step in range(1, 7):
        resilience.save_snapshot(d, _mk_ckpt(resilience, step), keep_last=3)
        os.utime(os.path.join(d, "snap_%08d.ckpt" % step),
                 (step, step))      # distinct mtimes, oldest first
    snaps = sorted(f for f in os.listdir(d) if f.endswith(".ckpt"))
    assert snaps == ["snap_00000004.ckpt", "snap_00000005.ckpt",
                     "snap_00000006.ckpt"]
    assert resilience.load_latest(d).superstep == 6


def test_snapshot_of_a_port_class_needs_no_jax(tmp_path):
    """A snapshot pickles the port's classes: the JAX loader refuses it
    (ROADMAP.md queue 3: snapshots are not interchangeable)."""
    path = resilience.save_snapshot(str(tmp_path), _mk_ckpt(resilience, 1))
    with pytest.raises(ValueError, match="not a PartitionCheckpoint"):
        jax_res.load_snapshot(path)


def test_checkpoint_fingerprint_guard(hg, jhg):
    assert hg.fingerprint() == jhg.fingerprint()
    with pytest.raises(ValueError, match="fingerprint"):
        resilience.check_checkpoint(_mk_ckpt(resilience, 3, "0" * 16), hg, 4)
    ck = _mk_ckpt(resilience, 3, fp=hg.fingerprint())
    resilience.check_checkpoint(ck, hg, 4)
    with pytest.raises(ValueError, match="k="):
        resilience.check_checkpoint(ck, hg, 8)


def test_resume_against_wrong_graph_raises(hg, tmp_path):
    other = synthetic.powerlaw_hypergraph(100, 80, seed=1, max_edge=6,
                                          max_degree=5)
    d = str(tmp_path)
    superstep.hype_superstep_partition(other, 4, superstep.SuperstepParams(
        seed=0, snapshot_every=1, snapshot_dir=d), device="cpu")
    with pytest.raises(ValueError, match="fingerprint"):
        superstep.hype_superstep_partition(
            hg, 4, superstep.SuperstepParams(seed=0, resume=d),
            device="cpu")


@pytest.mark.parametrize("method", ["hype_batched", "hype_superstep",
                                    "hype_device"])
def test_snapshot_requires_dir(method):
    hg = Hypergraph.from_edge_lists(6, [[0, 1], [1, 2, 3]])
    with pytest.raises(ValueError, match="snapshot_dir"):
        api.partition(hg, 2, method, device="cpu", snapshot_every=2)


# ---------------------------------------------- kill and resume, exactly

def _run(method, hg, d, resume=None, plan=None, **kw):
    params = {"hype_batched": batched.BatchedParams,
              "hype_superstep": superstep.SuperstepParams,
              "hype_device": device.DeviceParams}[method]
    runner = {"hype_batched": batched.hype_batched_partition,
              "hype_superstep": superstep.hype_superstep_partition,
              "hype_device": device.hype_device_partition}[method]
    return runner(hg, 16, params(seed=0, snapshot_dir=d, resume=resume,
                                 fault_plan=plan or resilience.FaultPlan(),
                                 **kw), True, device="cpu")


_RESUME = {
    "superstep_pd1": ("hype_superstep", "dispatch@5:fatal",
                      dict(t=8, pipeline_depth=1, snapshot_every=2)),
    "superstep_pd2": ("hype_superstep", "dispatch@5:fatal",
                      dict(t=8, pool_cap=8, pipeline_depth=2,
                           snapshot_every=3)),
    "batched": ("hype_batched", "dispatch@9:fatal",
                dict(t=8, snapshot_every=3)),
    "device": ("hype_device", "dispatch@5:fatal",
               dict(t=8, snapshot_every=4)),
}


@pytest.mark.parametrize("case", sorted(_RESUME))
def test_kill_and_resume_bit_identical(case, hg, jhg, tmp_path):
    """A snapshotting run killed by a fatal fault, then resumed: the
    uninterrupted run's bits with the same cadence, which is the golden
    at depth 1 and JAX's same-cadence run at depth 2."""
    method, plan, kw = _RESUME[case]
    base, bst = _run(method, hg, str(tmp_path / "base"), **kw)
    d = str(tmp_path / "killed")
    with pytest.raises(resilience.UnrecoverableFault):
        _run(method, hg, d, plan=plan, **kw)
    assert any(f.endswith(".ckpt") for f in os.listdir(d))
    a, st = _run(method, hg, d, resume=d, **kw)
    assert _digest(a) == _digest(base)
    assert st.resumed_at >= kw["snapshot_every"] and st.restore_s >= 0.0
    assert bst.snapshots > 0 and bst.snapshot_s >= 0.0
    if case == "superstep_pd2":
        jax_a = jax_ss.hype_superstep_partition(
            jhg, 16, jax_ss.SuperstepParams(
                seed=0, snapshot_every=3, snapshot_dir=str(tmp_path / "jax"),
                fault_plan=jax_res.FaultPlan(), t=8, pool_cap=8))
        assert _digest(a) == _digest(jax_a)
    elif case == "batched":
        plain = api.partition(hg, 16, "hype_batched", device="cpu", t=8)
        assert _digest(a) == _digest(plain)   # the cadence is transparent
    else:
        assert _digest(a) == _GOLD_PL600_16_8


def _snap(d, step):
    return os.path.join(d, "snap_%08d.ckpt" % step)


_SNAP_AT = {
    "superstep_pd1": ("hype_superstep", 4,
                      dict(t=8, pipeline_depth=1, snapshot_every=4)),
    "superstep_pd2": ("hype_superstep", 6,
                      dict(t=8, pool_cap=8, pipeline_depth=2,
                           snapshot_every=3)),
    "batched": ("hype_batched", 6, dict(t=8, snapshot_every=3)),
    "device": ("hype_device", 4, dict(t=8, snapshot_every=4)),
}


@pytest.mark.parametrize("case", sorted(_SNAP_AT))
def test_snapshot_equals_jax_at_the_same_ordinal(case, hg, jhg, tmp_path):
    """Each engine's snapshot at one ordinal against the JAX package's:
    the warm-start assignment, and the state an exact resume reads."""
    method, step, kw = _SNAP_AT[case]
    d, jd = str(tmp_path / "port"), str(tmp_path / "jax")
    _run(method, hg, d, keep_last=100, **kw)
    jparams = {"hype_batched": jax_batched.BatchedParams,
               "hype_superstep": jax_ss.SuperstepParams,
               "hype_device": jax_dev.DeviceParams}[method]
    jax_api._engine(method)[1](jhg, 16, jparams(
        seed=0, snapshot_dir=jd, keep_last=100,
        fault_plan=jax_res.FaultPlan(), **kw))
    got = resilience.load_snapshot(_snap(d, step))
    want = jax_res.load_snapshot(_snap(jd, step))
    assert (got.engine, got.superstep, got.fingerprint) == (
        want.engine, want.superstep, want.fingerprint)
    g, w = got.payload, want.payload
    if method == "hype_device":
        # JAX's device payload has no "assignment" (ROADMAP.md queue 3)
        np.testing.assert_array_equal(resilience.warm_assignment(got),
                                      w["carry"]["assign"])
        for name, want_v in w["carry"].items():
            np.testing.assert_array_equal(g["carry"][name], want_v,
                                          err_msg=name)
        return
    np.testing.assert_array_equal(resilience.warm_assignment(got),
                                  jax_res.warm_assignment(want))
    names = (("edge_dead", "edge_epoch", "rand_ptr", "next_phase")
             if method == "hype_batched" else
             ("acc", "cur_depth", "in_pool", "cache_scored", "bq_key",
              "bq_edge", "seq_back", "seq_front", "edge_queued",
              "edge_dead", "rand_ptr", "dirty_ratchet"))
    for name in names:
        np.testing.assert_array_equal(g[name], w[name], err_msg=name)
    assert g["rng_state"] == w["rng_state"]
    if method == "hype_superstep":
        n = hg.n
        np.testing.assert_array_equal(g["dev_assign"][:n], w["dev_assign"])
        np.testing.assert_array_equal(g["dev_cache"][:n].view(np.int32),
                                      w["dev_cache"].view(np.int32))
        for a, b in zip(g["pools"], w["pools"]):
            np.testing.assert_array_equal(a, b)


# -------------------------------------------------------- injected faults

_TRANSIENT = [("hype_superstep", "dispatch@2"), ("hype_superstep", "nan@3"),
              ("hype_superstep", "dispatch@1;nan@4"),
              ("hype_device", "dispatch@2"), ("hype_device", "nan@3"),
              ("hype_device", "dispatch@2;nan@5"),
              ("hype_batched", "dispatch@2")]


@pytest.mark.parametrize("method,plan", _TRANSIENT)
def test_transient_faults_are_exact(method, plan, hg, jhg):
    """Recovery lands on the fault-free bits, counted as JAX counts it,
    and never inflates the work counters."""
    kw = dict(t=8) if method == "hype_batched" else dict(
        t=8, pipeline_depth=1)
    base, s0 = _run(method, hg, None, **kw)
    a, st = _run(method, hg, None, plan=plan, **kw)
    assert _digest(a) == _digest(base)
    n = len(plan.split(";"))
    assert (st.faults_injected, st.retries) == (n, n)
    assert st.supersteps == s0.supersteps
    assert st.kernel_calls == s0.kernel_calls
    jparams = {"hype_batched": jax_batched.BatchedParams,
               "hype_superstep": jax_ss.SuperstepParams,
               "hype_device": jax_dev.DeviceParams}[method]
    ja, jst = jax_api._engine(method)[1](
        jhg, 16, jparams(seed=0, fault_plan=plan, **kw), return_stats=True)
    assert _digest(a) == _digest(ja)
    assert (st.faults_injected, st.retries) == (jst.faults_injected,
                                                jst.retries)


def test_superstep_pd2_nan_window_replay(hg, jhg):
    """At depth 2 a poisoned superstep drags its in-flight successor into
    the replay window; the recovered run is still bit-exact."""
    kw = dict(t=8, pool_cap=8, pipeline_depth=2)
    base, _ = _run("hype_superstep", hg, None, **kw)
    # superstep 5 has its successor in flight: two replays
    a, st = _run("hype_superstep", hg, None, plan="nan@5", **kw)
    assert _digest(a) == _digest(base)
    ja, jst = jax_ss.hype_superstep_partition(jhg, 16, jax_ss.SuperstepParams(
        seed=0, fault_plan="nan@5", **kw), return_stats=True)
    assert _digest(a) == _digest(ja)
    assert st.faults_injected == 1 and st.retries == jst.retries == 2


def test_batched_nan_quarantine_is_exact(hg, jhg):
    """A NaN-poisoned tile is rescored on the host with the kernel's
    arithmetic: the same bits, its rows counted as host rows."""
    base, s0 = _run("hype_batched", hg, None)
    a, st = _run("hype_batched", hg, None, plan="nan@2")
    assert _digest(a) == _digest(base)
    assert st.faults_injected == 1 and st.kernel_calls == s0.kernel_calls
    assert st.host_rows > s0.host_rows
    ja, jst = jax_batched.hype_batched_partition(
        jhg, 16, jax_batched.BatchedParams(seed=0, fault_plan="nan@2"),
        return_stats=True)
    assert _digest(a) == _digest(ja) and st.host_rows == jst.host_rows


@pytest.mark.parametrize("method", ["hype_superstep", "hype_batched"])
def test_retry_budget_exhaustion_is_unrecoverable(method, hg):
    """Three transient faults at one call against a budget of two
    retries. (The device loop probes a chunk's faults up front and, as
    in JAX, has no budget to exhaust.)"""
    with pytest.raises(resilience.UnrecoverableFault, match="retry budget"):
        _run(method, hg, None, plan="dispatch@2;dispatch@2;dispatch@2")


@pytest.mark.parametrize("method", ["hype_superstep", "hype_device",
                                    "hype_batched"])
def test_fatal_spec_is_consumed_and_unrecoverable(method, hg):
    plan = resilience.FaultPlan([resilience.FaultSpec("dispatch", 2, True)])
    with pytest.raises(resilience.UnrecoverableFault, match="fatal"):
        _run(method, hg, None, plan=plan)
    assert plan.fired and not plan.specs


@pytest.mark.parametrize("method,plan,match", [
    ("hype_superstep", "dispatch@3:fatal",
     "injected dispatch fault at superstep 3 \\(fatal\\)"),
    ("hype_superstep", "nan@3:fatal", "injected fatal nan tile"),
    ("hype_device", "nan@3:fatal", "injected fatal nan tile"),
    ("hype_batched", "nan@2:fatal", "injected fatal nan tile at kernel")])
def test_fatal_faults_are_unrecoverable(method, plan, match, hg):
    with pytest.raises(resilience.UnrecoverableFault, match=match):
        _run(method, hg, None, plan=plan)


@pytest.mark.parametrize("method", ["hype_superstep", "hype_device"])
def test_fatal_oom_is_unrecoverable(method, hg):
    with pytest.raises(resilience.UnrecoverableFault, match="OOM"):
        _run(method, hg, None, plan="oom:fatal")


@pytest.mark.parametrize("method,plan", [
    ("hype_superstep", "oom"), ("hype_superstep", "oom@2"),
    ("hype_device", "oom"), ("hype_device", "oom@3")])
def test_nonfatal_oom_names_memory_rungs(method, plan, hg, jhg):
    """A non-fatal oom recovers on the same engine down the memory rungs
    (hype_device down hype_superstep's pipeline): JAX's assignment,
    mem_retries, plan_rung and fallbacks."""
    a, st = _run(method, hg, None, plan=plan)
    params = {"hype_superstep": jax_ss.SuperstepParams,
              "hype_device": jax_dev.DeviceParams}[method]
    runner = {"hype_superstep": jax_ss.hype_superstep_partition,
              "hype_device": jax_dev.hype_device_partition}[method]
    ja, jst = runner(jhg, 16, params(seed=0, fault_plan=plan), True)
    assert _digest(a) == _digest(ja)
    got = (st.mem_retries, st.plan_rung, st.fallbacks, st.faults_injected)
    assert got == (jst.mem_retries, jst.plan_rung, jst.fallbacks,
                   jst.faults_injected)
    assert got[:3] == (1, 1, int(method == "hype_device"))


def test_oom_at_upload_recovers_on_same_engine(hg, jhg):
    """JAX's drill: a non-fatal oom at the upload retries the same engine
    at a smaller plan, bit-identical to the fault-free run."""
    base = _run("hype_superstep", hg, None)[0]
    a, st = _run("hype_superstep", hg, None, plan="oom")
    assert _digest(a) == _digest(base)
    assert st.mem_retries == 1 and st.plan_rung >= 1
    assert _digest(a) == _digest(jax_ss.hype_superstep_partition(
        jhg, 16, jax_ss.SuperstepParams(seed=0, fault_plan="oom")))


def test_stats_merge_rule_equals_jax():
    """Additive counters sum, high-water marks and ``resumed_at`` keep
    the max, the later ``refine`` record wins: JAX's rule on the fields
    both packages have."""
    from repro.engines.runtime import BatchedStats as JaxStats
    from repro_torch.engines.runtime import BatchedStats
    shared = [f.name for f in dataclasses.fields(BatchedStats)
              if f.name in {g.name for g in dataclasses.fields(JaxStats)}
              and f.name != "refine"]
    assert {"faults_injected", "retries", "fallbacks", "snapshots",
            "snapshot_s", "restore_s", "resumed_at"} <= set(shared)
    rng = np.random.default_rng(0)
    vals = [{n: int(v) for n, v in zip(shared, rng.integers(-1, 50,
                                                            len(shared)))}
            for _ in range(2)]
    got = BatchedStats(**vals[0], refine="a").merge(BatchedStats(**vals[1]))
    want = JaxStats(**vals[0], refine="a").merge(JaxStats(**vals[1]))
    assert {n: getattr(got, n) for n in shared} == {
        n: getattr(want, n) for n in shared}
    assert got.refine == "a" and got.resumed_at == max(
        vals[0]["resumed_at"], vals[1]["resumed_at"])


def test_abort_mid_pipeline_leaves_the_engine_reusable(hg, monkeypatch):
    """An interrupt between harvests at depth 2 tears the in-flight
    supersteps down and propagates; a fresh run is on the golden."""
    calls = {"n": 0}
    real = superstep.SuperstepState.harvest

    def exploding(self, handle, acc, targets, exclude=()):
        calls["n"] += 1
        if calls["n"] == 3:
            raise KeyboardInterrupt
        return real(self, handle, acc, targets, exclude)

    monkeypatch.setattr(superstep.SuperstepState, "harvest", exploding)
    with pytest.raises(KeyboardInterrupt):
        _run("hype_superstep", hg, None, t=8, pipeline_depth=2)
    monkeypatch.setattr(superstep.SuperstepState, "harvest", real)
    a, _ = _run("hype_superstep", hg, None, t=8, pipeline_depth=1)
    assert _digest(a) == _GOLD_PL600_16_8


# -------------------------------------------- a real exception propagates

class _Boom(RuntimeError):
    pass


def _boom(*args, **kwargs):
    raise _Boom("a real failure of the device call")


@pytest.mark.parametrize("method,target", [
    ("hype_superstep", (superstep.SuperstepState, "_call_program")),
    ("hype_device", (device_loop.DeviceLoop, "run_chunk")),
    ("hype_batched", (batched, "hype_scores"))])
def test_real_exception_propagates_unchanged(method, target, hg,
                                             monkeypatch):
    """Only injected faults are retried or escalated: a real exception
    of the program reaches the caller as itself, with no retry, and the
    ladder does not degrade on it (ROADMAP.md queue 3)."""
    seen = []
    real_init = batched.EngineRuntime.__init__

    def spy_init(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        seen.append(self)

    monkeypatch.setattr(batched.EngineRuntime, "__init__", spy_init)
    monkeypatch.setattr(*target, _boom)
    with pytest.raises(_Boom):
        _run(method, hg, None)
    assert seen and all(s.stats.retries == 0 for s in seen)
    with pytest.raises(_Boom):
        api.partition_resilient(hg, 16, method, device="cpu", seed=0, t=8)


def _nan_scores(real):
    def poisoned(*args, **kwargs):
        out = real(*args, **kwargs)
        if isinstance(out, tuple):
            return (torch.full_like(out[0], float("nan")),) + out[1:]
        # hype_scores returns int32 counts: a NaN needs a float tile
        return torch.full(out.shape, float("nan"), dtype=torch.float32)
    return poisoned


@pytest.mark.parametrize("method,kernel,kw", [
    ("hype_superstep", (superstep, "hype_score_select"),
     dict(pipeline_depth=1)),
    ("hype_superstep", (superstep, "hype_score_select"),
     dict(pipeline_depth=2)),
    ("hype_device", (device_loop, "hype_score_select"), {}),
    ("hype_batched", (batched, "hype_scores"), {})],
    ids=["superstep_pd1", "superstep_pd2", "device", "batched"])
def test_real_nan_from_the_kernel_raises_unchanged(method, kernel, kw, hg,
                                                   monkeypatch):
    """A kernel that scores real rows NaN with no injected ``nan`` is a
    fault of the kernel: a plain ``RuntimeError`` naming it, with no
    replay, no host rescore, and no rung of the ladder taking it."""
    seen = []
    real_init = batched.EngineRuntime.__init__

    def spy_init(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        seen.append(self)

    monkeypatch.setattr(batched.EngineRuntime, "__init__", spy_init)
    monkeypatch.setattr(*kernel, _nan_scores(getattr(*kernel)))
    with pytest.raises(RuntimeError, match=kernel[1]) as err:
        _run(method, hg, None, t=8, **kw)
    assert not isinstance(err.value, resilience.UnrecoverableFault)
    assert seen and all(s.stats.retries == 0 for s in seen)
    if method == "hype_batched":
        # the tile was not quarantined: no rows moved to the host for it
        assert all(s.stats.kernel_calls == 0 for s in seen)
    with pytest.raises(RuntimeError, match=kernel[1]) as err:
        api.partition_resilient(hg, 16, method, device="cpu", seed=0, t=8,
                                **kw)
    assert not isinstance(err.value, resilience.UnrecoverableFault)


def _broken_after_nan(real):
    """A kernel that breaks for good once it has seen a NaN bias: the
    injected round's clean replay scores non-finite too."""
    state = {"broken": False}

    def kernel(nbrs, fringe, bias, prev, **kwargs):
        state["broken"] |= bool(torch.isnan(bias).any())
        out = real(nbrs, fringe, bias, prev, **kwargs)
        if state["broken"]:
            return (torch.full_like(out[0], float("nan")),) + out[1:]
        return out
    return kernel


@pytest.mark.parametrize("method,kernel", [
    ("hype_superstep", (superstep, "hype_score_select")),
    ("hype_device", (device_loop, "hype_score_select"))],
    ids=["superstep", "device"])
def test_injected_nan_still_poisoned_after_replay_is_unrecoverable(
        method, kernel, hg, monkeypatch):
    """A superstep that an injected ``nan`` poisoned and that scores
    non-finite again in its clean replay raises ``UnrecoverableFault``,
    as JAX's does: the fault was injected, so the ladder may take it."""
    monkeypatch.setattr(*kernel, _broken_after_nan(getattr(*kernel)))
    with pytest.raises(resilience.UnrecoverableFault,
                       match="still poisoned after a clean replay"):
        _run(method, hg, None, plan="nan@3", t=8)


# ------------------------------------------ the device loop's poisoned round

class _Captured(Exception):
    pass


def _jax_first_call(jhg, k, params):
    got = {}
    real = jax_dl.device_loop_program

    def spy(cfg):
        def first(consts, carry, chunk_cap, poison_at):
            got.update(cfg=cfg,
                       consts={k_: np.asarray(v) for k_, v in consts.items()},
                       carry={k_: np.array(v) for k_, v in carry.items()})
            raise _Captured
        real(cfg)
        return first

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_dl, "device_loop_program", spy)
        with pytest.raises(_Captured):
            jax_dev.hype_device_partition(jhg, k, params)
    return got


def test_poisoned_round_carry_equals_jax(jhg):
    """A chunk whose third superstep scores a NaN bias and replays: the
    port's eager rounds (the card's off-graph path) against JAX's
    program, every carry field equal, one retry counted."""
    first = _jax_first_call(jhg, 16, jax_dev.DeviceParams(
        seed=0, t=8, fault_plan=jax_res.FaultPlan()))
    cfg = device_loop.DeviceLoopConfig(**{
        f: getattr(first["cfg"], f)
        for f in device_loop.DeviceLoopConfig._fields})
    loop = device_loop.DeviceLoop(
        cfg, device_loop.consts_to_device(first["consts"], "cpu"),
        convert.device_carry_from_numpy(first["carry"], "cpu"))
    ss0 = int(first["carry"]["supersteps"])
    poison_at = ss0 + 3
    run = jax_dl.device_loop_program(first["cfg"])
    want = run({k: jnp.asarray(v) for k, v in first["consts"].items()},
               {k: jnp.asarray(v) for k, v in first["carry"].items()},
               jnp.int32(3), jnp.int32(poison_at))
    flags, _, ss, _ = loop.run_chunk(3, poison_at)
    got = device_loop.carry_to_numpy(loop.carry)
    for name, w in want.items():
        g, w = got[name], np.array(w)
        if g.dtype.kind == "f":
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert flags == 0 and ss == poison_at
    assert int(got["stats"][device_loop.S_RETRIES]) == 1
    assert loop.off_rounds == 0         # no graph on the CPU


# ------------------------------------------------------ degradation ladder

def _report_equal(rep, jrep):
    skip = {"runtime_s", "stats"}
    assert set(rep) == set(jrep)
    assert {k: v for k, v in rep.items() if k not in skip} == {
        k: v for k, v in jrep.items() if k not in skip}


_LADDER = {
    "device_oom": ("hype_device", "oom:fatal", {}),
    "superstep_to_numpy": ("hype_superstep",
                           "oom:fatal;dispatch@3:fatal",
                           dict(kernel_min=1)),
    "superstep_snapshot": ("hype_superstep", "dispatch@5:fatal", {}),
    "batched_to_numpy": ("hype_batched", "dispatch@3:fatal",
                         dict(kernel_min=1)),
}


@pytest.mark.parametrize("case", sorted(_LADDER))
def test_ladder_equals_jax(case, hg, jhg, tmp_path):
    """The JAX package's ladder drills, started from the port's engines:
    the same rungs, the same bits, the same report."""
    method, plan, kw = _LADDER[case]
    args = dict(seed=0, t=8, pool_cap=8, snapshot_every=2, **kw)
    a, rep = api.partition_resilient(
        hg, 16, method, device="cpu", snapshot_dir=str(tmp_path / "p"),
        fault_plan=plan, **args)
    ja, jrep = jax_api.partition_resilient(
        jhg, 16, method, snapshot_dir=str(tmp_path / "j"),
        fault_plan=plan, **args)
    assert _digest(a) == _digest(ja)
    _report_equal(rep, jrep)
    assert rep["fallbacks"] >= 1 and rep["method"] != method
    if hasattr(rep["stats"], "fallbacks"):
        assert rep["stats"].fallbacks == rep["fallbacks"]
        assert rep["stats"].resumed_at == jrep["stats"].resumed_at
    sizes = np.bincount(a, minlength=16)
    assert sizes.max() - sizes.min() <= 1


def test_ladder_from_device_snapshot(hg, jhg, tmp_path):
    """hype_device dies after snapshots; hype_superstep warm-starts from
    the last one. JAX's ladder raises KeyError here (its device payload
    has no "assignment"); the port's payload carries it, and the result
    equals JAX's superstep rung warm-started from the JAX device
    snapshot's assignment (ROADMAP.md queue 3)."""
    args = dict(seed=0, t=8, snapshot_every=2)
    a, rep = api.partition_resilient(
        hg, 16, "hype_device", device="cpu",
        snapshot_dir=str(tmp_path / "p"), fault_plan="dispatch@5:fatal",
        **args)
    assert rep["method"] == "hype_superstep" and rep["fallbacks"] == 1
    assert rep["degraded_from"] == [{
        "method": "hype_device",
        "error": "injected fatal dispatch fault at superstep 5"}]
    assert rep["stats"].resumed_at == 4 and rep["stats"].fallbacks == 1
    with pytest.raises(KeyError, match="assignment"):
        jax_api.partition_resilient(
            jhg, 16, "hype_device", snapshot_dir=str(tmp_path / "j"),
            fault_plan="dispatch@5:fatal", **args)
    ck = jax_res.load_latest(str(tmp_path / "j"))
    assert ck.engine == "hype_device" and ck.superstep == 4
    ck.payload["assignment"] = ck.payload["carry"]["assign"]
    jd = str(tmp_path / "j2")
    jax_res.save_snapshot(jd, ck)
    ja = jax_ss.hype_superstep_partition(jhg, 16, jax_ss.SuperstepParams(
        snapshot_dir=jd, resume=jd, fault_plan=jax_res.FaultPlan(), **args))
    assert _digest(a) == _digest(ja)
    want = jax_metrics.all_metrics(jhg, ja, 16)
    assert {k: rep[k] for k in want} == want


def test_ladder_default_method_is_pending(hg, jhg):
    """Once pending, now served: the default method, ``hype_sharded``,
    runs at one device and equals JAX's, report and counters."""
    a, rep = api.partition_resilient(hg, 16, device="cpu", seed=0, t=8,
                                     devices=1)
    ja, jrep = jax_api.partition_resilient(
        jhg, 16, seed=0, t=8, devices=1, fault_plan=jax_res.FaultPlan())
    assert rep["method"] == rep["requested_method"] == "hype_sharded"
    assert _digest(a) == _digest(ja)
    _report_equal(rep, jrep)
    for key in ("supersteps", "collectives", "collective_bytes",
                "admission_conflicts", "fallbacks"):
        assert getattr(rep["stats"], key) == getattr(jrep["stats"], key)
    with pytest.raises(ValueError, match="unknown resilient method"):
        api.partition_resilient(hg, 4, "shp", device="cpu")


def test_ladder_hype_rung_adopts_the_snapshot(hg, jhg, tmp_path):
    """Resuming the numpy rung directly: ``warm_start`` from the
    snapshot's assignment, as JAX's ladder does."""
    d = str(tmp_path / "p")
    _run("hype_superstep", hg, d, t=8, pipeline_depth=1, snapshot_every=4)
    a, rep = api.partition_resilient(hg, 16, "hype", device="cpu",
                                     resume=d, seed=0)
    jd = str(tmp_path / "j")
    jax_ss.hype_superstep_partition(jhg, 16, jax_ss.SuperstepParams(
        seed=0, t=8, pipeline_depth=1, snapshot_every=4, snapshot_dir=jd,
        fault_plan=jax_res.FaultPlan()))
    ja, jrep = jax_api.partition_resilient(jhg, 16, "hype", resume=jd,
                                           seed=0)
    assert _digest(a) == _digest(ja)
    _report_equal(rep, jrep)
    assert dataclasses.asdict(rep["stats"]) == dataclasses.asdict(
        jrep["stats"])
