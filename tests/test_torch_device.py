"""The port's hype_device (the device loop) against the JAX package, on
the CPU.

The depth-1 golden digests through ``partition(..., "hype_device")``;
the carry after one and after eight rounds against JAX's
``device_loop_program`` on the same first carry (four configurations);
the engine's counters against JAX ``hype_device``'s; the restart draw
against ``random_unassigned``; the capacity reruns; the unported knobs,
validation, the fallbacks and the quality preset.
"""
import dataclasses
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import device_loop as jax_dl
from repro.core import resilience
from repro.core.hypergraph import Hypergraph as JaxHypergraph
from repro.data import synthetic as jax_synth
from repro.engines import device as jax_dev
from repro_torch import convert
from repro_torch.core import device_loop, metrics
from repro_torch.core import resilience as port_resilience
from repro_torch.core.hypergraph import Hypergraph
from repro_torch.data import synthetic
from repro_torch.engines import device
from repro_torch.engines.runtime import EngineRuntime
from repro_torch.partition_api import partition


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(a, dtype=np.int32).tobytes()).hexdigest()[:16]


def _pl600(synth):
    return synth.powerlaw_hypergraph(600, 400, seed=11, max_edge=30,
                                     max_degree=20)


def _pl300(synth):
    return synth.powerlaw_hypergraph(300, 500, seed=21, max_edge=10,
                                     max_degree=30)


# ------------------------------------------------------ golden digests

# tests/test_hype_device.py:48-51 (hype_device) and tests/test_pipeline.py
# :41-42 (hype_superstep at depth 1, which the device loop equals)
_GOLDENS = {
    "pl600_k5_t8": ("pl600", 5, {"t": 8}, "9e8abe668aa53a74"),
    "pl600_k16_t8": ("pl600", 16, {"t": 8}, "bbcd2f732e03af91"),
    "pl600_k16_t16": ("pl600", 16, {"t": 16}, "e67c679d4029b7d0"),
    "reddit_k32_t16": ("reddit", 32, {"t": 16}, "13f232f653c9c752"),
    "tiny_k2": ("tiny", 2, {}, "a102badbeab32296"),
    "tiny_k3": ("tiny", 3, {}, "b4293f255e72d527"),
    "pl300_k24": ("pl300", 24, {"seed": 1, "pool_cap": 16},
                  "f821db1120c8d632"),
}


def _graph(name):
    if name == "pl600":
        return _pl600(synthetic)
    if name == "pl300":
        return _pl300(synthetic)
    if name == "reddit":
        return synthetic.reddit_like(scale=0.005, seed=0)
    return Hypergraph.from_edge_lists(6, [[0, 1], [1, 2, 3], []])


@pytest.mark.parametrize("case", sorted(_GOLDENS))
def test_device_golden(case):
    graph, k, knobs, want = _GOLDENS[case]
    a = partition(_graph(graph), k, "hype_device", device="cpu", **knobs)
    assert _digest(a) == want


def test_device_tiny_store_narrower_than_budget():
    """m = 3 plans a 4-row store below the 512-row take budget: the port
    takes the whole store, where the JAX program fails to trace
    (ROADMAP.md queue 3, a difference kept on purpose)."""
    hg = JaxHypergraph.from_edge_lists(6, [[0, 1], [1, 2, 3], []])
    with pytest.raises(ValueError, match="broadcast"):
        jax_dev.hype_device_partition(hg, 2, jax_dev.DeviceParams(seed=0))
    a, st = device.hype_device_partition(
        _graph("tiny"), 2, device.DeviceParams(seed=0), True, device="cpu")
    assert st.loop_rounds > 0 and _digest(a) == _GOLDENS["tiny_k2"][3]


@pytest.mark.parametrize("edges,k", [
    ([], 3), ([[0], [3]], 2), ([[0, 1]], 8), ([[0, 1], [1, 2, 3], []], 8)])
def test_edge_poor_graphs_equal_superstep_depth1(edges, k):
    """No edges, single-pin edges, more phases than vertices with
    neighbours: the device loop still lands on the depth-1 schedule."""
    hg = Hypergraph.from_edge_lists(10, edges)
    np.testing.assert_array_equal(
        partition(hg, k, "hype_device", device="cpu"),
        partition(hg, k, "hype_superstep", device="cpu", pipeline_depth=1))


# -------------------------------------------- round parity against JAX

class _Captured(Exception):
    pass


def _jax_first_call(jhg, k, params):
    """The config, consts and first carry of JAX ``hype_device``'s first
    device-loop call, as numpy (the run stops there)."""
    got = {}
    real = jax_dl.device_loop_program

    def spy(cfg):
        def first(consts, carry, chunk_cap, poison_at):
            got.update(cfg=cfg,
                       consts={k_: np.asarray(v) for k_, v in consts.items()},
                       carry={k_: np.array(v) for k_, v in carry.items()})
            raise _Captured
        real(cfg)       # JAX's program for this config, kept in its cache
        return first

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_dl, "device_loop_program", spy)
        with pytest.raises(_Captured):
            jax_dev.hype_device_partition(jhg, k, params)
    return got


_PARITY = {
    "pl600_k16_t8": ("pl600", 16, dict(seed=0, t=8)),
    "warm_pool": ("pl600", 16, dict(seed=0, t=4, pool_cap=64)),
    "float16": ("pl600", 16, dict(seed=0, t=8, cache_dtype="float16")),
    "restarts_pl300": ("pl300", 24, dict(seed=1, pool_cap=16)),
}


@pytest.fixture(scope="module", params=sorted(_PARITY))
def first_call(request):
    graph, k, knobs = _PARITY[request.param]
    jhg = _pl600(jax_synth) if graph == "pl600" else _pl300(jax_synth)
    return _jax_first_call(jhg, k, jax_dev.DeviceParams(
        fault_plan=resilience.FaultPlan(), **knobs))


def _jax_chunk(cfg, consts, carry, cap):
    run = jax_dl.device_loop_program(cfg)
    out = run({k: jnp.asarray(v) for k, v in consts.items()},
              {k: jnp.asarray(v) for k, v in carry.items()},
              jnp.int32(cap), jnp.int32(-1))
    return {k: np.array(v) for k, v in out.items()}


def _assert_carry_equal(got, want, when):
    assert set(got) == set(want)
    for name in want:
        g, w = got[name], np.asarray(want[name])
        assert g.dtype == w.dtype and g.shape == w.shape, (when, name)
        if g.dtype.kind == "f":     # the cache, bit for bit
            g = g.view(np.int16 if g.itemsize == 2 else np.int32)
            w = w.view(g.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{when}: {name}")


def test_round_parity_after_1_then_8(first_call):
    """One carry, JAX's program and the port's runner: a chunk of 1, then
    a chunk of 8 from there; every field equal, scratch sliced off."""
    cfg = device_loop.DeviceLoopConfig(**{
        f: getattr(first_call["cfg"], f)
        for f in device_loop.DeviceLoopConfig._fields})
    loop = device_loop.DeviceLoop(
        cfg, device_loop.consts_to_device(first_call["consts"], "cpu"),
        convert.device_carry_from_numpy(first_call["carry"], "cpu"))
    want = first_call["carry"]
    for cap in (1, 8):
        want = _jax_chunk(first_call["cfg"], first_call["consts"], want, cap)
        loop.run_chunk(cap)
        _assert_carry_equal(device_loop.carry_to_numpy(loop.carry), want,
                            f"chunk of {cap}")
    assert int(want["supersteps"]) > 1
    assert int(want["stats"][device_loop.S_KERNEL_ROWS]) > 0


def test_round_is_a_no_op_when_the_loop_condition_fails(first_call):
    """A round whose exit condition holds (here: the chunk's cap is 0)
    leaves every carry tensor as it was: the predication the card's
    replays rely on."""
    cfg = device_loop.DeviceLoopConfig(**{
        f: getattr(first_call["cfg"], f)
        for f in device_loop.DeviceLoopConfig._fields})
    carry = convert.device_carry_from_numpy(first_call["carry"], "cpu")
    before = {k: v.clone() for k, v in carry.items()}
    loop = device_loop.DeviceLoop(
        cfg, device_loop.consts_to_device(first_call["consts"], "cpu"),
        carry)
    loop.chunk_cap.fill_(0)
    loop._step()
    for name, v in carry.items():
        assert torch.equal(v, before[name]), name


def test_carry_round_trips_through_the_scratch_layout(first_call):
    carry = first_call["carry"]
    back = device_loop.carry_to_numpy(
        convert.device_carry_from_numpy(carry, "cpu"))
    _assert_carry_equal(back, carry, "round trip")
    assert (device_loop.carry_bytes(carry)
            == jax_dl.carry_bytes(carry))


# ------------------------------------------------ counters against JAX

@pytest.fixture(scope="module")
def runs_16_8():
    jhg = _pl600(jax_synth)
    ja, jst = jax_dev.hype_device_partition(
        jhg, 16, jax_dev.DeviceParams(seed=0, t=8,
                                      fault_plan=resilience.FaultPlan()),
        return_stats=True)
    a, st = device.hype_device_partition(
        _pl600(synthetic), 16, device.DeviceParams(seed=0, t=8), True,
        device="cpu")
    return (ja, jst), (a, st)


@pytest.mark.parametrize("counter", [
    "supersteps", "loop_rounds", "loop_pack_only", "loop_store_peak",
    "refill_signals", "kernel_rows", "cache_hits", "random_restarts",
    "edges_scanned", "cache_invalidations", "kernel_calls", "loop_chunks",
    "loop_state_bytes", "stale_redraws"])
def test_counters_equal_jax(runs_16_8, counter):
    (ja, jst), (a, st) = runs_16_8
    np.testing.assert_array_equal(a, ja)
    assert getattr(st, counter) == getattr(jst, counter)
    assert st.kernel_calls == st.supersteps > 0
    assert st.graph_replays == 0 and st.device_s > 0.0


def test_warm_pool_cache_hits_equal_jax():
    """A small t with a deep pool serves held candidates from the cache;
    the port counts the same hits as JAX and the host engine."""
    kw = dict(seed=0, t=4, pool_cap=64)
    ja, jst = jax_dev.hype_device_partition(
        _pl600(jax_synth), 16, jax_dev.DeviceParams(
            fault_plan=resilience.FaultPlan(), **kw), return_stats=True)
    a, st = device.hype_device_partition(
        _pl600(synthetic), 16, device.DeviceParams(**kw), True,
        device="cpu")
    np.testing.assert_array_equal(a, ja)
    assert st.cache_hits == jst.cache_hits > 0


def test_float16_cache_same_assignment(runs_16_8):
    _, (a32, st32) = runs_16_8
    a16, st16 = device.hype_device_partition(
        _pl600(synthetic), 16,
        device.DeviceParams(seed=0, t=8, cache_dtype="float16"), True,
        device="cpu")
    np.testing.assert_array_equal(a16, a32)
    assert st16.loop_state_bytes < st32.loop_state_bytes


# ------------------------------------------------------- restart draw

@pytest.mark.parametrize("seed,assigned,ptr,cnt", [
    (0, 0.3, 0, 16),        # mid-stream
    (1, 0.5, 1500, 7),
    (2, 0.9, 2500, 16),     # the stream runs out: stragglers by id
    (3, 0.97, 0, 16),       # fewer available than asked
    (4, 1.0, 100, 5),       # nothing available
    (5, 0.2, 3000, 9),      # the pointer at n: stragglers only
    (6, 0.4, 700, 0),       # nothing asked
    (7, 0.0, 2999, 3),      # the last position, then stragglers
])
def test_restart_draw_equals_random_unassigned(seed, assigned, ptr, cnt):
    n, t = 3000, 16
    hg = synthetic.powerlaw_hypergraph(n, 200, seed=seed)
    rt = EngineRuntime(hg, 4, device.DeviceParams(seed=seed))
    rng = np.random.default_rng(seed)
    done = rng.random(n) < assigned
    rt.assignment[done] = 0
    rt.in_pool[~done & (rng.random(n) < 0.2)] = True
    rt.rand_ptr = ptr
    avail = torch.from_numpy(np.append((rt.assignment < 0) & ~rt.in_pool,
                                       False).astype(np.int64))
    before = avail.clone()
    vs, got, new_ptr = device_loop.rand_draw(
        avail, device_loop.draw_stream(torch.from_numpy(rt.rand_order)),
        torch.tensor(ptr), torch.tensor(cnt), t)
    want = rt.random_unassigned(cnt)
    assert int(got) == want.size
    np.testing.assert_array_equal(vs.numpy()[:want.size], want)
    assert (vs.numpy()[want.size:] == n).all()          # n: no draw
    assert int(new_ptr) == rt.rand_ptr
    before[torch.from_numpy(want)] = 0          # drawn: now unavailable
    assert torch.equal(avail, before)


# ---------------------------------------------------- capacity reruns

@pytest.mark.parametrize("flag,knobs,caps", [
    ("FLAG_STORE", {"store_cap": 32}, None),
    ("FLAG_ACT", {"act_cap": 8}, None),
    ("FLAG_RAWT", {}, {"rawt": 128}),
    ("FLAG_RAWD", {}, {"rawd": 256}),
])
def test_overflow_reruns_land_on_the_golden(monkeypatch, flag, knobs, caps):
    attempts = []
    real = device._device_attempt

    def spy(*args):
        out = real(*args)
        attempts.append(out[:2] if out[0] == "overflow" else out[:1])
        return out

    monkeypatch.setattr(device, "_device_attempt", spy)
    a, st = device._run_device_loop(
        _pl600(synthetic), 16, device.DeviceParams(seed=0, t=8, rows=8,
                                                   **knobs),
        "cpu", caps)
    bit = getattr(device_loop, flag)
    assert attempts[0][0] == "overflow" and attempts[0][1] & bit
    assert attempts[-1] == ("ok",) and len(attempts) <= 5
    assert _digest(a) == _GOLDENS["pl600_k16_t8"][3]
    assert st.stats.loop_rounds > 0


def test_exhausted_rerun_ladder_falls_back_to_superstep(monkeypatch):
    """rawt = 16 still overflows after four doublings: the ladder gives up
    and hype_device hands the run, knobs as given (pipeline_depth 2 by
    default), to hype_superstep, as JAX does."""
    real = device._run_device_loop
    ladders = []

    def small_rawt(hg, k, p, dev, caps=None):
        ladders.append(real(hg, k, p, dev, {"rawt": 16}))
        return ladders[-1]

    monkeypatch.setattr(device, "_run_device_loop", small_rawt)
    a, st = device.hype_device_partition(
        _pl600(synthetic), 16, device.DeviceParams(seed=0, t=8), True,
        device="cpu")
    assert ladders == [(None, None)]
    assert st.loop_rounds == 0 and st.supersteps > 0
    np.testing.assert_array_equal(a, partition(
        _pl600(synthetic), 16, "hype_superstep", device="cpu", t=8))


# ------------------------------------------------ errors and edge cases

@pytest.mark.parametrize("knobs,item", [
    ({"mem_budget": "24KB"}, "memory rungs"),
], ids=lambda v: ",".join(v) if isinstance(v, dict) else v)
def test_unported_knobs_raise_naming_their_item(knobs, item):
    """Once unported (``item`` names the feature), now served: a budget
    below rung 0 hands the run to hype_superstep's memory rungs, as in
    JAX, and the stats say which rung ran."""
    a, st = device.hype_device_partition(
        _pl600(synthetic), 4, device.DeviceParams(seed=0, **knobs), True,
        device="cpu")
    ja, jst = jax_dev.hype_device_partition(
        _pl600(jax_synth), 4, jax_dev.DeviceParams(seed=0, **knobs), True)
    assert _digest(a) == _digest(ja)
    assert (st.plan_rung, st.mem_retries, st.fallbacks, st.loop_rounds) \
        == (jst.plan_rung, jst.mem_retries, jst.fallbacks, 0) == (
            5, 0, 0, 0)


@pytest.mark.parametrize("knobs,match", [
    ({"chunk_supersteps": 0}, "chunk_supersteps"),
    ({"cache_dtype": "bf16"}, "cache_dtype"),
    ({"snapshot_every": 2}, "snapshot_dir"),
    ({"t": 0}, "rows, pool_cap, t"),
])
def test_param_validation(knobs, match):
    with pytest.raises(ValueError, match=match):
        device.hype_device_partition(
            _pl600(synthetic), 4, device.DeviceParams(**knobs),
            device="cpu")


def test_k1_shortcut():
    a = partition(_pl600(synthetic), 1, "hype_device", device="cpu")
    assert (a == 0).all() and a.dtype == np.int32


def test_int32_gate_falls_back_to_superstep_as_jax_does():
    """rows=2048 puts bud * 2^18 at 2^31: the gate rejects the graph and
    both packages run hype_superstep with the same knobs."""
    assert not device_loop.supported(n=10, m=100, kG=4, bud=1 << 13)
    kw = dict(seed=0, t=8, rows=2048)
    want = jax_dev.hype_device_partition(_pl600(jax_synth), 3,
                                         jax_dev.DeviceParams(**kw))
    a, st = device.hype_device_partition(
        _pl600(synthetic), 3, device.DeviceParams(**kw), True,
        device="cpu")
    np.testing.assert_array_equal(a, want)
    np.testing.assert_array_equal(a, partition(
        _pl600(synthetic), 3, "hype_superstep", device="cpu", **kw))
    assert st.loop_rounds == 0


def test_no_adjacency_falls_back_to_superstep(monkeypatch):
    """The hub-expansion guard trips (no device CSR image): the attempt
    reports a fallback and hype_device hands the call, knobs as given, to
    hype_superstep on the same device, as JAX does."""
    hg = Hypergraph.from_pins(9000, 1, np.arange(9000), np.zeros(9000))
    p = device.DeviceParams(seed=0, t=8, rows=8)
    assert device._device_attempt(hg, 4, p, {}, "cpu") == (
        "fallback", "no device adjacency", None)
    calls = []
    monkeypatch.setattr(device, "hype_superstep_partition",
                        lambda *a, **kw: calls.append((a, kw)) or "ran")
    assert device.hype_device_partition(hg, 4, p, device="cpu") == "ran"
    assert calls == [((hg, 4, p, False), {"device": "cpu"})]


def test_non_finite_score_raises(monkeypatch):
    """A real row scored NaN sets FLAG_POISON; the driver raises, and
    with no injected fault it is not a fault the ladder takes."""
    real = device_loop.hype_score_select

    def poisoned(nbrs, fringe, bias, prev, *, select_k):
        scores, idx, val, rem = real(nbrs, fringe, bias, prev,
                                     select_k=select_k)
        return torch.full_like(scores, float("nan")), idx, val, rem

    monkeypatch.setattr(device_loop, "hype_score_select", poisoned)
    with pytest.raises(RuntimeError, match="non-finite") as err:
        partition(_pl600(synthetic), 16, "hype_device", device="cpu", t=8)
    assert not isinstance(err.value, port_resilience.UnrecoverableFault)


def test_device_params_mirror_jax_fields_and_defaults():
    jf = {f.name: f.default for f in
          dataclasses.fields(jax_dev.DeviceParams)}
    pf = {f.name: f.default for f in dataclasses.fields(device.DeviceParams)}
    assert pf == jf
    jp = jax_dev.DeviceParams(t=16, seed=3, chunk_supersteps=7,
                              cache_dtype="float16", store_cap=64)
    assert (convert.device_params_from_dict(dataclasses.asdict(jp))
            == device.DeviceParams(t=16, seed=3, chunk_supersteps=7,
                                   cache_dtype="float16", store_cap=64))


def test_quality_preset_equals_superstep_quality_in_both_packages():
    """The quality preset of hype_device (refine_passes=4 after the
    depth-1 schedule) equals hype_superstep's quality preset (which pins
    depth 1) in JAX, and the port's equals both: the premise of the card's
    quality check on github_like(1.0)."""
    from repro.core import partition_api as jax_api
    jd = jax_api.partition(_pl600(jax_synth), 16, "hype_device",
                           preset="quality")
    js = jax_api.partition(_pl600(jax_synth), 16, "hype_superstep",
                           preset="quality")
    np.testing.assert_array_equal(jd, js)
    a = partition(_pl600(synthetic), 16, "hype_device", device="cpu",
                  preset="quality")
    np.testing.assert_array_equal(a, jd)
    assert _digest(a) == "8356b306cfe516d5"
    assert metrics.k_minus_1(_pl600(synthetic), a, 16) > 0
