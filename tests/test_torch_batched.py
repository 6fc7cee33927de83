"""The port's hype_batched engine, the refinement post-pass on both
engines, the presets and the hub-guard fallback, against the JAX package
on the CPU.

Each case runs the JAX package (its ``hype_scores`` and ``kway_gains``
kernels in Pallas interpret mode) and the port (their plain versions) on
the same seeded graph and compares assignments by digest, bit for bit,
and the engines' counters exactly.
"""
import dataclasses
import hashlib

import numpy as np
import pytest

from repro.core import metrics as jax_metrics
from repro.core import partition_api as jax_api
from repro.core.hype import HypeParams, hype_partition
from repro.core.hypergraph import Hypergraph as JaxHypergraph
from repro.data import synthetic as jax_synth
from repro.engines import batched as jax_batched
from repro.engines import superstep as jax_ss
from repro_torch import convert
from repro_torch.core import metrics
from repro_torch.core.hypergraph import Hypergraph
from repro_torch.data import synthetic
from repro_torch.engines import batched, superstep
from repro_torch.core.partition_api import partition

# the counters both engines keep, compared exactly
_COUNTERS = ("kernel_calls", "kernel_rows", "host_rows", "cache_hits",
             "edges_scanned", "random_restarts", "steps")


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(a, dtype=np.int32).tobytes()).hexdigest()[:16]


def _pl600(synth):
    return synth.powerlaw_hypergraph(600, 400, seed=11, max_edge=30,
                                     max_degree=20)


def _counters(st) -> dict:
    return {name: getattr(st, name) for name in _COUNTERS}


@pytest.mark.parametrize("t", (1, 8, 16))
@pytest.mark.parametrize("k", (2, 5, 16))
def test_batched_matches_jax(k, t):
    want, jst = jax_batched.hype_batched_partition(
        _pl600(jax_synth), k, jax_batched.BatchedParams(seed=0, t=t),
        return_stats=True)
    got, st = batched.hype_batched_partition(
        _pl600(synthetic), k, batched.BatchedParams(seed=0, t=t),
        return_stats=True, device="cpu")
    assert _digest(got) == _digest(want)
    assert _counters(st) == _counters(jst)
    # the kernel path runs in all but the smallest case
    assert st.kernel_calls > 0 or (k, t) == (2, 1)
    sizes = metrics.partition_sizes(got, k)
    assert sizes.max() - sizes.min() <= 1


def test_batched_without_adjacency_matches_jax(monkeypatch):
    """The ``adj is None`` path (``neighbor_tile`` with ``cap_pins``),
    forced on both packages."""
    monkeypatch.setattr(JaxHypergraph, "vertex_adjacency",
                        lambda self, *a, **kw: None)
    monkeypatch.setattr(Hypergraph, "vertex_adjacency",
                        lambda self, *a, **kw: None)
    p = dict(seed=1, t=8, cap_pins=64)
    want, jst = jax_batched.hype_batched_partition(
        _pl600(jax_synth), 5, jax_batched.BatchedParams(**p),
        return_stats=True)
    got, st = batched.hype_batched_partition(
        _pl600(synthetic), 5, batched.BatchedParams(**p),
        return_stats=True, device="cpu")
    assert _digest(got) == _digest(want)
    assert _counters(st) == _counters(jst)
    assert st.kernel_calls > 0


def test_batched_t1_agrees_with_sequential_hype():
    """t=1 recovers sequential admission (the JAX suite's check against
    the paper engine): complete, balanced, and within its quality band."""
    for seed in (0, 1):
        hg = synthetic.powerlaw_hypergraph(400, 260, seed=seed,
                                           max_edge=20, max_degree=14)
        jhg = jax_synth.powerlaw_hypergraph(400, 260, seed=seed,
                                            max_edge=20, max_degree=14)
        a_b = partition(hg, 5, "hype_batched", device="cpu", seed=seed,
                        t=1)
        a_n = hype_partition(jhg, 5, HypeParams(seed=seed))
        sizes = metrics.partition_sizes(a_b, 5)
        assert (a_b >= 0).all() and sizes.max() - sizes.min() <= 1
        assert (metrics.k_minus_1(hg, a_b)
                <= 1.35 * jax_metrics.k_minus_1(jhg, a_n) + 20)


def test_hub_guard_fallback_matches_jax():
    """Where the hub-expansion guard trips, hype_superstep falls back to
    hype_batched, and its refinement is skipped, in both packages."""
    pins = (np.arange(9000), np.zeros(9000))
    p = dict(seed=0, t=8, refine_passes=2)
    want = jax_ss.hype_superstep_partition(
        JaxHypergraph.from_pins(9000, 1, *pins), 4,
        jax_ss.SuperstepParams(**p))
    hg = Hypergraph.from_pins(9000, 1, *pins)
    got, st = superstep.hype_superstep_partition(
        hg, 4, superstep.SuperstepParams(**p), return_stats=True,
        device="cpu")
    assert hg.vertex_adjacency() is None
    assert _digest(got) == _digest(want)
    assert st.supersteps == 0 and st.steps > 0
    assert st.refine.boundary_rows == 0 and st.refine.moves == 0


# --------------------------------------------- the refinement post-pass

@pytest.mark.parametrize("method", ("hype_batched", "hype_superstep"))
def test_refine_passes_match_jax(method):
    g, jg = _pl600(synthetic), _pl600(jax_synth)
    kw = dict(seed=0, t=8, refine_passes=3)
    if method == "hype_superstep":
        kw["pipeline_depth"] = 1
        want, jst = jax_ss.hype_superstep_partition(
            jg, 16, jax_ss.SuperstepParams(**kw), return_stats=True)
        got, st = superstep.hype_superstep_partition(
            g, 16, superstep.SuperstepParams(**kw), return_stats=True,
            device="cpu")
    else:
        want, jst = jax_batched.hype_batched_partition(
            jg, 16, jax_batched.BatchedParams(**kw), return_stats=True)
        got, st = batched.hype_batched_partition(
            g, 16, batched.BatchedParams(**kw), return_stats=True,
            device="cpu")
    assert _digest(got) == _digest(want)
    assert dataclasses.asdict(st.refine) == dataclasses.asdict(jst.refine)
    assert st.refine.kernel_calls > 0 and st.refine.moves > 0
    sizes = metrics.partition_sizes(got, 16)
    assert sizes.max() - sizes.min() <= 1


def test_refine_passes_zero_keeps_the_golden():
    """tests/test_refine.py:273: refine_passes=0 is a strict no-op."""
    a = partition(_pl600(synthetic), 16, "hype_superstep", device="cpu",
                  t=8, pipeline_depth=1, refine_passes=0)
    assert _digest(a) == "bbcd2f732e03af91"


@pytest.mark.parametrize("preset", ("fast", "balanced", "quality"))
@pytest.mark.parametrize("method", ("hype_batched", "hype_superstep"))
def test_presets_match_jax(method, preset):
    want = jax_api.partition(_pl600(jax_synth), 8, method, seed=0,
                             preset=preset)
    got = partition(_pl600(synthetic), 8, method, device="cpu", seed=0,
                    preset=preset)
    assert _digest(got) == _digest(want)


@pytest.mark.parametrize("method", ("hype_batched", "hype_superstep"))
def test_quality_preset_is_explicit_knobs_and_knobs_win(method):
    hg = _pl600(synthetic)
    bundle = jax_api.method_presets(method)["quality"]
    quality = partition(hg, 8, method, device="cpu", preset="quality")
    explicit = partition(hg, 8, method, device="cpu", **bundle)
    assert _digest(quality) == _digest(explicit)
    over = partition(hg, 8, method, device="cpu", preset="quality",
                     refine_passes=0)
    want = jax_api.partition(_pl600(jax_synth), 8, method,
                             preset="quality", refine_passes=0)
    assert _digest(over) == _digest(want)


@pytest.mark.parametrize("method,preset,match", [
    ("hype_batched", "turbo", "unknown preset"),
    ("hype_multilevel", "quality", "does not support presets"),
    ("multilevel", "fast", "does not support presets"),
])
def test_bad_presets_raise_as_in_jax(method, preset, match):
    for run in (lambda: partition(_pl600(synthetic), 4, method,
                                  device="cpu", preset=preset),
                lambda: jax_api.partition(_pl600(jax_synth), 4, method,
                                          preset=preset)):
        with pytest.raises(ValueError, match=match):
            run()


# ----------------------------------------- knobs, params and converters

def test_batched_params_mirror_jax_fields_and_defaults():
    jf = {f.name: f.default for f in
          dataclasses.fields(jax_batched.BatchedParams)}
    pf = {f.name: f.default for f in dataclasses.fields(
        batched.BatchedParams)}
    assert pf == jf


def test_convert_batched_params():
    jp = jax_batched.BatchedParams(t=4, s=10, seed=2, refine_passes=1)
    p = convert.batched_params_from_dict(dataclasses.asdict(jp))
    assert p == batched.BatchedParams(t=4, s=10, seed=2, refine_passes=1)
    with pytest.raises(ValueError, match="unknown BatchedParams"):
        convert.batched_params_from_dict({"t": 4, "rows": 8})
