"""The port's method registry, host baselines and reports against the JAX
package, on the CPU.

``METHOD_INFO``'s keys (its descriptions are the port's own),
``method_knobs``, ``method_presets``, ``balance_slack`` and
``PARTITION_KNOBS`` against ``repro.core.partition_api``'s; the five host baselines (MinMax nb and
eb, SHP, random, hashing) assignment for assignment on pl600 and on
``community_hypergraph`` for several k and seeds; the generator's CSR;
``all_metrics`` and the ``spans=`` argument; ``partition_and_report`` for
every ported method.
"""
import hashlib
import inspect

import numpy as np
import pytest

from repro.core import metrics as jax_metrics
from repro.core import partition_api as jax_api
from repro.data import synthetic as jax_synth
from repro_torch import partition_api as api
from repro_torch.core import metrics
from repro_torch.data import synthetic

_HOST = ("minmax_nb", "minmax_eb", "shp", "random", "hashing")


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(a, dtype=np.int32).tobytes()).hexdigest()[:16]


def _graph(synth, name, seed=0):
    if name == "pl600":
        return synth.powerlaw_hypergraph(600, 400, seed=11, max_edge=30,
                                         max_degree=20)
    return synth.community_hypergraph(800, 500, 8, seed=seed)


@pytest.fixture(autouse=True)
def _no_env_plan(monkeypatch):
    monkeypatch.delenv("REPRO_FAULT_PLAN", raising=False)


# ---------------------------------------------------------------- registry

def test_registry_keys_equal_jax():
    """The same methods in the same order; each description is the
    port's own, and a pending method's says so."""
    assert tuple(api.METHOD_INFO) == jax_api.METHODS
    desc = api.describe_methods()
    assert tuple(desc) == tuple(jax_api.describe_methods())
    assert all(isinstance(d, str) and d for d in desc.values())
    assert {m for m, d in desc.items()
            if d.startswith("not ported yet")} == set(api.PENDING)
    assert not any("lax." in d or "Pallas" in d for d in desc.values())
    assert set(api.METHODS) | set(api.PENDING) == set(jax_api.METHODS)
    assert set(api.PENDING) == {"hype_jax", "hype_parallel"}
    assert len(api.METHODS) == 14


@pytest.mark.parametrize("method", api.METHODS)
def test_method_knobs_equal_jax(method):
    assert api.method_knobs(method) == jax_api.method_knobs(method)


@pytest.mark.parametrize("method,item", sorted(api.PENDING.items()))
def test_pending_method_knobs_name_their_item(method, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md.*{item}"):
        api.method_knobs(method)


@pytest.mark.parametrize("method", jax_api.METHODS)
def test_method_presets_equal_jax(method):
    assert api.method_presets(method) == jax_api.method_presets(method)


@pytest.mark.parametrize("method", jax_api.METHODS)
def test_balance_slack_equal_jax(method):
    for n in (1, 17, 600, 177_386, 10**7):
        for k in (1, 2, 7, 32, 1000):
            assert (api.balance_slack(method, n, k)
                    == jax_api.balance_slack(method, n, k)), (n, k)


def test_partition_knobs_equal_jax():
    assert api.PARTITION_KNOBS == jax_api.PARTITION_KNOBS
    for name, default in api.PARTITION_KNOBS.items():
        for fn in (api.partition, api.partition_resilient):
            assert inspect.signature(fn).parameters[name].default == default


def test_knobs_reach_their_engine():
    """Every registered knob is a keyword the port's callable takes."""
    for method in api.METHODS:
        knobs = api.method_knobs(method)
        if method in ("minmax_nb", "shp"):
            from repro_torch.core import minmax, shp
            fn = {"minmax_nb": minmax.minmax_partition,
                  "shp": shp.shp_partition}[method]
            assert set(knobs) <= set(inspect.signature(fn).parameters)
        elif method == "hype_multilevel":
            from repro_torch.core import multilevel
            params = inspect.signature(
                multilevel.hype_multilevel_partition).parameters
            assert set(knobs) <= set(params)


# ------------------------------------------------------- host baselines

def test_community_hypergraph_equals_jax():
    for seed in (0, 1, 5):
        got = _graph(synthetic, "community", seed)
        want = _graph(jax_synth, "community", seed)
        for name in ("v2e_indptr", "v2e_indices", "e2v_indptr",
                     "e2v_indices"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))
        assert got.fingerprint() == want.fingerprint()


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("k", [2, 7, 16])
@pytest.mark.parametrize("graph", ["pl600", "community"])
@pytest.mark.parametrize("method", _HOST)
def test_host_method_equals_jax(method, graph, k, seed):
    hg, jhg = _graph(synthetic, graph, seed), _graph(jax_synth, graph, seed)
    a = api.partition(hg, k, method, device="cpu", seed=seed)
    want = jax_api.partition(jhg, k, method, seed=seed)
    assert a.dtype == np.int32
    np.testing.assert_array_equal(a, want)
    sizes = np.bincount(a, minlength=k)
    assert sizes.max() - sizes.min() <= api.balance_slack(method, hg.n, k)


@pytest.mark.parametrize("method,knobs", [
    ("minmax_nb", {"slack": 3}), ("shp", {"iters": 2, "swap_frac": 0.5})])
def test_host_method_knobs_equal_jax(method, knobs):
    a = api.partition(_graph(synthetic, "pl600"), 8, method, device="cpu",
                      seed=1, **knobs)
    want = jax_api.partition(_graph(jax_synth, "pl600"), 8, method, seed=1,
                             **knobs)
    np.testing.assert_array_equal(a, want)


def test_minmax_rejects_unknown_mode():
    from repro_torch.core.minmax import minmax_partition
    with pytest.raises(ValueError, match="mode"):
        minmax_partition(_graph(synthetic, "pl600"), 4, mode="xx")


# ----------------------------------------------------------------- metrics

@pytest.mark.parametrize("k", [1, 5, 16])
def test_all_metrics_equal_jax(k):
    hg, jhg = _graph(synthetic, "pl600"), _graph(jax_synth, "pl600")
    rng = np.random.default_rng(k)
    a = rng.integers(0, k, size=hg.n).astype(np.int32)
    assert metrics.all_metrics(hg, a, k) == jax_metrics.all_metrics(
        jhg, a, k)
    spans = metrics.spans_per_edge(hg, a, k)
    for name in ("k_minus_1", "hyperedge_cut", "sum_external_degree",
                 "replication_factor"):
        fn, jfn = getattr(metrics, name), getattr(jax_metrics, name)
        assert fn(hg, a, k, spans=spans) == fn(hg, a, k) == jfn(jhg, a, k)


def test_metrics_of_empty_edges():
    from repro_torch.core.hypergraph import Hypergraph
    hg = Hypergraph.from_edge_lists(4, [[], [0, 1], [2]])
    a = np.array([0, 1, 1, 0], dtype=np.int32)
    rep = metrics.all_metrics(hg, a, 2)
    assert rep["k_minus_1"] == 1 and rep["hyperedge_cut"] == 1
    assert rep["soed"] == 2 and rep["replication_factor"] == 1.5


# ------------------------------------------------------------ the report

# JAX's mesh defaults to every local device, the port's to the process
# group's world size: one device on both sides
_REPORT_KNOBS = {"hype_batched": {"t": 8}, "hype_superstep": {"t": 8},
                 "hype_device": {"t": 8},
                 "hype_sharded": {"t": 8, "devices": 1}}


@pytest.mark.parametrize("method", api.METHODS)
def test_partition_and_report_equals_jax(method):
    kw = _REPORT_KNOBS.get(method, {})
    rep, a = api.partition_and_report(_graph(synthetic, "pl600"), 8, method,
                                      device="cpu", seed=0, **kw)
    jrep, ja = jax_api.partition_and_report(_graph(jax_synth, "pl600"), 8,
                                            method, seed=0, **kw)
    np.testing.assert_array_equal(a, ja)
    assert set(rep) == set(jrep)
    rep.pop("runtime_s")
    jrep.pop("runtime_s")
    assert rep == jrep


def test_partition_and_report_keeps_the_entry_checks():
    """A pending method still raises and a bad preset still fails; the
    sharded engine, served now, reports as JAX's does at one device."""
    hg = _graph(synthetic, "pl600")
    with pytest.raises(NotImplementedError, match="hype_jax"):
        api.partition_and_report(hg, 4, "hype_jax", device="cpu")
    rep, a = api.partition_and_report(hg, 16, "hype_sharded", device="cpu",
                                      seed=0, devices=1)
    jrep, ja = jax_api.partition_and_report(_graph(jax_synth, "pl600"), 16,
                                            "hype_sharded", seed=0,
                                            devices=1)
    np.testing.assert_array_equal(a, ja)
    assert _digest(a) == "6d0521661383d51f"     # the depth-2 run of pl600
    rep.pop("runtime_s")
    jrep.pop("runtime_s")
    assert rep == jrep
    with pytest.raises(ValueError, match="presets"):
        api.partition_and_report(hg, 4, "shp", device="cpu",
                                 preset="quality")
