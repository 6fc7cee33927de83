"""The port's padded-array engines (``repro_torch.core.hype_jax``)
against the JAX package's ``repro.core.hype_jax``, on the CPU.

The padded views; ``batched_dext_torch`` against ``batched_dext_jax``;
the state after each ``_seq_grow`` + ``_release_fringe``; ``hype_jax``
and ``hype_parallel`` through ``partition`` at k in {2, 5, 8}, seeds 0
and 9 and non-default ``s``/``r``/``candidates``, all bit for bit; the
pl300 digests ``chip_smoke.py`` pins; the 6-vertex edge graph; the
collision priority past the cores' exact float32 range; the errors
JAX raises. JAX's results are kept per module, so each configuration
compiles once.
"""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hype_jax as jhj
from repro.core import partition_api as jax_api
from repro.core.hypergraph import Hypergraph as JaxHypergraph
from repro.core.scoring import batched_dext_jax
from repro.data import synthetic as jax_synth
from repro_torch.core import partition_api as api
from repro_torch.core import hype_jax as hj
from repro_torch.core import threefry
from repro_torch.core.hypergraph import Hypergraph
from repro_torch.core.scoring import batched_dext_torch
from repro_torch.data import synthetic

EDGES = [[0, 1], [1, 2, 3], []]        # vertices 4 and 5 have no edge
PL300_DIGESTS = {"hype_jax": "3e750d64db36cd14",
                 "hype_parallel": "ca54abcebd06a7d4"}


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(a, dtype=np.int32).tobytes()).hexdigest()[:16]


def _pl(synth, name="pl300"):
    """pl300 is the engines' validation graph; pl2400's cores pass the
    exact float32 range of the collision priority at k = 2."""
    n, m = {"pl300": (300, 200), "pl2400": (2400, 1600)}[name]
    return synth.powerlaw_hypergraph(n, m, seed=3, max_edge=20,
                                     max_degree=12)


_JAX = {}


def _jax_run(graph, k, method, seed=0, **knobs):
    """JAX's assignment, computed once per module."""
    key = (graph, k, method, seed, tuple(sorted(knobs.items())))
    if key not in _JAX:
        jhg = (JaxHypergraph.from_edge_lists(6, EDGES) if graph == "edges"
               else _pl(jax_synth, graph))
        _JAX[key] = jax_api.partition(jhg, k, method, seed=seed, **knobs)
    return _JAX[key]


def _port_run(graph, k, method, seed=0, **knobs):
    hg = (Hypergraph.from_edge_lists(6, EDGES) if graph == "edges"
          else _pl(synthetic, graph))
    a = api.partition(hg, k, method, device="cpu", seed=seed, **knobs)
    assert a.dtype == np.int32 and a.shape == (hg.n,)
    return a


# ----------------------------------------------------------- the pieces

@pytest.mark.parametrize("graph", ["pl300", "edges"])
def test_padded_views_equal_jax(graph):
    if graph == "edges":
        hg = Hypergraph.from_edge_lists(6, EDGES)
        jhg = JaxHypergraph.from_edge_lists(6, EDGES)
    else:
        hg, jhg = _pl(synthetic), _pl(jax_synth)
    ph = hj.PaddedHypergraph.from_hypergraph(hg, "cpu")
    jph = jhj.PaddedHypergraph.from_hypergraph(jhg)
    assert (ph.n, ph.m) == (jph.n, jph.m) == (hg.n, hg.m)
    for name in ("v2e", "e2v", "edge_sizes"):
        got = getattr(ph, name)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jph, name)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batched_dext_equals_jax(seed):
    hg = _pl(synthetic)
    ph = hj.PaddedHypergraph.from_hypergraph(hg, "cpu")
    rng = np.random.default_rng(seed)
    vs = rng.integers(-1, hg.n, size=64).astype(np.int32)
    ext = rng.random(hg.n) < 0.6
    got = batched_dext_torch(ph.v2e, ph.e2v, torch.from_numpy(vs),
                             torch.from_numpy(ext))
    want = batched_dext_jax(jnp.asarray(ph.v2e.numpy()),
                            jnp.asarray(ph.e2v.numpy()), jnp.asarray(vs),
                            jnp.asarray(ext))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    empty = batched_dext_torch(ph.v2e, ph.e2v,
                               torch.zeros(0, dtype=torch.int32),
                               torch.from_numpy(ext))
    assert empty.shape == (0,)


def test_seq_grow_state_equals_jax():
    """The whole state after each phase's growth and after its fringe
    release equals JAX's; the release leaves in_fringe all-False."""
    hg = synthetic.powerlaw_hypergraph(200, 140, seed=7, max_edge=14,
                                       max_degree=10)
    jhg = jax_synth.powerlaw_hypergraph(200, 140, seed=7, max_edge=14,
                                        max_degree=10)
    ph = hj.PaddedHypergraph.from_hypergraph(hg, "cpu")
    jph = jhj.PaddedHypergraph.from_hypergraph(jhg)
    n, m, s, r = ph.n, ph.m, 10, 2
    state = hj._fresh_seq_state(ph, s, 0)
    jstate = jhj._SeqState(
        assignment=jnp.full((n,), -1, jnp.int32),
        in_fringe=jnp.zeros((n,), bool),
        fringe=jnp.full((s,), -1, jnp.int32),
        cache=jnp.full((n,), -1.0, jnp.float32),
        edge_active=jnp.zeros((m,), bool),
        core_size=jnp.int32(0),
        rand_key=jax.random.PRNGKey(0))
    grow = jax.jit(jhj._seq_grow, static_argnames=("part", "s", "r"))

    def same(st, jst):
        np.testing.assert_array_equal(st.assignment.numpy(),
                                      np.asarray(jst.assignment))
        np.testing.assert_array_equal(st.in_fringe.numpy(),
                                      np.asarray(jst.in_fringe))
        np.testing.assert_array_equal(st.fringe.numpy(),
                                      np.asarray(jst.fringe))
        np.testing.assert_array_equal(st.cache[:n].numpy(),
                                      np.asarray(jst.cache))
        np.testing.assert_array_equal(st.edge_active[:m].numpy(),
                                      np.asarray(jst.edge_active))
        assert st.core_size == int(jst.core_size)
        assert st.rand_key == tuple(np.asarray(jst.rand_key).tolist())

    stats = hj.GrowthStats()
    for part in range(3):
        state = hj._seq_grow(ph, state, part, n // 4, s, r, stats)
        jstate = grow(jph, jstate, part=part, target=jnp.int32(n // 4),
                      s=s, r=r)
        same(state, jstate)
        state = hj._release_fringe(state, n, s)
        jstate = jhj._release_fringe(jstate, n, s)
        same(state, jstate)
        assert not state.in_fringe.any()
        assert (state.fringe == -1).all()
    # each iteration admits one vertex; the seeds are not iterations
    assert stats.iterations == 3 * (n // 4 - 1)


def test_member_mask_routes_pads_to_scratch():
    ids = torch.tensor([-1, 0, 3, -1, 3], dtype=torch.int32)
    assert hj._member_mask(5, ids).tolist() == [True, False, False, True,
                                                False]


# ----------------------------------------------------------- the engines

@pytest.mark.parametrize("seed", [0, 9])
@pytest.mark.parametrize("k", [2, 5, 8])
@pytest.mark.parametrize("method", ["hype_jax", "hype_parallel"])
def test_engine_equals_jax(method, k, seed):
    a = _port_run("pl300", k, method, seed)
    np.testing.assert_array_equal(a, _jax_run("pl300", k, method, seed))
    sizes = np.bincount(a, minlength=k)
    assert sizes.max() - sizes.min() <= api.balance_slack(method, 300, k)


@pytest.mark.parametrize("method,knobs", [
    ("hype_jax", {"s": 3, "r": 1}), ("hype_jax", {"s": 16, "r": 4}),
    ("hype_parallel", {"candidates": 1}),
    ("hype_parallel", {"candidates": 8})], ids=str)
def test_engine_knobs_equal_jax(method, knobs):
    np.testing.assert_array_equal(
        _port_run("pl300", 6, method, 1, **knobs),
        _jax_run("pl300", 6, method, 1, **knobs))


@pytest.mark.parametrize("method", ["hype_jax", "hype_parallel"])
def test_pl300_digest(method):
    """The digests chip_smoke.py pins for pl300 at k = 8."""
    a = _port_run("pl300", 8, method)
    assert _digest(a) == _digest(_jax_run("pl300", 8, method))
    assert _digest(a) == PL300_DIGESTS[method]


@pytest.mark.parametrize("k", [1, 3, 6])
def test_edge_graph_equals_jax(k):
    """Singletons and an empty edge; at k = 6 every part gets one vertex.
    hype_parallel needs candidates <= m = 3."""
    a = _port_run("edges", k, "hype_jax")
    np.testing.assert_array_equal(a, _jax_run("edges", k, "hype_jax"))
    if k == 1:
        assert (a == 0).all()
    if k == 6:
        assert sorted(a) == list(range(6))
    a = _port_run("edges", k, "hype_parallel", candidates=3)
    np.testing.assert_array_equal(
        a, _jax_run("edges", k, "hype_parallel", candidates=3))


def test_large_core_priority_equals_jax():
    """Cores past 1,073 vertices: ``size * 1e6`` is no longer exact in
    float32, so the priority's two roundings must be JAX's."""
    a, st = hj.hype_parallel_partition(_pl(synthetic, "pl2400"), 2,
                                       device="cpu", return_stats=True)
    np.testing.assert_array_equal(a, _jax_run("pl2400", 2,
                                              "hype_parallel"))
    assert np.bincount(a).min() == 1200 > 1073
    assert st.rescues > 0


def test_stats_count_iterations():
    """hype_jax admits one vertex an iteration (seeds aside);
    hype_parallel's steps and rescues."""
    hg = _pl(synthetic)
    a, st = hj.hype_jax_partition(hg, 8, device="cpu", return_stats=True)
    base, rem = divmod(hg.n, 8)
    grown = sum(base + (1 if i < rem else 0) for i in range(7))
    assert st.iterations == grown - 7 and st.restarts > 0
    assert st.rescues == 0
    a2, st2 = hj.hype_parallel_partition(hg, 8, device="cpu",
                                         return_stats=True)
    assert _digest(a2) == PL300_DIGESTS["hype_parallel"]
    assert 0 < st2.rescues <= st2.iterations and st2.restarts == 0


@pytest.mark.parametrize("k,knobs,match", [
    (7, {}, "larger sample"), (2, {"candidates": 4}, "top_k"),
    (7, {"candidates": 4}, "larger sample")])
def test_parallel_raises_as_jax(k, knobs, match):
    """k > n (choice) and candidates > m (top_k) raise ValueError before
    any work; with both, the sample check comes first, as in JAX."""
    with pytest.raises(ValueError, match=match):
        jax_api.partition(JaxHypergraph.from_edge_lists(6, EDGES), k,
                          "hype_parallel", **knobs)
    with pytest.raises(ValueError, match=match.split()[-1]):
        _port_run("edges", k, "hype_parallel", **knobs)


@pytest.mark.parametrize("method", ["hype_jax", "hype_parallel"])
def test_no_card_raises(monkeypatch, method):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.partition(_pl(synthetic), 4, method)


def test_engines_draw_from_threefry():
    """The seed vertices are JAX's choice: the permutation's first k."""
    hg = _pl(synthetic)
    key, sub = threefry.split(threefry.prng_key(3))
    seeds = threefry.choice_without_replacement(sub, hg.n, 4).numpy()
    _, jsub = jax.random.split(jax.random.PRNGKey(3))
    np.testing.assert_array_equal(
        seeds, np.asarray(jax.random.choice(jsub, hg.n, shape=(4,),
                                            replace=False)))
