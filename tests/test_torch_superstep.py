"""The port's hype_superstep slice against the JAX package, on the CPU.

One device superstep on identical inputs, the traced helpers one by one,
the seven depth-1 golden digests the JAX package pins, depth 2 and 3
computed by both packages in the test, the hub-truncation path, the
knobs and methods that are not ported, the converters and the copied
generators and metrics.
"""
import dataclasses
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as jax_metrics
from repro.core import partition_api as jax_api
from repro.core import scoring as jax_scoring
from repro.core.hypergraph import Hypergraph as JaxHypergraph
from repro.data import synthetic as jax_synth
from repro.engines import superstep as jax_ss
from repro_torch import convert
from repro_torch.core import metrics, scoring
from repro_torch.core.hypergraph import Hypergraph
from repro_torch.data import synthetic
from repro_torch.engines import superstep as ss
from repro_torch.partition_api import METHODS, PENDING, partition


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(a, dtype=np.int32).tobytes()).hexdigest()[:16]


def _pl600(synth):
    return synth.powerlaw_hypergraph(600, 400, seed=11, max_edge=30,
                                     max_degree=20)


# ------------------------------------------------- one device superstep

def _superstep_inputs(seed=0, k=8, R=8, P=64, tile_l=32):
    """A mid-run image and one superstep's host buffers, from a seed.

    Some vertices are assigned, the cache holds integer-valued scores,
    fresh rows include pads and hub rows (degree above ``tile_l``), the
    pools include stale (assigned) slots, and two phases sit one
    admission below their target so the cap cuts their winners.
    """
    hg = _pl600(synthetic)
    indptr, indices = hg.vertex_adjacency()
    deg = np.diff(indptr)
    n = hg.n
    rng = np.random.default_rng(seed)
    assign = np.full(n, -1, np.int32)
    done = rng.random(n) < 0.3
    assign[done] = rng.integers(0, k, size=done.sum())
    cache = rng.integers(-3, 40, size=n).astype(np.float32)
    acc = np.bincount(assign[done], minlength=k).astype(np.int32)
    free = rng.permutation(np.flatnonzero(~done))
    hubs = free[deg[free] > tile_l][:3]
    rest = free[~np.isin(free, hubs)]
    delta_ids = np.full(2 * k * R, -1, np.int32)
    delta_vals = np.zeros(2 * k * R, np.int32)
    delta_ids[:10] = rest[:10]
    delta_vals[:10] = rng.integers(0, k, size=10)
    dirty_ids = np.full(256, -1, np.int32)
    dirty_counts = np.zeros(256, np.float32)
    dirt = rng.choice(n, size=60, replace=False)
    dirty_ids[:60] = dirt
    dirty_counts[:60] = rng.integers(1, 5, size=60)
    fresh_ids = np.concatenate([hubs, rest[10:10 + k * R - 12]])
    fresh = np.full((k, R), -1, np.int32)
    fresh.reshape(-1)[:fresh_ids.size] = fresh_ids
    bias = np.where(fresh >= 0, 0.0, np.inf).astype(np.float32)
    real = fresh >= 0
    bias[real] = np.where(deg[fresh[real]] > tile_l,
                          np.float32(scoring.TRUNC_PENALTY), 0.0)
    pool = np.full((k, P), -1, np.int32)
    pool_ids = rest[10 + k * R:10 + k * R + k * 20]
    pool[:, :20] = pool_ids.reshape(k, 20)
    pool[:, 20:23] = rng.choice(np.flatnonzero(done), size=(k, 3),
                                replace=False)           # stale slots
    fringe = np.full((k, 1), -1, np.int32)
    targets = (acc + 30).astype(np.int32)
    targets[[1, 4]] = acc[[1, 4]] + 1
    assert (bias == np.float32(scoring.TRUNC_PENALTY)).any()
    image = dict(indptr=indptr, indices=indices, assign=assign,
                 cache=cache, acc=acc, poison=np.zeros(1, np.int32))
    buffers = dict(delta_ids=delta_ids, delta_vals=delta_vals,
                   dirty_ids=dirty_ids, dirty_counts=dirty_counts,
                   fresh=fresh, bias=bias, pool=pool, fringe=fringe,
                   targets=targets, reset=np.zeros(1, np.int32))
    return image, buffers, tile_l, R


def _scratch(a: np.ndarray, fill) -> torch.Tensor:
    """The port's image layout: one scratch element at the end."""
    return torch.from_numpy(np.append(a, np.asarray(fill, a.dtype)))


def test_one_superstep_matches_jax():
    image, buf, tile_l, select_k = _superstep_inputs()
    n, k = image["assign"].size, image["acc"].size
    want = jax_ss.pipeline_superstep_device(
        jnp.asarray(image["indptr"], jnp.int32),
        jnp.asarray(image["indices"]),
        *(jnp.asarray(image[name]) for name in
          ("assign", "cache", "acc", "poison")),
        *(jnp.asarray(v) for v in buf.values()),
        tile_l=tile_l, select_k=select_k, interpret=True)
    got = ss.superstep_device(
        torch.from_numpy(image["indptr"].astype(np.int32)),
        torch.from_numpy(image["indices"]),
        _scratch(image["assign"], -1), _scratch(image["cache"], -1.0),
        _scratch(image["acc"], 0), torch.from_numpy(image["poison"]),
        *(torch.from_numpy(v) for v in buf.values()),
        tile_l=tile_l, select_k=select_k, debug=True)
    names = ("assign", "cache", "acc", "poison", "winners", "n_stale")
    trims = (n, n, k, None, None, None)
    for name, g, w, cut in zip(names, got, want, trims):
        g = g.numpy()[:cut] if cut else g.numpy()
        w = np.asarray(w)
        assert g.dtype == w.dtype, name
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert (np.asarray(want[4]) >= 0).any()          # something admitted
    assert int(want[5]) > 0                          # stale slots seen


def _helper_case(name):
    image, buf, tile_l, _ = _superstep_inputs(seed=3)
    ip = image["indptr"].astype(np.int32)
    flat = buf["fresh"].reshape(-1)
    scores = np.where(flat >= 0, 2.0, np.inf).astype(np.float32)
    if name == "apply_host_injections":
        args = [image["assign"], image["cache"], image["acc"],
                buf["delta_ids"], buf["delta_vals"], buf["dirty_ids"],
                buf["dirty_counts"]]
        scratch = {0: -1, 1: -1.0, 2: 0}
        trims = (image["assign"].size, image["cache"].size,
                 image["acc"].size)
        return args, scratch, trims, {}
    if name == "gather_fresh_tiles":
        return ([ip, image["indices"], image["assign"], flat],
                {2: -1}, (None,), {"tile_l": tile_l})
    if name == "stale_masked_prev":
        return ([buf["pool"], image["assign"], image["cache"]],
                {1: -1, 2: -1.0}, (None, None), {})
    scores[3] = np.nan
    return ([flat, scores, np.ones(1, np.int32), np.zeros(1, np.int32)],
            {}, (None,), {})


@pytest.mark.parametrize("name", ["apply_host_injections",
                                  "gather_fresh_tiles",
                                  "stale_masked_prev", "poison_guard"])
def test_traced_helper_matches_jax(name):
    args, scratch, trims, kw = _helper_case(name)
    want = getattr(jax_scoring, "_" + name)(
        *(jnp.asarray(a) for a in args), *kw.values())
    got = getattr(scoring, "_" + name)(
        *(_scratch(a, scratch[i]) if i in scratch else torch.from_numpy(a)
          for i, a in enumerate(args)), *kw.values())
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    for g, w, cut in zip(got, want, trims):
        g = g.numpy()[:cut] if cut else g.numpy()
        w = np.asarray(w)
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(np.asarray(g), w)


# ------------------------------------------------------ depth-1 goldens

# Copied from tests/test_pipeline.py:38-43 (the JAX package's pinned
# depth-1 digests of hype_superstep).
_GOLD_PL600 = {(5, 8): "9e8abe668aa53a74",
               (16, 8): "bbcd2f732e03af91",
               (16, 16): "e67c679d4029b7d0"}
_GOLD_TINY = {2: "a102badbeab32296", 3: "b4293f255e72d527"}
_GOLD_PL300 = "f821db1120c8d632"
_GOLD_REDDIT = "13f232f653c9c752"


@pytest.mark.parametrize("k,t", sorted(_GOLD_PL600))
def test_depth1_golden_powerlaw(k, t):
    a = partition(_pl600(synthetic), k, device="cpu", t=t,
                  pipeline_depth=1)
    assert _digest(a) == _GOLD_PL600[(k, t)]


def test_depth1_golden_restart_heavy():
    hg = synthetic.powerlaw_hypergraph(300, 500, seed=21, max_edge=10,
                                       max_degree=30)
    a = partition(hg, 24, device="cpu", seed=1, pool_cap=16,
                  pipeline_depth=1)
    assert _digest(a) == _GOLD_PL300


@pytest.mark.parametrize("k", sorted(_GOLD_TINY))
def test_depth1_golden_edge_cases(k):
    hg = Hypergraph.from_edge_lists(6, [[0, 1], [1, 2, 3], []])
    a = partition(hg, k, device="cpu", pipeline_depth=1)
    assert _digest(a) == _GOLD_TINY[k]


def test_depth1_golden_reddit_pushes_hub_rows(monkeypatch):
    """The reddit golden also covers the hub-truncation path: rows whose
    degree exceeds the tile width reach the kernel with the penalty."""
    hub_rows = []
    kernel = ss.hype_score_select

    def spy(nbrs, fringe, bias, prev, *, select_k):
        hub_rows.append(int((bias == np.float32(scoring.TRUNC_PENALTY))
                            .sum()))
        return kernel(nbrs, fringe, bias, prev, select_k=select_k)

    monkeypatch.setattr(ss, "hype_score_select", spy)
    a = ss.hype_superstep_partition(
        synthetic.reddit_like(0.005, seed=0), 32,
        ss.SuperstepParams(seed=0, t=16, pipeline_depth=1),
        device="cpu", debug=True)
    assert _digest(a) == _GOLD_REDDIT
    assert sum(hub_rows) > 0


# ------------------------------------------------------- depth 2 and 3

@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("case", ["pl600_k16_t8", "reddit_k32_t16"])
def test_pipelined_run_matches_jax(case, depth):
    if case == "pl600_k16_t8":
        graph, k, t = (lambda s: _pl600(s)), 16, 8
    else:
        graph, k, t = (lambda s: s.reddit_like(0.005, seed=0)), 32, 16
    want, jst = jax_ss.hype_superstep_partition(
        graph(jax_synth), k,
        jax_ss.SuperstepParams(seed=0, t=t, pipeline_depth=depth),
        return_stats=True)
    got, st = ss.hype_superstep_partition(
        graph(synthetic), k, ss.SuperstepParams(seed=0, t=t,
                                                pipeline_depth=depth),
        return_stats=True, device="cpu", debug=True)
    assert _digest(got) == _digest(want)
    assert (st.supersteps, st.stale_redraws, st.pipeline_stalls) == (
        jst.supersteps, jst.stale_redraws, jst.pipeline_stalls)
    assert st.stale_redraws > 0          # the pipeline really overlapped


# ------------------------------------------------ what is not ported yet

@pytest.mark.parametrize("knobs", [
    {"snapshot_every": 4, "snapshot_dir": "x"},
    {"resume": "snapshots"}, {"fault_plan": "nan@1"},
    {"mem_budget": "1GB"},
], ids=lambda kw: ",".join(kw))
def test_unported_knobs_raise(knobs):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        partition(_pl600(synthetic), 4, device="cpu", **knobs)


@pytest.mark.parametrize("method", sorted(PENDING))
def test_pending_methods_raise(method):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        partition(_pl600(synthetic), 4, method, device="cpu")


def test_registry_covers_every_jax_method():
    assert set(METHODS).isdisjoint(PENDING)
    assert set(METHODS) | set(PENDING) == set(jax_api.METHODS)
    with pytest.raises(ValueError, match="unknown method"):
        partition(_pl600(synthetic), 4, "nope", device="cpu")


def test_no_card_means_no_silent_cpu_run(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        partition(_pl600(synthetic), 4)


def test_hub_expansion_guard_raises():
    """The hub-expansion guard trips (no adjacency image), and the engine
    falls back to hype_batched on the same device, as the JAX engine
    does; tests/test_torch_batched.py holds the result against JAX."""
    hg = Hypergraph.from_pins(9000, 1, np.arange(9000), np.zeros(9000))
    a = partition(hg, 4, device="cpu")
    assert hg.vertex_adjacency() is None
    np.testing.assert_array_equal(
        a, partition(hg, 4, "hype_batched", device="cpu"))
    sizes = metrics.partition_sizes(a, 4)
    assert (a >= 0).all() and sizes.max() - sizes.min() <= 1


def test_debug_flags_duplicate_scatter_targets():
    with pytest.raises(AssertionError, match="duplicate"):
        ss._check_unique(torch.tensor([3, 5, 3]), "ids")


# ----------------------------------------- converters, data and metrics

def test_convert_roundtrips_a_jax_hypergraph():
    jhg = jax_synth.reddit_like(0.002, seed=4)
    hg = convert.hypergraph_from_arrays(
        jhg.n, jhg.m, jhg.v2e_indptr, jhg.v2e_indices, jhg.e2v_indptr,
        jhg.e2v_indices)
    assert hg.fingerprint() == jhg.fingerprint()
    assert hg.stats() == jhg.stats()


def test_convert_superstep_params():
    jp = jax_ss.SuperstepParams(t=16, seed=3, pipeline_depth=1, rows=24)
    p = convert.superstep_params_from_dict(dataclasses.asdict(jp))
    assert p == ss.SuperstepParams(t=16, seed=3, pipeline_depth=1, rows=24)
    with pytest.raises(ValueError, match="unknown"):
        convert.superstep_params_from_dict({"t": 4, "devices": 2})


def test_superstep_params_mirror_jax_fields_and_defaults():
    jf = {f.name: f.default for f in
          dataclasses.fields(jax_ss.SuperstepParams)}
    pf = {f.name: f.default for f in dataclasses.fields(ss.SuperstepParams)}
    assert pf == jf


@pytest.mark.parametrize("gen,args", [
    ("powerlaw_hypergraph", (600, 400)), ("github_like", (0.01,)),
    ("stackoverflow_like", (0.003,)), ("reddit_like", (0.002,)),
])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_synthetic_fingerprints_match_jax(gen, args, seed):
    a = getattr(synthetic, gen)(*args, seed=seed)
    b = getattr(jax_synth, gen)(*args, seed=seed)
    assert a.fingerprint() == b.fingerprint()


def test_hypergraph_builders_match_jax():
    edges = [[0, 1], [1, 2, 3], [], [3, 3, 4]]
    a = Hypergraph.from_edge_lists(5, edges)
    b = JaxHypergraph.from_edge_lists(5, edges)
    assert a.fingerprint() == b.fingerprint()
    for ma, mb in zip(a.vertex_adjacency(), b.vertex_adjacency()):
        np.testing.assert_array_equal(ma, mb)
        assert ma.dtype == mb.dtype
    with pytest.raises(ValueError, match="out of range"):
        Hypergraph.from_pins(3, 1, [0, 5], [0, 0])


def test_metrics_match_jax():
    hg = _pl600(synthetic)
    jhg = _pl600(jax_synth)
    a = np.random.default_rng(5).integers(0, 7, size=hg.n).astype(np.int32)
    assert metrics.k_minus_1(hg, a, 7) == jax_metrics.k_minus_1(jhg, a, 7)
    np.testing.assert_array_equal(metrics.partition_sizes(a, 7),
                                  jax_metrics.partition_sizes(a, 7))
    assert (metrics.vertex_imbalance(a, 7)
            == jax_metrics.vertex_imbalance(a, 7))
