"""The port's streaming engine against the JAX package, on the CPU.

``hype_stream`` through ``partition(..., device="cpu")`` assignment for
assignment; ``stream_bucket`` and ``stream_step_device`` (row 1 at the
stream's shape, then the sequential commit) bit for bit; the stream's
counters and sketch; validation, k = 1 and the empty graph; the
Hypergraph delta methods' CSR; ``apply_updates`` on each op kind and on
random op logs (the same assignment, sketch and counters as JAX's, and
the properties of the JAX package's incremental suite); faults,
snapshots and resume; the memory plan. Every case builds its inputs from
a seed with numpy and runs the JAX package in the same test.
"""
import copy
import dataclasses
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hype_stream as jax_stream
from repro.core import partition_api as jax_api
from repro.core import scoring as jax_scoring
from repro.data import synthetic as jax_synth
from repro_torch.core import hype_stream, metrics, scoring
from repro_torch.core.hype_stream import (STREAM_KM1_BOUND, StreamParams,
                                          apply_updates,
                                          hype_stream_partition,
                                          recompute_sketch)
from repro_torch.core.resilience import UnrecoverableFault
from repro_torch.data import synthetic
from repro_torch.engines.superstep import (SuperstepParams,
                                           hype_superstep_partition)
from repro_torch.kernels.hype_score.ref import stream_bucket_ref
from repro_torch.partition_api import partition
from tests._hyp_compat import given, settings, st

# wall-clock fields of StreamStats; every other field is a counter
_TIMINGS = {"stream_s", "vertices_per_s", "snapshot_s", "restore_s",
            "update_s", "updates_per_s"}


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(a, dtype=np.int32).tobytes()).hexdigest()[:16]


def _pl400(synth):
    return synth.powerlaw_hypergraph(400, 300, seed=5, max_edge=14,
                                     max_degree=12)


def _pl120(synth):
    return synth.powerlaw_hypergraph(120, 90, seed=11, max_edge=10,
                                     max_degree=8)


def _counters(stats) -> dict:
    return {key: val for key, val in dataclasses.asdict(stats).items()
            if key not in _TIMINGS}


def _both(k, graph=_pl400, **kw):
    """The port's and JAX's stream states for the same knobs."""
    _, got = hype_stream_partition(graph(synthetic), k, StreamParams(**kw),
                                   return_state=True, device="cpu")
    _, want = jax_stream.hype_stream_partition(
        graph(jax_synth), k, jax_stream.StreamParams(**kw),
        return_state=True)
    return got, want


def _assert_same_state(got, want):
    np.testing.assert_array_equal(got.assignment, want.assignment)
    np.testing.assert_array_equal(got.sketch, want.sketch)
    np.testing.assert_array_equal(got.sizes, want.sizes)
    np.testing.assert_array_equal(got.fringe, want.fringe)
    np.testing.assert_array_equal(got.fringe_pos, want.fringe_pos)
    assert got.sketch_digest() == want.sketch_digest()
    assert _counters(got.stats) == _counters(want.stats)
    assert (got.cursor, got.batch_idx) == (want.cursor, want.batch_idx)


def _assert_sketch_invariant(state):
    sk, sz = recompute_sketch(state.hg, state.assignment, state.k,
                              state.params.sketch_bits)
    np.testing.assert_array_equal(state.sketch, sk)
    np.testing.assert_array_equal(state.sizes, sz)


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    monkeypatch.delenv("REPRO_FAULT_PLAN", raising=False)
    monkeypatch.delenv("REPRO_DEVICE_MEM_BUDGET", raising=False)


# ------------------------------------------------------------- the hash

@pytest.mark.parametrize("bits", [4, 12, 16, 24])
def test_stream_bucket_equals_jax(bits):
    rng = np.random.default_rng(bits)
    ids = np.concatenate([
        np.array([-1, 0, 1, 2**31 - 1, 2**31 - 2], np.int64),
        rng.integers(-1, 2**31 - 1, size=1000)]).astype(np.int32)
    want = jax_scoring.stream_bucket(ids, bits)
    got = scoring.stream_bucket(ids, bits)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    on_torch = stream_bucket_ref(torch.from_numpy(ids), bits)
    np.testing.assert_array_equal(on_torch.numpy(), want)
    assert scoring.STREAM_HASH_MULT == jax_scoring.STREAM_HASH_MULT


# ---------------------------------------------------- the micro-batch step

def _step_inputs(seed, k, mb, le, ln, bits, s, kind):
    """Seeded step inputs: duplicate buckets (ids over few buckets), an
    all-pad row and pad rows at the end; ``kind`` forces ties (no balance
    or fringe term), capacity hits, or both at once (every partition
    full)."""
    rng = np.random.default_rng(seed)
    edge = rng.integers(-1, 3 << bits, size=(mb, le)).astype(np.int32)
    nbr = rng.integers(-1, 80, size=(mb, ln)).astype(np.int32)
    edge[mb // 2] = -1
    nbr[mb // 2] = -1
    fringe = rng.integers(-1, 80, size=(k, s)).astype(np.int32)
    sketch = (rng.integers(0, 3, size=(k, 1 << bits))
              * (rng.random((k, 1 << bits)) < 0.4)).astype(np.int32)
    cap = 2 * mb + 3
    sizes = rng.integers(0, cap, size=k).astype(np.int32)
    valid = np.ones(mb, bool)
    valid[max(mb - 2, 1):] = False
    alpha, fw = 1.0, 0.5
    if kind in ("ties", "full"):
        alpha, fw = 0.0, 0.0
    if kind == "cap":
        sizes[::2] = cap
    if kind == "full":
        sizes[:] = cap
    return (edge, nbr, fringe, sketch, sizes, valid,
            dict(alpha=alpha, fringe_w=fw, inv_target=float(
                np.float32(k / 977)), cap=cap, sketch_bits=bits))


@pytest.mark.parametrize("k,mb,le,ln,bits,s,kind", [
    (3, 1, 32, 32, 4, 8, "plain"), (5, 8, 32, 128, 4, 16, "ties"),
    (7, 16, 128, 32, 6, 3, "cap"), (4, 9, 32, 32, 4, 16, "full"),
    (32, 64, 128, 512, 8, 16, "plain"), (2, 7, 512, 128, 12, 1, "cap"),
    (1, 5, 32, 32, 4, 2, "plain")])
def test_stream_step_equals_jax(k, mb, le, ln, bits, s, kind):
    edge, nbr, fringe, sketch, sizes, valid, kw = _step_inputs(
        k * 100 + mb, k, mb, le, ln, bits, s, kind)
    want = jax_scoring.stream_step_device(
        jnp.asarray(edge), jnp.asarray(nbr), jnp.asarray(fringe),
        jnp.asarray(sketch), jnp.asarray(sizes), jnp.asarray(valid),
        interpret=True, **kw)
    t = [torch.from_numpy(a.copy()) for a in (edge, nbr, fringe, sketch,
                                              sizes, valid)]
    got = scoring.stream_step_device(*t, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1] is t[3] and got[2] is t[4]          # updated in place
    assert (got[0].numpy()[~valid] == -1).all()
    if kind == "full":
        assert (got[0].numpy()[valid] == 0).all()     # all -inf: index 0


# ------------------------------------------------------------- the pass

@pytest.mark.parametrize("order", ["random", "natural"])
@pytest.mark.parametrize("mb", [1, 4, 32, 64])
@pytest.mark.parametrize("k", [3, 5, 7])
def test_partition_equals_jax(k, mb, order):
    kw = dict(micro_batch=mb, s=8, seed=2, order=order)
    got = partition(_pl400(synthetic), k, "hype_stream", device="cpu",
                    seed=2, **{key: v for key, v in kw.items()
                               if key != "seed"})
    want = jax_stream.hype_stream_partition(
        _pl400(jax_synth), k, jax_stream.StreamParams(**kw))
    assert _digest(got) == _digest(want)


def test_registry_forwards_stream_knobs():
    kw = dict(micro_batch=32, sketch_bits=12, s=8, balance_alpha=0.5,
              fringe_weight=2.0)
    got = partition(_pl400(synthetic), 3, "hype_stream", device="cpu",
                    seed=1, **kw)
    want = jax_api.partition(_pl400(jax_synth), 3, "hype_stream", seed=1,
                             **kw)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,mb", [(2, 64), (6, 16)])
def test_state_and_counters_equal_jax(k, mb):
    got, want = _both(k, micro_batch=mb, seed=4)
    _assert_same_state(got, want)
    assert got.stats.vertices == got.hg.n
    assert got.stats.device_calls == got.stats.micro_batches
    assert got.stats.host_to_device_bytes > 0 and got.stats.planned_bytes
    assert (got.stats.plan_micro_batch, got.stats.plan_tile_l) == (mb, 2048)
    _assert_sketch_invariant(got)
    sizes = np.bincount(got.assignment, minlength=k)
    assert sizes.max() <= -(-got.hg.n // k)
    assert sizes.max() - sizes.min() <= k


def test_return_stats_and_state_shapes():
    hg = _pl400(synthetic)
    a, stats = hype_stream_partition(hg, 4, StreamParams(),
                                     return_stats=True, device="cpu")
    assert a.dtype == np.int32 and a.shape == (hg.n,)
    assert stats.vertices_per_s > 0
    a2 = hype_stream_partition(hg, 4, device="cpu")
    np.testing.assert_array_equal(a, a2)


def test_param_validation_messages_equal_jax():
    hg, jhg = _pl400(synthetic), _pl400(jax_synth)
    cases = [(2, dict(micro_batch=0)), (2, dict(sketch_bits=30)),
             (2, dict(sketch_bits=3)), (2, dict(s=0)),
             (2, dict(order="sorted")), (2, dict(update_radius=-1)),
             (2, dict(snapshot_every=3)), (0, {})]
    for k, kw in cases:
        with pytest.raises(ValueError) as want:
            jax_stream.hype_stream_partition(
                jhg, k, jax_stream.StreamParams(**kw))
        with pytest.raises(ValueError) as got:
            hype_stream_partition(hg, k, StreamParams(**kw), device="cpu")
        assert str(got.value) == str(want.value)


def test_k1_and_empty_graph_equal_jax():
    got, want = _both(1, micro_batch=16)
    _assert_same_state(got, want)
    assert (got.assignment == 0).all()
    empty, jempty = (synth.powerlaw_hypergraph(0, 0, seed=0)
                     for synth in (synthetic, jax_synth))
    a, state = hype_stream_partition(empty, 3, return_state=True,
                                     device="cpu")
    _, jstate = jax_stream.hype_stream_partition(jempty, 3,
                                                 return_state=True)
    assert a.size == 0
    _assert_same_state(state, jstate)


def test_no_card_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hg = _pl400(synthetic)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hype_stream_partition(hg, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        partition(hg, 4, "hype_stream")


def test_one_pass_quality_within_documented_bound():
    """km1(hype_stream) / km1(the port's offline hype) under
    STREAM_KM1_BOUND on the JAX suite's quick generators, the stream's
    assignment held to JAX's."""
    for make in (lambda s: s.powerlaw_hypergraph(800, 600, seed=7,
                                                 max_edge=20, max_degree=14),
                 lambda s: s.community_hypergraph(800, 550, 6, seed=7)):
        g, jg = make(synthetic), make(jax_synth)
        for k in (4, 16):
            base = metrics.k_minus_1(g, partition(g, k, "hype",
                                                  device="cpu"))
            a = partition(g, k, "hype_stream", device="cpu")
            np.testing.assert_array_equal(
                a, jax_api.partition(jg, k, "hype_stream"))
            got = metrics.k_minus_1(g, a)
            assert got <= STREAM_KM1_BOUND * max(base, 1), (g.n, k, got,
                                                             base)


# ------------------------------------------------- hypergraph delta methods

def _csr(g):
    return (g.n, g.m, g.v2e_indptr, g.v2e_indices, g.e2v_indptr,
            g.e2v_indices)


def _assert_same_graph(got, want):
    for a, b in zip(_csr(got), _csr(want)):
        np.testing.assert_array_equal(a, b)
    assert got.fingerprint() == want.fingerprint()


def test_delta_methods_equal_jax():
    g, jg = _pl400(synthetic), _pl400(jax_synth)
    steps = [lambda h: h.with_edges([[0, 1, 2], [5, 5, 9], []]),
             lambda h: h.with_edges([[400, 3]], n=401),
             lambda h: h.with_vertices([[0, 7], [], [3]]),
             lambda h: h.without_edges([0, 11]),
             lambda h: h.without_vertices([5, 6, 400])]
    for step in steps:
        g, jg = step(g), step(jg)
        _assert_same_graph(g, jg)
        g.validate()
    for v in (0, 5, 7, 399, 402):
        np.testing.assert_array_equal(g.vertex_edges(v),
                                      jg.vertex_edges(v))
        np.testing.assert_array_equal(g.neighbors(v), jg.neighbors(v))
    np.testing.assert_array_equal(g.edges_by_size(), jg.edges_by_size())
    assert g.edge_pins(0).size == 0 and g.vertex_edges(5).size == 0


# ----------------------------------------------------- incremental mode

def _random_ops(state, rng, n_ops):
    """A valid random op log against the live state (the JAX package's
    incremental suite's form)."""
    ops = []
    sim_n, sim_m = state.hg.n, state.hg.m
    alive_v = set(np.flatnonzero(state.assignment >= 0).tolist())
    alive_e = set(np.flatnonzero(np.diff(state.hg.e2v_indptr) > 0).tolist())
    for _ in range(n_ops):
        kind = rng.integers(0, 4)
        if kind == 0 and len(alive_v) > state.k * 2:
            v = int(rng.choice(sorted(alive_v)))
            ops.append(("remove_vertex", v))
            alive_v.discard(v)
        elif kind == 1 and len(alive_e) > 2:
            e = int(rng.choice(sorted(alive_e)))
            ops.append(("remove_edge", e))
            alive_e.discard(e)
        elif kind == 2 and len(alive_v) >= 2:
            pins = rng.choice(sorted(alive_v), size=int(rng.integers(2, 6)),
                              replace=False)
            ops.append(("add_edge", [int(x) for x in pins]))
            alive_e.add(sim_m)
            sim_m += 1
        elif len(alive_e) >= 1:
            es = rng.choice(sorted(alive_e),
                            size=min(int(rng.integers(1, 4)), len(alive_e)),
                            replace=False)
            ops.append(("add_vertex", [int(x) for x in es]))
            alive_v.add(sim_n)
            sim_n += 1
    return ops


@pytest.fixture(scope="module")
def states16():
    """The port's and JAX's states after a pass at k = 4, micro_batch 16."""
    return _both(4, micro_batch=16)


@pytest.fixture(scope="module")
def states120():
    """... on the 120-vertex graph at k = 3, micro_batch 8."""
    return _both(3, graph=_pl120, micro_batch=8)


@pytest.fixture(scope="module")
def states8():
    """... on the 400-vertex graph at k = 4, micro_batch 8."""
    return _both(4, micro_batch=8)


def _apply_both(states, ops):
    """``ops`` applied to copies of the port's and JAX's states; returns
    the two states, held equal."""
    got, want = (copy.deepcopy(s) for s in states)
    apply_updates(got, ops)
    jax_stream.apply_updates(want, ops)
    _assert_same_graph(got.hg, want.hg)
    _assert_same_state(got, want)
    _assert_sketch_invariant(got)
    return got, want


def test_apply_updates_each_op_kind(states16):
    n = states16[0].hg.n
    state, _ = _apply_both(states16, [("remove_vertex", 7), ("remove_edge", 3),
                                   ("add_edge", [1, 2, 10]),
                                   ("add_vertex", [0, 4])])
    assert state.assignment[7] == -1              # the deleted slot stays
    assert state.hg.edge_pins(3).size == 0        # emptied, not renumbered
    assert state.hg.n == n + 1                    # appended id = old n
    assert state.assignment[n] >= 0               # the new vertex admitted
    assert state.stats.inserts == 2 and state.stats.deletes == 2
    assert (state.fringe != 7).all()              # scrubbed from fringes


@pytest.mark.parametrize("op", [("remove_vertex", 12), ("remove_edge", 4),
                                ("add_edge", [3, 3, 8, 200]),
                                ("add_vertex", [1, 2, 3]),
                                ("add_vertex", [])])
def test_apply_updates_single_op_equals_jax(states16, op):
    _apply_both(states16, [op])


def test_apply_updates_unknown_op(states16):
    state = copy.deepcopy(states16[0])
    with pytest.raises(ValueError, match="unknown stream op"):
        apply_updates(state, [("rename_vertex", 1)])


def test_full_assignment_equals_jax(states16):
    state, want = _apply_both(states16, [("remove_vertex", 3),
                                         ("remove_vertex", 11)])
    f1 = state.full_assignment()
    np.testing.assert_array_equal(f1, want.full_assignment())
    assert f1.min() >= 0 and f1.max() < state.k
    live = state.assignment >= 0
    np.testing.assert_array_equal(f1[live], state.assignment[live])


def _check_random_log(states, seed):
    """Any valid log leaves the port on JAX's state, the exact sketch
    invariant, a bounded-slack assignment and a k-1 within the JAX
    suite's factor of a from-scratch hype_superstep run."""
    ops = _random_ops(states[0], np.random.default_rng(seed), 15)
    state, _ = _apply_both(states, ops)
    k = state.k
    live = state.assignment >= 0
    assert state.assignment[live].max() < k
    sizes = np.bincount(state.assignment[live], minlength=k)
    assert sizes.max() - sizes.min() <= k, sizes
    km_inc = metrics.k_minus_1(state.hg, state.full_assignment())
    scratch = hype_superstep_partition(state.hg, k, SuperstepParams(seed=0),
                                       device="cpu")
    km_scr = metrics.k_minus_1(state.hg, scratch)
    assert km_inc <= 2 * STREAM_KM1_BOUND * max(km_scr, 1) + 30, \
        (km_inc, km_scr)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_updates_random_log_equals_jax(states120, seed):
    _check_random_log(states120, seed)


@given(seed=st.integers(min_value=0, max_value=10**6))
@settings(max_examples=10, deadline=None)
def test_apply_updates_random_log_hypothesis(states120, seed):
    _check_random_log(states120, seed)


def _check_delete_reinsert(states, v):
    """Deleting a vertex and re-adding it with the same memberships keeps
    the sketch exact, and restores the pre-delete digest when the
    re-admission lands in the original partition with no move."""
    base = states[0]
    edges = base.hg.vertex_edges(int(v)).tolist()
    part_before = int(base.assignment[v])
    digest_before = base.sketch_digest()
    removed = _apply_both(states, [("remove_vertex", int(v))])
    state, _ = _apply_both(removed, [("add_vertex", edges)])
    if int(state.assignment[state.hg.n - 1]) == part_before \
            and state.stats.refine_moves == 0 \
            and state.stats.rebalance_moves == 0:
        assert state.sketch_digest() == digest_before


@pytest.mark.parametrize("v", [0, 17, 250])
def test_delete_then_reinsert_restores_the_sketch(states8, v):
    _check_delete_reinsert(states8, v)


@given(v=st.integers(min_value=0, max_value=399))
@settings(max_examples=10, deadline=None)
def test_delete_then_reinsert_hypothesis(states8, v):
    _check_delete_reinsert(states8, v)


# ------------------------------------------------- faults, snapshots, resume

def test_fault_retry_replays_the_batch():
    p0 = dict(micro_batch=16, seed=3)
    got, want = _both(4, fault_plan="dispatch@2", **p0)
    _assert_same_state(got, want)
    ref = hype_stream_partition(_pl400(synthetic), 4, StreamParams(**p0),
                                device="cpu")
    np.testing.assert_array_equal(got.assignment, ref)
    assert got.stats.faults_injected == 1 and got.stats.retries == 1


def test_retry_budget_and_fatal_fault_raise():
    hg = _pl400(synthetic)
    with pytest.raises(UnrecoverableFault, match="fatal injected"):
        hype_stream_partition(hg, 4, StreamParams(
            micro_batch=16, fault_plan="dispatch@2:fatal"), device="cpu")
    with pytest.raises(UnrecoverableFault, match="retry budget"):
        hype_stream_partition(hg, 4, StreamParams(
            micro_batch=16, max_retries=1,
            fault_plan="dispatch@2;dispatch@2"), device="cpu")


def test_real_exception_propagates(monkeypatch):
    def boom(*args, **kw):
        raise RuntimeError("a real failure")

    monkeypatch.setattr(scoring, "stream_step_device", boom)
    with pytest.raises(RuntimeError, match="a real failure"):
        hype_stream_partition(_pl400(synthetic), 4, device="cpu")


def test_env_fault_plan_reaches_the_stream(monkeypatch):
    monkeypatch.setenv("REPRO_FAULT_PLAN", "dispatch@2")
    got, want = _both(4, seed=3)
    _assert_same_state(got, want)
    assert got.stats.faults_injected == 1


def test_snapshot_resume_is_bit_identical(tmp_path):
    from repro.core import resilience as jax_res
    hg = _pl400(synthetic)
    d = str(tmp_path / "port")
    p0 = StreamParams(micro_batch=16, seed=3)
    ref = hype_stream_partition(hg, 4, p0, device="cpu")
    with pytest.raises(UnrecoverableFault):
        hype_stream_partition(hg, 4, dataclasses.replace(
            p0, snapshot_every=3, snapshot_dir=d,
            fault_plan="dispatch@8:fatal"), device="cpu")
    p_resume = dataclasses.replace(p0, snapshot_every=3, snapshot_dir=d,
                                   resume=d)
    a, state = hype_stream_partition(hg, 4, p_resume, return_state=True,
                                     device="cpu")
    np.testing.assert_array_equal(a, ref)
    assert state.stats.resumed_at == 6          # the last multiple of 3
    _assert_sketch_invariant(state)
    jd = str(tmp_path / "jax")
    jp = jax_stream.StreamParams(micro_batch=16, seed=3, snapshot_every=3,
                                 snapshot_dir=jd)
    with pytest.raises(jax_res.UnrecoverableFault):
        jax_stream.hype_stream_partition(_pl400(jax_synth), 4,
                                         dataclasses.replace(
                                             jp, fault_plan="dispatch@8:"
                                                            "fatal"))
    _, jstate = jax_stream.hype_stream_partition(
        _pl400(jax_synth), 4, dataclasses.replace(jp, resume=jd),
        return_state=True)
    _assert_same_state(state, jstate)


def test_snapshot_payload_equals_jax(tmp_path):
    from repro.core import resilience as jax_res
    from repro_torch.core import resilience
    d, jd = str(tmp_path / "port"), str(tmp_path / "jax")
    hype_stream_partition(_pl400(synthetic), 4, StreamParams(
        micro_batch=16, snapshot_every=5, snapshot_dir=d), device="cpu")
    jax_stream.hype_stream_partition(_pl400(jax_synth), 4,
                                     jax_stream.StreamParams(
                                         micro_batch=16, snapshot_every=5,
                                         snapshot_dir=jd))
    got, want = resilience.load_latest(d), jax_res.load_latest(jd)
    assert (got.engine, got.superstep, got.fingerprint, got.config) == (
        want.engine, want.superstep, want.fingerprint, want.config)
    assert set(got.payload) == set(want.payload)
    for key, val in got.payload.items():
        np.testing.assert_array_equal(val, want.payload[key])


def test_cross_config_snapshot_cold_starts(tmp_path):
    hg = _pl400(synthetic)
    d = str(tmp_path)
    hype_stream_partition(hg, 4, StreamParams(
        micro_batch=8, seed=1, snapshot_every=2, snapshot_dir=d),
        device="cpu")
    a, state = hype_stream_partition(hg, 4, StreamParams(
        micro_batch=16, seed=3, resume=d), return_state=True, device="cpu")
    assert state.stats.resumed_at == -1         # a cold start
    np.testing.assert_array_equal(a, hype_stream_partition(
        hg, 4, StreamParams(micro_batch=16, seed=3), device="cpu"))


# ------------------------------------------------------------ memory plan

def test_budgeted_plan_equals_jax():
    from repro_torch.core import membudget
    spec = membudget.StreamSpec(n=400, k=4, micro_batch=64, sketch_bits=16,
                                s=16, tile_l=2048)
    budget = membudget.estimate_stream_bytes(spec) // 2
    got, want = _both(4, micro_batch=64, mem_budget=budget)
    _assert_same_state(got, want)
    assert got.stats.plan_micro_batch < 64
    assert 0 < got.stats.planned_bytes <= budget


def test_env_budget_equals_jax(monkeypatch):
    monkeypatch.setenv("REPRO_DEVICE_MEM_BUDGET", "1MB")
    got, want = _both(4, micro_batch=64)
    _assert_same_state(got, want)
    assert got.stats.plan_micro_batch < 64


def test_module_keeps_jax_names():
    for name in ("STREAM_KM1_BOUND", "StreamParams", "StreamStats",
                 "StreamState", "recompute_sketch", "hype_stream_partition",
                 "apply_updates"):
        assert hasattr(hype_stream, name) and hasattr(jax_stream, name)
    assert hype_stream.STREAM_KM1_BOUND == jax_stream.STREAM_KM1_BOUND
    assert ([f.name for f in dataclasses.fields(StreamParams)]
            == [f.name for f in dataclasses.fields(jax_stream.StreamParams)])
    assert StreamParams() == StreamParams(**dataclasses.asdict(
        jax_stream.StreamParams()))
