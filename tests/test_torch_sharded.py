"""The port's sharded engine (``hype_sharded``) against the JAX package,
on the CPU.

JAX runs its mesh on the 4 host devices that ``tests/conftest.py``
forces; the port runs one gloo rank per device, spawned once per module
and world size (``RankPool``), each rank running the whole engine with
``device="cpu"``. Every comparison runs JAX in the same test: the
per-shard score + select, the program's lowest-phase-wins case, pl600 at
1, 2 and 4 ranks and depths 1 and 2 (digest and counters), reddit at 2
and 4, the replicated cache after admissions, the edge cases (a
sub-group and its broadcast among them), refinement, kill and resume,
injected collective, NaN and OOM faults, and the degradation ladder with
``hype_sharded`` on top. Every rank must return the same assignment and
counters. Each pool has a hard timeout, and a rank that raises ends the
others by the group's timeout.
"""
import hashlib
import time

import _torch_sharded_ranks as ranks
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import partition_api as jax_api
from repro.core.hypergraph import Hypergraph as JaxHypergraph
from repro.core import resilience as jax_res
from repro.core import scoring as jax_scoring
from repro.data import synthetic as jax_synth
from repro.engines import sharded as jax_sharded
from repro.kernels.hype_score import ops as jax_ops
from repro_torch.core import partition_api as api
from repro_torch.core import resilience
from repro_torch.core.hypergraph import Hypergraph
from repro_torch.data import synthetic
from repro_torch.engines import superstep
from repro_torch.engines.sharded import (RankPool, ShardedParams,
                                         hype_sharded_partition,
                                         partition_rank, run_counters,
                                         spawn_partition)
from repro_torch.kernels.hype_score import ops, ref

# a pool's hard limit: a task that runs past it kills the ranks and fails
POOL_TIMEOUT_S = 120.0

# the JAX package's pl600 runs at k=16, seed 0: (devices, depth) ->
# (digest, supersteps = collectives, collective_bytes, conflicts)
PL600 = {(1, 1): ("bbcd2f732e03af91", 6, 6_144, 0),
         (1, 2): ("6d0521661383d51f", 8, 8_192, 0),
         (2, 1): ("80d845e4419f3b00", 6, 12_288, 67),
         (2, 2): ("edef050f7f15fe8d", 8, 16_384, 70),
         (4, 1): ("217b7b72950795e6", 6, 24_576, 134),
         (4, 2): ("11f3d02577629223", 8, 32_768, 100)}
_COUNTERS = ("supersteps", "collectives", "collective_bytes",
             "admission_conflicts", "stale_redraws", "cache_invalidations",
             "random_restarts", "faults_injected", "retries", "mem_retries",
             "plan_rung", "snapshots", "resumed_at")


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


@pytest.fixture(scope="module")
def pool2():
    with RankPool(2, timeout_s=POOL_TIMEOUT_S) as pool:
        yield pool


@pytest.fixture(scope="module")
def pool4():
    with RankPool(4, timeout_s=POOL_TIMEOUT_S) as pool:
        yield pool


@pytest.fixture(autouse=True)
def _no_env_plan(monkeypatch):
    monkeypatch.delenv("REPRO_FAULT_PLAN", raising=False)


def _same_on_every_rank(outs):
    """Every rank's (assignment, stats, launches): the same assignment
    and counters; returns rank 0's assignment and stats."""
    a0, s0, _ = outs[0]
    for a, s, _ in outs[1:]:
        np.testing.assert_array_equal(a, a0)
        assert run_counters(s) == run_counters(s0)
    return a0, s0


def _counters_equal(st, jst):
    for key in _COUNTERS:
        assert getattr(st, key) == getattr(jst, key), key


def _params(**kw):
    kw.setdefault("fault_plan", resilience.FaultPlan())
    return ShardedParams(seed=0, **kw)


def _jax(jhg, k, **kw):
    kw.setdefault("fault_plan", jax_res.FaultPlan())
    return jax_sharded.hype_sharded_partition(
        jhg, k, jax_sharded.ShardedParams(seed=0, **kw), return_stats=True)


def _run(pool, hg, k, **kw):
    """The sharded run on ``pool``'s ranks (in this process without
    one); returns rank 0's assignment and stats."""
    if pool is None:
        return hype_sharded_partition(hg, k, _params(**kw), True,
                                      device="cpu")
    return _same_on_every_rank(pool.run(partition_rank, hg, k,
                                        _params(**kw), "cpu"))


# ------------------------------------------------------ the shard's kernel

@pytest.mark.parametrize("off,gl", [(0, 2), (2, 2), (1, 3)])
def test_score_select_shard_equals_jax(off, gl):
    """The per-shard offset wrapper against JAX's, and against the full
    call's slice (tests/test_hype_sharded.py:259)."""
    rng = np.random.default_rng(0)
    G, R, L, P, s, t = 4, 3, 32, 5, 4, 2
    nbrs = rng.integers(-1, 50, size=(G, R, L)).astype(np.int32)
    fringe = rng.integers(-1, 50, size=(G, s)).astype(np.int32)
    bias = np.zeros((G, R), np.float32)
    prev = np.where(rng.random((G, P)) < 0.5,
                    rng.random((G, P)) * 10, np.inf).astype(np.float32)
    want = jax_ops.hype_score_select_shard(
        jnp.asarray(nbrs[off:off + gl]), jnp.asarray(fringe),
        jnp.asarray(bias), jnp.asarray(prev), select_k=t,
        shard_offset=off, interpret=True)
    args = (torch.from_numpy(nbrs[off:off + gl]), torch.from_numpy(fringe),
            torch.from_numpy(bias), torch.from_numpy(prev))
    got = ops.hype_score_select_shard(*args, select_k=t, shard_offset=off)
    plain = ref.hype_score_select_shard_ref(*args, t, off)
    full = ops.hype_score_select(*(torch.from_numpy(x) for x in (
        nbrs, fringe, bias, prev)), select_k=t)
    for i in range(3):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
        np.testing.assert_array_equal(got[i].numpy(), plain[i].numpy())
        np.testing.assert_array_equal(got[i].numpy(),
                                      full[i][off:off + gl].numpy())


# ------------------------------------------------------------- the program

def test_conflict_lowest_phase_wins_program_equals_jax(pool2):
    """Two phases on two ranks propose the same vertex in one superstep:
    the lowest phase wins on every rank, as in JAX's program
    (tests/test_hype_sharded.py:115), down to the cache and totals."""
    h = synthetic.powerlaw_hypergraph(120, 90, seed=3, max_edge=12,
                                      max_degree=8)
    jh = jax_synth.powerlaw_hypergraph(120, 90, seed=3, max_edge=12,
                                       max_degree=8)
    n = h.n
    v = int(np.argmax(np.diff(h.vertex_adjacency()[0])[: n // 2]))
    D, kl, R, t = 2, 1, 4, 2
    kG = D * kl
    fresh = np.full((kG, R), -1, np.int32)
    fresh[0, 0] = v
    fresh[1, 0] = v
    bias = np.where(fresh >= 0, 0, np.inf).astype(np.float32)
    pool = np.full((kG, 4), -1, np.int32)
    fringe = np.full((kG, 1), -1, np.int32)
    targets = np.full(kG, t, np.int32)
    dev = jh.device_adjacency()
    empty_i = np.full(4, -1, np.int32)
    want = jax_sharded.sharded_superstep_device(
        dev[0], dev[1], jnp.full((n,), -1, jnp.int32),
        jnp.full((n,), -1.0, jnp.float32), jnp.zeros((kG,), jnp.int32),
        jnp.zeros((1,), jnp.int32), empty_i, np.zeros(4, np.int32), empty_i,
        np.zeros(4, np.float32), fresh, bias, pool, fringe, targets,
        np.zeros(1, np.int32), num_devices=D, group_l=kl, tile_l=32,
        select_k=t, interpret=True)
    want = [np.asarray(x) for x in want]
    outs = pool2.run(ranks.conflict_program, h, fresh, bias, pool, fringe,
                     targets, kl, t)
    for got in outs:
        for name, g, w in zip(("assign", "cache", "acc", "poison",
                               "winners", "n_conflicts", "n_stale"),
                              got, want):
            np.testing.assert_array_equal(g, w, err_msg=name)
        assert got[4][0, 0] == v and v not in got[4][1]
        assert int(got[5]) == 1 and int(got[6]) == 0


def test_cache_exact_after_admissions(pool2):
    """JAX's exactness drill at D = 2 (tests/test_hype_sharded.py:188):
    device winners with clipped decrements and host-queued tails, plus
    host injections; the replicated cache equals JAX's and a recount on
    every rank."""
    for seed in (0, 1):
        kw = dict(seed=10 + seed, max_edge=18, max_degree=12)
        h = synthetic.powerlaw_hypergraph(300, 200, **kw)
        jh = jax_synth.powerlaw_hypergraph(300, 200, **kw)
        k, D, R, t = 4, 2, 8, 2
        outs = pool2.run(ranks.cache_exact, h, seed, k, R, t)
        jst = ranks.drill(jax_sharded.ShardedState(
            jh, k, jax_sharded.ShardedParams(seed=seed, t=t, rows=R,
                                             devices=D), D), seed, k, R, t)
        for cache, assign, acc, mirror, scored, conflicts in outs:
            np.testing.assert_array_equal(cache, np.asarray(jst.dev_cache))
            np.testing.assert_array_equal(assign,
                                          np.asarray(jst.dev_assign))
            np.testing.assert_array_equal(acc, np.asarray(jst.dev_acc))
            np.testing.assert_array_equal(mirror, jst.assignment)
            np.testing.assert_array_equal(assign, mirror)
            assert conflicts == jst.stats.admission_conflicts
            live = np.flatnonzero(scored & (jst.deg <= jst.tile_l))
            assert live.size > 50
            recount = jax_scoring.batched_dext_adj(
                jst.adj, live, np.zeros(h.n, dtype=bool), mirror)
            np.testing.assert_allclose(cache[live], recount)


# ------------------------------------------------------- runs against JAX

@pytest.mark.parametrize("devices,depth", sorted(PL600))
def test_pl600_equals_jax(devices, depth, hg, jhg, pool2, pool4):
    """pl600, k=16: JAX's digest and counters at 1, 2 and 4 ranks (one
    rank in this process, with no group and no collective)."""
    pool = {1: None, 2: pool2, 4: pool4}[devices]
    a, st = _run(pool, hg, 16, pipeline_depth=depth)
    ja, jst = _jax(jhg, 16, devices=devices, pipeline_depth=depth)
    assert _digest(a) == _digest(ja) == PL600[devices, depth][0]
    _counters_equal(st, jst)
    assert (st.supersteps, st.collective_bytes, st.admission_conflicts) \
        == PL600[devices, depth][1:]
    assert st.collectives == st.supersteps


@pytest.mark.parametrize("depth", [1, 2])
def test_one_rank_equals_superstep(depth, hg):
    """At one rank the sharded engine lands on hype_superstep's run."""
    a, st = _run(None, hg, 16, pipeline_depth=depth)
    b, sst = superstep.hype_superstep_partition(
        hg, 16, superstep.SuperstepParams(seed=0, pipeline_depth=depth),
        True, device="cpu")
    np.testing.assert_array_equal(a, b)
    assert st.supersteps == sst.supersteps
    assert st.admission_conflicts == 0 and sst.collectives == 0


def test_reddit_two_ranks_spawned_equal_jax():
    """reddit_like(0.01), k=32, t=16 through ``spawn_partition`` (fresh
    ranks) at two ranks against JAX (tests/test_hype_sharded.py:96)."""
    h = synthetic.reddit_like(0.01, seed=0)
    a, st = spawn_partition(h, 32, _params(t=16), 2, device="cpu",
                            timeout_s=POOL_TIMEOUT_S, return_stats=True)
    ja, jst = _jax(jax_synth.reddit_like(0.01, seed=0), 32, t=16, devices=2)
    assert _digest(a) == _digest(ja)
    _counters_equal(st, jst)


def test_reddit_four_ranks_equal_jax(pool4):
    h = synthetic.reddit_like(0.01, seed=0)
    a, st = _run(pool4, h, 32, t=16)
    ja, jst = _jax(jax_synth.reddit_like(0.01, seed=0), 32, t=16, devices=4)
    assert _digest(a) == _digest(ja)
    _counters_equal(st, jst)


@pytest.mark.parametrize("world,k", [(2, 1), (2, 2), (2, 3), (2, 8),
                                     (4, 2), (4, 3)])
def test_edge_cases_equal_jax(world, k, pool2, pool4):
    """The 6-vertex graph (tests/test_hype_sharded.py:69). k below the
    world size runs a sub-group of the first k ranks and broadcasts its
    result to the rest; every rank returns it."""
    edges = [[0, 1], [1, 2, 3], []]
    a, st = _run({2: pool2, 4: pool4}[world],
                 Hypergraph.from_edge_lists(6, edges), k)
    ja, jst = _jax(JaxHypergraph.from_edge_lists(6, edges), k,
                   devices=world)
    np.testing.assert_array_equal(a, ja)
    _counters_equal(st, jst)
    sizes = np.bincount(a, minlength=min(k, 6))
    assert (a >= 0).all() and sizes.max() - sizes.min() <= 1


def test_a_fault_in_a_sub_group_reaches_the_ranks_past_it(pool4):
    """k=2 at four ranks: the two ranks of the sub-group die of a fatal
    fault, and the two past the mesh raise it too, from the broadcast,
    instead of waiting for the group's timeout."""
    h = synthetic.powerlaw_hypergraph(120, 90, seed=3, max_edge=12,
                                      max_degree=8)
    with pytest.raises(resilience.UnrecoverableFault, match="dispatch"):
        _run(pool4, h, 2, fault_plan=resilience.FaultPlan.parse(
            "dispatch@2:fatal"))
    a, _ = _run(pool4, h, 2)        # the group is still usable
    assert (a >= 0).all() and a.max() == 1


def test_refine_equals_jax(hg, jhg, pool2):
    """refine_passes=3 at two ranks (tests/test_refine.py:306)."""
    a, st = _run(pool2, hg, 16, refine_passes=3)
    ja, jst = _jax(jhg, 16, devices=2, refine_passes=3)
    np.testing.assert_array_equal(a, ja)
    assert st.refine.moves == jst.refine.moves > 0
    assert st.refine.gain == jst.refine.gain


# ------------------------------------------------------------- resilience

def test_kill_and_resume_four_ranks(hg, jhg, pool4, tmp_path):
    """Snapshots every 2 supersteps (rank 0 writes), killed by a fatal
    dispatch fault on every rank, resumed: the uninterrupted run's bits,
    JAX's same-cadence run (tests/test_resilience.py:214)."""
    kw = dict(pool_cap=8, snapshot_every=2)
    base, bst = _run(pool4, hg, 16, snapshot_dir=str(tmp_path / "base"),
                     **kw)
    d = str(tmp_path / "killed")
    with pytest.raises(resilience.UnrecoverableFault):
        _run(pool4, hg, 16, snapshot_dir=d,
             fault_plan=resilience.FaultPlan.parse("dispatch@5:fatal"), **kw)
    a, st = _run(pool4, hg, 16, snapshot_dir=d, resume=d, **kw)
    ja, _ = _jax(jhg, 16, devices=4, snapshot_dir=str(tmp_path / "jax"),
                 **kw)
    assert _digest(a) == _digest(base) == _digest(ja)
    assert st.resumed_at >= 2 and bst.snapshots > 0


def test_collective_and_nan_faults_four_ranks(hg, jhg, pool4):
    """collective@2;nan@3 on every rank: retried and replayed, the
    fault-free bits (tests/test_resilience.py:306)."""
    a, st = _run(pool4, hg, 16, pool_cap=8, fault_plan=resilience.
                 FaultPlan.parse("collective@2;nan@3"))
    ja, jst = _jax(jhg, 16, devices=4, pool_cap=8,
                   fault_plan="collective@2;nan@3")
    base, _ = _jax(jhg, 16, devices=4, pool_cap=8)
    assert _digest(a) == _digest(ja) == _digest(base)
    assert st.faults_injected == st.retries == 2
    _counters_equal(st, jst)


def test_injected_oom_walks_one_rung_on_every_rank(hg, jhg, pool2):
    """A non-fatal oom at dispatch 2: every rank retries at rung 1 (the
    tile width drop), warm-started, as JAX's run does."""
    a, st = _run(pool2, hg, 16, fault_plan=resilience.FaultPlan.parse(
        "oom@2"))
    ja, jst = _jax(jhg, 16, devices=2, fault_plan="oom@2")
    assert _digest(a) == _digest(ja)
    assert st.mem_retries == 1 and st.plan_rung == jst.plan_rung >= 1
    _counters_equal(st, jst)


_LADDER = {
    "oom": ("oom:fatal", {}),
    "snapshot": ("dispatch@5:fatal", {}),
    "to_numpy": ("oom:fatal;oom:fatal;dispatch@3:fatal",
                 dict(kernel_min=1)),
}


@pytest.mark.parametrize("case", sorted(_LADDER))
def test_ladder_from_sharded_equals_jax(case, hg, jhg, tmp_path):
    """JAX's three ladder drills from ``hype_sharded``
    (tests/test_resilience.py:455-492), at devices=1 in both packages:
    the same rungs, bits and report; ``devices`` is dropped below."""
    plan, kw = _LADDER[case]
    args = dict(seed=0, pool_cap=8, snapshot_every=2, devices=1, **kw)
    a, rep = api.partition_resilient(
        hg, 16, "hype_sharded", device="cpu",
        snapshot_dir=str(tmp_path / "p"), fault_plan=plan, **args)
    ja, jrep = jax_api.partition_resilient(
        jhg, 16, "hype_sharded", snapshot_dir=str(tmp_path / "j"),
        fault_plan=plan, **args)
    assert _digest(a) == _digest(ja)
    assert rep["requested_method"] == "hype_sharded"
    assert rep["method"] == jrep["method"] != "hype_sharded"
    assert [r["method"] for r in rep["degraded_from"]] == [
        r["method"] for r in jrep["degraded_from"]]
    assert rep["fallbacks"] == jrep["fallbacks"] >= 1
    if hasattr(rep["stats"], "resumed_at"):
        assert rep["stats"].resumed_at == jrep["stats"].resumed_at
    sizes = np.bincount(a, minlength=16)
    assert sizes.max() - sizes.min() <= 1


# ------------------------------------------------------ the mesh, the ranks

def test_mesh_size_defaults_to_the_group(hg):
    """Without a group the mesh is one rank whatever ``devices`` asks
    (JAX's default is its local devices: ROADMAP.md queue 3); the knob
    is still checked."""
    a, st = _run(None, hg, 16, devices=4)
    assert _digest(a) == PL600[1, 2][0]
    assert st.collective_bytes == PL600[1, 2][2]
    with pytest.raises(ValueError, match="devices"):
        hype_sharded_partition(hg, 4, ShardedParams(devices=0),
                               device="cpu")


def test_no_card_means_no_silent_cpu_run(hg, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hype_sharded_partition(hg, 4, ShardedParams(seed=0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.partition_resilient(hg, 4)


def test_a_failed_rank_ends_the_others_and_a_stuck_pool_is_killed():
    """A rank that raises before the collective leaves the other waiting
    in it until the group's timeout, which raises naming the
    collective; a task that outlives the pool's limit is killed."""
    t0 = time.monotonic()
    pool = RankPool(2, timeout_s=2.0)
    try:
        with pytest.raises(RuntimeError, match="all_gather over 2 ranks"):
            pool.run(ranks.desync, 1)
        with pytest.raises(TimeoutError, match="killed"):
            pool.run(time.sleep, 60)
        assert not any(p.is_alive() for p in pool._procs)
    finally:
        pool.close(kill=True)
    assert time.monotonic() - t0 < 45
