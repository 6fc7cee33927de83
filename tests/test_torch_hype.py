"""The port's host HYPE and HYPE row placement against the JAX package.

``repro_torch.core.hype`` is a numpy copy of ``repro.core.hype``; on the
same graph, params and seed its assignment must equal JAX's exactly, as
must its stats. The graphs come from the copied generators (one seed,
one CSR). ``partition_rows_hype`` is run on the co-access log of
``benchmarks/bench_beyond_paper.py``'s embedding-placement run, whose
digest ``chip_smoke.py`` holds the card's run against.
"""
import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from repro.core import hype as jax_hype
from repro.core import partition_api as jax_api
from repro.data import synthetic as jax_synth
from repro.placement import partitioned_embedding as jax_pe
from repro_torch.core import hype
from repro_torch.core.hypergraph import Hypergraph
from repro_torch.data import synthetic
from repro_torch.partition_api import METHODS, PENDING, partition
from repro_torch.placement import partitioned_embedding as pe

# digest of partition_rows_hype on the bench log (vocab 8,192, 4,000
# queries, bag 16, k=8, seed 0), computed with the JAX package
PLACEMENT_DIGEST = "23febef3972fa7ee"


def digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a, np.int32).tobytes()
                          ).hexdigest()[:16]


def graphs(name):
    """The same graph from the JAX package's and the port's generator."""
    args = {"pl300": ((300, 200), dict(seed=3, max_edge=20, max_degree=12)),
            "pl600": ((600, 400), dict(seed=11, max_edge=30,
                                       max_degree=20))}[name]
    return (jax_synth.powerlaw_hypergraph(*args[0], **args[1]),
            synthetic.powerlaw_hypergraph(*args[0], **args[1]))


def bench_log(vocab=8192, n_queries=4000, bag=16):
    """benchmarks/bench_beyond_paper.py:62-70, call for call."""
    rng = np.random.default_rng(0)
    centers = rng.integers(0, vocab, n_queries)
    return [np.unique((centers[i] + rng.geometric(0.05, bag)) % vocab)
            for i in range(n_queries)]


@pytest.mark.parametrize("use_cache", [True, False])
@pytest.mark.parametrize("balance", ["vertex", "weighted"])
@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("graph", ["pl300", "pl600"])
def test_hype_partition_equals_jax(graph, k, balance, use_cache):
    jhg, hg = graphs(graph)
    kw = dict(seed=k, balance=balance, use_cache=use_cache)
    want, wst = jax_hype.hype_partition(jhg, k, jax_hype.HypeParams(**kw),
                                        return_stats=True)
    got, st = hype.hype_partition(hg, k, hype.HypeParams(**kw),
                                  return_stats=True)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert dataclasses.asdict(st) == dataclasses.asdict(wst)


@pytest.mark.parametrize("kw", [
    dict(dext_mode="eq1"), dict(dext_cap=12), dict(s=3, r=1),
    dict(s=16, r=4, seed=5)], ids=["eq1", "cap12", "s3r1", "s16r4"])
def test_hype_ablation_modes_equal_jax(kw):
    jhg, hg = graphs("pl300")
    want = jax_hype.hype_partition(jhg, 4, jax_hype.HypeParams(**kw))
    got = hype.hype_partition(hg, 4, hype.HypeParams(**kw))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [2, 4, 8])
def test_hyperedge_balanced_hype_equals_jax(k):
    jhg, hg = graphs("pl300")
    want = jax_hype.hyperedge_balanced_hype(jhg, k)
    got = hype.hyperedge_balanced_hype(hg, k)
    assert got.shape == (hg.m,)
    np.testing.assert_array_equal(got, want)


def test_warm_start_equals_jax():
    jhg, hg = graphs("pl600")
    warm = np.full(hg.n, -1, np.int32)
    warm[:150] = np.arange(150) % 3
    want = jax_hype.hype_partition(jhg, 6, warm_start=warm)
    got = hype.hype_partition(hg, 6, warm_start=warm)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:150], warm[:150])


def test_flip_equals_jax():
    jhg, hg = graphs("pl300")
    f, jf = hg.flip(), jhg.flip()
    assert (f.n, f.m) == (jf.n, jf.m) == (hg.m, hg.n)
    for name in ("v2e_indptr", "v2e_indices", "e2v_indptr", "e2v_indices"):
        np.testing.assert_array_equal(getattr(f, name), getattr(jf, name))
    f.validate()
    np.testing.assert_array_equal(f.flip().v2e_indices, hg.v2e_indices)


def test_hype_params_mirror_jax_fields_and_defaults():
    assert ([(f.name, f.default) for f in dataclasses.fields(hype.HypeParams)]
            == [(f.name, f.default)
                for f in dataclasses.fields(jax_hype.HypeParams)])
    assert ([f.name for f in dataclasses.fields(hype.HypeStats)]
            == [f.name for f in dataclasses.fields(jax_hype.HypeStats)])


@pytest.mark.parametrize("args,kw,match", [
    ((0,), {}, "k must be"),
    ((4, hype.HypeParams(balance="edges")), {}, "unknown balance"),
    ((4,), {"warm_start": np.zeros(5, np.int32)}, "warm_start must have"),
    ((4,), {"warm_start": np.full(300, 4, np.int32)}, "partition >= k"),
], ids=["k0", "balance", "warm_shape", "warm_range"])
def test_hype_rejects_bad_arguments(args, kw, match):
    _, hg = graphs("pl300")
    with pytest.raises(ValueError, match=match):
        hype.hype_partition(hg, *args, **kw)


@pytest.mark.parametrize("method", ["hype", "hype_weighted"])
@pytest.mark.parametrize("k", [3, 8])
def test_partition_api_equals_jax(method, k):
    jhg, hg = graphs("pl600")
    want = jax_api.partition(jhg, k, method, seed=2, s=6)
    got = partition(hg, k, method, device="cpu", seed=2, s=6)
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < k


def test_default_method_is_jax_default():
    """``partition(hg, k)`` names no method: both packages run ``hype``.
    JAX's digest on this graph is 075e45ddb0c2850d (k-1 = 292)."""
    jhg, hg = graphs("pl600")
    want = jax_api.partition(jhg, 8)
    got = partition(hg, 8, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert digest(got) == "075e45ddb0c2850d"


def test_hype_methods_are_served():
    assert {"hype", "hype_weighted"} <= set(METHODS)
    assert not {"hype", "hype_weighted"} & set(PENDING)


def test_hype_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, hg = graphs("pl300")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        partition(hg, 4, "hype")


def test_hype_takes_no_preset():
    _, hg = graphs("pl300")
    with pytest.raises(ValueError, match="does not support presets"):
        partition(hg, 4, "hype", device="cpu", preset="quality")


def test_queries_to_hypergraph_equals_jax():
    queries = bench_log(vocab=512, n_queries=300, bag=8)
    jhg = jax_pe.queries_to_hypergraph(512, queries)
    hg = pe.queries_to_hypergraph(512, queries)
    assert isinstance(hg, Hypergraph)
    assert hg.fingerprint() == jhg.fingerprint()


def test_partition_rows_hype_on_the_bench_log_equals_jax():
    queries = bench_log()
    want = jax_pe.partition_rows_hype(8192, queries, 8, seed=0)
    got = pe.partition_rows_hype(8192, queries, 8, seed=0)
    np.testing.assert_array_equal(got, want)
    assert digest(want) == PLACEMENT_DIGEST
    pl = pe.RowPlacement.from_assignment(got, 8)
    assert pl.shard_rows.sum() == 8192
    assert pl.shard_rows.max() - pl.shard_rows.min() <= 1


def test_row_placement_from_assignment():
    pl = pe.RowPlacement.from_assignment(np.array([0, 2, 2, 1, 2]), 4)
    assert pl.owner.dtype == np.int32
    np.testing.assert_array_equal(pl.shard_rows, [1, 1, 3, 0])
    jpl = jax_pe.RowPlacement.from_assignment(np.array([0, 2, 2, 1, 2]), 4)
    np.testing.assert_array_equal(pl.shard_rows, jpl.shard_rows)
    empty = pe.RowPlacement.from_assignment(np.zeros(0, np.int32), 2)
    np.testing.assert_array_equal(empty.shard_rows, [0, 0])


@pytest.mark.parametrize("bad", [[0, -1, 1], [0, 1, 3]],
                         ids=["negative", "at_k"])
def test_row_placement_rejects_ids_outside_k(bad):
    with pytest.raises(ValueError, match=r"\[0, k\)"):
        pe.RowPlacement.from_assignment(np.array(bad), 3)
    with pytest.raises(ValueError, match=r"\[0, k\)"):
        jax_pe.RowPlacement.from_assignment(np.array(bad), 3)
