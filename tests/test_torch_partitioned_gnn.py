"""The port's partitioned-GNN placement against the JAX package's.

``repro_torch.placement.partitioned_gnn`` is a numpy copy of
``repro.placement.partitioned_gnn``: on benchmarks/bench_beyond_paper.py's
placement graph (n=4,000, 8 edges a vertex, ring locality, seed 0) its
hypergraph equals JAX's array for array, the port's host HYPE assignment
of it equals JAX's, and the halo statistics of ``build_partitioned_graph``
are equal exactly.
"""
import numpy as np
import pytest

from repro.core.hype import HypeParams as JaxHypeParams
from repro.core.hype import hype_partition as jax_hype_partition
from repro.placement import partitioned_gnn as jax_pg
from repro_torch.core.hype import HypeParams, hype_partition
from repro_torch.placement import partitioned_gnn as pg


def bench_graph(n=4000, avg_deg=8):
    """benchmarks/bench_beyond_paper.py:40-47, call for call."""
    rng = np.random.default_rng(0)
    src = rng.integers(0, n, n * avg_deg)
    offs = rng.integers(1, 40, n * avg_deg)
    return src, (src + offs) % n


def test_graph_to_hypergraph_equals_jax():
    src, dst = bench_graph()
    hg, jhg = pg.graph_to_hypergraph(4000, src, dst), \
        jax_pg.graph_to_hypergraph(4000, src, dst)
    assert (hg.n, hg.m) == (jhg.n, jhg.m)
    for name in ("v2e_indptr", "v2e_indices", "e2v_indptr", "e2v_indices"):
        assert np.array_equal(getattr(hg, name), getattr(jhg, name)), name


@pytest.mark.parametrize("k", [2, 8])
def test_hype_placement_halo_equals_jax(k):
    src, dst = bench_graph()
    hg = pg.graph_to_hypergraph(4000, src, dst)
    a = hype_partition(hg, k, HypeParams(seed=0))
    ja = jax_hype_partition(jax_pg.graph_to_hypergraph(4000, src, dst), k,
                            JaxHypeParams(seed=0))
    assert np.array_equal(a, ja)
    got = pg.build_partitioned_graph(4000, src, dst, a, k)
    want = jax_pg.build_partitioned_graph(4000, src, dst, ja, k)
    assert got.k == want.k and got.s_max == want.s_max
    assert np.array_equal(got.owner, want.owner)
    assert np.array_equal(got.halo_rows, want.halo_rows)
    assert got.stats == want.stats
    # HYPE beats a hash placement on the ring-local graph
    hashed = (np.arange(4000) * 2654435761 % 4000 % k).astype(np.int32)
    assert got.s_max < pg.build_partitioned_graph(4000, src, dst, hashed,
                                                  k).s_max


def test_partitioned_graph_small_case_and_errors():
    src = np.array([0, 1, 2, 3, 3])
    dst = np.array([1, 2, 3, 0, 1])
    owner = np.array([0, 0, 1, 1])
    got = pg.build_partitioned_graph(4, src, dst, owner, 2)
    want = jax_pg.build_partitioned_graph(4, src, dst, owner, 2)
    assert got.halo_rows.tolist() == want.halo_rows.tolist() == [1, 1]
    assert got.stats == want.stats
    with pytest.raises(ValueError, match="shape"):
        pg.build_partitioned_graph(4, src, dst, owner[:3], 2)
    with pytest.raises(ValueError, match="same shape"):
        pg.graph_to_hypergraph(4, src, dst[:2])
