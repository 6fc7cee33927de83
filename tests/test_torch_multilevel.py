"""The port's multilevel partitioners against the JAX package, on the CPU.

``hype_multilevel`` (coarsening, the superstep engine on the coarsest
graph, weighted refinement on the coarse levels, rebalance and the
device-screened refinement at the finest) and ``multilevel`` (recursive
bisection) run in both packages on the same seeded graphs; assignments
must agree bit for bit.
"""
import hashlib

import numpy as np
import pytest

from repro.core import multilevel as jax_ml
from repro.data import synthetic as jax_synth
from repro_torch.core import metrics, multilevel
from repro_torch.data import synthetic
from repro_torch.core.partition_api import partition


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(a, dtype=np.int32).tobytes()).hexdigest()[:16]


def _pl600(synth):
    return synth.powerlaw_hypergraph(600, 400, seed=11, max_edge=30,
                                     max_degree=20)


def _pl1500(synth):
    # tests/test_refine.py:334-344: coarsest well below n forces the
    # coarsening and the weighted uncoarsening path
    return synth.powerlaw_hypergraph(1500, 1000, seed=4, max_edge=20,
                                     max_degree=12)


@pytest.mark.parametrize("k", (3, 8))
def test_hype_multilevel_matches_jax(k):
    want = jax_ml.hype_multilevel_partition(_pl600(jax_synth), k, seed=0)
    got = partition(_pl600(synthetic), k, "hype_multilevel", device="cpu")
    assert _digest(got) == _digest(want)
    assert got.dtype == np.int32
    sizes = metrics.partition_sizes(got, k)
    assert sizes.max() - sizes.min() <= 1


def test_hype_multilevel_coarsened_matches_jax():
    want = jax_ml.hype_multilevel_partition(_pl1500(jax_synth), 8, seed=0,
                                            coarsest=200)
    got = partition(_pl1500(synthetic), 8, "hype_multilevel", device="cpu",
                    coarsest=200, refine_passes=3)
    assert _digest(got) == _digest(want)
    sizes = metrics.partition_sizes(got, 8)
    assert sizes.max() - sizes.min() <= 1


def test_coarsening_matches_jax():
    hg, jhg = _pl1500(synthetic), _pl1500(jax_synth)
    w = np.ones(hg.n)
    chg, cw, cid = multilevel._coarsen_once(hg, w)
    jchg, jcw, jcid = jax_ml._coarsen_once(jhg, w)
    assert chg.fingerprint() == jchg.fingerprint()
    np.testing.assert_array_equal(cw, jcw)
    np.testing.assert_array_equal(cid, jcid)
    assert chg.n < hg.n


@pytest.mark.parametrize("k", (4, 8))
def test_multilevel_matches_jax(k):
    want = jax_ml.multilevel_partition(_pl600(jax_synth), k, seed=0)
    got = partition(_pl600(synthetic), k, "multilevel", device="cpu")
    assert _digest(got) == _digest(want)


def test_hype_multilevel_edge_cases():
    hg = _pl600(synthetic)
    run = multilevel.hype_multilevel_partition
    np.testing.assert_array_equal(run(hg, 1, device="cpu"),
                                  np.zeros(hg.n, np.int32))
    with pytest.raises(ValueError, match="k must be"):
        run(hg, 0, device="cpu")
