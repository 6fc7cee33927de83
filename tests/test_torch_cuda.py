"""Card-only checks of the port: each CUDA kernel against its plain version
and small partitions on the card. Marked ``cuda``; each test skips when
no CUDA device is present (decided inside the test, never at import).
Run them on a machine with a card (no JAX needed):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import hashlib

import numpy as np
import pytest
import torch

from repro_torch.data.synthetic import powerlaw_hypergraph
from repro_torch.kernels.hype_score.ops import hype_score_select, hype_scores
from repro_torch.kernels.hype_score.ref import (hype_score_select_ref,
                                                hype_scores_ref)
from repro_torch.kernels.kway_refine.ops import kway_gains
from repro_torch.kernels.kway_refine.ref import kway_gains_ref
from repro_torch.partition_api import partition

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.parametrize("G,R,L,s,select_k", [
    (32, 16, 2048, 1, 16), (32, 16, 128, 1, 16), (1, 16, 512, 16, 80),
    (5, 8, 33, 3, 72)])
def test_cuda_kernel_equals_plain_version(G, R, L, s, select_k):
    _need_card()
    rng = np.random.default_rng(G + L)
    nbrs = rng.integers(-1, 3 * L, size=(G, R, L)).astype(np.int32)
    fringe = rng.integers(-1, 3 * L, size=(G, s)).astype(np.int32)
    bias = np.where(rng.random((G, R)) < 0.2, 1e12, 0.0).astype(np.float32)
    prev = rng.integers(0, L, size=(G, 64)).astype(np.float32)
    prev[rng.random((G, 64)) < 0.3] = np.inf
    x = [torch.from_numpy(a).cuda() for a in (nbrs, fringe, bias, prev)]
    before = hype_score_select.launches
    got = hype_score_select(*x, select_k=select_k)
    torch.cuda.synchronize()
    assert hype_score_select.launches == before + 1
    for g, w in zip(got, hype_score_select_ref(*x, select_k)):
        assert torch.equal(g, w)


def test_cuda_partition_matches_golden():
    _need_card()
    hg = powerlaw_hypergraph(600, 400, seed=11, max_edge=30, max_degree=20)
    a = partition(hg, 16, device="cuda", t=8, pipeline_depth=1)
    got = hashlib.sha256(a.astype(np.int32).tobytes()).hexdigest()[:16]
    assert got == "bbcd2f732e03af91"    # tests/test_pipeline.py:39


@pytest.mark.parametrize("B,L,s", [
    (64, 32, 16), (256, 2048, 16), (256, 512, 1), (33, 33, 3), (5, 128, 40)])
def test_cuda_scores_equal_plain_version(B, L, s):
    _need_card()
    rng = np.random.default_rng(B + L + s)
    nbrs = rng.integers(-1, 2 * L, size=(B, L)).astype(np.int32)
    nbrs[0] = -1                                   # an all-pad row
    fringe = rng.choice(nbrs[nbrs >= 0], size=s).astype(np.int32)
    if s >= 2:
        fringe[1] = fringe[0]                      # a duplicated id
    x = [torch.from_numpy(a).cuda() for a in (nbrs, fringe)]
    before = hype_scores.launches
    got = hype_scores(*x)
    torch.cuda.synchronize()
    assert hype_scores.launches == before + 1
    assert torch.equal(got, hype_scores_ref(*x))


@pytest.mark.parametrize("B,L,k", [
    (4096, 2048, 32), (4096, 32, 2), (300, 512, 67), (17, 33, 5),
    (8, 128, 1)])
def test_cuda_kway_gains_equal_plain_version(B, L, k):
    _need_card()
    rng = np.random.default_rng(B + L + k)
    parts = rng.integers(-1, k, size=(B, L)).astype(np.int32)
    own = rng.integers(0, k, size=B).astype(np.int32)
    parts[::7] = -1
    own[::7] = -1                                  # pad rows
    x = [torch.from_numpy(a).cuda() for a in (parts, own)]
    before = kway_gains.launches
    got = kway_gains(*x, k=k)
    torch.cuda.synchronize()
    assert kway_gains.launches == before + 1
    assert torch.equal(got, kway_gains_ref(*x, k))


@pytest.mark.parametrize("method,kw,want", [
    ("hype_batched", {"t": 8}, "2f2d37dfd52d5986"),
    ("hype_superstep", {"preset": "quality"}, "8356b306cfe516d5"),
])
def test_cuda_refined_partition_matches_golden(method, kw, want):
    """Digests of the JAX package on the same graph (computed on the CPU)."""
    _need_card()
    hg = powerlaw_hypergraph(600, 400, seed=11, max_edge=30, max_degree=20)
    a = partition(hg, 16, method, device="cuda", **kw)
    got = hashlib.sha256(a.astype(np.int32).tobytes()).hexdigest()[:16]
    assert got == want
