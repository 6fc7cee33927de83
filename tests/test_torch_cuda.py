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
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
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


@pytest.mark.parametrize("G,R,L,s,P,select_k", [
    (32, 16, 2048, 1, 64, 16), (32, 16, 128, 1, 64, 16),
    (1, 16, 512, 16, 64, 80), (5, 8, 33, 3, 64, 72),
    # a fringe wider than the 16 register slots (shared memory), and
    # R + P slots past 48 KB (opted-in shared memory) and past the 227 KB
    # a block can have (a global scratch)
    (32, 16, 2048, 24, 64, 16), (32, 16, 512, 64, 64, 16),
    (4, 16, 128, 16, 12_300, 40), (3, 16, 64, 3, 58_200, 40),
    (2, 8, 64, 100, 60_000, 12)])
def test_cuda_kernel_equals_plain_version(G, R, L, s, P, select_k):
    _need_card()
    rng = np.random.default_rng(G + L)
    nbrs = rng.integers(-1, 3 * L, size=(G, R, L)).astype(np.int32)
    fringe = rng.integers(-1, 3 * L, size=(G, s)).astype(np.int32)
    bias = np.where(rng.random((G, R)) < 0.2, 1e12, 0.0).astype(np.float32)
    prev = rng.integers(0, L, size=(G, P)).astype(np.float32)
    prev[rng.random((G, P)) < 0.3] = np.inf
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
    a = partition(hg, 16, "hype_superstep", device="cuda", t=8,
                  pipeline_depth=1)
    got = hashlib.sha256(a.astype(np.int32).tobytes()).hexdigest()[:16]
    assert got == "bbcd2f732e03af91"    # tests/test_pipeline.py:39


@pytest.mark.parametrize("B,L,s", [
    (64, 32, 16), (256, 2048, 16), (256, 512, 1), (33, 33, 3), (5, 128, 40),
    (256, 2048, 16_384), (64, 128, 60_000)])
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


@pytest.mark.parametrize("s", [1, 16, 32, 33])
@pytest.mark.parametrize("L", [32, 128, 512, 2048])
@pytest.mark.parametrize("B", [1, 64, 256])
def test_cuda_scores_fringe_widths_equal_plain_version(B, L, s):
    """The register-fringe paths (s <= 16, s <= 32) and the shared-memory
    path past them, at every L bucket: bit-equal to the plain version."""
    _need_card()
    rng = np.random.default_rng(3 * B + L + s)
    nbrs = rng.integers(-1, 2 * L, size=(B, L)).astype(np.int32)
    nbrs[-1, : L // 2] = -1                        # pad slots
    fringe = rng.choice(nbrs[nbrs >= 0], size=s).astype(np.int32)
    if s >= 3:
        fringe[1] = fringe[0]                      # a duplicated id
        fringe[-1] = -1                            # a pad slot
    x = [torch.from_numpy(a).cuda() for a in (nbrs, fringe)]
    got = hype_scores(*x)
    torch.cuda.synchronize()
    assert torch.equal(got, hype_scores_ref(*x))


@pytest.mark.parametrize("B,L,k", [
    (4096, 2048, 32), (4096, 32, 2), (300, 512, 67), (17, 33, 5),
    (8, 128, 1), (4096, 512, 2048), (4096, 512, 7264), (2048, 512, 10_000)])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V,D,B,bag,combine", [
    (4096, 256, 2048, 8, "mean"), (4096, 256, 512, 8, "sum"),
    (100, 33, 64, 5, "mean"), (50, 64, 40, 1, "sum"),
    (300, 128, 17, 40, "mean")])
def test_cuda_embedding_bag_equals_plain_version(V, D, B, bag, combine,
                                                 dtype):
    _need_card()
    rng = np.random.default_rng(V + D + bag)
    table = torch.from_numpy(rng.normal(size=(V, D)).astype(np.float32))
    ids = rng.integers(-1, V, size=(B, bag)).astype(np.int32)
    ids[0] = -1                                    # an all-pad row
    ids[-1] = ids[-1, 0]                           # one id repeated
    x = [table.to(dtype).cuda(), torch.from_numpy(ids).cuda()]
    before = embedding_bag.launches
    got = embedding_bag(*x, combine=combine)
    torch.cuda.synchronize()
    assert embedding_bag.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, D)
    assert torch.equal(got, embedding_bag_ref(*x, combine))


# flash_attention on the card against its plain version (chip_smoke.py's
# FLASH_TOL). float32: the CUDA-core kernel sums key tiles online where the
# plain version takes one softmax, so the two agree within float32
# rounding (the float32 tol of tests/test_kernels.py). bfloat16: the
# tensor-core kernel rounds P to bf16 before P V; bf16 keeps 8 significant
# bits, so each p_j moves by at most 2**-8 of itself and an output row by
# at most 2**-8 * sum_j p_j |v_j| / l <= 2**-8 max|v|; both sides round
# the output to bf16 once (under rtol). Worst case: allclose with atol
# 1e-4 + 2**-8 max|v| and rtol 1e-2. Typical error: mean |out - ref| <=
# 2**-8 mean |ref|, which a systematic fault would break.
FLASH_F32_TOL = dict(atol=2e-5, rtol=2e-5)


def _assert_flash_close(got, want, v):
    got, want = got.float(), want.float()
    if v.dtype == torch.float32:
        torch.testing.assert_close(got, want, **FLASH_F32_TOL)
        return
    vmax = float(v.float().abs().max())
    torch.testing.assert_close(got, want, atol=1e-4 + 2 ** -8 * vmax,
                               rtol=1e-2)
    assert float((got - want).abs().mean()) <= \
        2 ** -8 * float(want.abs().mean())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal,window", [
    (2, 128, 4, 4, 64, True, None), (1, 256, 8, 2, 64, True, None),
    (2, 256, 4, 4, 32, True, 64), (1, 128, 2, 1, 128, True, None),
    (1, 128, 2, 2, 32, False, None), (2, 100, 4, 2, 80, True, None),
    (1, 1000, 8, 2, 128, True, 300), (1, 70, 2, 1, 256, False, 33),
    (3, 1, 4, 4, 16, True, None), (1, 300, 4, 1, 64, True, 77),
    (2, 129, 4, 1, 128, False, None), (1, 200, 4, 2, 256, True, None)])
def test_cuda_flash_attention_close_to_plain_version(B, S, Hq, Hkv, D,
                                                     causal, window, dtype):
    """The limits above, on ragged S, windows, Hkv = 1 and D in {64, 80,
    128, 256} among others."""
    _need_card()
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.flash_attention import ops as fops
    rng = np.random.default_rng(B + S + D)
    x = [torch.from_numpy(rng.normal(size=(B, S, h, D)).astype(
        np.float32)).to(dtype).cuda() for h in (Hq, Hkv, Hkv)]
    before = fops.flash_attention.launches
    got = fops.flash_attention(*x, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fops.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == x[0].shape
    want = attention_ref(*x, causal=causal, window=window)
    _assert_flash_close(got, want, x[2])


def test_cuda_prefill_launches_the_kernel_once_per_layer():
    _need_card()
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import transformer as tf
    cfg = get_arch("qwen3-8b").build_cfg(reduced=True)
    params = tf.init_params(torch.Generator("cuda").manual_seed(0), cfg,
                            "cuda")
    tokens = torch.zeros((2, 40), dtype=torch.int32, device="cuda")
    before = fops.flash_attention.launches
    with torch.inference_mode():
        cache, logits = tf.prefill(params, tokens, cfg)
        tf.serve_step(params, cache, tokens[:, :1], cfg)
    torch.cuda.synchronize()
    assert fops.flash_attention.launches == before + cfg.n_layers
    assert bool(torch.isfinite(logits.float()).all())


# neighbor_agg on the card against its plain version: the mean is a
# float32 sum in slot order in both (equal bit for bit); the product sums
# over D in another order, so the output agrees within float32 rounding,
# and in bf16 within one bf16 step of the output (rtol 2**-7) plus that.
NA_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
          torch.bfloat16: dict(atol=1e-5, rtol=2 ** -7)}
NA_SHAPES = [(64, 32, 16, 8, 4), (200, 128, 64, 16, 10), (30, 16, 8, 4, 15),
             (50, 33, 7, 9, 1), (100, 602, 128, 64, 10),
             (4096, 128, 128, 4096, 25), (5000, 128, 64, 300, 100)]


def _na_inputs(N, D, F, B, K, dtype):
    rng = np.random.default_rng(N + D + K)
    x = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(D, F)) * 0.1).astype(np.float32))
    nbrs = rng.integers(-1, N, size=(B, K)).astype(np.int32)
    nbrs[0] = -1                                   # an all-pad row
    nbrs[-1] = N - 1                               # the last row, K times
    return x.to(dtype).cuda(), torch.from_numpy(nbrs).cuda(), w.cuda()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,D,F,B,K", NA_SHAPES)
def test_cuda_neighbor_agg_close_to_plain_version(N, D, F, B, K, dtype):
    _need_card()
    from repro_torch.kernels._build import load_extension
    from repro_torch.kernels.neighbor_agg import ops as nops
    from repro_torch.kernels.neighbor_agg import ref as nref
    x, nbrs, w = _na_inputs(N, D, F, B, K, dtype)
    before = nops.neighbor_agg.launches
    got = nops.neighbor_agg(x, nbrs, w)
    torch.cuda.synchronize()
    assert nops.neighbor_agg.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, F)
    torch.testing.assert_close(got.float(),
                               nref.neighbor_agg_ref(x, nbrs, w).float(),
                               **NA_TOL[dtype])
    _, mean = load_extension().neighbor_agg(x, nbrs, w, True)
    assert torch.equal(mean, nref.neighbor_mean_ref(x, nbrs)[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,D,F,B,K", NA_SHAPES)
def test_cuda_neighbor_agg_backward_is_deterministic(N, D, F, B, K, dtype):
    """The backward kernel adds in ref.py's chunk order without float
    atomics: the same bits on every run, and equal bit for bit to the
    plain version on the CPU (whose index_add_ adds in index order; on the
    card it adds with atomics)."""
    _need_card()
    from repro_torch.kernels.neighbor_agg import ops as nops
    from repro_torch.kernels.neighbor_agg import ref as nref
    _, nbrs, _ = _na_inputs(N, D, F, B, K, dtype)
    g = torch.randn((B, D), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(K))
    before = nops.neighbor_agg_bwd.launches
    first = nops.neighbor_agg_bwd(g, nbrs, N, dtype)
    again = nops.neighbor_agg_bwd(g, nbrs, N, dtype)
    torch.cuda.synchronize()
    assert nops.neighbor_agg_bwd.launches == before + 2
    assert first.dtype == dtype and torch.equal(first, again)
    assert torch.equal(first.cpu(), nref.neighbor_agg_bwd_ref(
        g.cpu(), nbrs.cpu(), N).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hub,D", [(1386, 128), (100_000, 128),
                                   (100_000, 33)])
def test_cuda_neighbor_agg_backward_hub_equals_plain_version(hub, D, dtype):
    """A hub id named by ``hub`` slots (the train launcher's 1,386, and
    100,000) among light ids: its chunks spread over many warps and are
    added in chunk order, bit-equal to the CPU plain version and to a
    second run."""
    _need_card()
    from repro_torch.kernels.neighbor_agg import ops as nops
    from repro_torch.kernels.neighbor_agg import ref as nref
    rng = np.random.default_rng(hub + D)
    N, K = 5000, 4
    B = hub + 1000
    nbrs = rng.integers(-1, N, size=(B, K)).astype(np.int32)
    nbrs[nbrs == 7] = 8
    nbrs[1 + rng.permutation(B - 1)[:hub], 0] = 7  # the hub, id 7
    nbrs[0] = -1                                   # an all-pad row
    assert (nbrs == 7).sum() == hub
    nbrs = torch.from_numpy(nbrs).cuda()
    g = torch.randn((B, D), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(D))
    first = nops.neighbor_agg_bwd(g, nbrs, N, dtype)
    again = nops.neighbor_agg_bwd(g, nbrs, N, dtype)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    assert torch.equal(first.cpu(), nref.neighbor_agg_bwd_ref(
        g.cpu(), nbrs.cpu(), N).to(dtype))


def test_cuda_neighbor_agg_backward_index_from_edges():
    """The backward over the index that in_neighbors builds from the edges
    gives the same bits as over transpose_index of the matrix."""
    _need_card()
    from repro_torch.data.graphs import build_graph_batch, random_graph
    from repro_torch.kernels.neighbor_agg import ops as nops
    from repro_torch.models import gnn
    src, dst = random_graph(3000, 6.0, seed=2)
    b = build_graph_batch(3000, src, dst, 8, 5, seed=2, pad_nodes=3072,
                          pad_edges=20480)
    t = {k: torch.from_numpy(b[k]).cuda()
         for k in ("edge_src", "edge_dst", "edge_mask")}
    nbrs, _, index = gnn.in_neighbors(t["edge_src"], t["edge_dst"],
                                      t["edge_mask"], 3072)
    g = torch.randn((3072, 128), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(4))
    assert torch.equal(nops.neighbor_agg_bwd(g, nbrs, 3072, index=index),
                       nops.neighbor_agg_bwd(g, nbrs, 3072))


def test_cuda_graphsage_step_launches_two_forward_two_backward():
    """One training step of the reduced GraphSAGE on the card: each of the
    two layers launches the forward kernel once and the backward once;
    the loss agrees with the CPU run within float32 rounding."""
    _need_card()
    from repro_torch.configs import get_arch
    from repro_torch.data.graphs import build_graph_batch, random_graph
    from repro_torch.kernels.neighbor_agg import ops as nops
    from repro_torch.models import gnn
    from repro_torch.train.train_loop import value_and_grad
    from repro_torch.train.tree import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("graphsage-reddit").build_cfg(reduced=True)
    src, dst = random_graph(200, 4.0, seed=3)
    b = build_graph_batch(200, src, dst, cfg.d_in, cfg.n_classes, seed=3,
                          pad_nodes=256, pad_edges=1024)
    params = gnn.init_gnn_params(torch.Generator().manual_seed(0), cfg)
    losses = {}
    for dev in ("cpu", "cuda"):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        p = tree_map(lambda t: t.to(dev), params)
        before = (nops.neighbor_agg.launches, nops.neighbor_agg_bwd.launches)
        loss, grads = value_and_grad(
            lambda q, bb: gnn.gnn_loss(q, bb, cfg), p, batch)
        after = (nops.neighbor_agg.launches, nops.neighbor_agg_bwd.launches)
        want = (0, 0) if dev == "cpu" else (2, 2)
        assert (after[0] - before[0], after[1] - before[1]) == want
        losses[dev] = float(loss)
    assert losses["cuda"] == pytest.approx(losses["cpu"], rel=1e-5)
