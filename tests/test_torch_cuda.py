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
from repro_torch.kernels.hype_score.ops import (hype_score_select,
                                               hype_scores, stream_commit)
from repro_torch.kernels.hype_score.ref import (SELECT_PAD,
                                                stream_commit_ref,
                                                hype_score_select_ref,
                                                hype_scores_ref)
from repro_torch.kernels.kway_refine.ops import kway_gains, kway_gains_csr
from repro_torch.kernels.kway_refine.ref import (kway_gains_csr_ref,
                                                 kway_gains_ref)
from repro_torch.core.partition_api import partition

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
    (2, 8, 64, 100, 60_000, 12),
    # the rows spread over blocks, each phase selected by its last block:
    # one phase; one row; R not a multiple of the rows a block holds
    # (4 at L = 512, 64 at L = 32); rows not 16-byte aligned (L % 4 != 0);
    # fringe widths around the register paths (16, 32) and past them
    (1, 16, 2048, 1, 64, 16), (4, 1, 2048, 1, 64, 8),
    (6, 13, 512, 1, 64, 20), (3, 70, 32, 1, 10, 40),
    (5, 16, 2047, 1, 64, 16), (3, 16, 33, 16, 64, 16),
    (4, 16, 2048, 16, 64, 16), (4, 16, 2048, 17, 64, 16),
    (4, 16, 2048, 33, 64, 16),
    # rank selection up to R + P = 256 slots, the block's rounds past it
    (2, 16, 128, 1, 240, 30), (2, 16, 128, 1, 241, 30),
    (2, 16, 512, 1, 300, 50)])
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


@pytest.mark.parametrize("G,L", [(32, 2048), (32, 128), (1, 512)])
def test_cuda_select_repeats_and_graph_replays_equal(G, L):
    """Two calls back to back, then a CUDA graph of one call replayed three
    times, all bit-equal to the first call: the per-phase ticket counters
    are left zero by every launch, with no memset between."""
    _need_card()
    rng = np.random.default_rng(L)
    nbrs = rng.integers(-1, 3 * L, size=(G, 16, L)).astype(np.int32)
    fringe = rng.integers(0, 3 * L, size=(G, 1)).astype(np.int32)
    bias = np.zeros((G, 16), np.float32)
    prev = rng.integers(0, L, size=(G, 64)).astype(np.float32)
    x = [torch.from_numpy(a).cuda() for a in (nbrs, fringe, bias, prev)]
    first = hype_score_select(*x, select_k=16)
    second = hype_score_select(*x, select_k=16)
    for a, b in zip(first, hype_score_select_ref(*x, 16)):
        assert torch.equal(a, b)
    for a, b in zip(second, first):
        assert torch.equal(a, b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        hype_score_select(*x, select_k=16)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = hype_score_select(*x, select_k=16)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(captured, first):
            assert torch.equal(a, b)


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
    (8, 128, 1), (4096, 512, 2048), (4096, 512, 7264), (2048, 512, 10_000),
    # either side of the lane-private counters' last k, and of the shared
    # counters' (past it, the global scratch)
    (4096, 512, 64), (4096, 512, 65), (4096, 512, 7257)])
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


def _csr_screen(k, ptr_dtype, seed=7):
    """A seeded screen on the card: mostly short rows, rows of 200-700
    and of 2,100-2,600 neighbours, vertices with none, parts at -1 and
    at k + 1 in the assignment, and -1 candidates among the real ones."""
    rng = np.random.default_rng(seed)
    n = 3000
    deg = rng.integers(0, 20, size=n)
    long_rows = rng.choice(n, size=25, replace=False)
    deg[long_rows[:5]] = rng.integers(2100, 2600, size=5)
    deg[long_rows[5:]] = rng.integers(200, 700, size=20)
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum(deg)
    indices = rng.integers(0, n, size=int(indptr[-1])).astype(np.int32)
    assign = rng.integers(0, k, size=n + 1).astype(np.int32)
    odd = rng.choice(n, size=40, replace=False)
    assign[odd[:20]] = -1
    assign[odd[20:]] = k + 1
    cand = np.full(300, -1, np.int32)
    cand[:280] = rng.choice(n, size=280, replace=False)
    cand[:25] = long_rows
    cand[25:28] = np.flatnonzero(deg == 0)[:3]
    cand[100] = -1
    return (torch.from_numpy(indptr).to(ptr_dtype).cuda(),
            *(torch.from_numpy(a).cuda() for a in (indices, assign, cand)))


@pytest.mark.parametrize("ptr_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("k", [2, 32, 64, 65, 2048, 7264, 10_000])
@pytest.mark.parametrize("tile_l", [32, 128, 512, 2048])
def test_cuda_kway_gains_csr_equal_plain_version(tile_l, k, ptr_dtype):
    """The screen's front end against its plain version on the card, bit
    for bit; two calls give the same bits, each one launch."""
    _need_card()
    x = _csr_screen(k, ptr_dtype)
    before = kway_gains_csr.launches
    got = kway_gains_csr(*x, tile_l=tile_l, k=k)
    again = kway_gains_csr(*x, tile_l=tile_l, k=k)
    torch.cuda.synchronize()
    assert kway_gains_csr.launches == before + 2
    assert torch.equal(got, kway_gains_csr_ref(*x, tile_l, k))
    assert torch.equal(again, got)


@pytest.mark.parametrize("ptr_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("k", [1, 32, 48, 65, 67, 10_000])
@pytest.mark.parametrize("tile_l", [32, 2048])
def test_cuda_kway_screen_with_delta_equal_plain_version(tile_l, k,
                                                         ptr_dtype):
    """The screen as one device program (the delta, then the gains'
    kernel as its programmatic dependent): the assignment and the gains
    bit-equal to the plain version's, eagerly and replayed in a CUDA
    graph; a delta of pads only changes no vertex. One launch counted a
    call."""
    _need_card()
    indptr, indices, assign, cand = _csr_screen(k, ptr_dtype)
    rng = np.random.default_rng(k + tile_l)
    movers = cand[:8].cpu().numpy()                # candidates that move
    ids = np.full(96, -1, np.int32)
    ids[:8] = movers
    ids[8:40] = rng.choice(np.setdiff1d(np.arange(3000), movers), size=32,
                           replace=False)          # the ids are unique
    vals = rng.integers(0, k, size=96).astype(np.int32)
    for d_ids in (ids, np.full(96, -1, np.int32)):
        delta = [torch.from_numpy(a).cuda() for a in (d_ids, vals)]
        cpu = [t.cpu() for t in (indptr, indices, assign, cand)]
        cpu_assign = cpu[2].clone()
        want = kway_gains_csr(cpu[0], cpu[1], cpu_assign, cpu[3],
                              tile_l=tile_l, k=k,
                              delta=[t.cpu() for t in delta])
        dev_assign = assign.clone()
        before = kway_gains_csr.launches
        got = kway_gains_csr(indptr, indices, dev_assign, cand,
                             tile_l=tile_l, k=k, delta=delta)
        torch.cuda.synchronize()
        assert kway_gains_csr.launches == before + 1
        assert torch.equal(got.cpu(), want)
        assert torch.equal(dev_assign.cpu()[:-1], cpu_assign[:-1])
        replay = assign.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            kway_gains_csr(indptr, indices, replay, cand, tile_l=tile_l,
                           k=k, delta=delta)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = kway_gains_csr(indptr, indices, replay, cand,
                                 tile_l=tile_l, k=k, delta=delta)
        replay.copy_(assign)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), want)
        assert torch.equal(replay.cpu()[:-1], cpu_assign[:-1])


@pytest.mark.parametrize("D", [1, 3, 33, 64, 70, 128, 130, 256, 600])
@pytest.mark.parametrize("hub", [0, 33, 1000])
def test_cuda_segment_sum_equals_plain_version(D, hub):
    """Row 5c's kernel at any D (16-, 8- and 4-byte rows, one pass or
    several), with a heavy id of ``hub`` edges or none, runs of empty ids
    and skipped edges: bit-equal to the plain version on the CPU, on a
    repeat, on rows only 8 or 4 bytes aligned, and replayed in a CUDA
    graph (the tickets left zeroed for the next launch)."""
    _need_card()
    from repro_torch.kernels.neighbor_agg import ops as nops
    rng = np.random.default_rng(D + hub)
    N = 5000
    ids = rng.integers(-1, N // 2, size=20_000).astype(np.int32)
    ids[ids == 7] = 8
    ids[rng.permutation(ids.size)[:hub]] = 7
    store = torch.randn((ids.size * D + 1,), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(D))
    ids = torch.from_numpy(ids).cuda()
    msgs = store[:-1].view(ids.shape[0], D)
    want = nops.segment_sum(msgs.cpu(), ids.cpu(), N)
    before = nops.segment_sum.launches
    got = nops.segment_sum(msgs, ids, N)
    again = nops.segment_sum(msgs, ids, N)
    torch.cuda.synchronize()
    assert nops.segment_sum.launches == before + 2
    assert torch.equal(got.cpu(), want) and torch.equal(again, got)
    # rows from a 4-byte offset: the narrower loads give the same bits
    shifted = store[1:].view(ids.shape[0], D)
    assert torch.equal(nops.segment_sum(shifted, ids, N).cpu(),
                       nops.segment_sum(shifted.cpu(), ids.cpu(), N))
    index = nops.segment_index(ids, N)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        nops.segment_sum(msgs, ids, N, index)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = nops.segment_sum(msgs, ids, N, index)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), want)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("combine", ["mean", "sum"])
@pytest.mark.parametrize("V,D,B,bag,kind", [
    (4096, 256, 2048, 8, "random"), (100, 33, 64, 5, "odd_d"),
    (50, 64, 40, 1, "bag1"), (300, 128, 17, 40, "wide_bag"),
    (200, 256, 64, 8, "all_pad"), (500, 256, 4000, 8, "hub")])
def test_cuda_embedding_bag_bwd_equals_plain_version(V, D, B, bag, kind,
                                                     combine, dtype):
    """The table's gradient (row 5b's kernel in its mean or sum mode) bit
    for bit against the plain version on the CPU, equal on a second
    launch, each launch counted once."""
    _need_card()
    from repro_torch.kernels.embedding_bag.ops import embedding_bag_bwd
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_bwd_ref
    rng = np.random.default_rng(V + D + bag)
    ids = rng.integers(-1, V, size=(B, bag)).astype(np.int32)
    if kind == "all_pad":
        ids[::2] = -1
    elif kind == "hub":
        ids[rng.random(ids.shape) < 0.5] = 3
    ids = torch.from_numpy(ids).cuda()
    g = torch.randn((B, D), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(B))
    before = embedding_bag_bwd.launches
    first = embedding_bag_bwd(g, ids, V, combine, dtype)
    again = embedding_bag_bwd(g, ids, V, combine, dtype)
    torch.cuda.synchronize()
    assert embedding_bag_bwd.launches == before + 2
    assert first.dtype == dtype and first.shape == (V, D)
    assert torch.equal(first, again)
    assert torch.equal(first.cpu(), embedding_bag_bwd_ref(
        g.cpu(), ids.cpu(), V, combine).to(dtype))


def test_cuda_twotower_grads_go_through_both_kernels():
    """value_and_grad of the reduced two-tower loss on the card: the
    EmbeddingBag kernel and its backward each launched once a tower, the
    loss and every gradient leaf close to the CPU run."""
    _need_card()
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import RecsysStream
    from repro_torch.kernels.embedding_bag.ops import embedding_bag_bwd
    from repro_torch.models import recsys
    from repro_torch.train.train_loop import value_and_grad
    from repro_torch.train.tree import tree_flatten, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("two-tower-retrieval").build_cfg(reduced=True)
    params = recsys.init_twotower_params(torch.Generator().manual_seed(0),
                                         cfg)
    b = RecsysStream(cfg.user_vocab, cfg.item_vocab, 64, n_fields=4,
                     bag=cfg.bag_size).batch_at(0)
    out = {}
    for dev in ("cpu", "cuda"):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        p = tree_map(lambda t: t.to(dev), params)
        before = (embedding_bag.launches, embedding_bag_bwd.launches)
        loss, grads = value_and_grad(
            lambda q, x: recsys.twotower_loss(q, x, cfg), p, batch)
        after = (embedding_bag.launches, embedding_bag_bwd.launches)
        assert (after[0] - before[0], after[1] - before[1]) == (
            (0, 0) if dev == "cpu" else (2, 2))
        out[dev] = (float(loss), [g.cpu() for g in tree_flatten(grads)])
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-5)
    for a, w in zip(out["cuda"][1], out["cpu"][1]):
        scale = float(w.abs().max())
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-5 * scale)


def test_cuda_serving_launches_no_backward():
    """score_batch under inference_mode: two forward launches, none of the
    backward."""
    _need_card()
    from repro_torch.configs import get_arch
    from repro_torch.kernels.embedding_bag.ops import embedding_bag_bwd
    from repro_torch.models import recsys
    cfg = get_arch("two-tower-retrieval").build_cfg(reduced=True)
    params = recsys.init_twotower_params(
        torch.Generator("cuda").manual_seed(0), cfg, "cuda")
    ids = torch.zeros((4, cfg.n_fields, cfg.bag_size), dtype=torch.int32,
                      device="cuda")
    before = (embedding_bag.launches, embedding_bag_bwd.launches)
    with torch.inference_mode():
        recsys.score_batch(params, {"user_ids": ids, "item_ids": ids}, cfg)
    assert (embedding_bag.launches - before[0],
            embedding_bag_bwd.launches - before[1]) == (2, 0)


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


# flash_attention_bwd on the card against its plain version (chip_smoke.py's
# BWD_TOL): both sum in float32, in other orders (tiles against einsum's
# blocks), and ds = p (dp - delta) cancels, so float32 agrees within rtol
# 1e-4 and atol 1e-4 of the call's largest |gradient| (of dq, dk and dv: a
# gradient that is zero in exact arithmetic, as dq and dk at S = 1, is
# float32 noise on both sides). In bf16 the tensor-core kernels (D <= 128)
# round P and dS to bf16 as the operands of dv = P^T dout, dk = scale dS^T q
# and dq = scale dS k: 2**-8 of each term at most, so each element may move
# by 2**-8 of A, the same product on absolute values
# (``attention_bwd_abs_ref``), beside one bf16 step of the result (rtol
# 2**-7) and that atol; the mean error stays under 2**-8 of the mean
# |gradient| (plus that atol), which a systematic fault would break.
def _assert_bwd_close(got, want, absp):
    f32 = got[0].dtype == torch.float32
    atol = 1e-4 * max(float(w.float().abs().max()) for w in want)
    for g, w, a in zip(got, want, absp):
        g, w = g.float(), w.float()
        if f32:
            torch.testing.assert_close(g, w, atol=atol, rtol=1e-4)
            continue
        limit = 2 ** -7 * w.abs() + 2 ** -8 * a + atol
        excess = float(((g - w).abs() - limit).max())
        assert excess <= 0.0, excess
        assert float((g - w).abs().mean()) <= 2 ** -8 * float(
            w.abs().mean()) + atol


def _bwd_inputs(B, S, Hq, Hkv, D, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(B, S, h, D)).astype(
        np.float32)).to(dtype).cuda() for h in (Hq, Hkv, Hkv, Hq)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal,window", [
    (2, 128, 4, 4, 64, True, None), (1, 256, 8, 2, 64, True, None),
    (2, 256, 4, 4, 32, True, 64), (1, 128, 2, 1, 128, True, None),
    (1, 128, 2, 2, 32, False, None), (2, 100, 4, 2, 80, True, None),
    (1, 300, 8, 2, 128, True, 100), (1, 70, 2, 1, 256, False, 33),
    (3, 1, 4, 4, 16, True, None), (1, 300, 4, 1, 64, True, 77),
    (2, 129, 4, 1, 128, False, None), (1, 200, 4, 2, 256, True, None),
    (1, 150, 4, 4, 192, True, None), (1, 333, 4, 2, 8, False, None)])
def test_cuda_flash_attention_bwd_close_to_plain_version(
        B, S, Hq, Hkv, D, causal, window, dtype):
    """dq, dk and dv of the card's backward within the limits above of
    ``attention_bwd_ref`` on the same inputs (the forward's own output and
    logsumexp)."""
    _need_card()
    _check_bwd_case(B, S, Hq, Hkv, D, causal, window, dtype)


def _check_bwd_case(B, S, Hq, Hkv, D, causal, window, dtype):
    from repro_torch.kernels.flash_attention import (attention_bwd_abs_ref,
                                                     attention_bwd_ref)
    from repro_torch.kernels.flash_attention import ops as fops
    q, k, v, dout = _bwd_inputs(B, S, Hq, Hkv, D, dtype, B + S + D)
    out, lse = fops.flash_attention(q, k, v, causal=causal, window=window,
                                    return_lse=True)
    before = fops.flash_attention_bwd.launches
    got = fops.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal,
                                   window=window)
    torch.cuda.synchronize()
    assert fops.flash_attention_bwd.launches == before + 1
    assert [t.shape for t in got] == [q.shape, k.shape, v.shape]
    assert all(t.dtype == dtype for t in got)
    kw = dict(causal=causal, window=window)
    want = attention_bwd_ref(q, k, v, out, dout, **kw)
    absp = attention_bwd_abs_ref(q, k, v, out, dout, **kw)
    _assert_bwd_close(got, want, absp)


@pytest.mark.parametrize("D", [16, 64, 80, 96, 128])
@pytest.mark.parametrize("B,S,Hq,Hkv,causal,window", [
    (2, 300, 8, 2, True, None), (1, 333, 4, 1, True, 100),
    (2, 257, 6, 3, False, 50), (3, 1, 4, 2, True, None),
    (1, 191, 4, 4, False, None)])
def test_cuda_flash_attention_bwd_tensor_cores(B, S, Hq, Hkv, causal,
                                               window, D):
    """The bf16 tensor-core backward (D <= 128, padded to 64, 96 or 128)
    with GQA, windows, ragged S and S = 1, within the limits above."""
    _need_card()
    _check_bwd_case(B, S, Hq, Hkv, D, causal, window, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal,window", [
    (2, 300, 8, 2, 80, True, None), (1, 333, 4, 1, 128, True, 100),
    (2, 129, 4, 4, 64, False, None), (3, 1, 4, 2, 16, True, None),
    (1, 200, 4, 2, 256, False, 33)])
def test_cuda_forward_lse_equals_plain_version(B, S, Hq, Hkv, D, causal,
                                               window, dtype):
    """The forward's logsumexp against ``attention_lse_ref`` (chip_smoke.py's
    LSE_TOL), and the same output as without it."""
    _need_card()
    from repro_torch.kernels.flash_attention import attention_lse_ref
    from repro_torch.kernels.flash_attention import ops as fops
    q, k, v, _ = _bwd_inputs(B, S, Hq, Hkv, D, dtype, S + D)
    out, lse = fops.flash_attention(q, k, v, causal=causal, window=window,
                                    return_lse=True)
    plain = fops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert torch.equal(out, plain)
    assert lse.dtype == torch.float32 and lse.shape == (B, Hq, S)
    torch.testing.assert_close(
        lse, attention_lse_ref(q, k, causal=causal, window=window),
        atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_bwd_repeats_bit_for_bit(dtype):
    """No atomics: the same inputs give the same bits, and autograd
    through the wrapper calls the backward kernel once."""
    _need_card()
    from repro_torch.kernels.flash_attention import ops as fops
    q, k, v, dout = _bwd_inputs(2, 333, 8, 2, 80, dtype, 3)
    out, lse = fops.flash_attention(q, k, v, window=100, return_lse=True)
    first = fops.flash_attention_bwd(q, k, v, out, dout, lse, window=100)
    again = fops.flash_attention_bwd(q, k, v, out, dout, lse, window=100)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = fops.flash_attention_bwd.launches
    o = fops.flash_attention(*leaves, window=100)
    grads = torch.autograd.grad(o, leaves, dout)
    assert fops.flash_attention_bwd.launches == before + 1
    for a, b in zip(grads, first):
        assert torch.equal(a, b)


def test_cuda_lm_grads_go_through_the_backward_kernel():
    """The reduced stablelm-3b's lm_loss on the card: every leaf's
    gradient is finite and nonzero (wq, wk, wv and the rest reach the
    loss only through the attention kernels), the forward kernel runs
    once a layer (twice under remat: the recompute) and the backward
    once a layer."""
    _need_card()
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import transformer as tf
    from repro_torch.train.train_loop import value_and_grad
    from repro_torch.train.tree import tree_flatten
    base = get_arch("stablelm-3b").build_cfg(reduced=True)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, base.vocab, (2, 2, 96)).astype(
        np.int32)).cuda()
    batch = {"tokens": toks[0], "labels": toks[1]}
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat)
        params = tf.init_params(torch.Generator("cuda").manual_seed(0), cfg,
                                "cuda")
        f0, b0 = fops.flash_attention.launches, \
            fops.flash_attention_bwd.launches
        loss, grads = value_and_grad(lambda p, b: tf.lm_loss(p, b, cfg),
                                     params, batch)
        torch.cuda.synchronize()
        assert fops.flash_attention.launches - f0 == \
            cfg.n_layers * (2 if remat else 1)
        assert fops.flash_attention_bwd.launches - b0 == cfg.n_layers
        assert bool(torch.isfinite(loss))
        for name in ("wq", "wk", "wv"):
            assert float(grads["layers"][name].float().norm()) > 0, name
        for g in tree_flatten(grads):
            assert bool(torch.isfinite(g.float()).all())
            assert float(g.float().norm()) > 0


def test_cuda_full_width_layer_backward_under_remat():
    """One stablelm-3b layer at its published width (d_model 2,560, 32
    heads of 80), S = 4,096, bf16, remat on, twice: the loss's gradients
    through the forward (twice a run) and backward kernels are finite and
    nonzero."""
    _need_card()
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import transformer as tf
    from repro_torch.train.train_loop import value_and_grad
    cfg = dataclasses.replace(get_arch("stablelm-3b").build_cfg(),
                              n_layers=1)
    assert cfg.remat and cfg.d_head == 80 and cfg.dtype == torch.bfloat16
    params = tf.init_params(torch.Generator("cuda").manual_seed(0), cfg,
                            "cuda")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 1, 4096)).astype(
        np.int32)).cuda()
    batch = {"tokens": toks[0], "labels": toks[1]}
    for _ in range(2):
        f0, b0 = fops.flash_attention.launches, \
            fops.flash_attention_bwd.launches
        loss, grads = value_and_grad(lambda p, b: tf.lm_loss(p, b, cfg),
                                     params, batch)
        torch.cuda.synchronize()
        assert fops.flash_attention.launches - f0 == 2
        assert fops.flash_attention_bwd.launches - b0 == 1
        assert bool(torch.isfinite(loss))
        for name, g in grads["layers"].items():
            assert bool(torch.isfinite(g.float()).all()), name
            assert float(g.float().norm()) > 0, name


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
@pytest.mark.parametrize("N,D,F,B,K,live", [
    (3000, 128, 128, 2000, 1340, 3),   # the launcher's K, 3 slots a row
    (3000, 128, 128, 2000, 1339, 3),   # K % 4 != 0: ids loaded one by one
    (300, 130, 66, 70, 25, 9),         # D % 4 != 0: one element a lane
    (64, 128, 128, 3, 25, 9),          # B smaller than one set of rows
    (5000, 128, 128, 700, 25, 25),     # bf16 x: a half-warp a row
    (500, 256, 128, 90, 40, 30)])      # a row wider than the lanes
def test_cuda_neighbor_agg_sparse_slots_close_to_plain_version(
        N, D, F, B, K, live, dtype):
    """The forward's compacted slot lists: ``live`` valid slots scattered
    among pads in every third row, all-pad rows between them, one row
    valid in every slot: the output within NA_TOL of the plain version,
    the mean bit-equal, and a second run equal."""
    _need_card()
    from repro_torch.kernels._build import load_extension
    from repro_torch.kernels.neighbor_agg import ref as nref
    rng = np.random.default_rng(N + D + K)
    x = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(D, F)) * 0.1).astype(np.float32))
    nbrs = np.full((B, K), -1, np.int32)
    for b in range(0, B, 3):
        pos = rng.choice(K, size=min(live, K), replace=False)
        nbrs[b, pos] = rng.integers(0, N, size=pos.size)
    nbrs[B // 2] = rng.integers(0, N, size=K)
    x, nbrs, w = x.to(dtype).cuda(), torch.from_numpy(nbrs).cuda(), w.cuda()
    out, mean = load_extension().neighbor_agg(x, nbrs, w, True)
    again, _ = load_extension().neighbor_agg(x, nbrs, w, False)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(),
                               nref.neighbor_agg_ref(x, nbrs, w).float(),
                               **NA_TOL[dtype])
    assert torch.equal(mean, nref.neighbor_mean_ref(x, nbrs)[0])
    assert torch.equal(out, again)


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


@pytest.mark.parametrize("lengths", [[3, 0, 5, 1, 32], [33, 0, 1000, 2],
                                     [0, 2049, 0, 64, 65]])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_cuda_neighbor_agg_csr_equals_plain_version(lengths, wdtype):
    """Row 5d on the card: its mean and its backward bit for bit against
    the plain versions on the CPU (the chunk order), the output within
    float32 rounding (the product's order), the same bits with the chunk
    units built ahead, one counted launch a call."""
    _need_card()
    from repro_torch.kernels._build import load_extension
    from repro_torch.kernels.neighbor_agg import ops as nops
    from repro_torch.kernels.neighbor_agg import ref as nref
    rng = np.random.default_rng(len(lengths))
    N, D, F = 300, 128, 64
    indptr = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(lengths)]).astype(np.int64))
    indices = torch.from_numpy(rng.integers(
        0, N, size=int(indptr[-1]) + 4).astype(np.int32))
    x = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(D, F)) * 0.1).astype(
        np.float32)).to(wdtype)
    before = nops.neighbor_agg_csr.launches
    out = nops.neighbor_agg_csr(x.cuda(), indptr.cuda(), indices.cuda(),
                                w.cuda())
    assert nops.neighbor_agg_csr.launches == before + 1
    ext = load_extension()
    again, mean = nops.launch_csr(x.cuda(), indptr.cuda(), indices.cuda(),
                                  w.cuda())
    want_mean, _ = nref.neighbor_mean_csr_ref(x, indptr, indices)
    assert torch.equal(mean.cpu(), want_mean)
    assert torch.equal(again, out)
    units = nops.chunk_units(indptr.cuda(), indices.shape[0])
    assert torch.equal(nops.neighbor_agg_csr(
        x.cuda(), indptr.cuda(), indices.cuda(), w.cuda(), units=units), out)
    torch.testing.assert_close(out.cpu(), nref.neighbor_agg_csr_ref(
        x, indptr, indices, w), atol=1e-5, rtol=1e-5)
    g = torch.randn((len(lengths), D), generator=torch.Generator()
                    .manual_seed(1))
    gx = ext.neighbor_agg_bwd(g.cuda(), *nops.csr_transpose_index(
        indptr.cuda(), indices.cuda(), N), False, True)
    assert torch.equal(gx.cpu(), nref.neighbor_agg_csr_bwd_ref(
        g, indptr, indices, N))


def test_cuda_graphsage_step_launches_two_forward_two_backward():
    """One training step of the reduced GraphSAGE on the card: each of the
    two layers launches the forward (row 5d, the CSR front end) once and
    the backward once; the loss agrees with the CPU run within float32
    rounding."""
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
        before = (nops.neighbor_agg_csr.launches,
                  nops.neighbor_agg_bwd.launches)
        loss, grads = value_and_grad(
            lambda q, bb: gnn.gnn_loss(q, bb, cfg), p, batch)
        after = (nops.neighbor_agg_csr.launches,
                 nops.neighbor_agg_bwd.launches)
        want = (0, 0) if dev == "cpu" else (2, 2)
        assert (after[0] - before[0], after[1] - before[1]) == want
        losses[dev] = float(loss)
    assert losses["cuda"] == pytest.approx(losses["cpu"], rel=1e-5)


# ------------------------------------------------ the device loop (hype_device)

_DEVICE_GOLD = {"pl600": (16, 8, "bbcd2f732e03af91"),     # test_hype_device.py
                "reddit": (32, 16, "13f232f653c9c752")}


def _device_graph(name):
    from repro_torch.data.synthetic import reddit_like
    if name == "pl600":
        return powerlaw_hypergraph(600, 400, seed=11, max_edge=30,
                                   max_degree=20)
    return reddit_like(scale=0.005, seed=0)


@pytest.mark.parametrize("chunk", [1, 7, 64])
@pytest.mark.parametrize("graph", sorted(_DEVICE_GOLD))
def test_cuda_device_loop_replays_equal_cpu_and_golden(graph, chunk):
    """The captured round replayed ``chunk`` times a chunk lands on the
    CPU run's bits and the golden; every replay launches score + select
    once, and each capture's warm-up round once more (reddit's planned
    capacities overflow twice, so three attempts capture)."""
    _need_card()
    from repro_torch.engines.device import DeviceParams, hype_device_partition
    from repro_torch.kernels.hype_score import ops
    k, t, want = _DEVICE_GOLD[graph]
    hg = _device_graph(graph)
    p = DeviceParams(seed=0, t=t, chunk_supersteps=chunk)
    before = ops.hype_score_select.launches
    a, st = hype_device_partition(hg, k, p, True, device="cuda")
    launched = ops.hype_score_select.launches - before
    cpu = hype_device_partition(hg, k, p, device="cpu")
    got = hashlib.sha256(a.astype(np.int32).tobytes()).hexdigest()[:16]
    assert got == want
    np.testing.assert_array_equal(a, cpu)
    assert st.graph_nodes > 0 and st.graph_replays >= st.supersteps
    assert st.graph_captures >= 1
    assert launched == st.graph_replays + st.graph_captures


def test_cuda_device_loop_two_runs_same_bits():
    _need_card()
    from repro_torch.engines.device import DeviceParams, hype_device_partition
    hg = _device_graph("reddit")
    p = DeviceParams(seed=0, t=16)
    a1, st1 = hype_device_partition(hg, 32, p, True, device="cuda")
    a2, st2 = hype_device_partition(hg, 32, p, True, device="cuda")
    np.testing.assert_array_equal(a1, a2)
    assert (st1.supersteps, st1.loop_rounds, st1.graph_nodes) == (
        st2.supersteps, st2.loop_rounds, st2.graph_nodes)


def test_cuda_device_loop_overflow_recaptures(monkeypatch):
    """A store too small for the run raises FLAG_STORE on the card; the
    rerun with the doubled store captures a new graph and lands on the
    golden."""
    _need_card()
    from repro_torch.core import device_loop
    from repro_torch.engines import device
    captures = []
    real = device_loop.DeviceLoop._capture

    def spy(self, dev):
        real(self, dev)
        captures.append(self.cfg.sp)

    monkeypatch.setattr(device_loop.DeviceLoop, "_capture", spy)
    a, st = device.hype_device_partition(
        _device_graph("pl600"), 16,
        device.DeviceParams(seed=0, t=8, store_cap=32), True, device="cuda")
    got = hashlib.sha256(a.astype(np.int32).tobytes()).hexdigest()[:16]
    assert got == _DEVICE_GOLD["pl600"][2]
    assert captures == [32, 64] and st.graph_captures == 2


def test_cuda_device_quality_matches_superstep_quality():
    _need_card()
    hg = _device_graph("pl600")
    a = partition(hg, 16, "hype_device", device="cuda", preset="quality")
    got = hashlib.sha256(a.astype(np.int32).tobytes()).hexdigest()[:16]
    assert got == "8356b306cfe516d5"    # JAX hype_superstep, preset quality


# ------------------------------------------- resilience on the card

def _pl600_t2_cpu():
    """pl600 at k=16, t=2 (19 supersteps, no capacity rerun) on the CPU."""
    from repro_torch.engines.device import DeviceParams, hype_device_partition
    return hype_device_partition(_device_graph("pl600"), 16,
                                 DeviceParams(seed=0, t=2), device="cpu")


def test_cuda_device_resume_across_captured_graph(tmp_path):
    """A hype_device run killed after its snapshots resumes on the card
    with a fresh capture: the snapshot's carry is uploaded before the
    capture, so the graph reads the restored tensors' addresses, and the
    run lands on the CPU run's bits with one launch a replay and a
    warm-up."""
    _need_card()
    from repro_torch.core import resilience
    from repro_torch.engines.device import DeviceParams, hype_device_partition
    from repro_torch.kernels.hype_score import ops
    hg = _device_graph("pl600")
    d = str(tmp_path)
    with pytest.raises(resilience.UnrecoverableFault):
        hype_device_partition(hg, 16, DeviceParams(
            seed=0, t=2, snapshot_every=4, snapshot_dir=d,
            fault_plan="dispatch@10:fatal"), device="cuda")
    before = ops.hype_score_select.launches
    a, st = hype_device_partition(hg, 16, DeviceParams(
        seed=0, t=2, snapshot_every=4, snapshot_dir=d, resume=d,
        fault_plan=resilience.FaultPlan()), True, device="cuda")
    launched = ops.hype_score_select.launches - before
    np.testing.assert_array_equal(a, _pl600_t2_cpu())
    assert st.resumed_at == 8 and st.supersteps == 19
    assert st.graph_captures == 1 and st.graph_replays >= 11
    assert launched == st.graph_replays + st.graph_captures


def test_cuda_device_poisoned_round_runs_off_the_graph():
    """An injected NaN tile: the rounds of its chunk before the poisoned
    superstep replay the graph, the poisoned one runs eagerly and scores
    twice (its replay), and the run keeps the CPU run's bits."""
    _need_card()
    from repro_torch.engines.device import DeviceParams, hype_device_partition
    from repro_torch.kernels.hype_score import ops
    before = ops.hype_score_select.launches
    a, st = hype_device_partition(_device_graph("pl600"), 16, DeviceParams(
        seed=0, t=2, fault_plan="nan@5"), True, device="cuda")
    launched = ops.hype_score_select.launches - before
    np.testing.assert_array_equal(a, _pl600_t2_cpu())
    assert (st.faults_injected, st.retries) == (1, 1)
    assert st.graph_captures == 1 and st.graph_off_rounds >= 1
    assert launched == (st.graph_replays + st.graph_captures
                        + st.graph_off_rounds + 1)


def test_cuda_batched_nan_quarantine_is_exact():
    """A NaN-poisoned hype_scores tile on the card is rescored on the
    host, bit-equal to the clean run (and to the CPU's)."""
    _need_card()
    from repro_torch.engines.batched import (BatchedParams,
                                             hype_batched_partition)
    from repro_torch.kernels.hype_score import ops
    hg = _device_graph("pl600")
    base, s0 = hype_batched_partition(hg, 16, BatchedParams(seed=0), True,
                                      device="cuda")
    before = ops.hype_scores.launches
    a, st = hype_batched_partition(hg, 16, BatchedParams(
        seed=0, fault_plan="nan@2"), True, device="cuda")
    assert ops.hype_scores.launches - before == st.kernel_calls > 0
    np.testing.assert_array_equal(a, base)
    np.testing.assert_array_equal(a, hype_batched_partition(
        hg, 16, BatchedParams(seed=0), device="cpu"))
    assert st.faults_injected == 1 and st.host_rows > s0.host_rows


# ------------------------------------------------ memory rungs on the card

def _digest(a) -> str:
    return hashlib.sha256(np.asarray(a, dtype=np.int32).tobytes()
                          ).hexdigest()[:16]


def test_cuda_select_pad_phase_equals_plain_version():
    """The chunked rung's last chunk at k = 5 in chunks of 3: a phase of
    -1 rows, -1 fringe, +inf bias and +inf held scores selects SELECT_PAD
    in every slot, bit-equal to the plain version."""
    _need_card()
    rng = np.random.default_rng(5)
    G, R, L, P, k = 3, 8, 2048, 64, 8
    nbrs = rng.integers(-1, 3 * L, size=(G, R, L)).astype(np.int32)
    fringe = np.full((G, 1), -1, np.int32)
    bias = np.zeros((G, R), np.float32)
    prev = rng.integers(0, L, size=(G, P)).astype(np.float32)
    nbrs[-1], bias[-1], prev[-1] = -1, np.inf, np.inf
    x = [torch.from_numpy(a).cuda() for a in (nbrs, fringe, bias, prev)]
    got = hype_score_select(*x, select_k=k)
    want = hype_score_select_ref(*[t.cpu() for t in x], k)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert bool((want[2][-1] == SELECT_PAD).all())


@pytest.mark.parametrize("rung", [1, 4, 5])
def test_cuda_forced_rung_equals_cpu(rung):
    """The chunked (k = 5: a pad phase in the last chunk), spill and paged
    programs on the card: the CPU run's bits, with one score + select
    launch a phase chunk. 16 rows a phase and t = 4, so the select ranks
    real scores and the held pool serves cached ones."""
    _need_card()
    from repro_torch.engines import superstep
    from repro_torch.kernels.hype_score import ops
    hg = _device_graph("pl600")
    p = superstep.SuperstepParams(seed=0, t=4, rows=16)
    before = ops.hype_score_select.launches
    a, st = superstep.run_pipeline(hg, 5, p, device="cuda", mem_rung=rung)
    launched = ops.hype_score_select.launches - before
    cpu, cst = superstep.run_pipeline(hg, 5, p, device="cpu", mem_rung=rung)
    np.testing.assert_array_equal(a, cpu)
    assert st.stats.plan_rung == rung
    assert launched == st.g_chunk * st.stats.supersteps
    assert (st.stats.page_uploads, st.stats.page_hits,
            st.stats.page_evictions, st.stats.page_bytes) == (
        cst.stats.page_uploads, cst.stats.page_hits,
        cst.stats.page_evictions, cst.stats.page_bytes)


def _fail_once(real, when=lambda: True):
    """``real`` that first allocates 1 TiB on the card (a real
    ``torch.OutOfMemoryError`` from the caching allocator) when
    ``when()``."""
    tried = []

    def failing(*args, **kw):
        if not tried and when():
            tried.append(True)
            torch.empty(1 << 40, dtype=torch.uint8, device="cuda")
        return real(*args, **kw)

    failing.tried = tried
    return failing


def test_cuda_real_oom_at_upload_recovers_and_releases(monkeypatch):
    """A real allocator failure at the image upload of hype_superstep:
    one retry at rung 1, the clean run's bits, and the card's memory back
    at its level before the run but for the memoized CSR image."""
    _need_card()
    import gc
    from repro_torch.core.hypergraph import Hypergraph
    hg = _device_graph("pl600")
    clean = partition(hg, 5, "hype_superstep", device="cpu", t=8)
    failing = _fail_once(Hypergraph.device_adjacency)
    monkeypatch.setattr(Hypergraph, "device_adjacency", failing)
    gc.collect()
    before = torch.cuda.memory_allocated()
    from repro_torch.engines import superstep
    a, st = superstep.hype_superstep_partition(
        hg, 5, superstep.SuperstepParams(seed=0, t=8), True, device="cuda")
    gc.collect()
    after = torch.cuda.memory_allocated()
    image = sum(t.nbytes for t in hg.device_adjacency("cuda"))
    assert failing.tried
    np.testing.assert_array_equal(a, clean)
    assert (st.mem_retries, st.plan_rung, st.fallbacks) == (1, 1, 0)
    assert after - before <= image + (1 << 20)


def test_cuda_real_oom_in_capture_falls_down_the_rungs(monkeypatch):
    """A real allocator failure inside hype_device's CUDA graph capture:
    the capture ends, the run falls down the host pipeline's rungs from
    rung 1 at depth 1 (no partial: the golden schedule), the card's memory
    is released, and a clean hype_device afterwards captures again and
    lands on the golden."""
    _need_card()
    import gc
    from repro_torch.core import device_loop
    from repro_torch.engines.device import DeviceParams, hype_device_partition
    hg = _device_graph("pl600")
    k, t, want = _DEVICE_GOLD["pl600"]
    hype_device_partition(hg, k, DeviceParams(seed=0, t=t), device="cuda")
    failing = _fail_once(device_loop.DeviceLoop._step,
                         torch.cuda.is_current_stream_capturing)
    monkeypatch.setattr(device_loop.DeviceLoop, "_step", failing)
    gc.collect()
    before = torch.cuda.memory_allocated()
    a, st = hype_device_partition(hg, k, DeviceParams(seed=0, t=t), True,
                                  device="cuda")
    gc.collect()
    after = torch.cuda.memory_allocated()
    assert failing.tried
    assert _digest(a) == want
    assert (st.mem_retries, st.plan_rung, st.fallbacks) == (1, 1, 1)
    assert after - before <= 1 << 20
    monkeypatch.undo()
    a, st = hype_device_partition(hg, k, DeviceParams(seed=0, t=t), True,
                                  device="cuda")
    assert _digest(a) == want and st.graph_captures == 1
    assert st.fallbacks == 0


def _commit_inputs(seed, k, mb, le, bits=16, kind="random"):
    """Seeded stream_commit inputs on the card: pads anywhere in a row, a
    pad row at the end, sketch entries in about 30% of the buckets;
    ``kind`` forces ties (no fringe or balance term, an empty sketch),
    partitions at their cap (all but the last, or all), all-pad rows,
    duplicate buckets (16 buckets), the stream's own rows (1-3 leading
    pins, about 30% of the valid rows with none: ``path``), rows that
    repeat the ids of the rows before them over an empty sketch
    (``chain``), valid rows with no pin (``nopins``), every slot a pin
    (``wide``: past the staged table's room at mb * Le > 4,096) or
    sketch entries below 0 (``negative``). Past 16 bits the sketch holds
    entries only in the tile's buckets (it would not fit otherwise)."""
    rng = np.random.default_rng(seed)
    if kind == "dup":
        bits = 4
    edge = rng.integers(0, 200_000, size=(mb, le)).astype(np.int32)
    if kind != "wide":
        edge[rng.random((mb, le)) < 0.3] = -1
    if kind in ("path", "chain", "nopins"):
        edge[:] = -1
        pool = rng.integers(0, 200_000, size=6)
        for i in range(mb if kind != "nopins" else 0):
            n = int(rng.integers(1, min(3, le) + 1))
            if kind == "chain":
                edge[i, :n] = rng.choice(pool, size=n)
            elif rng.random() >= 0.3:
                edge[i, :n] = rng.integers(0, 200_000, size=n)
    fcnt = rng.integers(0, 5, size=(mb, k)).astype(np.float32)
    if bits <= 16:
        sketch = (rng.integers(1, 3, size=(k, 1 << bits))
                  * (rng.random((k, 1 << bits)) < 0.3)).astype(np.int32)
    else:
        sketch = np.zeros((k, 1 << bits), np.int32)
        ids = edge[edge >= 0].astype(np.uint32)
        b = (ids * np.uint32(2654435761)) >> np.uint32(32 - bits)
        hit = rng.random((k, b.size)) < 0.3
        sketch[np.nonzero(hit)[0], b[np.nonzero(hit)[1]]] = 1
    if kind == "negative":
        sketch[rng.random(sketch.shape) < 0.2] = -1
    cap = 5 * mb + 3
    sizes = rng.integers(0, cap, size=k).astype(np.int32)
    valid = np.ones(mb, bool)
    valid[-1] = mb == 1 or kind == "nopins"
    alpha, fw = 1.0, 0.5
    if kind in ("ties", "chain"):
        sketch[:] = 0
    if kind == "ties":
        alpha, fw = 0.0, 0.0
    elif kind == "cap":
        sizes[:-1] = cap
    elif kind == "full":
        sizes[:] = cap
    elif kind == "pad":
        edge[:] = -1
        valid[:] = False
    x = [torch.from_numpy(a).cuda() for a in (edge, fcnt, valid, sketch,
                                               sizes)]
    kw = dict(alpha=alpha, fringe_w=fw, inv_target=float(
        np.float32(k / 177_386)), cap=cap, sketch_bits=bits)
    return x, kw


@pytest.mark.parametrize("mb", [1, 7, 64])
@pytest.mark.parametrize("le", [32, 128, 512, 2048])
@pytest.mark.parametrize("k", [1, 2, 32, 67, 300])
def test_cuda_stream_commit_equals_plain_version(k, le, mb):
    _need_card()
    _check_commit(*_commit_inputs(k * 1000 + le + mb, k, mb, le))


@pytest.mark.parametrize("kind", ["ties", "cap", "full", "pad", "dup"])
@pytest.mark.parametrize("k", [3, 32])
def test_cuda_stream_commit_edge_cases_equal_plain_version(k, kind):
    _need_card()
    _check_commit(*_commit_inputs(k, k, 64, 128, kind=kind))


@pytest.mark.parametrize("le", [32, 2048])
@pytest.mark.parametrize("kind", ["path", "chain", "nopins"])
@pytest.mark.parametrize("k", [32, 33, 64, 65])
def test_cuda_stream_commit_path_kinds_equal_plain_version(k, kind, le):
    """The staged branch on the stream's kinds of rows, at the pass's
    narrowest tile and the widened one, and past one word of partitions
    (k > 32, > 64)."""
    _need_card()
    _check_commit(*_commit_inputs(k + le, k, 64, le, kind=kind),
                  branch=1)


@pytest.mark.parametrize("kind,k,le,branch", [
    ("wide", 3, 256, 2), ("wide", 32, 256, 2), ("wide", 256, 2048, 2),
    ("wide", 300, 256, 0),
    ("negative", 3, 32, 1), ("negative", 32, 32, 1),
    ("negative", 300, 32, 0), ("path", 257, 32, 0)])
def test_cuda_stream_commit_second_branch_equals_plain_version(kind, k, le,
                                                               branch):
    """The row chain: more pins than the staged table's room (handed over
    inside the staged kernel), k past 256 (chosen by the launcher), and a
    sketch entry below 0, which the staged kernel hands over too."""
    _need_card()
    _check_commit(*_commit_inputs(k * 7 + le, k, 64, le, kind=kind),
                  branch=branch)


@pytest.mark.parametrize("kind", ["random", "path", "chain"])
@pytest.mark.parametrize("k", [1, 5, 8])
def test_cuda_stream_commit_24_bits_equals_plain_version(k, kind):
    _need_card()
    _check_commit(*_commit_inputs(k, k, 64, 32, bits=24, kind=kind))


def _check_commit(x, kw, branch=None):
    """The kernel on clones of the inputs against the plain version:
    parts, sketch and sizes bit for bit, one launch counted; where given,
    the branch the launcher reports for the shape and the valid rows'
    pins (0 the row chain, 1 staged, 2 the staged kernel handing the
    launch to the row chain)."""
    from repro_torch.kernels._build import load_extension
    got = [t.clone() for t in x]
    before = stream_commit.launches
    parts = stream_commit(*got, **kw)
    torch.cuda.synchronize()
    assert stream_commit.launches == before + 1
    want = [t.clone() for t in x]
    want_parts = stream_commit_ref(*want, **kw)
    assert torch.equal(parts, want_parts)
    assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
    if branch is not None:
        edge, _, valid, sketch, _ = x
        pins = int(((edge >= 0) & valid[:, None]).sum())
        assert load_extension().stream_commit_branch(
            *edge.shape, sketch.shape[0], pins) == branch


def test_cuda_stream_equals_cpu_and_counts_launches():
    """The stream on the card: the CPU run's assignment, sketch and
    counters, one row 1 and one stream_commit launch a micro-batch."""
    _need_card()
    import dataclasses
    from repro_torch.core.hype_stream import (StreamParams,
                                              hype_stream_partition,
                                              recompute_sketch)
    hg = powerlaw_hypergraph(400, 300, seed=5, max_edge=14, max_degree=12)
    p = StreamParams(micro_batch=16, seed=3)
    _, cpu = hype_stream_partition(hg, 5, p, return_state=True,
                                   device="cpu")
    before = (hype_score_select.launches, stream_commit.launches)
    a, card = hype_stream_partition(hg, 5, p, return_state=True,
                                    device="cuda")
    batches = card.stats.micro_batches
    assert (hype_score_select.launches - before[0],
            stream_commit.launches - before[1]) == (batches, batches)
    np.testing.assert_array_equal(a, cpu.assignment)
    assert card.sketch_digest() == cpu.sketch_digest()
    sk, _ = recompute_sketch(hg, a, 5, p.sketch_bits)
    np.testing.assert_array_equal(card.sketch, sk)
    timing = {"stream_s", "vertices_per_s", "snapshot_s", "restore_s",
              "update_s", "updates_per_s"}
    counters = [{key: val for key, val in dataclasses.asdict(s.stats).items()
                 if key not in timing} for s in (card, cpu)]
    assert counters[0] == counters[1]


def test_cuda_apply_updates_equals_cpu():
    """apply_updates on the card's state: the CPU state's assignment,
    sketch and counters after the same mixed log."""
    _need_card()
    import copy
    from repro_torch.core.hype_stream import (StreamParams, apply_updates,
                                              hype_stream_partition,
                                              recompute_sketch)
    hg = powerlaw_hypergraph(400, 300, seed=5, max_edge=14, max_degree=12)
    ops = [("remove_vertex", 7), ("remove_edge", 3), ("add_edge", [1, 2, 10]),
           ("add_vertex", [0, 4]), ("add_vertex", []),
           ("remove_vertex", 250)]
    states = []
    for device in ("cpu", "cuda"):
        _, st = hype_stream_partition(hg, 4, StreamParams(micro_batch=8),
                                      return_state=True, device=device)
        states.append(apply_updates(copy.deepcopy(st), ops))
    cpu, card = states
    assert card.device.type == "cuda"
    np.testing.assert_array_equal(card.assignment, cpu.assignment)
    assert card.sketch_digest() == cpu.sketch_digest()
    assert card.stats.readmitted == cpu.stats.readmitted == 2
    sk, sz = recompute_sketch(card.hg, card.assignment, 4, 16)
    np.testing.assert_array_equal(card.sketch, sk)
    np.testing.assert_array_equal(card.sizes, sz)


@pytest.mark.parametrize("off,gl", [(0, 8), (8, 8), (24, 8), (0, 32)])
def test_cuda_score_select_shard_equals_plain_version(off, gl):
    """The sharded engine's per-shard call on the card, bit for bit: the
    phase group's slices of the global fringe, bias and held scores."""
    _need_card()
    from repro_torch.kernels.hype_score.ops import hype_score_select_shard
    from repro_torch.kernels.hype_score.ref import (
        hype_score_select_shard_ref)
    rng = np.random.default_rng(off + gl)
    G, R, L, P, t = 32, 16, 512, 64, 16
    nbrs = rng.integers(-1, 3 * L, size=(gl, R, L)).astype(np.int32)
    fringe = np.full((G, 1), -1, np.int32)
    bias = np.where(rng.random((G, R)) < 0.1, np.inf,
                    0.0).astype(np.float32)
    prev = np.where(rng.random((G, P)) < 0.5, rng.integers(0, 40, (G, P)),
                    np.inf).astype(np.float32)
    cpu = [torch.from_numpy(x) for x in (nbrs, fringe, bias, prev)]
    want = hype_score_select_shard_ref(*cpu, t, off)
    before = hype_score_select.launches
    got = hype_score_select_shard(*(x.cuda() for x in cpu), select_k=t,
                                  shard_offset=off)
    assert hype_score_select.launches - before == 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


@pytest.mark.parametrize("depth", [1, 2])
def test_cuda_sharded_one_rank_equals_cpu(depth):
    """hype_sharded at one rank on the card: the CPU run's bits and
    counters, one score + select launch a superstep."""
    _need_card()
    from repro_torch.engines.sharded import (ShardedParams,
                                             hype_sharded_partition,
                                             run_counters)
    hg = powerlaw_hypergraph(600, 400, seed=11, max_edge=30, max_degree=20)
    p = ShardedParams(seed=0, pipeline_depth=depth)
    a_cpu, s_cpu = hype_sharded_partition(hg, 16, p, True, device="cpu")
    before = hype_score_select.launches
    a, st = hype_sharded_partition(hg, 16, p, True, device="cuda")
    assert hype_score_select.launches - before == st.supersteps
    np.testing.assert_array_equal(a, a_cpu)
    assert run_counters(st) == run_counters(s_cpu)


def test_cuda_sharded_two_ranks_share_the_card():
    """Two gloo ranks on the one card (the payload staged through the
    host): the CPU ranks' bits and counters, each rank launching row 1
    once a superstep."""
    _need_card()
    from repro_torch.engines.sharded import (RankPool, ShardedParams,
                                             partition_rank, run_counters)
    hg = powerlaw_hypergraph(600, 400, seed=11, max_edge=30, max_degree=20)
    p = ShardedParams(seed=0)
    with RankPool(2, timeout_s=300) as pool:
        card = pool.run(partition_rank, hg, 16, p, "cuda")
        cpu = pool.run(partition_rank, hg, 16, p, "cpu")
    for (a, st, launches), (a_cpu, s_cpu, _) in zip(card, cpu):
        np.testing.assert_array_equal(a, a_cpu)
        assert run_counters(st) == run_counters(s_cpu)
        assert launches == st.supersteps and st.admission_conflicts > 0
    assert _digest(card[0][0]) == "edef050f7f15fe8d"    # JAX's at d2


@pytest.mark.parametrize("method,digest", [
    ("hype_jax", "3e750d64db36cd14"), ("hype_parallel", "ca54abcebd06a7d4")])
def test_cuda_padded_engines_equal_cpu(method, digest):
    """hype_jax and hype_parallel on the card: the CPU run's bits (JAX's
    pl300 digest at k = 8), with no kernel launched."""
    _need_card()
    hg = powerlaw_hypergraph(300, 200, seed=3, max_edge=20, max_degree=12)
    before = (hype_score_select.launches, hype_scores.launches)
    a = partition(hg, 8, method, device="cuda")
    assert (hype_score_select.launches, hype_scores.launches) == before
    np.testing.assert_array_equal(a, partition(hg, 8, method, device="cpu"))
    assert _digest(a) == digest
