"""Row 5d, the neighbour aggregation over a CSR (``neighbor_agg_csr``),
on the CPU route: its plain version against the JAX package's kernel.

The same function as ``neighbor_agg`` with row b's neighbours
``indices[indptr[b]:indptr[b + 1]]`` in place of the -1-padded row b of
an (N, K) matrix. Padded inputs from one numpy seed are turned into a
CSR and held within 1e-5 of the JAX Pallas kernel in interpret mode (as
tests/test_kernels.py runs it on the CPU). The mean is held bit for bit:
to row 5's ``neighbor_mean_ref`` on rows of at most 32 slots, and to a
hand-written loop in the chunk order (chunks of 32 summed from 0, the
partials in chunk order) on longer rows, the order the card's kernels
keep. The backward is held bit for bit to row 5's on the padded matrix,
and by ``torch.autograd.gradcheck`` in float64.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.neighbor_agg.ops import neighbor_agg as jax_neighbor_agg
from repro_torch.kernels.neighbor_agg import ops, ref

TOL = dict(atol=1e-5, rtol=1e-5)
# the shapes of tests/test_torch_neighbor_agg.py (N, D, F, B, K)
SHAPES = [(64, 32, 16, 8, 4), (200, 128, 64, 16, 10), (30, 16, 8, 4, 15),
          (50, 33, 7, 9, 1), (40, 5, 3, 6, 3), (300, 128, 128, 64, 25),
          (20, 8, 70, 3, 40)]


def padded(N, D, F, B, K, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D)).astype(np.float32)
    w = (rng.normal(size=(D, F)) * 0.1).astype(np.float32)
    nbrs = rng.integers(-1, N, size=(B, K)).astype(np.int32)
    return x, nbrs, w


def to_csr(nbrs, extra=0):
    """The CSR of a padded matrix: each row's valid ids in slot order;
    ``extra`` unread entries after ``indptr[B]``."""
    valid = nbrs >= 0
    indptr = np.concatenate([[0], np.cumsum(valid.sum(1))]).astype(np.int64)
    indices = np.concatenate([nbrs[valid], np.full(extra, 7, np.int32)])
    return torch.from_numpy(indptr), torch.from_numpy(
        indices.astype(np.int32))


def hub_csr(N, lengths, seed=0):
    """A CSR whose rows have the given numbers of slots."""
    rng = np.random.default_rng(seed)
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    indices = rng.integers(0, N, size=int(indptr[-1])).astype(np.int32)
    return torch.from_numpy(indptr), torch.from_numpy(indices)


def chunk_loop_mean(x, indptr, indices):
    """The mean in the chunk order, one float32 add at a time in numpy."""
    B = indptr.size - 1
    out = np.zeros((B, x.shape[1]), np.float32)
    for b in range(B):
        ids = indices[indptr[b]:indptr[b + 1]]
        total = np.zeros(x.shape[1], np.float32)
        for c in range(0, ids.size, ref.CHUNK):
            part = np.zeros(x.shape[1], np.float32)
            for i in ids[c:c + ref.CHUNK]:
                part = part + x[i]
            total = total + part
        out[b] = total / np.float32(max(ids.size, 1))
    return out


@pytest.mark.parametrize("N,D,F,B,K", SHAPES)
def test_plain_version_equals_jax_kernel(N, D, F, B, K):
    x, nbrs, w = padded(N, D, F, B, K)
    nbrs[0] = -1                                   # a row with no slot
    want = np.asarray(jax_neighbor_agg(jnp.asarray(x), jnp.asarray(nbrs),
                                       jnp.asarray(w)))
    indptr, indices = to_csr(nbrs, extra=5)
    got = ops.neighbor_agg_csr(torch.from_numpy(x), indptr, indices,
                               torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == (B, F)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not got[0].any()


@pytest.mark.parametrize("N,D,F,B,K", SHAPES)
def test_short_rows_mean_bit_equal_to_row_5(N, D, F, B, K):
    """A row of at most 32 slots adds them in slot order from 0: row 5d's
    mean equals row 5's bit for bit, and so do the outputs (the same
    matmul of the same means)."""
    x, nbrs, w = padded(N, D, F, B, K, seed=1)
    nbrs[:, ref.CHUNK:] = -1                       # at most 32 valid slots
    indptr, indices = to_csr(nbrs)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    mean, count = ref.neighbor_mean_csr_ref(xt, indptr, indices)
    want, want_count = ref.neighbor_mean_ref(xt, torch.from_numpy(nbrs))
    assert torch.equal(mean, want)
    assert torch.equal(count, want_count.long())
    assert torch.equal(ops.neighbor_agg_csr(xt, indptr, indices, wt),
                       ops.neighbor_agg(xt, torch.from_numpy(nbrs), wt))


@pytest.mark.parametrize("lengths", [
    [33, 0, 64, 1, 65, 31, 32],
    [1000, 3, 0, 257],
    [1234],
    [0, 0, 2049, 0]])
def test_hub_rows_equal_the_chunk_order_loop(lengths):
    x = np.random.default_rng(4).normal(size=(90, 12)).astype(np.float32)
    indptr, indices = hub_csr(90, lengths, seed=len(lengths))
    mean, _ = ref.neighbor_mean_csr_ref(torch.from_numpy(x), indptr,
                                        indices)
    want = chunk_loop_mean(x, indptr.numpy(), indices.numpy())
    assert np.array_equal(mean.numpy(), want)


def test_long_rows_differ_from_one_serial_sum():
    """Past 32 slots the chunk order is not one serial sum: the two give
    other bits on a hub row (so the bit checks above see the order)."""
    x = np.random.default_rng(5).normal(size=(500, 16)).astype(np.float32)
    indptr, indices = hub_csr(500, [1000], seed=5)
    mean, _ = ref.neighbor_mean_csr_ref(torch.from_numpy(x), indptr,
                                        indices)
    serial, _ = ref.neighbor_mean_ref(torch.from_numpy(x),
                                      indices[None, :])
    assert not torch.equal(mean, serial)
    np.testing.assert_allclose(mean.numpy(), serial.numpy(), **TOL)


def test_empty_rows_and_an_empty_csr_give_zeros():
    x = torch.randn(10, 6, generator=torch.Generator().manual_seed(0))
    w = torch.randn(6, 5, generator=torch.Generator().manual_seed(1))
    indptr = torch.tensor([0, 0, 3, 3, 3], dtype=torch.int64)
    indices = torch.tensor([4, 4, 9, 0], dtype=torch.int32)
    out = ops.neighbor_agg_csr(x, indptr, indices, w)
    assert not out[[0, 2, 3]].any()
    torch.testing.assert_close(out[1], ((2 * x[4] + x[9]) / 3) @ w)
    none = ops.neighbor_agg_csr(x, torch.zeros(4, dtype=torch.int64),
                                torch.zeros(0, dtype=torch.int32), w)
    assert none.shape == (3, 5) and not none.any()


@pytest.mark.parametrize("lengths", [[3, 0, 5, 1], [40, 2, 0, 70]])
def test_gradcheck_float64(lengths):
    gen = torch.Generator().manual_seed(len(lengths))
    x = torch.randn(15, 4, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    w = torch.randn(4, 3, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    indptr, indices = hub_csr(15, lengths, seed=3)
    assert torch.autograd.gradcheck(
        lambda a, b: ops.neighbor_agg_csr(a, indptr, indices, b), (x, w))


@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_backward_bit_equal_to_row_5_on_the_padded_matrix(wdtype):
    """Row 5d's gradients are row 5's on rows of at most 32 slots (the
    same means): grad_x the same chunk-order sum of the same slots (its
    index or none), grad_w the same product."""
    x, nbrs, w = padded(200, 16, 8, 150, 30, seed=6)
    nbrs[:, 0] = 11                                # id 11 in 150 slots
    indptr, indices = to_csr(nbrs, extra=3)
    grads = []
    for run in ("padded", "csr", "csr+index"):
        xt = torch.from_numpy(x).requires_grad_()
        wt = torch.from_numpy(w).to(wdtype).requires_grad_()
        if run == "padded":
            out = ops.neighbor_agg(xt, torch.from_numpy(nbrs), wt)
        else:
            index = ops.csr_transpose_index(indptr, indices, 200) \
                if run == "csr+index" else None
            out = ops.neighbor_agg_csr(xt, indptr, indices, wt, index)
        g = torch.randn(out.shape, generator=torch.Generator().manual_seed(9))
        out.backward(g.to(out.dtype))
        grads.append((xt.grad, wt.grad))
    for gx, gw in grads[1:]:
        assert torch.equal(gx, grads[0][0])
        assert gw.dtype == wdtype and torch.equal(gw, grads[0][1])


def test_plain_backward_equals_row_5s_plain_backward():
    x, nbrs, w = padded(100, 8, 4, 300, 50, seed=8)
    nbrs[:, 0] = 5                                 # id 5 in 300 slots
    indptr, indices = to_csr(nbrs)
    g = torch.randn((300, 8), generator=torch.Generator().manual_seed(2))
    got = ref.neighbor_agg_csr_bwd_ref(g, indptr, indices, 100)
    want = ref.neighbor_agg_bwd_ref(g, torch.from_numpy(nbrs), 100)
    assert torch.equal(got, want)


@pytest.mark.parametrize("extra", [0, 9])
def test_csr_transpose_index_equals_transpose_index(extra):
    _, nbrs, _ = padded(120, 4, 4, 400, 30, seed=3)
    nbrs[:, :3] = 17                               # a hub id: 1,200 slots
    nbrs[5] = -1
    indptr, indices = to_csr(nbrs, extra=extra)
    got = ops.csr_transpose_index(indptr, indices, 120)
    want = ops.transpose_index(torch.from_numpy(nbrs), 120)
    assert torch.equal(got.cnt, want.cnt) and got.cnt.dtype == torch.int32
    assert torch.equal(got.rowptr, want.rowptr)
    n = int(got.rowptr[-1])
    assert torch.equal(got.rows[:n], want.rows)
    assert torch.equal(got.hptr, want.hptr)
    units = int(got.hptr[-1])
    assert units > 0
    assert torch.equal(got.hunit[:units], want.hunit[:units])


def test_wrapper_rejects_bad_inputs():
    x, w = torch.zeros(5, 4), torch.zeros(4, 3)
    indptr = torch.tensor([0, 1, 2], dtype=torch.int64)
    indices = torch.tensor([0, 1], dtype=torch.int32)
    f = ops.neighbor_agg_csr
    with pytest.raises(ValueError, match="indptr must be int64"):
        f(x, indptr.int(), indices, w)
    with pytest.raises(ValueError, match="int32"):
        f(x, indptr, indices.long(), w)
    with pytest.raises(ValueError, match="D = 4"):
        f(x, indptr, indices, torch.zeros(3, 3))
    with pytest.raises(ValueError, match="must be one of"):
        f(x.bfloat16(), indptr, indices, w)
    with pytest.raises(ValueError, match="takes x"):
        f(x, indptr[None], indices, w)
    with pytest.raises(ValueError, match="contiguous"):
        f(torch.zeros(4, 5).t(), indptr, indices, w)
    with pytest.raises(ValueError, match="B \\+ 1"):
        f(x, torch.zeros(0, dtype=torch.int64), indices, w)


@pytest.mark.parametrize("built", [False, True])
def test_cpu_tensors_never_launch(built):
    """No launch on CPU tensors, with the backward's index and the
    forward's chunk units built by the wrapper or handed to it (the same
    values and gradients either way)."""
    before = (ops.neighbor_agg_csr.launches, ops.neighbor_agg_bwd.launches)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(9, 4, generator=gen, requires_grad=True)
    w = torch.randn(4, 2, generator=gen, requires_grad=True)
    indptr, indices = hub_csr(9, [40, 1, 0], seed=1)
    extra = {}
    if built:
        extra = {"index": ops.csr_transpose_index(indptr, indices, 9),
                 "units": ops.chunk_units(indptr, indices.shape[0])}
    out = ops.neighbor_agg_csr(x, indptr, indices, w, **extra)
    out.sum().backward()
    assert (ops.neighbor_agg_csr.launches,
            ops.neighbor_agg_bwd.launches) == before
    assert torch.equal(out, ref.neighbor_agg_csr_ref(x, indptr, indices,
                                                      w))
    ones = torch.ones(3, 2)
    assert torch.equal(x.grad, ref.neighbor_agg_csr_bwd_ref(
        ones @ w.detach().t(), indptr, indices, 9))
    assert torch.equal(w.grad, ref.neighbor_mean_csr_ref(
        x.detach(), indptr, indices)[0].t() @ ones)


def test_epilogue_kernel_is_in_the_source_and_bound():
    """The card's route names a kernel of the checkout: the epilogue is
    in neighbor_agg.cu and bound by the extension."""
    import pathlib
    root = pathlib.Path(ops.__file__).resolve().parent.parent
    cu = (root / "neighbor_agg" / "csrc" / "neighbor_agg.cu").read_text()
    binding = (root / "hype_score" / "csrc" / "binding.cpp").read_text()
    assert "neighbor_agg_fin_kernel" in cu
    assert 'extern "C" cudaError_t neighbor_agg_fin_launch' in cu
    assert 'm.def("neighbor_agg_fin"' in binding
