"""The port's neighbour aggregation (CPU route: the plain version) against
the JAX package's.

``repro_torch.kernels.neighbor_agg`` on CPU tensors runs ``ref.py``,
the plain version the CUDA kernels are held against on the card. Here it
is held against the JAX Pallas kernel run as ``tests/test_kernels.py``
runs it on the CPU (interpret mode) and against ``neighbor_agg_ref``,
within 1e-5 in float32 (the plain version sums the valid rows in slot
order in float32, as the Pallas kernel does; the product with ``w`` is
one matmul in each, summed in a library order). Its backward, which the
JAX package lacks, is held against ``jax.grad`` of ``neighbor_agg_ref``
within 1e-5 and checked by ``torch.autograd.gradcheck`` in float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp_compat import given, settings, st

from repro.kernels.neighbor_agg.ops import neighbor_agg as jax_neighbor_agg
from repro.kernels.neighbor_agg.ref import neighbor_agg_ref as jax_ref
from repro_torch.kernels.neighbor_agg import ops, ref

TOL = dict(atol=1e-5, rtol=1e-5)


def inputs(N, D, F, B, K, seed=0, x_dtype=np.float32):
    """The inputs of tests/test_kernels.py:217-221, from one seed."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D)).astype(x_dtype)
    w = (rng.normal(size=(D, F)) * 0.1).astype(np.float32)
    nbrs = rng.integers(-1, N, size=(B, K)).astype(np.int32)
    return x, nbrs, w


def port(x, nbrs, w):
    return ops.neighbor_agg(torch.from_numpy(x), torch.from_numpy(nbrs),
                            torch.from_numpy(w)).numpy()


# the shapes of tests/test_kernels.py:213-215, then edge cases: K = 1,
# D and F not multiples of 4, one slot per row, a tall K
SHAPES = [(64, 32, 16, 8, 4), (200, 128, 64, 16, 10), (30, 16, 8, 4, 15),
          (50, 33, 7, 9, 1), (40, 5, 3, 6, 3), (300, 128, 128, 64, 25),
          (20, 8, 70, 3, 40)]


@pytest.mark.parametrize("N,D,F,B,K", SHAPES)
def test_plain_version_equals_jax_kernel(N, D, F, B, K):
    x, nbrs, w = inputs(N, D, F, B, K)
    want = np.asarray(jax_neighbor_agg(jnp.asarray(x), jnp.asarray(nbrs),
                                       jnp.asarray(w)))
    np.testing.assert_allclose(port(x, nbrs, w), want, **TOL)


@pytest.mark.parametrize("N,D,F,B,K", SHAPES)
def test_plain_version_equals_jax_ref(N, D, F, B, K):
    x, nbrs, w = inputs(N, D, F, B, K, seed=1)
    want = np.asarray(jax_ref(jnp.asarray(x), jnp.asarray(nbrs),
                              jnp.asarray(w)))
    np.testing.assert_allclose(port(x, nbrs, w), want, **TOL)


def test_all_pad_rows_ids_at_n_minus_1_and_duplicates():
    x, nbrs, w = inputs(17, 12, 6, 5, 6, seed=2)
    nbrs[0] = -1                       # an all-pad row: mean 0
    nbrs[1] = 16                       # every slot the last row, N - 1
    nbrs[2, :3] = [4, 4, -1]           # a duplicated id counts twice
    got = port(x, nbrs, w)
    want = np.asarray(jax_ref(jnp.asarray(x), jnp.asarray(nbrs),
                              jnp.asarray(w)))
    np.testing.assert_allclose(got, want, **TOL)
    assert np.array_equal(got[0], np.zeros(6, np.float32))
    np.testing.assert_allclose(got[1], x[16] @ w, **TOL)


def test_mean_is_slot_order_sum_then_one_division():
    """The plain mean is the float32 sum in slot order divided once: the
    bits the CUDA kernel reproduces."""
    x, nbrs, _ = inputs(40, 24, 4, 10, 9, seed=3)
    mean, cnt = ref.neighbor_mean_ref(torch.from_numpy(x),
                                      torch.from_numpy(nbrs))
    for b in range(10):
        acc = np.float32(0) * x[0]
        n = 0
        for j in range(9):
            if nbrs[b, j] >= 0:
                acc = acc + x[nbrs[b, j]]
                n += 1
        assert cnt[b] == n
        assert np.array_equal(mean[b].numpy(), acc / np.float32(max(n, 1)))


def test_bf16_x_rounds_once_to_bf16():
    x, nbrs, w = inputs(64, 32, 16, 8, 6, seed=4)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = ops.neighbor_agg(xb, torch.from_numpy(nbrs), torch.from_numpy(w))
    assert got.dtype == torch.bfloat16
    mean, _ = ref.neighbor_mean_ref(xb, torch.from_numpy(nbrs))
    want = (mean @ torch.from_numpy(w)).to(torch.bfloat16)
    assert torch.equal(got, want)
    # the float32 JAX kernel on the bf16-rounded inputs, within one bf16
    # step of the output (rtol 2**-7) plus the float32 difference
    jx = jnp.asarray(xb.float().numpy())
    jw = jnp.asarray(w)
    ref32 = np.asarray(jax_ref(jx, jnp.asarray(nbrs), jw))
    np.testing.assert_allclose(got.float().numpy(), ref32, rtol=2 ** -7,
                               atol=1e-5)


def test_wrapper_rejects_bad_inputs():
    x, nbrs, w = (torch.from_numpy(a) for a in inputs(8, 4, 2, 3, 2))
    with pytest.raises(ValueError, match="int32"):
        ops.neighbor_agg(x, nbrs.long(), w)
    with pytest.raises(ValueError, match="D = 4"):
        ops.neighbor_agg(x, nbrs, w.t().contiguous())
    with pytest.raises(ValueError, match="one of"):
        ops.neighbor_agg(x.half(), nbrs, w)
    with pytest.raises(ValueError, match="contiguous"):
        ops.neighbor_agg(torch.zeros(4, 8).t(), nbrs, w)


def test_cpu_tensors_never_launch():
    before = (ops.neighbor_agg.launches, ops.neighbor_agg_bwd.launches)
    x, nbrs, w = (torch.from_numpy(a) for a in inputs(8, 4, 2, 3, 2))
    x.requires_grad_(True)
    ops.neighbor_agg(x, nbrs, w).sum().backward()
    assert (ops.neighbor_agg.launches,
            ops.neighbor_agg_bwd.launches) == before


@given(st.integers(2, 50), st.integers(1, 8), st.integers(1, 12),
       st.integers(0, 50))
@settings(max_examples=10, deadline=None)
def test_plain_version_property(N, B, K, seed):
    x, nbrs, w = inputs(N, 16, 8, B, K, seed=seed)
    want = np.asarray(jax_ref(jnp.asarray(x), jnp.asarray(nbrs),
                              jnp.asarray(w)))
    np.testing.assert_allclose(port(x, nbrs, w), want, **TOL)


# ----------------------------------------------------------------- backward

def jax_grads(x, nbrs, w, gout):
    def f(x_, w_):
        return jnp.sum(jax_ref(x_, jnp.asarray(nbrs), w_) * gout)
    gx, gw = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    return np.asarray(gx), np.asarray(gw)


@pytest.mark.parametrize("N,D,F,B,K", SHAPES)
def test_backward_equals_jax_grad(N, D, F, B, K):
    x, nbrs, w = inputs(N, D, F, B, K, seed=5)
    gout = np.random.default_rng(6).normal(size=(B, F)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    out = ops.neighbor_agg(xt, torch.from_numpy(nbrs), wt)
    out.backward(torch.from_numpy(gout))
    gx, gw = jax_grads(x, nbrs, w, gout)
    np.testing.assert_allclose(xt.grad.numpy(), gx, **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), gw, **TOL)


def chunk_order_oracle(g, nbrs, n_rows):
    """numpy float32: each id's slots in (b, j) order, cut into chunks of
    CHUNK slots, each chunk summed in order from 0, the chunk partials
    added in chunk order from 0 (the order of ref.py and the kernel)."""
    B, K = nbrs.shape
    cnt = np.maximum((nbrs >= 0).sum(1), 1).astype(np.float32)
    slots = [[] for _ in range(n_rows)]
    for b in range(B):
        for j in range(K):
            if nbrs[b, j] >= 0:
                slots[nbrs[b, j]].append(b)
    out = np.zeros((n_rows, g.shape[1]), np.float32)
    for u, bs in enumerate(slots):
        for c0 in range(0, len(bs), ref.CHUNK):
            part = np.zeros(g.shape[1], np.float32)
            for b in bs[c0:c0 + ref.CHUNK]:
                part = part + g[b] / cnt[b]
            out[u] = out[u] + part
    return out


def test_backward_adds_in_slot_order():
    """The case of ids with at most CHUNK slots: grad_x of each id is the
    float32 sum of g[b] / count_b over its slots in (b, j) order, which
    is the chunk order's one chunk; the bits the CUDA kernel
    reproduces."""
    x, nbrs, w = inputs(12, 8, 5, 20, 7, seed=7)
    nbrs[3] = -1
    assert np.bincount(nbrs[nbrs >= 0]).max() <= ref.CHUNK
    g = np.random.default_rng(8).normal(size=(20, 8)).astype(np.float32)
    got = ops.neighbor_agg_bwd(torch.from_numpy(g), torch.from_numpy(nbrs),
                               12).numpy()
    want = np.zeros((12, 8), np.float32)
    cnt = np.maximum((nbrs >= 0).sum(1), 1).astype(np.float32)
    for b in range(20):
        for j in range(7):
            if nbrs[b, j] >= 0:
                want[nbrs[b, j]] = want[nbrs[b, j]] + g[b] / cnt[b]
    assert np.array_equal(got, want)
    assert np.array_equal(chunk_order_oracle(g, nbrs, 12), want)


# slots per id: 0, 1, C, C + 1, 3C + 5 and a power-law hub's 1,386 (the
# train launcher's batch); ids 1 and 7 name no slot
C = ref.CHUNK
ID_SLOTS = [1386, 0, 1, C, C + 1, 3 * C + 5, 2, 0]


@pytest.mark.parametrize("seed,D,K", [(0, 8, 7), (1, 33, 5), (2, 1, 16)])
def test_backward_adds_in_chunk_order(seed, D, K):
    """The plain backward (and the wrapper's CPU route) equals the numpy
    oracle of the chunk order bit for bit, on ids of 0, 1, C, C + 1,
    3C + 5 and 1,386 slots, with all-pad rows between."""
    rng = np.random.default_rng(seed)
    ids = rng.permutation(np.repeat(np.arange(len(ID_SLOTS)), ID_SLOTS))
    B = -(-ids.size // K) + 40
    flat = np.full(B * K, -1, np.int32)
    keep = rng.choice(np.arange(K, B * K - K), size=ids.size, replace=False)
    flat[np.sort(keep)] = ids                # rows 0 and B - 1 all pad
    nbrs = flat.reshape(B, K)
    assert (nbrs[0] < 0).all() and (nbrs[-1] < 0).all()
    assert np.bincount(nbrs[nbrs >= 0], minlength=8).tolist() == ID_SLOTS
    g = rng.normal(size=(B, D)).astype(np.float32)
    want = chunk_order_oracle(g, nbrs, len(ID_SLOTS))
    got = ref.neighbor_agg_bwd_ref(torch.from_numpy(g), torch.from_numpy(nbrs),
                                   len(ID_SLOTS))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(ops.neighbor_agg_bwd(
        torch.from_numpy(g), torch.from_numpy(nbrs), len(ID_SLOTS)).numpy(),
        want)


def test_transpose_index_groups_slots_by_id_in_order():
    nbrs = torch.tensor([[2, -1, 0], [0, 2, 2], [-1, -1, -1], [1, 0, -1]],
                        dtype=torch.int32)
    cnt, rowptr, rows, hptr, hunit = ops.transpose_index(nbrs, 4)
    assert rowptr.tolist() == [0, 3, 4, 7, 7]
    # id 0: (0, 2), (1, 0), (3, 1); id 1: (3, 0); id 2: (0, 0), (1, 1), (1, 2)
    assert rows.tolist() == [0, 1, 3, 3, 0, 1, 1]
    assert cnt.tolist() == [2, 3, 0, 2]
    assert rows.dtype == torch.int32 and rowptr.dtype == torch.int64
    assert cnt.dtype == torch.int32
    # no id has more than CHUNK slots: no chunk unit
    assert hptr.tolist() == [0, 0, 0, 0, 0] and hptr.dtype == torch.int64
    assert hunit.dtype == torch.int32


@pytest.mark.parametrize("counts", [
    [0, 33, 5, 64, 100], [C + 1] * 7, [1] * 50 + [1386], [C] * 9, [0, 0],
    [100_000, 3, C + 1]])
def test_chunk_units_map_every_chunk_to_its_id(counts):
    """hptr counts ceil(n / CHUNK) units for each id of n > CHUNK slots
    and none for the others; hunit names each unit's id and holds them
    all within its 2 * slots // CHUNK entries."""
    rowptr = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                          dtype=torch.int64)
    hptr, hunit = ops.chunk_units(rowptr, sum(counts))
    units = [-(-n // C) if n > C else 0 for n in counts]
    assert hptr.tolist() == np.concatenate([[0], np.cumsum(units)]).tolist()
    want = np.repeat(np.arange(len(counts)), units)
    assert want.size <= hunit.numel() == 2 * sum(counts) // C
    assert hunit[:want.size].tolist() == want.tolist()


def test_chunk_constant_matches_the_kernel_source():
    """ref.CHUNK defines the order; the CUDA kernel's kChunk must be the
    same number (the card's tests hold the bits)."""
    import pathlib
    src = (pathlib.Path(ops.__file__).parent / "csrc"
           / "neighbor_agg.cu").read_text()
    assert f"constexpr int kChunk = {ref.CHUNK};" in src


@pytest.mark.parametrize("K,pad", [(4, 0.3), (1, 0.0), (6, 1.0)])
def test_gradcheck_float64(K, pad):
    rng = np.random.default_rng(K)
    nbrs = rng.integers(0, 7, size=(5, K)).astype(np.int32)
    nbrs[rng.random((5, K)) < pad] = -1
    x = torch.from_numpy(rng.normal(size=(7, 3))).requires_grad_(True)
    w = torch.from_numpy(rng.normal(size=(3, 4))).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda a, b: ops.neighbor_agg(a, torch.from_numpy(nbrs), b),
        (x, w), eps=1e-6, atol=1e-7)


def test_bf16_grad_of_w_is_the_float32_grad_rounded():
    """A bfloat16 w gets its float32 gradient rounded to bfloat16, as
    JAX's cotangent of a bf16 param is."""
    x, nbrs, w = inputs(30, 16, 8, 10, 5, seed=9)
    wb = torch.from_numpy(w).to(torch.bfloat16).requires_grad_(True)
    w32 = wb.detach().float().requires_grad_(True)
    gout = torch.from_numpy(np.random.default_rng(10).normal(
        size=(10, 8)).astype(np.float32))
    for wt in (wb, w32):
        ops.neighbor_agg(torch.from_numpy(x), torch.from_numpy(nbrs),
                         wt).backward(gout)
    assert wb.grad.dtype == torch.bfloat16
    assert torch.equal(wb.grad, w32.grad.to(torch.bfloat16))
