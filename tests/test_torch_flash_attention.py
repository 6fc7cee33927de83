"""The port's flash-attention plain version against the JAX package on the CPU.

The JAX side is the Pallas kernel ``flash_attention`` in interpret mode
(as ``tests/test_kernels.py`` runs it, block 64) and its oracle
``attention_ref``; the port's side is ``ops.flash_attention`` on CPU
tensors, which is ``ref.attention_ref``. Inputs come from numpy seeds.
Tolerances are those of ``tests/test_kernels.py``: 2e-5 in float32 (the
kernel's online softmax sums the key tiles in another order than one
softmax over all keys) and 2e-2 in bfloat16 (one rounding of outputs of
order 1 to 8 bits of mantissa); the random-shape sweep keeps that
file's 3e-5. The JAX kernel asserts ``S % block == 0``, so ragged
lengths are held against the JAX oracle.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.kernels.flash_attention import ops, ref


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-5)


def _inputs(seed, B, S, Hq, Hkv, D, dtype="float32"):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(B, S, h, D)).astype(np.float32)
              for h in (Hq, Hkv, Hkv)]
    jax_x = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    torch_x = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jax_x, torch_x


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,window", [
    (2, 128, 4, 4, 64, None),          # MHA
    (1, 256, 8, 2, 64, None),          # GQA 4:1
    (2, 256, 4, 4, 32, 64),            # sliding window
    (1, 128, 2, 1, 128, None),         # MQA, d=128
])
def test_plain_version_matches_jax_kernel(B, S, Hq, Hkv, D, window, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(0, B, S, Hq, Hkv, D, dtype)
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    want = jax_flash(jq, jk, jv, causal=True, window=window, block_q=64,
                     block_k=64)
    _close(got, want, **_tol(dtype))
    _close(got, jax_ref(jq, jk, jv, causal=True, window=window),
           **_tol(dtype))


def test_noncausal_matches_jax_kernel():
    (jq, jk, jv), (q, k, v) = _inputs(1, 1, 128, 2, 2, 32)
    got = ops.flash_attention(q, k, v, causal=False)
    want = jax_flash(jq, jk, jv, causal=False, block_q=64, block_k=64)
    _close(got, want, **_tol("float32"))


@pytest.mark.parametrize("window", [None, 48])
def test_noncausal_window_matches_jax_ref(window):
    """Without the causal mask a window still cuts keys j <= i - window
    (and the plain version sees the future, as the reference does)."""
    (jq, jk, jv), (q, k, v) = _inputs(2, 2, 96, 4, 2, 16)
    got = ops.flash_attention(q, k, v, causal=False, window=window)
    _close(got, jax_ref(jq, jk, jv, causal=False, window=window),
           **_tol("float32"))


# a fixed, seeded stand-in for tests/test_kernels.py's property sweep
_RANDOM_GQA = [(int(b), int(s), int(h), int(seed)) for b, s, h, seed in zip(
    np.random.default_rng(7).integers(1, 4, 8),
    np.random.default_rng(8).choice([64, 128, 192], 8),
    np.random.default_rng(9).choice([1, 2, 4], 8),
    np.random.default_rng(10).integers(0, 101, 8))]


@pytest.mark.parametrize("B,S,Hkv,seed", _RANDOM_GQA)
def test_random_gqa_shapes_match_jax_kernel(B, S, Hkv, seed):
    (jq, jk, jv), (q, k, v) = _inputs(seed, B, S, 2 * Hkv, Hkv, 32)
    got = ops.flash_attention(q, k, v, causal=True)
    want = jax_flash(jq, jk, jv, causal=True, block_q=64, block_k=64)
    _close(got, want, atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,window,causal", [
    (100, None, True), (37, 16, True), (1, None, True), (70, None, False),
    (130, 24, True)])
def test_ragged_lengths_match_jax_ref(S, window, causal, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(S, 2, S, 4, 2, 24, dtype)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    _close(got, jax_ref(jq, jk, jv, causal=causal, window=window),
           **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_d80_matches_jax_kernel(dtype):
    (jq, jk, jv), (q, k, v) = _inputs(3, 1, 128, 4, 2, 80, dtype)
    got = ops.flash_attention(q, k, v, causal=True)
    want = jax_flash(jq, jk, jv, causal=True, block_q=64, block_k=64)
    _close(got, want, **_tol(dtype))


@pytest.mark.parametrize("window", [None, 5])
def test_plain_version_matches_jax_ref_tightly(window):
    """The two oracles do the same float32 arithmetic."""
    (jq, jk, jv), (q, k, v) = _inputs(4, 2, 50, 6, 3, 16)
    got = ref.attention_ref(q, k, v, causal=True, window=window)
    _close(got, jax_ref(jq, jk, jv, causal=True, window=window),
           atol=1e-6, rtol=1e-6)


# every head dim the wrapper takes (a multiple of 8 in [8, 256]) under each
# mask combination; the card's bf16 kernel zero-pads D up to a multiple of
# 64, so each D is a distinct padding case there
@pytest.mark.parametrize("causal,window", [
    (True, None), (True, 5), (False, None), (False, 5)],
    ids=["causal", "causal_window", "full", "window"])
@pytest.mark.parametrize("D", range(8, 257, 8))
def test_every_head_dim_and_mask_match_jax_ref(D, causal, window):
    (jq, jk, jv), (q, k, v) = _inputs(D, 1, 19, 4, 2, D)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, jax_ref(jq, jk, jv, causal=causal, window=window),
           **_tol("float32"))


def test_cpu_tensors_never_launch():
    _, (q, k, v) = _inputs(5, 1, 64, 4, 2, 32)
    before = ops.flash_attention.launches
    ops.flash_attention(q, k, v)
    ops.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), window=8)
    assert ops.flash_attention.launches == before


def _bad(case):
    _, (q, k, v) = _inputs(6, 1, 16, 4, 2, 16)
    if case == "rank":
        return (q[0], k[0], v[0]), {}
    if case == "heads":
        return (q[:, :, :3].contiguous(), k, v), {}
    if case == "kv_shape":
        return (q, k, v[:, :8].contiguous()), {}
    if case == "d_not_multiple_of_8":
        return (q[..., :12].contiguous(), k[..., :12].contiguous(),
                v[..., :12].contiguous()), {}
    if case == "d_too_large":
        big = [torch.zeros(1, 4, h, 264) for h in (4, 2, 2)]
        return tuple(big), {}
    if case == "float16":
        return (q.half(), k.half(), v.half()), {}
    if case == "mixed_dtype":
        return (q, k.bfloat16(), v), {}
    if case == "non_contiguous":
        return (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)), {}
    if case == "window_0":
        return (q, k, v), {"window": 0}
    raise AssertionError(case)


@pytest.mark.parametrize("case", [
    "rank", "heads", "kv_shape", "d_not_multiple_of_8", "d_too_large",
    "float16", "mixed_dtype", "non_contiguous", "window_0"])
def test_bad_inputs_raise(case):
    args, kw = _bad(case)
    with pytest.raises(ValueError):
        ops.flash_attention(*args, **kw)
