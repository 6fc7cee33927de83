"""The backward of the port's flash attention on the CPU: the plain version
``attention_bwd_ref`` against ``jax.vjp`` of the JAX package's
``repro.kernels.flash_attention.ref.attention_ref``, and the autograd
wrapper ``ops.flash_attention`` against autograd through the port's
``attention_ref``. Inputs come from a numpy seed.

Tolerances. float32: atol 1e-5, rtol 1e-5 on gradients of order 1-7
(both sides sum in float32 in other orders, and JAX's softmax vjp takes
``rowsum(p * dp)`` where the port takes ``rowsum(dout * out)``, the same
number in exact arithmetic; measured differences are below 4e-6).
bfloat16: both widen the same bf16 inputs to float32, but the port's
``delta`` reads the output rounded to bf16 (each term off by up to 2**-9
of itself) and both round the gradients to bf16 once, so they may differ
by one or two bf16 steps: allclose with rtol 2**-7 and atol 2**-7 of the
largest |gradient| (measured: two steps of 2**-7 at magnitude 3-5, 3.4e-3
of the largest), and the mean error under 2**-8 of the mean |gradient|
(measured below 7.1e-4 of it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jax_attention
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref)

CASES = [(2, 64, 4, 4, 16, True, None), (1, 100, 8, 2, 80, True, None),
         (2, 77, 4, 1, 32, False, None), (1, 130, 4, 2, 64, True, 20),
         (1, 50, 2, 2, 128, False, 7), (2, 33, 6, 3, 80, True, 5),
         (3, 1, 4, 4, 16, True, None), (1, 65, 4, 1, 256, True, None)]
F32_TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(B, S, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, h, D)).astype(np.float32)
            for h in (Hq, Hkv, Hkv, Hq)]


def _close(got, want, dtype):
    for g, w in zip(got, want):
        g = g.float().numpy()
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape
        if dtype == "float32":
            np.testing.assert_allclose(g, w, **F32_TOL)
            continue
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=2 ** -7, atol=2 ** -7 * scale)
        assert float(np.abs(g - w).mean()) <= 2 ** -8 * float(
            np.abs(w).mean())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal,window", CASES)
def test_attention_bwd_ref_equals_jax_vjp(B, S, Hq, Hkv, D, causal, window,
                                          dtype):
    x = _inputs(B, S, Hq, Hkv, D, B + S + D)
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in x]
    _, vjp = jax.vjp(lambda q, k, v: jax_attention(
        q, k, v, causal=causal, window=window), *jx[:3])
    want = vjp(jx[3])
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in x]
    out = attention_ref(*tx[:3], causal=causal, window=window)
    got = attention_bwd_ref(*tx[:3], out, tx[3], causal=causal,
                            window=window)
    assert [t.dtype for t in got] == [getattr(torch, dtype)] * 3
    _close(got, want, dtype)


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal,window", CASES)
def test_wrapper_grads_equal_autograd_through_attention_ref(
        B, S, Hq, Hkv, D, causal, window):
    """On the CPU the wrapper's forward is ``attention_ref`` and its
    backward ``attention_bwd_ref``: float32 autograd through either agrees
    within F32_TOL, and no kernel launch is counted."""
    x = [torch.from_numpy(a) for a in _inputs(B, S, Hq, Hkv, D, S)]
    ref_leaves = [t.clone().requires_grad_(True) for t in x[:3]]
    want = torch.autograd.grad(attention_ref(
        *ref_leaves, causal=causal, window=window), ref_leaves, x[3])
    leaves = [t.clone().requires_grad_(True) for t in x[:3]]
    launches = (fops.flash_attention.launches,
                fops.flash_attention_bwd.launches)
    out = fops.flash_attention(*leaves, causal=causal, window=window)
    got = torch.autograd.grad(out, leaves, x[3])
    assert (fops.flash_attention.launches,
            fops.flash_attention_bwd.launches) == launches
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **F32_TOL)


def test_wrapper_backward_in_bf16_is_the_plain_version():
    x = [torch.from_numpy(a).to(torch.bfloat16)
         for a in _inputs(2, 40, 4, 2, 16, 1)]
    leaves = [t.clone().requires_grad_(True) for t in x[:3]]
    out = fops.flash_attention(*leaves, window=9)
    got = torch.autograd.grad(out, leaves, x[3])
    want = attention_bwd_ref(*x[:3], out.detach().contiguous(), x[3],
                             window=9)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, w)


def test_flash_attention_bwd_checks_its_arguments():
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(1, 8, 2, 1, 16, 0))
    out = attention_ref(q, k, v)
    with pytest.raises(ValueError, match="out and dout must be"):
        fops.flash_attention_bwd(q, k, v, out[:, :4], g)
    with pytest.raises(ValueError, match="out and dout must be"):
        fops.flash_attention_bwd(q, k, v, out, g.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        fops.flash_attention_bwd(q, k, v, out.transpose(1, 2).contiguous()
                                 .transpose(1, 2), g)
    with pytest.raises(ValueError, match="multiple of 8"):
        fops.flash_attention_bwd(q[..., :12].contiguous(),
                                 k[..., :12].contiguous(),
                                 v[..., :12].contiguous(),
                                 out[..., :12].contiguous(),
                                 g[..., :12].contiguous())
