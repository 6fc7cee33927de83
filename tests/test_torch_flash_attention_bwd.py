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

The logsumexp the forward hands the backward: ``attention_lse_ref``
against ``jax.nn.logsumexp`` of JAX's masked scores (float32, atol and
rtol 1e-5: both sum the same float32 exponentials in other orders), and
the wrapper's ``lse`` argument checked on the CPU too.

The card's bf16 limits (chip_smoke.py's BWD_TOL, tests/test_torch_cuda.py):
the tensor-core kernel rounds P and dS to bf16 as operands of its
products (2**-8 of each term at most), so a gradient may move by 2**-8 of
the same product on absolute values, A (``attention_bwd_abs_ref``), beside
one bf16 step of the result (rtol 2**-7) and float32 order (atol 1e-4 of
the largest |gradient|); the mean error stays under 2**-8 of the mean
|gradient| plus that atol. An emulation of that rounding lies within the
limits on every case here, and three faults of the kind a wrong tile
walk or a lost term would make fall outside them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jax_attention
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.ref import (attention_bwd_abs_ref,
                                                     attention_bwd_ref,
                                                     attention_lse_ref,
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
    out, lse = fops.flash_attention(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="out and dout must be"):
        fops.flash_attention_bwd(q, k, v, out[:, :4], g, lse)
    with pytest.raises(ValueError, match="out and dout must be"):
        fops.flash_attention_bwd(q, k, v, out, g.to(torch.bfloat16), lse)
    with pytest.raises(ValueError, match="contiguous"):
        fops.flash_attention_bwd(q, k, v, out.transpose(1, 2).contiguous()
                                 .transpose(1, 2), g, lse)
    with pytest.raises(ValueError, match="multiple of 8"):
        fops.flash_attention_bwd(q[..., :12].contiguous(),
                                 k[..., :12].contiguous(),
                                 v[..., :12].contiguous(),
                                 out[..., :12].contiguous(),
                                 g[..., :12].contiguous(), lse)


@pytest.mark.parametrize("bad,match", [
    ("shape", r"lse must be \(1, 2, 8\) float32"),
    ("dtype", r"lse must be \(1, 2, 8\) float32"),
    ("contiguity", "lse must be contiguous")])
def test_flash_attention_bwd_rejects_a_bad_lse(bad, match):
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(1, 8, 2, 1, 16, 0))
    out, lse = fops.flash_attention(q, k, v, return_lse=True)
    bad_lse = {"shape": lse[:, :, :4],
               "dtype": lse.double(),
               "contiguity": lse.transpose(1, 2).contiguous()
               .transpose(1, 2)}[bad]
    with pytest.raises(ValueError, match=match):
        fops.flash_attention_bwd(q, k, v, out, g, bad_lse)


LSE_CASES = [(2, 64, 4, 4, 16, True, None), (1, 100, 8, 2, 80, True, None),
             (1, 130, 4, 2, 64, True, 20), (2, 33, 6, 3, 80, True, 5),
             (2, 77, 4, 1, 32, False, None), (1, 50, 2, 2, 128, False, 7),
             (3, 1, 4, 4, 16, True, None)]


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal,window", LSE_CASES)
def test_attention_lse_ref_equals_jax_logsumexp(B, S, Hq, Hkv, D, causal,
                                                window):
    """The port's logsumexp against jax.nn.logsumexp of the scores as the
    JAX package's ``attention_ref`` masks them."""
    q, k = _inputs(B, S, Hq, Hkv, D, S + D)[:2]
    G = Hq // Hkv
    qg = jnp.asarray(q).reshape(B, S, Hkv, G, D)
    scores = jnp.einsum("bshgd,bthd->bhgst", qg, jnp.asarray(k)) / jnp.sqrt(
        D)
    i = jnp.arange(S)[:, None]
    j = jnp.arange(S)[None, :]
    mask = jnp.ones((S, S), bool)
    if causal:
        mask &= j <= i
    if window is not None:
        mask &= j > i - window
    scores = jnp.where(mask[None, None, None], scores, -1e30)
    want = np.asarray(jax.nn.logsumexp(scores, axis=-1)).reshape(B, Hq, S)
    got = attention_lse_ref(torch.from_numpy(q), torch.from_numpy(k),
                            causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == (B, Hq, S)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_return_lse_on_the_cpu_is_the_plain_version(dtype):
    """``return_lse`` gives ``(attention_ref, attention_lse_ref)`` on the
    CPU, the lse not differentiable, and no launch is counted."""
    x = [torch.from_numpy(a).to(getattr(torch, dtype))
         for a in _inputs(2, 40, 4, 2, 16, 2)[:3]]
    launches = fops.flash_attention.launches
    out, lse = fops.flash_attention(*x, window=9, return_lse=True)
    assert fops.flash_attention.launches == launches
    assert torch.equal(out, attention_ref(*x, window=9))
    assert torch.equal(lse, attention_lse_ref(*x[:2], window=9))
    leaves = [t.clone().requires_grad_(True) for t in x]
    out, lse = fops.flash_attention(*leaves, window=9, return_lse=True)
    assert out.requires_grad and not lse.requires_grad


# ---------------------------------------------- the card's bf16 limits

ULP = 2 ** -8      # bf16's unit roundoff
RTOL = 2 ** -7     # one bf16 step of the result
ATOL_FRAC = 1e-4   # float32 order, of the largest |gradient|


def _bf16_bwd_excess(got, want, absp):
    """How far each of dq, dk, dv lies past the bf16 limits (<= 0 inside):
    the worst element's |g - w| - (RTOL |w| + ULP A + atol), and the mean
    error less (ULP mean |w| + atol), the larger of the two."""
    atol = ATOL_FRAC * max(float(w.float().abs().max()) for w in want)
    out = []
    for g, w, a in zip(got, want, absp):
        g, w = g.float(), w.float()
        d = (g - w).abs()
        elem = float((d - (RTOL * w.abs() + ULP * a + atol)).max())
        mean = float(d.mean()) - (ULP * float(w.abs().mean()) + atol)
        out.append(max(elem, mean))
    return out


def _emulate_tc_bwd(q, k, v, out, dout, causal, window, fault=None):
    """The tensor-core backward's arithmetic on the CPU: float32 scores,
    P = exp(s - lse), dS = P (dP - delta), P and dS rounded to bf16 before
    the three products, float32 sums, outputs rounded to bf16. ``fault``
    injects one of three faults: "drop_head" (the last query head of each
    GQA group left out of dK), "zero_tile" (dV of keys 0-63 zeroed) or
    "scale_dq" (dQ times 1 + 2**-5)."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / np.sqrt(D)
    qg = q.reshape(B, S, Hkv, G, D).float()
    dg = dout.reshape(B, S, Hkv, G, D).float()
    og = out.reshape(B, S, Hkv, G, D).float()
    kf, vf = k.float(), v.float()
    s = torch.einsum("bshgd,bthd->bhgst", qg, kf) * scale
    i = torch.arange(S)[:, None]
    j = torch.arange(S)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool)
    if causal:
        mask &= j <= i
    if window is not None:
        mask &= j > i - window
    lse = attention_lse_ref(q, k, causal=causal, window=window)
    lse = lse.reshape(B, Hkv, G, S)[..., None]
    p = torch.where(mask, torch.exp(s - lse), 0.0)
    dp = torch.einsum("bshgd,bthd->bhgst", dg, vf)
    delta = (dg * og).sum(-1).permute(0, 2, 3, 1)[..., None]
    ds = (p * (dp - delta)).bfloat16().float()
    p = p.bfloat16().float()
    if fault == "drop_head":
        ds_k = ds.clone()
        ds_k[:, :, G - 1] = 0.0
    else:
        ds_k = ds
    dv = torch.einsum("bhgst,bshgd->bthd", p, dg)
    dk = torch.einsum("bhgst,bshgd->bthd", ds_k, qg) * scale
    dq = torch.einsum("bhgst,bthd->bshgd", ds, kf) * scale
    if fault == "zero_tile":
        dv[:, :64] = 0.0
    if fault == "scale_dq":
        dq = dq * (1 + 2 ** -5)
    return (dq.reshape(B, S, Hq, D).bfloat16(), dk.bfloat16(),
            dv.bfloat16())


def _bf16_case(B, S, Hq, Hkv, D, causal, window):
    x = [torch.from_numpy(a).bfloat16()
         for a in _inputs(B, S, Hq, Hkv, D, B + S + D)]
    q, k, v, g = x
    out = attention_ref(q, k, v, causal=causal, window=window)
    kw = dict(causal=causal, window=window)
    want = attention_bwd_ref(q, k, v, out, g, **kw)
    absp = attention_bwd_abs_ref(q, k, v, out, g, **kw)
    return (q, k, v, out, g), kw, want, absp


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal,window", CASES)
def test_bf16_operand_rounding_lies_within_the_limits(B, S, Hq, Hkv, D,
                                                      causal, window):
    x, kw, want, absp = _bf16_case(B, S, Hq, Hkv, D, causal, window)
    got = _emulate_tc_bwd(*x, **kw)
    excess = _bf16_bwd_excess(got, want, absp)
    assert max(excess) <= 0.0, excess


FAULT_CASES = {
    "drop_head": [(1, 100, 8, 2, 80, True, None), (2, 77, 4, 1, 32, False,
                                                   None),
                  (1, 130, 4, 2, 64, True, 20), (2, 33, 6, 3, 80, True, 5)],
    "zero_tile": [(2, 64, 4, 4, 16, True, None), (1, 100, 8, 2, 80, True,
                                                  None),
                  (1, 50, 2, 2, 128, False, 7), (1, 65, 4, 1, 256, True,
                                                 None)],
    "scale_dq": [c for c in CASES if c[1] > 1]}


@pytest.mark.parametrize("fault,case", [
    (f, c) for f, cases in FAULT_CASES.items() for c in cases])
def test_bf16_limits_reject_synthetic_faults(fault, case):
    """One query head of a GQA group dropped from dK, one key tile's dV
    zeroed, dQ scaled by 1 + 2**-5: each breaks the limits."""
    x, kw, want, absp = _bf16_case(*case)
    got = _emulate_tc_bwd(*x, **kw, fault=fault)
    which = {"drop_head": 1, "zero_tile": 2, "scale_dq": 0}[fault]
    assert _bf16_bwd_excess(got, want, absp)[which] > 0.0
