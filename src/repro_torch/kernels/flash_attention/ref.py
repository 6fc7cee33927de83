"""Plain PyTorch versions of the flash-attention kernels.

``attention_ref`` is a copy of
``src/repro/kernels/flash_attention/ref.py::attention_ref``: it
materialises the (S, S) scores, masks them with -1e30 and takes a
float32 softmax. ``attention_lse_ref`` is the logsumexp of the same
masked scores, the second output of the forward kernel.
``attention_bwd_ref`` is its gradient, written out in float32 on the
materialised probabilities (the JAX package takes it with ``jax.vjp``);
it computes P from the scores and never reads a logsumexp.
``attention_bwd_abs_ref`` is the same three products on absolute values,
the scale of the bf16 kernel's operand rounding (chip_smoke.py's
BWD_TOL). They are the CPU path of ``ops.flash_attention`` and its
backward, and the yardsticks the card's kernels are compared with;
nothing on the card's main path calls them. The kernels compute the
same functions blockwise (online softmax over key tiles), so the two
agree within float32 rounding, not bit for bit.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """q: (B, S, Hq, D); k/v: (B, S, Hkv, D). Returns (B, S, Hq, D) in
    ``q.dtype``.

    Hq must be a multiple of Hkv (GQA): q-head h reads kv-head
    h // (Hq // Hkv). Softmax in fp32.
    """
    B, S, Hq, D = q.shape
    probs = _probs(q, k, causal, window)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v.float())
    return out.reshape(B, S, Hq, D).to(q.dtype)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                      causal: bool = True,
                      window: Optional[int] = None) -> torch.Tensor:
    """(B, Hq, S) float32: each query row's natural logsumexp of its
    masked, scaled float32 scores (masked keys at -1e30, as
    ``attention_ref`` masks them)."""
    B, S, Hq, _ = q.shape
    lse = torch.logsumexp(_scores(q, k, causal, window), dim=-1)
    return lse.reshape(B, Hq, S)


def _probs(q, k, causal, window) -> torch.Tensor:
    """The float32 softmax of the masked scores, (B, Hkv, G, S, S)."""
    return torch.softmax(_scores(q, k, causal, window), dim=-1)


def _scores(q, k, causal, window) -> torch.Tensor:
    """The masked, scaled float32 scores, (B, Hkv, G, S, S)."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, Hq // Hkv, D)
    scores = torch.einsum("bshgd,bthd->bhgst", qg.float(),
                          k.float()) / math.sqrt(D)
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= j <= i
    if window is not None:
        mask &= j > i - window
    return torch.where(mask, scores, -1e30)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      out: torch.Tensor, dout: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None):
    """The gradient of ``attention_ref`` at ``dout`` (B, S, Hq, D), given
    its output ``out``: ``(dq, dk, dv)`` in the inputs' dtypes, computed
    in float32 from the materialised probabilities P:
    ``dv = P^T dout``, ``ds = P * (dout v^T - delta)`` with
    ``delta = rowsum(dout * out)``, ``dq = ds k / sqrt(D)``,
    ``dk = ds^T q / sqrt(D)``; dk and dv sum over each kv-head's query
    heads. ``delta`` reads ``out`` as given (rounded to its dtype), as
    the kernel does."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    probs = _probs(q, k, causal, window)
    qg = q.reshape(B, S, Hkv, G, D).float()
    dg = dout.reshape(B, S, Hkv, G, D).float()
    og = out.reshape(B, S, Hkv, G, D).float()
    kf, vf = k.float(), v.float()
    dv = torch.einsum("bhgst,bshgd->bthd", probs, dg)
    dp = torch.einsum("bshgd,bthd->bhgst", dg, vf)
    delta = (dg * og).sum(-1).permute(0, 2, 3, 1)[..., None]
    ds = probs * (dp - delta)
    del dp
    dq = torch.einsum("bhgst,bthd->bshgd", ds, kf) / math.sqrt(D)
    dk = torch.einsum("bhgst,bshgd->bthd", ds, qg) / math.sqrt(D)
    return (dq.reshape(B, S, Hq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def attention_bwd_abs_ref(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, out: torch.Tensor,
                          dout: torch.Tensor, *, causal: bool = True,
                          window: Optional[int] = None):
    """The products of ``attention_bwd_ref`` on absolute values, float32:
    ``(|ds| |k| / sqrt(D), |ds|^T |q| / sqrt(D), P^T |dout|)`` for dq, dk
    and dv. Rounding P and ds to bf16 (2**-8 of each term at most) moves
    a gradient by at most 2**-8 of these."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    probs = _probs(q, k, causal, window)
    qg = q.reshape(B, S, Hkv, G, D).float()
    dg = dout.reshape(B, S, Hkv, G, D).float()
    og = out.reshape(B, S, Hkv, G, D).float()
    av = torch.einsum("bhgst,bshgd->bthd", probs, dg.abs())
    dp = torch.einsum("bshgd,bthd->bhgst", dg, v.float())
    delta = (dg * og).sum(-1).permute(0, 2, 3, 1)[..., None]
    ds = (probs * (dp - delta)).abs_()
    del dp
    aq = torch.einsum("bhgst,bthd->bshgd", ds, k.float().abs()) / math.sqrt(D)
    ak = torch.einsum("bhgst,bshgd->bthd", ds, qg.abs()) / math.sqrt(D)
    return aq.reshape(B, S, Hq, D), ak, av
