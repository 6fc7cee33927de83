"""The flash-attention wrappers: the tensors' device picks the kernel.

A CUDA tensor goes to the hand-written Hopper kernels
(``csrc/flash_attention.cu``, and its backward
``csrc/flash_attention_bwd.cu``, built by ``kernels._build``); a CPU
tensor goes to the plain versions in ``ref.py`` (``attention_ref`` and
``attention_bwd_ref``). There is no other switch and no fallback: a
failed build or launch raises. ``flash_attention`` is differentiable in
q, k and v (a ``torch.autograd.Function`` that saves q, k, v and the
output, and runs ``flash_attention_bwd``). ``flash_attention.launches``
and ``flash_attention_bwd.launches`` count the CUDA launches (one a
backward call, which runs three kernels), so a run can show that its
path went through the kernels.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .._build import load_extension, on_cuda
from .ref import attention_bwd_ref, attention_ref

__all__ = ["flash_attention", "flash_attention_bwd"]

DTYPES = (torch.float32, torch.bfloat16)
MAX_D = 256


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention takes 4-D (B, S, H, D) tensors, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, Hq, D = q.shape
    if k.shape != v.shape or (k.shape[0], k.shape[1], k.shape[3]) != (
            B, S, D):
        raise ValueError(f"k and v must be (B, S, Hkv, D) beside q's "
                         f"{tuple(q.shape)}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    Hkv = k.shape[2]
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    if D % 8 or not 8 <= D <= MAX_D:
        raise ValueError(f"D must be a multiple of 8 in [8, {MAX_D}], got "
                         f"{D}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must share one dtype of {DTYPES}, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")


class _FlashAttention(torch.autograd.Function):
    """Attention with its gradient for q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        if on_cuda(q, "flash_attention"):
            out = load_extension().flash_attention(
                q, k, v, causal, window or 0, 1.0 / math.sqrt(q.shape[3]))
            flash_attention.launches += 1
        else:
            out = attention_ref(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out.contiguous(),
                                         dout.contiguous(),
                                         causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q (B, S, Hq, D), k and v (B, S, Hkv, D), one dtype (float32 or
    bfloat16), contiguous, Hq a multiple of Hkv, D a multiple of 8 up to
    256. Returns (B, S, Hq, D) in ``q.dtype``: attention with a causal
    mask (``causal``) and a sliding window of ``window`` keys (key j
    sees query i when ``i - window < j``), scale ``1/sqrt(D)``, as
    ``ref.attention_ref`` defines it. Differentiable in q, k and v.
    Raises on anything else.
    """
    _check(q, k, v, window)
    return _FlashAttention.apply(q, k, v, causal, window)


flash_attention.launches = 0


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, *,
                        causal: bool = True,
                        window: Optional[int] = None):
    """The gradient of ``flash_attention(q, k, v)`` at ``dout``, given its
    output ``out``: ``(dq, dk, dv)`` in the inputs' dtype, as
    ``ref.attention_bwd_ref`` defines it (float32 sums; dk and dv summed
    over each kv-head's query heads). out and dout are (B, S, Hq, D) in
    q's dtype, contiguous; the rest as ``flash_attention``. The card's
    kernels use no atomics: a repeated call gives the same bits."""
    _check(q, k, v, window)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out and dout must be {tuple(q.shape)}, got "
                         f"{tuple(out.shape)} and {tuple(dout.shape)}")
    if out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"out and dout must be {q.dtype}, got {out.dtype} "
                         f"and {dout.dtype}")
    if not (out.is_contiguous() and dout.is_contiguous()):
        raise ValueError("out and dout must be contiguous")
    if not on_cuda(q, "flash_attention_bwd"):
        return attention_bwd_ref(q, k, v, out, dout, causal=causal,
                                 window=window)
    grads = load_extension().flash_attention_bwd(
        q, k, v, out, dout, causal, window or 0, 1.0 / math.sqrt(q.shape[3]))
    flash_attention_bwd.launches += 1
    return tuple(grads)


flash_attention_bwd.launches = 0
