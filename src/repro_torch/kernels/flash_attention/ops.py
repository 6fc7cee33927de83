"""The flash-attention wrappers: the tensors' device picks the kernel.

A CUDA tensor goes to the hand-written Hopper kernels
(``csrc/flash_attention.cu``, and its backward
``csrc/flash_attention_bwd.cu``, built by ``kernels._build``); a CPU
tensor goes to the plain versions in ``ref.py`` (``attention_ref`` and
``attention_bwd_ref``). There is no other switch and no fallback: a
failed build or launch raises. ``flash_attention`` is differentiable in
q, k and v (a ``torch.autograd.Function`` that saves q, k, v, the output
and the forward's logsumexp, and runs ``flash_attention_bwd``); the
kernel writes the logsumexp only when a gradient is recorded or the
caller asks for it (``return_lse``), so serving pays nothing for it.
``flash_attention.launches`` and ``flash_attention_bwd.launches`` count
the CUDA launches (one a backward call, which runs three kernels), so a
run can show that its path went through the kernels.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .._build import load_extension, on_cuda
from .ref import attention_bwd_ref, attention_lse_ref, attention_ref

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
    def forward(ctx, q, k, v, causal, window, want_lse):
        if on_cuda(q, "flash_attention"):
            out, lse = load_extension().flash_attention(
                q, k, v, causal, window or 0, 1.0 / math.sqrt(q.shape[3]),
                want_lse)
            flash_attention.launches += 1
        else:
            out = attention_ref(q, k, v, causal=causal, window=window)
            lse = (attention_lse_ref(q, k, causal=causal, window=window)
                   if want_lse else q.new_empty(0, dtype=torch.float32))
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out.contiguous(),
                                         dout.contiguous(), lse,
                                         causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    return_lse: bool = False):
    """q (B, S, Hq, D), k and v (B, S, Hkv, D), one dtype (float32 or
    bfloat16), contiguous, Hq a multiple of Hkv, D a multiple of 8 up to
    256. Returns (B, S, Hq, D) in ``q.dtype``: attention with a causal
    mask (``causal``) and a sliding window of ``window`` keys (key j
    sees query i when ``i - window < j``), scale ``1/sqrt(D)``, as
    ``ref.attention_ref`` defines it. Differentiable in q, k and v.
    With ``return_lse``, returns ``(out, lse)``: lse (B, Hq, S) float32,
    each query row's logsumexp (``ref.attention_lse_ref``), not
    differentiable. Raises on anything else.
    """
    _check(q, k, v, window)
    grad = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    out, lse = _FlashAttention.apply(q, k, v, causal, window,
                                     return_lse or grad)
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None):
    """The gradient of ``flash_attention(q, k, v)`` at ``dout``, given its
    output ``out`` and logsumexp ``lse`` (``flash_attention(...,
    return_lse=True)``): ``(dq, dk, dv)`` in the inputs' dtype, as
    ``ref.attention_bwd_ref`` defines it (float32 sums; dk and dv summed
    over each kv-head's query heads). out and dout are (B, S, Hq, D) in
    q's dtype, lse (B, Hq, S) float32, all contiguous; the rest as
    ``flash_attention``. On the CPU lse is checked and the plain version,
    which computes P from the scores, runs. The card's kernels use no
    atomics: a repeated call gives the same bits."""
    _check(q, k, v, window)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out and dout must be {tuple(q.shape)}, got "
                         f"{tuple(out.shape)} and {tuple(dout.shape)}")
    if out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"out and dout must be {q.dtype}, got {out.dtype} "
                         f"and {dout.dtype}")
    if not (out.is_contiguous() and dout.is_contiguous()):
        raise ValueError("out and dout must be contiguous")
    B, S, Hq, _ = q.shape
    if lse.shape != (B, Hq, S) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be ({B}, {Hq}, {S}) float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if not lse.is_contiguous():
        raise ValueError("lse must be contiguous")
    if not on_cuda(q, "flash_attention_bwd"):
        return attention_bwd_ref(q, k, v, out, dout, causal=causal,
                                 window=window)
    grads = load_extension().flash_attention_bwd(
        q, k, v, out, dout, lse, causal, window or 0,
        1.0 / math.sqrt(q.shape[3]))
    flash_attention_bwd.launches += 1
    return tuple(grads)


flash_attention_bwd.launches = 0
