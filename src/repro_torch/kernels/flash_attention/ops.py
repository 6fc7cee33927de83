"""The flash-attention wrapper: the tensors' device picks the kernel.

A CUDA tensor goes to the hand-written Hopper kernel
(``csrc/flash_attention.cu``, built by ``kernels._build``); a CPU tensor
goes to the plain version in ``ref.py``. There is no other switch and no
fallback: a failed build or launch raises. ``flash_attention.launches``
counts the CUDA launches, so a run can show that its path went through
the kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .._build import load_extension, on_cuda
from .ref import attention_ref

__all__ = ["flash_attention"]

DTYPES = (torch.float32, torch.bfloat16)
MAX_D = 256


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q (B, S, Hq, D), k and v (B, S, Hkv, D), one dtype (float32 or
    bfloat16), contiguous, Hq a multiple of Hkv, D a multiple of 8 up to
    256. Returns (B, S, Hq, D) in ``q.dtype``: attention with a causal
    mask (``causal``) and a sliding window of ``window`` keys (key j
    sees query i when ``i - window < j``), scale ``1/sqrt(D)``, as
    ``ref.attention_ref`` defines it. Raises on anything else.
    """
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
    if not on_cuda(q, "flash_attention"):
        return attention_ref(q, k, v, causal=causal, window=window)
    out = load_extension().flash_attention(q, k, v, causal, window or 0,
                                           1.0 / math.sqrt(D))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
