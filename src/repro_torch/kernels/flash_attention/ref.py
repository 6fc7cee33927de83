"""Plain PyTorch version of the flash-attention kernel.

A copy of ``src/repro/kernels/flash_attention/ref.py::attention_ref``:
it materialises the (S, S) scores, masks them with -1e30 and takes a
float32 softmax. It is the CPU path of ``ops.flash_attention`` and the
yardstick the card's kernel is compared with; nothing on the card's
main path calls it. The kernel computes the same function blockwise
(online softmax over key tiles), so the two agree within float32
rounding, not bit for bit.
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
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, D)
    scores = torch.einsum("bshgd,bthd->bhgst", qg.float(),
                          k.float()) / math.sqrt(D)
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= j <= i
    if window is not None:
        mask &= j > i - window
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v.float())
    return out.reshape(B, S, Hq, D).to(q.dtype)
