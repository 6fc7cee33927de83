"""Shared model building blocks, as ``src/repro/models/common.py`` has them.

Parameters are nested dicts of tensors in the JAX package's layout: a
dense weight is (in, out) and is applied as ``x @ w + b``, so params
converted from the JAX package are used as they are (no transpose).
Every ``*_init`` takes an explicit ``torch.Generator`` and a device and
draws on that device, so a full-width table is made on the card without
a host copy. The draws are float32 normals, scaled, then cast to
``dtype``, as the JAX package draws them; the numbers themselves differ
from JAX's, whose generator is another. The norms and RoPE round
where the JAX package rounds.
"""
from __future__ import annotations

import math

import torch

# The default dtype of the inits (and the LM's compute dtype), as in the
# JAX package; the two-tower model passes float32.
DEFAULT_DTYPE = torch.bfloat16


def _normal(gen: torch.Generator, shape, scale: float, dtype, device):
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device)
    return w.mul_(scale).to(dtype)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype=DEFAULT_DTYPE, device="cpu") -> torch.Tensor:
    """(in_dim, out_dim) normal / sqrt(in_dim)."""
    return _normal(gen, (in_dim, out_dim), 1.0 / math.sqrt(in_dim), dtype,
                   device)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype=DEFAULT_DTYPE, device="cpu") -> torch.Tensor:
    """(vocab, dim) normal x 0.02."""
    return _normal(gen, (vocab, dim), 0.02, dtype, device)


def mlp_init(gen: torch.Generator, dims, dtype=DEFAULT_DTYPE,
             device="cpu") -> dict:
    """Params ``w{i}`` (d_i, d_{i+1}) and zero ``b{i}`` for layer dims
    [d0, d1, ..., dk]."""
    params = {f"w{i}": dense_init(gen, dims[i], dims[i + 1], dtype, device)
              for i in range(len(dims) - 1)}
    params.update({f"b{i}": torch.zeros(dims[i + 1], dtype=dtype,
                                        device=device)
                   for i in range(len(dims) - 1)})
    return params


def mlp_apply(params: dict, x: torch.Tensor, n_layers: int,
              act=torch.relu, final_act: bool = False) -> torch.Tensor:
    """``x @ w + b`` per layer, ``act`` (ReLU by default) between layers
    (after the last only with ``final_act``). Mixed dtypes promote as in
    JAX: a float32 ``x`` against bfloat16 params (the GNN) multiplies in
    float32, with ``w`` widened exactly; with one dtype nothing is
    cast."""
    for i in range(n_layers):
        w = params[f"w{i}"]
        dt = torch.promote_types(x.dtype, w.dtype)
        x = x.to(dt) @ w.to(dt) + params[f"b{i}"]
        if i < n_layers - 1 or final_act:
            x = act(x)
    return x


# ------------------------------------------------------------------- norms

def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32, cast back to ``x.dtype``, then times ``gamma``
    in that dtype (where the JAX package rounds)."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dtype) * gamma


# -------------------------------------------------------------------- rope

def rotary_embedding(positions: torch.Tensor, d_head: int,
                     theta: float = 10_000.0):
    """Returns (sin, cos) of shape (..., d_head//2), float32."""
    half = d_head // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    angles = positions.float()[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D); sin/cos: (..., S, D//2) broadcast over heads.
    A bfloat16 ``x`` times the float32 sin and cos is float32 (in both
    frameworks); the result is cast back to ``x.dtype`` at the end."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    sin = sin[..., None, :]
    cos = cos[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# -------------------------------------------------------------------- loss

def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean cross-entropy in float32. logits (..., V), labels (...,) int;
    with ``mask`` (...,) the sum of the masked terms over
    ``max(sum(mask), 1)``."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)
