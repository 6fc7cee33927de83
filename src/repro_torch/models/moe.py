"""Mixture-of-Experts FFN with capacity-based local dispatch.

The counterpart of ``src/repro/models/moe.py``: GShard/Switch-style top-k
routing with a per-batch-row token queue. Each slot's position in its
expert's queue is a running count over the row's slots, so dispatch stays
local to the row; each expert takes at most ``capacity = S * top_k /
n_experts * capacity_factor`` slots a row and the rest are dropped.

The JAX package routes and runs the experts in plain ``jnp``, with no
Pallas kernel, so the port's expert products are ``torch.bmm`` over the
experts. Routing is held to JAX's integers: the router logits are a
float32 product (the default full-float32 matmul precision: TF32 would
flip routes), and ties among the probabilities go to the lower expert
index, as ``jax.lax.top_k`` breaks them.

The dispatch buffer is laid out (E, B, C, d), experts first, so each
expert's (B * C, d) block is one operand of the batched product with no
copy; JAX's is (B, E, C, d), which holds the same values.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from .common import _normal


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


def moe_layer_shapes(d_model: int, d_ff: int, moe: MoEConfig) -> dict:
    """Name -> shape of one layer's MoE leaves, in the JAX package's
    order (``router`` is float32, the rest the model's dtype)."""
    E = moe.n_experts
    return {"router": (d_model, E), "moe_gate": (E, d_model, d_ff),
            "moe_up": (E, d_model, d_ff), "moe_down": (E, d_ff, d_model)}


def init_moe_layer(gen: torch.Generator, d_model: int, d_ff: int,
                   moe: MoEConfig, dtype, device="cpu") -> dict:
    """The router (d, E) in float32 and the experts' stacked weights in
    ``dtype``, each drawn normal / sqrt(fan_in) from ``gen``."""
    out = {}
    for name, shape in moe_layer_shapes(d_model, d_ff, moe).items():
        dt = torch.float32 if name == "router" else dtype
        out[name] = _normal(gen, shape, 1.0 / math.sqrt(shape[-2]), dt,
                            device)
    return out


def capacity(cfg, S: int) -> int:
    """Slots each expert takes a row: JAX's ``max(1, int(S * K / E *
    cf))``, the same Python float expression."""
    moe = cfg.moe
    cf = cfg.moe_cf_override or moe.capacity_factor
    return max(1, int(S * moe.top_k / moe.n_experts * cf))


def top_experts(probs: torch.Tensor, K: int) -> torch.Tensor:
    """The indices (int64) of the K largest of ``probs`` along its last
    axis, largest first. A stable descending sort keeps equal
    probabilities in index order, so a tie goes to the lower expert, as
    ``jax.lax.top_k`` breaks it; ``torch.topk`` promises no order for
    ties."""
    return torch.sort(probs, dim=-1, descending=True, stable=True)[1][
        ..., :K]


def route(cfg, router: torch.Tensor, x: torch.Tensor):
    """The routing of ``x`` (B, S, d): ``(probs, top_p, top_i, pos,
    keep)``. probs (B, S, E) float32; top_p (B, S, K) the renormalised
    weights of the top K experts top_i (int64, ties to the lower index);
    pos (B, S * K) int32, each slot's place in its expert's queue,
    clamped to C - 1; keep (B, S * K), the slots within capacity."""
    moe = cfg.moe
    B, S, _ = x.shape
    E, K = moe.n_experts, moe.top_k
    C = capacity(cfg, S)
    probs = torch.softmax(x.float() @ router, dim=-1)
    top_i = top_experts(probs, K)
    top_p = torch.gather(probs, -1, top_i)
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    flat_e = top_i.reshape(B, S * K)
    # (B, E, S * K): one row an expert, so the running count is a scan
    # along the innermost axis (on the card a scan along the outer axis
    # of (B, S * K, E) took most of a full-width granite prefill)
    onehot = (flat_e[:, None, :] == torch.arange(
        E, device=x.device)[:, None]).to(torch.int32)
    seen = torch.cumsum(onehot, dim=-1, dtype=torch.int32)
    # the slot's own expert's running count, less itself: the slots of
    # that expert before it in the row
    pos = torch.gather(seen, 1, flat_e[:, None, :])[:, 0] - 1
    keep = pos < C
    return probs, top_p, top_i, torch.clamp_max(pos, C - 1), keep


def moe_ffn(cfg, lp: dict, x: torch.Tensor):
    """x: (B, S, d) -> ((B, S, d), the aux load-balancing loss, a float32
    scalar), as the JAX package's ``moe_ffn`` computes them."""
    moe = cfg.moe
    B, S, d = x.shape
    E, K = moe.n_experts, moe.top_k
    C = capacity(cfg, S)
    probs, top_p, top_i, pos, keep = route(cfg, lp["router"], x)

    # ---- aux loss (Switch): E * sum_e f_e * p_e / K ----
    me = torch.mean(probs, dim=(0, 1))
    counts = torch.bincount(top_i.reshape(-1), minlength=E)
    fe = counts.float() / (B * S)
    aux = E * torch.sum(me * fe / K)

    # ---- dispatch into (E, B, C, d) ----
    # Each (e, b, p) holds at most one kept slot, and JAX's scatter-add
    # adds 0 for every dropped one, so writing only the kept slots, with
    # no accumulation, gives its values without float atomics and the
    # same bits on a repeat. Dropped slots write to one spare row past
    # the buffer, which nothing reads.
    b_idx = torch.arange(B, device=x.device)[:, None]
    slot = (top_i.reshape(B, S * K) * B + b_idx) * C + pos     # (B, S*K)
    dest = torch.where(keep, slot, E * B * C).reshape(-1)
    xk = x.repeat_interleave(K, dim=1).reshape(B * S * K, d)
    buf = x.new_zeros(E * B * C + 1, d).index_copy(0, dest, xk)
    buf = buf[:E * B * C].view(E, B * C, d)

    # ---- expert products, batched over E ----
    # moe_accum_bf16 is JAX's preferred_element_type=bfloat16: each
    # product's result rounded to bf16 (a no-op for bf16 inputs)
    acc = torch.bfloat16 if cfg.moe_accum_bf16 else None

    def mm(a, w):
        out = torch.bmm(a, w)
        return out if acc is None else out.to(acc)

    h = mm(buf, lp["moe_gate"])
    u = mm(buf, lp["moe_up"])
    h = (F.silu(h) * u).to(x.dtype)
    out_buf = mm(h, lp["moe_down"]).to(x.dtype).reshape(E * B * C, d)

    # ---- combine: gather each slot's output, weight, sum over K ----
    slot_out = out_buf[slot.reshape(-1)].reshape(B, S * K, d)
    w = (top_p.reshape(B, S * K) * keep).to(x.dtype)
    out = torch.sum((slot_out * w[..., None]).reshape(B, S, K, d), dim=2)
    return out, aux.float()
