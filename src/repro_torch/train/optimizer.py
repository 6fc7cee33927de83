"""AdamW + gradient clipping + LR schedule, as ``src/repro/train/optimizer.py``.

Params are nested dicts (or lists) of tensors; the state mirrors them.
Every update runs in float32 and casts the new param back to its dtype,
as the JAX package does, with the same order of operations: linear
warmup then cosine decay to ``min_lr_frac``, one global-norm clip over
every leaf, bias-corrected moments, and weight decay on every leaf. The
update returns new tensors and leaves its inputs as they were (JAX's
arrays are immutable; the fault-tolerant driver relies on it to replay a
step). ``AdamWState`` is a NamedTuple of ``step``, ``m`` and ``v``, so a
checkpoint flattens it in JAX's order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from .tree import tree_flatten, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    moment_dtype: Optional[torch.dtype] = None   # None -> float32


class AdamWState(NamedTuple):
    step: torch.Tensor             # () int32
    m: dict
    v: dict


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay, in float32 on ``step``'s device."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init_adamw(params, cfg: AdamWConfig) -> AdamWState:
    dt = cfg.moment_dtype or torch.float32
    leaves = tree_flatten(params)
    device = leaves[0].device if leaves else "cpu"

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    leaves = tree_flatten(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves))


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, cfg: AdamWConfig):
    """Returns ``(new_params, new_state, stats)``."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())
    mdt = cfg.moment_dtype or torch.float32

    def upd(p, g, m, v):
        # JAX's expressions, operation for operation; the in-place forms
        # (on temporaries only) give the same bits with fewer float32
        # copies of a leaf alive at once (one leaf of a 3B model's is
        # 2.26 GB)
        g = g.float() * scale
        m32 = (b1 * m.float()).add_((1 - b1) * g)
        v32 = (b2 * v.float()).add_(((1 - b2) * g).mul_(g))
        den = (v32 / bc2).sqrt_().add_(cfg.eps)
        delta = (m32 / bc1).div_(den)
        del den
        delta.add_(cfg.weight_decay * p.float())
        newp = torch.sub(p.float(), delta.mul_(lr))
        del delta
        return newp.to(p.dtype), m32.to(mdt), v32.to(mdt)

    out = tree_map(upd, params, grads, state.m, state.v)
    is_t = lambda t: isinstance(t, tuple)  # noqa: E731
    new_params = tree_map(lambda t: t[0], out, is_leaf=is_t)
    new_m = tree_map(lambda t: t[1], out, is_leaf=is_t)
    new_v = tree_map(lambda t: t[2], out, is_leaf=is_t)
    return new_params, AdamWState(step=step, m=new_m, v=new_v), {
        "grad_norm": gnorm, "lr": lr}
