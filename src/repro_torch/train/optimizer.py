"""AdamW + gradient clipping + LR schedule, as ``src/repro/train/optimizer.py``.

Params are nested dicts (or lists) of tensors; the state mirrors them.
Every update runs in float32 and casts the new param back to its dtype,
as the JAX package does, with the same order of operations: linear
warmup then cosine decay to ``min_lr_frac``, one global-norm clip over
every leaf, bias-corrected moments, and weight decay on every leaf. The
update returns new params and a new step count, and writes the new
moments into the state's own ``m`` and ``v`` in place (the analogue of a
donated buffer: a step never holds two moment trees, 8 bytes a param in
float32). Every new param is allocated, and the clip scale known, before
the first moment is written, so a step that fails up to there leaves the
state as it was (``run_training`` replays a step on it); a failure after
it raises ``MomentsConsumed``, which ``run_training`` does not replay on
the same state. Each leaf is updated a flat slice of at most
``UPDATE_SLICE`` elements at a time, so the float32 temporaries stay at
one slice's size; the update is elementwise, so the bits are those of
one pass over the leaf. ``AdamWState`` is a NamedTuple of ``step``,
``m`` and ``v``, so a checkpoint flattens it in JAX's order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from .tree import tree_flatten, tree_map

# the most elements of a leaf updated at once (a float32 temporary of
# 256 MB): a larger leaf goes a flat slice at a time
UPDATE_SLICE = 1 << 26


class MomentsConsumed(RuntimeError):
    """An update failed after it had written some of the moments in
    place: the state no longer holds the step's old moments, so the step
    cannot be replayed on it."""


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
    """Returns ``(new_params, new_state, stats)``. ``new_state`` holds
    ``state``'s own ``m`` and ``v`` tensors, updated in place; a caller
    that needs the old moments after the step clones them first. Raises
    ``MomentsConsumed`` where it fails after its first moment write."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())

    # every allocation first: the new params and the flat views (m and v
    # must be views, as they are written in place)
    flat = []

    def alloc(p, g, m, v):
        newp = torch.empty(p.shape, dtype=p.dtype, device=p.device)
        flat.append((p.reshape(-1), g.reshape(-1), m.view(-1), v.view(-1),
                     newp.view(-1)))
        return newp

    new_params = tree_map(alloc, params, grads, state.m, state.v)
    written = False
    try:
        for leaf in flat:
            for p, g, m, v, newp in zip(*(t.split(UPDATE_SLICE)
                                          for t in leaf)):
                # JAX's expressions, operation for operation; the in-place
                # forms (on temporaries only) give the same bits with
                # fewer float32 copies of a slice alive at once; copy_
                # rounds to the moment's and the param's dtype as .to()
                g = g.float() * scale
                m32 = (b1 * m.float()).add_((1 - b1) * g)
                v32 = (b2 * v.float()).add_(((1 - b2) * g).mul_(g))
                den = (v32 / bc2).sqrt_().add_(cfg.eps)
                delta = (m32 / bc1).div_(den)
                del den
                written = True
                m.copy_(m32)
                v.copy_(v32)
                del m32, v32
                delta.add_(cfg.weight_decay * p.float())
                newp.copy_(torch.sub(p.float(), delta.mul_(lr)))
    except Exception as e:
        if written:
            raise MomentsConsumed(f"the AdamW update failed after writing "
                                  f"moments in place: {e!r}") from e
        raise
    return new_params, AdamWState(step=step, m=state.m, v=state.v), {
        "grad_norm": gnorm, "lr": lr}
