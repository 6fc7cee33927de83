"""Train-step factory, as ``src/repro/train/train_loop.py``.

``make_train_step(loss_fn, opt_cfg, accum_steps=..., compress_grads=...)``
returns

    train_step(params, opt_state, batch[, err]) -> (params, opt_state,
                                                    metrics[, err])

With ``accum_steps > 1`` every batch leaf has a leading accumulation
axis (``split_microbatches`` makes it); the microbatches run in a loop
(the JAX package's ``lax.scan``), so activations live for one
microbatch, and the gradients accumulate in float32: each microbatch's
``g / accum_steps`` is added in place into one float32 buffer that the
step owns (the same sums as JAX's ``a + b / accum_steps``, so the same
bits, without a second float32 tree a microbatch). With
``compress_grads`` the step takes and returns the error-feedback tree
``err`` (``grad_compression.init_error_feedback(params)`` to start),
and the gradients go through ``compress_tree`` after accumulation and
before AdamW, as in JAX.
"""
from __future__ import annotations

from typing import Callable

import torch

from .grad_compression import compress_tree
from .optimizer import AdamWConfig, adamw_update
from .tree import tree_flatten, tree_map, tree_unflatten


def value_and_grad(loss_fn: Callable, params, batch):
    """``(loss, grads)`` of ``loss_fn(params, batch)``, the grads shaped
    like ``params`` (``jax.value_and_grad``)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_flatten(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig, *,
                    accum_steps: int = 1, compress_grads: bool = False):
    """loss_fn(params, batch) -> scalar loss."""

    def train_step(params, opt_state, batch, err=None):
        if compress_grads != (err is not None):
            raise ValueError("train_step takes the error-feedback tree err "
                             "exactly when compress_grads is on")
        if accum_steps > 1:
            loss = torch.zeros((), dtype=torch.float32)
            grads = None
            for i in range(accum_steps):
                mb = tree_map(lambda x: x[i], batch)
                l_i, g_i = value_and_grad(loss_fn, params, mb)
                if grads is None:
                    loss = loss.to(l_i.device)
                    grads = tree_map(lambda p: torch.zeros(
                        p.shape, dtype=torch.float32, device=p.device),
                        params)
                for a, b in zip(tree_flatten(grads), tree_flatten(g_i)):
                    a.add_(b.float() / accum_steps)
                del g_i
                loss = loss + l_i / accum_steps
        else:
            loss, grads = value_and_grad(loss_fn, params, batch)
        if compress_grads:
            grads, err = compress_tree(grads, err)
        params, opt_state, stats = adamw_update(grads, opt_state, params,
                                                opt_cfg)
        metrics = {"loss": loss.float(), **stats}
        if compress_grads:
            return params, opt_state, metrics, err
        return params, opt_state, metrics

    return train_step



def split_microbatches(batch: dict, accum_steps: int) -> dict:
    """Reshape each leaf (B, ...) -> (accum, B/accum, ...)."""
    def f(x):
        b = x.shape[0]
        assert b % accum_steps == 0, (b, accum_steps)
        return x.reshape(accum_steps, b // accum_steps, *x.shape[1:])
    return tree_map(f, batch)
