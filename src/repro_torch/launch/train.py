"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch graphsage-reddit --reduced --steps 4 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch graphsage-reddit --shape minibatch_lg --steps 5
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch graphsage-reddit --shape ogb_products --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch stablelm-3b --reduced --steps 4 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch mixtral-8x22b --reduced --steps 4 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch two-tower-retrieval --reduced --steps 4 --device cpu

The counterpart of ``src/repro/launch/train.py`` for the GNN, LM (dense
and MoE) and two-tower families. It runs on the card unless ``--device cpu`` is
given, and raises when there is no card. As the JAX launcher does:

* GNN: it trains on one fixed batch from ``random_graph`` over the
  shape's padded size (``build_graph_batch`` with 5 label classes;
  ``graph_batch``), full-batch ogb_products included (2,449,408 nodes,
  61,859,328 edges: a batch of about 3.6 GB on the card), and
  draws every param as ``rng.normal(shape)`` in float32 times 0.1, cast
  to the param's dtype, in JAX's flatten order over the sorted keys (so
  the params equal the JAX launcher's bit for bit).
* LM: it reads ``(accum, mb, seq)`` from the shape's token spec, draws
  step ``i``'s batch as ``TokenStream(vocab, accum * mb, seq,
  seed=0).batch_at(i)`` split into ``accum`` microbatches of ``(mb,
  seq)`` (the JAX launcher's batches, bit for bit), and trains
  ``lm_loss`` with ``accum_steps=accum`` (an MoE arch's aux loss
  included, as in JAX).
  Params come from ``init_params`` with a ``torch.Generator`` of the
  device seeded with 0, as the serve launcher's (JAX's ``jax.random``
  init is not carried over).
* two-tower: it reads ``(B, n_fields, bag)`` from the shape's
  ``user_ids`` spec (``train_batch``), draws step ``i``'s batch as
  ``RecsysStream(user_vocab, item_vocab, B, n_fields=, bag=)
  .batch_at(i)`` (the JAX launcher's batches, bit for bit) and trains
  ``twotower_loss``. Params come from ``init_twotower_params`` with a
  ``torch.Generator`` of the device seeded with 0, as the LM's. At full
  width the tables, their dense gradients and AdamW moments take about
  137 GB, more than one card holds; ``--reduced`` fits the CPU.

Each takes the arch's AdamW from ``launch.cells`` (the default for every
GNN and for two-tower, as in JAX) and drives ``run_training`` with
checkpoints in ``<ckpt_dir>/<arch>``. A directory that already holds a
checkpoint resumes from it. Returns the ``TrainResult``.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..configs import ARCH_IDS, FAMILIES, get_arch
from ..data.graphs import build_graph_batch, random_graph
from ..data.pipeline import RecsysStream, TokenStream
from ..models import transformer as tf_mod
from ..models.gnn import gnn_loss, init_gnn_params
from ..models.recsys import init_twotower_params, twotower_loss
from ..core.partition_api import resolve_device
from ..train.fault_tolerance import FTConfig, run_training
from ..train.optimizer import init_adamw
from ..train.train_loop import make_train_step, split_microbatches
from ..train.tree import tree_map
from .cells import opt_config

DEFAULT_SHAPE = {"lm": "train_4k", "gnn": "full_graph_sm",
                 "recsys": "train_batch"}


def graph_batch(n: int, e: int, d_feat: int, device, seed: int = 0,
                keys=None) -> dict:
    """The JAX launcher's one GNN batch (``_gnn_batches``) at n nodes and
    e edges: ``random_graph`` over n with e / n edges a node, cut to e,
    then ``build_graph_batch`` with 5 label classes (JAX's ``int(labels
    and 5) or 5``) padded to n and e; the arrays named in ``keys`` (all
    when None), on ``device``."""
    src, dst = random_graph(n, max(e / n, 1.0), seed=seed)
    src, dst = src[:e], dst[:e]
    base = build_graph_batch(n, src, dst, d_feat, 5, seed=seed,
                             pad_nodes=n, pad_edges=e)
    return {k: torch.from_numpy(v).to(device) for k, v in base.items()
            if keys is None or k in keys}


def gnn_batches(arch, shape: str, reduced: bool, device, seed: int = 0):
    """The JAX launcher's ``_gnn_batches``: one fixed batch for every
    step, the input spec's keys only, on ``device``."""
    spec = arch.input_specs(shape, reduced=reduced)
    (n, d_feat), _ = spec["nodes"]
    base = graph_batch(n, spec["edge_src"][0][0], d_feat, device, seed,
                       keys=spec)
    return lambda step: base


def launcher_params(cfg, device, seed: int = 0) -> dict:
    """The JAX launcher's params: every leaf ``rng.normal(shape)`` in
    float32 times 0.1, cast to its dtype, in JAX's flatten order."""
    rng = np.random.default_rng(seed)
    like = init_gnn_params(torch.Generator().manual_seed(0), cfg, "cpu")

    def draw(t):
        a = rng.normal(size=tuple(t.shape)).astype(np.float32) * 0.1
        return torch.from_numpy(a).to(device=device, dtype=t.dtype)

    return tree_map(draw, like)


def lm_batches(arch, shape: str, reduced: bool, vocab: int, device):
    """The JAX launcher's LM batches: step ``i`` is
    ``TokenStream(vocab, accum * mb, seq, seed=0).batch_at(i)``, each
    leaf reshaped to the spec's ``(accum, mb, seq)``, on ``device``."""
    (accum, mb, seq), _ = arch.input_specs(shape, reduced=reduced)["tokens"]
    stream = TokenStream(vocab, accum * mb, seq, seed=0)

    def batch_at(step):
        batch = split_microbatches({k: torch.from_numpy(v) for k, v in
                                    stream.batch_at(step).items()}, accum)
        return {k: v.to(device) for k, v in batch.items()}

    return batch_at, accum


def recsys_params(cfg, device) -> dict:
    """The launcher's two-tower params: ``init_twotower_params`` from a
    generator of ``device`` seeded with 0."""
    gen = torch.Generator(device=device).manual_seed(0)
    return init_twotower_params(gen, cfg, device)


def recsys_batches(arch, shape: str, reduced: bool, cfg, device):
    """The JAX launcher's two-tower batches: step ``i`` is
    ``RecsysStream(user_vocab, item_vocab, B, n_fields=, bag=)
    .batch_at(i)`` with ``(B, n_fields, bag)`` from the shape's
    ``user_ids`` spec, on ``device``."""
    (B, n_fields, bag), _ = arch.input_specs(shape, reduced=reduced)[
        "user_ids"]
    stream = RecsysStream(cfg.user_vocab, cfg.item_vocab, B,
                          n_fields=n_fields, bag=bag)
    return lambda step: {k: torch.from_numpy(v).to(device)
                         for k, v in stream.batch_at(step).items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-trainable)")
    ap.add_argument("--ckpt_dir", default="artifacts/ckpt")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    family = FAMILIES[args.arch]
    arch = get_arch(args.arch)           # unported archs raise here
    shape = args.shape or DEFAULT_SHAPE[family]
    if arch.step_kind(shape) != "train":
        raise ValueError(f"train.py drives train cells; {shape!r} is "
                         f"{arch.step_kind(shape)!r}")
    device = resolve_device(args.device)

    if family == "lm":
        cfg = arch.build_cfg(reduced=args.reduced)
        gen = torch.Generator(device=device).manual_seed(0)
        params = tf_mod.init_params(gen, cfg, device)
        batch_at, accum = lm_batches(arch, shape, args.reduced, cfg.vocab,
                                     device)
        loss_fn = lambda p, b: tf_mod.lm_loss(p, b, cfg)  # noqa: E731
    elif family == "recsys":
        cfg = arch.build_cfg(reduced=args.reduced)
        params = recsys_params(cfg, device)
        batch_at = recsys_batches(arch, shape, args.reduced, cfg, device)
        loss_fn = lambda p, b: twotower_loss(p, b, cfg)  # noqa: E731
        accum = 1
    else:
        cfg = arch.build_cfg(reduced=args.reduced, shape=shape)
        params = launcher_params(cfg, device)
        batch_at = gnn_batches(arch, shape, args.reduced, device)
        loss_fn, accum = lambda p, b: gnn_loss(p, b, cfg), 1  # noqa: E731
    opt_cfg = opt_config(args.arch)
    step_fn = make_train_step(loss_fn, opt_cfg, accum_steps=accum)
    opt = init_adamw(params, opt_cfg)

    os.makedirs(args.ckpt_dir, exist_ok=True)
    t0 = time.time()
    res = run_training(step_fn, (params, opt), None, args.steps,
                       FTConfig(ckpt_dir=os.path.join(args.ckpt_dir,
                                                      args.arch)),
                       batch_at=batch_at)
    losses = [m["loss"] for m in res.metrics_history if "loss" in m]
    if losses:
        print(f"{args.arch}/{shape}: {res.steps_done} steps in "
              f"{time.time() - t0:.1f}s on {device.type}; loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    else:
        print(f"{args.arch}/{shape}: resumed at step {res.steps_done}; "
              f"no step to run")
    return res


if __name__ == "__main__":
    main()
