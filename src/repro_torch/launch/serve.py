"""Serving launcher: batched greedy decode for LM archs, scoring for recsys.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \\
        --reduced --tokens 16
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch granite-moe-3b-a800m --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch two-tower-retrieval --reduced --batch 512

The counterpart of ``src/repro/launch/serve.py``. It runs on the card
unless ``--device cpu`` is given, and raises when there is no card.
Params are drawn on the device from a ``torch.Generator`` seeded with 0,
inputs from ``np.random.default_rng(0)``, and the work runs under
``torch.inference_mode()``.

The LM branch draws prompts ``rng.integers(0, vocab, (B, prompt_len))``,
runs ``prefill``, then ``--tokens`` greedy ``serve_step``s on the cache
that prefill returns, unpadded, as the JAX launcher does: from the first
step on, each new token overwrites the oldest slot of the rolling cache.
It prints tokens per second, prefill included. The recsys branch draws
ids ``rng.integers(-1, vocab, (B, n_fields, bag))``, scores them once
and prints the time. The MoE LM archs (mixtral-8x22b,
granite-moe-3b-a800m) serve through the same branch, their FFN
``models/moe.py``'s ``moe_ffn``; GNN archs exit, as in the JAX package,
since they are trained, not served.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCH_IDS, FAMILIES, get_arch
from ..models import recsys as rec_mod
from ..models import transformer as tf_mod
from ..core.partition_api import resolve_device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_lm(args, device: torch.device, rng) -> torch.Tensor:
    """Prefill and greedy decode; returns the (B, tokens + 1) greedy
    tokens (the one after the prompt, then one per step)."""
    cfg = get_arch(args.arch).build_cfg(reduced=args.reduced)
    gen = torch.Generator(device=device).manual_seed(0)
    params = tf_mod.init_params(gen, cfg, device)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)).to(
            device)
    with torch.inference_mode():
        t0 = time.perf_counter()
        cache, logits = tf_mod.prefill(params, prompts, cfg)
        toks = [torch.argmax(logits, -1)[:, None].to(torch.int32)]
        n_out = 0
        for _ in range(args.tokens):
            logits, cache = tf_mod.serve_step(params, cache, toks[-1], cfg)
            toks.append(torch.argmax(logits, -1)[:, None].to(torch.int32))
            n_out += args.batch
        _sync(device)
        dt = time.perf_counter() - t0
    if not bool(torch.isfinite(logits.float()).all()):
        raise RuntimeError("decode gave non-finite logits")
    print(f"{args.arch}: served {n_out} tokens in {dt:.2f}s "
          f"({n_out / dt:.1f} tok/s incl. prefill) on {device.type}")
    return torch.cat(toks, dim=1)


def serve_recsys(args, device: torch.device, rng) -> torch.Tensor:
    cfg = get_arch(args.arch).build_cfg(reduced=args.reduced)
    gen = torch.Generator(device=device).manual_seed(0)
    params = rec_mod.init_twotower_params(gen, cfg, device)
    ids = (args.batch, cfg.n_fields, cfg.bag_size)
    batch = {
        "user_ids": torch.from_numpy(
            rng.integers(-1, cfg.user_vocab, ids).astype(np.int32)).to(device),
        "item_ids": torch.from_numpy(
            rng.integers(-1, cfg.item_vocab, ids).astype(np.int32)).to(device),
    }
    with torch.inference_mode():
        t0 = time.perf_counter()
        s = rec_mod.score_batch(params, batch, cfg)
        _sync(device)
        dt = time.perf_counter() - t0
    if s.shape != (args.batch,) or not bool(torch.isfinite(s).all()):
        raise RuntimeError(f"scores of shape {tuple(s.shape)} are not "
                           f"({args.batch},) finite values")
    print(f"{args.arch}: scored {args.batch} pairs in {dt * 1e3:.1f} ms "
          f"on {device.type}")
    return s


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt_len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    family = FAMILIES[args.arch]
    if family == "gnn":
        raise SystemExit("gnn archs are trained, not served; use train.py")
    get_arch(args.arch)                  # unported archs raise here
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    if family == "lm":
        return serve_lm(args, device, rng)
    return serve_recsys(args, device, rng)


if __name__ == "__main__":
    main()
