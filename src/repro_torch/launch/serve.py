"""Serving launcher: scoring for the two-tower recsys model.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch two-tower-retrieval --reduced --batch 512

The counterpart of ``src/repro/launch/serve.py``. It runs on the card
unless ``--device cpu`` is given, and raises when there is no card. The
recsys branch draws params on the device from a ``torch.Generator``
seeded with 0, and ids as ``rng.integers(-1, vocab, (B, n_fields,
bag))`` with ``np.random.default_rng(0)``; it scores them once under
``torch.inference_mode()`` and prints the time. LM archs raise
``NotImplementedError`` naming their ROADMAP.md item; GNN archs exit,
as in the JAX package, since they are trained, not served.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCH_IDS, FAMILIES, PENDING_ITEMS, get_arch
from ..models import recsys as rec_mod
from ..partition_api import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    family = FAMILIES[args.arch]
    if family == "gnn":
        raise SystemExit("gnn archs are trained, not served; use train.py")
    if family != "recsys":
        raise NotImplementedError(
            f"serving {args.arch!r} is not ported to torch yet; see "
            f"{PENDING_ITEMS[family]}")
    device = resolve_device(args.device)
    cfg = get_arch(args.arch).build_cfg(reduced=args.reduced)
    rng = np.random.default_rng(0)
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
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
    if s.shape != (args.batch,) or not bool(torch.isfinite(s).all()):
        raise RuntimeError(f"scores of shape {tuple(s.shape)} are not "
                           f"({args.batch},) finite values")
    print(f"{args.arch}: scored {args.batch} pairs in {dt * 1e3:.1f} ms "
          f"on {device.type}")
    return s


if __name__ == "__main__":
    main()
