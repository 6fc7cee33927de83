"""Compute the JAX package's LM training losses that chip_smoke.py pins.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/jax_lm_losses.py [--port]

Runs, on the CPU, the JAX package on the inputs chip_smoke.py makes for
its ``lm_train_parity`` phase, by the same recipe: the reduced
stablelm-3b config (2 layers, d_model 64, vocab 512) in float32 and in
bfloat16, params from chip_smoke's ``lm_numpy_params`` (cast to the
config's dtype), batches from ``lm_parity_batches``, and
``repro.train.train_loop.make_train_step`` of ``lm_loss`` with
``AdamWConfig(**LM_TRAIN_PARITY_OPT)`` and ``accum_steps=2``, for
``LM_TRAIN_PARITY_STEPS`` steps. It prints ``LM_TRAIN_JAX_LOSSES``.

With ``--port`` it also runs the port (``repro_torch``) on the CPU on the
same inputs and prints its losses and their largest difference from
JAX's, the figure chip_smoke's bf16 tolerance is set against. It takes
about half a minute. It is a helper, not a test: pytest does not collect
it.
"""
import argparse
import dataclasses
import json
import pathlib
import sys

import jax
import jax.numpy as jnp

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402

from repro.configs import get_arch  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.train.optimizer import AdamWConfig, init_adamw  # noqa: E402
from repro.train.train_loop import make_train_step  # noqa: E402


def jax_losses(dtype: str) -> list:
    cfg = dataclasses.replace(get_arch(cs.LM_TRAIN_ARCH).build_cfg(
        reduced=True), dtype=getattr(jnp, dtype))
    params = jax.tree.map(lambda a: jnp.asarray(a, cfg.dtype),
                          cs.lm_numpy_params(cfg))
    opt_cfg = AdamWConfig(**cs.LM_TRAIN_PARITY_OPT)
    opt = init_adamw(params, opt_cfg)
    step = jax.jit(make_train_step(
        lambda p, b: jax_tf.lm_loss(p, b, cfg), opt_cfg, accum_steps=2))
    losses = []
    for batch in cs.lm_parity_batches(cfg.vocab):
        params, opt, m = step(params, opt, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
        losses.append(float(m["loss"]))
    return losses


def port_losses(dtype: str) -> list:
    import torch

    from repro_torch import convert
    from repro_torch.configs import get_arch as port_arch
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import AdamWConfig as PortOpt
    from repro_torch.train.optimizer import init_adamw as port_init
    from repro_torch.train.train_loop import make_train_step as port_step
    cfg = dataclasses.replace(port_arch(cs.LM_TRAIN_ARCH).build_cfg(
        reduced=True), dtype=getattr(torch, dtype))
    params = convert.transformer_params_from_numpy(cs.lm_numpy_params(cfg),
                                                   cfg)
    opt_cfg = PortOpt(**cs.LM_TRAIN_PARITY_OPT)
    opt = port_init(params, opt_cfg)
    step = port_step(lambda p, b: tf.lm_loss(p, b, cfg), opt_cfg,
                     accum_steps=2)
    losses = []
    for batch in cs.lm_parity_batches(cfg.vocab):
        params, opt, m = step(params, opt, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
        losses.append(float(m["loss"]))
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", action="store_true",
                    help="also run the port on the CPU beside JAX")
    args = ap.parse_args(argv)
    want = {dt: jax_losses(dt) for dt in ("float32", "bfloat16")}
    print("LM_TRAIN_JAX_LOSSES =", json.dumps(want))
    if args.port:
        for dt, ref in want.items():
            got = port_losses(dt)
            print(f"port {dt}: {json.dumps(got)}; largest |port - jax| "
                  f"{max(abs(a - b) for a, b in zip(got, ref)):.3e}")


if __name__ == "__main__":
    main()
