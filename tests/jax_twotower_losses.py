"""Compute the JAX package's two-tower training losses that chip_smoke.py
pins.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/jax_twotower_losses.py \
        [--port]

Runs, on the CPU, the JAX package on the inputs chip_smoke.py makes for
its ``recsys_train_parity`` phase, by the same recipe: the reduced
two-tower-retrieval config (embed 16, towers 64-32-16, vocab 1,024),
params from chip_smoke's ``twotower_numpy_params`` drawn from
``default_rng(5)`` and cast to float32, batches from
``recsys_parity_batches``, and ``repro.train.train_loop.make_train_step``
of ``twotower_loss`` with ``AdamWConfig(**RECSYS_PARITY_OPT)``, for
``RECSYS_PARITY_STEPS`` steps, without and with ``compress_grads`` (the
error feedback from ``init_error_feedback``). It prints
``RECSYS_TRAIN_JAX_LOSSES``.

With ``--port`` it also runs the port (``repro_torch``) on the CPU on the
same inputs and prints its losses and their largest difference from
JAX's. It takes a few seconds. It is a helper, not a test: pytest does
not collect it.
"""
import argparse
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402

from repro.configs import get_arch  # noqa: E402
from repro.models import recsys as jax_rec  # noqa: E402
from repro.train.grad_compression import init_error_feedback  # noqa: E402
from repro.train.optimizer import AdamWConfig, init_adamw  # noqa: E402
from repro.train.train_loop import make_train_step  # noqa: E402

VARIANTS = ("plain", "compressed")


def numpy_params(cfg) -> dict:
    tree = cs.twotower_numpy_params(cfg, np.random.default_rng(5))
    return jax.tree.map(lambda a: a.astype(np.float32), tree)


def jax_losses(variant: str) -> list:
    cfg = get_arch("two-tower-retrieval").build_cfg(reduced=True)
    params = jax.tree.map(jnp.asarray, numpy_params(cfg))
    opt_cfg = AdamWConfig(**cs.RECSYS_PARITY_OPT)
    state = [params, init_adamw(params, opt_cfg)]
    compress = variant == "compressed"
    if compress:
        state.append(init_error_feedback(params))
    step = jax.jit(make_train_step(
        lambda p, b: jax_rec.twotower_loss(p, b, cfg), opt_cfg,
        compress_grads=compress))
    losses = []
    for batch in cs.recsys_parity_batches(cfg):
        params, opt, m, *err = step(*state[:2], {
            k: jnp.asarray(v) for k, v in batch.items()}, *state[2:])
        state = [params, opt, *err]
        losses.append(float(m["loss"]))
    return losses


def port_losses(variant: str) -> list:
    import torch

    from repro_torch import convert
    from repro_torch.configs import get_arch as port_arch
    from repro_torch.models import recsys
    from repro_torch.train.grad_compression import (
        init_error_feedback as port_err)
    from repro_torch.train.optimizer import AdamWConfig as PortOpt
    from repro_torch.train.optimizer import init_adamw as port_init
    from repro_torch.train.train_loop import make_train_step as port_step
    cfg = port_arch("two-tower-retrieval").build_cfg(reduced=True)
    params = convert.twotower_params_from_numpy(numpy_params(cfg), cfg)
    opt_cfg = PortOpt(**cs.RECSYS_PARITY_OPT)
    state = [params, port_init(params, opt_cfg)]
    compress = variant == "compressed"
    if compress:
        state.append(port_err(params))
    step = port_step(lambda p, b: recsys.twotower_loss(p, b, cfg), opt_cfg,
                     compress_grads=compress)
    losses = []
    for batch in cs.recsys_parity_batches(cfg):
        params, opt, m, *err = step(*state[:2], {
            k: torch.from_numpy(v) for k, v in batch.items()}, *state[2:])
        state = [params, opt, *err]
        losses.append(float(m["loss"]))
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", action="store_true",
                    help="also run the port on the CPU beside JAX")
    args = ap.parse_args(argv)
    want = {v: jax_losses(v) for v in VARIANTS}
    print("RECSYS_TRAIN_JAX_LOSSES =", json.dumps(want))
    if args.port:
        for v, ref in want.items():
            got = port_losses(v)
            print(f"port {v}: {json.dumps(got)}; largest |port - jax| "
                  f"{max(abs(a - b) for a, b in zip(got, ref)):.3e}")


if __name__ == "__main__":
    main()
