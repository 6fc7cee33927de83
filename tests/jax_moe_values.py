"""Compute the JAX package's MoE values that chip_smoke.py pins.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/jax_moe_values.py [--port]

Runs, on the CPU, the JAX package on the inputs chip_smoke.py makes for
its ``moe_parity`` phase, by the same recipe (the comment above
``MOE_PARITY_ARCHS``): the reduced granite-moe-3b-a800m and mixtral-8x22b
configs in float32 and bfloat16, params from chip_smoke's
``lm_numpy_params`` (the router kept float32), prompts from
``moe_parity_prompts``. Serving: prefill, the cache padded to
``MOE_PARITY_SLOTS``, ``MOE_PARITY_STEPS`` greedy ``serve_step``s, then
as many ``serve_step_paged`` steps from the padded prefill, fed the same
tokens, appending their K/V at slot ``pos % MOE_PARITY_SLOTS``. The
layers run one by one (``scan_layers=False``), eagerly, so that each
``moe_ffn`` call's experts can be read on the way. Training:
``make_train_step`` of ``lm_loss`` with accum_steps 2 on
``lm_parity_batches``, jitted. It prints ``MOE_JAX_VALUES``: per arch and
dtype the greedy tokens, the experts of every MoE call (a digit an
expert, in call order), the first ``MOE_PARITY_COLS`` logits of every
row of the 9 serving calls, and the 4 losses.

With ``--port`` it also runs the port (``repro_torch``) on the CPU on the
same inputs (on JAX's experts, as chip_smoke feeds it) and prints its
largest differences from JAX's values and the number of (token, call)
pairs whose own experts differ. It takes about a minute. It is a helper,
not a test: pytest does not collect it.
"""
import argparse
import contextlib
import dataclasses
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402

from repro.configs import get_arch  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.train.optimizer import AdamWConfig, init_adamw  # noqa: E402
from repro.train.train_loop import make_train_step  # noqa: E402


def jax_cfg(arch: str, dtype: str, **changes):
    return dataclasses.replace(get_arch(arch).build_cfg(reduced=True),
                               dtype=getattr(jnp, dtype), **changes)


def jax_params(tree: dict, cfg) -> dict:
    """``tree`` (numpy) as JAX arrays of ``cfg.dtype``, the router kept
    float32."""
    def cast(name, a):
        return jnp.asarray(a, jnp.float32 if name == "router" else cfg.dtype)
    out = {k: cast(k, v) for k, v in tree.items() if k != "layers"}
    out["layers"] = {k: cast(k, v) for k, v in tree["layers"].items()}
    return out


@contextlib.contextmanager
def jax_routes():
    """Collects the experts (``jax.lax.top_k`` of the router's softmax,
    as ``moe_ffn`` takes them) of every eager ``moe_ffn`` call that
    ``repro.models.transformer`` makes while it is open."""
    calls, orig = [], jax_tf.moe_ffn

    def spy(cfg, lp, x):
        probs = jax.nn.softmax(x.astype(jnp.float32) @ lp["router"], -1)
        calls.append(np.asarray(jax.lax.top_k(probs, cfg.moe.top_k)[1]))
        return orig(cfg, lp, x)

    jax_tf.moe_ffn = spy
    try:
        yield calls
    finally:
        jax_tf.moe_ffn = orig


def jax_serve(arch: str, dtype: str, cols=None) -> dict:
    """The serving recipe through the JAX package: ``tokens`` (the greedy
    tokens fed to decode), ``routes`` (a digit string a call), ``logits`` (the
    9 calls' (B, V) logits, or their first ``cols`` columns),
    ``k_new``/``v_new`` of the first paged step and the prefill
    ``cache``."""
    cfg = jax_cfg(arch, dtype, scan_layers=False)
    stacked = jax_params(cs.lm_numpy_params(cfg), cfg)
    params = dict(stacked, layers=[
        {k: v[i] for k, v in stacked["layers"].items()}
        for i in range(cfg.n_layers)])
    prompts = jnp.asarray(cs.moe_parity_prompts(cfg.vocab))
    with jax_routes() as calls:
        cache, logits = jax_tf.prefill(params, prompts, cfg)
        prefill_cache = cache
        pad = cs.MOE_PARITY_SLOTS - cache["k"].shape[2]
        width = ((0, 0), (0, 0), (0, pad), (0, 0), (0, 0))
        cache = {"k": jnp.pad(cache["k"], width),
                 "v": jnp.pad(cache["v"], width), "pos": cache["pos"]}
        paged = dict(cache)
        logs, toks = [logits], []
        for _ in range(cs.MOE_PARITY_STEPS):
            toks.append(jnp.argmax(logits, -1).astype(jnp.int32))
            logits, cache = jax_tf.serve_step(params, cache,
                                              toks[-1][:, None], cfg)
            logs.append(logits)
        first = None
        for tok in toks:
            logits, k_new, v_new, pos = jax_tf.serve_step_paged(
                params, paged, tok[:, None], cfg)
            slot = int(paged["pos"]) % cs.MOE_PARITY_SLOTS
            paged = {"k": paged["k"].at[:, :, slot].set(k_new[:, :, 0]),
                     "v": paged["v"].at[:, :, slot].set(v_new[:, :, 0]),
                     "pos": pos}
            first = (k_new, v_new) if first is None else first
            logs.append(logits)
    logs = [np.asarray(lg, np.float32)[:, :cols] for lg in logs]
    return {"tokens": [np.asarray(t).tolist() for t in toks],
            "routes": ["".join(str(int(i)) for i in c.reshape(-1))
                       for c in calls],
            "logits": logs, "k_new": np.asarray(first[0], np.float32),
            "v_new": np.asarray(first[1], np.float32),
            "cache": {k: np.asarray(prefill_cache[k], np.float32)
                      for k in ("k", "v")}}


def jax_losses(arch: str, dtype: str) -> list:
    cfg = jax_cfg(arch, dtype)
    params = jax_params(cs.lm_numpy_params(cfg), cfg)
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


def _short(a):
    """float32 values (nested lists) as the shortest decimals that give
    them back."""
    a = np.asarray(a, np.float32)
    return [_short(x) for x in a] if a.ndim else float(str(a[()]))


def jax_values(arch: str, dtype: str) -> dict:
    """One (arch, dtype) entry of MOE_JAX_VALUES."""
    serve = jax_serve(arch, dtype, cs.MOE_PARITY_COLS)
    return {"tokens": serve["tokens"], "routes": serve["routes"],
            "logits": _short(serve["logits"]),
            "losses": _short(jax_losses(arch, dtype))}


def pin_block(values: dict) -> str:
    """``MOE_JAX_VALUES`` as chip_smoke.py holds it: JSON, broken after
    commas into lines of at most 79 characters."""
    lines, line = [], ""
    for tok in json.dumps(values, separators=(",", ":")).split(","):
        piece = tok + ","
        if line and len(line) + len(piece) > 79:
            lines.append(line)
            line = ""
        line += piece
    lines.append(line[:-1])
    return 'MOE_JAX_VALUES = json.loads("""\n' + "\n".join(lines) + '\n""")'


def port_values(arch: str, dtype: str, pins: dict) -> dict:
    """The port on the CPU by the same recipe, fed ``pins``' tokens and
    experts: its serving check row (chip_smoke's ``moe_parity_check``),
    the (token, call) pairs whose own experts differ, and its losses."""
    import torch

    from repro_torch import convert
    from repro_torch.configs import get_arch as port_arch
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(port_arch(arch).build_cfg(reduced=True),
                              dtype=getattr(torch, dtype))
    params = convert.transformer_params_from_numpy(cs.lm_numpy_params(cfg),
                                                   cfg)
    with cs.RouteLog(moe_mod, cfg, pinned="".join(pins["routes"])) as log:
        logs, _ = cs.moe_parity_serve(tf, cfg, params,
                                      cs.moe_parity_prompts(cfg.vocab),
                                      pins["tokens"])
    losses, _ = cs.moe_train_losses(tf, convert, cfg, "cpu")
    return {**cs.moe_parity_check(logs, pins, dtype),
            "routes_differ": log.differing(), "losses": losses,
            "losses_max_abs_diff": max(abs(a - b) for a, b in
                                       zip(losses, pins["losses"]))}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", action="store_true",
                    help="also run the port on the CPU beside JAX")
    args = ap.parse_args(argv)
    want = {arch: {dt: jax_values(arch, dt)
                   for dt in ("float32", "bfloat16")}
            for arch in cs.MOE_PARITY_ARCHS}
    print(pin_block(want))
    if args.port:
        for arch, per in want.items():
            for dt, pins in per.items():
                got = port_values(arch, dt, pins)
                print(f"port {arch} {dt}: {json.dumps(got)}")


if __name__ == "__main__":
    main()
