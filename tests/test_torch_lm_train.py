"""The port's LM training (``lm_loss``, remat, accumulation, the launcher's
LM branch) against the JAX package on the CPU.

Params are JAX's ``init_params(PRNGKey(0), cfg)`` of a reduced config,
carried across with ``convert.transformer_params_from_numpy``; batches
come from the token stream (numpy, the same on both sides).

Tolerances. float32: the loss within 2e-6 (relative), every gradient leaf
within atol 1e-5 of its largest |entry| and rtol 1e-4 (both sides run
float32 on the CPU and sum in other orders; measured differences below
1.6e-6 of the largest entry), and 4 AdamW steps' losses within 1e-5.
bfloat16: JAX's einsum attention rounds scores and probabilities to bf16
where the port's kernel keeps them in float32, and every layer rounds its
residual to bf16, so the loss moves in its third decimal (measured below
1.5e-3 on losses near 6.5-7) and single gradient entries by a few bf16
steps (measured up to 2.8e-2 of a leaf's largest entry): the loss within
atol 5e-3, each leaf within 6e-2 of its largest entry and its mean error
under 2**-4 of its mean |entry|.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.data.pipeline import TokenStream as JaxTokenStream
from repro.launch import cells as jax_cells
from repro.models import transformer as jax_tf
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig
from repro.train.optimizer import init_adamw as jax_init_adamw
from repro.train.train_loop import make_train_step as jax_make_train_step
from repro.train.train_loop import split_microbatches as jax_split
from repro_torch import configs
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.data.pipeline import TokenStream
from repro_torch.launch import cells
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as tf
from repro_torch.models.common import softmax_cross_entropy
from repro_torch.train.checkpoint import latest_step
from repro_torch.train.optimizer import AdamWConfig, init_adamw
from repro_torch.train.train_loop import (make_train_step,
                                          split_microbatches,
                                          value_and_grad)
from repro_torch.train.tree import tree_flatten, tree_map

REPO = pathlib.Path(__file__).resolve().parent.parent
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=20)


def _pair(arch, dtype="float32", **changes):
    jcfg = dataclasses.replace(jax_get_arch(arch).build_cfg(reduced=True),
                               dtype=getattr(jnp, dtype), **changes)
    cfg = dataclasses.replace(configs.get_arch(arch).build_cfg(reduced=True),
                              dtype=getattr(torch, dtype), **changes)
    return jcfg, cfg


def _params(jcfg, cfg, seed=0):
    jp = jax_tf.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, transformer_params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jp), cfg)


def _batch(vocab, B, S, seed=1, step=0):
    b = TokenStream(vocab, B, S, seed=seed).batch_at(step)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _close_leaf(got, want, dtype, where):
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, where
    scale = float(np.abs(w).max())
    if dtype == "float32":
        np.testing.assert_allclose(g, w, atol=1e-5 * scale, rtol=1e-4,
                                   err_msg=where)
        return
    np.testing.assert_allclose(g, w, atol=6e-2 * scale, rtol=0,
                               err_msg=where)
    assert float(np.abs(g - w).mean()) <= 2 ** -4 * float(
        np.abs(w).mean()), where


@pytest.mark.parametrize("arch", ["stablelm-3b", "qwen3-8b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pad_vocab", [False, True])
def test_lm_loss_and_grads_equal_jax(arch, dtype, pad_vocab):
    """vocab 500 so that pad_vocab pads it to 512 (12 masked columns)."""
    jcfg, cfg = _pair(arch, dtype, pad_vocab=pad_vocab, vocab=500)
    jp, p = _params(jcfg, cfg)
    jb, b = _batch(cfg.vocab, 2, 40)
    jl, jg = jax.value_and_grad(
        lambda q, x: jax_tf.lm_loss(q, x, jcfg))(jp, jb)
    loss, grads = value_and_grad(lambda q, x: tf.lm_loss(q, x, cfg), p, b)
    assert loss.dtype == torch.float32
    if dtype == "float32":
        assert float(loss) == pytest.approx(float(jl), rel=2e-6)
    else:
        assert float(loss) == pytest.approx(float(jl), abs=5e-3)
    leaves, jleaves = tree_flatten(grads), jax.tree.leaves(jg)
    assert len(leaves) == len(jleaves)
    for i, (g, w) in enumerate(zip(leaves, jleaves)):
        assert g.dtype == cfg.dtype
        _close_leaf(g, w, dtype, f"leaf {i}")
    if pad_vocab:
        # the padded columns reach no loss: zero gradient on both sides
        assert not grads["lm_head"][:, cfg.vocab:].any()
        assert not grads["embed"][cfg.vocab:].any()


def test_lm_loss_masks_the_padded_vocabulary_to_minus_1e30():
    """A padded logit column set to -1e30 (in bf16: -1e30 rounded) adds
    nothing to the softmax: the loss equals the unpadded model's."""
    _, cfg = _pair("stablelm-3b", "bfloat16", vocab=500)
    padded = dataclasses.replace(cfg, pad_vocab=True)
    p = tf.init_params(torch.Generator().manual_seed(0), padded)
    cut = dict(p, embed=p["embed"][:500], lm_head=p["lm_head"][:, :500])
    _, b = _batch(500, 2, 24)
    with torch.no_grad():
        assert float(tf.lm_loss(p, b, padded)) == pytest.approx(
            float(tf.lm_loss(cut, b, cfg)), abs=1e-3)


def test_four_accumulated_steps_equal_jax():
    """make_train_step with accum_steps 2, fed by split_microbatches of the
    token stream's batches, against JAX's (the lax.scan of
    microbatches), float32."""
    jcfg, cfg = _pair("stablelm-3b")
    jp, p = _params(jcfg, cfg)
    jstep = jax.jit(jax_make_train_step(
        lambda q, x: jax_tf.lm_loss(q, x, jcfg), JaxAdamWConfig(**OPT),
        accum_steps=2))
    step = make_train_step(lambda q, x: tf.lm_loss(q, x, cfg),
                           AdamWConfig(**OPT), accum_steps=2)
    jo, o = jax_init_adamw(jp, JaxAdamWConfig(**OPT)), init_adamw(
        p, AdamWConfig(**OPT))
    stream = TokenStream(cfg.vocab, 4, 32, seed=0)
    got, want = [], []
    for i in range(4):
        raw = stream.batch_at(i)
        jb = jax_split({k: jnp.asarray(v) for k, v in raw.items()}, 2)
        b = split_microbatches({k: torch.from_numpy(v)
                                for k, v in raw.items()}, 2)
        assert tuple(b["tokens"].shape) == (2, 2, 32)
        jp, jo, jm = jstep(jp, jo, jb)
        p, o, m = step(p, o, b)
        want.append(float(jm["loss"]))
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    for a, w in zip(tree_flatten(p), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-4)


def test_split_microbatches_equals_jax():
    raw = TokenStream(100, 6, 5, seed=3).batch_at(2)
    for accum in (1, 2, 3, 6):
        got = split_microbatches({k: torch.from_numpy(v)
                                  for k, v in raw.items()}, accum)
        want = jax_split({k: jnp.asarray(v) for k, v in raw.items()}, accum)
        for key in raw:
            assert tuple(got[key].shape) == want[key].shape
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))
    with pytest.raises(AssertionError):
        split_microbatches({"x": torch.zeros(5)}, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_on_and_off_give_the_same_bits(dtype):
    """The checkpointed layers run the same ops again: loss and every
    gradient are bit-equal with and without remat."""
    _, cfg = _pair("qwen3-8b", dtype)
    p = tf.init_params(torch.Generator().manual_seed(0), cfg)
    _, b = _batch(cfg.vocab, 2, 48)
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        out[remat] = value_and_grad(lambda q, x: tf.lm_loss(q, x, c), p, b)
    assert torch.equal(out[False][0], out[True][0])
    for a, w in zip(tree_flatten(out[False][1]), tree_flatten(out[True][1])):
        assert torch.equal(a, w)


def test_accumulation_adds_into_one_buffer_in_place():
    """Two microbatches: the step's float32 gradient equals JAX's formula
    ``0 + g0 / 2 + g1 / 2`` bit for bit."""
    w0 = torch.tensor([[0.5, -1.25], [2.0, 0.75]])
    xs = torch.tensor([[[1.0, 2.0]], [[-3.0, 0.5]]])
    seen = {}

    def fake_update(grads, state, params, cfg):
        seen["g"] = grads
        return params, state, {}

    import repro_torch.train.train_loop as tl
    real = tl.adamw_update
    tl.adamw_update = fake_update
    try:
        step = make_train_step(lambda q, x: torch.sum((x["x"] @ q["w"]) ** 3),
                               AdamWConfig(), accum_steps=2)
        step({"w": w0}, None, {"x": xs})
    finally:
        tl.adamw_update = real
    g = [value_and_grad(lambda q, x: torch.sum((x["x"] @ q["w"]) ** 3),
                        {"w": w0}, {"x": xs[i]})[1]["w"] for i in range(2)]
    want = torch.zeros_like(w0) + g[0] / 2 + g[1] / 2
    assert seen["g"]["w"].dtype == torch.float32
    assert torch.equal(seen["g"]["w"], want)


def test_opt_table_equals_jax():
    assert sorted(cells._OPT) == sorted(jax_cells._OPT)
    for arch, want in list(jax_cells._OPT.items()) + [
            ("stablelm-3b", jax_cells._DEFAULT_OPT)]:
        got = cells.opt_config(arch)
        for field in dataclasses.fields(want):
            a, b = getattr(got, field.name), getattr(want, field.name)
            if field.name == "moment_dtype":
                assert (a is None) == (b is None)
                if b is not None:
                    assert str(a).removeprefix("torch.") == jnp.dtype(b).name
            else:
                assert a == b, field.name


@pytest.mark.parametrize("arch", ["stablelm-3b", "qwen3-8b", "llama3-405b",
                                  "granite-moe-3b-a800m", "mixtral-8x22b"])
def test_launcher_batches_equal_jax_launcher_recipe(arch):
    """The JAX launcher's LM batches: the cell's token spec (accum, mb,
    seq), TokenStream(vocab, accum * mb, seq, seed=0), each leaf reshaped;
    bit for bit."""
    plan = jax_cells.build_cell(arch, "train_4k", mesh=None, reduced=True)
    accum, mb, seq = plan.args[2]["tokens"].shape
    jcfg = jax_get_arch(arch).build_cfg(reduced=True)
    stream = JaxTokenStream(jcfg.vocab, accum * mb, seq, seed=0)
    cfg = configs.get_arch(arch).build_cfg(reduced=True)
    batch_at, got_accum = launch_train.lm_batches(
        configs.get_arch(arch), "train_4k", True, cfg.vocab, "cpu")
    assert got_accum == accum
    for step in (0, 1, 7):
        want = stream.batch_at(step)
        got = batch_at(step)
        for key in ("tokens", "labels"):
            assert tuple(got[key].shape) == (accum, mb, seq)
            assert got[key].dtype == torch.int32
            np.testing.assert_array_equal(
                got[key].numpy(), want[key].reshape(accum, mb, seq))


def test_launcher_trains_and_resumes_on_the_cpu(tmp_path):
    args = ["--arch", "stablelm-3b", "--reduced", "--steps", "4",
            "--device", "cpu", "--ckpt_dir", str(tmp_path)]
    res = launch_train.main(args)
    assert res.steps_done == 4 and res.failures_recovered == 0
    losses = [m["loss"] for m in res.metrics_history]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert not any(m.get("skipped") for m in res.metrics_history)
    d = str(tmp_path / "stablelm-3b")
    assert latest_step(d) == 4
    # the same directory resumes at step 4 and runs no step
    again = launch_train.main(args)
    assert again.steps_done == 4 and again.metrics_history == []
    # two more steps resume from the checkpoint: the loss of step 4
    # follows from the restored state
    more = launch_train.main(args[:4] + ["6"] + args[5:])
    assert more.steps_done == 6 and len(more.metrics_history) == 2
    assert all(np.isfinite(m["loss"]) for m in more.metrics_history)


def test_train_cli_runs_the_lm_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-8b", "--reduced", "--steps", "2", "--device", "cpu",
         "--ckpt_dir", str(tmp_path)], env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("qwen3-8b/train_4k: 2 steps in ")
    assert "on cpu; loss " in proc.stdout


def test_moe_lm_loss_adds_the_aux_loss():
    """An MoE lm_loss, which raised until MoE layers were ported (item
    15e), now trains: the loss is the cross-entropy plus 0.01 times the
    aux loss summed over the layers, each near 1 (Switch's balanced
    value), and the router's gradient is float32."""
    _, cfg = _pair("granite-moe-3b-a800m")
    p = tf.init_params(torch.Generator().manual_seed(0), cfg)
    _, b = _batch(cfg.vocab, 1, 8)
    x, aux = tf.forward(p, b["tokens"], cfg)
    assert 0.99 * cfg.n_layers <= float(aux) <= 2.0 * cfg.n_layers
    ce = softmax_cross_entropy(x @ p["lm_head"], b["labels"])
    loss, grads = value_and_grad(lambda q, y: tf.lm_loss(q, y, cfg), p, b)
    assert float(loss) == pytest.approx(float(ce + 0.01 * aux), rel=1e-6)
    assert grads["layers"]["router"].dtype == torch.float32
    assert grads["layers"]["router"].abs().max() > 0


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mixtral-8x22b"])
def test_moe_lm_loss_and_grads_equal_jax(arch):
    """float32: the loss (aux included) and every gradient leaf, the
    router's and the experts' among them, against jax.grad, within the
    float32 tolerances above; the aux of the forward within 1e-6."""
    jcfg, cfg = _pair(arch)
    jp, p = _params(jcfg, cfg)
    jb, b = _batch(cfg.vocab, 2, 40)
    _, jaux = jax_tf.forward(jp, jb["tokens"], jcfg)
    _, aux = tf.forward(p, b["tokens"], cfg)
    assert float(aux) == pytest.approx(float(jaux), abs=1e-6)
    jl, jg = jax.value_and_grad(
        lambda q, x: jax_tf.lm_loss(q, x, jcfg))(jp, jb)
    loss, grads = value_and_grad(lambda q, x: tf.lm_loss(q, x, cfg), p, b)
    assert float(loss) == pytest.approx(float(jl), rel=2e-6)
    leaves, jleaves = tree_flatten(grads), jax.tree.leaves(jg)
    assert len(leaves) == len(jleaves)
    for i, (g, w) in enumerate(zip(leaves, jleaves)):
        _close_leaf(g, w, "float32", f"leaf {i}")
    for name in ("router", "moe_gate", "moe_up", "moe_down"):
        _close_leaf(grads["layers"][name], jg["layers"][name], "float32",
                    name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mixtral-8x22b"])
def test_chip_smoke_pins_jax_moe_values(arch, dtype):
    """chip_smoke.py's MOE_JAX_VALUES are the JAX package's values on its
    moe_parity recipe (tests/jax_moe_values.py): the tokens and experts
    exactly, the logits and the 4 training losses within 1e-6; and the
    port on the CPU, fed those tokens and experts, lies within the
    phase's tolerances of them (float32: its own experts equal)."""
    sys.path.insert(0, str(REPO / "tests"))
    import chip_smoke as cs
    import jax_moe_values
    pins = cs.MOE_JAX_VALUES[arch][dtype]
    want = jax_moe_values.jax_values(arch, dtype)
    assert want["tokens"] == pins["tokens"]
    assert want["routes"] == pins["routes"]
    np.testing.assert_allclose(want["logits"], pins["logits"], rtol=1e-6)
    np.testing.assert_allclose(want["losses"], pins["losses"], rtol=1e-6)
    got = jax_moe_values.port_values(arch, dtype, pins)
    assert got["close"], got
    if dtype == "float32":
        assert got["routes_differ"] == 0
    for a, b, t in zip(got["losses"], pins["losses"],
                       cs.MOE_TRAIN_PARITY_TOL[dtype]):
        assert abs(a - b) <= max(t["rtol"] * abs(b), t["atol"])


def test_layer_list_views_the_stacked_leaves():
    _, cfg = _pair("stablelm-3b")
    p = tf.init_params(torch.Generator().manual_seed(0), cfg)
    layers = tf.layer_list(p)
    assert len(layers) == cfg.n_layers
    for li, lp in enumerate(layers):
        for name, leaf in p["layers"].items():
            assert lp[name].data_ptr() == leaf[li].data_ptr()
            assert torch.equal(lp[name], leaf[li])


def test_grads_come_back_in_the_params_tree():
    """value_and_grad's gradients come back in the params' tree and JAX's
    leaf order (the checkpoint layout)."""
    _, cfg = _pair("stablelm-3b")
    p = tf.init_params(torch.Generator().manual_seed(0), cfg)
    _, b = _batch(cfg.vocab, 1, 16)
    _, g = value_and_grad(lambda q, x: tf.lm_loss(q, x, cfg), p, b)
    shapes = tree_map(lambda t: tuple(t.shape), g)
    assert shapes == tree_map(lambda t: tuple(t.shape), p)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chip_smoke_pins_jax_losses_of_its_parity_recipe(dtype):
    """chip_smoke.py's LM_TRAIN_JAX_LOSSES are the JAX package's losses on
    its lm_train_parity recipe (tests/jax_lm_losses.py), and the port on
    the CPU lies within the phase's tolerance of them."""
    sys.path.insert(0, str(REPO / "tests"))
    import jax_lm_losses
    import chip_smoke as cs
    want = cs.LM_TRAIN_JAX_LOSSES[dtype]
    np.testing.assert_allclose(jax_lm_losses.jax_losses(dtype), want,
                               rtol=1e-6)
    got = jax_lm_losses.port_losses(dtype)
    for a, b, t in zip(got, want, cs.LM_TRAIN_PARITY_TOL[dtype]):
        assert abs(a - b) <= max(t["rtol"] * abs(b), t["atol"])
