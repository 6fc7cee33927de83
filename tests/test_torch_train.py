"""The port's training substrate (train/) and GNN launcher against the JAX
package's.

AdamW, the LR schedule and clipping are held against
``repro.train.optimizer`` on the same params and gradients within
float32 rounding (rtol 1e-6: both run the same float32 operations in the
same order; ``cos`` and ``pow`` may differ in the last bit). Checkpoints
share one on-disk layout: the port's restore in JAX's
``restore_checkpoint`` and the reverse, bfloat16 included, bit for bit.
The cases of tests/test_train_substrate.py:20-117 are carried over. The
launcher's losses equal the JAX launcher's, run in the same test, within
2e-6 (float32 rounding of the aggregation order).
"""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.train as jax_launch
from repro.train import checkpoint as jax_ckpt
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig
from repro.train.optimizer import adamw_update as jax_adamw_update
from repro.train.optimizer import init_adamw as jax_init_adamw
from repro.train.optimizer import lr_at as jax_lr_at
from repro.train.train_loop import make_train_step as jax_make_train_step
from repro_torch.launch import train as launch_train
from repro_torch.train.checkpoint import (latest_step, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.fault_tolerance import FTConfig, run_training
from repro_torch.train.optimizer import (AdamWConfig, AdamWState,
                                         adamw_update, init_adamw, lr_at)
from repro_torch.train.train_loop import make_train_step
from repro_torch.train.tree import (tree_flatten, tree_map,
                                    tree_unflatten)

OPT = dict(lr=0.05, warmup_steps=3, total_steps=12, weight_decay=0.1,
           grad_clip=0.5)


def tree_pair(seed=0):
    """A param tree (nested dicts, a list, bf16 and f32 leaves) for both."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(4, 3)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    c = rng.normal(size=(2, 2)).astype(np.float32)
    jt = {"w": jnp.asarray(a, jnp.bfloat16),
          "layers": [{"b": jnp.asarray(b)}, {"b": jnp.asarray(c)}]}
    tt = {"w": torch.from_numpy(a).to(torch.bfloat16),
          "layers": [{"b": torch.from_numpy(b)}, {"b": torch.from_numpy(c)}]}
    return jt, tt


def grads_like(jt, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=x.shape).astype(np.float32) * 3
            for x in jax.tree.leaves(jt)]
    jg = jax.tree.unflatten(jax.tree.structure(jt),
                            [jnp.asarray(a) for a in arrs])
    return jg, arrs


def test_tree_flatten_order_is_jax_order():
    jt, tt = tree_pair()
    jo = jax_init_adamw(jt, JaxAdamWConfig())
    o = init_adamw(tt, AdamWConfig())
    state_j, state_t = (jt, jo), (tt, o)
    js = [tuple(x.shape) for x in jax.tree.leaves(state_j)]
    ts = [tuple(x.shape) for x in tree_flatten(state_t)]
    assert js == ts
    back = tree_unflatten(state_t, tree_flatten(state_t))
    assert isinstance(back[1], AdamWState)
    assert tree_map(lambda x: x + 1, [1, {"b": 2, "a": (3,)}]) == [
        2, {"a": (4,), "b": 3}]


def test_adamw_updates_equal_jax():
    jt, tt = tree_pair(1)
    jcfg, cfg = JaxAdamWConfig(**OPT), AdamWConfig(**OPT)
    jo, o = jax_init_adamw(jt, jcfg), init_adamw(tt, cfg)
    for step in range(6):
        jg, arrs = grads_like(jt, 10 + step)
        g = tree_unflatten(tt, [torch.from_numpy(a) for a in arrs])
        jt, jo, jstats = jax_adamw_update(jg, jo, jt, jcfg)
        tt, o, stats = adamw_update(g, o, tt, cfg)
        for a, b in zip(tree_flatten((tt, o)), jax.tree.leaves((jt, jo))):
            assert a.dtype == {"bfloat16": torch.bfloat16,
                               "float32": torch.float32,
                               "int32": torch.int32}[str(b.dtype)]
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b, np.float32),
                                       rtol=1e-6, atol=1e-7)
        for k in ("grad_norm", "lr"):
            assert float(stats[k]) == pytest.approx(float(jstats[k]),
                                                    rel=1e-6)


def test_lr_schedule_equals_jax():
    cfg = dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    for s in (0, 1, 5, 10, 11, 37, 50, 99, 100, 150):
        got = float(lr_at(AdamWConfig(**cfg), torch.tensor(s, dtype=torch.int32)))
        want = float(jax_lr_at(JaxAdamWConfig(**cfg), jnp.int32(s)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-7), s


def test_adamw_converges_quadratic():
    cfg = AdamWConfig(lr=0.1, warmup_steps=0, total_steps=200,
                      weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = init_adamw(params, cfg)
    for _ in range(150):
        g = {"w": 2 * params["w"]}
        params, opt, _ = adamw_update(g, opt, params, cfg)
    assert float((params["w"] ** 2).sum()) < 1e-2


def test_lr_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1)
    lrs = [float(lr_at(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in (0, 5, 10, 50, 100)]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0)
    assert lrs[3] < lrs[2]
    assert lrs[4] == pytest.approx(0.1, abs=1e-6)


def test_grad_clip_applied():
    cfg = AdamWConfig(lr=1e-3, grad_clip=1.0, warmup_steps=0)
    params = {"w": torch.zeros(3)}
    opt = init_adamw(params, cfg)
    g = {"w": torch.full((3,), 100.0)}
    new, _, stats = adamw_update(g, opt, params, cfg)
    assert float(stats["grad_norm"]) > 100
    # Adam's first step moves each coordinate by about lr whatever the
    # clip scale; the inputs are left as they were
    assert torch.allclose(new["w"], torch.full((3,), -1e-3), rtol=1e-3)
    assert torch.equal(params["w"], torch.zeros(3))


def test_train_step_with_accumulation_equals_jax():
    """Two microbatches looped (the JAX scan) with float32 accumulation."""
    rng = np.random.default_rng(3)
    w0 = rng.normal(size=(3, 2)).astype(np.float32)
    xs = rng.normal(size=(2, 4, 3)).astype(np.float32)

    def jloss(p, b):
        return jnp.mean((b["x"] @ p["w"]) ** 2)

    def tloss(p, b):
        return torch.mean((b["x"] @ p["w"]) ** 2)

    jstep = jax_make_train_step(jloss, JaxAdamWConfig(**OPT), accum_steps=2)
    step = make_train_step(tloss, AdamWConfig(**OPT), accum_steps=2)
    jp = {"w": jnp.asarray(w0)}
    p = {"w": torch.from_numpy(w0)}
    jo, o = jax_init_adamw(jp, JaxAdamWConfig(**OPT)), init_adamw(
        p, AdamWConfig(**OPT))
    for _ in range(3):
        jp, jo, jm = jstep(jp, jo, {"x": jnp.asarray(xs)})
        p, o, m = step(p, o, {"x": torch.from_numpy(xs)})
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 rel=1e-6)
        np.testing.assert_allclose(p["w"].numpy(), np.asarray(jp["w"]),
                                   rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------- checkpoints

def test_port_checkpoint_restores_in_jax_and_back():
    jt, tt = tree_pair(2)
    o = init_adamw(tt, AdamWConfig())
    g = tree_map(lambda x: torch.ones(x.shape), tt)
    tt, o, _ = adamw_update(g, o, tt, AdamWConfig())
    state = (tt, o)
    jlike = (jt, jax_init_adamw(jt, JaxAdamWConfig()))
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 4, state)
        assert jax_ckpt.latest_step(d) == 4
        got = jax_ckpt.restore_checkpoint(d, 4, jlike)
        for a, b in zip(jax.tree.leaves(got), tree_flatten(state)):
            assert str(a.dtype) == str(b.dtype).removeprefix("torch.")
            assert np.array_equal(np.asarray(a, np.float32),
                                  b.float().numpy())
        # and JAX's save of what it restored comes back in the port
        jax_ckpt.save_checkpoint(d, 9, got)
        assert latest_step(d) == 9
        back = restore_checkpoint(d, 9, state)
        assert isinstance(back[1], AdamWState)
        for a, b in zip(tree_flatten(back), tree_flatten(state)):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_roundtrip_bf16():
    tree = {"a": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
            "b": {"c": np.float32(3.5), "d": np.arange(4)}}
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 7, tree)
        assert latest_step(d) == 7
        out = restore_checkpoint(d, 7, tree)
        assert out["a"].dtype == torch.bfloat16
        assert torch.equal(out["a"], tree["a"])
        assert float(out["b"]["c"]) == 3.5
        assert np.array_equal(out["b"]["d"], np.arange(4))


def test_checkpoint_gc_and_latest():
    tree = {"x": torch.ones(2)}
    with tempfile.TemporaryDirectory() as d:
        for s in (1, 2, 3, 4, 5):
            save_checkpoint(d, s, tree, keep_last=2)
        dirs = [x for x in os.listdir(d) if x.startswith("step_")]
        assert len(dirs) == 2
        assert latest_step(d) == 5


def test_checkpoint_shape_mismatch_rejected():
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, {"x": torch.ones((2, 2))})
        with pytest.raises(ValueError, match="shape"):
            restore_checkpoint(d, 1, {"x": torch.ones((3, 3))})
        with pytest.raises(ValueError, match="leaf count"):
            restore_checkpoint(d, 1, {"x": torch.ones((2, 2)),
                                      "y": torch.ones(1)})


def test_run_training_rewind_truncates_history():
    """A checkpoint-restore rewind also rewinds the metrics log, and the
    replay is exact (tests/test_train_substrate.py:78-117)."""
    def train_step(params, opt, batch):
        params = params + batch
        return params, opt, {"loss": float(params.sum()), "step_in": 1.0}

    def batch_at(step):
        return torch.full((2,), float(step + 1))

    fails = {"armed": True}

    def fail_injector(step):
        if step == 7 and fails["armed"]:
            fails["armed"] = False
            raise RuntimeError("injected node failure")

    with tempfile.TemporaryDirectory() as d:
        ft = FTConfig(ckpt_dir=d, ckpt_every=5, max_retries_per_step=2)
        state = (torch.zeros(2), torch.zeros(1))
        res = run_training(train_step, state, iter(()), 10, ft,
                           batch_at=batch_at, fail_injector=fail_injector)
    assert res.failures_recovered == 1
    assert res.steps_done == 10
    assert len(res.metrics_history) == 10
    losses = [m["loss"] for m in res.metrics_history]
    np.testing.assert_allclose(losses, np.cumsum(2 * np.arange(1.0, 11.0)))


def test_run_training_skips_a_batch_after_its_retries():
    """The driver hides a step that keeps failing: it logs a NaN loss
    marked ``skipped`` and goes on, as the JAX driver does."""
    def train_step(params, opt, batch):
        if batch == 2:
            raise RuntimeError("launch failed")
        return params + 1, opt, {"loss": torch.tensor(1.0)}

    with tempfile.TemporaryDirectory() as d:
        res = run_training(train_step, (torch.zeros(()), torch.zeros(())),
                           None, 4, FTConfig(ckpt_dir=d),
                           batch_at=lambda s: s)
    assert res.failures_recovered == 3 and res.steps_done == 4
    assert res.metrics_history[2]["skipped"] is True
    assert np.isnan(res.metrics_history[2]["loss"])
    assert [m["loss"] for m in res.metrics_history if "skipped" not in m] \
        == [1.0, 1.0, 1.0]


# ------------------------------------------------------------------ launcher

def jax_launcher_losses(argv):
    """The JAX launcher's own run, its history kept."""
    seen = {}
    orig = jax_launch.run_training

    def spy(*a, **k):
        seen["res"] = orig(*a, **k)
        return seen["res"]

    jax_launch.run_training = spy
    try:
        jax_launch.main(argv)
    finally:
        jax_launch.run_training = orig
    return [m["loss"] for m in seen["res"].metrics_history]


def test_launcher_losses_equal_jax_launcher(tmp_path):
    args = ["--arch", "graphsage-reddit", "--reduced", "--steps", "4"]
    want = jax_launcher_losses(args + ["--ckpt_dir", str(tmp_path / "j")])
    res = launch_train.main(args + ["--device", "cpu", "--ckpt_dir",
                                    str(tmp_path / "t")])
    assert res.steps_done == 4 and res.failures_recovered == 0
    got = [m["loss"] for m in res.metrics_history]
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
    # the checkpoint of the last step restores in the JAX package
    d = str(tmp_path / "t" / "graphsage-reddit")
    assert jax_ckpt.latest_step(d) == 4
    # a second run in the same directory resumes and runs no step
    again = launch_train.main(args + ["--device", "cpu", "--ckpt_dir",
                                      str(tmp_path / "t")])
    assert again.steps_done == 4 and again.metrics_history == []


def test_launcher_params_equal_jax_launcher_draw():
    """Every leaf rng.normal(shape) * 0.1 in JAX's flatten order, cast to
    bfloat16: bit for bit the JAX launcher's params."""
    from repro.configs import get_arch as jax_get_arch
    from repro.launch.cells import build_cell
    from repro_torch.configs import get_arch
    plan = build_cell("graphsage-reddit", "full_graph_sm", reduced=True)
    rng = np.random.default_rng(0)
    want = jax.tree.map(lambda s: jnp.asarray(
        rng.normal(size=s.shape).astype(np.float32) * 0.1, s.dtype),
        plan.args[0])
    cfg = get_arch("graphsage-reddit").build_cfg(reduced=True)
    got = launch_train.launcher_params(cfg, "cpu")
    for a, b in zip(tree_flatten(got), jax.tree.leaves(want)):
        assert torch.equal(a.float(), torch.from_numpy(
            np.asarray(b, np.float32)))
    assert jax_get_arch("graphsage-reddit").family == "gnn"


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "schnet"])
def test_launcher_trains_other_families(arch, tmp_path):
    """The MoE LM mixtral-8x22b (which raised until item 15e) and schnet
    (which raised until item 15g) train: 2 finite steps (mixtral's of 2
    accumulated microbatches)."""
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--ckpt_dir",
            str(tmp_path)]
    res = launch_train.main(argv + ["--steps", "2"])
    assert res.steps_done == 2 and res.failures_recovered == 0
    assert all(np.isfinite(m["loss"]) for m in res.metrics_history)


def test_launcher_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "graphsage-reddit", "--reduced",
                           "--ckpt_dir", str(tmp_path)])
