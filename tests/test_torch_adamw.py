"""The port's AdamW update writes its moments in place, a slice at a time.

``adamw_update`` updates the state's own ``m`` and ``v`` tensors and
returns new params; each leaf past ``UPDATE_SLICE`` elements goes a flat
slice at a time. Held here, bit for bit, against the functional formula
it replaced (kept below as ``reference_update``: new ``m``, ``v`` and
params trees, each leaf whole), over a few steps with bf16 and float32
params, float32 and bf16 moments (llama3-405b's ``moment_dtype``),
clipping active, and leaves past a lowered slicing threshold. The
moments keep their storage: no second moment tree is allocated. A
failure before the first moment write leaves the state as it was; one
after it raises ``MomentsConsumed``, which ``run_training`` does not
replay on the state it left. Parity with the JAX package's update is
``tests/test_torch_train.py``'s.
"""
import dataclasses
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.train import optimizer
from repro_torch.train.fault_tolerance import FTConfig, run_training
from repro_torch.train.optimizer import (AdamWConfig, AdamWState,
                                         MomentsConsumed, adamw_update,
                                         global_norm, init_adamw, lr_at)
from repro_torch.train.train_loop import make_train_step
from repro_torch.train.tree import tree_flatten, tree_map

OPT = dict(lr=0.05, warmup_steps=2, total_steps=10, grad_clip=0.5)


@torch.no_grad()
def reference_update(grads, state, params, cfg):
    """The functional update: new params, m and v, each leaf whole."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())
    mdt = cfg.moment_dtype or torch.float32

    def upd(p, g, m, v):
        g = g.float() * scale
        m32 = (b1 * m.float()).add_((1 - b1) * g)
        v32 = (b2 * v.float()).add_(((1 - b2) * g).mul_(g))
        den = (v32 / bc2).sqrt_().add_(cfg.eps)
        delta = (m32 / bc1).div_(den)
        delta.add_(cfg.weight_decay * p.float())
        newp = torch.sub(p.float(), delta.mul_(lr))
        return newp.to(p.dtype), m32.to(mdt), v32.to(mdt)

    out = tree_map(upd, params, grads, state.m, state.v)
    is_t = lambda t: isinstance(t, tuple)  # noqa: E731
    return (tree_map(lambda t: t[0], out, is_leaf=is_t),
            AdamWState(step=step,
                       m=tree_map(lambda t: t[1], out, is_leaf=is_t),
                       v=tree_map(lambda t: t[2], out, is_leaf=is_t)),
            {"grad_norm": gnorm, "lr": lr})


def make_tree(dtype, seed=0):
    """Nested dicts and a list: a scalar, a vector, a (10, 4) leaf and a
    (3, 5, 7) leaf (three and seven flat slices at a threshold of 16, the
    last one short)."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(np.asarray(rng.normal(size=shape),
                                           np.float32)).to(dtype)

    return {"scale": t(), "emb": t(10, 4),
            "layers": [{"w": t(3, 5, 7)}, {"b": t(6)}]}


def grads_for(params, seed):
    """float32 gradients, large enough that the clip at 0.5 is active."""
    rng = np.random.default_rng(100 + seed)
    return tree_map(lambda p: torch.from_numpy(np.asarray(
        rng.normal(size=tuple(p.shape)) * 4, np.float32)), params)


@pytest.mark.parametrize("slice_elems", [optimizer.UPDATE_SLICE, 16, 1])
@pytest.mark.parametrize("moment_dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_update_equals_the_functional_formula(monkeypatch, dtype,
                                              moment_dtype, slice_elems):
    monkeypatch.setattr(optimizer, "UPDATE_SLICE", slice_elems)
    cfg = AdamWConfig(**OPT, moment_dtype=moment_dtype)
    params = ref_params = make_tree(dtype)
    state, ref_state = init_adamw(params, cfg), init_adamw(ref_params, cfg)
    for s in range(4):
        g = grads_for(params, s)
        assert float(global_norm(g)) > cfg.grad_clip
        ref_params, ref_state, ref_stats = reference_update(
            g, ref_state, ref_params, cfg)
        params, state, stats = adamw_update(g, state, params, cfg)
        assert torch.equal(stats["grad_norm"], ref_stats["grad_norm"])
        assert torch.equal(state.step, ref_state.step)
        for got, want in zip(tree_flatten((params, state.m, state.v)),
                             tree_flatten((ref_params, ref_state.m,
                                           ref_state.v))):
            assert got.dtype == want.dtype and got.shape == want.shape
            assert torch.equal(got, want)


@pytest.mark.parametrize("slice_elems", [optimizer.UPDATE_SLICE, 16])
def test_moments_keep_their_storage(monkeypatch, slice_elems):
    """The state's m and v are written in place (the same tensors and
    storage after every step); the params are new tensors, and the old
    params are left as they were."""
    monkeypatch.setattr(optimizer, "UPDATE_SLICE", slice_elems)
    cfg = AdamWConfig(**OPT)
    params = make_tree(torch.bfloat16)
    state = init_adamw(params, cfg)
    ptrs = [t.data_ptr() for t in tree_flatten((state.m, state.v))]
    for s in range(3):
        old = [t.clone() for t in tree_flatten(params)]
        new, nstate, _ = adamw_update(grads_for(params, s), state, params,
                                      cfg)
        assert [t.data_ptr() for t in tree_flatten(
            (nstate.m, nstate.v))] == ptrs
        assert nstate.m is state.m and nstate.v is state.v
        assert all(torch.equal(a, b)
                   for a, b in zip(tree_flatten(params), old))
        assert all(a.data_ptr() != b.data_ptr() for a, b in
                   zip(tree_flatten(new), tree_flatten(params)))
        assert all(float(m.abs().max()) > 0
                   for m in tree_flatten(nstate.m))
        params, state = new, nstate


def test_train_step_keeps_the_moments_storage():
    """Through make_train_step with accumulation: the same moment
    tensors come back, holding the functional formula's values."""
    cfg = AdamWConfig(**OPT)
    w0 = torch.tensor([[0.5, -1.25], [2.0, 0.75]])
    xs = torch.tensor([[[1.0, 2.0]], [[-3.0, 0.5]]])

    def loss(q, x):
        return torch.sum((x["x"] @ q["w"]) ** 3)

    step = make_train_step(loss, cfg, accum_steps=2)
    state = init_adamw({"w": w0}, cfg)
    m_ptr, v_ptr = state.m["w"].data_ptr(), state.v["w"].data_ptr()
    ref_p, ref_state = {"w": w0}, init_adamw({"w": w0}, cfg)
    p = {"w": w0}
    for _ in range(2):
        p, state, metrics = step(p, state, {"x": xs})
        g = {"w": torch.zeros_like(w0)}
        for i in range(2):
            with torch.enable_grad():
                w = ref_p["w"].detach().requires_grad_(True)
                gi, = torch.autograd.grad(loss({"w": w}, {"x": xs[i]}), [w])
            g["w"].add_(gi / 2)
        ref_p, ref_state, _ = reference_update(g, ref_state, ref_p, cfg)
        assert state.m["w"].data_ptr() == m_ptr
        assert state.v["w"].data_ptr() == v_ptr
        assert torch.equal(p["w"], ref_p["w"])
        assert torch.equal(state.m["w"], ref_state.m["w"])
        assert torch.equal(state.v["w"], ref_state.v["w"])


def test_moment_dtype_round_trip_matches_to():
    """copy_ into a bf16 moment rounds as .to(bfloat16) does."""
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=4096).astype(np.float32)) * 1e3
    m = torch.empty(4096, dtype=torch.bfloat16)
    m.copy_(x)
    assert torch.equal(m, x.to(torch.bfloat16))
    cfg = dataclasses.replace(AdamWConfig(), moment_dtype=torch.bfloat16)
    st = init_adamw({"a": torch.zeros(3)}, cfg)
    assert st.m["a"].dtype == torch.bfloat16


class FailOnCall:
    """A stand-in for a torch function that raises an allocator's error
    on its ``at``-th call while ``armed``."""

    def __init__(self, fn, at):
        self.fn, self.at, self.calls, self.armed = fn, at, 0, True

    def __call__(self, *a, **k):
        if self.armed:
            self.calls += 1
            if self.calls == self.at:
                self.armed = False
                raise RuntimeError("CUDA out of memory (injected)")
        return self.fn(*a, **k)


def test_failure_before_the_first_write_leaves_the_state(monkeypatch):
    """The new params are all allocated before any moment is written: an
    allocation that fails (the third leaf's) raises the error itself and
    leaves m and v as they were, so the step replays to the formula's
    bits."""
    cfg = AdamWConfig(**OPT)
    params = make_tree(torch.float32)
    state = init_adamw(params, cfg)
    params, state, _ = adamw_update(grads_for(params, 0), state, params, cfg)
    before = [t.clone() for t in tree_flatten((state.m, state.v))]
    g = grads_for(params, 1)
    monkeypatch.setattr(torch, "empty", FailOnCall(torch.empty, 3))
    with pytest.raises(RuntimeError, match="out of memory") as err:
        adamw_update(g, state, params, cfg)
    assert not isinstance(err.value, MomentsConsumed)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_flatten((state.m, state.v)), before))
    want = reference_update(g, AdamWState(state.step, *tree_map(
        torch.clone, (state.m, state.v))), params, cfg)
    got = adamw_update(g, state, params, cfg)
    assert all(torch.equal(a, b) for a, b in zip(
        tree_flatten((got[0], got[1].m, got[1].v)),
        tree_flatten((want[0], want[1].m, want[1].v))))


@pytest.mark.parametrize("slice_elems", [optimizer.UPDATE_SLICE, 16])
def test_failure_after_a_moment_write_raises_moments_consumed(monkeypatch,
                                                              slice_elems):
    """A failure between the first slice's moment write and the end (at
    the second slice's param write) is raised as MomentsConsumed, its
    cause kept: the first slice's moments have moved."""
    monkeypatch.setattr(optimizer, "UPDATE_SLICE", slice_elems)
    cfg = AdamWConfig(**OPT)
    params = make_tree(torch.float32)
    state = init_adamw(params, cfg)
    monkeypatch.setattr(torch, "sub", FailOnCall(torch.sub, 2))
    with pytest.raises(MomentsConsumed) as err:
        adamw_update(grads_for(params, 0), state, params, cfg)
    assert "out of memory" in str(err.value.__cause__)
    assert any(float(m.abs().max()) > 0 for m in tree_flatten(state.m))


def small_training(tmp, ckpt_every, fail_step=None):
    """run_training over 4 steps of make_train_step on a two-leaf tree;
    with ``fail_step``, the update of that step fails (once) after its
    first moment write. Returns the result and the final state."""
    cfg = AdamWConfig(**OPT)
    rng = np.random.default_rng(7)
    params = {"w": torch.from_numpy(rng.normal(size=(3, 4)).astype(
        np.float32)), "b": torch.from_numpy(rng.normal(size=4).astype(
            np.float32))}
    xs = torch.from_numpy(rng.normal(size=(4, 2, 3)).astype(np.float32))

    def loss(q, b):
        return torch.sum(torch.tanh(b["x"] @ q["w"] + q["b"]) ** 2)

    inner = make_train_step(loss, cfg)
    fault = FailOnCall(torch.sub, 2)
    fault.armed = False
    seen = {"fired": False}

    def step_fn(p, opt, batch):
        out = inner(p, opt, batch)
        seen["state"] = out[:2]
        return out

    def injector(step):
        if step == fail_step and not seen["fired"]:
            seen["fired"] = fault.armed = True

    sub = torch.sub
    torch.sub = fault
    try:
        res = run_training(step_fn, (params, init_adamw(params, cfg)), None,
                           4, FTConfig(ckpt_dir=tmp, ckpt_every=ckpt_every),
                           batch_at=lambda s: {"x": xs[s]},
                           fail_injector=injector)
    finally:
        torch.sub = sub
    return res, seen["state"]


def test_run_training_restores_after_moments_consumed():
    """With a checkpoint to go back to, a step whose update failed
    mid-way goes on from it, and the run ends on the bits of a run with
    no fault."""
    with tempfile.TemporaryDirectory() as a, \
            tempfile.TemporaryDirectory() as b:
        want, want_state = small_training(a, 1)
        got, got_state = small_training(b, 1, fail_step=2)
    assert want.failures_recovered == 0 and got.failures_recovered == 1
    assert got.steps_done == 4
    assert [m["loss"] for m in got.metrics_history] == \
        [m["loss"] for m in want.metrics_history]
    for x, y in zip(tree_flatten(got_state), tree_flatten(want_state)):
        assert torch.equal(x, y)


def test_run_training_refuses_to_replay_on_consumed_moments():
    """With no checkpoint yet, the step is not retried on the moments it
    already moved: MomentsConsumed reaches the caller."""
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(MomentsConsumed):
            small_training(d, 10, fail_step=1)
