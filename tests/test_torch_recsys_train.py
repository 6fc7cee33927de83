"""Two-tower training in the port against the JAX package on the CPU.

* The table's gradient through ``embedding_bag`` (the plain version of
  the backward kernel on the CPU) against ``jax.grad`` of JAX's
  ``models/recsys.embedding_bag`` in float32, mean and sum, within atol
  1e-6: JAX's transpose of ``jnp.take`` scatter-adds in an order XLA
  picks, the port in the kernel's chunk order. Also: the same bits on a
  repeat, ``torch.autograd.gradcheck`` in float64, and the sum mode's
  chunk order written out.
* ``twotower_loss`` and every gradient leaf against
  ``jax.value_and_grad`` of JAX's on the reduced config (JAX's params
  carried across by ``convert.twotower_params_from_numpy``): the loss at
  rtol 1e-5; the gradients at rtol 1e-4 with atol 1e-5 of the leaf's
  largest entry (the reduced model's table gradients reach 20, where one
  float32 ulp is 1.9e-6, so an absolute 1e-6 is below the rounding of
  two summation orders). The hand-written backward of the in-batch
  softmax is held to autograd of the plain expression within 1e-6.
* Compression bit for bit against JAX's, and JAX's error-feedback
  property on the port.
* Four train steps against JAX's ``make_train_step``, with and without
  ``compress_grads``: losses at rtol 1e-5 on the first step, then 1e-4;
  params within 1e-5.
* The launcher: its losses equal JAX's steps on the launcher's own params
  and JAX's ``RecsysStream`` batches, and a second call resumes.
"""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import two_tower_retrieval as jax_cfgmod
from repro.data.pipeline import RecsysStream as JaxRecsysStream
from repro.models import recsys as jax_rec
from repro.train import grad_compression as jax_gc
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig
from repro.train.optimizer import init_adamw as jax_init_adamw
from repro.train.train_loop import make_train_step as jax_make_train_step
from repro_torch.configs import get_arch
from repro_torch.configs import two_tower_retrieval as cfgmod
from repro_torch.convert import twotower_params_from_numpy
from repro_torch.kernels.embedding_bag import ops as bops
from repro_torch.kernels.embedding_bag import ref as bref
from repro_torch.kernels.neighbor_agg.ref import CHUNK
from repro_torch.launch import train as launch_train
from repro_torch.models import recsys
from repro_torch.train import grad_compression as gc
from repro_torch.train.checkpoint import latest_step
from repro_torch.train.optimizer import AdamWConfig, init_adamw
from repro_torch.train.train_loop import make_train_step, value_and_grad
from repro_torch.train.tree import tree_flatten, tree_map

REPO = pathlib.Path(__file__).resolve().parent.parent
BAG_CASES = {"random": (100, 16, 64, 8), "all_pad": (40, 8, 24, 4),
             "duplicates": (30, 12, 20, 6), "bag1": (50, 16, 40, 1),
             "hub": (60, 8, 100, 4)}


def bag_inputs(case, seed=0):
    V, D, B, bag = BAG_CASES[case]
    rng = np.random.default_rng(seed + V)
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids = rng.integers(-1, V, size=(B, bag)).astype(np.int32)
    if case == "all_pad":
        ids[::3] = -1
    elif case == "duplicates":
        ids[:, 1:] = ids[:, :1]
        ids[0, -1] = -1
    elif case == "hub":              # row 5 named by more than CHUNK slots
        ids[rng.random(ids.shape) < 0.12] = 5
    gout = rng.normal(size=(B, D)).astype(np.float32)
    return table, ids, gout


def port_table_grad(table, ids, gout, combine, dtype=torch.float32):
    t = torch.from_numpy(table).to(dtype).requires_grad_(True)
    out = bops.embedding_bag(t, torch.from_numpy(ids), combine=combine)
    out.backward(torch.from_numpy(gout).to(dtype))
    return t.grad


@pytest.mark.parametrize("case", list(BAG_CASES))
@pytest.mark.parametrize("combine", ["mean", "sum"])
def test_table_grad_equals_jax_grad(case, combine):
    table, ids, gout = bag_inputs(case)
    cfg = jax_cfgmod.build_cfg(reduced=True)
    want = jax.grad(lambda t: jnp.sum(jax_rec.embedding_bag(
        t, jnp.asarray(ids), cfg, combine) * gout))(jnp.asarray(table))
    got = port_table_grad(table, ids, gout, combine)
    assert got.dtype == torch.float32 and got.shape == table.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    if case == "hub":
        assert (ids == 5).sum() > CHUNK
    named = np.zeros(table.shape[0], bool)
    named[ids[ids >= 0]] = True
    assert not got[torch.from_numpy(~named)].any()


@pytest.mark.parametrize("combine", ["mean", "sum"])
def test_table_grad_repeats_bit_for_bit(combine):
    table, ids, gout = bag_inputs("hub", seed=3)
    first = port_table_grad(table, ids, gout, combine)
    assert torch.equal(first, port_table_grad(table, ids, gout, combine))


@pytest.mark.parametrize("combine", ["mean", "sum"])
@pytest.mark.parametrize("pad", [0.0, 0.4, 1.0])
def test_gradcheck_float64(combine, pad):
    rng = np.random.default_rng(int(pad * 10))
    ids = rng.integers(0, 7, size=(5, 4)).astype(np.int32)
    ids[rng.random(ids.shape) < pad] = -1
    t = torch.from_numpy(rng.normal(size=(7, 3))).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda a: bops.embedding_bag(a, torch.from_numpy(ids),
                                     combine=combine), (t,), eps=1e-6,
        atol=1e-7)


def test_sum_mode_adds_each_rows_slots_in_chunk_order():
    """grad[r] of the sum: r's slots in (b, j) order, cut into chunks of
    CHUNK, each chunk summed from 0.0 and the partials added in order."""
    table, ids, gout = bag_inputs("hub", seed=5)
    assert (ids == 5).sum() > CHUNK
    got = bops.embedding_bag_bwd(torch.from_numpy(gout),
                                 torch.from_numpy(ids), table.shape[0],
                                 "sum")
    want = np.zeros_like(table)
    for r in range(table.shape[0]):
        bs = [b for b, j in zip(*np.nonzero(ids == r))]
        partials = []
        for c in range(0, len(bs), CHUNK):
            acc = np.zeros(table.shape[1], np.float32)
            for b in bs[c:c + CHUNK]:
                acc = acc + gout[b]
            partials.append(acc)
        total = np.zeros(table.shape[1], np.float32)
        for p in partials:
            total = total + p
        want[r] = total
    assert np.array_equal(got.numpy(), want)


def test_backward_takes_the_tables_dtype_and_no_ids_grad():
    table, ids, gout = bag_inputs("random")
    t = torch.from_numpy(table).to(torch.bfloat16).requires_grad_(True)
    out = bops.embedding_bag(t, torch.from_numpy(ids))
    out.backward(torch.from_numpy(gout).to(torch.bfloat16))
    want = bref.embedding_bag_bwd_ref(
        torch.from_numpy(gout).to(torch.bfloat16).float(),
        torch.from_numpy(ids), table.shape[0], "mean").to(torch.bfloat16)
    assert t.grad.dtype == torch.bfloat16 and torch.equal(t.grad, want)


def test_cpu_backward_never_launches(monkeypatch):
    def no_build():
        raise AssertionError("a CPU tensor must not build the extension")

    monkeypatch.setattr(bops, "load_extension", no_build)
    before = (bops.embedding_bag.launches, bops.embedding_bag_bwd.launches)
    table, ids, gout = bag_inputs("random")
    port_table_grad(table, ids, gout, "mean")
    assert (bops.embedding_bag.launches,
            bops.embedding_bag_bwd.launches) == before


def test_inference_mode_records_no_graph():
    table, ids, _ = bag_inputs("random")
    t = torch.from_numpy(table).requires_grad_(True)
    with torch.inference_mode():
        out = bops.embedding_bag(t, torch.from_numpy(ids))
    assert out.grad_fn is None


@pytest.mark.parametrize("kwargs,match", [
    (dict(combine="max"), "combine"),
    (dict(dtype=torch.float64), "float64"),
])
def test_backward_rejects_bad_arguments(kwargs, match):
    with pytest.raises(ValueError, match=match):
        bops.embedding_bag_bwd(torch.zeros(2, 4),
                               torch.zeros(2, 3, dtype=torch.int32), 5,
                               **kwargs)


# ------------------------------------------------------------------ the loss

@pytest.fixture(scope="module")
def models():
    """(jax cfg, jax params, port cfg, port params), reduced config."""
    jcfg = jax_cfgmod.build_cfg(reduced=True)
    jparams = jax_rec.init_twotower_params(jax.random.PRNGKey(0), jcfg)
    cfg = cfgmod.build_cfg(reduced=True)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, cfg, twotower_params_from_numpy(tree, cfg)


def batch_pair(step, B=32, seed=0):
    b = JaxRecsysStream(1024, 1024, B, n_fields=4, bag=4,
                        seed=seed).batch_at(step)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def assert_leaf_close(got, want, where):
    w = np.asarray(want)
    scale = float(np.abs(w).max())
    np.testing.assert_allclose(got.numpy(), w, rtol=1e-4,
                               atol=1e-5 * scale, err_msg=where)


@pytest.mark.parametrize("step", [0, 1, 2])
def test_loss_and_grads_equal_jax(models, step):
    jcfg, jparams, cfg, params = models
    jb, b = batch_pair(step)
    jl, jg = jax.value_and_grad(
        lambda p, x: jax_rec.twotower_loss(p, x, jcfg))(jparams, jb)
    loss, grads = value_and_grad(
        lambda p, x: recsys.twotower_loss(p, x, cfg), params, b)
    assert loss.dtype == torch.float32
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    leaves, jleaves = tree_flatten(grads), jax.tree.leaves(jg)
    assert len(leaves) == len(jleaves) == 10
    for i, (g, w) in enumerate(zip(leaves, jleaves)):
        assert g.dtype == torch.float32
        assert_leaf_close(g, w, f"leaf {i}")


def plain_in_batch_softmax(u, i, logq, temperature):
    logits = (u @ i.T) / temperature - logq[None, :]
    logz = torch.logsumexp(logits.float(), dim=-1)
    return (logz - logits.float().diagonal()).mean()


@pytest.mark.parametrize("B,D,temperature", [(32, 16, 0.05), (7, 5, 1.0),
                                             (64, 8, 0.2)])
def test_hand_written_backward_equals_autograd(B, D, temperature):
    rng = np.random.default_rng(B + D)
    u0, i0 = (rng.normal(size=(B, D)).astype(np.float32) for _ in range(2))
    u0 /= np.linalg.norm(u0, axis=1, keepdims=True)
    i0 /= np.linalg.norm(i0, axis=1, keepdims=True)
    lq0 = (-8.0 * rng.random(B)).astype(np.float32)
    grads = {}
    for name, fn in (("hand", recsys._InBatchSoftmax.apply),
                     ("plain", plain_in_batch_softmax)):
        u, i, lq = (torch.from_numpy(a).requires_grad_(True)
                    for a in (u0, i0, lq0))
        loss = fn(u, i, lq, temperature)
        (3.0 * loss).backward()
        grads[name] = (loss.item(), u.grad, i.grad, lq.grad)
    hand, plain = grads["hand"], grads["plain"]
    assert hand[0] == pytest.approx(plain[0], abs=1e-6)
    for a, b in zip(hand[1:], plain[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)


def test_loss_backward_frees_the_logits():
    """The backward overwrites the saved logits with their gradient and
    drops them: nothing (B, B) stays on the graph's context."""
    u = torch.randn(8, 4, requires_grad=True)
    i = torch.randn(8, 4, requires_grad=True)
    loss = recsys._InBatchSoftmax.apply(u, i, torch.zeros(8), 0.1)
    assert loss.grad_fn.logits.shape == (8, 8)
    loss.backward()
    assert loss.grad_fn.logits is None


# ----------------------------------------------------------- compression

def leaf_cases():
    rng = np.random.default_rng(11)
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, -127.0, 3.5],
                    np.float32)          # scale 1: exact .5 ties
    return {
        "random": (rng.normal(size=(33, 7)).astype(np.float32),
                   (rng.normal(size=(33, 7)) * 1e-3).astype(np.float32)),
        "zeros": (np.zeros((4, 5), np.float32), np.zeros((4, 5), np.float32)),
        "ties": (ties, np.zeros_like(ties)),
        "tiny": ((rng.normal(size=16) * 1e-30).astype(np.float32),
                 np.zeros(16, np.float32)),
        "bf16": (rng.normal(size=(9, 4)).astype(np.float32),
                 (rng.normal(size=(9, 4)) * 1e-2).astype(np.float32)),
    }


@pytest.mark.parametrize("case", list(leaf_cases()))
def test_compress_decompress_equals_jax_bit_for_bit(case):
    g, err = leaf_cases()[case]
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if case == "bf16" else (
        jnp.float32, torch.float32)
    jg = jnp.asarray(g, jdt)
    tg = torch.from_numpy(np.array(jg.astype(jnp.float32))).to(tdt)
    jdeq, jerr = jax_gc.compress_decompress(jg, jnp.asarray(err))
    deq, new_err = gc.compress_decompress(tg, torch.from_numpy(err))
    assert deq.dtype == tdt and new_err.dtype == torch.float32
    assert np.array_equal(deq.float().numpy(),
                          np.asarray(jdeq.astype(jnp.float32)))
    assert np.array_equal(new_err.numpy(), np.asarray(jerr))
    if case == "ties":                   # half to even, as jnp.round
        assert deq.tolist() == [127.0, 0.0, 2.0, 2.0, -0.0, -2.0, -127.0,
                                4.0]


def test_compress_tree_and_error_feedback_init_equal_jax():
    cases = leaf_cases()
    grads = {"a": cases["random"][0], "b": {"c": cases["ties"][0],
                                            "d": cases["zeros"][0]}}
    jerr0 = jax_gc.init_error_feedback(jax.tree.map(jnp.asarray, grads))
    terr0 = gc.init_error_feedback(tree_map(torch.from_numpy, grads))
    for a, b in zip(tree_flatten(terr0), jax.tree.leaves(jerr0)):
        assert a.dtype == torch.float32 and not a.any()
        assert tuple(a.shape) == b.shape
    jdeq, jerr = jax_gc.compress_tree(jax.tree.map(jnp.asarray, grads),
                                      jerr0)
    deq, err = gc.compress_tree(tree_map(torch.from_numpy, grads), terr0)
    for a, b in zip(tree_flatten((deq, err)),
                    jax.tree.leaves((jdeq, jerr))):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_compression_error_feedback_reduces_bias():
    """JAX's property (tests/test_train_substrate.py) on the port."""
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))}
    err = gc.init_error_feedback(g)
    total_deq = np.zeros(64, np.float32)
    total_g = np.zeros(64, np.float32)
    for _ in range(50):
        deq, err = gc.compress_tree(g, err)
        total_deq += deq["w"].numpy()
        total_g += g["w"].numpy()
    rel = np.abs(total_deq - total_g).max() / np.abs(total_g).max()
    assert rel < 0.01


# ----------------------------------------------------------- train steps

@pytest.mark.parametrize("compress", [False, True])
def test_four_steps_equal_jax(models, compress):
    jcfg, jparams, cfg, params = models
    jstep = jax.jit(jax_make_train_step(
        lambda p, b: jax_rec.twotower_loss(p, b, jcfg), JaxAdamWConfig(),
        compress_grads=compress))
    step = make_train_step(lambda p, b: recsys.twotower_loss(p, b, cfg),
                           AdamWConfig(), compress_grads=compress)
    jstate = [jparams, jax_init_adamw(jparams, JaxAdamWConfig())]
    state = [params, init_adamw(params, AdamWConfig())]
    if compress:
        jstate.append(jax_gc.init_error_feedback(jparams))
        state.append(gc.init_error_feedback(params))
    for s in range(4):
        jb, b = batch_pair(s, seed=4)
        jp, jo, jm, *jerr = jstep(*jstate[:2], jb, *jstate[2:])
        p, o, m, *err = step(*state[:2], b, *state[2:])
        assert len(err) == len(jerr) == int(compress)
        jstate, state = [jp, jo, *jerr], [p, o, *err]
        assert float(m["loss"]) == pytest.approx(
            float(jm["loss"]), rel=1e-5 if s == 0 else 1e-4)
    for a, b in zip(tree_flatten(state[0]), jax.tree.leaves(jstate[0])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("compress", [True, False])
def test_compress_grads_needs_the_error_feedback(compress):
    """err is taken exactly when compression is on: missing with it on,
    or given with it off, raises rather than drop the residual."""
    step = make_train_step(lambda p, b: (p["w"] ** 2).sum(), AdamWConfig(),
                           compress_grads=compress)
    p = {"w": torch.ones(3)}
    err = () if compress else (gc.init_error_feedback(p),)
    with pytest.raises(ValueError, match="err"):
        step(p, init_adamw(p, AdamWConfig()), {}, *err)


def test_compressed_step_carries_its_residual():
    """The step returns the residual of g + err against its int8
    quantization: the dequantized gradient plus the residual is the
    gradient plus the old residual."""
    w0 = torch.tensor([0.3, -1.7, 2.25, 0.01])
    step = make_train_step(lambda p, b: (p["w"] * b["x"]).sum(),
                           AdamWConfig(), compress_grads=True)
    err = {"w": torch.tensor([0.001, 0.0, -0.002, 0.0])}
    x = torch.tensor([1.0, -2.0, 0.37, 5.0])
    _, _, m, new_err = step({"w": w0}, init_adamw({"w": w0}, AdamWConfig()),
                            {"x": x}, err)
    deq, want = gc.compress_decompress(x, err["w"])
    assert torch.equal(new_err["w"], want)
    assert float(m["loss"]) == pytest.approx(float((w0 * x).sum()))


# ------------------------------------------------------------- the launcher

def test_launcher_batches_equal_jax_stream():
    arch = get_arch("two-tower-retrieval")
    cfg = arch.build_cfg(reduced=True)
    batch_at = launch_train.recsys_batches(arch, "train_batch", True, cfg,
                                           "cpu")
    stream = JaxRecsysStream(1024, 1024, 32, n_fields=4, bag=4)
    for step in (0, 3):
        got, want = batch_at(step), stream.batch_at(step)
        assert set(got) == set(want) == {"user_ids", "item_ids",
                                         "item_logq"}
        for k in want:
            assert np.array_equal(got[k].numpy(), want[k])


def test_launcher_losses_equal_jax_steps(tmp_path):
    args = ["--arch", "two-tower-retrieval", "--reduced", "--steps", "4",
            "--device", "cpu", "--ckpt_dir", str(tmp_path)]
    res = launch_train.main(args)
    assert res.steps_done == 4 and res.failures_recovered == 0
    got = [m["loss"] for m in res.metrics_history]
    # JAX's steps from the launcher's own params and JAX's stream
    cfg = get_arch("two-tower-retrieval").build_cfg(reduced=True)
    jcfg = jax_cfgmod.build_cfg(reduced=True)
    jp = jax.tree.map(jnp.asarray, tree_map(
        lambda t: t.numpy(), launch_train.recsys_params(cfg, "cpu")))
    jstep = jax.jit(jax_make_train_step(
        lambda p, b: jax_rec.twotower_loss(p, b, jcfg), JaxAdamWConfig()))
    jo = jax_init_adamw(jp, JaxAdamWConfig())
    stream = JaxRecsysStream(1024, 1024, 32, n_fields=4, bag=4)
    want = []
    for s in range(4):
        jp, jo, m = jstep(jp, jo, {k: jnp.asarray(v) for k, v in
                                   stream.batch_at(s).items()})
        want.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    d = str(tmp_path / "two-tower-retrieval")
    assert latest_step(d) == 4
    # two more steps resume from the checkpoint at 4
    more = launch_train.main(args[:4] + ["6"] + args[5:])
    assert more.steps_done == 6 and len(more.metrics_history) == 2
    assert all(np.isfinite(m["loss"]) for m in more.metrics_history)
    again = launch_train.main(args[:4] + ["6"] + args[5:])
    assert again.steps_done == 6 and again.metrics_history == []


def test_train_cli_runs_two_tower_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "two-tower-retrieval", "--reduced", "--steps", "2", "--device",
         "cpu", "--ckpt_dir", str(tmp_path)], env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("two-tower-retrieval/train_batch: 2 "
                                  "steps in ")


# ------------------------------------------------- chip_smoke's pinned losses

@pytest.mark.parametrize("variant", ["plain", "compressed"])
def test_chip_smoke_pins_jax_losses_of_its_parity_recipe(variant):
    """chip_smoke.py's RECSYS_TRAIN_JAX_LOSSES are the JAX package's
    losses on its recsys_train_parity recipe
    (tests/jax_twotower_losses.py), and the port on the CPU lies within
    the phase's tolerance of them."""
    sys.path.insert(0, str(REPO / "tests"))
    import chip_smoke as cs
    import jax_twotower_losses
    want = cs.RECSYS_TRAIN_JAX_LOSSES[variant]
    np.testing.assert_allclose(jax_twotower_losses.jax_losses(variant),
                               want, rtol=1e-6)
    got = jax_twotower_losses.port_losses(variant)
    for a, b, t in zip(got, want, cs.RECSYS_PARITY_TOL):
        assert abs(a - b) <= max(t["rtol"] * abs(b), t["atol"])
