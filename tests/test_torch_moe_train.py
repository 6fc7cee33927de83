"""MoE LM training at the published archs' routing shapes, narrow, on the
CPU, against the JAX package, with remat on.

The configs keep what the card's moe_train and moe_window_train phases
train at full width and cut the widths: granite-moe-3b-a800m's 40
experts top-8 with its 3 query heads to a key head of 64 (G = 3, D =
64), mixtral-8x22b's 8 experts top-2 with G = 6 and its window (16 in the
reduced config, so that it masks keys at S = 64); 2 layers, d_model 192,
d_ff 32, vocab 512, each built by ``dataclasses.replace`` on both
packages' reduced configs. Params are JAX's ``init_params`` carried over
by ``convert.transformer_params_from_numpy``; batches come from the token
stream (B = 2, S = 64: granite's capacity of 16 slots an expert a row
drops some of its 512 slots a row).

Held, in float32: the loss within 2e-6 (relative) and every gradient
leaf within atol 1e-5 of its largest |entry| and rtol 1e-4 of
``jax.value_and_grad`` of JAX's ``lm_loss`` (the tolerances of
``tests/test_torch_lm_train.py``; measured within 1.3e-6 of the scale);
the port with remat on and off bit-equal (the same ops run again); and,
through ``chip_smoke.TrainRouteLog`` (the spy on ``models.moe.top_experts``
and ``transformer.moe_ffn`` that the card's phases read), the recompute's
experts equal to the forward's in every layer, with the aux losses the
spy picks summing to the forward's.
"""
import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import transformer as jax_tf
from repro_torch import configs
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.data.pipeline import TokenStream
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as tf
from repro_torch.train.train_loop import split_microbatches, value_and_grad
from repro_torch.train.tree import tree_flatten

REPO = pathlib.Path(__file__).resolve().parent.parent
# arch -> (n_heads, n_kv_heads, d_head, n_experts, top_k)
SHAPES = {"granite-moe-3b-a800m": (3, 1, 64, 40, 8),
          "mixtral-8x22b": (6, 1, 32, 8, 2)}
B, S = 2, 64


def _cfg(get_arch, arch, dtype, remat=True):
    Hq, Hkv, D, E, K = SHAPES[arch]
    cfg = get_arch(arch).build_cfg(reduced=True)
    return dataclasses.replace(
        cfg, n_layers=2, d_model=192, n_heads=Hq, n_kv_heads=Hkv,
        d_head=D, d_ff=32, vocab=512, dtype=dtype, remat=remat,
        moe=dataclasses.replace(cfg.moe, n_experts=E, top_k=K))


def _pair(arch):
    return (_cfg(jax_get_arch, arch, jnp.float32),
            _cfg(configs.get_arch, arch, torch.float32))


def _params(jcfg, cfg):
    jp = jax_tf.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, transformer_params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jp), cfg)


def _batch(vocab, step=0):
    b = TokenStream(vocab, B, S, seed=1).batch_at(step)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _close_leaf(got, want, where):
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, where
    np.testing.assert_allclose(g, w, atol=1e-5 * float(np.abs(w).max()),
                               rtol=1e-4, err_msg=where)


@pytest.fixture(scope="module", params=list(SHAPES))
def case(request):
    arch = request.param
    jcfg, cfg = _pair(arch)
    jp, p = _params(jcfg, cfg)
    return arch, jcfg, cfg, jp, p


def test_configs_keep_the_routing_shape(case):
    arch, jcfg, cfg, _, p = case
    full = configs.get_arch(arch).build_cfg()
    assert cfg.remat and jcfg.remat
    assert (cfg.moe.n_experts, cfg.moe.top_k) == (full.moe.n_experts,
                                                  full.moe.top_k)
    assert cfg.n_heads // cfg.n_kv_heads == full.n_heads // full.n_kv_heads
    assert (cfg.window is None) == (full.window is None)
    assert sum(t.numel() for t in tree_flatten(p)) == cfg.params_dense
    # granite's capacity drops slots at this shape
    if arch == "granite-moe-3b-a800m":
        assert moe_mod.capacity(cfg, S) * cfg.moe.n_experts \
            < 1.5 * S * cfg.moe.top_k


def test_loss_and_grads_equal_jax_with_remat(case):
    _, jcfg, cfg, jp, p = case
    jb, b = _batch(cfg.vocab)
    jl, jg = jax.value_and_grad(
        lambda q, x: jax_tf.lm_loss(q, x, jcfg))(jp, jb)
    loss, grads = value_and_grad(lambda q, x: tf.lm_loss(q, x, cfg), p, b)
    assert float(loss) == pytest.approx(float(jl), rel=2e-6)
    leaves, jleaves = tree_flatten(grads), jax.tree.leaves(jg)
    assert len(leaves) == len(jleaves)
    for i, (g, w) in enumerate(zip(leaves, jleaves)):
        _close_leaf(g, w, f"leaf {i}")
    for name in ("router", "moe_gate", "moe_up", "moe_down"):
        _close_leaf(grads["layers"][name], jg["layers"][name], name)
        assert grads["layers"][name].abs().max() > 0


def test_remat_on_and_off_give_the_same_bits(case):
    _, _, cfg, _, p = case
    _, b = _batch(cfg.vocab, step=1)
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        out[remat] = value_and_grad(lambda q, x: tf.lm_loss(q, x, c), p, b)
    assert torch.equal(out[False][0], out[True][0])
    for a, w in zip(tree_flatten(out[False][1]), tree_flatten(out[True][1])):
        assert torch.equal(a, w)


def test_recompute_takes_the_forward_experts(case):
    """Two microbatches of a remat step through chip_smoke's
    TrainRouteLog: 2 L routings a microbatch, each layer's recompute on
    the forward's experts, the aux it picks summing to the forward's, and
    the dropped shares its capacity counts."""
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    _, _, cfg, _, p = case
    raw = TokenStream(cfg.vocab, 2 * B, S, seed=1).batch_at(0)
    batch = split_microbatches({k: torch.from_numpy(v)
                                for k, v in raw.items()}, 2)
    want_aux = []
    with torch.no_grad():
        for a in range(2):
            want_aux.append(float(tf.forward(p, batch["tokens"][a],
                                             cfg)[1]))
    with cs.TrainRouteLog(moe_mod, tf, cfg) as log:
        for a in range(2):
            value_and_grad(lambda q, x: tf.lm_loss(q, x, cfg), p,
                           {k: v[a] for k, v in batch.items()})
    got = log.summary(cfg.n_layers, 2)
    assert got["routings"] == got["expected_routings"] == 4 * cfg.n_layers
    assert got["remat_experts_equal"] == [True] * cfg.n_layers
    assert got["aux"] == pytest.approx(sum(want_aux) / 2, rel=1e-6)
    assert len(got["dropped_share_by_layer"]) == cfg.n_layers
    assert all(0.0 <= x < 1.0 for x in got["dropped_share_by_layer"])
    # the spy's pairing is by order: the recompute of layer i is routing
    # 2 L - 1 - i of its microbatch, and a forward's experts differ from
    # the other layer's
    L = cfg.n_layers
    assert not torch.equal(log.own[0], log.own[1])
    assert torch.equal(log.own[0], log.own[2 * L - 1])


def test_moe_train_flops_count_granite():
    """chip_smoke.moe_train_flops at granite's full width: 2.16 GFLOP a
    token forward (experts 1.21, projections 0.40, scores 0.40, head
    0.15) and 8.5 for a remat step."""
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    cfg = configs.get_arch("granite-moe-3b-a800m").build_cfg()
    f = cs.moe_train_flops(cfg, 4096)
    assert f["forward"]["experts"] == pytest.approx(1.208, abs=1e-3)
    assert f["forward"]["attention_projections"] == pytest.approx(
        0.403, abs=1e-3)
    assert f["forward"]["scores"] == pytest.approx(0.403, abs=1e-3)
    assert f["forward"]["head"] == pytest.approx(0.151, abs=1e-3)
    assert f["forward_total"] == pytest.approx(2.17, abs=0.01)
    assert f["model_total"] == pytest.approx(8.5, abs=0.05)
    assert f["capacity"] == 1024
    assert f["executed_total"] > f["model_total"]
