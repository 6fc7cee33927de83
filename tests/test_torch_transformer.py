"""The port's LM serving path against the JAX package on the CPU.

JAX's ``init_params(PRNGKey(0), cfg)`` for a reduced config is carried
across with ``convert.transformer_params_from_numpy``; prompts come from
a numpy seed. ``prefill``, eight ``serve_step``s and the greedy tokens
are compared on the cache as prefill returns it (unpadded: decode
overwrites the oldest slots, as the JAX launcher does) and on a cache
padded by 8 slots (as ``tests/test_serving.py`` pads it);
``serve_step_paged`` against JAX's before and past a full buffer, and
against ``serve_step`` over the same keys.

Tolerances. float32: atol 2e-5, rtol 2e-5 on logits of order 1-4 (the
port's prefill attention is an online softmax over key tiles, the JAX
model's one softmax over materialised scores, and the matmul libraries
block their sums differently; measured differences are below 5e-6),
with equal greedy tokens. bfloat16: atol 0.1, rtol 0.02, about six
bf16 steps at that scale: JAX's einsum path rounds the prefill scores
and probabilities to bfloat16 where the port's kernel keeps them in
float32, and every layer rounds its residual to bfloat16, so the two
drift by a few steps (measured below 0.06). In bfloat16 both sides are
fed the JAX side's tokens, and a greedy token must agree wherever
JAX's top two logits lie further apart than the tolerance.
"""
import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import common as jax_common
from repro.models import transformer as jax_tf
from repro_torch import configs
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.launch import serve
from repro_torch.models import common, transformer as tf
from repro_torch.models.moe import MoEConfig

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
DENSE = ["stablelm-3b", "qwen3-8b", "llama3-405b"]
MOE = ["mixtral-8x22b", "granite-moe-3b-a800m"]
TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=0.1, rtol=0.02)}


def _pair(arch, dtype="float32", **changes):
    """(jax cfg, port cfg) of the reduced ``arch`` with ``changes``."""
    jcfg = dataclasses.replace(jax_get_arch(arch).build_cfg(reduced=True),
                               dtype=getattr(jnp, dtype), **changes)
    cfg = dataclasses.replace(configs.get_arch(arch).build_cfg(reduced=True),
                              dtype=getattr(torch, dtype), **changes)
    return jcfg, cfg


def _params(jcfg, cfg, seed=0):
    jp = jax_tf.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, transformer_params_from_numpy(jax.tree.map(np.asarray, jp),
                                             cfg)


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _pad(jcache, cache, pad):
    jcache = dict(jcache)
    for key in ("k", "v"):
        jcache[key] = jnp.pad(jcache[key], ((0, 0), (0, 0), (0, pad),
                                            (0, 0), (0, 0)))
        z = cache[key].new_zeros(cache[key].shape[:2] + (pad,)
                                 + cache[key].shape[3:])
        cache[key] = torch.cat([cache[key], z], dim=2)
    return jcache, cache


# the variants: qk-norm on (qwen3) and off (stablelm), MQA (qwen3 reduced
# has 1 kv head), GQA 2:1, MHA (stablelm), a window of 24 (llama3's
# reduced config with one)
VARIANTS = {
    "qwen3_qknorm_mqa": ("qwen3-8b", {}),
    "qwen3_qknorm_gqa": ("qwen3-8b", {"n_kv_heads": 2}),
    "stablelm_mha": ("stablelm-3b", {}),
    "llama3_window24": ("llama3-405b", {"window": 24, "n_kv_heads": 2}),
}


@pytest.mark.parametrize("pad", [0, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_and_decode_match_jax(variant, dtype, pad):
    arch, changes = VARIANTS[variant]
    jcfg, cfg = _pair(arch, dtype, **changes)
    jp, params = _params(jcfg, cfg)
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 40)).astype(np.int32)
    jcache, jlog = jax.jit(lambda p, t: jax_tf.prefill(p, t, jcfg))(
        jp, jnp.asarray(prompts))
    jstep = jax.jit(lambda p, c, t: jax_tf.serve_step(p, c, t, jcfg))
    with torch.inference_mode():
        cache, logits = tf.prefill(params, torch.from_numpy(prompts), cfg)
    assert logits.dtype == cfg.dtype and logits.shape == (2, cfg.vocab)
    assert cache["pos"] == int(jcache["pos"]) == 40
    np.testing.assert_allclose(_np(cache["k"]), _np(jcache["k"]),
                               **TOL[dtype])
    if pad:
        jcache, cache = _pad(jcache, cache, pad)
    tol = TOL[dtype]
    for step in range(9):
        np.testing.assert_allclose(_np(logits), _np(jlog), **tol,
                                   err_msg=f"step {step}")
        want = np.argmax(_np(jlog), -1)
        got = np.argmax(_np(logits), -1)
        if dtype == "float32":
            np.testing.assert_array_equal(got, want)
        else:
            top2 = np.sort(_np(jlog), -1)[:, -2:]
            clear = top2[:, 1] - top2[:, 0] > 2 * tol["atol"]
            np.testing.assert_array_equal(got[clear], want[clear])
        if step == 8:
            break
        tok = want[:, None].astype(np.int32)
        jlog, jcache = jstep(jp, jcache, jnp.asarray(tok))
        with torch.inference_mode():
            logits, cache = tf.serve_step(params, cache,
                                          torch.from_numpy(tok), cfg)
        assert cache["pos"] == int(jcache["pos"])
    np.testing.assert_allclose(_np(cache["v"]), _np(jcache["v"]), **tol)


def test_unpadded_cache_overwrites_the_oldest_slot_as_jax_does():
    """Reference behaviour, kept: on the cache as prefill returns it the
    first decode step writes slot pos % S = 0, over the first prompt
    token, and attends to every slot; the logits differ from those on a
    padded cache, in both packages alike."""
    jcfg, cfg = _pair("qwen3-8b")
    jp, params = _params(jcfg, cfg)
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 16)).astype(np.int32)
    tok = np.array([[3], [7]], np.int32)
    out = {}
    for pad in (0, 4):
        jcache, _ = jax_tf.prefill(jp, jnp.asarray(prompts), jcfg)
        with torch.inference_mode():
            cache, _ = tf.prefill(params, torch.from_numpy(prompts), cfg)
            k0 = cache["k"][:, :, 0].clone()
            if pad:
                jcache, cache = _pad(jcache, cache, pad)
            jl, _ = jax_tf.serve_step(jp, jcache, jnp.asarray(tok), jcfg)
            logits, cache = tf.serve_step(params, cache,
                                          torch.from_numpy(tok), cfg)
        np.testing.assert_allclose(_np(logits), _np(jl), **TOL["float32"])
        overwritten = not torch.equal(cache["k"][:, :, 0], k0)
        assert overwritten == (pad == 0)
        out[pad] = _np(logits)
    assert np.abs(out[0] - out[4]).max() > 0.1


def test_decode_on_a_padded_cache_matches_the_full_forward():
    """Greedy decode on a padded cache equals re-running forward over the
    growing sequence (tests/test_serving.py's oracle), in the port."""
    _, cfg = _pair("qwen3-8b", n_kv_heads=2)
    params = tf.init_params(torch.Generator().manual_seed(3), cfg)
    prompts = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 16)).astype(np.int32))
    with torch.inference_mode():
        filled, logits = tf.prefill(params, prompts, cfg)
        cache = tf.init_cache(cfg, 2, 22)
        cache["k"][:, :, :16] = filled["k"]
        cache["v"][:, :, :16] = filled["v"]
        cache["pos"] = filled["pos"]
        got = [logits.argmax(-1)]
        for _ in range(5):
            logits, cache = tf.serve_step(
                params, cache, got[-1][:, None].to(torch.int32), cfg)
            got.append(logits.argmax(-1))
        toks, want = prompts, []
        for _ in range(6):
            x, aux = tf.forward(params, toks, cfg)
            want.append((x[:, -1] @ params["lm_head"]).argmax(-1))
            toks = torch.cat([toks, want[-1][:, None].to(torch.int32)], 1)
    assert float(aux) == 0.0
    assert torch.equal(torch.stack(got, 1), torch.stack(want, 1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(dtype):
    jcfg, cfg = _pair("qwen3-8b", dtype, n_kv_heads=2)
    jp, params = _params(jcfg, cfg, seed=4)
    toks = np.random.default_rng(4).integers(0, cfg.vocab,
                                             (2, 24)).astype(np.int32)
    jx, _ = jax_tf.forward(jp, jnp.asarray(toks), jcfg)
    with torch.inference_mode():
        x, _ = tf.forward(params, torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(_np(x), _np(jx), **TOL[dtype])


def test_prefill_launches_no_kernel_on_the_cpu():
    _, cfg = _pair("qwen3-8b")
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    before = flash_attention.launches
    with torch.inference_mode():
        tf.prefill(params, torch.zeros((1, 8), dtype=torch.int32), cfg)
    assert flash_attention.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_and_rope_match_jax(dtype):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 9, 4, 16)).astype(np.float32)
    g = rng.normal(size=16).astype(np.float32)
    jx, jg = (jnp.asarray(a, getattr(jnp, dtype)) for a in (x, g))
    tx, tg = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, g))
    got = common.rms_norm(tx, tg)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(jax_common.rms_norm(jx, jg)),
                               **TOL[dtype])
    pos = np.arange(9)[None, :]
    js, jc = jax_common.rotary_embedding(jnp.asarray(pos), 16, 1e6)
    ts, tc = common.rotary_embedding(torch.from_numpy(pos), 16, 1e6)
    np.testing.assert_allclose(_np(ts), _np(js), atol=1e-6)
    np.testing.assert_allclose(_np(tc), _np(jc), atol=1e-6)
    got = common.apply_rope(tx, ts, tc)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got),
                               _np(jax_common.apply_rope(jx, js, jc)),
                               **TOL[dtype])


def test_converted_params_hold_the_jax_values():
    jcfg, cfg = _pair("qwen3-8b", "bfloat16")
    jp, params = _params(jcfg, cfg)
    assert set(params) == {"embed", "lm_head", "ln_f", "layers"}
    assert set(params["layers"]) == set(jp["layers"])
    for name, leaf in params["layers"].items():
        assert leaf.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(leaf), _np(jp["layers"][name]))
    np.testing.assert_array_equal(_np(params["embed"]), _np(jp["embed"]))


def test_convert_checks_names_and_shapes():
    jcfg, cfg = _pair("qwen3-8b")
    tree = jax.tree.map(np.asarray, jax_tf.init_params(
        jax.random.PRNGKey(0), jcfg))
    with pytest.raises(ValueError, match="LM params"):
        transformer_params_from_numpy({**tree, "extra": 0}, cfg)
    bad = {**tree, "layers": {**tree["layers"], "wq": tree["layers"]["wq"][0]}}
    with pytest.raises(ValueError, match="layers.wq has shape"):
        transformer_params_from_numpy(bad, cfg)
    no_qk = dataclasses.replace(cfg, qk_norm=False)
    with pytest.raises(ValueError, match="layers hold"):
        transformer_params_from_numpy(tree, no_qk)


def test_init_matches_jax_shapes_and_scales():
    jcfg, cfg = _pair("qwen3-8b", "bfloat16")
    jp = jax_tf.init_params(jax.random.PRNGKey(0), jcfg)
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    flat = {"embed": params["embed"], "lm_head": params["lm_head"],
            "ln_f": params["ln_f"],
            **{f"layers.{k}": v for k, v in params["layers"].items()}}
    jflat = {"embed": jp["embed"], "lm_head": jp["lm_head"],
             "ln_f": jp["ln_f"],
             **{f"layers.{k}": v for k, v in jp["layers"].items()}}
    assert set(flat) == set(jflat)
    for name, t in flat.items():
        assert tuple(t.shape) == jflat[name].shape, name
        assert t.dtype == torch.bfloat16
        std = float(t.float().std()) if t.dim() >= 2 and t.shape[-1] > 1 \
            else 0.0
        jstd = float(jnp.std(jflat[name].astype(jnp.float32))) \
            if t.dim() >= 2 and t.shape[-1] > 1 else 0.0
        assert std == pytest.approx(jstd, rel=0.1, abs=1e-6), name
    # every layer's leaves are their own draws
    assert not torch.equal(params["layers"]["wq"][0],
                           params["layers"]["wq"][1])


_CFG_FIELDS = [f.name for f in dataclasses.fields(tf.TransformerConfig)
               if f.name not in ("dtype", "moe")]
# The JAX config's training and sharding knobs, which the port leaves out.
_JAX_ONLY_FIELDS = {"remat", "scan_layers", "seq_shard", "constrain",
                    "attention_impl", "attention_block", "moe_shard_c"}


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", DENSE + MOE)
def test_config_numbers_equal_jax(arch, reduced):
    jcfg = jax_get_arch(arch).build_cfg(reduced=reduced)
    cfg = configs.get_arch(arch).build_cfg(reduced=reduced)
    assert {f.name for f in dataclasses.fields(jcfg)} == set(
        _CFG_FIELDS) | {"dtype", "moe"} | _JAX_ONLY_FIELDS
    for name in _CFG_FIELDS:
        assert getattr(cfg, name) == getattr(jcfg, name), name
    assert (cfg.moe is None) == (jcfg.moe is None) == (arch in DENSE)
    if cfg.moe is not None:
        assert dataclasses.asdict(cfg.moe) == dataclasses.asdict(jcfg.moe)
    assert cfg.dtype == torch.bfloat16 and jcfg.dtype == jnp.bfloat16
    assert cfg.params_dense == jcfg.params_dense
    assert cfg.params_active == jcfg.params_active
    assert cfg.vocab_padded == jcfg.vocab_padded
    arch_def, jarch = configs.get_arch(arch), jax_get_arch(arch)
    assert (arch_def.family, dict(arch_def.accum_steps), arch_def.notes) == (
        jarch.family, dict(jarch.accum_steps), jarch.notes)
    for shape in jarch.shapes:
        assert arch_def.step_kind(shape) == jarch.step_kind(shape)
        assert arch_def.skip(shape) == jarch.skip(shape)
        got = arch_def.input_specs(shape, reduced=reduced)
        want = jarch.input_specs(shape, reduced=reduced)
        assert set(got) == set(want)
        for name, (shp, dtype) in got.items():
            assert shp == tuple(want[name].shape), (shape, name)
            assert str(dtype).removeprefix("torch.") == str(
                want[name].dtype), (shape, name)


def test_qwen3_8b_full_width_numbers():
    cfg = configs.get_arch("qwen3-8b").build_cfg()
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_head, cfg.d_ff, cfg.vocab) == (36, 4096, 32, 8, 128,
                                                 12288, 151936)
    assert cfg.qk_norm and cfg.rope_theta == 1e6
    assert cfg.params_dense == 8_190_726_144


@pytest.mark.parametrize("arch", MOE)
def test_moe_archs_serve_through_the_launcher(arch):
    """The MoE archs, which raised until MoE serving was ported (item
    15e), now serve: get_arch returns the port's config (its numbers are
    JAX's: test_config_numbers_equal_jax), and the serve launcher's
    tokens on the reduced config are prefill and greedy serve_steps of
    its params and prompts."""
    cfg = configs.get_arch(arch).build_cfg(reduced=True)
    assert cfg.moe == MoEConfig(4, 2, 1.25)
    got = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt_len", "20", "--tokens", "4"])
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    assert params["layers"]["router"].dtype == torch.float32
    assert params["layers"]["moe_gate"].shape == (2, 4, 64, 128)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 20)).astype(np.int32))
    with torch.inference_mode():
        cache, logits = tf.prefill(params, prompts, cfg)
        want = [logits.argmax(-1)[:, None].to(torch.int32)]
        for _ in range(4):
            logits, cache = tf.serve_step(params, cache, want[-1], cfg)
            want.append(logits.argmax(-1)[:, None].to(torch.int32))
    assert torch.equal(got, torch.cat(want, 1))


def test_paged_decode_and_moe_paths_run():
    """The paths that raised until paged decode and MoE layers were
    ported (items 15f, 15e) now run: serve_step ignores decode_paged, as
    JAX's does; serve_step_paged leaves the cache as it was; lm_loss and
    init_params take an MoE config."""
    _, cfg = _pair("qwen3-8b")
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, 6)).astype(np.int32))
    tok = torch.zeros((1, 1), dtype=torch.int32)
    with torch.inference_mode():
        filled, _ = tf.prefill(params, prompts, cfg)
        out = []
        for paged in (False, True):
            cache = dict(filled, k=filled["k"].clone(),
                         v=filled["v"].clone())
            out.append(tf.serve_step(params, cache, tok, dataclasses.replace(
                cfg, decode_paged=paged)))
        assert torch.equal(out[0][0], out[1][0])
        assert torch.equal(out[0][1]["k"], out[1][1]["k"])
        before = filled["k"].clone()
        logits, k_new, v_new, pos = tf.serve_step_paged(params, filled, tok,
                                                        cfg)
    assert torch.equal(filled["k"], before) and pos == filled["pos"] + 1
    assert k_new.shape == v_new.shape == (cfg.n_layers, 1, 1,
                                          cfg.n_kv_heads, cfg.d_head)
    # lm_loss, once pending (item 15d), now trains: a finite float32 scalar
    loss = tf.lm_loss(params, {"tokens": tok, "labels": tok}, cfg)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert bool(torch.isfinite(loss))
    moe_cfg = dataclasses.replace(cfg, moe=MoEConfig(4, 2))
    moe_params = tf.init_params(torch.Generator(), moe_cfg)
    assert "w_gate" not in moe_params["layers"]
    loss = tf.lm_loss(moe_params, {"tokens": tok, "labels": tok}, moe_cfg)
    assert bool(torch.isfinite(loss))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_serve_step_paged_matches_jax(variant, dtype):
    """serve_step_paged against JAX's on the cache padded by 4 slots:
    4 steps at pos < Skv, each step's K/V appended at its slot, then 3
    on the full buffer (pos >= Skv: every slot valid, plus the new
    token); logits, k_new and v_new within the LM tolerances, and the
    cache left as it was."""
    arch, changes = VARIANTS[variant]
    jcfg, cfg = _pair(arch, dtype, **changes)
    jp, params = _params(jcfg, cfg)
    prompts = np.random.default_rng(9).integers(
        0, cfg.vocab, (2, 12)).astype(np.int32)
    jcache, _ = jax_tf.prefill(jp, jnp.asarray(prompts), jcfg)
    with torch.inference_mode():
        cache, _ = tf.prefill(params, torch.from_numpy(prompts), cfg)
    jcache, cache = _pad(jcache, cache, 4)
    Skv = cache["k"].shape[2]
    jstep = jax.jit(lambda p, c, t: jax_tf.serve_step_paged(p, c, t, jcfg))
    tol = TOL[dtype]
    for step in range(7):
        tok = np.random.default_rng(step).integers(
            0, cfg.vocab, (2, 1)).astype(np.int32)
        jl, jk, jv, jpos = jstep(jp, jcache, jnp.asarray(tok))
        before = cache["k"].clone()
        with torch.inference_mode():
            logits, k, v, pos = tf.serve_step_paged(
                params, cache, torch.from_numpy(tok), cfg)
        assert torch.equal(cache["k"], before)
        assert k.shape == tuple(jk.shape) and pos == int(jpos)
        np.testing.assert_allclose(_np(logits), _np(jl), **tol,
                                   err_msg=f"step {step}")
        np.testing.assert_allclose(_np(k), _np(jk), **tol)
        np.testing.assert_allclose(_np(v), _np(jv), **tol)
        slot = cache["pos"] % Skv
        jcache = {"k": jcache["k"].at[:, :, slot].set(jk[:, :, 0]),
                  "v": jcache["v"].at[:, :, slot].set(jv[:, :, 0]),
                  "pos": jpos}
        cache["k"][:, :, slot] = k[:, :, 0]
        cache["v"][:, :, slot] = v[:, :, 0]
        cache["pos"] = pos


@pytest.mark.parametrize("pos_past", [False, True])
def test_paged_step_equals_serve_step_on_the_same_keys(pos_past):
    """Reference behaviour, kept: serve_step_paged attends to the slots
    before pos and the new token; on a full rolling buffer to all Skv
    slots and the new token (Skv + 1 keys). serve_step on a copy of the
    cache holding those keys (one slot more, rolled so that the step
    writes it; chip_smoke's ``same_keys``) gives the same logits and K/V,
    in float32; on the rolling buffer itself (the oldest slot
    overwritten) it does not."""
    _, cfg = _pair("llama3-405b", window=16, n_kv_heads=2)
    params = tf.init_params(torch.Generator().manual_seed(5), cfg)
    S = 24 if pos_past else 12
    prompts = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, S)).astype(np.int32))
    tok = torch.tensor([[3], [9]], dtype=torch.int32)
    with torch.inference_mode():
        cache, _ = tf.prefill(params, prompts, cfg)
        if not pos_past:
            cache = _pad_to(cache, 16)
        Skv = cache["k"].shape[2]
        assert (cache["pos"] >= Skv) == pos_past
        logits, k, v, _ = tf.serve_step_paged(params, cache, tok, cfg)
        ref = cs.same_keys(cache)
        want, ref = tf.serve_step(params, ref, tok, cfg)
        slot = cache["pos"] % ref["k"].shape[2]
        rolled, _ = tf.serve_step(params, dict(
            cache, k=cache["k"].clone(), v=cache["v"].clone()), tok, cfg)
    np.testing.assert_allclose(logits.numpy(), want.numpy(), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(k[:, :, 0].numpy(),
                               ref["k"][:, :, slot].numpy(), **TOL["float32"])
    np.testing.assert_allclose(v[:, :, 0].numpy(),
                               ref["v"][:, :, slot].numpy(), **TOL["float32"])
    gap = float((logits - rolled).abs().max())
    assert (gap > 1e-3) == pos_past


def _pad_to(cache, slots):
    """``cache`` padded with zero slots to ``slots``."""
    pad = slots - cache["k"].shape[2]
    return dict(cache, **{key: torch.cat([cache[key], torch.zeros_like(
        cache[key][:, :, :pad])], dim=2) for key in ("k", "v")})


def test_init_cache_matches_jax():
    for arch, window in (("qwen3-8b", None), ("llama3-405b", 24)):
        jcfg, cfg = _pair(arch, "bfloat16", window=window)
        jc = jax_tf.init_cache(jcfg, 3, 40)
        c = tf.init_cache(cfg, 3, 40)
        assert tuple(c["k"].shape) == jc["k"].shape
        assert c["v"].dtype == torch.bfloat16 and c["pos"] == 0


def test_serve_cli_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-8b", "--reduced", "--device", "cpu"], env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert re.fullmatch(r"qwen3-8b: served 64 tokens in [0-9.]+s "
                        r"\([0-9.]+ tok/s incl\. prefill\) on cpu\n",
                        proc.stdout), proc.stdout


def test_serve_main_decodes_like_prefill_and_serve_step():
    """The launcher's params and prompts, rebuilt here, give its tokens:
    greedy decode on the unpadded cache."""
    got = serve.main(["--arch", "stablelm-3b", "--reduced", "--device",
                      "cpu", "--batch", "2", "--prompt_len", "12",
                      "--tokens", "5"])
    cfg = configs.get_arch("stablelm-3b").build_cfg(reduced=True)
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 12)).astype(np.int32))
    with torch.inference_mode():
        cache, logits = tf.prefill(params, prompts, cfg)
        want = [logits.argmax(-1)[:, None].to(torch.int32)]
        for _ in range(5):
            logits, cache = tf.serve_step(params, cache, want[-1], cfg)
            want.append(logits.argmax(-1)[:, None].to(torch.int32))
    assert got.shape == (2, 6)
    assert torch.equal(got, torch.cat(want, 1))
