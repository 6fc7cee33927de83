"""The port's MoE layer (``models/moe.py``) and MoE LM serving against the
JAX package on the CPU.

``moe_ffn``: the same numpy inputs go through JAX's function and the
port's. The routing integers (each slot's experts, queue position and
keep flag) must be equal: both take the softmax of a float32 router
product, and ties go to the lower expert. Tolerances of ``out``:
float32 atol 1e-5, rtol 1e-5 (the expert products sum in other orders;
measured below 5e-7 on outputs of order 1-3); bf16, and float32 with
``moe_accum_bf16`` (its products rounded to bf16): torch's silu rounds
once where XLA rounds each step of its sigmoid (exp, 1 +, 1 /, times
h), so h differs by a bf16 step here and there and the down product
sums those steps. Held to atol 2**-5 max|ref| and a mean error under
2**-7 of the mean |ref| (one bf16 step): measured over three seeds of
every case, up to 0.0150 max|ref| and 0.0047 mean|ref|. ``aux`` is a
float32 sum of E terms either way: within 1e-6.

Whole model: the reduced granite-moe-3b-a800m and mixtral-8x22b, the
JAX side run by ``tests/jax_moe_values.py`` (eager, layer by layer, each
MoE call's experts read), on chip_smoke's ``moe_parity`` recipe:
prefill, 4 ``serve_step``s on the cache padded to 16 slots (the last two
past them, where the rolling buffer overwrites its oldest slot), and 4
``serve_step_paged`` steps from the same prefill (the last two attend to
17 keys). float32: the port's experts equal JAX's at every call, and
logits, caches and the paged step's K/V within 2e-5. bf16: a near tie
of the router may go the other way under another rounding (JAX's
einsum attention rounds its prefill scores to bf16, the port's kernel
keeps them float32), and a token that takes another expert moves by far
more than a rounding; so the port is fed JAX's experts (chip_smoke's
``RouteLog``), held to the LM bf16 tolerance (atol 0.1, rtol 0.02), and
the (token, call) pairs whose own experts differ are counted: at most
one in 20 of them.
"""
import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp_compat import given, settings, st

from repro.models import moe as jax_moe
from repro.models import transformer as jax_tf
from repro_torch import configs
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.models import moe
from repro_torch.models import transformer as tf

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
import jax_moe_values  # noqa: E402

MOE_ARCHS = ["granite-moe-3b-a800m", "mixtral-8x22b"]
WHOLE_TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
             "bfloat16": dict(atol=0.1, rtol=0.02)}


def _cfgs(E, K, dtype, **knobs):
    """(jax cfg, port cfg) of a one-layer MoE model, d 32, d_ff 16."""
    kw = dict(name="t", n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
              d_head=16, d_ff=16, vocab=64, remat=False, **knobs)
    return (jax_tf.TransformerConfig(moe=jax_moe.MoEConfig(E, K),
                                     dtype=getattr(jnp, dtype), **kw),
            tf.TransformerConfig(moe=moe.MoEConfig(E, K),
                                 dtype=getattr(torch, dtype), **kw))


def _layer(E, d, ff, seed):
    rng = np.random.default_rng(seed)
    return {"router": rng.normal(size=(d, E)) / np.sqrt(d),
            "moe_gate": rng.normal(size=(E, d, ff)) / np.sqrt(d),
            "moe_up": rng.normal(size=(E, d, ff)) / np.sqrt(d),
            "moe_down": rng.normal(size=(E, ff, d)) / np.sqrt(ff)}


def _both(lp, jcfg, cfg):
    """``lp`` (numpy) as JAX's and the port's leaves, router float32."""
    jlp = {k: jnp.asarray(v, jnp.float32 if k == "router" else jcfg.dtype)
           for k, v in lp.items()}
    tlp = {k: torch.from_numpy(np.asarray(v, np.float32)).to(
        torch.float32 if k == "router" else cfg.dtype)
        for k, v in lp.items()}
    return jlp, tlp


def _jax_route(jcfg, router, x):
    """JAX's routing integers, by the formula of its moe_ffn: top_i,
    pos (clamped) and keep."""
    m = jcfg.moe
    B, S, _ = x.shape
    C = max(1, int(S * m.top_k / m.n_experts * (
        jcfg.moe_cf_override or m.capacity_factor)))
    probs = jax.nn.softmax(x.astype(jnp.float32) @ router, axis=-1)
    _, top_i = jax.lax.top_k(probs, m.top_k)
    flat_e = top_i.reshape(B, S * m.top_k)
    onehot = jax.nn.one_hot(flat_e, m.n_experts, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=1) - onehot) * onehot, axis=-1)
    return (np.asarray(top_i), np.asarray(jnp.minimum(pos, C - 1)),
            np.asarray(pos < C))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


CAPACITY = {"default": {}, "drops": {"moe_cf_override": 0.5},
            "no_drops": {"moe_cf_override": 1e3},
            "accum_bf16": {"moe_accum_bf16": True}}


@pytest.mark.parametrize("case", sorted(CAPACITY))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,K", [(4, 2), (8, 2), (40, 8)])
def test_moe_ffn_matches_jax(E, K, dtype, case):
    jcfg, cfg = _cfgs(E, K, dtype, **CAPACITY[case])
    jlp, tlp = _both(_layer(E, 32, 16, seed=E + K), jcfg, cfg)
    x = np.random.default_rng(E).normal(size=(2, 24, 32))
    jx = jnp.asarray(x, jcfg.dtype)
    tx = torch.from_numpy(x.astype(np.float32)).to(cfg.dtype)
    jout, jaux = jax_moe.moe_ffn(jcfg, jlp, jx)
    out, aux = moe.moe_ffn(cfg, tlp, tx)
    want_i, want_pos, want_keep = _jax_route(jcfg, jlp["router"], jx)
    _, _, top_i, pos, keep = moe.route(cfg, tlp["router"], tx)
    np.testing.assert_array_equal(top_i.numpy(), want_i)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if case == "drops":
        assert not want_keep.all()
    if case == "no_drops":
        assert want_keep.all()
    assert out.dtype == cfg.dtype and aux.dtype == torch.float32
    assert float(aux) == pytest.approx(float(jaux), abs=1e-6)
    got, want = _np(out), _np(jout)
    if dtype == "float32" and case != "accum_bf16":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        return
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 ** -5 * np.abs(want).max())
    assert np.abs(got - want).mean() <= 2 ** -7 * np.abs(want).mean()


def test_moe_ffn_gives_the_same_bits_on_a_repeat():
    """No float atomics: the dispatch writes each kept slot once."""
    jcfg, cfg = _cfgs(8, 2, "bfloat16", moe_cf_override=0.5)
    _, tlp = _both(_layer(8, 32, 16, seed=3), jcfg, cfg)
    x = torch.randn((3, 40, 32), generator=torch.Generator().manual_seed(3))
    a, b = moe.moe_ffn(cfg, tlp, x.bfloat16())[0], moe.moe_ffn(
        cfg, tlp, x.bfloat16())[0]
    assert torch.equal(a, b)


@pytest.mark.parametrize("ties", ["all", "pair"])
def test_a_tie_in_the_router_goes_to_the_lower_expert(ties):
    """Equal probabilities: jax.lax.top_k takes the lower index first;
    so does the port."""
    E, K, d = 8, 3, 32
    jcfg, cfg = _cfgs(E, K, "float32")
    router = np.zeros((d, E), np.float32)
    if ties == "pair":
        col = np.abs(np.random.default_rng(0).normal(size=d)).astype(
            np.float32)
        router[:, 5] = router[:, 2] = col
        router[:, 6] = col * 0.5
    x = np.abs(np.random.default_rng(1).normal(size=(2, 6, d))).astype(
        np.float32)
    want, _, _ = _jax_route(jcfg, jnp.asarray(router), jnp.asarray(x))
    _, _, got, _, _ = moe.route(cfg, torch.from_numpy(router),
                                torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    expect = [0, 1, 2] if ties == "all" else [2, 5, 6]
    assert (want == np.array(expect)).all()


# ---- JAX's invariants (tests/test_moe_invariants.py), in the port ----

@given(st.integers(2, 8), st.integers(1, 2), st.integers(0, 20))
@settings(max_examples=12, deadline=None)
def test_moe_finite_and_shape(E, K, seed):
    K = min(K, E)
    _, cfg = _cfgs(E, K, "float32", moe_cf_override=8.0)
    lp = moe.init_moe_layer(torch.Generator().manual_seed(seed), 32, 16,
                            cfg.moe, torch.float32)
    x = torch.randn((2, 16, 32), generator=torch.Generator().manual_seed(
        seed + 1))
    out, aux = moe.moe_ffn(cfg, lp, x)
    assert out.shape == x.shape
    assert bool(torch.isfinite(out).all())
    assert float(aux) >= 0.99   # the Switch aux loss is about 1 balanced


def test_moe_huge_capacity_no_drops_matches_dense_mixture():
    _, cfg = _cfgs(4, 2, "float32", moe_cf_override=64.0)
    lp = moe.init_moe_layer(torch.Generator().manual_seed(0), 32, 16,
                            cfg.moe, torch.float32)
    x = torch.randn((1, 8, 32), generator=torch.Generator().manual_seed(1))
    out, _ = moe.moe_ffn(cfg, lp, x)
    probs = torch.softmax(x @ lp["router"], -1)
    top_p, top_i = torch.topk(probs, 2)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    expect = torch.zeros_like(x)
    for e in range(4):
        h = torch.nn.functional.silu(x @ lp["moe_gate"][e]) * (
            x @ lp["moe_up"][e])
        w = torch.where(top_i == e, top_p, 0.0).sum(-1)
        expect = expect + (h @ lp["moe_down"][e]) * w[..., None]
    np.testing.assert_allclose(out.numpy(), expect.numpy(), atol=1e-4,
                               rtol=1e-3)


def test_moe_zero_capacity_drops_everything():
    """cf 1e-9: one slot an expert a row, every other slot dropped; the
    output stays finite."""
    _, cfg = _cfgs(4, 2, "float32", moe_cf_override=1e-9)
    lp = moe.init_moe_layer(torch.Generator().manual_seed(0), 32, 16,
                            cfg.moe, torch.float32)
    x = torch.randn((1, 8, 32), generator=torch.Generator().manual_seed(1))
    out, _ = moe.moe_ffn(cfg, lp, x)
    assert moe.capacity(cfg, 8) == 1
    _, _, top_i, _, keep = moe.route(cfg, lp["router"], x)
    assert int(keep.sum()) == len(set(top_i.reshape(-1).tolist()))
    assert bool(torch.isfinite(out).all())


# ---- whole model ----

def _port_serve(arch, dtype, pins):
    """The port on the CPU by chip_smoke's moe_parity recipe, fed the
    JAX run's tokens, and (bf16) its experts: (logits, extras, log)."""
    cfg = dataclasses.replace(configs.get_arch(arch).build_cfg(reduced=True),
                              dtype=getattr(torch, dtype))
    params = transformer_params_from_numpy(cs.lm_numpy_params(cfg), cfg)
    pinned = "".join(pins["routes"]) if dtype == "bfloat16" else None
    with cs.RouteLog(moe, cfg, pinned=pinned) as log:
        logs, extra = cs.moe_parity_serve(
            tf, cfg, params, cs.moe_parity_prompts(cfg.vocab),
            pins["tokens"])
    return logs, extra, log


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_decode_and_paged_decode_match_jax(arch, dtype):
    want = jax_moe_values.jax_serve(arch, dtype)
    logs, extra, log = _port_serve(arch, dtype, want)
    tol = WHOLE_TOL[dtype]
    if dtype == "float32":
        assert log.digits() == "".join(want["routes"])
    else:
        compared = sum(r.shape[0] * r.shape[1] for r in log.used)
        assert log.differing() <= compared // 20, log.differing()
    assert len(logs) == len(want["logits"]) == 9
    for i, (got, ref) in enumerate(zip(logs, want["logits"])):
        np.testing.assert_allclose(got.numpy(), ref, **tol,
                                   err_msg=f"call {i}")
    for key in ("k", "v"):
        np.testing.assert_allclose(extra[key].numpy(), want["cache"][key],
                                   **tol)
        np.testing.assert_allclose(extra[key + "_new"].numpy(),
                                   want[key + "_new"], **tol)


def test_full_width_moe_counts_equal_jax():
    want = {"granite-moe-3b-a800m": (3_374_295_552, 958_376_448),
            "mixtral-8x22b": (140_630_071_296, 39_161_468_928)}
    for arch, (dense, active) in want.items():
        cfg = configs.get_arch(arch).build_cfg()
        assert (cfg.params_dense, cfg.params_active) == (dense, active)
        shapes = tf.layer_shapes(cfg)
        per_layer = sum(int(np.prod(s)) for s in shapes.values())
        assert cfg.n_layers * per_layer + 2 * cfg.vocab * cfg.d_model \
            + cfg.d_model == dense
