"""The port's two-tower serving path against the JAX package on the CPU.

JAX's ``init_twotower_params(PRNGKey(0), build_cfg(reduced=True))`` is
carried across with ``convert.twotower_params_from_numpy``; ids and
candidates are made from a numpy seed. ``tower``, ``score_batch`` and
``retrieve`` are compared in float32 within rtol 1e-5, atol 1e-6: the
JAX model sums a bag with ``jnp.sum`` in an order XLA picks, the port
in slot order (the kernel's order), and the two matmul libraries block
their sums differently, so the last bits may differ; outputs are unit
vectors and their dots, of order 0.1-1. Top-k indices must be equal
except where two candidates' scores lie within that tolerance.
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

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_arch as jax_get_arch
from repro.configs import two_tower_retrieval as jax_cfgmod
from repro.models import common as jax_common
from repro.models import recsys as jax_rec
from repro_torch import configs
from repro_torch.configs import two_tower_retrieval as cfgmod
from repro_torch.configs.base import round_up
from repro_torch.convert import twotower_params_from_numpy
from repro_torch.kernels.embedding_bag.ops import embedding_bag as bag_op
from repro_torch.launch import serve
from repro_torch.models import common, recsys

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def models():
    """(jax cfg, jax params, port cfg, port params), reduced config."""
    jcfg = jax_cfgmod.build_cfg(reduced=True)
    jparams = jax_rec.init_twotower_params(jax.random.PRNGKey(0), jcfg)
    cfg = cfgmod.build_cfg(reduced=True)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, cfg, twotower_params_from_numpy(tree, cfg)


def ids_for(cfg, B, seed, vocab=None):
    rng = np.random.default_rng(seed)
    vocab = cfg.user_vocab if vocab is None else vocab
    return rng.integers(-1, vocab, (B, cfg.n_fields, cfg.bag_size)).astype(
        np.int32)


def batch_pair(ids_u, ids_i):
    return ({"user_ids": jnp.asarray(ids_u), "item_ids": jnp.asarray(ids_i)},
            {"user_ids": torch.from_numpy(ids_u),
             "item_ids": torch.from_numpy(ids_i)})


def test_converted_params_hold_the_jax_values(models):
    _, jparams, cfg, params = models
    assert set(params) == set(recsys.PARAM_NAMES)
    np.testing.assert_array_equal(params["user_table"].numpy(),
                                  np.asarray(jparams["user_table"]))
    for name in ("user_tower", "item_tower"):
        assert set(params[name]) == set(jparams[name])
        for k, v in params[name].items():
            assert v.dtype == torch.float32
            np.testing.assert_array_equal(v.numpy(),
                                          np.asarray(jparams[name][k]))


@pytest.mark.parametrize("combine", ["mean", "sum"])
def test_model_embedding_bag_matches_jax(models, combine):
    jcfg, jparams, cfg, params = models
    ids = ids_for(cfg, 32, seed=1)
    ids[0] = -1                                    # an all-pad example
    want = jax_rec.embedding_bag(jparams["user_table"], jnp.asarray(ids),
                                 jcfg, combine)
    got = recsys.embedding_bag(params["user_table"], torch.from_numpy(ids),
                               cfg, combine)
    assert got.shape == (32, cfg.n_fields, cfg.embed_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("seed", [2, 3])
def test_tower_matches_jax(models, seed):
    jcfg, jparams, cfg, params = models
    ids = ids_for(cfg, 32, seed)
    want = jax_rec.tower(jparams["item_tower"], jparams["item_table"],
                         jnp.asarray(ids), jcfg)
    with torch.inference_mode():
        got = recsys.tower(params["item_tower"], params["item_table"],
                           torch.from_numpy(ids), cfg)
    assert got.shape == (32, cfg.tower_dims[-1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0,
                               rtol=1e-5)


@pytest.mark.parametrize("B,seed", [(32, 4), (512, 5), (1, 6)])
def test_score_batch_matches_jax(models, B, seed):
    jcfg, jparams, cfg, params = models
    jb, tb = batch_pair(ids_for(cfg, B, seed), ids_for(cfg, B, seed + 100))
    want = jax_rec.score_batch(jparams, jb, jcfg)
    before = bag_op.launches
    with torch.inference_mode():
        got = recsys.score_batch(params, tb, cfg)
    assert bag_op.launches == before              # the CPU takes no kernel
    assert got.shape == (B,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_retrieve_matches_jax(models):
    """n_cand 2,048, top_k 128, as the reduced retrieval_cand cell."""
    jcfg, jparams, cfg, params = models
    rng = np.random.default_rng(7)
    ids = ids_for(cfg, 1, seed=8)
    cands = rng.normal(size=(2048, cfg.tower_dims[-1])).astype(np.float32)
    jb = {"user_ids": jnp.asarray(ids), "cand_embs": jnp.asarray(cands)}
    jv, ji = jax_rec.retrieve(jparams, jb, jcfg, top_k=128)
    with torch.inference_mode():
        tv, ti = recsys.retrieve(params, {
            "user_ids": torch.from_numpy(ids),
            "cand_embs": torch.from_numpy(cands)}, cfg, top_k=128)
    assert tv.shape == (128,) and ti.dtype == torch.int32
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    u = jax_rec.tower(jparams["user_tower"], jparams["user_table"],
                      jnp.asarray(ids), jcfg)
    scores = np.asarray(u @ jnp.asarray(cands).T)[0]
    ji, ti = np.asarray(ji), ti.numpy()
    differ = np.flatnonzero(ji != ti)
    for pos in differ:                # only near-ties may swap places
        np.testing.assert_allclose(scores[ti[pos]], scores[ji[pos]], **TOL)
    assert differ.size <= 2


def test_top_k_orders_exact_ties_by_lower_index():
    """Many exact ties: the order of ``jax.lax.top_k``, value descending
    and the lower index first."""
    rng = np.random.default_rng(9)
    scores = rng.integers(0, 6, size=500).astype(np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(scores), 40)
    got_v, got_i = recsys.ordered_top_k(torch.from_numpy(scores), 40)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    with pytest.raises(ValueError, match="top_k"):
        recsys.ordered_top_k(torch.from_numpy(scores), 501)


def test_retrieve_breaks_tied_candidates_by_lower_index(models):
    """Candidates repeated across the matrix score exactly alike; the
    lower index comes first, as in the JAX package."""
    jcfg, jparams, cfg, params = models
    rng = np.random.default_rng(10)
    base = rng.normal(size=(8, cfg.tower_dims[-1])).astype(np.float32)
    cands = np.tile(base, (64, 1))                 # 512 rows, 8 distinct
    ids = ids_for(cfg, 1, seed=11)
    _, ji = jax_rec.retrieve(jparams, {"user_ids": jnp.asarray(ids),
                                       "cand_embs": jnp.asarray(cands)},
                             jcfg, top_k=100)
    with torch.inference_mode():
        tv, ti = recsys.retrieve(params, {
            "user_ids": torch.from_numpy(ids),
            "cand_embs": torch.from_numpy(cands)}, cfg, top_k=100)
    ti = ti.numpy()
    np.testing.assert_array_equal(ti, np.asarray(ji))
    assert np.all(ti[:64] % 8 == ti[0] % 8) and np.all(np.diff(ti[:64]) > 0)


def test_mlp_apply_matches_jax():
    rng = np.random.default_rng(12)
    dims = (12, 7, 5, 3)
    p = {f"w{i}": rng.normal(size=(dims[i], dims[i + 1])).astype(np.float32)
         for i in range(3)}
    p.update({f"b{i}": rng.normal(size=dims[i + 1]).astype(np.float32)
              for i in range(3)})
    x = rng.normal(size=(9, 12)).astype(np.float32)
    for final_act in (False, True):
        want = jax_common.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                                    jnp.asarray(x), 3, final_act=final_act)
        got = common.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                               torch.from_numpy(x), 3, final_act=final_act)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("final_act", [False, True])
def test_mlp_apply_act_matches_jax(final_act):
    """``act`` as schnet passes it (softplus), within float32 rounding."""
    rng = np.random.default_rng(13)
    dims = (10, 6, 4)
    p = {f"w{i}": rng.normal(size=(dims[i], dims[i + 1])).astype(np.float32)
         for i in range(2)}
    p.update({f"b{i}": rng.normal(size=dims[i + 1]).astype(np.float32)
              for i in range(2)})
    x = rng.normal(size=(7, 10)).astype(np.float32)
    want = jax_common.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), 2, act=jax.nn.softplus,
                                final_act=final_act)
    got = common.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), 2,
                           act=torch.nn.functional.softplus,
                           final_act=final_act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", ["dense_init", "embed_init", "mlp_init"])
def test_init_default_dtype_equals_jax(name):
    """With no dtype the inits draw JAX's DEFAULT_DTYPE, bfloat16."""
    jax_fn, fn = getattr(jax_common, name), getattr(common, name)
    args = ([3, 5, 2],) if name == "mlp_init" else (3, 5)
    want = jax_fn(jax.random.PRNGKey(0), *args)
    got = fn(torch.Generator().manual_seed(0), *args)
    if name == "mlp_init":
        assert {k: str(v.dtype) for k, v in got.items()} == {
            k: "torch." + str(v.dtype) for k, v in want.items()}
    else:
        assert str(got.dtype) == "torch." + str(want.dtype)
    assert common.DEFAULT_DTYPE == torch.bfloat16
    assert str(jax_common.DEFAULT_DTYPE.dtype) == "bfloat16"


def test_init_matches_jax_shapes_and_scales():
    """Same tree, shapes and dtypes as JAX's init; the draws differ (the
    generators differ), so the scales are checked: table std 0.02,
    dense std 1/sqrt(in), zero biases."""
    jcfg = jax_cfgmod.build_cfg(reduced=True)
    cfg = cfgmod.build_cfg(reduced=True)
    jp = jax_rec.init_twotower_params(jax.random.PRNGKey(0), jcfg)
    gen = torch.Generator().manual_seed(0)
    tp = recsys.init_twotower_params(gen, cfg, "cpu")
    jshapes = jax.tree.map(lambda a: a.shape, jp)
    tshapes = {k: (tuple(v.shape) if isinstance(v, torch.Tensor)
                   else {kk: tuple(vv.shape) for kk, vv in v.items()})
               for k, v in tp.items()}
    assert tshapes == jshapes
    assert abs(float(tp["user_table"].std()) - 0.02) < 0.002
    w0 = tp["user_tower"]["w0"]
    assert abs(float(w0.std()) * np.sqrt(w0.shape[0]) - 1.0) < 0.05
    assert not tp["item_tower"]["b1"].any()
    again = recsys.init_twotower_params(torch.Generator().manual_seed(0),
                                        cfg, "cpu")
    assert torch.equal(again["item_table"], tp["item_table"])
    bf = recsys.init_twotower_params(
        torch.Generator().manual_seed(0),
        dataclasses.replace(cfg, dtype=torch.bfloat16), "cpu")
    assert bf["user_table"].dtype == torch.bfloat16


def test_init_rejects_a_mismatched_tower():
    cfg = dataclasses.replace(cfgmod.build_cfg(reduced=True), embed_dim=8)
    with pytest.raises(ValueError, match="tower input"):
        recsys.init_twotower_params(torch.Generator(), cfg)


def test_convert_checks_names_and_shapes(models):
    _, jparams, cfg, _ = models
    tree = jax.tree.map(np.asarray, jparams)
    with pytest.raises(ValueError, match="two-tower params"):
        twotower_params_from_numpy({**tree, "extra": tree["user_table"]},
                                   cfg)
    bad = dict(tree, user_table=tree["user_table"][:-1])
    with pytest.raises(ValueError, match="user_table has shape"):
        twotower_params_from_numpy(bad, cfg)
    tower = dict(tree["item_tower"])
    tower.pop("b1")
    with pytest.raises(ValueError, match="item_tower holds"):
        twotower_params_from_numpy(dict(tree, item_tower=tower), cfg)


def test_config_numbers_equal_jax():
    assert cfgmod._FULL == jax_cfgmod._FULL
    assert cfgmod._RED == jax_cfgmod._RED
    assert cfgmod.SHAPES.keys() == jax_cfgmod.SHAPES.keys()
    for name, spec in cfgmod.SHAPES.items():
        j = jax_cfgmod.SHAPES[name]
        assert (spec.name, spec.kind, dict(spec.meta)) == (
            j.name, j.kind, dict(j.meta))
    for reduced in (False, True):
        c, jc = cfgmod.build_cfg(reduced), jax_cfgmod.build_cfg(reduced)
        for f in dataclasses.fields(c):
            if f.name != "dtype":
                assert getattr(c, f.name) == getattr(jc, f.name), f.name
        assert c.dtype == torch.float32 and jc.dtype == jnp.float32
        for shape in cfgmod.SHAPES:
            got = cfgmod.input_specs(shape, reduced)
            want = jax_cfgmod.input_specs(shape, reduced)
            assert got.keys() == want.keys()
            for k, (shp, dt) in got.items():
                assert shp == want[k].shape
                assert str(dt).removeprefix("torch.") == str(want[k].dtype)
    arch = configs.get_arch("two-tower-retrieval")
    jarch = jax_get_arch("two-tower-retrieval")
    assert (arch.arch_id, arch.family, arch.notes) == (
        jarch.arch_id, jarch.family, jarch.notes)
    assert arch.step_kind("retrieval_cand") == "retrieve"
    assert round_up(1000, 128) == 1024


def test_registry_knows_every_jax_arch():
    assert configs.ARCH_IDS == JAX_ARCH_IDS
    for arch_id in JAX_ARCH_IDS:
        assert configs.FAMILIES[arch_id] == jax_get_arch(arch_id).family
        if arch_id in configs.PORTED:
            continue
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            configs.get_arch(arch_id)
    # hype_paper (item 17a): the paper's run grid, field for field JAX's
    got, want = configs.get_arch("hype_paper"), jax_get_arch("hype_paper")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_arch("nope")


def test_serve_cli_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "two-tower-retrieval", "--reduced", "--device", "cpu", "--batch",
         "16"], env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert re.fullmatch(r"two-tower-retrieval: scored 16 pairs in "
                        r"[0-9.]+ ms on cpu\n", proc.stdout), proc.stdout


def test_serve_main_scores_like_score_batch():
    """The launcher's params and ids, rebuilt here, give its scores."""
    got = serve.main(["--arch", "two-tower-retrieval", "--reduced",
                      "--device", "cpu", "--batch", "8"])
    cfg = cfgmod.build_cfg(reduced=True)
    params = recsys.init_twotower_params(torch.Generator().manual_seed(0),
                                         cfg, "cpu")
    rng = np.random.default_rng(0)
    shape = (8, cfg.n_fields, cfg.bag_size)
    batch = {name: torch.from_numpy(
        rng.integers(-1, vocab, shape).astype(np.int32))
        for name, vocab in (("user_ids", cfg.user_vocab),
                            ("item_ids", cfg.item_vocab))}
    with torch.inference_mode():
        want = recsys.score_batch(params, batch, cfg)
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch,err,match", [
    ("mixtral-8x22b", None, None),
    ("graphsage-reddit", SystemExit, "trained, not served"),
])
def test_serve_other_families(arch, err, match):
    """A GNN arch is trained, not served; the MoE LM mixtral-8x22b (which
    raised until item 15e) serves its launcher defaults: 4 prompts, the
    token after each and 16 more."""
    argv = ["--arch", arch, "--reduced", "--device", "cpu"]
    if err is None:
        toks = serve.main(argv)
        assert toks.shape == (4, 17) and toks.dtype == torch.int32
        return
    with pytest.raises(err, match=match):
        serve.main(argv)


def test_serve_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "two-tower-retrieval", "--reduced"])
