"""The port's gatedgcn, meshgraphnet and schnet (models/gnn.py), their
layers and the deterministic segment sum they aggregate with, against
the JAX package's.

The same batches (the copied generators give the same arrays) and the
same params (JAX's, carried over by ``convert``) go through
``repro.models.gnn`` and ``repro_torch.models.gnn`` on the CPU at the
reduced configs (2 layers, d 16, 256 nodes and 512 edges with padding;
schnet also on 8 small molecules under ``graph_reg``). The port sums by
``dst`` with ``segment_sum`` (each id's edges in chunks of 32, in edge
order), where JAX's ``segment_sum`` adds in edge order, and skips the
masked edges, whose messages JAX multiplies by 0: the two round at other
places, so the forward agrees within 2e-5 and, in float32, the loss
and every gradient within 1e-5. bf16 params trained by AdamW follow
gradients a float32 rounding apart, which can round a param to its
neighbouring bf16 value: the losses of 4 steps agree within 1e-4.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.train as jax_launch
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_arch as jax_get_arch
from repro.models import common as jax_common
from repro.models import gnn as jax_gnn
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig
from repro.train.optimizer import adamw_update as jax_adamw_update
from repro.train.optimizer import init_adamw as jax_init_adamw
from repro_torch import configs as port_configs
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.configs.gnn_common import GNN_SHAPES
from repro_torch.data import graphs
from repro_torch.kernels.neighbor_agg import ops as nops
from repro_torch.launch import train as launch_train
from repro_torch.models import common
from repro_torch.models import gnn
from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_adamw
from repro_torch.train.train_loop import value_and_grad
from repro_torch.train.tree import tree_flatten

ARCHS = ["gatedgcn", "meshgraphnet", "schnet"]
FWD_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-5)
# (arch, batch): every arch on a padded graph; schnet also on molecules
CASES = [(a, "graph") for a in ARCHS] + [("schnet", "molecules")]


def configs(arch, task=None):
    cfg = get_arch(arch).build_cfg(reduced=True)
    jcfg = jax_get_arch(arch).build_cfg(reduced=True)
    if task is not None:
        cfg = dataclasses.replace(cfg, task=task)
        jcfg = dataclasses.replace(jcfg, task=task)
    return cfg, jcfg


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def case(arch, kind):
    """(cfg, jcfg, numpy batch) of one case: tests/test_gnn_training.py's
    padded random graph (200 nodes, 400 edges, padded to 256 and 512), or
    8 molecules of 10 atoms and 20 bonds under graph_reg."""
    if kind == "molecules":
        cfg, jcfg = configs(arch, "graph_reg")
        return cfg, jcfg, graphs.molecule_batch(8, 10, 20, d_feat=cfg.d_in,
                                                seed=2)
    cfg, jcfg = configs(arch)
    src, dst = graphs.random_graph(200, 2.0, seed=3)
    return cfg, jcfg, graphs.build_graph_batch(
        200, src, dst, cfg.d_in, cfg.n_classes, seed=3, pad_nodes=256,
        pad_edges=512)


def same_params(jcfg, cfg, seed=0, norms=False, dtype=None):
    """JAX's init params (with ``norms``, the norm vectors drawn at
    random, so their gradients count) and the port's copy of them; with
    ``dtype`` float32, both in float32."""
    jp = jax_gnn.init_gnn_params(jax.random.PRNGKey(seed), jcfg)
    if norms:
        rng = np.random.default_rng(seed)
        for lp in jp["layers"]:
            for k in gnn.NORM_INIT:
                if k in lp:
                    lp[k] = jnp.asarray(rng.normal(size=lp[k].shape) * 0.5
                                        + gnn.NORM_INIT[k], jnp.float32)
    if dtype is not None:
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return jp, convert.gnn_params_from_numpy(
        jax.tree.map(np.asarray, jp), cfg)


# ---------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_param_shapes_and_dtypes_equal_jax(arch):
    for shape in GNN_SHAPES:
        for reduced in (False, True):
            cfg = get_arch(arch).build_cfg(reduced=reduced, shape=shape)
            jcfg = jax_get_arch(arch).build_cfg(reduced=reduced, shape=shape)
            for f in dataclasses.fields(cfg):
                if f.name != "dtype":
                    assert getattr(cfg, f.name) == getattr(jcfg, f.name)
    # the trees at the full width (molecule: graph_reg's out_dim of 1)
    # and at the reduced config
    for cfg, jcfg in ((get_arch(arch).build_cfg(shape="molecule"),
                       jax_get_arch(arch).build_cfg(shape="molecule")),
                      configs(arch)):
        like = jax.eval_shape(lambda: jax_gnn.init_gnn_params(
            jax.random.PRNGKey(0), jcfg))
        assert gnn.gnn_param_shapes(cfg) == jax.tree.map(
            lambda a: tuple(a.shape), like)
    p = gnn.init_gnn_params(torch.Generator().manual_seed(0), cfg)
    dtypes = [str(t.dtype).removeprefix("torch.") for t in tree_flatten(p)]
    assert dtypes == [str(a.dtype) for a in jax.tree.leaves(like)]
    want = jax_gnn.init_gnn_params(jax.random.PRNGKey(0), jcfg)
    for k, v in gnn.NORM_INIT.items():
        if k in p["layers"][0]:
            assert torch.equal(p["layers"][0][k], torch.full_like(
                p["layers"][0][k], v))
            assert np.all(np.asarray(want["layers"][0][k]) == v)


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_keeps_bf16_mlps_and_float32_norms(arch):
    cfg, jcfg = configs(arch)
    jp, p = same_params(jcfg, cfg, norms=True)
    for a, w in zip(tree_flatten(p), jax.tree.leaves(jp)):
        assert str(a.dtype).removeprefix("torch.") == str(w.dtype)
        assert torch.equal(a.float(), torch.from_numpy(
            np.array(w, np.float32)))
    # a cast takes the MLPs only: the norm vectors stay float32
    f32 = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    cast = convert.gnn_params_from_numpy(f32, cfg, dtype=torch.bfloat16)
    for k in gnn.NORM_INIT:
        if k in cast["layers"][0]:
            assert cast["layers"][0][k].dtype == torch.float32
    assert cast["dec"]["w0"].dtype == torch.bfloat16
    layer = dict(f32["layers"][0])
    mlp = sorted(k for k in layer if isinstance(layer[k], dict))[0]
    layer[mlp] = dict(layer[mlp], w0=np.zeros((3, 3), np.float32))
    bad = dict(f32, layers=[layer] + f32["layers"][1:])
    with pytest.raises(ValueError, match=f"layers\\[0\\].{mlp}.w0"):
        convert.gnn_params_from_numpy(bad, cfg)


def test_get_arch_raises_for_an_unported_arch_with_its_item(monkeypatch):
    """All ten archs are ported, so a stand-in keeps the registry's
    not-ported branch tested: it raises naming the family's item."""
    assert port_configs.ARCH_IDS == JAX_ARCH_IDS
    for arch in JAX_ARCH_IDS:
        assert get_arch(arch).arch_id == arch
    monkeypatch.delitem(port_configs.PORTED, "schnet")
    monkeypatch.setitem(port_configs.PENDING_ITEMS, "gnn",
                        "ROADMAP.md, queue 1, item 99z: a stand-in")
    with pytest.raises(NotImplementedError, match="item 99z"):
        get_arch("schnet")


# ---------------------------------------------------------------- layers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_equals_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(37, 70)).astype(np.float32) * 3 + 1
    g = rng.normal(size=70).astype(np.float32)
    b = rng.normal(size=70).astype(np.float32)
    want = np.asarray(jax_common.layer_norm(
        jnp.asarray(x, dtype), jnp.asarray(g), jnp.asarray(b)), np.float32)
    got = common.layer_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                            torch.from_numpy(g), torch.from_numpy(b))
    assert got.dtype == torch.float32
    # bf16: the normalised x rounds to bf16 before * gamma + beta in both
    tol = FWD_TOL if dtype == "float32" else dict(atol=1e-5,
                                                  rtol=2 ** -7)
    np.testing.assert_allclose(got.numpy(), want, **tol)


@pytest.mark.parametrize("n_rbf,cutoff", [(300, 10.0), (16, 10.0),
                                          (7, 3.3)])
def test_rbf_expand_equals_jax(n_rbf, cutoff):
    """The centres follow jnp.linspace's formula in float32; XLA on the
    CPU divides within one ulp of the correct rounding, so its centres
    differ from these by at most 2 ulp of the cutoff (1e-6 at 10)."""
    centres = gnn._linspace(0.0, cutoff, n_rbf, "cpu").numpy()
    want = np.asarray(jnp.linspace(0.0, cutoff, n_rbf))
    np.testing.assert_allclose(centres, want, rtol=0, atol=1e-6)
    assert centres[0] == 0.0 and centres[-1] == np.float32(cutoff)
    dist = np.random.default_rng(1).uniform(0, 2 * cutoff, 200).astype(
        np.float32)
    got = gnn._rbf_expand(torch.from_numpy(dist), n_rbf, cutoff)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_gnn._rbf_expand(
        jnp.asarray(dist), n_rbf, cutoff)), atol=1e-6, rtol=1e-5)


def agg_inputs(seed=0, N=50, E=400, D=6, ties=False):
    """Messages, destinations with padding edges at node 0, the edge
    mask, and a node with no edge."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(1, N - 1, E).astype(np.int32)
    mask = rng.random(E) < 0.8
    dst[~mask] = 0
    msgs = rng.normal(size=(E, D)).astype(np.float32)
    if ties:    # node 5: two edges share the largest value of column 0
        five = np.flatnonzero((dst == 5) & mask)
        msgs[five, 0] = -1.0
        msgs[five[:2], 0] = 4.0
    return msgs, dst, mask, N


@pytest.mark.parametrize("how", ["sum", "gated", "mean", "max"])
def test_segment_agg_modes_equal_jax(how):
    """Each mode on messages times the edge mask, as every caller has
    them, and its gradient with respect to the messages before the
    mask."""
    msgs, dst, mask, N = agg_inputs(ties=how == "max")
    edges = gnn.edge_index(torch.from_numpy(dst), torch.from_numpy(dst),
                           torch.from_numpy(mask), N)
    r = np.random.default_rng(2).normal(size=(N, msgs.shape[1])).astype(
        np.float32)
    emask = mask[:, None].astype(np.float32)

    def jax_fn(m):
        out = jax_gnn._segment_agg(m * emask, jnp.asarray(dst), N, how)
        return jnp.sum(jnp.where(jnp.isfinite(out), out, 0.0) * r), out

    (_, want), jgrad = jax.value_and_grad(jax_fn, has_aux=True)(
        jnp.asarray(msgs))
    m = torch.from_numpy(msgs).requires_grad_(True)
    out = gnn._segment_agg(m * torch.from_numpy(emask), edges, N, how)
    torch.sum(torch.where(torch.isfinite(out), out, 0.0)
              * torch.from_numpy(r)).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **GRAD_TOL)
    np.testing.assert_allclose(m.grad.numpy(), np.asarray(jgrad), **GRAD_TOL)
    if how == "max":
        assert np.isneginf(out.detach().numpy()[N - 1]).all()  # no edge
        five = np.flatnonzero((dst == 5) & mask)[:2]            # the tie
        assert np.allclose(m.grad.numpy()[five, 0], r[5, 0] / 2)


# ----------------------------------------------------------- segment sum

def test_segment_sum_equals_index_add_in_float64():
    rng = np.random.default_rng(4)
    E, N, D = 3000, 40, 5
    ids = rng.integers(-1, N, E).astype(np.int32)
    ids[rng.permutation(E)[:500]] = 3       # an id of 500+ edges: chunks
    msgs = torch.from_numpy(rng.normal(size=(E, D)))
    got = nops.segment_sum(msgs, torch.from_numpy(ids), N)
    keep = torch.from_numpy(ids >= 0)
    want = torch.zeros((N, D), dtype=torch.float64).index_add_(
        0, torch.from_numpy(ids)[keep].long(), msgs[keep])
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    # the chunk order is the plain backward's, bit for bit
    assert torch.equal(nops.segment_sum(msgs.float(), torch.from_numpy(ids),
                                        N),
                       nops.neighbor_agg_bwd_ref(
                           msgs.float(), torch.from_numpy(ids)[:, None], N,
                           mean=False))


def test_segment_sum_and_gather_rows_gradcheck():
    rng = np.random.default_rng(5)
    E, N, D = 40, 7, 2
    ids = torch.from_numpy(rng.integers(-1, N, E).astype(np.int32))
    rows = torch.from_numpy(rng.integers(0, N, E))
    skip = torch.where(ids >= 0, rows.to(torch.int32), -1)
    msgs = torch.from_numpy(rng.normal(size=(E, D))).requires_grad_(True)
    h = torch.from_numpy(rng.normal(size=(N, D))).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda m: nops.segment_sum(m, ids, N), (msgs,))
    assert torch.autograd.gradcheck(
        lambda x: nops.gather_rows(x, rows, rows.to(torch.int32)), (h,))
    # the skipped edges add nothing to the gradient
    g = torch.from_numpy(rng.normal(size=(E, D)))
    (grad,) = torch.autograd.grad(nops.gather_rows(h, rows, skip), h, g)
    keep = skip >= 0
    want = torch.zeros((N, D), dtype=torch.float64).index_add_(
        0, rows[keep], g[keep])
    torch.testing.assert_close(grad, want)


def test_segment_index_groups_edges_by_id_in_edge_order():
    ids = torch.tensor([2, -1, 0, 2, 2, -1, 0], dtype=torch.int32)
    index = nops.segment_index(ids, 4)
    assert index.rowptr.tolist() == [0, 2, 2, 5, 5]
    assert index.rows[:5].tolist() == [2, 6, 0, 3, 4]
    assert index.cnt.tolist() == [1, 0, 1, 1, 1, 0, 1]


def test_segment_sum_rejects_bad_inputs_and_never_launches_on_the_cpu():
    msgs = torch.zeros((4, 2))
    with pytest.raises(ValueError, match="int32"):
        nops.segment_sum(msgs, torch.zeros(4, dtype=torch.int64), 3)
    with pytest.raises(ValueError, match="rows for"):
        nops.segment_sum(msgs, torch.zeros(3, dtype=torch.int32), 3)
    with pytest.raises(ValueError, match="float32"):
        nops.segment_sum(msgs.bfloat16(), torch.zeros(4, dtype=torch.int32),
                         3)
    before = nops.segment_sum.launches
    nops.segment_sum(msgs, torch.zeros(4, dtype=torch.int32), 3)
    assert nops.segment_sum.launches == before


# ------------------------------------------------------------ the models

@pytest.mark.parametrize("arch,kind", CASES)
def test_forward_equals_jax(arch, kind):
    cfg, jcfg, b = case(arch, kind)
    jp, p = same_params(jcfg, cfg, norms=True)
    want = np.asarray(jax.jit(lambda q, bb: jax_gnn.gnn_forward(
        q, bb, jcfg))(jp, to_jax(b)))
    got = gnn.gnn_forward(p, to_torch(b), cfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, **FWD_TOL)


@pytest.mark.parametrize("arch,kind", CASES)
def test_loss_and_every_gradient_equal_jax(arch, kind):
    """float32 params: the loss and every gradient leaf (the norm
    vectors' too) within 1e-5 of jax.value_and_grad."""
    cfg, jcfg, b = case(arch, kind)
    jp, p = same_params(jcfg, cfg, seed=1, norms=True, dtype="float32")
    jl, jg = jax.jit(jax.value_and_grad(
        lambda q: jax_gnn.gnn_loss(q, to_jax(b), jcfg)))(jp)
    loss, g = value_and_grad(lambda q, bb: gnn.gnn_loss(q, bb, cfg), p,
                             to_torch(b))
    assert float(loss) == pytest.approx(float(jl), rel=1e-5, abs=1e-5)
    got, want = tree_flatten(g), jax.tree.leaves(jg)
    assert len(got) == len(want)
    for a, w in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **GRAD_TOL)


@pytest.mark.parametrize("arch,kind", [c for c in CASES
                                       if c != ("schnet", "graph")])
def test_four_adamw_steps_equal_jax(arch, kind):
    cfg, jcfg, b = case(arch, kind)
    jp, p = same_params(jcfg, cfg, seed=2)
    opt = dict(lr=3e-3, warmup_steps=2, total_steps=10, weight_decay=0.01)
    jo_cfg, o_cfg = JaxAdamWConfig(**opt), AdamWConfig(**opt)
    jo, o = jax_init_adamw(jp, jo_cfg), init_adamw(p, o_cfg)
    jb, tb = to_jax(b), to_torch(b)

    @jax.jit
    def jax_step(q, o):
        loss, g = jax.value_and_grad(
            lambda q_: jax_gnn.gnn_loss(q_, jb, jcfg))(q)
        q, o, _ = jax_adamw_update(g, o, q, jo_cfg)
        return q, o, loss

    want, got = [], []
    for _ in range(4):
        jp, jo, jl = jax_step(jp, jo)
        loss, g = value_and_grad(lambda q, bb: gnn.gnn_loss(q, bb, cfg), p,
                                 tb)
        p, o, _ = adamw_update(g, o, p, o_cfg)
        want.append(float(jl))
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert got[-1] < got[0]


def test_graph_reg_pools_only_valid_nodes_of_known_graphs():
    """Padding nodes (times nmask = 0 in JAX) and graph ids at or past G
    (which JAX's segment_sum drops) are left out of the pooling."""
    cfg, jcfg, b = case("schnet", "molecules")
    b = dict(b, node_mask=b["node_mask"].copy(), graph_id=b["graph_id"].copy())
    b["node_mask"][-7:] = False
    b["graph_id"][:10] = 8                  # past the 8 graphs
    jp, p = same_params(jcfg, cfg)
    want = float(jax.jit(lambda q, bb: jax_gnn.gnn_loss(q, bb, jcfg))(
        jp, to_jax(b)))
    assert float(gnn.gnn_loss(p, to_torch(b), cfg)) == pytest.approx(
        want, rel=2e-5, abs=2e-5)


# -------------------------------------------------------------- launcher

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


@pytest.mark.parametrize("argv", [
    ["--arch", "gatedgcn", "--reduced", "--steps", "2"],
    ["--arch", "meshgraphnet", "--reduced", "--steps", "2"],
    ["--arch", "schnet", "--shape", "molecule", "--steps", "2"]])
def test_launcher_losses_equal_jax_launcher(argv, tmp_path):
    """The launcher's params (every leaf drawn in JAX's flatten order, the
    norm vectors float32) and batches are the JAX launcher's; schnet runs
    at full width on the molecule shape, whose one graph_targets row
    pools every atom, as the JAX launcher builds it."""
    want = jax_launcher_losses(argv + ["--ckpt_dir", str(tmp_path / "j")])
    res = launch_train.main(argv + ["--device", "cpu", "--ckpt_dir",
                                    str(tmp_path / "t")])
    got = [m["loss"] for m in res.metrics_history]
    assert res.failures_recovered == 0 and len(got) == len(want)
    assert all(math.isfinite(v) for v in got)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
