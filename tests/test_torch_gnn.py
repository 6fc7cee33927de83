"""The port's GraphSAGE (models/gnn.py), its data and configs against the
JAX package's.

The same batches (the copied generators and sampler give the same arrays)
and the same params (JAX's, carried over by ``convert``) go through
``repro.models.gnn`` and ``repro_torch.models.gnn`` on the CPU. Forward
and loss agree within atol/rtol 2e-5 in float32: the port aggregates
through the neighbour-aggregation plain version (a float32 sum in slot
order, then the product) where JAX takes ``segment_sum`` then the
product, so the two round at other places. Parameter gradients are
bfloat16 in both (JAX's cotangent of a bf16 param is its float32
gradient rounded): they agree within one bf16 step (rtol 2**-7) plus
atol 1e-6 for gradients near zero.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.data import graphs as jax_graphs
from repro.models import gnn as jax_gnn
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig
from repro.train.optimizer import adamw_update as jax_adamw_update
from repro.train.optimizer import init_adamw as jax_init_adamw
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.configs.gnn_common import GNN_SHAPES
from repro_torch.data import graphs
from repro_torch.models import gnn
from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_adamw
from repro_torch.train.train_loop import value_and_grad

TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(rtol=2 ** -7, atol=1e-6)


def configs(shape="full_graph_sm", reduced=True):
    return (get_arch("graphsage-reddit").build_cfg(reduced=reduced,
                                                   shape=shape),
            jax_get_arch("graphsage-reddit").build_cfg(reduced=reduced,
                                                       shape=shape))


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def same_params(jcfg, cfg, seed=0):
    """JAX's init params and the port's copy of them."""
    jp = jax_gnn.init_gnn_params(jax.random.PRNGKey(seed), jcfg)
    return jp, convert.gnn_params_from_numpy(
        jax.tree.map(np.asarray, jp), cfg)


def graph_batch(cfg, n=200, e=800, pad_nodes=256, pad_edges=1024, seed=3):
    """tests/test_gnn_training.py:20-23's batch: padding nodes and edges."""
    src, dst = graphs.random_graph(n, e / n, seed=seed)
    return graphs.build_graph_batch(n, src, dst, cfg.d_in, cfg.n_classes,
                                    seed=seed, pad_nodes=pad_nodes,
                                    pad_edges=pad_edges)


def sampled_batch(cfg, seed=0):
    """tests/test_gnn_training.py:47-73's sampled minibatch."""
    n = 1000
    src, dst = graphs.random_graph(n, 8.0, seed=5)
    rng = np.random.default_rng(seed)
    proto = rng.normal(size=(cfg.n_classes, cfg.d_in)).astype(np.float32)
    labels = rng.integers(0, cfg.n_classes, n).astype(np.int32)
    feats = (proto[labels] + rng.normal(size=(n, cfg.d_in)) * 0.3
             ).astype(np.float32)
    sampler = graphs.NeighborSampler(n, src, dst)
    seeds = rng.choice(n, 64, replace=False)
    return sampler.sample_padded(seeds, (5, 3), rng, max_nodes=1536,
                                 max_edges=2048, features=feats,
                                 labels=labels)


@pytest.mark.parametrize("kind", ["graph", "sampled"])
def test_forward_and_loss_equal_jax(kind):
    cfg, jcfg = configs()
    b = graph_batch(cfg) if kind == "graph" else sampled_batch(cfg)
    jp, p = same_params(jcfg, cfg)
    want = np.asarray(jax_gnn.gnn_forward(jp, to_jax(b), jcfg))
    got = gnn.gnn_forward(p, to_torch(b), cfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    jl = float(jax_gnn.gnn_loss(jp, to_jax(b), jcfg))
    assert float(gnn.gnn_loss(p, to_torch(b), cfg)) == pytest.approx(
        jl, rel=2e-5, abs=2e-5)


@pytest.mark.parametrize("kind", ["graph", "sampled"])
def test_bf16_gradients_equal_jax_within_one_step(kind):
    cfg, jcfg = configs()
    b = graph_batch(cfg) if kind == "graph" else sampled_batch(cfg)
    jp, p = same_params(jcfg, cfg, seed=1)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda q: jax_gnn.gnn_loss(q, to_jax(b), jcfg)))(jp)
    loss, g = value_and_grad(lambda q, bb: gnn.gnn_loss(q, bb, cfg), p,
                             to_torch(b))
    assert float(loss) == pytest.approx(float(jl), rel=2e-5, abs=2e-5)
    want = jax.tree.leaves(jax.tree.map(
        lambda a: np.asarray(a, np.float32), jg))
    from repro_torch.train.tree import tree_flatten
    got = tree_flatten(g)
    assert len(got) == len(want) == 14
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), w, **GRAD_TOL)


def test_padding_edges_count_in_node_zero_denominator():
    """Reference behaviour, kept: JAX's mean divides node 0's sum by its
    valid plus padding in-edges (padding edges point at node 0 with zero
    messages). The port scales the kernel's mean, which counts valid
    slots only, by max(valid, 1) / max(all, 1): node 0's output equals
    JAX's, and differs from an unscaled mean."""
    cfg, jcfg = configs()
    b = graph_batch(cfg, pad_edges=1024)
    n_pad = int((~b["edge_mask"]).sum())
    assert n_pad > 200 and (b["edge_dst"][~b["edge_mask"]] == 0).all()
    tb = to_torch(b)
    _, _, scale, _, _ = gnn.in_neighbors_csr(
        tb["edge_src"], tb["edge_dst"], tb["edge_mask"], 256)
    valid0 = int(((b["edge_dst"] == 0) & b["edge_mask"]).sum())
    assert float(scale[0]) == pytest.approx(max(valid0, 1)
                                            / (valid0 + n_pad))
    assert (scale[1:] == 1).all()
    jp, p = same_params(jcfg, cfg)
    want = np.asarray(jax_gnn.gnn_forward(jp, to_jax(b), jcfg))
    got = gnn.gnn_forward(p, tb, cfg).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # without the scale node 0 (a node the loss counts) would differ
    orig = gnn.in_neighbors_csr
    try:
        gnn.in_neighbors_csr = lambda *a: (*orig(*a)[:2], torch.ones(256),
                                           *orig(*a)[3:])
        unscaled = gnn.gnn_forward(p, tb, cfg).detach().numpy()
    finally:
        gnn.in_neighbors_csr = orig
    assert np.abs(unscaled[0] - want[0]).max() > 1e-3


def test_in_neighbors_keeps_edge_order_and_duplicates():
    src = torch.tensor([5, 1, 2, 1, 3, 4, 0], dtype=torch.int32)
    dst = torch.tensor([2, 0, 2, 2, 0, 1, 0], dtype=torch.int32)
    mask = torch.tensor([True, True, True, True, False, True, False])
    nbrs, scale, index = gnn.in_neighbors(src, dst, mask, 6)
    assert nbrs.tolist() == [[1, -1, -1], [4, -1, -1], [5, 2, 1],
                             [-1, -1, -1], [-1, -1, -1], [-1, -1, -1]]
    assert nbrs.dtype == torch.int32
    assert scale.tolist() == pytest.approx([1 / 3, 1, 1, 1, 1, 1])
    # slots by source: 1 <- (0, 0), (2, 2); 2 <- (2, 1); 4 <- (1, 0);
    # 5 <- (2, 0)
    assert index.cnt.tolist() == [1, 1, 3, 0, 0, 0]
    assert index.rowptr.tolist() == [0, 0, 2, 3, 3, 4, 5]
    assert index.rows[:5].tolist() == [0, 2, 2, 1, 2]


@pytest.mark.parametrize("kind", ["graph", "sampled", "hubs"])
def test_in_neighbors_index_equals_transpose_index(kind):
    """The backward's index that in_neighbors builds from its edges (no
    sync) equals the one ``transpose_index`` builds from the matrix, on
    batches with padding edges, the chunk units of the ids with more than
    CHUNK slots included (a power-law batch has such hubs)."""
    from repro_torch.kernels.neighbor_agg.ops import transpose_index
    cfg, _ = configs()
    if kind == "hubs":
        b = graph_batch(cfg, n=3000, e=18000, pad_nodes=3072,
                        pad_edges=20480, seed=2)
    else:
        b = graph_batch(cfg) if kind == "graph" else sampled_batch(cfg)
    tb = to_torch(b)
    n = tb["nodes"].shape[0]
    nbrs, _, index = gnn.in_neighbors(tb["edge_src"], tb["edge_dst"],
                                      tb["edge_mask"], n)
    want = transpose_index(nbrs, n)
    assert torch.equal(index.cnt, want.cnt)
    assert torch.equal(index.rowptr, want.rowptr)
    assert torch.equal(index.rows[:int(index.rowptr[-1])], want.rows)
    assert torch.equal(index.hptr, want.hptr)
    units = int(index.hptr[-1])
    assert torch.equal(index.hunit[:units], want.hunit[:units])
    assert units <= min(index.hunit.numel(), want.hunit.numel())
    if kind == "hubs":
        assert units > 0
    assert index.cnt.dtype == torch.int32 and index.rows.dtype == torch.int32
    assert index.hptr.dtype == torch.int64
    assert index.hunit.dtype == torch.int32


def test_in_neighbors_past_2_31_slots_raises(monkeypatch):
    """Row 5's padded matrix still has its limit, and raises naming row
    5d; GraphSAGE does not build it: with the limit so low that any
    padded matrix of the batch would raise, the model runs through row 5d
    and equals JAX."""
    monkeypatch.setattr(gnn, "MAX_SLOTS", 12)
    src = torch.tensor([1, 2, 3, 0], dtype=torch.int32)
    dst = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="row 5d"):
        gnn.in_neighbors(src, dst, torch.ones(4, dtype=torch.bool), 4)
    cfg, jcfg = configs()
    b = graph_batch(cfg)
    tb = to_torch(b)
    with pytest.raises(ValueError, match="past 2\\*\\*31"):
        gnn.in_neighbors(tb["edge_src"], tb["edge_dst"], tb["edge_mask"],
                         256)
    jp, p = same_params(jcfg, cfg)
    want = np.asarray(jax_gnn.gnn_forward(jp, to_jax(b), jcfg))
    np.testing.assert_allclose(
        gnn.gnn_forward(p, tb, cfg).detach().numpy(), want, **TOL)


def numpy_csr(b, n):
    """The in-neighbour CSR by a numpy stable argsort by destination."""
    valid = b["edge_mask"]
    key = np.where(valid, b["edge_dst"].astype(np.int64), n)
    order = np.argsort(key, kind="stable")
    counts = np.bincount(b["edge_dst"][valid], minlength=n)
    return (np.concatenate([[0], np.cumsum(counts)]),
            b["edge_src"][order][:int(valid.sum())])


@pytest.mark.parametrize("kind", ["graph", "sampled", "hubs"])
def test_in_neighbors_csr_equals_a_numpy_stable_argsort(kind):
    """The CSR (duplicates kept, each node's edges in edge order, the
    invalid ones past indptr[N]) equals numpy's stable argsort by
    destination, its backward index equals ``transpose_index`` of the
    padded matrix of the same rows, and its forward chunk units are
    ceil(count / 32) for each row past 32 slots."""
    from repro_torch.kernels.neighbor_agg.ops import transpose_index
    cfg, _ = configs()
    if kind == "hubs":
        b = graph_batch(cfg, n=3000, e=18000, pad_nodes=3072,
                        pad_edges=20480, seed=2)
    else:
        b = graph_batch(cfg) if kind == "graph" else sampled_batch(cfg)
    tb = to_torch(b)
    n = tb["nodes"].shape[0]
    indptr, indices, scale, fwd, index = gnn.in_neighbors_csr(
        tb["edge_src"], tb["edge_dst"], tb["edge_mask"], n)
    want_ptr, want_idx = numpy_csr(b, n)
    assert indptr.dtype == torch.int64 and indices.dtype == torch.int32
    assert indices.shape == tb["edge_src"].shape
    assert np.array_equal(indptr.numpy(), want_ptr)
    assert np.array_equal(indices[:want_idx.size].numpy(), want_idx)
    nbrs, pscale, pindex = gnn.in_neighbors(tb["edge_src"], tb["edge_dst"],
                                            tb["edge_mask"], n)
    assert torch.equal(scale, pscale)
    want = transpose_index(nbrs, n)
    for got in (index, pindex):
        assert torch.equal(got.cnt, want.cnt)
        assert torch.equal(got.rowptr, want.rowptr)
        assert torch.equal(got.rows[:int(got.rowptr[-1])], want.rows)
        assert torch.equal(got.hptr, want.hptr)
        units = int(got.hptr[-1])
        assert torch.equal(got.hunit[:units], want.hunit[:units])
    # the forward's chunk units: ceil(count / 32) for each row past 32
    cnt = np.diff(want_ptr)
    long = cnt > 32
    assert int(fwd[0][-1]) == int(((cnt[long] + 31) // 32).sum())
    assert np.array_equal(np.diff(fwd[0].numpy()),
                          np.where(long, (cnt + 31) // 32, 0))
    if kind == "hubs":
        assert int((indptr[1:] - indptr[:-1]).max()) > 32


def test_hub_graph_loss_and_gradients_equal_jax():
    """GraphSAGE on ``random_graph(4096, 25.25)``, whose busiest rows pass
    32 slots (so row 5d sums them in chunks): the loss and every
    gradient equal ``jax.value_and_grad`` of JAX's ``gnn_loss`` within
    2e-5, in float32 params (so the gradients are float32 too)."""
    cfg, jcfg = configs()
    src, dst = graphs.random_graph(4096, 25.25, seed=0)
    b = graphs.build_graph_batch(4096, src, dst, cfg.d_in, cfg.n_classes,
                                 seed=0, pad_nodes=4096,
                                 pad_edges=src.size + 512)
    assert np.bincount(dst).max() > 32
    jp, _ = same_params(jcfg, cfg, seed=4)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    p = convert.gnn_params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                      dtype=torch.float32)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda q: jax_gnn.gnn_loss(q, to_jax(b), jcfg)))(jp)
    loss, g = value_and_grad(lambda q, bb: gnn.gnn_loss(q, bb, cfg), p,
                             to_torch(b))
    assert float(loss) == pytest.approx(float(jl), rel=2e-5, abs=2e-5)
    from repro_torch.train.tree import tree_flatten
    got, want = tree_flatten(g), jax.tree.leaves(jg)
    assert len(got) == len(want) == 14
    for a, w in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("task,shape", [("node_reg", "full_graph_sm"),
                                        ("graph_reg", "molecule")])
def test_other_tasks_equal_jax(task, shape):
    cfg, jcfg = configs()
    cfg = dataclasses.replace(cfg, task=task)
    jcfg = dataclasses.replace(jcfg, task=task)
    b = graphs.molecule_batch(8, 10, 20, d_feat=cfg.d_in, seed=2) \
        if task == "graph_reg" else graph_batch(cfg)
    jp, p = same_params(jcfg, cfg)
    jl = float(jax_gnn.gnn_loss(jp, to_jax(b), jcfg))
    assert float(gnn.gnn_loss(p, to_torch(b), cfg)) == pytest.approx(
        jl, rel=2e-5, abs=2e-5)


def test_five_adamw_steps_equal_jax():
    cfg, jcfg = configs()
    b = sampled_batch(cfg)
    jp, p = same_params(jcfg, cfg, seed=2)
    jo_cfg = JaxAdamWConfig(lr=3e-3, warmup_steps=2, total_steps=10,
                            weight_decay=0.01)
    o_cfg = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=10,
                        weight_decay=0.01)
    jo, o = jax_init_adamw(jp, jo_cfg), init_adamw(p, o_cfg)
    jb, tb = to_jax(b), to_torch(b)

    @jax.jit
    def jax_step(q, o):
        loss, g = jax.value_and_grad(
            lambda q_: jax_gnn.gnn_loss(q_, jb, jcfg))(q)
        q, o, _ = jax_adamw_update(g, o, q, jo_cfg)
        return q, o, loss

    want, got = [], []
    for _ in range(5):
        jp, jo, jl = jax_step(jp, jo)
        loss, g = value_and_grad(lambda q, bb: gnn.gnn_loss(q, bb, cfg), p,
                                 tb)
        p, o, _ = adamw_update(g, o, p, o_cfg)
        want.append(float(jl))
        got.append(float(loss))
    # a gradient a float32 rounding apart can round a bf16 param to its
    # neighbouring value; that moves the loss in its fifth digit at most
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert got[-1] < got[0]


def test_sampler_batches_equal_jax_array_for_array():
    for n, deg, fan, seed in ((1000, 8.0, (5, 3), 0), (300, 3.0, (4,), 1),
                              (500, 6.0, (15, 10), 2)):
        jsrc, jdst = jax_graphs.random_graph(n, deg, seed=seed)
        src, dst = graphs.random_graph(n, deg, seed=seed)
        assert np.array_equal(src, jsrc) and np.array_equal(dst, jdst)
        js = jax_graphs.NeighborSampler(n, jsrc, jdst)
        s = graphs.NeighborSampler(n, src, dst)
        assert np.array_equal(s.indptr, js.indptr)
        assert np.array_equal(s.in_src, js.in_src)
        rng = np.random.default_rng(seed)
        feats = rng.normal(size=(n, 8)).astype(np.float32)
        labels = rng.integers(0, 5, n).astype(np.int32)
        jr, r = np.random.default_rng(seed + 7), np.random.default_rng(
            seed + 7)
        for _ in range(2):
            seeds = r.choice(n, 32, replace=False)
            jr.choice(n, 32, replace=False)
            jb = js.sample_padded(seeds, fan, jr, max_nodes=1024,
                                  max_edges=2048, features=feats,
                                  labels=labels)
            b = s.sample_padded(seeds, fan, r, max_nodes=1024,
                                max_edges=2048, features=feats,
                                labels=labels)
            assert sorted(b) == sorted(jb)
            for k in b:
                assert b[k].dtype == jb[k].dtype, k
                assert np.array_equal(b[k], jb[k]), k


def test_graph_builders_equal_jax():
    src, dst = graphs.random_graph(300, 4.0, seed=9, power_law=False)
    jsrc, jdst = jax_graphs.random_graph(300, 4.0, seed=9, power_law=False)
    assert np.array_equal(src, jsrc) and np.array_equal(dst, jdst)
    for got, want in (
            (graphs.build_graph_batch(300, src, dst, 12, 4, seed=1,
                                      n_graphs=3, pad_nodes=320,
                                      pad_edges=1300),
             jax_graphs.build_graph_batch(300, jsrc, jdst, 12, 4, seed=1,
                                          n_graphs=3, pad_nodes=320,
                                          pad_edges=1300)),
            (graphs.molecule_batch(4, 6, 9, seed=3),
             jax_graphs.molecule_batch(4, 6, 9, seed=3))):
        assert sorted(got) == sorted(want)
        for k in got:
            assert np.array_equal(got[k], want[k]), k


def test_configs_and_param_shapes_equal_jax():
    for shape in GNN_SHAPES:
        for reduced in (False, True):
            cfg, jcfg = configs(shape, reduced)
            for f in dataclasses.fields(cfg):
                if f.name != "dtype":
                    assert getattr(cfg, f.name) == getattr(jcfg, f.name)
            specs = get_arch("graphsage-reddit").input_specs(shape, reduced)
            jspecs = jax_get_arch("graphsage-reddit").input_specs(shape,
                                                                  reduced)
            assert {k: v[0] for k, v in specs.items()} == {
                k: tuple(v.shape) for k, v in jspecs.items()}
            shapes = jax.tree.map(lambda a: tuple(a.shape), jax.eval_shape(
                lambda: jax_gnn.init_gnn_params(jax.random.PRNGKey(0),
                                                jcfg)))
            assert gnn.gnn_param_shapes(cfg) == shapes
    mb = GNN_SHAPES["minibatch_lg"].meta
    # the padded sizes the sampled batch uses (round_up of the counts)
    assert (mb["nodes"], mb["edges"]) == (169_984, 168_960)


def test_init_draws_bf16_params_of_the_jax_shapes():
    cfg, jcfg = configs(reduced=False, shape="minibatch_lg")
    p = gnn.init_gnn_params(torch.Generator().manual_seed(0), cfg)
    jp = jax.eval_shape(lambda: jax_gnn.init_gnn_params(
        jax.random.PRNGKey(0), jcfg))
    from repro_torch.train.tree import tree_flatten
    leaves, jleaves = tree_flatten(p), jax.tree.leaves(jp)
    assert [tuple(t.shape) for t in leaves] == [j.shape for j in jleaves]
    assert all(t.dtype == torch.bfloat16 for t in leaves)
    assert sum(t.numel() for t in leaves) == 165_033


def test_convert_checks_names_shapes_and_dtypes():
    cfg, jcfg = configs()
    jp, p = same_params(jcfg, cfg)
    # bf16 carried bit for bit
    assert torch.equal(p["dec"]["w0"].float(), torch.from_numpy(
        np.asarray(jp["dec"]["w0"], np.float32)))
    tree = jax.tree.map(np.asarray, jp)
    bad = dict(tree, enc_node={"w0": tree["enc_node"]["w0"]})
    with pytest.raises(ValueError, match="enc_node"):
        convert.gnn_params_from_numpy(bad, cfg)
    bad = dict(tree, dec=dict(tree["dec"], w1=np.zeros((3, 3), np.float32)))
    with pytest.raises(ValueError, match="shape"):
        convert.gnn_params_from_numpy(bad, cfg)
    bad = dict(tree, dec=dict(tree["dec"], b1=np.zeros(5, np.int32)))
    with pytest.raises(ValueError, match="int32"):
        convert.gnn_params_from_numpy(bad, cfg)
    f32 = convert.gnn_params_from_numpy(tree, cfg, dtype=torch.float32)
    assert f32["layers"][1]["w_nbr"]["w0"].dtype == torch.float32


@pytest.mark.parametrize("arch", ["gatedgcn", "meshgraphnet", "schnet"])
def test_other_gnn_archs_build_and_run(arch):
    """The other archs, which raised until their layers were ported (item
    15g), now run: get_arch returns the port's config, init_gnn_params
    draws its tree, and gnn_forward gives finite per-node outputs
    (tests/test_torch_gnn_archs.py holds them to JAX's)."""
    arch_def = get_arch(arch)
    assert arch_def.arch_id == arch and arch_def.family == "gnn"
    cfg = arch_def.build_cfg(reduced=True)
    p = gnn.init_gnn_params(torch.Generator().manual_seed(0), cfg)
    src, dst = graphs.random_graph(100, 2.0, seed=1)
    b = graphs.build_graph_batch(100, src, dst, cfg.d_in, cfg.n_classes,
                                 seed=1, pad_nodes=128, pad_edges=256)
    out = gnn.gnn_forward(p, to_torch(b), cfg)
    assert out.shape == (128, cfg.n_classes)
    assert bool(torch.isfinite(out).all())
