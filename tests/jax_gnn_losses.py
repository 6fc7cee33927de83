"""Compute the JAX package's losses that chip_smoke.py pins.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/jax_gnn_losses.py \
        [--what {all,graphsage,archs,full_batch}] [--port] [--stats]

Runs, on the CPU, the JAX package on the inputs chip_smoke.py makes for
its GNN phases, from the same numpy seeds and by the same recipe
(chip_smoke's ``gnn_source``, ``gnn_sample``, ``gnn_numpy_params``,
``gnn_arch_cfg`` and ``gnn_arch_batch``, given the JAX package's
``repro.data.graphs`` and ``repro.configs.get_arch``):

  * ``GNN_JAX_LOSSES``: the first 3 losses of graphsage-reddit at full
    width on minibatch_lg (the reddit-scale source graph, one sampled
    batch a step, ``GNN_OPT``), through ``repro.models.gnn.gnn_loss`` and
    ``repro.train.optimizer.adamw_update``;
  * ``GNN_LAUNCHER_JAX_LOSSES``: the JAX train launcher's losses at
    ``--shape minibatch_lg --steps 5``;
  * ``GNN_ARCH_JAX_LOSSES``: the first 3 losses of gatedgcn and
    meshgraphnet at full width on the first sampled minibatch_lg batch
    (with chip_smoke's edge_x), and of schnet at full width on
    ``molecule_batch()``, each on its one batch (``GNN_OPT``; the MLPs
    cast to bfloat16 and the norm vectors kept float32, as JAX's
    ``init_gnn_params`` has them);
  * ``GNN_ARCH_LAUNCHER_JAX_LOSSES``: the JAX train launcher's losses of
    each of those three archs at its defaults for 3 steps;
  * ``GNN_FULL_BATCH_JAX_LOSSES`` (``--what full_batch`` only): the JAX
    train launcher's first ``GNN_FB_STEPS`` losses of graphsage-reddit at
    ogb_products (its config, its AdamW), its batch made by its own
    ``_gnn_batches`` at ``GNN_FB_PIN_NODES`` nodes and
    ``GNN_FB_PIN_EDGES`` edges (ogb_products' edges a node), where the
    padded in-neighbour matrix would hold 3.82e9 slots. About 10 GB of
    host memory and two minutes.

``--what`` picks graphsage's pins, the three archs', both (the default)
or the full-batch pins. With ``--stats`` it prints the shape of the first sampled
batch: its valid edges, K (the largest valid in-degree) and how many
slots of the in-neighbour matrix the busiest source id fills (the
backward kernel's longest row). With ``--port`` it also runs the port
(``repro_torch``) on the CPU on the same training inputs and prints its
losses beside JAX's (not the launcher's: there node 0's in-degree makes
K about 1,400, and the plain aggregation loops over K). Graphsage's
part needs about 4 GB of host memory and a few minutes (the 114.6M-edge
graph and its sampler); the archs' part about 17 GB at its peak
(meshgraphnet's saved activations) and a few minutes more.
It is a helper, not a test: pytest does not collect it.
"""
import argparse
import pathlib
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402

import repro.launch.train as jax_launch  # noqa: E402
from repro.configs import get_arch  # noqa: E402
from repro.data import graphs  # noqa: E402
from repro.models import gnn  # noqa: E402
from repro.train.optimizer import (AdamWConfig, adamw_update,  # noqa: E402
                                   init_adamw)

N_PINNED = 3


def batch_stats(b) -> dict:
    """Valid edges, K, and the slots each source id fills, of a batch."""
    src = b["edge_src"][b["edge_mask"]]
    dst = b["edge_dst"][b["edge_mask"]]
    per_id = np.bincount(src)
    return {"valid_edges": int(src.size),
            "K": int(np.bincount(dst).max()),
            "max_slots_one_id": int(per_id.max()),
            "ids_over_64_slots": int((per_id > 64).sum())}


def sampled_batches(stats: bool):
    """The first N_PINNED sampled minibatch_lg batches (GNN_KEYS only);
    the source graph and sampler are freed on return."""
    arch = get_arch(cs.GNN_ARCH)
    meta = arch.shapes[cs.GNN_SHAPE].meta
    src, dst, feats, labels = cs.gnn_source(meta, graphs)
    sampler = graphs.NeighborSampler(meta["graph_nodes"], src, dst)
    del src, dst
    batches = [{k: v for k, v in cs.gnn_sample(
        sampler, meta, feats, labels, i).items() if k in cs.GNN_KEYS}
        for i in range(N_PINNED)]
    if stats:
        print("first batch:", batch_stats(batches[0]))
    return batches


def jax_train(cfg, params, batches):
    """JAX's losses of one AdamW step (GNN_OPT) on each batch in turn."""
    opt_cfg = AdamWConfig(**cs.GNN_OPT)
    opt = init_adamw(params, opt_cfg)

    @jax.jit
    def step(p, o, b):
        loss, g = jax.value_and_grad(lambda q: gnn.gnn_loss(q, b, cfg))(p)
        p, o, _ = adamw_update(g, o, p, opt_cfg)
        return p, o, loss

    losses = []
    for b in batches:
        params, opt, loss = step(params, opt, {k: jnp.asarray(v)
                                               for k, v in b.items()})
        losses.append(float(loss))
    return losses


def port_train(name, shape, tree, batches):
    """The port's losses on the CPU on the same inputs."""
    import torch
    from repro_torch import convert
    from repro_torch.configs import get_arch as port_arch
    from repro_torch.models import gnn as port_gnn
    from repro_torch.train import optimizer as popt
    from repro_torch.train.train_loop import make_train_step
    pcfg = port_arch(name).build_cfg(shape=shape)
    p = convert.gnn_params_from_numpy(tree, pcfg, "cpu",
                                      dtype=torch.bfloat16)
    ocfg = popt.AdamWConfig(**cs.GNN_OPT)
    o = popt.init_adamw(p, ocfg)
    fn = make_train_step(lambda q, bb: port_gnn.gnn_loss(q, bb, pcfg), ocfg)
    losses = []
    for b in batches:
        p, o, m = fn(p, o, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses


def init_like(cfg):
    """JAX's init params of ``cfg``, abstract (shapes and dtypes)."""
    return jax.eval_shape(
        lambda: gnn.init_gnn_params(jax.random.PRNGKey(0), cfg))


def train_losses(batches, port: bool):
    cfg = get_arch(cs.GNN_ARCH).build_cfg(shape=cs.GNN_SHAPE)
    tree = cs.gnn_numpy_params(jax.tree.map(lambda a: tuple(a.shape),
                                            init_like(cfg)))
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    losses = jax_train(cfg, params, batches)
    port_losses = port_train(cs.GNN_ARCH, cs.GNN_SHAPE, tree,
                             batches) if port else None
    return losses, port_losses


def arch_losses(first, port: bool):
    """GNN_ARCH_JAX_LOSSES (and the port's on the CPU, with ``port``)."""
    out, port_out = {}, {}
    for name in cs.GNN_OTHER_ARCHS:
        cfg = cs.gnn_arch_cfg(get_arch, name)
        like = init_like(cfg)
        tree = cs.gnn_numpy_params(jax.tree.map(lambda a: tuple(a.shape),
                                                like))
        params = jax.tree.map(lambda a, s: jnp.asarray(a, s.dtype), tree,
                              like)
        batches = [cs.gnn_arch_batch(name, first, graphs)] * cs.GNN_ARCH_STEPS
        out[name] = jax_train(cfg, params, batches)
        print(name, out[name], flush=True)
        if port:
            port_out[name] = port_train(name, cs.GNN_ARCH_SHAPE[name], tree,
                                        batches)
            print(" port on the CPU:", port_out[name], flush=True)
    return out, port_out


def launcher_losses(argv):
    """The JAX train launcher's losses for ``argv`` in a fresh
    checkpoint directory."""
    seen = {}
    orig = jax_launch.run_training

    def spy(*a, **k):
        seen["res"] = orig(*a, **k)
        return seen["res"]

    jax_launch.run_training = spy
    try:
        with tempfile.TemporaryDirectory() as d:
            jax_launch.main(argv + ["--ckpt_dir", d])
    finally:
        jax_launch.run_training = orig
    return [m["loss"] for m in seen["res"].metrics_history]


def full_batch_losses(port: bool):
    """GNN_FULL_BATCH_JAX_LOSSES: the JAX launcher at ogb_products with
    its ``_gnn_batches`` reading a spec of GNN_FB_PIN_NODES nodes and
    GNN_FB_PIN_EDGES edges; with ``port``, the port's launcher on the
    CPU on the same batch (its ``gnn_batches`` at the same sizes)."""
    import types

    from repro.configs.gnn_common import gnn_batch_specs
    meta = dict(get_arch(cs.GNN_ARCH).shapes[cs.GNN_FB_SHAPE].meta,
                nodes=cs.GNN_FB_PIN_NODES, edges=cs.GNN_FB_PIN_EDGES)
    small = types.SimpleNamespace(args=(None, None, gnn_batch_specs(meta)))
    argv = ["--arch", cs.GNN_ARCH, "--shape", cs.GNN_FB_SHAPE, "--steps",
            str(cs.GNN_FB_STEPS)]
    orig = jax_launch._gnn_batches
    jax_launch._gnn_batches = lambda arch, plan, seed=0: orig(arch, small,
                                                              seed)
    try:
        losses = launcher_losses(argv)
    finally:
        jax_launch._gnn_batches = orig
    if not port:
        return losses, None
    from repro_torch.launch import train as port_launch
    porig = port_launch.gnn_batches

    def small_batches(arch, shape, reduced, device, seed=0):
        b = port_launch.graph_batch(meta["nodes"], meta["edges"],
                                    meta["d_feat"], device, seed)
        return lambda step: b

    port_launch.gnn_batches = small_batches
    try:
        with tempfile.TemporaryDirectory() as d:
            res = port_launch.main(argv + ["--ckpt_dir", d, "--device",
                                           "cpu"])
    finally:
        port_launch.gnn_batches = porig
    return losses, [m["loss"] for m in res.metrics_history]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--what", choices=("all", "graphsage", "archs",
                                       "full_batch"),
                    default="all", help="which pins to compute")
    ap.add_argument("--port", action="store_true",
                    help="also run the port on the CPU and print its losses")
    ap.add_argument("--stats", action="store_true",
                    help="print the first sampled batch's shape")
    args = ap.parse_args()
    if args.what == "full_batch":
        jl, pl = full_batch_losses(args.port)
        print("GNN_FULL_BATCH_JAX_LOSSES =", jl, flush=True)
        if pl is not None:
            print("port on the CPU:", pl, flush=True)
        return
    if args.what in ("all", "archs"):
        print("GNN_ARCH_LAUNCHER_JAX_LOSSES =", {
            name: launcher_losses(["--arch", name, "--steps",
                                   str(cs.GNN_ARCH_LAUNCHER_STEPS)])
            for name in cs.GNN_OTHER_ARCHS}, flush=True)
    if args.what in ("all", "graphsage"):
        print("GNN_LAUNCHER_JAX_LOSSES =", launcher_losses(
            ["--arch", cs.GNN_ARCH, "--shape", cs.GNN_SHAPE, "--steps",
             str(cs.GNN_LAUNCHER_STEPS)]), flush=True)
    batches = sampled_batches(args.stats)
    if args.what in ("all", "graphsage"):
        tj, tp = train_losses(batches, args.port)
        print("GNN_JAX_LOSSES =", tj, flush=True)
        if tp is not None:
            print("port on the CPU:", tp, flush=True)
    if args.what in ("all", "archs"):
        first = batches[0]
        del batches
        aj, ap_ = arch_losses(first, args.port)
        print("GNN_ARCH_JAX_LOSSES =", aj)
        if args.port:
            print("port on the CPU:", ap_)


if __name__ == "__main__":
    main()
