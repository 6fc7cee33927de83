#!/usr/bin/env python3
"""Time the scoring, refinement-screen, neighbour-aggregation and
flash-attention kernels of one source tree on one CUDA card, so that two
commits can be compared on one card.

    python3 kernel_ab.py [--tree DIR] [--label NAME] [--flash-only]
                         [--stream-only] [--recsys-vocab ROWS]
                         [--gnn-only [--gnn-batch FILE]]
                         [--rows-only [--rows-cache DIR] [--rows LIST]]
                         [--variants --rows-cache DIR]

``--tree`` is the root of a checkout of this repository (default: the
one holding this script); its ``src/repro_torch`` is imported, and its
kernels are built into its own ``build/torch_ext``. Run one process per
tree, in turns (A, B, B, A), inside one machine: both trees' extensions
share a module name, so they cannot live in one process.

Measures, each on inputs made from fixed seeds:
  * ``hype_score_select`` at the superstep path's shape (G = 32 phases,
    R = 16 rows, s = 1, P = 64, select_k = 16) at L = 32, 128, 512 and
    2048 (the main one), eagerly and in a CUDA graph, beside the launch
    floor below;
  * ``hype_scores`` at the batched engine's shapes (B in {64, 256}, L in
    {32, 128, 512, 2048}, s = 16), timed eagerly (host launch included,
    as the engine calls it) and in a CUDA graph (the device alone), beside
    a one-element ``add_`` timed the same two ways (the launch floor);
  * the ``kway_gains`` tile kernel at B = 4,096, L = 2,048, k = 32, on
    ``chip_smoke.py``'s synthetic tile and its path-like one (ragged rows,
    about 96% trailing pads), and at k = 67 on the synthetic one, eagerly
    and in a CUDA graph;
  * the refinement screen, ``core.scoring.refine_gains_device`` whole
    (the delta, then the gains), at the quality path's first screen
    (github_like(1.0, seed=0), k = 32, t = 16, preset "quality": the
    supersteps' assignment and the first 4,096 boundary ids, taken from
    the tree's own run), eagerly and in a CUDA graph, and that path's
    wall time in two more runs (host clock, ending in a synchronise);
  * the ``neighbor_agg`` forward (the kernel alone, float32 x with unit
    rows, bfloat16 w, D = F = 128, the float32 mean kept, as the GNN step
    calls it) at the GraphSAGE layer shape (the first sampled batch of
    ``chip_smoke.py``'s gnn_train: 169,984 nodes, K = 25, about 148k
    valid slots) and on the train launcher's batch (``random_graph`` over
    169,984 nodes, K = 1,340 from one hub, nearly all slots pads);
  * ``neighbor_agg_bwd`` (the kernel alone, its index built once, D =
    128, float32) at the same two batches (a hub of 1,056 slots at the
    layer, 1,386 on the launcher's batch) and on a synthetic hub of
    100,000 slots;
  * ``flash_attention`` at qwen3-8b's layer (B = 8, S = 4,096, 32/8
    heads of 128, bf16, causal), without and, where the tree's wrapper
    has ``return_lse``, with the logsumexp; and ``flash_attention_bwd``
    at the LM training shape (B = 2, S = 4,096, 32 heads of 80) and at
    qwen3-8b's layer, fed the forward's logsumexp where the tree's
    backward takes one, eagerly and in a CUDA graph (one call).
  * ``stream_commit`` (k = 32, mb = 64, 16 bits) and the stream pass:
    ``hype_stream`` on github_like(1.0, seed=0) at k = 32 with
    ``StreamParams(seed=0)``, once to keep the commit arguments of its
    first micro-batch of each tile width (Le = 32, 128, 512) and of its
    middle one, and to count on the host every micro-batch's tile width,
    pins and dependent rows (a bucket that another pin of the
    micro-batch holds too), then twice more for the pass's wall (host
    clock, ending in a synchronise); then ``chip_smoke.commit_timings``
    (each launch on its own copy of the state) on those: each
    kept micro-batch at its own width eagerly and in a CUDA graph, the
    middle one widened to Le = 2,048 (eagerly, in a graph, and its plain
    version), its first 1, 16 and 64 rows in a graph (the per-row slope),
    the all-pad chain, 64 valid rows with no pin and a dense tile, each
    with the branch of ``stream_commit.cu`` it takes (where the tree's
    extension reports one).
``--flash-only`` measures the flash kernels alone, ``--stream-only``
``stream_commit`` and the stream pass alone. ``--recsys-vocab ROWS``
measures no kernel: it runs ``chip_smoke.py``'s recsys_train phase with
each vocabulary at ROWS and prints its row (the peak memory), or, where
the allocator refuses, the peak and the reserved memory before it, to
size that phase's vocabulary cut. ``--gnn-only`` measures the sampled
GraphSAGE path alone, as the tree's model runs it, on the first sampled
batch of ``chip_smoke.py``'s gnn_train (169,984 padded nodes, 168,960
edges): the in-neighbour structure's build, one layer's aggregation
(float32 x with unit rows, bfloat16 w of D = F = 128 that asks for its
gradient, the structure built once) eagerly and in a CUDA graph, and
graphsage-reddit's train step (``GNN_OPT``, TF32 off) on that batch, 10
steps after 2 warm-ups, by the host clock with a synchronise on either
side (gnn_train's ``device_ms``) and by CUDA events, then one step
under ``chip_smoke.phase_profile`` (its device launches and busy time). ``--gnn-batch FILE`` keeps
that batch (an ``.npz``, built from ``chip_smoke.gnn_source`` when the
file is missing), so that the trees' runs skip the host's 40 s build.
``--rows-only`` measures the chunk-sum kernels alone, each at its main
path's shape, eagerly and in a CUDA graph: row 5d (``neighbor_agg_csr``,
float32 x with unit rows, bfloat16 w of D = F = 128, the chunk units
built ahead, as the model's layers call it) at the ogb_products layer
(the full-batch launcher's batch: 2,449,408 rows, 61.9M slots) and at
the minibatch_lg layer (gnn_train's first sampled batch); row 4b
(``neighbor_agg_bwd`` on the table's index, the kernel alone) at the
two-tower training shape (the user tower's 262,144 bags of 8 from
``RecsysStream`` at V = 2,097,152, D = 256, mean), and its light ids and
empty rows alone (the index's unit list emptied); row 5b (the backward
over ``csr_transpose_index``, D = 128) at both layers; row 5c
(``segment_sum`` by dst, the masked edges skipped, the index built
ahead) at meshgraphnet's (D = 128) and gatedgcn's (D = 70) layer, and by
src at D = 70 (the gradient of h[src], whose ids pass 32 edges), beside
row 5b's kernel in its sum mode on the same inputs with its unit list,
without it (no ticket memset, no heavy blocks) and at D = 72 (its
16-byte route); row 3b at the quality path's first screen (as the
default run takes it): ``refine_gains_device`` whole and
``kway_gains_csr`` alone, then the kernel alone at tile_l = 32, with
every candidate a pad, at k = 1 and 67, with only the rows of at most 32
neighbours, and the launch floor; row 3 (the ``kway_gains`` tile) as the
default run times it; and, where the tree's kernels have the names, each
launch's share by ``chip_smoke.kernel_split``. ``--rows LIST`` times
only the rows named (a comma-separated subset of 5d,5b,4b,5c,3b,3; the
ogb_products batch is built only for 5d and 5b).
``--rows-cache DIR`` keeps both batches' CSRs, the sampled batch and the
screen's arguments there, so that the next tree's run skips the host's
builds and the quality run. ``--variants`` (after a ``--rows-only`` run
with the same ``--rows-cache``, which keeps the screen's arguments)
builds row 5c's kernel once per entry of SEGMENT_VARIANTS and row 3b's
once per entry of SCREEN_VARIANTS (the committed source with one text
change each: blocks an SM, ids a warp, rows in flight; rows and warps a
block, lane-loads in flight, L2 gathers) with nvcc into
``build/variants``, loads each with ctypes, and times it eagerly and in a CUDA graph (row 5c at gatedgcn's
and meshgraphnet's layers; row 3b alone and with the delta at the first
screen), each output held bit-equal to the tree's wrapper, beside each
build's registers and spills.
Prints one JSON line per
measurement, then the card's name and power limit. Exits 1 without a
CUDA device.
"""
from __future__ import annotations

import argparse
import inspect
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(HERE))
    ap.add_argument("--label", default=None)
    ap.add_argument("--flash-only", action="store_true")
    ap.add_argument("--stream-only", action="store_true")
    ap.add_argument("--recsys-vocab", type=int, default=None)
    ap.add_argument("--gnn-only", action="store_true")
    ap.add_argument("--gnn-batch", default=None)
    ap.add_argument("--rows-only", action="store_true")
    ap.add_argument("--rows-cache", default=None)
    ap.add_argument("--rows", default="5d,5b,4b,5c,3b,3")
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    from chip_smoke import (CaptureCommits, FirstScreen, card_line,
                            commit_timings, cuda_ms, gnn_sample, graph_ms,
                            kernel_inputs, kway_tile, layer_x_w)
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.core import hype_stream, scoring
    from repro_torch.data import graphs, synthetic
    from repro_torch.kernels._build import load_extension
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.hype_score import ops, ref
    from repro_torch.kernels.neighbor_agg import ops as nops
    from repro_torch.models.gnn import in_neighbors
    from repro_torch.partition_api import partition

    label = args.label or tree.name
    ext = load_extension()

    def emit(row):
        print(json.dumps({"tree": label, **row}), flush=True)

    if args.recsys_vocab:
        recsys_vocab(emit, args.recsys_vocab)
        print(card_line(), flush=True)
        return 0
    if args.gnn_only:
        sampled_gnn(emit, args.gnn_batch, cuda_ms, graph_ms)
        print(card_line(), flush=True)
        return 0
    if args.rows_only:
        chunk_rows(emit, args.rows_cache, args.rows.split(","))
        print(card_line(), flush=True)
        return 0
    if args.variants:
        variants(emit, args.rows_cache, args.rows.split(","))
        print(card_line(), flush=True)
        return 0
    if args.stream_only:
        stream(emit, synthetic.github_like(1.0, seed=0), hype_stream,
               scoring, ops, ref, ext, CaptureCommits, commit_timings)
        print(card_line(), flush=True)
        return 0
    flash(emit, fops, cuda_ms, graph_ms)
    if args.flash_only:
        print(card_line(), flush=True)
        return 0

    one = torch.zeros(1, device="cuda")
    emit({"kernel": "launch_floor", "ms": cuda_ms(lambda: one.add_(1.0)),
          "graph_ms": graph_ms(lambda: one.add_(1.0))})
    rng = np.random.default_rng(0)
    for L in (32, 128, 512, 2048):
        x = kernel_inputs(rng, 32, 16, L, 1, 64, "random")
        emit({"kernel": "hype_score_select", "G": 32, "R": 16, "L": L,
              "s": 1, "P": 64, "select_k": 16,
              "ms": cuda_ms(lambda: ops.hype_score_select(*x, select_k=16)),
              "graph_ms": graph_ms(
                  lambda: ops.hype_score_select(*x, select_k=16))})
    rng = np.random.default_rng(1)
    for B in (64, 256):
        for L in (32, 128, 512, 2048):
            nbrs = rng.integers(0, 2 * L, size=(B, L)).astype(np.int32)
            nbrs[rng.random((B, L)) < 0.4] = -1
            fringe = rng.choice(nbrs[nbrs >= 0], size=16).astype(np.int32)
            x = [torch.from_numpy(a).cuda() for a in (nbrs, fringe)]
            emit({"kernel": "hype_scores", "B": B, "L": L, "s": 16,
                  "ms": cuda_ms(lambda: ops.hype_scores(*x)),
                  "graph_ms": graph_ms(lambda: ops.hype_scores(*x))})

    krng = np.random.default_rng(2)
    for kind, k in (("synthetic", 32), ("path", 32), ("synthetic", 67)):
        x = [torch.from_numpy(a).cuda()
             for a in kway_tile(krng, 4096, 2048, k, kind)]
        emit({"kernel": "kway_gains", "B": 4096, "L": 2048, "k": k,
              "inputs": kind, "ms": cuda_ms(lambda: ext.kway_gains(*x, k)),
              "graph_ms": graph_ms(lambda: ext.kway_gains(*x, k))})
    hg = synthetic.github_like(1.0, seed=0)
    stream(emit, hg, hype_stream, scoring, ops, ref, ext, CaptureCommits,
           commit_timings)

    def quality():
        partition(hg, 32, "hype_superstep", device="cuda", t=16,
                  preset="quality")
        torch.cuda.synchronize()

    with FirstScreen(scoring) as first:
        quality()
    args = first.args
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        quality()
        walls.append(time.perf_counter() - t0)
    emit({"path": "quality", "wall_s": walls})

    def screen():
        return scoring.refine_gains_device(**args)

    emit({"kernel": "refine_gains_device", "B": args["cand"].shape[0],
          "tile_l": args["tile_l"], "k": args["k"], "ms": cuda_ms(screen),
          "graph_ms": graph_ms(screen)})
    del hg, args, first

    def matrix(src, dst, mask, n):
        return in_neighbors(*(torch.from_numpy(a).cuda()
                              for a in (src, dst, mask)), n)[0]

    meta = get_arch("graphsage-reddit").shapes["minibatch_lg"].meta
    m = meta["graph_nodes"]
    src, dst = graphs.random_graph(m, meta["graph_edges"] / m, seed=0)
    sampler = graphs.NeighborSampler(m, src, dst)
    del src, dst
    b = gnn_sample(sampler, meta, np.zeros((m, 1), np.float32),
                   np.zeros(m, np.int32), 0)
    n = meta["nodes"]
    layer = matrix(b["edge_src"], b["edge_dst"], b["edge_mask"], n)
    del sampler, b
    # as launch.train.gnn_batches draws it
    src, dst = graphs.random_graph(n, max(meta["edges"] / n, 1.0), seed=0)
    src, dst = src[:meta["edges"]], dst[:meta["edges"]]
    launcher = matrix(src, dst, np.ones(src.size, bool), n)
    hub = np.full((101_000, 4), -1, np.int32)
    tail = hub[:, 1:]
    tail[:] = rng.integers(-1, 5000, size=tail.shape)
    tail[tail == 7] = 8
    hub[1:100_001, 0] = 7                          # 100,000 slots of id 7
    cases = {"layer": (layer, n), "launcher batch": (launcher, n),
             "hub": (torch.from_numpy(hub).cuda(), 5000)}
    gen = torch.Generator("cuda").manual_seed(3)
    x, w = layer_x_w(n, gen)
    for name in ("layer", "launcher batch"):
        nb = cases[name][0]
        emit({"kernel": "neighbor_agg", "shape": name, "B": nb.shape[0],
              "K": nb.shape[1], "valid_slots": int((nb >= 0).sum()),
              "live_rows": int(((nb >= 0).sum(1) > 0).sum()),
              "ms": cuda_ms(lambda: ext.neighbor_agg(x, nb, w, True),
                            reps=5, iters=10, warmup=3)})
    del x, w
    for name, (nb, N) in cases.items():
        g = torch.randn((nb.shape[0], 128), device="cuda", generator=gen)
        index = nops.transpose_index(nb, N)
        emit({"kernel": "neighbor_agg_bwd", "shape": name, "N": N,
              "B": nb.shape[0], "K": nb.shape[1],
              "valid_slots": int((nb >= 0).sum()),
              "heaviest_id_slots": int((index.rowptr[1:]
                                        - index.rowptr[:-1]).max()),
              "ms": cuda_ms(lambda: ext.neighbor_agg_bwd(g, *index, False,
                                                         True),
                            reps=5, iters=20, warmup=3)})
    print(card_line(), flush=True)
    return 0


def sampled_gnn(emit, batch_file, cuda_ms, graph_ms):
    """``--gnn-only``: the sampled GraphSAGE layer and train step of the
    tree on gnn_train's first batch (see the module's docstring)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch import convert
    from repro_torch.configs import get_arch
    from repro_torch.data import graphs
    from repro_torch.kernels.neighbor_agg import ops as nops
    from repro_torch.models import gnn
    from repro_torch.train.optimizer import AdamWConfig, init_adamw
    from repro_torch.train.train_loop import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arch = get_arch(cs.GNN_ARCH)
    cfg = arch.build_cfg(shape=cs.GNN_SHAPE)
    meta = arch.shapes[cs.GNN_SHAPE].meta
    path = pathlib.Path(batch_file) if batch_file else None
    if path is not None and path.exists():
        b = dict(np.load(path))
    else:
        src, dst, feats, labels = cs.gnn_source(meta, graphs)
        sampler = graphs.NeighborSampler(meta["graph_nodes"], src, dst)
        del src, dst
        b = cs.gnn_sample(sampler, meta, feats, labels, 0)
        b = {k: b[k] for k in cs.GNN_KEYS}
        del sampler, feats, labels
        if path is not None:
            path.parent.mkdir(parents=True, exist_ok=True)
            np.savez(path, **b)
    tb = {k: torch.from_numpy(b[k]).cuda() for k in cs.GNN_KEYS}
    n = meta["nodes"]
    edges = (tb["edge_src"], tb["edge_dst"], tb["edge_mask"], n)
    x, w = cs.layer_x_w(n, torch.Generator("cuda").manual_seed(3))
    w.requires_grad_(True)
    if hasattr(gnn, "in_neighbors_csr"):
        route = "neighbor_agg_csr"

        def build():
            return gnn.in_neighbors_csr(*edges)

        indptr, indices, _, *rest = build()

        # rest is (units, index) where the tree builds the forward's chunk
        # units once, (index,) where the wrapper builds them in each call
        def layer():
            return nops.neighbor_agg_csr(x, indptr, indices, w,
                                         *reversed(rest))
    else:
        route = "neighbor_agg"

        def build():
            return gnn.in_neighbors(*edges)

        nbrs, _, index = build()

        def layer():
            return nops.neighbor_agg(x, nbrs, w, index)

    row = {"gnn": "layer", "route": route, "nodes": n,
           "valid_edges": int(tb["edge_mask"].sum()),
           "structure_build_ms": cuda_ms(build, reps=3, iters=5, warmup=2),
           "ms": cuda_ms(layer, reps=5, iters=20, warmup=3)}
    try:
        row["graph_ms"] = graph_ms(layer, iters=20)
    except RuntimeError as e:          # a route that cannot be captured
        row["graph_ms"], row["graph_error"] = None, str(e)[:200]
    emit(row)
    del x, w

    params = convert.gnn_params_from_numpy(
        cs.gnn_numpy_params(gnn.gnn_param_shapes(cfg)), cfg, "cuda",
        dtype=torch.bfloat16)
    opt_cfg = AdamWConfig(**cs.GNN_OPT)
    step_fn = make_train_step(lambda p, bb: gnn.gnn_loss(p, bb, cfg),
                              opt_cfg)
    state = (params, init_adamw(params, opt_cfg))
    host, device, losses = [], [], []
    for _ in range(12):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        p, o, m = step_fn(*state, tb)
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        device.append(start.elapsed_time(end))
        losses.append(float(m["loss"]))
        state = (p, o)
    emit({"gnn": "train_step", "route": route, "warmups": 2,
          "host_ms": host[2:], "host_ms_median": float(np.median(host[2:])),
          "events_ms": device[2:],
          "events_ms_median": float(np.median(device[2:])),
          "losses": losses})
    cs.emit = emit          # the profile's row carries the tree's label
    cs.phase_profile(f"gnn_step_{route}", lambda: step_fn(*state, tb),
                     watch=("neighbor_agg",))


def rows_inputs(cache, need_ogb=True):
    """The sampled batch (numpy, GNN_KEYS) of gnn_train's first step and,
    with ``need_ogb``, the ogb_products launcher batch's in-neighbour CSR
    (on the card; else None, None), from ``cache`` where a tree's run kept
    them."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.data import graphs
    from repro_torch.launch import train as launch_train
    from repro_torch.models import gnn

    arch = get_arch(cs.GNN_ARCH)
    path = pathlib.Path(cache) if cache else None
    if path is not None and (path / "first.npz").exists():
        first = dict(np.load(path / "first.npz"))
    else:
        meta = arch.shapes[cs.GNN_SHAPE].meta
        src, dst, feats, labels = cs.gnn_source(meta, graphs)
        sampler = graphs.NeighborSampler(meta["graph_nodes"], src, dst)
        del src, dst
        first = cs.gnn_sample(sampler, meta, feats, labels, 0)
        first = {k: first[k] for k in cs.GNN_KEYS}
        del sampler, feats, labels
        if path is not None:
            path.mkdir(parents=True, exist_ok=True)
            np.savez(path / "first.npz", **first)
    if not need_ogb:
        return first, None, None
    if path is not None and (path / "ogb_csr.pt").exists():
        ogb = torch.load(path / "ogb_csr.pt", map_location="cuda")
        return first, ogb["indptr"], ogb["indices"]
    b = launch_train.gnn_batches(arch, cs.GNN_FB_SHAPE, False, "cuda")(0)
    indptr, indices = gnn.in_neighbors_csr(
        b["edge_src"], b["edge_dst"], b["edge_mask"],
        b["nodes"].shape[0])[:2]
    del b
    if path is not None:
        path.mkdir(parents=True, exist_ok=True)
        torch.save({"indptr": indptr, "indices": indices},
                   path / "ogb_csr.pt")
    return first, indptr, indices


def chunk_rows(emit, cache, rows):
    """``--rows-only``: rows 5d, 4b, 5b, 5c, 3b and 3, those named in
    ``rows`` (see the docstring)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.data.pipeline import RecsysStream
    from repro_torch.kernels._build import load_extension
    from repro_torch.kernels.neighbor_agg import ops as nops
    from repro_torch.models import gnn

    ext = load_extension()
    gen = torch.Generator("cuda").manual_seed(3)
    first, ogb_ptr, ogb_idx = rows_inputs(cache, "5d" in rows or "5b" in rows)
    tb = {k: torch.from_numpy(first[k]).cuda() for k in cs.GNN_KEYS}
    n = tb["nodes"].shape[0]

    def timed(row, fn, iters, split=True):
        row.update(ms=cs.cuda_ms(fn, reps=3, iters=iters, warmup=2),
                   graph_ms=cs.graph_ms(fn, iters=iters))
        if split:
            row["split_ms"] = cs.kernel_split(fn, iters=min(iters, 5))
        emit(row)

    if "5d" in rows or "5b" in rows:
        mb_ptr, mb_idx = gnn.in_neighbors_csr(
            tb["edge_src"], tb["edge_dst"], tb["edge_mask"], n)[:2]
        for layer, indptr, indices, iters in (
                ("minibatch_lg", mb_ptr, mb_idx, 20),
                ("ogb_products", ogb_ptr, ogb_idx, 5)):
            N = indptr.numel() - 1
            if "5d" in rows:
                x, w = cs.layer_x_w(N, gen)
                units = nops.chunk_units(indptr, indices.shape[0])
                timed({"row": "5d", "kernel": "neighbor_agg_csr",
                       "layer": layer, "valid_slots": int(indptr[-1])},
                      lambda: nops.neighbor_agg_csr(x, indptr, indices, w,
                                                    units=units), iters)
                del x, w, units
            if "5b" in rows:
                g = torch.randn((N, 128), device="cuda", generator=gen)
                index = nops.csr_transpose_index(indptr, indices, N)
                timed({"row": "5b", "kernel": "neighbor_agg_bwd",
                       "layer": layer},
                      lambda: ext.neighbor_agg_bwd(g, *index, False, True),
                      iters)
                del g, index
            torch.cuda.empty_cache()
        del ogb_ptr, ogb_idx

    if "4b" in rows:
        V = cs.RECSYS_TRAIN_VOCAB
        ids = torch.from_numpy(RecsysStream(V, V, 65_536, n_fields=4, bag=8)
                               .batch_at(0)["user_ids"].reshape(-1, 8)
                               ).cuda()
        g = torch.randn((ids.shape[0], 256), device="cuda", generator=gen)
        index = nops.transpose_index(ids, V)
        # the light ids and the runs of empty ids alone: no unit list
        light = cs.cuda_ms(lambda: ext.neighbor_agg_bwd(
            g, *index[:4], index.hunit[:0], False, True), reps=3, iters=10,
            warmup=2)
        timed({"row": "4b", "kernel": "embedding_bag_bwd",
               "shape": "training shape, user tower", "V": V, "D": 256,
               "light_pass_ms": light},
              lambda: ext.neighbor_agg_bwd(g, *index, False, True), 10)
        del g, index, ids
        torch.cuda.empty_cache()

    if "5c" in rows:
        segment_rows(emit, tb, n, gen, timed)
    if "3b" in rows:
        screen_rows(emit, cache, timed)
    if "3" in rows:
        krng = np.random.default_rng(2)
        for kind, k in (("synthetic", 32), ("path", 32), ("synthetic", 67)):
            x = [torch.from_numpy(a).cuda()
                 for a in cs.kway_tile(krng, 4096, 2048, k, kind)]
            timed({"row": "3", "kernel": "kway_gains", "B": 4096, "L": 2048,
                   "k": k, "inputs": kind},
                  lambda: ext.kway_gains(*x, k), 100, split=False)


def segment_rows(emit, tb, n, gen, timed):
    """Row 5c at meshgraphnet's (D = 128) and gatedgcn's (D = 70) layers,
    by dst (the forward's sums) and, at D = 70, by src (h[src]'s
    gradient), each index built ahead; then row 5b's kernel in its sum
    mode on the same inputs, with its unit list and without it (the
    ticket memset and the heavy blocks' launch left out), and at D = 72
    (its 16-byte route), the yardsticks of the sum's fixed costs and of
    its column passes."""
    import torch

    from repro_torch.kernels._build import load_extension
    from repro_torch.kernels.neighbor_agg import ops as nops

    ext = load_extension()
    mask = tb["edge_mask"]
    by = {"dst": torch.where(mask, tb["edge_dst"], -1),
          "src": torch.where(mask, tb["edge_src"], -1)}
    for arch, D, key in (("meshgraphnet", 128, "dst"), ("gatedgcn", 70, "dst"),
                         ("gatedgcn", 70, "src")):
        ids = by[key]
        index = nops.segment_index(ids, n)
        per_id = torch.bincount(ids[ids >= 0].long(), minlength=n)
        msgs = torch.randn((ids.shape[0], D), device="cuda",
                           generator=gen) * mask[:, None]
        timed({"row": "5c", "kernel": "segment_sum", "layer": arch, "D": D,
               "by": key, "max_edges_one_id": int(per_id.max()),
               "ids_past_32": int((per_id > 32).sum())},
              lambda: nops.segment_sum(msgs, ids, n, index), 100)
        if key != "dst":
            continue
        row = {"row": "5c", "kernel": "neighbor_agg_bwd (sum mode)",
               "layer": arch, "D": D, "by": key}
        timed(dict(row, units="kept"), lambda: ext.neighbor_agg_bwd(
            msgs, *index, False, False), 100)
        timed(dict(row, units="none"), lambda: ext.neighbor_agg_bwd(
            msgs, *index[:4], index.hunit[:0], False, False), 100)
        if D % 4:
            wide = torch.randn((ids.shape[0], D + 2), device="cuda",
                               generator=gen) * mask[:, None]
            timed(dict(row, D=D + 2, units="kept"),
                  lambda: ext.neighbor_agg_bwd(wide, *index, False, False),
                  100)
            del wide
        del msgs, index


# Schedule variants of rows 5c and 3b: (name, [(text, replacement)])
# applied to the kernel's source before it is built on its own (its plain
# C entry points, no PyTorch headers).
SEGMENT_VARIANTS = [
    ("as committed", []),
    ("3 blocks an SM", [("__launch_bounds__(kThreads, 4)",
                         "__launch_bounds__(kThreads, 3)")]),
    ("6 blocks an SM", [("__launch_bounds__(kThreads, 4)",
                         "__launch_bounds__(kThreads, 6)")]),
    ("8 blocks an SM", [("__launch_bounds__(kThreads, 4)",
                         "__launch_bounds__(kThreads, 8)")]),
    ("2 ids a warp", [("constexpr int kIds = 4;", "constexpr int kIds = 2;")]),
    ("8 ids a warp", [("constexpr int kIds = 4;", "constexpr int kIds = 8;")]),
    ("4 rows in flight", [("return VW * NC <= 4 ? 8 :",
                           "return VW * NC <= 4 ? 4 :")]),
    ("16 rows in flight", [("return VW * NC <= 4 ? 8 :",
                            "return VW * NC <= 4 ? 16 :")]),
]
_OWN_IN_A_REGISTER = [
    ("  for (int jb = (int)((int64_t)nl * warp / kWarps); jb < j1; jb += kSPer) {",
     "  int mine = -1, own_acc = 0, own_col = 0;\n"
     "  for (int jb = (int)((int64_t)nl * warp / kWarps); jb < j1; jb += kSPer) {"),
    ("""      const int own = sr.own[row[i]];
      const int col = (unsigned)x[i] < (unsigned)k   ? x[i]
                      : x[i] >= 0 && x[i] == own ? k
                                                 : -1;
      if (col >= 0) atomicAdd(cnt + row[i] * k1 + col, 1);
    }
  }
  __syncthreads();""",
     """      const int own = sr.own[row[i]];
      if (row[i] != mine) {  // a lane's places only move forward
        if (own_acc) atomicAdd(cnt + mine * k1 + own_col, own_acc);
        mine = row[i];
        own_acc = 0;
        own_col = own < k ? own : k;
      }
      if (x[i] >= 0 && x[i] == own) {
        ++own_acc;
      } else if ((unsigned)x[i] < (unsigned)k) {
        atomicAdd(cnt + row[i] * k1 + x[i], 1);
      }
    }
  }
  if (own_acc) atomicAdd(cnt + mine * k1 + own_col, own_acc);
  __syncthreads();""")]
SCREEN_VARIANTS = [
    ("as committed", []),
    ("the own part counted in a register", _OWN_IN_A_REGISTER),
    ("the own part in a register, 4 in flight", _OWN_IN_A_REGISTER + [
        ("constexpr int kSPer = 8;", "constexpr int kSPer = 4;")]),
    ("the own part in a register, 16 warps a block", _OWN_IN_A_REGISTER + [
        ("constexpr int kThreads = 256;", "constexpr int kThreads = 512;")]),
    ("gathers from L2", [("__ldca(assign", "__ldcg(assign")]),
    ("16 in flight", [("constexpr int kSPer = 8;",
                       "constexpr int kSPer = 16;")]),
    ("4 in flight", [("constexpr int kSPer = 8;",
                      "constexpr int kSPer = 4;")]),
    ("16 rows a block", [("constexpr int kSRows = 8;",
                          "constexpr int kSRows = 16;")]),
    ("4 rows a block", [("constexpr int kSRows = 8;",
                         "constexpr int kSRows = 4;")]),
    ("16 warps a block", [("constexpr int kThreads = 256;",
                           "constexpr int kThreads = 512;")]),
    ("16 rows and 16 warps a block", [
        ("constexpr int kSRows = 8;", "constexpr int kSRows = 16;"),
        ("constexpr int kThreads = 256;", "constexpr int kThreads = 512;")]),
]


def build_variant(src, name, subs, out_dir):
    """``src`` with ``subs`` applied, built by nvcc into a shared library
    under ``out_dir``; returns (the library, ptxas's register and spill
    lines)."""
    import ctypes
    import subprocess
    text = src.read_text()
    for a, b in subs:
        if a not in text:
            raise SystemExit(f"variant {name!r}: {a!r} not in the source")
        text = text.replace(a, b)
    tag = src.stem + "_" + "".join(c if c.isalnum() else "_" for c in name)
    cu, so = out_dir / f"{tag}.cu", out_dir / f"{tag}.so"
    cu.write_text(text)
    built = subprocess.run(
        ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
         "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
         f"-I{src.parent}", "-o", str(so), str(cu)],
        capture_output=True, text=True)
    if built.returncode:
        raise SystemExit(f"variant {name!r} failed to build: "
                         f"{built.stderr[-2000:]}")
    ptxas = [line.strip() for line in built.stderr.splitlines()
             if "registers" in line or "spill" in line]
    return ctypes.CDLL(str(so)), ptxas


def variants(emit, cache, rows):
    """``--variants``: rows 5c and 3b (those in ``rows``) built once per
    entry of SEGMENT_VARIANTS and SCREEN_VARIANTS (see the docstring)."""
    import torch

    from repro_torch.kernels import _build

    kernels = pathlib.Path(_build.__file__).parent
    out_dir = pathlib.Path(_build.BUILD_DIR).parent / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)

    def check(name, err):
        if err:
            raise SystemExit(f"variant {name!r}: CUDA error {err}")

    def stream():
        return torch.cuda.current_stream().cuda_stream

    if "5c" in rows:
        segment_variants(emit, cache, kernels, out_dir, check, stream)
    if "3b" in rows:
        screen_variants(emit, cache, kernels, out_dir, check, stream)


def segment_variants(emit, cache, kernels, out_dir, check, stream):
    """Row 5c's variants (``variants``)."""
    import ctypes

    import torch

    import chip_smoke as cs
    from repro_torch.kernels.neighbor_agg import ops as nops

    vp, i64, c_int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    first = rows_inputs(cache, False)[0]
    tb = {k: torch.from_numpy(first[k]).cuda() for k in cs.GNN_KEYS}
    n = tb["nodes"].shape[0]
    mask = tb["edge_mask"]
    gen = torch.Generator("cuda").manual_seed(3)
    cases = []
    for D, key in ((70, "edge_dst"), (70, "edge_src"), (128, "edge_dst")):
        ids = torch.where(mask, tb[key], -1)
        msgs = torch.randn((ids.shape[0], D), device="cuda",
                           generator=gen) * mask[:, None]
        cases.append((D, key, msgs, nops.segment_index(ids, n),
                      nops.segment_sum(msgs, ids, n)))
    for name, subs in SEGMENT_VARIANTS:
        lib, ptxas = build_variant(
            kernels / "neighbor_agg" / "csrc" / "segment_sum.cu", name, subs,
            out_dir)
        fn = lib.segment_sum_launch
        fn.restype = c_int
        fn.argtypes = [vp] * 7 + [i64, vp, i64, c_int, c_int, vp]
        for D, key, msgs, index, want in cases:
            cap = index.hunit.shape[0]
            tickets = torch.zeros(cap + 1, dtype=torch.int32, device="cuda")
            partials = torch.empty((cap, D), device="cuda")
            out = torch.empty((n, D), device="cuda")

            def call():
                check(name, fn(
                    msgs.data_ptr(), index.rowptr.data_ptr(),
                    index.rows.data_ptr(), index.hptr.data_ptr(),
                    index.hunit.data_ptr(), partials.data_ptr(),
                    tickets.data_ptr(), cap, out.data_ptr(), n, D, 16,
                    stream()))

            call()
            torch.cuda.synchronize()
            emit({"row": "5c", "variant": name, "D": D,
                  "by": key.removeprefix("edge_"),
                  "equal": torch.equal(out, want),
                  "tickets_zero": not bool(tickets.any()),
                  "ms": cs.cuda_ms(call, reps=3, iters=100, warmup=5),
                  "graph_ms": cs.graph_ms(call, iters=100),
                  "ptxas": ptxas})


def screen_variants(emit, cache, kernels, out_dir, check, stream):
    """Row 3b's variants (``variants``)."""
    import ctypes

    import torch

    import chip_smoke as cs
    from repro_torch.core import scoring
    from repro_torch.kernels.kway_refine import ops as kops

    vp, c_int = ctypes.c_void_p, ctypes.c_int
    args = torch.load(pathlib.Path(cache) / "screen.pt", map_location="cuda")
    indptr, indices, cand = args["indptr"], args["indices"], args["cand"]
    tile_l, k = args["tile_l"], args["k"]
    d_ids, d_vals = args["delta_ids"], args["delta_vals"]
    assign = args["assign"].clone()
    scoring.refine_gains_device(indptr, indices, assign, d_ids, d_vals,
                                cand, tile_l=tile_l, k=k)
    want = kops.kway_gains_csr(indptr, indices, assign, cand, tile_l=tile_l,
                               k=k)
    B = cand.shape[0]
    for name, subs in SCREEN_VARIANTS:
        lib, ptxas = build_variant(
            kernels / "kway_refine" / "csrc" / "kway_gains.cu", name, subs,
            out_dir)
        fn = lib.kway_gains_csr_launch
        fn.restype = c_int
        fn.argtypes = [vp, c_int, vp, vp, c_int, vp, vp, c_int, vp, vp, vp,
                       c_int, c_int, c_int, vp]
        gains = torch.empty((B, k), device="cuda")
        ptr64 = int(indptr.dtype == torch.int64)

        def call(delta_ids, delta_vals, nd):
            check(name, fn(indptr.data_ptr(), ptr64, indices.data_ptr(),
                           assign.data_ptr(), assign.shape[0] - 1, delta_ids,
                           delta_vals, nd, cand.data_ptr(), gains.data_ptr(),
                           None, B, tile_l, k, stream()))

        def kernel():
            call(None, None, 0)

        def screen():
            call(d_ids.data_ptr(), d_vals.data_ptr(), d_ids.shape[0])

        kernel()
        torch.cuda.synchronize()
        equal = torch.equal(gains, want)
        screen()
        torch.cuda.synchronize()
        emit({"row": "3b", "variant": name, "B": B, "tile_l": tile_l,
              "k": k, "equal": equal and torch.equal(gains, want),
              "ms": cs.cuda_ms(kernel, reps=3, iters=100, warmup=5),
              "graph_ms": cs.graph_ms(kernel, iters=100),
              "screen_ms": cs.cuda_ms(screen, reps=3, iters=100, warmup=5),
              "screen_graph_ms": cs.graph_ms(screen, iters=100),
              "ptxas": ptxas})


def screen_rows(emit, cache, timed):
    """Row 3b at the quality path's first screen (github_like(1.0,
    seed=0), k = 32, t = 16, preset "quality": the supersteps' assignment
    and the first 4,096 boundary ids, from the tree's own run, kept in
    ``cache``): ``refine_gains_device`` whole and ``kway_gains_csr``
    alone, each eager, in a CUDA graph and split by launch; then the
    kernel alone at tile_l = 32, with every candidate a pad, at k = 1 and
    67, with only the rows of at most 32 neighbours (the others made
    pads), and the launch floor."""
    import torch

    import chip_smoke as cs
    from repro_torch.core import scoring
    from repro_torch.data import synthetic
    from repro_torch.kernels.kway_refine import ops as kops
    from repro_torch.partition_api import partition

    path = pathlib.Path(cache) / "screen.pt" if cache else None
    if path is not None and path.exists():
        args = torch.load(path, map_location="cuda")
    else:
        with cs.FirstScreen(scoring) as first:
            partition(synthetic.github_like(1.0, seed=0), 32,
                      "hype_superstep", device="cuda", t=16,
                      preset="quality")
        args = first.args
        if path is not None:
            path.parent.mkdir(parents=True, exist_ok=True)
            torch.save(args, path)
    indptr, indices, cand = args["indptr"], args["indices"], args["cand"]
    tile_l, k = args["tile_l"], args["k"]
    assign = args["assign"].clone()
    delta = (args["delta_ids"], args["delta_vals"])
    scoring.refine_gains_device(indptr, indices, assign, *delta, cand,
                                tile_l=tile_l, k=k)
    deg = torch.where(cand >= 0, indptr[cand.clamp_min(0).long() + 1]
                      - indptr[cand.clamp_min(0).long()], 0)
    info = {"row": "3b", "B": cand.shape[0], "tile_l": tile_l, "k": k,
            "real_rows": int((cand >= 0).sum()),
            "rows_past_32": int((deg > 32).sum()),
            "rows_at_tile_l": int((deg >= tile_l).sum()),
            "delta_entries": int(delta[0].shape[0]),
            "delta_real": int((delta[0] >= 0).sum())}
    timed(dict(info, kernel="refine_gains_device"),
          lambda: scoring.refine_gains_device(indptr, indices, assign,
                                              *delta, cand, tile_l=tile_l,
                                              k=k), 100)
    timed(dict(info, kernel="kway_gains_csr"),
          lambda: kops.kway_gains_csr(indptr, indices, assign, cand,
                                      tile_l=tile_l, k=k), 100)
    pads = torch.full_like(cand, -1)
    short = torch.where(deg <= 32, cand, -1)
    for name, c, tl, kk in (("tile_l 32", cand, 32, k),
                            ("every candidate a pad", pads, tile_l, k),
                            ("k 1", cand, tile_l, 1),
                            ("k 67", cand, tile_l, 67),
                            ("rows of at most 32 only", short, tile_l, k)):
        timed(dict(info, kernel="kway_gains_csr", variant=name),
              lambda: kops.kway_gains_csr(indptr, indices, assign, c,
                                          tile_l=tl, k=kk), 100,
              split=False)
    one = torch.zeros(1, device="cuda")
    timed({"row": "3b", "kernel": "launch floor (one-element add_)"},
          lambda: one.add_(1.0), 100, split=False)


def recsys_vocab(emit, vocab):
    """chip_smoke.py's recsys_train phase (it prints its own row) with
    each vocabulary at ``vocab`` rows; where the allocator refuses, the
    peak and the reserved memory when it did."""
    import torch

    import chip_smoke
    from repro_torch.kernels.embedding_bag import ops as bops
    chip_smoke.RECSYS_TRAIN_VOCAB = vocab
    launches = chip_smoke.Launches({"embedding_bag": bops.embedding_bag,
                                    "embedding_bag_bwd":
                                        bops.embedding_bag_bwd})
    try:
        chip_smoke.phase_recsys_train(launches)
    except torch.OutOfMemoryError as e:
        emit({"phase": "recsys_train", "vocab": vocab,
              "out_of_memory": True,
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
              "reserved_gb": torch.cuda.memory_reserved() / 1e9,
              "total_gb": torch.cuda.get_device_properties(0).total_memory
              / 1e9, "error": str(e).split(". If ")[0]})


def stream(emit, hg, hs, scoring, ops, ref, ext, CaptureCommits,
           commit_timings) -> None:
    """The stream rows of the module docstring."""
    import collections

    import numpy as np
    import torch
    params = hs.StreamParams(seed=0)

    def run():
        hs.hype_stream_partition(hg, 32, params, device="cuda")
        torch.cuda.synchronize()

    mid = -(-hg.n // params.micro_batch) // 2
    census = collections.Counter()
    with CaptureCommits(scoring, (mid,), widths=(32, 128, 512)) as kept:
        spied = scoring.stream_commit

        def count(edge, fcnt, valid, sketch, sizes, **kw):
            # on the host: the tile's width, its valid rows' pins, and its
            # dependent rows (a bucket that another pin of the micro-batch
            # holds too)
            e, v = edge.cpu().numpy(), valid.cpu().numpy()
            ids = np.where((e >= 0) & v[:, None], e, -1)
            b = (ids.astype(np.uint32) * np.uint32(2654435761)) >> np.uint32(
                32 - kw["sketch_bits"])
            b = np.where(ids >= 0, b.astype(np.int64), -1)
            vals, counts = np.unique(b[b >= 0], return_counts=True)
            shared = np.isin(b, vals[counts >= 2])
            pins = int((ids >= 0).sum())
            census.update({f"Le{e.shape[1]}": 1, "micro_batches": 1,
                           "pins": pins, "valid_rows": int(v.sum()),
                           "dependent_rows": int(shared.any(1).sum())})
            census["max_pins"] = max(census["max_pins"], pins)
            return spied(edge, fcnt, valid, sketch, sizes, **kw)

        scoring.stream_commit = count
        run()
        scoring.stream_commit = spied
    emit({"stream_census": dict(census)})
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    emit({"path": "stream", "wall_s": walls})
    emit({"kernel": "stream_commit", "inputs": f"path micro-batch {mid}",
          **commit_timings(ops, ref, ext, kept.args[0], kept.by_width)})


def flash(emit, fops, cuda_ms, graph_ms) -> None:
    """The flash rows of the module docstring; inputs from a fixed seed."""
    import torch
    with_lse = "lse" in inspect.signature(fops.flash_attention_bwd).parameters
    gen = torch.Generator("cuda").manual_seed(6)

    def inputs(B, Hq, Hkv, D):
        return [torch.randn((B, 4096, h, D), device="cuda",
                            generator=gen).bfloat16()
                for h in (Hq, Hkv, Hkv, Hq)]

    q, k, v, _ = inputs(8, 32, 8, 128)
    shape = {"B": 8, "S": 4096, "Hq": 32, "Hkv": 8, "D": 128}
    emit({"kernel": "flash_attention", **shape, "lse": False,
          "ms": cuda_ms(lambda: fops.flash_attention(q, k, v), reps=5,
                        iters=10, warmup=3)})
    if with_lse:
        emit({"kernel": "flash_attention", **shape, "lse": True,
              "ms": cuda_ms(lambda: fops.flash_attention(
                  q, k, v, return_lse=True), reps=5, iters=10, warmup=3)})
    del q, k, v
    for name, (B, Hq, Hkv, D) in (("train", (2, 32, 32, 80)),
                                  ("layer", (8, 32, 8, 128))):
        q, k, v, g = inputs(B, Hq, Hkv, D)
        if with_lse:
            out, lse = fops.flash_attention(q, k, v, return_lse=True)
            args = (q, k, v, out, g, lse)
        else:
            args = (q, k, v, fops.flash_attention(q, k, v), g)

        def call():
            return fops.flash_attention_bwd(*args)

        emit({"kernel": "flash_attention_bwd", "shape": name, "B": B,
              "S": 4096, "Hq": Hq, "Hkv": Hkv, "D": D,
              "ms": cuda_ms(call, reps=3, iters=3, warmup=1),
              "graph_ms": graph_ms(call, iters=1)})
        del q, k, v, g, args
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
