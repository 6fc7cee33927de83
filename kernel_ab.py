#!/usr/bin/env python3
"""Time the scoring, refinement-screen and neighbour-aggregation kernels of
one source tree on one CUDA card, so that two commits can be compared on
one card.

    python3 kernel_ab.py [--tree DIR] [--label NAME]

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
    100,000 slots.
Prints one JSON line per measurement, then the card's name and power
limit. Exits 1 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(HERE))
    ap.add_argument("--label", default=None)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    from chip_smoke import (FirstScreen, card_line, cuda_ms, gnn_sample,
                            graph_ms, kernel_inputs, kway_tile, layer_x_w)
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.core import scoring
    from repro_torch.data import graphs, synthetic
    from repro_torch.kernels._build import load_extension
    from repro_torch.kernels.hype_score import ops
    from repro_torch.kernels.neighbor_agg import ops as nops
    from repro_torch.models.gnn import in_neighbors
    from repro_torch.partition_api import partition

    label = args.label or tree.name
    ext = load_extension()

    def emit(row):
        print(json.dumps({"tree": label, **row}), flush=True)

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
              "ms": cuda_ms(lambda: ext.neighbor_agg_bwd(g, *index, False),
                            reps=5, iters=20, warmup=3)})
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
