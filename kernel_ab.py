#!/usr/bin/env python3
"""Time the scoring, refinement-screen, neighbour-aggregation and
flash-attention kernels of one source tree on one CUDA card, so that two
commits can be compared on one card.

    python3 kernel_ab.py [--tree DIR] [--label NAME] [--flash-only]
                         [--stream-only]

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
``stream_commit`` and the stream pass alone. Prints one JSON line per
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
              "ms": cuda_ms(lambda: ext.neighbor_agg_bwd(g, *index, False),
                            reps=5, iters=20, warmup=3)})
    print(card_line(), flush=True)
    return 0


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
