#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check every phase.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card (one is
enough). It builds the port's CUDA kernels from this checkout, then
prints one JSON line per phase:

  env       the card's name and power limit, torch/CUDA versions, build
            time, and the flash kernels' instructions in the built
            extension's SASS (the bf16 kernel must hold HGMMA)
  kernel    each CUDA kernel against its plain PyTorch version on the card,
            compared exactly, with times per launch: score + select per L,
            hype_scores per (B, L) (eagerly and in a CUDA graph, beside
            the launch floor of a one-element add_), kway_gains per
            (L, k), plus edge cases and the shapes past the limits the
            port once had (a fringe of 24 to 60,000 ids, R + P up to
            60,016 slots, k up to 10,000)
  goldens   the seven small depth-1 golden digests of the JAX package and
            six of the refinement, batched and multilevel paths (pl600),
            reproduced through ``partition(..., device="cuda")``
  slice     github_like(1.0, seed=0), k=32, t=16, hype_superstep at
            pipeline depth 1 and 2, with its digests held against the JAX
            package's
  batched   the same graph through hype_batched, t=16, with the (B, L)
            of each hype_scores launch counted and summed over this run's
            times per shape
  quality   the same graph through hype_superstep, t=16, preset="quality"
            (the refinement post-pass on the card)
  multilevel  github_like(0.25, seed=0), k=32, through hype_multilevel
  profile   the depth-1 slice, the batched and the quality path each run
            twice more, under torch.profiler (the card's busy time) and
            under cProfile (the host's time per function)
  kernel_embedding_bag  the EmbeddingBag kernel against its plain version
            (fp32 and bf16, mean and sum, edge cases, ids near V-1 of a
            full-width 16,777,216 x 256 table), timed at the serving
            shapes beside ``torch.nn.functional.embedding_bag``
  recsys_serve  two-tower-retrieval at its published width, tables drawn
            on the card: score_batch at serve_p99 (B=512) and serve_bulk
            (B=262,144), retrieve over 1,048,576 candidates (top 128),
            each equal to the same call through the plain EmbeddingBag,
            then the serve launcher at B=512
  recsys_parity  the reduced config from numpy params, card against CPU
  placement  HYPE row placement of the co-access log of
            benchmarks/bench_beyond_paper.py, held against JAX's digest
  kernel_flash_attention  the flash-attention kernels against their
            plain version (fp32 on the CUDA-core kernel, bf16 on the
            tensor-core kernel: causal, non-causal, windows, D from 8 to
            256, Hkv = 1, ragged S, and the full-width qwen3-8b layer shape
            B=8, S=4096), timed there and at B=1, S=32,768 beside
            ``F.scaled_dot_product_attention``; at S=32,768 the last 64
            query rows of every head are compared; bf16 is held to a worst
            case and a mean error limit (FLASH_TOL)
  lm_serve  qwen3-8b at full width (bf16, 8.19e9 params drawn on the
            card): prefill of 8 prompts of 4,096 tokens, 16 greedy
            decode steps on that cache, then the serve launcher with its
            defaults; each prefill launches the kernel once per layer
  lm_parity  the reduced qwen3-8b config in float32 from numpy params,
            card against CPU
  lm_parity_bf16  the same config in bf16 (the tensor-core kernel),
            card against CPU, prefill launching the kernel once a layer
  gnn_setup the reddit-scale source graph (232,965 nodes, 114.6M edges),
            its features and labels, and the neighbour sampler, on the host
  kernel_neighbor_agg  the neighbour-aggregation forward and backward
            kernels against their plain versions (small shapes, an all-pad
            row, K = 1, ragged D and F, D = 602, K = 100, bf16, the train
            launcher's batch with K = 1,340, a synthetic hub of 100,000
            slots, and the full-width layer shape of a sampled batch:
            B = N = 169,984, D = F = 128; the backward bit for bit
            against its plain version on the CPU), timed there beside
            F.embedding_bag + matmul and a sparse CSR product
  gnn_train graphsage-reddit at its published width: 20 AdamW steps on
            sampled minibatch_lg batches (1,024 seeds, fanout 15-10)
            through run_training, each step launching the forward and the
            backward kernel twice; the first losses held to the JAX
            package's; then 3 more steps under the profiler
  gnn_launcher  the train launcher at minibatch_lg for 5 steps, its
            losses held to the JAX launcher's
  gnn_parity  the reduced config in float32, card against CPU: loss and
            every gradient

Every path starts with all launch counts at 0 and reads them right after;
a path that did not launch each of its kernels fails. Then come the
``{"kernels": [...]}`` record, the card's name and power limit, and as the
last line ``{"ok": true, "device": {...}}``. Any failure raises and exits
non-zero; nothing is printed on a machine without a card or outside the
repository.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time
import warnings

# HBM rate of one H100 SXM (NVIDIA's data sheet): the bytes bound.
HBM_BYTES_PER_S = 3.35e12
# Dense bf16 tensor-core peak of one H100 SXM (NVIDIA's data sheet): the
# operations bound of attention.
BF16_FLOPS = 989e12

# The JAX package's schedule facts for the slice (computed with the JAX
# package on the CPU; they are not speeds).
SLICE_FINGERPRINT = "f165bf3b6f7316de"
SLICE_DIGESTS = {1: "11af1dd01f862a04", 2: "b375f828d4fc1261"}
SLICE_KM1 = {1: 61457, 2: 61526}
# ... and for this slice's paths (k=32, seed 0; hype_batched and the
# quality preset at t=16 on the same graph, hype_multilevel with its
# defaults on github_like(0.25, seed=0))
PATH_DIGESTS = {"batched": "fcf79576d996c475",
                "quality": "ff5a93e5d0575075",
                "multilevel": "f69b4e70314aafbb"}
PATH_KM1 = {"batched": 52658, "quality": 60847, "multilevel": 28860}
ML_FINGERPRINT = "e3c67ff51a35cfd8"
# RefineStats.kernel_calls of the quality path in the JAX package's run
QUALITY_SCREENS = 104

# The two-tower serving slice. Tolerance of the reduced config's card
# run against the CPU run (tests/test_torch_recsys.py holds the CPU run
# against JAX with the same): the matmul libraries sum in other orders.
PARITY_TOL = dict(rtol=1e-5, atol=1e-6)
SERVE_BATCHES = {"serve_p99": 512, "serve_bulk": 262_144}
RETRIEVE_N_CAND, RETRIEVE_TOP_K = 1_048_576, 128
# partition_rows_hype on benchmarks/bench_beyond_paper.py's log (vocab
# 8,192, 4,000 queries, bag 16, k=8, seed 0), and the mean shards
# touched and remote fraction of the HYPE and the hash placement, all
# computed with the JAX package on the CPU (tests/test_torch_hype.py)
PLACEMENT_DIGEST = "23febef3972fa7ee"
PLACEMENT_JAX = {"hype": (2.03425, 0.23954658362470863),
                 "hash": (7.0305, 0.7520709009740261)}

# The LM serving slice: qwen3-8b at full width, bf16. The published
# prefill_32k (B=32) and decode_32k (B=128) caches need 154.6 and 618 GB
# (147,456 bytes per token over 36 layers), so prefill runs B=8 prompts
# of 4,096 tokens (a 4.83 GB cache) and decode 16 steps at B=8 on that
# cache; the kernel alone is timed at the published S=32,768 with B=1.
LM_ARCH = "qwen3-8b"
LM_BATCH, LM_PROMPT, LM_STEPS = 8, 4096, 16
LM_LONG_SEQ = 32_768
# flash_attention against its plain version on the card. float32 (the
# CUDA-core kernel): it sums key tiles online, the plain version takes one
# softmax, so they agree within float32 rounding (the float32 tolerance of
# tests/test_kernels.py). bfloat16 (the tensor-core kernel): the products
# are exact and summed in float32, but P is rounded to bf16 before P V.
# bf16 keeps 8 significant bits, so each p_j moves by at most 2**-8 of
# itself, and an output row by at most 2**-8 * sum_j p_j |v_j| / l <=
# 2**-8 max|v|; both sides round the output to bf16 once (one bf16 step,
# 2**-7 of the value, under rtol). So each bf16 case is held to two
# limits: the worst case, allclose with atol 1e-4 + 2**-8 max|v| of the
# case and rtol 1e-2; and the typical error, mean |out - ref| <= 2**-8
# mean |ref|, which a systematic fault (a wrong tile, a lost rescale)
# would break where the loose worst case would not.
FLASH_TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
             "bfloat16": dict(atol=1e-4, rtol=1e-2)}
FLASH_P_ULP = 2 ** -8       # bf16's unit roundoff: P's and the mean limit
# At S=32,768 the plain scores would be 137 GB: the last rows of every
# head are compared (64 x 32,768 scores a head) with the plain formula.
LONG_CHECK_ROWS = 64
# The reduced LM, float32 without TF32, card against CPU: the tolerance
# tests/test_serving.py holds two float32 decode paths to.
LM_PARITY_TOL = dict(atol=1e-4, rtol=1e-4)
LM_PARITY_STEPS = 8
# The reduced LM in bf16, card (the tensor-core kernel, P rounded to bf16)
# against CPU (the plain version, P in float32): the attention outputs
# differ by at most 2**-8 max|v| (FLASH_TOL's reasoning) and the bf16
# matmuls sum in other orders, and every layer rounds its residual to bf16,
# so the logits drift by a few bf16 steps, as JAX's bf16 path drifts from
# the port's (tests/test_torch_transformer.py: atol 0.1, rtol 0.02 on
# logits of order 1-4, about six bf16 steps). Both sides are fed the CPU's
# greedy tokens; a token must agree wherever the CPU's top two logits lie
# further apart than 2 atol.
LM_BF16_PARITY_TOL = dict(atol=0.1, rtol=0.02)

# The GNN training slice: graphsage-reddit at its published width (2
# layers, d_hidden 128, mean aggregator, d_feat 602, 41 classes) on the
# minibatch_lg shape: 1,024 seeds a step, fanout 15 then 10, sampled from
# a reddit-scale source graph (232,965 nodes, 114.6M edges) and padded to
# 169,984 nodes and 168,960 edges. Every input is made here from numpy
# seeds by the functions below, which tests/jax_gnn_losses.py runs with
# the JAX package's own generators and model to pin GNN_JAX_LOSSES.
GNN_ARCH, GNN_SHAPE = "graphsage-reddit", "minibatch_lg"
GNN_STEPS, GNN_PROFILE_STEPS = 20, 3
GNN_OPT = dict(lr=3e-3, warmup_steps=5, total_steps=100, weight_decay=0.0)
GNN_KEYS = ("nodes", "edge_src", "edge_dst", "edge_mask", "node_mask",
            "labels")
# FP32 CUDA-core peak of one H100 SXM (NVIDIA's data sheet): the
# operations bound of neighbor_agg (float32 gathers, means and product).
FP32_FLOPS = 67e12
# neighbor_agg on the card against its plain version: the mean is a
# float32 sum in slot order in both (compared bit for bit); the product
# sums over D in another order (float32 rounding), and a bf16 output
# rounds once, so it may differ by one bf16 step (rtol 2**-7). The
# backward is held bit for bit to its plain version on the CPU (the
# chunk order of ref.py in both), not to this tolerance.
NA_TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
          "bfloat16": dict(atol=1e-5, rtol=2 ** -7)}
# The first losses of gnn_train and of the launcher at minibatch_lg for 5
# steps, from the JAX package on the CPU (tests/jax_gnn_losses.py).
GNN_JAX_LOSSES = [3.7235753536224365, 3.68819260597229, 3.634840965270996]
GNN_LAUNCHER_STEPS = 5
GNN_LAUNCHER_JAX_LOSSES = [3.7143805027008057, 3.714378595352173,
                           3.714369773864746, 3.7143445014953613,
                           3.7143125534057617]
# Step 0 is one float32 forward (the aggregation sums in another order):
# float32 rounding. Later steps follow bf16 params updated by AdamW: a
# gradient a float32 rounding apart can round a param to the next bf16
# value, which moves the loss in its fifth digit at most (a param whose
# gradient is near zero barely moves the loss).
GNN_LOSS_TOL = [dict(rtol=1e-5, atol=1e-5)] + [dict(rtol=1e-4,
                                                    atol=1e-4)] * 4
# The launcher's losses move by 6.8e-5 in five steps (AdamWConfig()'s
# lr 3e-4 warms up over 100 steps), so GNN_LOSS_TOL would pass a frozen
# state: rtol 1e-6, about four float32 steps of 3.71, holds each step.
GNN_LAUNCHER_TOL = dict(rtol=1e-6, atol=0.0)
# The reduced config in float32 (TF32 off), card against CPU.
GNN_PARITY_TOL = dict(atol=1e-5, rtol=1e-5)

# tests/test_pipeline.py:38-43 of the JAX package: depth-1 goldens
GOLD_PL600 = {(5, 8): "9e8abe668aa53a74", (16, 8): "bbcd2f732e03af91",
              (16, 16): "e67c679d4029b7d0"}
GOLD_TINY = {2: "a102badbeab32296", 3: "b4293f255e72d527"}
GOLD_PL300 = "f821db1120c8d632"
GOLD_REDDIT = "13f232f653c9c752"
# pl600 (seed 0), computed with the JAX package on the CPU
GOLD_PL600_PATHS = {
    ("hype_batched", 16, (("t", 8),)): "2f2d37dfd52d5986",
    ("hype_batched", 16, (("preset", "quality"),)): "d3a01a34b9d175f4",
    ("hype_superstep", 16, (("t", 8), ("pipeline_depth", 1),
                            ("refine_passes", 3))): "852373b017ae7153",
    ("hype_superstep", 16, (("preset", "quality"),)): "8356b306cfe516d5",
    ("hype_multilevel", 8, ()): "0efce722e6a081e7",
    ("multilevel", 8, ()): "7c340e73e77b3aed",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def digest(a) -> str:
    import numpy as np
    return hashlib.sha256(
        np.ascontiguousarray(a, dtype=np.int32).tobytes()).hexdigest()[:16]


def flash_sass(so_path: str) -> dict:
    """What the built extension's flash kernels were compiled to: per
    kernel instance (bf16 tensor-core and float32 CUDA-core), the count of
    Hopper warpgroup MMA (HGMMA), warp MMA (HMMA) and float32 FMA (FFMA)
    instructions in ``cuobjdump -sass``. Raises if a bf16 instance has no
    HGMMA."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", so_path], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            fn = None
            for kind in ("flash_tc_kernel", "flash_attention_kernel"):
                if kind in name:
                    # the template argument: padded D, or float4 chunks
                    arg = name.split(kind + "ILi")[1].split("E")[0]
                    fn = f"{kind}<{arg}>"
                    counts[fn] = dict.fromkeys(("HGMMA", "HMMA", "FFMA"), 0)
        elif fn and "*/" in line:
            # "/*addr*/  [@P0] OPCODE.MODIFIERS operands ; /* encoding */"
            ops = [t for t in line.split("*/", 1)[1].split()
                   if not t.startswith("@")][:1]
            for key in counts[fn]:
                if ops and ops[0].split(".")[0] == key:
                    counts[fn][key] += 1
    tc = {k: v for k, v in counts.items() if k.startswith("flash_tc")}
    if not tc or any(v["HGMMA"] == 0 for v in tc.values()):
        raise SystemExit(f"the bf16 flash kernel has no HGMMA: {counts}")
    return counts


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int = 5, iters: int = 100, warmup: int = 10) -> float:
    """Median device time of one call over ``reps`` runs of ``iters``."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def graph_ms(fn, iters: int = 100) -> float:
    """Device time of one call with the host's launch cost out of the
    way: ``iters`` calls captured in one CUDA graph, the graph's replay
    timed by ``cuda_ms``, divided by ``iters``."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return cuda_ms(graph.replay, iters=1, warmup=2) / iters


def kernel_inputs(rng, G, R, L, s, P, kind):
    """Seeded score + select inputs on the card (numpy-made)."""
    import numpy as np
    import torch
    nbrs = rng.integers(0, 4 * L, size=(G, R, L)).astype(np.int32)
    nbrs[rng.random((G, R, L)) < 0.4] = -1
    fringe = np.full((G, s), -1, np.int32)
    fringe[:, : max(0, s - 1)] = rng.integers(0, 4 * L, size=(G, max(0, s - 1)))
    bias = np.zeros((G, R), np.float32)
    bias[:, R - 2:] = np.inf                       # pad rows
    prev = rng.integers(0, L, size=(G, P)).astype(np.float32)
    prev[rng.random((G, P)) < 0.3] = np.inf        # empty pool slots
    if kind == "hub":
        bias[rng.random((G, R)) < 0.3] = 1e12
    elif kind == "ties":
        nbrs = np.where(nbrs >= 0, 5, -1).astype(np.int32)
        prev[:] = float(np.count_nonzero(nbrs[0, 0] >= 0))
    elif kind == "pads":
        nbrs[:] = -1
        bias[:] = np.inf
        prev[:] = np.inf
    return [torch.from_numpy(a).cuda() for a in (nbrs, fringe, bias, prev)]


def max_abs_err(outs, refs) -> float:
    import torch
    err = 0.0
    for a, b in zip(outs, refs):
        if not torch.equal(a, b):
            d = torch.where(a == b, torch.zeros_like(a),
                            (a.double() - b.double()).abs().to(a.dtype))
            err = max(err, float(d.double().nan_to_num(float("inf")).max()))
    return err


def phase_kernel(ops, ref):
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    P, s, R, k = 64, 1, 16, 16
    cases = [(32, R, L, s, P, k, "random") for L in (32, 128, 512, 2048)]
    cases += [(32, R, 2048, s, P, k, "hub"), (32, R, 2048, s, P, k, "ties"),
              (32, R, 2048, s, P, k, "pads"),
              (1, R, 2048, 16, P, R + P, "ties"),
              (5, 8, 33, 3, P, 8 + P, "hub")]
    # shapes past the old limits, timed too: a fringe wider than the 16
    # register slots (shared memory), R + P slots past 48 KB (opted-in
    # shared memory) and past 227 KB (a global scratch), and a fringe that
    # no longer fits beside the slots (read from global memory)
    cases += [(32, R, 2048, 24, P, k, "wide"), (32, R, 2048, 64, P, k, "wide"),
              (4, R, 128, 16, 12_300, 40, "wide"),
              (3, R, 64, 3, 60_000, 40, "wide"),
              (2, R, 64, 2_000, 57_000, 12, "wide")]
    per_l, worst = {}, 0.0
    for G, R_, L, s_, P_, k_, kind in cases:
        x = kernel_inputs(rng, G, R_, L, s_, P_, kind)
        out = ops.hype_score_select(*x, select_k=k_)
        torch.cuda.synchronize()
        want = ref.hype_score_select_ref(*x, k_)
        err = max_abs_err(out, want)
        worst = max(worst, err)
        equal = all(torch.equal(a, b) for a, b in zip(out, want))
        row = {"phase": "kernel", "G": G, "R": R_, "L": L, "s": s_,
               "P": P_, "select_k": k_, "inputs": kind, "equal": equal,
               "max_abs_err": err}
        if kind in ("random", "wide"):
            nbytes = sum(t.nbytes for t in x) + sum(t.nbytes for t in out)
            # the plain version loops over the fringe in Python: one run
            # of it for the wide shapes
            few = {} if kind == "random" else dict(reps=1, iters=1, warmup=1)
            row.update(
                ms=cuda_ms(lambda: ops.hype_score_select(*x, select_k=k_)),
                plain_ms=cuda_ms(lambda: ref.hype_score_select_ref(*x, k_),
                                 **({"iters": 20} | few)),
                bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
            if kind == "random":
                per_l[L] = row
        emit(row)
        if not equal:
            raise SystemExit(f"kernel disagrees with its plain version: "
                             f"{row}")
    return per_l, worst


def compare_and_time(phase, fn, plain, x, row, timed, time_plain=True,
                     graph=False):
    """Run the kernel and its plain version on ``x``; emit and return the
    row (exact comparison, and times and the bytes bound when ``timed``;
    the plain version untimed when not ``time_plain``; the kernel also
    timed in a CUDA graph when ``graph``). Raises when they disagree."""
    import torch
    out = fn(*x)
    torch.cuda.synchronize()
    want = plain(*x)
    err = max_abs_err([out], [want])
    row = {"phase": phase, **row, "equal": torch.equal(out, want),
           "max_abs_err": err}
    if timed:
        nbytes = sum(t.nbytes for t in x) + out.nbytes
        row.update(ms=cuda_ms(lambda: fn(*x)), bytes=nbytes,
                   bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
        if graph:
            row["graph_ms"] = graph_ms(lambda: fn(*x))
        if time_plain:
            row["plain_ms"] = cuda_ms(lambda: plain(*x), iters=20)
    emit(row)
    if not row["equal"]:
        raise SystemExit(f"kernel disagrees with its plain version: {row}")
    return row


def phase_kernel_scores(ops, ref):
    """hype_scores at the batched engine's shapes (B in {64, 256}, every
    L bucket, s=16) and edge cases, against its plain version, timed
    eagerly (the host's launch included, as the engine calls it) and in a
    CUDA graph (the device alone), beside the launch floor: a one-element
    ``add_`` timed the same two ways. Fringe widths 1, 17, 32 and 33
    cross the kernel's register paths (s <= 16, s <= 32) and the
    shared-memory one. Returns the s=16 rows by (B, L), the floor row and
    the worst error."""
    import numpy as np
    import torch
    one = torch.zeros(1, device="cuda")
    floor = {"phase": "kernel_hype_scores", "launch_floor": "add_ of one "
             "float32 element", "ms": cuda_ms(lambda: one.add_(1.0)),
             "graph_ms": graph_ms(lambda: one.add_(1.0))}
    emit(floor)
    rng = np.random.default_rng(1)
    cases = [(B, L, 16, "random") for B in (64, 256)
             for L in (32, 128, 512, 2048)]
    cases += [(256, 2048, 16, "dup_fringe"), (64, 128, 16, "pads"),
              (33, 33, 3, "random"), (5, 128, 40, "dup_fringe"),
              (64, 2048, 1, "widths"), (256, 2048, 17, "widths"),
              (256, 2048, 32, "widths"), (256, 2048, 33, "widths"),
              (1, 2048, 16, "widths"), (256, 33, 32, "widths"),
              # past the old 48 KB fringe: opted-in shared memory, and
              # past 227 KB read from global memory
              (256, 2048, 16_384, "wide"), (64, 128, 60_000, "wide")]
    per_shape, worst = {}, 0.0
    for B, L, s, kind in cases:
        nbrs = rng.integers(0, 2 * L, size=(B, L)).astype(np.int32)
        nbrs[rng.random((B, L)) < 0.4] = -1
        if B > 1:
            nbrs[0] = -1                               # an all-pad row
        fringe = rng.choice(nbrs[nbrs >= 0], size=s).astype(np.int32)
        fringe[-1] = -1                                # a pad slot
        if kind == "dup_fringe":
            fringe[: s // 2] = fringe[0]
        elif kind == "pads":
            nbrs[:] = -1
        x = [torch.from_numpy(a).cuda() for a in (nbrs, fringe)]
        main = kind == "random" and s == 16 and L % 32 == 0
        row = compare_and_time(
            "kernel_hype_scores", ops.hype_scores, ref.hype_scores_ref, x,
            {"B": B, "L": L, "s": s, "inputs": kind},
            timed=(kind in ("random", "wide", "widths")) and L % 32 == 0,
            # the plain version loops over a wide fringe in Python (1.3 s
            # a call at s = 60,000): checked, not timed
            time_plain=kind != "wide", graph=main)
        worst = max(worst, row["max_abs_err"])
        if main:
            per_shape[(B, L)] = row
    return per_shape, floor, worst


def phase_kernel_kway(kops, kref):
    """kway_gains at the refinement screen's tile (B=4096, every L
    bucket, k in {2, 32, 67}) and edge cases, against its plain version."""
    import numpy as np
    import torch
    rng = np.random.default_rng(2)
    cases = [(4096, L, k) for L in (32, 128, 512, 2048) for k in (2, 32, 67)]
    cases += [(17, 33, 5), (8, 128, 1), (4096, 2048, 1024)]
    # past the old k <= 1,536: the opted-in shared histogram up to its
    # last k (7,264) and the global-scratch histogram beyond
    cases += [(4096, 512, 2048), (4096, 512, 7264), (4096, 512, 10_000)]
    per_shape, worst = {}, 0.0
    for B, L, k in cases:
        parts = rng.integers(0, k, size=(B, L)).astype(np.int32)
        hot = rng.integers(0, k, size=(B, 1))
        parts = np.where(rng.random((B, L)) < 0.6, hot, parts)
        parts[rng.random((B, L)) < 0.2] = -1
        own = rng.integers(0, k, size=B).astype(np.int32)
        parts[B - B // 8:] = -1                        # pad rows
        own[B - B // 8:] = -1
        x = [torch.from_numpy(a.astype(np.int32)).cuda()
             for a in (parts, own)]
        row = compare_and_time(
            "kernel_kway_gains", lambda p, o: kops.kway_gains(p, o, k=k),
            lambda p, o: kref.kway_gains_ref(p, o, k), x,
            {"B": B, "L": L, "k": k},
            timed=B == 4096 and (k in (2, 32, 67) or k >= 2048))
        worst = max(worst, row["max_abs_err"])
        if "ms" in row:
            per_shape[(L, k)] = row
    return per_shape, worst


def phase_goldens(partition, synth, Hypergraph):
    got = {}
    hg = synth.powerlaw_hypergraph(600, 400, seed=11, max_edge=30,
                                   max_degree=20)
    for (k, t), want in GOLD_PL600.items():
        got[f"pl600_k{k}_t{t}"] = (digest(partition(
            hg, k, "hype_superstep", device="cuda", t=t, pipeline_depth=1)),
            want)
    hg = synth.powerlaw_hypergraph(300, 500, seed=21, max_edge=10,
                                   max_degree=30)
    got["pl300_k24"] = (digest(partition(
        hg, 24, "hype_superstep", device="cuda", seed=1, pool_cap=16,
        pipeline_depth=1)), GOLD_PL300)
    hg = Hypergraph.from_edge_lists(6, [[0, 1], [1, 2, 3], []])
    for k, want in GOLD_TINY.items():
        got[f"tiny_k{k}"] = (digest(partition(
            hg, k, "hype_superstep", device="cuda", pipeline_depth=1)), want)
    got["reddit_k32_t16"] = (digest(partition(
        synth.reddit_like(0.005, seed=0), 32, "hype_superstep",
        device="cuda", t=16, pipeline_depth=1)), GOLD_REDDIT)
    hg = synth.powerlaw_hypergraph(600, 400, seed=11, max_edge=30,
                                   max_degree=20)
    for (method, k, knobs), want in GOLD_PL600_PATHS.items():
        name = "pl600_" + "_".join([method, f"k{k}"]
                                   + [f"{a}{b}" for a, b in knobs])
        got[name] = (digest(partition(hg, k, method, device="cuda",
                                      **dict(knobs))), want)
    bad = {name: pair for name, pair in got.items() if pair[0] != pair[1]}
    emit({"phase": "goldens", "checked": len(got), "mismatches": bad})
    if bad:
        raise SystemExit(f"golden digests differ: {bad}")


def run_slice(hg, depth, device, metrics, SuperstepParams, run):
    t0 = time.perf_counter()
    a, st = run(hg, 32, SuperstepParams(seed=0, t=16,
                                        pipeline_depth=depth),
                return_stats=True, device=device)
    wall = time.perf_counter() - t0
    sizes = metrics.partition_sizes(a, 32)
    if (a < 0).any() or sizes.max() - sizes.min() > 1:
        raise SystemExit("slice assignment is incomplete or unbalanced")
    return a, {"phase": "slice", "device": device, "depth": depth,
               "wall_s": wall, "host_s": st.host_s, "device_s": st.device_s,
               "supersteps": st.supersteps, "tile_l": st.tile_l,
               "stale_redraws": st.stale_redraws,
               "pipeline_stalls": st.pipeline_stalls,
               "k_minus_1": metrics.k_minus_1(hg, a, 32),
               "vertex_imbalance": metrics.vertex_imbalance(a, 32),
               "digest": digest(a)}


def phase_profile(label, fn):
    """Where the time goes in one path, from two more runs of it.

    Under torch.profiler: the card's busy time (kernels and copies,
    summed over device-side events only) and its largest consumers. Each
    run ends in a synchronize, so the wall time covers the card's work.
    Under cProfile: the host's cumulative seconds per function of the
    port (cProfile inflates Python-heavy code, so read the shares, not
    the sums).
    """
    import cProfile
    import pstats

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            dev[e.key[:60]] = dev.get(e.key[:60], 0) + e.self_device_time_total
    busy_s = sum(dev.values()) / 1e6
    top = dict(sorted(dev.items(), key=lambda kv: -kv[1])[:6])
    emit({"phase": "profile", "path": label, "wall_s": wall,
          "device_busy_s": busy_s, "device_idle_share": 1 - busy_s / wall,
          "top_device_us": top})

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    wall = time.perf_counter() - t0
    host = {}
    for (path, _, func), row in pstats.Stats(prof).stats.items():
        if "repro_torch" in path:
            host[func] = host.get(func, 0.0) + row[3]
    top = dict(sorted(host.items(), key=lambda kv: -kv[1])[:10])
    emit({"phase": "host_profile", "path": label,
          "wall_s_under_cprofile": wall, "cumulative_s": top})


def bag_case(bops, bref, table, ids, combine, row, timed):
    """One EmbeddingBag case: the kernel against its plain version
    (``torch.equal``); when ``timed``, the kernel's, the plain version's
    and ``F.embedding_bag``'s times, and the bytes bound (the valid rows,
    the ids and the output, each moved once)."""
    import torch
    import torch.nn.functional as F
    out = bops.embedding_bag(table, ids, combine=combine)
    torch.cuda.synchronize()
    want = bref.embedding_bag_ref(table, ids, combine)
    row = {"phase": "kernel_embedding_bag", **row,
           "dtype": str(table.dtype).removeprefix("torch."),
           "combine": combine, "rows": ids.shape[0], "bag": ids.shape[1],
           "D": table.shape[1], "equal": torch.equal(out, want),
           "max_abs_err": max_abs_err([out], [want])}
    if timed:
        valid = ids >= 0
        nbytes = (int(valid.sum()) * table.shape[1] * table.element_size()
                  + ids.nbytes + out.nbytes)
        flat, weights = ids.clamp_min(0).long(), valid.to(table.dtype)
        row.update(
            ms=cuda_ms(lambda: bops.embedding_bag(table, ids,
                                                  combine=combine)),
            plain_ms=cuda_ms(lambda: bref.embedding_bag_ref(table, ids,
                                                            combine),
                             iters=20),
            library_ms=cuda_ms(lambda: F.embedding_bag(
                flat, table, mode="sum", per_sample_weights=weights)),
            library_call="F.embedding_bag(mode='sum', per_sample_weights)",
            bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
    emit(row)
    if not row["equal"]:
        raise SystemExit(f"embedding_bag disagrees with its plain version: "
                         f"{row}")
    return row


def phase_kernel_bag(bops, bref, table, cfg):
    """EmbeddingBag on the card against its plain version: edge cases on
    small tables, ids near V-1 of the full-width table (fp32 and a bf16
    copy: row offsets past 2**32 elements), and the serving shapes on
    the full-width fp32 table, timed: batch x n_fields bag rows, 2,048
    at serve_p99 and 1,048,576 at serve_bulk, bag 8, D 256, mean."""
    import numpy as np
    import torch
    rng = np.random.default_rng(3)
    worst, timed = 0.0, {}
    small = [(1000, 256, 512, 8, "random"), (100, 33, 64, 5, "odd_d"),
             (50, 64, 40, 1, "bag1"), (300, 128, 17, 40, "wide_bag"),
             (200, 256, 64, 8, "duplicates"), (200, 256, 64, 8, "all_pad")]
    for V, D, B, bag, kind in small:
        t32 = torch.from_numpy(rng.normal(size=(V, D)).astype(np.float32))
        ids = rng.integers(-1, V, size=(B, bag)).astype(np.int32)
        if kind == "duplicates":
            ids[:, 1:] = ids[:, :1]
        elif kind == "all_pad":
            ids[::2] = -1
        ids = torch.from_numpy(ids).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            for combine in ("mean", "sum"):
                row = bag_case(bops, bref, t32.to(dtype).cuda(), ids,
                               combine, {"V": V, "inputs": kind}, False)
                worst = max(worst, row["max_abs_err"])
    V = table.shape[0]
    ids = (V - 1 - rng.integers(0, 4096, size=(4096, 8))).astype(np.int32)
    ids[0] = V - 1
    ids[rng.random(ids.shape) < 0.1] = -1
    ids = torch.from_numpy(ids).cuda()
    for dtype in (torch.float32, torch.bfloat16):
        t = table if dtype == table.dtype else table.to(dtype)
        for combine in ("mean", "sum"):
            row = bag_case(bops, bref, t, ids, combine,
                           {"V": V, "inputs": "ids_near_V-1"}, False)
            worst = max(worst, row["max_abs_err"])
        del t
    torch.cuda.empty_cache()
    for shape, B in SERVE_BATCHES.items():
        ids = torch.from_numpy(rng.integers(
            -1, V, size=(B * cfg.n_fields, cfg.bag_size)).astype(
                np.int32)).cuda()
        row = bag_case(bops, bref, table, ids, "mean",
                       {"V": V, "inputs": "random", "shape": shape}, True)
        worst = max(worst, row["max_abs_err"])
        timed[shape] = row
    return timed, worst


def serve_ids(rng, cfg, B):
    """A serving batch as the launcher draws it: ids in [-1, vocab)."""
    import numpy as np
    import torch
    shape = (B, cfg.n_fields, cfg.bag_size)
    return {name: torch.from_numpy(rng.integers(-1, vocab, shape).astype(
        np.int32)).cuda() for name, vocab in (("user_ids", cfg.user_vocab),
                                              ("item_ids", cfg.item_vocab))}


def wall_ms(fn, n: int) -> float:
    """Median host-clock ms of ``n`` synchronised calls, after one more."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_recsys_serve(recsys, bref, params, cfg, launches):
    """The serving path at full width through the entry points: each
    call is driven once with every launch count at 0 and must launch the
    EmbeddingBag kernel once per tower, then is repeated through the
    plain EmbeddingBag on the card and must give the same tensors."""
    import numpy as np
    import torch

    def through_plain(fn):
        kernel = recsys.bag_kernel
        recsys.bag_kernel = lambda t, i, combine: bref.embedding_bag_ref(
            t, i, combine)
        try:
            return fn()
        finally:
            recsys.bag_kernel = kernel

    def check(row, got, want, counts, need):
        row.update(launches=counts, expected_launches=need,
                   equal_to_plain_path=all(
                       torch.equal(a, b) for a, b in zip(got, want)),
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        emit(row)
        if not row["equal_to_plain_path"]:
            raise SystemExit(f"{row['path']} differs from the plain path")
        if {k: v for k, v in counts.items() if v} != need:
            raise SystemExit(f"{row['path']} launched {counts}, not {need}")
        if not all(bool(torch.isfinite(t.float()).all()) for t in got):
            raise SystemExit(f"{row['path']} gave non-finite values")

    rng = np.random.default_rng(0)
    with torch.inference_mode():
        for shape, B in SERVE_BATCHES.items():
            batch = serve_ids(rng, cfg, B)
            torch.cuda.reset_peak_memory_stats()
            s, _, counts = launches.drive(
                lambda: recsys.score_batch(params, batch, cfg))
            torch.cuda.synchronize()
            want = through_plain(lambda: recsys.score_batch(params, batch,
                                                            cfg))
            iters = 100 if B <= 512 else 5
            flat = {k: v.reshape(-1, cfg.bag_size) for k, v in batch.items()}
            row = {"phase": "recsys_serve", "path": f"score_batch_{shape}",
                   "batch": B, "wall_ms": wall_ms(
                       lambda: recsys.score_batch(params, batch, cfg),
                       20 if B <= 512 else 5),
                   # where the time goes, in CUDA events (the profiler
                   # rows below may miss device events): the whole call
                   # and its two bags, back to back
                   "device_ms": cuda_ms(lambda: recsys.score_batch(
                       params, batch, cfg), iters=iters),
                   "bags_ms": cuda_ms(lambda: [recsys.bag_kernel(
                       params[f"{side}_table"], flat[f"{side}_ids"])
                       for side in ("user", "item")], iters=iters)}
            if s.shape != (B,):
                raise SystemExit(f"score_batch gave {tuple(s.shape)}")
            check(row, [s], [want], counts, {"embedding_bag": 2})
            phase_profile(f"score_batch_{shape}", lambda: recsys.score_batch(
                params, batch, cfg))

        gen = torch.Generator(device="cuda").manual_seed(1)
        cands = torch.randn((RETRIEVE_N_CAND, cfg.tower_dims[-1]),
                            generator=gen, device="cuda")
        cands /= torch.linalg.vector_norm(cands, dim=-1, keepdim=True)
        batch = {"user_ids": serve_ids(rng, cfg, 1)["user_ids"],
                 "cand_embs": cands}
        torch.cuda.reset_peak_memory_stats()
        (v, i), _, counts = launches.drive(lambda: recsys.retrieve(
            params, batch, cfg, top_k=RETRIEVE_TOP_K))
        want = through_plain(lambda: recsys.retrieve(
            params, batch, cfg, top_k=RETRIEVE_TOP_K))
        u = recsys.tower(params["user_tower"], params["user_table"],
                         batch["user_ids"], cfg)
        top = torch.topk((u @ cands.T)[0], RETRIEVE_TOP_K).values
        scores = (u @ cands.T)[0]
        row = {"phase": "recsys_serve", "path": "retrieve_retrieval_cand",
               "n_cand": RETRIEVE_N_CAND, "top_k": RETRIEVE_TOP_K,
               "values_equal_topk": torch.equal(v, top),
               "indices_distinct": int(i.unique().numel()),
               "wall_ms": wall_ms(lambda: recsys.retrieve(
                   params, batch, cfg, top_k=RETRIEVE_TOP_K), 10),
               "device_ms": cuda_ms(lambda: recsys.retrieve(
                   params, batch, cfg, top_k=RETRIEVE_TOP_K), iters=20),
               "tower_ms": cuda_ms(lambda: recsys.tower(
                   params["user_tower"], params["user_table"],
                   batch["user_ids"], cfg), iters=20),
               "cand_matmul_ms": cuda_ms(lambda: u @ cands.T, iters=20),
               "top_k_ms": cuda_ms(lambda: recsys.ordered_top_k(
                   scores, RETRIEVE_TOP_K), iters=20)}
        if not row["values_equal_topk"] or row["indices_distinct"] != \
                RETRIEVE_TOP_K:
            raise SystemExit(f"retrieve's top-k is wrong: {row}")
        check(row, [v, i], list(want), counts, {"embedding_bag": 1})
        phase_profile("retrieve_retrieval_cand", lambda: recsys.retrieve(
            params, batch, cfg, top_k=RETRIEVE_TOP_K))


def phase_recsys_parity(recsys, convert, cfg):
    """The reduced config from numpy params: the card (the kernel)
    against the CPU (the plain version), within PARITY_TOL; top-k
    indices equal except between scores that tie within it."""
    import numpy as np
    import torch
    rng = np.random.default_rng(5)
    dims = (cfg.n_fields * cfg.embed_dim,) + tuple(cfg.tower_dims[1:])

    def tower():
        p = {f"w{i}": rng.normal(size=(dims[i], dims[i + 1])) /
             np.sqrt(dims[i]) for i in range(len(dims) - 1)}
        p.update({f"b{i}": rng.normal(size=dims[i + 1]) * 0.1
                  for i in range(len(dims) - 1)})
        return p

    tree = {"user_table": rng.normal(size=(cfg.user_vocab,
                                           cfg.embed_dim)) * 0.02,
            "item_table": rng.normal(size=(cfg.item_vocab,
                                           cfg.embed_dim)) * 0.02,
            "user_tower": tower(), "item_tower": tower()}
    shape = (512, cfg.n_fields, cfg.bag_size)
    ids = {name: rng.integers(-1, vocab, shape).astype(np.int32)
           for name, vocab in (("user_ids", cfg.user_vocab),
                               ("item_ids", cfg.item_vocab))}
    cands = rng.normal(size=(2048, cfg.tower_dims[-1])).astype(np.float32)
    out = {}
    with torch.inference_mode():
        for dev in ("cuda", "cpu"):
            params = convert.twotower_params_from_numpy(tree, cfg, dev)
            batch = {k: torch.from_numpy(v).to(dev) for k, v in ids.items()}
            s = recsys.score_batch(params, batch, cfg)
            q = {"user_ids": batch["user_ids"][:1],
                 "cand_embs": torch.from_numpy(cands).to(dev)}
            v, i = recsys.retrieve(params, q, cfg, top_k=128)
            u = recsys.tower(params["user_tower"], params["user_table"],
                             q["user_ids"], cfg)
            full = (u @ q["cand_embs"].T)[0]
            out[dev] = [t.cpu().numpy() for t in (s, v, i, full)]
    (s_g, v_g, i_g, _), (s_c, v_c, i_c, full_c) = out["cuda"], out["cpu"]
    ok = (np.allclose(s_g, s_c, **PARITY_TOL)
          and np.allclose(v_g, v_c, **PARITY_TOL))
    swapped = np.flatnonzero(i_g != i_c)
    ok = ok and np.allclose(full_c[i_g[swapped]], full_c[i_c[swapped]],
                            **PARITY_TOL)
    row = {"phase": "recsys_parity", "config": "two-tower-retrieval reduced",
           "batch": 512, "n_cand": 2048, "top_k": 128, "tol": PARITY_TOL,
           "score_max_abs_diff": float(np.abs(s_g - s_c).max()),
           "topk_value_max_abs_diff": float(np.abs(v_g - v_c).max()),
           "topk_swapped_near_ties": int(swapped.size), "ok": bool(ok)}
    emit(row)
    if not ok:
        raise SystemExit(f"reduced two-tower differs card vs cpu: {row}")


def phase_placement(pe):
    """HYPE row placement of benchmarks/bench_beyond_paper.py's co-access
    log (the same numpy calls), against JAX's digest; mean shards
    touched and remote fraction under affinity routing for HYPE and the
    hash placement. Host work."""
    import numpy as np
    vocab, n_queries, bag, k = 8192, 4000, 16, 8
    rng = np.random.default_rng(0)
    centers = rng.integers(0, vocab, n_queries)
    queries = [np.unique((centers[i] + rng.geometric(0.05, bag)) % vocab)
               for i in range(n_queries)]
    t0 = time.perf_counter()
    asg = pe.partition_rows_hype(vocab, queries, k, seed=0)
    host_s = time.perf_counter() - t0
    row = {"phase": "placement", "vocab": vocab, "queries": n_queries,
           "bag": bag, "k": k, "host_s": host_s, "digest": digest(asg),
           "expected_digest": PLACEMENT_DIGEST}
    hashed = (np.arange(vocab) * 2654435761 % vocab % k).astype(np.int32)
    for name, a in (("hype", asg), ("hash", hashed)):
        pl = pe.RowPlacement.from_assignment(a, k)
        touched, remote = [], []
        for q in queries:
            counts = np.bincount(pl.owner[q], minlength=k)
            touched.append(int((counts > 0).sum()))
            remote.append(1.0 - counts.max() / max(counts.sum(), 1))
        row[name] = {"shards_touched": float(np.mean(touched)),
                     "remote_frac": float(np.mean(remote)),
                     "expected": PLACEMENT_JAX[name]}
    emit(row)
    if row["digest"] != PLACEMENT_DIGEST or any(
            (row[n]["shards_touched"], row[n]["remote_frac"])
            != PLACEMENT_JAX[n] for n in PLACEMENT_JAX):
        raise SystemExit(f"placement differs from the JAX package: {row}")


def run_recsys(launches, bops, bref):
    """The two-tower serving slice: full-width tables drawn on the card,
    the EmbeddingBag kernel phase on them, the serving paths, the serve
    launcher (after the tables are freed), the reduced parity run and
    the placement. Returns the kernel's timed rows and its worst error."""
    import torch

    from repro_torch import convert
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import recsys
    from repro_torch.placement import partitioned_embedding as pe

    arch = get_arch("two-tower-retrieval")
    cfg = arch.build_cfg()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = recsys.init_twotower_params(gen, cfg, "cuda")
    torch.cuda.synchronize()
    emit({"phase": "recsys_setup", "config": "two-tower-retrieval",
          "embed_dim": cfg.embed_dim, "tower_dims": cfg.tower_dims,
          "n_fields": cfg.n_fields, "bag_size": cfg.bag_size,
          "user_vocab": cfg.user_vocab, "item_vocab": cfg.item_vocab,
          "param_gb": sum(t.nbytes for t in (
              [params["user_table"], params["item_table"]]
              + list(params["user_tower"].values())
              + list(params["item_tower"].values()))) / 1e9,
          "init_s": time.perf_counter() - t0})
    timed, worst = phase_kernel_bag(bops, bref, params["user_table"], cfg)
    phase_recsys_serve(recsys, bref, params, cfg, launches)
    del params
    torch.cuda.empty_cache()
    s, wall, counts = launches.drive(lambda: serve.main(
        ["--arch", "two-tower-retrieval", "--batch", "512"]))
    row = {"phase": "recsys_serve", "path": "launch.serve --batch 512",
           "wall_s": wall, "launches": counts}
    emit(row)
    if {k: v for k, v in counts.items() if v} != {"embedding_bag": 2}:
        raise SystemExit(f"the serve launcher launched {counts}")
    torch.cuda.empty_cache()
    phase_recsys_parity(recsys, convert, arch.build_cfg(reduced=True))
    phase_placement(pe)
    return timed, worst


def attention_bound(B, S, Hq, Hkv, D):
    """(FLOPs, bytes, bound ms) of one causal bf16 attention call: 4 D
    FLOP (QK^T and PV) per unmasked (query, key) pair, S (S + 1) / 2 of
    them per batch row and q-head, at the bf16 tensor-core peak; q, k
    and v read once and the output written once. The bound is the
    larger of the two times."""
    flops = 4 * B * Hq * D * (S * (S + 1) // 2)
    nbytes = (2 * Hq + 2 * Hkv) * B * S * D * 2
    bound_ms = max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
    return flops, nbytes, bound_ms


def attention_rows_plain(q, k, v, start):
    """The plain version's formula (kernels/flash_attention/ref.py),
    causal, for query rows start..S-1 only: (B, S - start, Hq, D)."""
    import torch
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q[:, start:].reshape(B, S - start, Hkv, Hq // Hkv, D)
    scores = torch.einsum("bshgd,bthd->bhgst", qg.float(),
                          k.float()) / math.sqrt(D)
    i = torch.arange(start, S, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    probs = torch.softmax(torch.where(j <= i, scores, -1e30), dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v.float())
    return out.reshape(B, S - start, Hq, D).to(q.dtype)


def flash_check(out, want, v, dtype):
    """The row fields of one flash comparison under FLASH_TOL: the worst
    and mean error, the limits and whether both hold (bf16: the worst case
    with atol widened by 2**-8 max|v|, and the mean error against 2**-8 of
    the mean |ref|; float32: the worst case alone)."""
    import torch
    d = (out.float() - want.float()).abs()
    row = {"max_abs_err": float(d.max()), "mean_abs_err": float(d.mean()),
           "mean_abs_ref": float(want.float().abs().mean())}
    tol = dict(FLASH_TOL[dtype])
    if dtype == "bfloat16":
        tol["atol"] += FLASH_P_ULP * float(v.float().abs().max())
        row["mean_limit"] = FLASH_P_ULP * row["mean_abs_ref"]
    row["tol"] = tol
    row["close"] = bool(torch.allclose(out.float(), want.float(), **tol)) \
        and row["mean_abs_err"] <= row.get("mean_limit", math.inf)
    return row


def phase_kernel_flash(fops, fref):
    """flash_attention on the card against its plain version (FLASH_TOL):
    the shapes of tests/test_kernels.py in fp32 and bf16, non-causal, a
    window, D in {16, 32, 64, 80, 128, 192, 256}, Hkv = 1, ragged S, and
    the full-width layer shape
    of qwen3-8b (B=8, S=4096, 32 q-heads, 8 kv-heads, D=128, bf16),
    compared one sequence at a time so the plain scores stay at 2.1 GB.
    Timed there and at B=1, S=32,768, beside
    F.scaled_dot_product_attention; at S=32,768 the plain version is
    neither run whole nor timed (its scores would be 137 GB), and the last
    LONG_CHECK_ROWS query rows of every head are compared with its
    formula."""
    import torch
    import torch.nn.functional as F
    cases = [(B, S, Hq, Hkv, D, True, w, dt)
             for dt in ("float32", "bfloat16")
             for B, S, Hq, Hkv, D, w in (
                 (2, 128, 4, 4, 64, None), (1, 256, 8, 2, 64, None),
                 (2, 256, 4, 4, 32, 64), (1, 128, 2, 1, 128, None))]
    cases += [(1, 128, 2, 2, 32, False, None, "float32"),
              (2, 256, 4, 2, 64, False, 48, "float32"),
              (1, 512, 8, 2, 128, True, 100, "bfloat16"),
              (2, 256, 8, 2, 80, True, None, "float32"),
              (2, 256, 8, 2, 80, True, None, "bfloat16"),
              (2, 100, 4, 2, 128, True, None, "float32"),
              (1, 1000, 8, 2, 128, True, None, "bfloat16"),
              (1, 1000, 4, 1, 64, True, 256, "float32"),
              (3, 1, 4, 4, 16, True, None, "float32"),
              (3, 1, 4, 4, 16, True, None, "bfloat16"),
              (2, 333, 4, 2, 8, False, None, "bfloat16"),
              (1, 300, 4, 1, 192, True, None, "bfloat16"),
              (1, 300, 4, 1, 256, True, 77, "bfloat16"),
              (1, 70, 2, 1, 256, False, 33, "bfloat16")]
    worst = 0.0
    gen = torch.Generator(device="cuda").manual_seed(4)

    def inputs(B, S, Hq, Hkv, D, dtype):
        return [torch.randn((B, S, h, D), device="cuda",
                            generator=gen).to(getattr(torch, dtype))
                for h in (Hq, Hkv, Hkv)]

    for B, S, Hq, Hkv, D, causal, window, dtype in cases:
        x = inputs(B, S, Hq, Hkv, D, dtype)
        out = fops.flash_attention(*x, causal=causal, window=window)
        torch.cuda.synchronize()
        want = fref.attention_ref(*x, causal=causal, window=window)
        row = {"phase": "kernel_flash_attention", "B": B, "S": S, "Hq": Hq,
               "Hkv": Hkv, "D": D, "causal": causal, "window": window,
               "dtype": dtype, **flash_check(out, want, x[2], dtype)}
        worst = max(worst, row["max_abs_err"])
        emit(row)
        if not row["close"]:
            raise SystemExit(f"flash_attention disagrees with its plain "
                             f"version: {row}")

    timed = {}
    for name, (B, S) in (("layer", (LM_BATCH, LM_PROMPT)),
                         ("long", (1, LM_LONG_SEQ))):
        Hq, Hkv, D = 32, 8, 128
        x = inputs(B, S, Hq, Hkv, D, "bfloat16")
        row = {"phase": "kernel_flash_attention", "shape": name, "B": B,
               "S": S, "Hq": Hq, "Hkv": Hkv, "D": D, "causal": True,
               "window": None, "dtype": "bfloat16"}
        out = fops.flash_attention(*x)
        torch.cuda.synchronize()
        if name == "layer":
            checks = []
            for b in range(B):
                xb = [t[b:b + 1] for t in x]
                want = fref.attention_ref(*xb)
                checks.append(flash_check(out[b:b + 1], want, x[2],
                                          "bfloat16"))
                del want
            # equal-sized sequences: the mean of the means is the mean
            mean_err = statistics.fmean(c["mean_abs_err"] for c in checks)
            mean_ref = statistics.fmean(c["mean_abs_ref"] for c in checks)
            row.update(max_abs_err=max(c["max_abs_err"] for c in checks),
                       mean_abs_err=mean_err, mean_abs_ref=mean_ref,
                       mean_limit=FLASH_P_ULP * mean_ref,
                       tol=checks[0]["tol"],
                       close=all(c["close"] for c in checks),
                       compared="one sequence at a time")
            worst = max(worst, row["max_abs_err"])
        else:
            if not bool(torch.isfinite(out.float()).all()):
                raise SystemExit(f"flash_attention at S={S} gave non-finite "
                                 f"values")
            start = S - LONG_CHECK_ROWS
            want = attention_rows_plain(*x, start)
            got = out[:, start:]
            row.update(**flash_check(got, want, x[2], "bfloat16"),
                       compared=f"query rows {start}..{S - 1} of every head")
            worst = max(worst, row["max_abs_err"])
            del want, got
        del out
        flops, nbytes, bound_ms = attention_bound(B, S, Hq, Hkv, D)
        iters = 5 if name == "layer" else 2
        row.update(ms=cuda_ms(lambda: fops.flash_attention(*x), reps=3,
                              iters=iters, warmup=2),
                   flops=flops, bytes=nbytes, bound_ms=bound_ms,
                   bound_by="operations")
        row["tflops"] = flops / row["ms"] / 1e9
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in x)
        row.update(library_ms=cuda_ms(
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), reps=3,
            iters=iters, warmup=2),
            library_call="F.scaled_dot_product_attention(is_causal=True, "
                         "enable_gqa=True) on (B, H, S, D) copies")
        del qt, kt, vt
        if name == "layer":
            torch.cuda.empty_cache()
            row["plain_ms"] = cuda_ms(lambda: fref.attention_ref(*x),
                                      reps=3, iters=1, warmup=1)
        emit(row)
        if not row["close"]:
            raise SystemExit(f"flash_attention disagrees with its plain "
                             f"version at full width: {row}")
        timed[name] = row
        del x
        torch.cuda.empty_cache()
    return timed, worst


def phase_lm_serve(tf, launches):
    """qwen3-8b at full width (bf16, params drawn on the card): prefill of
    B=8 prompts of 4,096 tokens (a warm-up, then timed), then 16 greedy
    serve_steps on that cache, unpadded, as the serve launcher decodes.
    Each prefill must launch the kernel once per layer, decode never."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch

    cfg = get_arch(LM_ARCH).build_cfg()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tf.init_params(gen, cfg, "cuda")
    torch.cuda.synchronize()
    leaves = [params["embed"], params["lm_head"], params["ln_f"],
              *params["layers"].values()]
    emit({"phase": "lm_setup", "config": LM_ARCH, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "n_heads": cfg.n_heads,
          "n_kv_heads": cfg.n_kv_heads, "d_head": cfg.d_head,
          "d_ff": cfg.d_ff, "vocab": cfg.vocab,
          "dtype": str(cfg.dtype).removeprefix("torch."),
          "params": sum(t.numel() for t in leaves),
          "params_dense": cfg.params_dense,
          "param_gb": sum(t.nbytes for t in leaves) / 1e9,
          "init_s": time.perf_counter() - t0})
    # params_dense (the JAX package's count) leaves out the qk-norm scales
    qk = 2 * cfg.n_layers * cfg.d_head if cfg.qk_norm else 0
    if sum(t.numel() for t in leaves) != cfg.params_dense + qk:
        raise SystemExit(f"{LM_ARCH} params differ from params_dense")
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT)).astype(np.int32)).cuda()

    def run_prefill():
        out = tf.prefill(params, prompts, cfg)
        torch.cuda.synchronize()
        return out

    def greedy(logits):
        return torch.argmax(logits, -1)[:, None].to(torch.int32)

    need = {"flash_attention": cfg.n_layers}
    with torch.inference_mode():
        for label in ("prefill_warmup", "prefill"):
            torch.cuda.reset_peak_memory_stats()
            (cache, logits), wall, counts = launches.drive(run_prefill)
            row = {"phase": "lm_serve", "path": label,
                   "batch": LM_BATCH, "prompt_len": LM_PROMPT,
                   "wall_s": wall, "tokens_per_s": LM_BATCH * LM_PROMPT / wall,
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "cache_gb": (cache["k"].nbytes + cache["v"].nbytes) / 1e9,
                   "launches": counts, "expected_launches": need}
            emit(row)
            if {k: v for k, v in counts.items() if v} != need:
                raise SystemExit(f"{label} launched {counts}, not {need}")
        if logits.shape != (LM_BATCH, cfg.vocab) or not bool(
                torch.isfinite(logits.float()).all()):
            raise SystemExit(f"prefill logits {tuple(logits.shape)} are not "
                             f"finite ({LM_BATCH}, {cfg.vocab})")
        prefill_cache_pos = cache["pos"]

        def decode():
            nonlocal cache, logits
            toks, step_s = [greedy(logits)], []
            for _ in range(LM_STEPS):
                t0 = time.perf_counter()
                logits, cache = tf.serve_step(params, cache, toks[-1], cfg)
                toks.append(greedy(logits))
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
            return torch.cat(toks, 1), step_s

        torch.cuda.reset_peak_memory_stats()
        (toks, step_s), wall, counts = launches.drive(decode)
        step_ms = statistics.median(step_s) * 1e3
        row = {"phase": "lm_serve", "path": "decode", "batch": LM_BATCH,
               "cache_len": LM_PROMPT, "steps": LM_STEPS, "wall_s": wall,
               "step_ms_median": step_ms,
               "step_ms_first": step_s[0] * 1e3,
               "tokens_per_s": LM_BATCH / (step_ms / 1e3),
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "pos": cache["pos"], "launches": counts,
               "expected_launches": {}}
        emit(row)
        if any(counts.values()):
            raise SystemExit(f"decode launched {counts}; it runs no kernel")
        if (cache["pos"] != prefill_cache_pos + LM_STEPS
                or toks.shape != (LM_BATCH, LM_STEPS + 1)
                or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab
                or not bool(torch.isfinite(logits.float()).all())):
            raise SystemExit(f"decode gave bad tokens or logits: {row}")
        step = {"k": cache["k"], "v": cache["v"], "pos": cache["pos"]}
        phase_profile("lm_prefill", run_prefill)
        phase_profile("lm_decode_step", lambda: tf.serve_step(
            params, dict(step), toks[:, -1:], cfg))


def phase_lm_parity(tf, convert, cfg):
    """The reduced qwen3-8b config in float32 from numpy params, card (the
    kernel; TF32 off) against CPU (the plain version): prefill logits and
    LM_PARITY_STEPS decode steps' logits within LM_PARITY_TOL on the
    unpadded cache, and equal greedy tokens."""
    import dataclasses as dc

    import numpy as np
    import torch
    cfg = dc.replace(cfg, dtype=torch.float32)
    rng = np.random.default_rng(6)
    tree = {"embed": rng.normal(size=(cfg.vocab, cfg.d_model)) * 0.02,
            "lm_head": rng.normal(size=(cfg.d_model, cfg.vocab))
            / np.sqrt(cfg.d_model),
            "ln_f": 1 + 0.1 * rng.normal(size=cfg.d_model),
            "layers": {name: (1 + 0.1 * rng.normal(size=(cfg.n_layers,)
                                                    + shape))
                       if len(shape) == 1 else
                       rng.normal(size=(cfg.n_layers,) + shape)
                       / np.sqrt(shape[0])
                       for name, shape in tf.layer_shapes(cfg).items()}}
    prompts = rng.integers(0, cfg.vocab, (4, 40)).astype(np.int32)
    out = {}
    with torch.inference_mode():
        for dev in ("cuda", "cpu"):
            params = convert.transformer_params_from_numpy(tree, cfg, dev)
            cache, logits = tf.prefill(params, torch.from_numpy(prompts).to(
                dev), cfg)
            logs, toks = [logits], [logits.argmax(-1)]
            for _ in range(LM_PARITY_STEPS):
                logits, cache = tf.serve_step(
                    params, cache, toks[-1][:, None].to(torch.int32), cfg)
                logs.append(logits)
                toks.append(logits.argmax(-1))
            out[dev] = (torch.stack(logs).cpu().numpy(),
                        torch.stack(toks).cpu().numpy())
    (lg, tg), (lc, tc) = out["cuda"], out["cpu"]
    ok = bool(np.allclose(lg, lc, **LM_PARITY_TOL)
              and np.array_equal(tg, tc))
    row = {"phase": "lm_parity", "config": f"{LM_ARCH} reduced, float32",
           "batch": 4, "prompt_len": 40, "steps": LM_PARITY_STEPS,
           "tf32": torch.backends.cuda.matmul.allow_tf32,
           "tol": LM_PARITY_TOL,
           "prefill_max_abs_diff": float(np.abs(lg[0] - lc[0]).max()),
           "decode_max_abs_diff": float(np.abs(lg[1:] - lc[1:]).max()),
           "logit_scale": float(np.abs(lc).max()),
           "tokens_equal": bool(np.array_equal(tg, tc)), "ok": ok}
    emit(row)
    if not ok:
        raise SystemExit(f"reduced LM differs card vs cpu: {row}")


def phase_lm_parity_bf16(tf, convert, cfg, launches):
    """The reduced qwen3-8b config in bfloat16 from numpy params (the
    dtype of the full-width serving path), card (the tensor-core kernel)
    against CPU (the plain version): prefill logits and LM_PARITY_STEPS
    decode steps' logits within LM_BF16_PARITY_TOL, both sides fed the
    CPU's greedy tokens; the card's greedy token equal to the CPU's
    wherever the CPU's top two logits lie more than 2 atol apart. The
    card's prefill must launch the kernel once per layer."""
    import numpy as np
    import torch
    rng = np.random.default_rng(7)
    tree = {"embed": rng.normal(size=(cfg.vocab, cfg.d_model)) * 0.02,
            "lm_head": rng.normal(size=(cfg.d_model, cfg.vocab))
            / np.sqrt(cfg.d_model),
            "ln_f": 1 + 0.1 * rng.normal(size=cfg.d_model),
            "layers": {name: (1 + 0.1 * rng.normal(size=(cfg.n_layers,)
                                                    + shape))
                       if len(shape) == 1 else
                       rng.normal(size=(cfg.n_layers,) + shape)
                       / np.sqrt(shape[0])
                       for name, shape in tf.layer_shapes(cfg).items()}}
    # 200 tokens: two query tiles of the kernel, a ragged last one
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (4, 200)).astype(np.int32))
    out, counts = {}, None
    with torch.inference_mode():
        for dev in ("cpu", "cuda"):
            params = convert.transformer_params_from_numpy(tree, cfg, dev)
            (cache, logits), _, c = launches.drive(
                lambda: tf.prefill(params, prompts.to(dev), cfg))
            if dev == "cuda":
                counts = c
            logs = [logits.float().cpu()]
            for step in range(LM_PARITY_STEPS):
                tok = (out["cpu"][1][step] if dev == "cuda"
                       else logs[-1].argmax(-1))
                logits, cache = tf.serve_step(
                    params, cache, tok[:, None].to(torch.int32).to(dev), cfg)
                logs.append(logits.float().cpu())
            logs = torch.stack(logs).numpy()
            out[dev] = (logs, [torch.from_numpy(lg.argmax(-1))
                               for lg in logs])
    lc, lg = out["cpu"][0], out["cuda"][0]
    tol = LM_BF16_PARITY_TOL
    top2 = np.sort(lc, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * tol["atol"]
    tok_c, tok_g = lc.argmax(-1), lg.argmax(-1)
    need = {"flash_attention": cfg.n_layers}
    ok = bool(np.allclose(lg, lc, **tol)
              and np.array_equal(tok_g[clear], tok_c[clear])
              and {k: v for k, v in counts.items() if v} == need)
    row = {"phase": "lm_parity_bf16", "config": f"{LM_ARCH} reduced, bf16",
           "batch": 4, "prompt_len": 200, "steps": LM_PARITY_STEPS,
           "tol": tol, "max_abs_diff": float(np.abs(lg - lc).max()),
           "prefill_max_abs_diff": float(np.abs(lg[0] - lc[0]).max()),
           "mean_abs_diff": float(np.abs(lg - lc).mean()),
           "logit_scale": float(np.abs(lc).max()),
           "tokens_compared": int(clear.sum()),
           "tokens_equal": bool(np.array_equal(tok_g[clear], tok_c[clear])),
           "launches": counts, "expected_launches": need, "ok": ok}
    emit(row)
    if not ok:
        raise SystemExit(f"reduced bf16 LM differs card vs cpu: {row}")


def run_lm(launches, fops, fref):
    """The LM serving slice: the flash-attention kernel phase, qwen3-8b
    at full width through prefill and decode, the serve launcher with its
    defaults, and the reduced config card against CPU. Returns the
    kernel's timed rows and its worst error."""
    import torch

    from repro_torch import convert
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf

    # float32 matmuls in full float32 (the parity phase's premise)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    emit({"phase": "lm_memory", "allocated_gb":
          torch.cuda.memory_allocated() / 1e9,
          "free_gb": torch.cuda.mem_get_info()[0] / 1e9})
    timed, worst = phase_kernel_flash(fops, fref)
    phase_lm_serve(tf, launches)
    torch.cuda.empty_cache()
    toks, wall, counts = launches.drive(lambda: serve.main(
        ["--arch", LM_ARCH]))
    need = {"flash_attention": get_arch(LM_ARCH).build_cfg().n_layers}
    row = {"phase": "lm_serve", "path": f"launch.serve --arch {LM_ARCH}",
           "wall_s": wall, "tokens_shape": list(toks.shape),
           "launches": counts, "expected_launches": need}
    emit(row)
    if {k: v for k, v in counts.items() if v} != need:
        raise SystemExit(f"the serve launcher launched {counts}")
    torch.cuda.empty_cache()
    reduced = get_arch(LM_ARCH).build_cfg(reduced=True)
    phase_lm_parity(tf, convert, reduced)
    phase_lm_parity_bf16(tf, convert, reduced, launches)
    return timed, worst

# ------------------------------------------------------------------- GNN

def gnn_source(meta, graphs):
    """The reddit-scale source graph, its features and labels, on the host:
    ``random_graph`` over ``graph_nodes`` with ``graph_edges / graph_nodes``
    edges a node (seed 0), then, as tests/test_gnn_training.py:54-57 makes
    them, 41 class prototypes and features ``proto[label] + 0.3 noise``
    (seed 0). ``graphs`` is the port's data.graphs module or the JAX
    package's; both give the same arrays."""
    import numpy as np
    n = meta["graph_nodes"]
    src, dst = graphs.random_graph(n, meta["graph_edges"] / n, seed=0)
    rng = np.random.default_rng(0)
    proto = rng.normal(size=(meta["n_classes"], meta["d_feat"])).astype(
        np.float32)
    labels = rng.integers(0, meta["n_classes"], n).astype(np.int32)
    feats = (proto[labels] + rng.normal(size=(n, meta["d_feat"])) * 0.3
             ).astype(np.float32)
    return src, dst, feats, labels


def gnn_sample(sampler, meta, feats, labels, step):
    """The padded batch of one step: ``batch_nodes`` seeds drawn without
    replacement and sampled with ``fanout``, from a generator seeded by
    the step alone, so a replayed step gets the same batch."""
    import numpy as np
    rng = np.random.default_rng([1, step])
    seeds = rng.choice(meta["graph_nodes"], meta["batch_nodes"],
                       replace=False)
    return sampler.sample_padded(seeds, meta["fanout"], rng,
                                 max_nodes=meta["nodes"],
                                 max_edges=meta["edges"], features=feats,
                                 labels=labels)


def gnn_numpy_params(shapes, seed: int = 0):
    """Params as numpy float32: every weight ``normal / sqrt(fan_in)``,
    drawn in JAX's flatten order (sorted keys, lists in order), every bias
    zero, as ``mlp_init`` scales them; ``shapes`` is the param tree with a
    shape tuple at each leaf. The model casts them to bfloat16."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if len(node) == 1:
            return np.zeros(node, np.float32)
        return (rng.normal(size=node) / np.sqrt(node[0])).astype(np.float32)

    return walk(shapes)


def neighbor_agg_bound(x, nbrs, w, out_itemsize, with_mean):
    """(FLOPs, bytes, bound ms, bound_by) of one forward: the rows of x that
    valid slots name, read once, nbrs and w read once, the output (and the
    float32 mean, when training asks for it) written once; one add per
    valid slot and element, 2 D F FLOP for the product of each row with
    a valid slot (a row without one has a zero mean and output)."""
    import torch
    B, K = nbrs.shape
    D, F = w.shape
    valid = nbrs[nbrs >= 0]
    rows = int(torch.unique(valid).numel())
    live = int(((nbrs >= 0).sum(1) > 0).sum())
    nbytes = (rows * D * x.element_size() + nbrs.numel() * 4
              + w.numel() * w.element_size() + B * F * out_itemsize
              + (B * D * 4 if with_mean else 0))
    flops = int(valid.numel()) * D + 2 * live * D * F
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return flops, nbytes, max(t_ops, t_bytes) * 1e3, (
        "operations" if t_ops > t_bytes else "bytes")


def neighbor_agg_bwd_bound(g, nbrs, n_rows, out_itemsize):
    """The same for the backward kernel: the rows of g with a valid slot,
    the counts, the transposed index (N + 1 offsets, one int32 per valid
    slot) read once, grad_x written once; a division and an add per valid
    slot and element."""
    B, D = g.shape
    cnt = (nbrs >= 0).sum(1)
    nv = int(cnt.sum())
    nbytes = (int((cnt > 0).sum()) * D * 4 + B * 4 + (n_rows + 1) * 8
              + nv * 4 + n_rows * D * out_itemsize)
    flops = 2 * nv * D
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return flops, nbytes, max(t_ops, t_bytes) * 1e3, (
        "operations" if t_ops > t_bytes else "bytes")


def na_case(nops, nref, x, nbrs, w, row):
    """One neighbor_agg case on the card: the forward against the plain
    version (NA_TOL), the kernel's mean bit for bit, the backward bit for
    bit against the plain backward and equal to itself on a second run.
    The plain backward runs on the CPU, where ``index_add_`` adds in the
    chunk order the kernel keeps (ref.py); on the card its atomics add a
    hub id's slots in an order that changes from run to run."""
    import torch
    from repro_torch.kernels._build import load_extension
    dt = str(x.dtype).removeprefix("torch.")
    out = nops.neighbor_agg(x, nbrs, w)
    _, mean = load_extension().neighbor_agg(x, nbrs, w, True)
    torch.cuda.synchronize()
    want = nref.neighbor_agg_ref(x, nbrs, w)
    fwd_err = float((out.float() - want.float()).abs().max()) \
        if out.numel() else 0.0
    fwd_ok = torch.allclose(out.float(), want.float(), **NA_TOL[dt])
    mean_equal = torch.equal(mean, nref.neighbor_mean_ref(x, nbrs)[0])
    del want
    g = torch.randn((nbrs.shape[0], x.shape[1]), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(7))
    gx = nops.neighbor_agg_bwd(g, nbrs, x.shape[0], x.dtype)
    again = nops.neighbor_agg_bwd(g, nbrs, x.shape[0], x.dtype)
    want = nref.neighbor_agg_bwd_ref(g.cpu(), nbrs.cpu(),
                                     x.shape[0]).to(x.dtype)
    gx_cpu = gx.cpu()
    bwd_err = float((gx_cpu.float() - want.float()).abs().max()) \
        if gx.numel() else 0.0
    row.update(x_dtype=dt, w_dtype=str(w.dtype).removeprefix("torch."),
               fwd_max_abs_err=fwd_err, mean_bit_equal=mean_equal,
               fwd_tol=NA_TOL[dt], close=fwd_ok, bwd_max_abs_err=bwd_err,
               bwd_bit_equal=torch.equal(gx_cpu, want),
               bwd_run_to_run_equal=torch.equal(gx, again))
    emit(row)
    if not (fwd_ok and mean_equal and row["bwd_bit_equal"]
            and row["bwd_run_to_run_equal"]):
        raise SystemExit(f"neighbor_agg disagrees with its plain version: "
                         f"{row}")
    return fwd_err, bwd_err


def layer_x_w(N, gen):
    """h (N, 128) float32 with unit rows, as the layer has it, and w_nbr
    (128, 128) bfloat16."""
    import torch
    x = torch.randn((N, 128), device="cuda", generator=gen)
    w = (torch.randn((128, 128), device="cuda", generator=gen)
         / math.sqrt(128)).to(torch.bfloat16)
    return x / x.norm(dim=1, keepdim=True), w


def phase_kernel_neighbor_agg(nops, nref, layer_nbrs, launcher_nbrs):
    """neighbor_agg forward and backward on the card against their plain
    versions: the shapes of tests/test_kernels.py:213, K = 1, D and F not
    multiples of 4, D = 602 (the opt-in shared memory), K = 100 at the
    layer's N (slot chunks of 32 and a partial last one), bf16 x and w,
    each with an all-pad row and a row naming N - 1 in every slot; the
    train launcher's batch (B = N = 169,984, K = 1,340 from node 0's
    in-degree); then the full-width layer shape from a real sampled batch
    (B = N = 169,984, the batch's K, D = F = 128, float32 x and bf16 w
    as the model has them), timed beside the plain versions and the
    nearest library calls. Returns the timed row and the worst forward
    and backward errors."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels._build import load_extension
    ext = load_extension()
    cases = [(64, 32, 16, 8, 4, "float32", "float32"),
             (200, 128, 64, 16, 10, "float32", "float32"),
             (30, 16, 8, 4, 15, "float32", "float32"),
             (50, 33, 7, 9, 1, "float32", "float32"),
             (40, 5, 3, 6, 3, "float32", "bfloat16"),
             (200, 128, 64, 16, 10, "bfloat16", "float32"),
             (200, 128, 64, 16, 10, "bfloat16", "bfloat16"),
             (1000, 602, 128, 256, 10, "float32", "bfloat16"),
             (169984, 128, 128, 4096, 100, "float32", "bfloat16")]
    worst = (0.0, 0.0)
    for N, D, F_, B, K, xd, wd in cases:
        rng = np.random.default_rng(N + D + K)
        x = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32))
        w = torch.from_numpy((rng.normal(size=(D, F_)) * 0.1).astype(
            np.float32))
        nbrs = rng.integers(-1, N, size=(B, K)).astype(np.int32)
        nbrs[0] = -1                               # an all-pad row
        nbrs[-1] = N - 1                           # ids at N - 1
        errs = na_case(
            nops, nref, x.to(getattr(torch, xd)).cuda(),
            torch.from_numpy(nbrs).cuda(), w.to(getattr(torch, wd)).cuda(),
            {"phase": "kernel_neighbor_agg", "N": N, "D": D, "F": F_,
             "B": B, "K": K})
        worst = tuple(map(max, worst, errs))

    # the launcher's batch: a hub row of 1,340 slots
    gen = torch.Generator("cuda").manual_seed(11)
    N, K = launcher_nbrs.shape
    x, w = layer_x_w(N, gen)
    worst = tuple(map(max, worst, na_case(
        nops, nref, x, launcher_nbrs, w,
        {"phase": "kernel_neighbor_agg", "shape": "launcher batch", "N": N,
         "D": 128, "F": 128, "B": N, "K": K,
         "valid_slots": int((launcher_nbrs >= 0).sum())})))
    del x, w

    # a synthetic hub: id 7 named by 100,000 slots (3,125 chunks spread
    # over the card, then added in chunk order by one warp)
    rng = np.random.default_rng(100_000)
    N, K, hub = 5000, 4, 100_000
    B = hub + 1000
    nbrs = rng.integers(-1, N, size=(B, K)).astype(np.int32)
    nbrs[nbrs == 7] = 8
    nbrs[1 + rng.permutation(B - 1)[:hub], 0] = 7
    nbrs[0] = -1                                   # an all-pad row
    nbrs = torch.from_numpy(nbrs).cuda()
    x, w = layer_x_w(N, gen)
    worst = tuple(map(max, worst, na_case(
        nops, nref, x, nbrs, w,
        {"phase": "kernel_neighbor_agg", "shape": "hub", "N": N, "D": 128,
         "F": 128, "B": B, "K": K, "hub_slots": hub})))
    g = torch.randn((B, 128), device="cuda", generator=gen)
    index = nops.transpose_index(nbrs, N)
    emit({"phase": "kernel_neighbor_agg", "shape": "hub timing",
          "hub_slots": hub, "chunk_units": int(index.hptr[-1]),
          "bwd_ms": cuda_ms(lambda: ext.neighbor_agg_bwd(g, *index, False),
                            reps=3, iters=10, warmup=2)})
    del x, w, g, nbrs, index

    # the layer shape: h (N, 128) float32, w_nbr (128, 128) bf16
    N, K = layer_nbrs.shape
    D = F_ = 128
    x, w = layer_x_w(N, gen)
    row = {"phase": "kernel_neighbor_agg", "shape": "layer", "N": N,
           "D": D, "F": F_, "B": N, "K": K,
           "valid_slots": int((layer_nbrs >= 0).sum())}
    worst = tuple(map(max, worst, na_case(nops, nref, x, layer_nbrs, w,
                                          row)))
    flops, nbytes, bound_ms, bound_by = neighbor_agg_bound(
        x, layer_nbrs, w, 4, True)
    row.update(ms=cuda_ms(lambda: ext.neighbor_agg(x, layer_nbrs, w, True),
                          reps=5, iters=20, warmup=3),
               flops=flops, bytes=nbytes, bound_ms=bound_ms,
               bound_by=bound_by,
               plain_ms=cuda_ms(lambda: nref.neighbor_agg_ref(
                   x, layer_nbrs, w), reps=3, iters=3, warmup=1))
    # the nearest library composition: F.embedding_bag(mean) over a table
    # with a zero row at N for the pad slots, then the product
    table = torch.cat([x, torch.zeros((1, D), device="cuda")])
    ids = torch.where(layer_nbrs >= 0, layer_nbrs, N).long()
    wf = w.float()
    lib = F.embedding_bag(ids, table, mode="mean", padding_idx=N) @ wf
    row["library_max_abs_err"] = float(
        (lib - ext.neighbor_agg(x, layer_nbrs, w, False)[0]).abs().max())
    row.update(library_ms=cuda_ms(lambda: F.embedding_bag(
        ids, table, mode="mean", padding_idx=N) @ wf, reps=5, iters=20,
        warmup=3),
        library_call="two calls: F.embedding_bag(mode='mean', "
                     "padding_idx=N) on a zero-padded table, then "
                     "torch.matmul")
    del table, ids, lib

    # the backward at the same shape: the kernel alone (transposed index
    # built once), the wrapper with its index build, the plain version,
    # and one sparse CSR product of the same function
    g = torch.randn((N, D), device="cuda", generator=gen)
    index = nops.transpose_index(layer_nbrs, N)
    cnt = index.cnt
    bflops, bbytes, bbound, bby = neighbor_agg_bwd_bound(g, layer_nbrs, N, 4)
    bwd = {"ms": cuda_ms(lambda: ext.neighbor_agg_bwd(g, *index, False),
                         reps=5, iters=20, warmup=3),
           "chunk_units": int(index.hptr[-1]),
           "heaviest_id_slots": int((index.rowptr[1:]
                                     - index.rowptr[:-1]).max()),
           "wrapper_ms": cuda_ms(lambda: nops.neighbor_agg_bwd(
               g, layer_nbrs, N), reps=5, iters=5, warmup=2),
           "flops": bflops, "bytes": bbytes, "bound_ms": bbound,
           "bound_by": bby,
           "plain_ms": cuda_ms(lambda: nref.neighbor_agg_bwd_ref(
               g, layer_nbrs, N), reps=3, iters=3, warmup=1)}
    pos = (layer_nbrs.reshape(-1) >= 0).nonzero().squeeze(1)
    b_of = torch.div(pos, K, rounding_mode="floor")
    vals = 1.0 / cnt.clamp_min(1).float()[b_of]
    with warnings.catch_warnings():   # sparse CSR is "beta" in torch
        warnings.simplefilter("ignore", UserWarning)
        a = torch.sparse_coo_tensor(
            torch.stack([layer_nbrs.reshape(-1)[pos].long(), b_of]), vals,
            (N, N), check_invariants=False).coalesce().to_sparse_csr()
    lib = a @ g
    bwd["library_max_abs_err"] = float(
        (lib - ext.neighbor_agg_bwd(g, *index, False)).abs().max())
    bwd.update(library_ms=cuda_ms(lambda: a @ g, reps=5, iters=20, warmup=3),
               library_call="torch.sparse CSR (N x B, weights 1/count) @ g")
    row["backward"] = bwd
    emit({"phase": "kernel_neighbor_agg", "shape": "layer timing", **{
        k: v for k, v in row.items() if k not in ("phase", "shape")}})
    del x, g, a, lib, index
    torch.cuda.empty_cache()
    return row, worst


def phase_gnn_train(launches, cfg, meta, sampler, feats, labels):
    """graphsage-reddit at full width through the port's train step and
    fault-tolerant driver: GNN_STEPS AdamW steps, each on a fresh sampled
    batch (host sample, upload and device step timed apart), in a fresh
    checkpoint directory, then GNN_PROFILE_STEPS more under the profiler.
    Fails on a recovered failure, a skipped step, a non-finite loss, a
    launch count other than 2 forward + 2 backward a step, or a first loss
    outside GNN_LOSS_TOL of the JAX package's."""
    import tempfile

    import torch
    from repro_torch import convert
    from repro_torch.models import gnn
    from repro_torch.train.fault_tolerance import FTConfig, run_training
    from repro_torch.train.optimizer import AdamWConfig, init_adamw
    from repro_torch.train.train_loop import make_train_step

    params = convert.gnn_params_from_numpy(
        gnn_numpy_params(gnn.gnn_param_shapes(cfg)), cfg, "cuda",
        dtype=torch.bfloat16)
    opt_cfg = AdamWConfig(**GNN_OPT)
    step_fn = make_train_step(lambda p, b: gnn.gnn_loss(p, b, cfg), opt_cfg)
    times = {"sample_ms": [], "upload_ms": [], "device_ms": []}
    valid_edges = []

    def batch_at(step):
        t0 = time.perf_counter()
        b = gnn_sample(sampler, meta, feats, labels, step)
        t1 = time.perf_counter()
        tb = {k: torch.from_numpy(b[k]).cuda() for k in GNN_KEYS}
        torch.cuda.synchronize()
        times["sample_ms"].append((t1 - t0) * 1e3)
        times["upload_ms"].append((time.perf_counter() - t1) * 1e3)
        valid_edges.append(int(b["edge_mask"].sum()))
        return tb

    def timed_step(p, o, b):
        t0 = time.perf_counter()
        out = step_fn(p, o, b)
        torch.cuda.synchronize()
        times["device_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as d:
        state = (params, init_adamw(params, opt_cfg))
        res, wall, counts = launches.drive(lambda: run_training(
            timed_step, state, None, GNN_STEPS,
            FTConfig(ckpt_dir=d, ckpt_every=10), batch_at=batch_at))
    losses = [m["loss"] for m in res.metrics_history]
    skipped = [i for i, m in enumerate(res.metrics_history)
               if m.get("skipped")]
    need = {"neighbor_agg": 2 * GNN_STEPS, "neighbor_agg_bwd": 2 * GNN_STEPS}
    pinned = GNN_JAX_LOSSES
    close = [bool(math.isclose(a, b, rel_tol=t["rtol"], abs_tol=t["atol"]))
             for a, b, t in zip(losses, pinned, GNN_LOSS_TOL)]
    med = {k: statistics.median(v) for k, v in times.items()}
    row = {"phase": "gnn_train", "config": GNN_ARCH, "shape": GNN_SHAPE,
           "steps": res.steps_done, "wall_s": wall,
           "step_ms_mean": wall * 1e3 / max(res.steps_done, 1),
           **{f"{k}_median": v for k, v in med.items()},
           "device_ms_first": times["device_ms"][0],
           "valid_edges_min_max": [min(valid_edges), max(valid_edges)],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "failures_recovered": res.failures_recovered,
           "skipped_steps": skipped, "losses": losses,
           "jax_losses": pinned, "loss_tol": GNN_LOSS_TOL[:len(pinned)],
           "losses_close_to_jax": close,
           "launches": counts, "expected_launches": need,
           "launches_per_step": {k: v / GNN_STEPS for k, v in counts.items()
                                 if v}}
    emit(row)
    if res.failures_recovered or skipped or res.steps_done != GNN_STEPS:
        raise SystemExit(f"gnn_train recovered from failures or skipped "
                         f"steps: {row}")
    if not all(math.isfinite(v) for v in losses):
        raise SystemExit(f"gnn_train gave non-finite losses: {losses}")
    if {k: v for k, v in counts.items() if v} != need:
        raise SystemExit(f"gnn_train launched {counts}, not {need}")
    if not all(close):
        raise SystemExit(f"gnn_train's first losses differ from JAX's: "
                         f"{losses[:len(pinned)]} vs {pinned}")

    def three_steps():
        p, o = state
        for k in range(GNN_PROFILE_STEPS):
            p, o, _ = step_fn(p, o, batch_at(GNN_STEPS + k))
        torch.cuda.synchronize()

    phase_profile("gnn_train_steps", three_steps)


def phase_gnn_launcher(launches):
    """The train launcher at minibatch_lg for 5 steps in a fresh
    checkpoint directory (its one fixed batch from ``random_graph`` over
    169,984 nodes, node 0's in-degree setting K), held to the JAX
    launcher's losses."""
    import tempfile

    from repro_torch.launch import train as launch_train
    argv = ["--arch", GNN_ARCH, "--shape", GNN_SHAPE, "--steps",
            str(GNN_LAUNCHER_STEPS)]
    with tempfile.TemporaryDirectory() as d:
        res, wall, counts = launches.drive(lambda: launch_train.main(
            argv + ["--ckpt_dir", d]))
    losses = [m["loss"] for m in res.metrics_history]
    need = {"neighbor_agg": 2 * GNN_LAUNCHER_STEPS,
            "neighbor_agg_bwd": 2 * GNN_LAUNCHER_STEPS}
    pinned = GNN_LAUNCHER_JAX_LOSSES
    t = GNN_LAUNCHER_TOL
    close = [bool(math.isclose(a, b, rel_tol=t["rtol"], abs_tol=t["atol"]))
             for a, b in zip(losses, pinned)]
    row = {"phase": "gnn_launcher", "argv": argv, "wall_s": wall,
           "steps": res.steps_done,
           "failures_recovered": res.failures_recovered, "losses": losses,
           "jax_losses": pinned, "loss_tol": t, "losses_close_to_jax": close,
           "launches": counts, "expected_launches": need}
    emit(row)
    if res.failures_recovered or any(m.get("skipped")
                                     for m in res.metrics_history):
        raise SystemExit(f"the train launcher hid a failure: {row}")
    if {k: v for k, v in counts.items() if v} != need:
        raise SystemExit(f"the train launcher launched {counts}")
    if len(pinned) != len(losses) or not all(close):
        raise SystemExit(f"the train launcher's losses differ from JAX's: "
                         f"{row}")


def phase_gnn_parity(cfg, graphs):
    """The reduced graphsage config in float32 (TF32 off), card against
    CPU: the loss and every gradient within GNN_PARITY_TOL on a sampled
    batch whose padding edges reach node 0."""
    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.models import gnn
    from repro_torch.train.train_loop import value_and_grad
    from repro_torch.train.tree import tree_flatten
    n = 1000
    src, dst = graphs.random_graph(n, 8.0, seed=5)
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(n, cfg.d_in)).astype(np.float32)
    labels = rng.integers(0, cfg.n_classes, n).astype(np.int32)
    b = graphs.NeighborSampler(n, src, dst).sample_padded(
        rng.choice(n, 64, replace=False), (5, 3), rng, max_nodes=1536,
        max_edges=2048, features=feats, labels=labels)
    tree = gnn_numpy_params(gnn.gnn_param_shapes(cfg), seed=3)
    out = {}
    for dev in ("cuda", "cpu"):
        p = convert.gnn_params_from_numpy(tree, cfg, dev,
                                          dtype=torch.float32)
        tb = {k: torch.from_numpy(b[k]).to(dev) for k in GNN_KEYS}
        loss, grads = value_and_grad(lambda q, bb: gnn.gnn_loss(q, bb, cfg),
                                     p, tb)
        out[dev] = [loss.cpu().numpy()] + [g.cpu().numpy()
                                           for g in tree_flatten(grads)]
    diffs = [float(np.abs(a - c).max()) for a, c in zip(out["cuda"],
                                                         out["cpu"])]
    ok = all(np.allclose(a, c, **GNN_PARITY_TOL)
             for a, c in zip(out["cuda"], out["cpu"]))
    row = {"phase": "gnn_parity", "config": f"{GNN_ARCH} reduced, float32",
           "tf32": torch.backends.cuda.matmul.allow_tf32,
           "tol": GNN_PARITY_TOL, "loss_cuda": float(out["cuda"][0]),
           "loss_cpu": float(out["cpu"][0]), "loss_abs_diff": diffs[0],
           "grad_max_abs_diff": max(diffs[1:]),
           "padding_edges": int((~b["edge_mask"]).sum()), "ok": ok}
    emit(row)
    if not ok:
        raise SystemExit(f"reduced GNN differs card vs cpu: {row}")


def run_gnn(launches, nops, nref):
    """The GNN training slice: the reddit-scale source graph and sampler
    on the host, the neighbor_agg kernel phase at the layer shape of its
    first batch, graphsage-reddit trained at full width, the train
    launcher at minibatch_lg, and the reduced config card against CPU.
    Returns the kernel's timed row and its worst forward and backward
    errors."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data import graphs
    from repro_torch.launch import train as launch_train
    from repro_torch.models import gnn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arch = get_arch(GNN_ARCH)
    cfg = arch.build_cfg(shape=GNN_SHAPE)
    meta = arch.shapes[GNN_SHAPE].meta
    t0 = time.perf_counter()
    src, dst, feats, labels = gnn_source(meta, graphs)
    t1 = time.perf_counter()
    sampler = graphs.NeighborSampler(meta["graph_nodes"], src, dst)
    t2 = time.perf_counter()
    emit({"phase": "gnn_setup", "config": GNN_ARCH, "shape": GNN_SHAPE,
          "n_layers": cfg.n_layers, "d_hidden": cfg.d_hidden,
          "d_in": cfg.d_in, "n_classes": cfg.n_classes,
          "aggregator": cfg.aggregator, "graph_nodes": meta["graph_nodes"],
          "graph_edges": int(src.size), "batch_nodes": meta["batch_nodes"],
          "fanout": list(meta["fanout"]), "padded_nodes": meta["nodes"],
          "padded_edges": meta["edges"],
          "graph_and_features_s": t1 - t0, "sampler_build_s": t2 - t1,
          "host_setup_s": t2 - t0})
    del src, dst
    first = gnn_sample(sampler, meta, feats, labels, 0)
    tb = {k: torch.from_numpy(first[k]).cuda() for k in GNN_KEYS}
    layer_nbrs = gnn.in_neighbors(tb["edge_src"], tb["edge_dst"],
                                  tb["edge_mask"], meta["nodes"])[0]
    tb = launch_train.gnn_batches(arch, GNN_SHAPE, False, "cuda")(0)
    launcher_nbrs = gnn.in_neighbors(tb["edge_src"], tb["edge_dst"],
                                     tb["edge_mask"], meta["nodes"])[0]
    del tb, first
    timed, worst = phase_kernel_neighbor_agg(nops, nref, layer_nbrs,
                                             launcher_nbrs)
    del layer_nbrs, launcher_nbrs
    phase_gnn_train(launches, cfg, meta, sampler, feats, labels)
    del sampler, feats, labels
    torch.cuda.empty_cache()
    phase_gnn_launcher(launches)
    torch.cuda.empty_cache()
    phase_gnn_parity(arch.build_cfg(reduced=True), graphs)
    return timed, worst

class Launches:
    """The launch counts of every kernel wrapper of the port."""

    def __init__(self, wrappers: dict):
        self.wrappers = wrappers
        self.total = dict.fromkeys(wrappers, 0)   # summed over the paths

    def drive(self, fn):
        """Run one path with every count set to 0 just before it; return
        ``(fn's result, wall seconds, the counts just after)``."""
        for w in self.wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
        counts = {name: w.launches for name, w in self.wrappers.items()}
        for name, c in counts.items():
            self.total[name] += c
        return out, wall, counts


def check_path(row, want_digest, want_km1, cpu_digest, counts, need):
    """Hold a path's digest against the JAX constant (or, when the graph
    differs from the one the constant was taken on, against the port's
    own CPU run) and its launch counts against ``need``: kernel name ->
    the count the engine's own stats call for (None: at least one). A
    path that launches none of its kernels fails."""
    if cpu_digest is None:
        row.update(check="jax_digest", expected_digest=want_digest,
                   expected_k_minus_1=want_km1)
        ok = row["digest"] == want_digest and row["k_minus_1"] == want_km1
    else:
        row.update(check="port_cpu_digest", expected_digest=cpu_digest)
        ok = row["digest"] == cpu_digest
    row["launches"] = counts
    row["expected_launches"] = need
    emit(row)
    if not ok:
        raise SystemExit(f"{row['phase']} digest differs: {row}")
    for name, want in need.items():
        got = counts[name]
        bad = got == 0 if want is None else got != want
        if bad:
            raise SystemExit(f"{row['phase']} launched {name} {got} times; "
                             f"its engine counted {want}")
    if not any(counts[name] for name in need):
        raise SystemExit(f"{row['phase']} launched none of its kernels")


def batched_scores_row(shapes, per_bl, floor):
    """The batched path's hype_scores launches by (B, L), and their sum of
    this run's times per shape: eager, in a graph, over the bytes bound
    (the launches x gap) and over the launch floor."""
    row = {"phase": "batched_scores_shapes",
           "launches": {f"{B}x{L}": n for (B, L), n in sorted(shapes.items())}}
    timed = {k: n for k, n in shapes.items() if k in per_bl}
    row["untimed_shapes"] = sorted(f"{B}x{L}" for B, L in
                                   set(shapes) - set(timed))
    for key in ("ms", "graph_ms", "bound_ms"):
        row[f"sum_{key}"] = sum(n * per_bl[k][key] for k, n in timed.items())
    row["gap_over_bound_ms"] = row["sum_ms"] - row["sum_bound_ms"]
    row["gap_over_floor_ms"] = row["sum_ms"] - sum(timed.values()) * floor[
        "ms"]
    return row


def path_row(phase, hg, a, k, wall):
    from repro_torch.core import metrics
    sizes = metrics.partition_sizes(a, k)
    if (a < 0).any() or sizes.max() - sizes.min() > 1:
        raise SystemExit(f"{phase} assignment is incomplete or unbalanced")
    return {"phase": phase, "wall_s": wall,
            "k_minus_1": metrics.k_minus_1(hg, a, k),
            "vertex_imbalance": metrics.vertex_imbalance(a, k),
            "digest": digest(a)}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
    from repro_torch.core import metrics
    from repro_torch.core.hypergraph import Hypergraph
    from repro_torch.data import synthetic as synth
    from repro_torch.engines.batched import (BatchedParams,
                                             hype_batched_partition)
    from repro_torch.engines.superstep import (SuperstepParams,
                                               hype_superstep_partition)
    from repro_torch.kernels import _build
    from repro_torch.kernels.embedding_bag import ops as bops
    from repro_torch.kernels.embedding_bag import ref as bref
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.hype_score import ops, ref
    from repro_torch.kernels.kway_refine import ops as kops
    from repro_torch.kernels.kway_refine import ref as kref
    from repro_torch.kernels.neighbor_agg import ops as nops
    from repro_torch.kernels.neighbor_agg import ref as nref
    from repro_torch.partition_api import PRESETS, partition

    t_start = time.perf_counter()
    t0 = time.perf_counter()
    ext = _build.load_extension()
    build_s = time.perf_counter() - t0
    card = card_line()
    emit({"phase": "env", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device_name": torch.cuda.get_device_name(0),
          "build_s": build_s, "flash_sass": flash_sass(ext.__file__)})

    per_l, worst_err = phase_kernel(ops, ref)
    per_bl, scores_floor, worst_scores = phase_kernel_scores(ops, ref)
    per_lk, worst_kway = phase_kernel_kway(kops, kref)
    phase_goldens(partition, synth, Hypergraph)

    t0 = time.perf_counter()
    hg = synth.github_like(1.0, seed=0)
    hg.vertex_adjacency()
    fp = hg.fingerprint()
    emit({"phase": "slice_setup", "graph": "github_like(1.0, seed=0)",
          "n": hg.n, "m": hg.m, "pins": hg.n_pins, "fingerprint": fp,
          "expected_fingerprint": SLICE_FINGERPRINT,
          "setup_s": time.perf_counter() - t0})

    # the main paths: each starts with every launch count at 0
    launches = Launches({"hype_score_select": ops.hype_score_select,
                         "hype_scores": ops.hype_scores,
                         "kway_gains": kops.kway_gains,
                         "embedding_bag": bops.embedding_bag,
                         "flash_attention": fops.flash_attention,
                         "neighbor_agg": nops.neighbor_agg,
                         "neighbor_agg_bwd": nops.neighbor_agg_bwd})
    runs = {}
    for depth in (1, 2):
        (a, row), _, counts = launches.drive(lambda: run_slice(
            hg, depth, "cuda", metrics, SuperstepParams,
            hype_superstep_partition))
        runs[depth] = row
        if fp == SLICE_FINGERPRINT:
            row["check"] = "jax_digest"
            row["expected_digest"] = SLICE_DIGESTS[depth]
            row["expected_k_minus_1"] = SLICE_KM1[depth]
            ok = (row["digest"] == SLICE_DIGESTS[depth]
                  and row["k_minus_1"] == SLICE_KM1[depth])
        elif depth == 1:
            _, cpu_row = run_slice(hg, 1, "cpu", metrics, SuperstepParams,
                                   hype_superstep_partition)
            row["check"] = "port_cpu_digest"
            row["expected_digest"] = cpu_row["digest"]
            ok = row["digest"] == cpu_row["digest"]
        else:
            row["check"] = "none (graph differs; depth 1 checked on cpu)"
            ok = True
        row["launches"] = counts
        emit(row)
        if not ok:
            raise SystemExit(f"slice digest differs: {row}")
        if (counts["hype_score_select"] == 0
                or counts["hype_score_select"] != row["supersteps"]):
            raise SystemExit(f"slice launched the kernel "
                             f"{counts['hype_score_select']} times for "
                             f"{row['supersteps']} supersteps")

    same_graph = fp == SLICE_FINGERPRINT
    # hype_batched, t=16: the hype_scores kernel, one launch per tile
    # (the (B, L) of every launch counted on the way: the shapes the
    # path really scores)
    from repro_torch.engines import batched as batched_mod
    score_shapes = collections.Counter()

    def spy_scores(nbrs, fringe):
        score_shapes[tuple(nbrs.shape)] += 1
        return ops.hype_scores(nbrs, fringe)

    bp = BatchedParams(seed=0, t=16)
    batched_mod.hype_scores = spy_scores
    try:
        (a, st), wall, counts = launches.drive(
            lambda: hype_batched_partition(hg, 32, bp, return_stats=True,
                                           device="cuda"))
    finally:
        batched_mod.hype_scores = ops.hype_scores
    emit(batched_scores_row(score_shapes, per_bl, scores_floor))
    row = path_row("batched", hg, a, 32, wall)
    row.update(kernel_calls=st.kernel_calls, kernel_rows=st.kernel_rows,
               host_rows=st.host_rows, steps=st.steps)
    cpu = None if same_graph else digest(hype_batched_partition(
        hg, 32, bp, device="cpu"))
    check_path(row, PATH_DIGESTS["batched"], PATH_KM1["batched"], cpu,
               counts, {"hype_scores": st.kernel_calls})

    # hype_superstep, t=16, preset="quality": supersteps, then the
    # refinement post-pass with its kway_gains screen on the card
    qp = SuperstepParams(seed=0, t=16, **PRESETS["hype_superstep"]["quality"])
    (a, st), wall, counts = launches.drive(
        lambda: hype_superstep_partition(hg, 32, qp, return_stats=True,
                                         device="cuda"))
    row = path_row("quality", hg, a, 32, wall)
    row.update(supersteps=st.supersteps, tile_l=st.tile_l,
               refine=dataclasses.asdict(st.refine))
    cpu = None if same_graph else digest(hype_superstep_partition(
        hg, 32, qp, device="cpu"))
    screens = st.refine.kernel_calls
    if same_graph and screens != QUALITY_SCREENS:
        raise SystemExit(f"quality path screened {screens} tiles; the JAX "
                         f"run screened {QUALITY_SCREENS}")
    check_path(row, PATH_DIGESTS["quality"], PATH_KM1["quality"], cpu,
               counts, {"hype_score_select": st.supersteps,
                        "kway_gains": screens})
    quality_tile_l = st.tile_l

    # hype_multilevel on github_like(0.25): host coarsening, supersteps on
    # the coarsest graph, kway_gains screens at the finest level
    t0 = time.perf_counter()
    hq = synth.github_like(0.25, seed=0)
    fq = hq.fingerprint()
    emit({"phase": "multilevel_setup", "graph": "github_like(0.25, seed=0)",
          "n": hq.n, "m": hq.m, "fingerprint": fq,
          "expected_fingerprint": ML_FINGERPRINT,
          "setup_s": time.perf_counter() - t0})
    # the coarsest graph's superstep run, seen from inside the path: its
    # supersteps are the score + select launches the path must show
    from repro_torch.engines import superstep as superstep_mod
    coarsest = []

    def spy(hc, k, params=None, return_stats=False, **kw):
        out, st = hype_superstep_partition(hc, k, params, True, **kw)
        coarsest.append({"n": hc.n, "edges_2plus": int(
            (hc.edge_sizes >= 2).sum()), "supersteps": st.supersteps})
        return (out, st) if return_stats else out

    superstep_mod.hype_superstep_partition = spy
    try:
        a, wall, counts = launches.drive(lambda: partition(
            hq, 32, "hype_multilevel", device="cuda"))
    finally:
        superstep_mod.hype_superstep_partition = hype_superstep_partition
    row = path_row("multilevel", hq, a, 32, wall)
    row["coarsest"] = coarsest[0]
    cpu = None if fq == ML_FINGERPRINT else digest(partition(
        hq, 32, "hype_multilevel", device="cpu"))
    check_path(row, PATH_DIGESTS["multilevel"], PATH_KM1["multilevel"], cpu,
               counts, {"hype_score_select": coarsest[0]["supersteps"],
                        "kway_gains": None})

    phase_profile("slice_depth1", lambda: run_slice(
        hg, 1, "cuda", metrics, SuperstepParams, hype_superstep_partition))
    phase_profile("batched", lambda: hype_batched_partition(
        hg, 32, bp, device="cuda"))
    phase_profile("quality", lambda: hype_superstep_partition(
        hg, 32, qp, device="cuda"))

    bag_rows, worst_bag = run_recsys(launches, bops, bref)
    flash_rows, worst_flash = run_lm(launches, fops, fref)
    na_row, (worst_na, worst_na_bwd) = run_gnn(launches, nops, nref)

    def entry(name, source, replaces, main, err, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches.total[name],
                "max_abs_err": err, "ms": main["ms"],
                "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main.get("bound_by", "bytes"),
                "library_ms": main.get("library_ms"), **extra}

    csrc = "src/repro_torch/kernels/"
    bulk = bag_rows["serve_bulk"]
    emit({"phase": "library",
          "embedding_bag": {shape: {"library_ms": r["library_ms"],
                                    "call": r["library_call"]}
                            for shape, r in bag_rows.items()},
          "flash_attention": {shape: {"library_ms": r["library_ms"],
                                      "call": r["library_call"]}
                              for shape, r in flash_rows.items()},
          "neighbor_agg": {"layer": {"library_ms": na_row["library_ms"],
                                     "call": na_row["library_call"]}},
          "neighbor_agg_bwd": {"layer": {
              "library_ms": na_row["backward"]["library_ms"],
              "call": na_row["backward"]["library_call"]}},
          "hype_score_select": None, "hype_scores": None, "kway_gains": None,
          "why_none": "no single PyTorch call computes the functions of "
                      "the three partitioning kernels"})
    emit({"kernels": [
        entry("hype_score_select", csrc + "hype_score/csrc/score_select.cu",
              "src/repro/kernels/hype_score/kernel.py:160",
              per_l[runs[1]["tile_l"]], worst_err),
        entry("hype_scores", csrc + "hype_score/csrc/scores.cu",
              "src/repro/kernels/hype_score/kernel.py:50",
              per_bl[(256, 2048)], worst_scores),
        entry("kway_gains", csrc + "kway_refine/csrc/kway_gains.cu",
              "src/repro/kernels/kway_refine/kernel.py:65",
              per_lk[(quality_tile_l, 32)], worst_kway),
        entry("embedding_bag", csrc + "embedding_bag/csrc/embedding_bag.cu",
              "src/repro/kernels/embedding_bag/kernel.py:73", bulk,
              worst_bag),
        entry("flash_attention",
              csrc + "flash_attention/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention/kernel.py:111",
              flash_rows["layer"], worst_flash),
        entry("neighbor_agg", csrc + "neighbor_agg/csrc/neighbor_agg.cu",
              "src/repro/kernels/neighbor_agg/kernel.py:72", na_row,
              worst_na),
        entry("neighbor_agg_bwd", csrc + "neighbor_agg/csrc/neighbor_agg.cu",
              None, na_row["backward"], worst_na_bwd,
              note="the backward (grad of x) of neighbor_agg_kernel, "
                   "src/repro/kernels/neighbor_agg/kernel.py:72, which has "
                   "no TPU backward")]})
    emit({"phase": "done", "total_s": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
