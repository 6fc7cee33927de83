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
            the launch floor of a one-element add_), kway_gains (the
            tile front end) per (L, k) and on a path-like tile of ragged
            rows and trailing pads, plus edge cases and the shapes past
            the limits the port once had (a fringe of 24 to 60,000 ids,
            R + P up to 60,016 slots, k up to 10,000), and the chunked
            memory rung's shapes (16 phases; 3 phases, one all pad)
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
            (the refinement post-pass on the card, 104 screens, each one
            kway_gains_csr launch)
  kernel_kway_screen  kway_gains_csr at the quality path's first screen
            (its 4,096 boundary ids, tile_l 2,048, k=32): the tile's fill,
            bit-equal to its plain version, timed with and without the
            screen's delta, eagerly and in a CUDA graph, beside the launch
            floor and the gather + tile kernel chain it replaced; then at
            k=67 on the same inputs
  device    the same graph through hype_device, t=16: the whole growth
            loop on the card, one round captured as a CUDA graph and
            replayed 64 times a chunk, held to the depth-1 slice's digest,
            k-1 and supersteps, with its replays, graph nodes and capture
            time (score + select launches = replays + one warm-up round a
            capture); then preset="quality" held to the quality path's
            digest and 104 screens; then the depth-1 slice and hype_device
            one after the other (wall, host_s, device_s)
  resilience  the same graph: hype_device clean, snapshotting every 64
            supersteps, killed by dispatch@200:fatal and resumed (from
            the snapshot at 192), and with dispatch@50;nan@120 (the
            poisoned round off the captured graph), each on the depth-1
            digest; hype_superstep killed and resumed at depth 1 (the
            digest) and 2 (the uninterrupted run with the same cadence,
            held to JAX's); hype_batched with a NaN tile at launch 3,000
            (the batched digest, the tile rescored on the host); then
            partition_resilient from hype_device killed at 100, finishing
            on hype_superstep from the snapshot at 64 (held to JAX's
            ladder). Each run prints wall, host_s, device_s, snapshots,
            snapshot_s, restore_s and a snapshot's bytes
  report    partition_and_report on the same graph for minmax_nb,
            minmax_eb, shp, random, hashing and hype_device, each report
            held to the JAX package's key for key (runtime_s aside)
  membudget the same graph through hype_superstep at six memory budgets,
            which plan rungs 0-5 (phase-chunked scoring, tile_l 512,
            depth 1, the score cache on the host, the CSR paged in 31
            chunks) with no OOM: the depth-2 digest, JAX's rung-2 digest,
            JAX's rung-3 digest (rungs 3-5), JAX's planned bytes and page
            counters; an injected oom and a real allocator failure (a
            1 TiB torch.empty at a fresh copy's image upload) retried once
            at rung 1; hype_device with oom@2 and oom@70 falling down the
            host pipeline's rungs; each with its launches, peak bytes and
            the card's memory before and after; then a clean hype_device
  stream    the same graph through hype_stream, k=32, StreamParams(seed=0):
            2,772 micro-batches, each one row 1 launch (G=32 fringes,
            R=64) and one stream_commit launch, on JAX's digest, k-1,
            plan and planned bytes, the sketch equal to its recount;
            stream_commit against its plain version (random cases over k,
            L and mb, ties, cap hits, pad rows, duplicate buckets, the
            stream's kinds of rows, the row chain's hand-overs, 24 bits,
            six of the path's micro-batches), one launch a case and the
            branch the launcher reports; timed (each launch on its own
            copy of the state) on the path's micro-batches at Le=32, 128
            and 512, one widened to Le=2048, its first 1, 16 and 64 rows,
            the all-pad and no-pin chains and a dense tile;
            row 1 timed at the stream's shape; then mem_budget=20e6 (plan
            (32, 2048), JAX's digest), a run snapshotting every 512
            micro-batches killed at 1,500 and resumed at 1,024, a retried
            dispatch fault, and apply_updates of a seeded 64-op log on the
            path's state (JAX's digest, the sketch equal to its recount)
  sharded   the same graph through hype_sharded, k=32, t=16: row 1 at
            the shard's shapes (a group of 8 of the 32 phases, and all
            32) against its plain version, timed; one rank with no group
            at depths 1 and 2 (the slice's digests, 380 collectives
            counted at depth 2, no conflicts); one rank under a one-rank
            NCCL group over a file:// store (the digest, NCCL's
            all_gather timed alone and as a share of a superstep); four
            spawned ranks sharing the card over gloo (JAX's four-device
            digest, 391 collectives, 6,406,144 bytes and 2,686 conflicts
            on every rank, each rank's row 1 launches); partition_resilient
            with its default method killed at 100 (JAX's ladder at one
            device); collective@2;nan@3 at one rank (the digest)
  hype_jax  the padded-array engines, which launch no kernel (every
            count must stay 0): hype_jax and hype_parallel on pl300
            (k=8) and pl3000 (k=16), each on JAX's digest and k-1, and
            hype_jax on the 6-vertex edge graph at k = 1, 3 and 6 (JAX's
            digests too); each card run equal to the port's CPU run, with its wall,
            iterations, restarts and rescues, k-1 and part sizes
  multilevel  github_like(0.25, seed=0), k=32, through hype_multilevel
  profile   the depth-1 slice (the host-driven pipeline), hype_device
            (the device loop) and hype_stream each run once more under
            torch.profiler (the card's busy time)
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
  kernel_embedding_bag_bwd  the table's gradient (row 5b's backward
            kernel with the bags as rows, mean and sum) bit for bit
            against its plain version on the CPU: small tables (odd D,
            bag 1, a wide bag, duplicates, all-pad rows, a hub) in fp32
            and bf16, a second launch equal, ids near V-1 of a
            16,777,216 x 256 gradient; the training shape (both towers'
            262,144 bags of 8 from RecsysStream at V = 2,097,152) timed
            eagerly and in a CUDA graph beside the plain version and
            autograd's backward of F.embedding_bag(mode='mean')
  recsys_train  two-tower-retrieval at its published width and B =
            65,536, its vocabularies cut to 2,097,152: 3 AdamW steps, each
            launching the EmbeddingBag kernel and its backward twice;
            wall, examples/s, peak memory, finite losses, no all-zero
            gradient leaf, the loss alone; then one step under the
            profiler
  recsys_train_parity  the reduced config from numpy params, 4 steps with
            and without compress_grads, held to the JAX package's pinned
            losses (tests/jax_twotower_losses.py)
  recsys_launcher  the train launcher, --arch two-tower-retrieval
            --reduced --steps 4
  kernel_flash_attention  the flash-attention kernels against their
            plain version (fp32 on the CUDA-core kernel, bf16 on the
            tensor-core kernel: causal, non-causal, windows, D from 8 to
            256, Hkv = 1, ragged S, and the full-width qwen3-8b layer shape
            B=8, S=4096), timed there and at B=1, S=32,768 beside
            ``F.scaled_dot_product_attention``; at S=32,768 the last 64
            query rows of every head are compared; bf16 is held to a worst
            case and a mean error limit (FLASH_TOL); also timed, and
            compared, at granite-moe-3b-a800m's layer (B=4, S=4,096, 24/8
            heads of 64) and mixtral-8x22b's (B=1, S=16,384, 48/8 heads of
            128, window 4,096; SDPA given an explicit band mask)
  lm_serve  qwen3-8b at full width (bf16, 8.19e9 params drawn on the
            card): prefill of 8 prompts of 4,096 tokens, 16 greedy
            decode steps on that cache, then the serve launcher with its
            defaults; each prefill launches the kernel once per layer
  lm_parity  the reduced qwen3-8b config in float32 from numpy params,
            card against CPU
  lm_parity_bf16  the same config in bf16 (the tensor-core kernel),
            card against CPU, prefill launching the kernel once a layer
  kernel_flash_bwd  the flash-attention backward kernels against their
            plain version (fp32 and bf16: causal, non-causal, windows,
            Hkv = 1, ragged S, D from 8 to 256; BWD_TOL), one case repeated
            for equal bits, and the LM training shape (B=2, S=4,096, 32
            heads of 80) and qwen3-8b's layer (B=8, S=4,096, 32/8 heads of
            128), compared one sequence at a time and timed eagerly and in
            a CUDA graph beside SDPA's backward
  lm_train  stablelm-3b at its published width (bf16, 2.80e9 params drawn
            on the card), remat on, the launcher's AdamW: 3 steps of 2
            microbatches of 2 x 4,096 tokens; each step launches the
            forward kernel 128 times (forward and recompute) and the
            backward 64; finite losses, no zero-gradient leaf, the peak
            memory; then one more step under the profiler
  lm_train_parity  the reduced stablelm-3b in fp32 and bf16 from numpy
            params, 4 accumulated steps held to the JAX package's pinned
            losses (tests/jax_lm_losses.py)
  lm_launcher  the train launcher, --arch stablelm-3b --reduced --steps 4
  moe_serve granite-moe-3b-a800m at its published width (bf16, 3.37e9
            params drawn on the card): prefill of 4 prompts of 32,768
            tokens (a warm-up, then timed; the attention kernel once a
            layer; the share of slots each expert's capacity drops, layer
            by layer), 16 greedy serve_steps on the cache padded by 16
            slots, 16 serve_step_paged steps from the same prefill, fed
            the same tokens (each held to a serve_step over the same keys
            on its experts; layer 0's first K/V bit-equal to serve_step's);
            then a prefill and a step of each decode under the profiler
  moe_window_serve  mixtral-8x22b at its published width cut to 4 layers
            (10.4e9 params): one prompt of 16,384 tokens, then the same
            decode checks on the rolling 4,096-slot cache, past the window
  moe_parity  the reduced granite-moe-3b-a800m and mixtral-8x22b in fp32
            and bf16 from numpy params: prefill, serve_step and
            serve_step_paged logits held to the JAX package's pinned
            values on JAX's experts (MOE_JAX_VALUES), then 4 training
            steps held to JAX's losses (tests/jax_moe_values.py)
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
  gnn_train graphsage-reddit at its published width: 4 AdamW steps on
            sampled minibatch_lg batches (1,024 seeds, fanout 15-10)
            through run_training, each step launching the forward and the
            backward kernel twice; the first losses held to the JAX
            package's; then one more step under the profiler
  gnn_launcher  the train launcher at minibatch_lg for 5 steps, its
            losses held to the JAX launcher's
  gnn_parity  the reduced config in float32, card against CPU: loss and
            every gradient
  kernel_segment_sum  segment_sum (row 5c's kernel: the backward's sum
            mode, each edge a bag of one slot) bit for bit against its
            plain version on the CPU and on a repeat: D = 1, 3, 33, 64,
            70, 128 and 130 on the pooling's, schnet's and the sampled
            batch's ids (by dst, and by src at D = 70), an all-skipped
            input, a 1,000-edge id, node 0's padding hub;
            meshgraphnet's and gatedgcn's layers timed eagerly and in a
            CUDA graph beside index_add_ and the bound
  gnn_archs gatedgcn (16 x 70) and meshgraphnet (15 x 128) at their
            published widths on the first sampled minibatch_lg batch,
            schnet (3 x 64, 300 RBFs) on 128 molecules: step 0's loss
            and gradients twice, bit-equal; 3 AdamW steps through
            run_training held to the JAX package's losses, each step
            launching segment_sum 64, 45 and 7 times; one more step under
            the profiler
  gnn_archs_parity  the three reduced configs in float32 (schnet also
            on molecules under graph_reg), card against CPU: loss and
            every gradient
  gnn_arch_launcher  each arch's train launcher at full_graph_sm for 3
            steps, its losses held to the JAX launcher's

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
                "multilevel": "f69b4e70314aafbb",
                # hype_superstep at depth 2 with snapshot_every=64 (the
                # drain at a snapshot is part of the schedule)
                "pd2_cadence64": "62ea00d540e4ddea"}
PATH_KM1 = {"batched": 52658, "quality": 60847, "multilevel": 28860}
ML_FINGERPRINT = "e3c67ff51a35cfd8"
# RefineStats.kernel_calls of the quality path in the JAX package's run
QUALITY_SCREENS = 104
# nodes of hype_device's captured round on github_like(1.0), k=32, t=16
# (torch 2.11.0+cu128 on an H100): a clean run keeps them within 2%
DEVICE_GRAPH_NODES = 1822
# partition_resilient("hype_device", t=16, snapshot_every=64,
# fault_plan="dispatch@100:fatal"): JAX's ladder raises KeyError reading
# its device snapshot's assignment, so this is JAX's superstep rung
# (depth 2, the same cadence) warm-started from the assignment of JAX's
# hype_device snapshot at 64, the run killed at 100: k-1 61685.
LADDER_DIGEST = "4ae54e05b401a645"
# hype_sharded on the slice's graph (k=32, t=16), by the JAX package on
# the CPU with 4 host devices: at one device it is the slice's run at the
# same depth (SLICE_DIGESTS); at four devices, depth 2: (digest,
# supersteps = collectives, collective_bytes, admission conflicts, k-1);
# partition_resilient's default method at devices=1, snapshot_every=64,
# killed by dispatch@100:fatal, finishing on hype_superstep warm-started
# from the snapshot at 64: (digest, k-1)
SHARDED_D4 = ("44e59fd536a9df17", 391, 6_406_144, 2_686, 61_561)
SHARDED_LADDER = ("6ce8a086dfc9fd63", 61_658)
SHARDED_RANKS = 4
# partition_and_report(hg, 32, method, seed=0) in the JAX package, its
# runtime_s left out (hype_device with t=16)
REPORTS = {
    "minmax_nb": {"digest": "0e52c320b9e81963", "report": {
        "k_minus_1": 66413, "hyperedge_cut": 34654, "soed": 101067,
        "vertex_imbalance": 0.017917331914138725,
        "replication_factor": 2.1750561757992886, "method": "minmax_nb",
        "k": 32}},
    "minmax_eb": {"digest": "5ae6b38082dc6102", "report": {
        "k_minus_1": 85152, "hyperedge_cut": 39456, "soed": 124608,
        "vertex_imbalance": 0.015498287979816183,
        "replication_factor": 2.506608397176171, "method": "minmax_eb",
        "k": 32}},
    "shp": {"digest": "bc43b408a6faaba5", "report": {
        "k_minus_1": 95756, "hyperedge_cut": 33999, "soed": 129755,
        "vertex_imbalance": 0.00018037518037518038,
        "replication_factor": 2.69422672021798, "method": "shp", "k": 32}},
    "random": {"digest": "93b5be10a9cd0e81", "report": {
        "k_minus_1": 175001, "hyperedge_cut": 48368, "soed": 223369,
        "vertex_imbalance": 0.00018037518037518038,
        "replication_factor": 4.096321590969408, "method": "random",
        "k": 32}},
    "hashing": {"digest": "78f41066a7acbc7e", "report": {
        "k_minus_1": 175942, "hyperedge_cut": 48386, "soed": 224328,
        "vertex_imbalance": 0.0027036770007209804,
        "replication_factor": 4.112970859357031, "method": "hashing",
        "k": 32}},
    "hype_device": {"digest": "11af1dd01f862a04", "report": {
        "k_minus_1": 61457, "hyperedge_cut": 15306, "soed": 76763,
        "vertex_imbalance": 0.00018037518037518038,
        "replication_factor": 2.0873688494134717, "method": "hype_device",
        "k": 32}},
}

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

# The two-tower training slice: two-tower-retrieval at its published width
# (embed 256, towers 1024-512-256, 4 fields, bag 8; fp32, TF32 off) at the
# published train_batch B = 65,536, default AdamW through make_train_step.
# Cut: each vocabulary from 16,777,216 to 2,097,152 rows. At full vocab
# the tables, their dense gradients and the two AdamW moments take 137 GB
# (JAX's AdamW decays every row every step, so the state cannot be sparse);
# at 2,097,152 rows they take 17.2 GB beside the (B, B) float32 logits
# (17.2 GB, two alive at the forward's peak). Batches: the launcher's
# RecsysStream(V, V, B, n_fields=4, bag=8), steps 0-3, made on the host
# and uploaded before the steps are timed.
RECSYS_TRAIN_VOCAB = 2_097_152
RECSYS_TRAIN_STEPS = 3
# The reduced config trained on the card from twotower_numpy_params for 4
# steps of recsys_parity_batches, with and without compress_grads, against
# the JAX package's losses on the CPU from the same params and batches
# (tests/jax_twotower_losses.py; LR 1e-2 so the losses move). The card's
# matmuls and the two packages' table-gradient scatters sum in other
# orders: rtol 1e-5 on step 0, then 1e-4, as LM_TRAIN_PARITY_TOL (a
# gradient a rounding apart can flip one int8 level of the compressed
# gradient, or move a near-zero weight by about lr under AdamW; the loss
# barely feels either).
RECSYS_PARITY_STEPS = 4
RECSYS_PARITY_OPT = dict(lr=1e-2, warmup_steps=2, total_steps=20)
RECSYS_TRAIN_JAX_LOSSES = {
    "plain": [5.785348892211914, 6.073033809661865, 5.267496109008789,
              5.496495246887207],
    "compressed": [5.785348892211914, 6.076738357543945, 5.270156383514404,
                   5.5261430740356445]}
RECSYS_PARITY_TOL = [dict(rtol=1e-5, atol=0.0)] + [
    dict(rtol=1e-4, atol=0.0)] * 3
RECSYS_LAUNCHER_STEPS = 4

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
# The forward's logsumexp (return_lse) against attention_lse_ref: both take
# float32 logs of float32 sums of the same exponentials, in other orders
# (and the bf16 kernel's ex2.approx, 2**-22 of each term), so they agree
# within the float32 tolerance of the forward.
LSE_TOL = dict(atol=2e-5, rtol=2e-5)
# At S=32,768 the plain scores would be 137 GB: the last rows of every
# head are compared (64 x 32,768 scores a head) with the plain formula.
LONG_CHECK_ROWS = 64
# The bf16 shapes timed beside SDPA: name -> (B, S, Hq, Hkv, D, window).
# qwen3-8b's layer at the lm_serve prefill and its kernel alone at the
# published S = 32,768; granite-moe-3b-a800m's layer (G = 3, D = 64) at
# B = 4, S = 4,096 (moe_train's forward); mixtral-8x22b's (G = 6, D = 128)
# at moe_window_serve's prefill, its 4,096-token window over 16,384
# tokens, and at moe_window_train's forward (B = 4, S = 4,096, where the
# window masks no key). Up to S = 4,096 every sequence is compared whole
# with the plain version (its scores at most 3.2 GB a sequence); past it,
# the last LONG_CHECK_ROWS query rows (mixtral's plain scores would be
# 51.5 GB).
FLASH_TIMED = {"layer": (LM_BATCH, LM_PROMPT, 32, 8, 128, None),
               "long": (1, LM_LONG_SEQ, 32, 8, 128, None),
               "granite_layer": (4, 4096, 24, 8, 64, None),
               "mixtral_window": (1, 16_384, 48, 8, 128, 4096),
               "mixtral_train": (4, 4096, 48, 8, 128, 4096)}
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

# flash_attention_bwd against its plain version on the card: both sum in
# float32, in other orders (tiles against einsum's blocks), and ds = p (dp -
# delta) cancels, so float32 is held to rtol 1e-4 and atol 1e-4 of the
# call's largest |gradient| (of dq, dk and dv: one that is zero in exact
# arithmetic, as dq at S = 1, is float32 noise on both sides).
# bf16 at D <= 128 runs the tensor-core kernels, which round P and dS to
# bf16 as the operands of dv = P^T dout, dk = scale dS^T q and dq = scale
# dS k (the plain version keeps them float32). bf16 keeps 8 significant
# bits, so each term p_ij dout_i moves by at most 2**-8 |p_ij dout_i|, and
# dv_j by at most 2**-8 of A_v = sum_i p_ij |dout_i|; likewise dk by 2**-8
# of A_k = scale |dS|^T |q| and dq by 2**-8 of A_q = scale |dS| |k| (the
# products on absolute values, computed by the plain side in float32:
# ref.attention_bwd_abs_ref). The products are otherwise exact and summed
# in float32, and both sides round the gradient once to bf16, so nearly
# equal sums may round one bf16 step apart (rtol 2**-7). Each element is
# held to rtol |want| + 2**-8 A + atol (atol 1e-4 of the call's largest
# |gradient|, float32 order); D above 128 runs CUDA-core kernels that round
# nothing before the sums, which the same limit covers. The rounding errors
# of P and dS have random signs, so the mean error stays under 2**-8 of the
# mean |gradient| plus that atol, which a systematic fault (a lost head or
# tile, a scaled gradient) breaks where the loose worst case may not.
BWD_TOL = {"float32": dict(rtol=1e-4, atol_frac=1e-4),
           "bfloat16": dict(rtol=2 ** -7, atol_frac=1e-4,
                            abs_ulp=FLASH_P_ULP)}
BWD_CYCLES = 2.5    # five products against the forward's two
# The LM training slice: stablelm-3b at its published width (32 layers,
# d_model 2,560, 32 heads of 80, d_ff 6,912, vocab 50,304; bf16), remat on,
# AdamW as the JAX launcher trains it (launch/cells.py: the default). train_4k
# is 256 x 4,096 tokens in 2 microbatches of 128; a microbatch of 128
# sequences does not fit the card beside 44.7 GB of params, grads, the
# float32 accumulation and the moments, so a step is 2 microbatches of 2
# sequences (16,384 tokens), for 3 steps. Batches: the launcher's
# TokenStream(vocab, 4, 4096, seed=0), step i reshaped to (2, 2, 4096).
LM_TRAIN_ARCH = "stablelm-3b"
LM_TRAIN_SEQ, LM_TRAIN_ACCUM, LM_TRAIN_MB, LM_TRAIN_STEPS = 4096, 2, 2, 3
# The reduced stablelm-3b (2 layers, d 64, vocab 512) trained on the card
# from lm_numpy_params for 4 steps of 2 microbatches of 2 x 200 tokens
# (lm_parity_batches), against the JAX package's losses on the
# CPU from the same params and batches (tests/jax_lm_losses.py; LR 1e-2 so
# the losses move). float32: the card's kernels sum in other orders than
# JAX's einsum: rtol 1e-5 on step 0, then 1e-4 (AdamW's first steps move
# each weight by about lr whatever its gradient's size, so a gradient a
# rounding apart can flip a near-zero entry; the loss barely feels it).
# bf16: JAX's einsum attention rounds the scores and probabilities to bf16,
# the card's kernels keep the scores in float32 and round P for P V only,
# and each layer rounds its residual: the losses move in their third
# decimal (the port on the CPU is 2.5e-3 from JAX's at most, see
# tests/jax_lm_losses.py --port, and the card 2.8e-3 from the port on the
# CPU in a run on other batches), so atol 2e-2, against 4 steps that move
# the loss by 0.17 (a frozen state fails from the third step).
LM_TRAIN_PARITY_STEPS = 4
LM_TRAIN_PARITY_SEQ = 200
LM_TRAIN_PARITY_OPT = dict(lr=1e-2, warmup_steps=2, total_steps=20)
LM_TRAIN_JAX_LOSSES = {
    "float32": [6.76626443862915, 6.688925743103027, 6.648444175720215,
                6.592385292053223],
    "bfloat16": [6.766615867614746, 6.688925266265869, 6.644269943237305,
                 6.594763278961182]}
LM_TRAIN_PARITY_TOL = {
    "float32": [dict(rtol=1e-5, atol=0.0)] + [dict(rtol=1e-4, atol=0.0)] * 3,
    "bfloat16": [dict(rtol=0.0, atol=2e-2)] * 4}
LM_LAUNCHER_STEPS = 4

# The MoE LM serving slice (PERF.md section 4), bf16, params drawn on the
# card. granite-moe-3b-a800m at its published width (32 layers, d 1,536,
# 24/8 heads of 64, 40 experts of d_ff 512, top-8): prefill_32k's
# sequence of 32,768 tokens, its batch cut from 32 to 4 (at B = 32 the
# cache alone is 68.7 GB), then MOE_STEPS greedy serve_steps on the
# cache padded by MOE_STEPS slots and MOE_STEPS serve_step_paged steps
# from the same prefill, fed the same tokens, appending each step's K/V
# at its slot. mixtral-8x22b at its published width (d 6,144, 48/8 heads
# of 128, 8 experts of d_ff 16,384, top-2, window 4,096) with its depth
# cut from 56 layers to 4 (281 GB of bf16 weights in all): one prompt of
# 16,384 tokens (four windows), then decode on the rolling 4,096-slot
# cache, past the window.
MOE_ARCH, MOE_BATCH, MOE_PROMPT = "granite-moe-3b-a800m", 4, 32_768
MOE_WINDOW_ARCH, MOE_WINDOW_LAYERS = "mixtral-8x22b", 4
MOE_WINDOW_BATCH, MOE_WINDOW_PROMPT = 1, 16_384
MOE_STEPS = 16
# The MoE training slices (PERF.md section 4): bf16, params drawn on the
# card from a generator seeded with 0, remat on, the launcher's AdamW
# (launch/cells.py opt_config), train_4k's sequence of 4,096 and
# accum_steps 2. train_4k's microbatch of 128 sequences is cut to the
# largest power of two up to 8 that leaves 4 GB of the card unreserved
# at the step's peak, found on the card by kernel_ab.py
# --moe-train (one process a microbatch; PERF.md section 4) and fixed
# here: the phase does not search. granite-moe-3b-a800m at all 32 layers;
# mixtral-8x22b with its depth cut from 56 layers to 1 (two layers are
# 86 GB of params, gradients and moments). Batches: the launcher's
# TokenStream(vocab, accum x mb, 4,096, seed=0), step i split into
# microbatches. At S = 4,096 mixtral's 4,096-token window masks no key.
MOE_TRAIN_SEQ, MOE_TRAIN_ACCUM = 4096, 2
MOE_TRAIN = {
    "moe_train": dict(arch=MOE_ARCH, layers=None, mb=4, steps=3),
    "moe_window_train": dict(arch=MOE_WINDOW_ARCH, layers=1, mb=4, steps=3)}
# the profiled step's aten ops whose device time is reported apart: the
# experts' products, the routing's sort and one-hot running count, the
# dispatch (the kept slots' copy into the (E, B, C, d) buffer, and its
# backward) and the combine (each slot's output gathered, and the
# gather's backward), the routing gather of top_p and its backward
MOE_PROFILE_OPS = ("aten::bmm", "aten::sort", "aten::cumsum",
                   "aten::repeat_interleave", "aten::index_copy",
                   "aten::index_select", "aten::index",
                   "aten::_index_put_impl_", "aten::gather",
                   "aten::scatter_add_")
# Paged against in-place decode on the card. Each paged step is held to a
# serve_step on a copy of the paged cache with the same keys: on a full
# rolling buffer the paged step attends to all Skv slots and the new token
# (Skv + 1 keys, as JAX's does) where serve_step overwrites the oldest
# slot first, a difference of function that the in-place decode run shows
# (printed, not held). The two attend differently: in place, scores and
# probabilities are rounded to bf16, as JAX's _decode_attention does (a
# score of 4 moves by up to 2**-8 of itself, its probability by up to
# 1.6%); paged, float32 throughout. So each layer's attention output
# differs by a percent or so, and the logits by a few percent of their
# scale, in random directions. A token whose top-K experts nearly tie
# may also take another expert in one path, which moves it by far more
# than a rounding: the reference step takes the paged step's experts
# (RouteLog), and the (token, layer) pairs where its own experts would
# differ are counted (routes_differ). Held: every logit within
# MOE_PAGED_TOL["worst"] of the largest |reference logit| of the run,
# and the mean error within MOE_PAGED_TOL["mean"] of the mean |reference
# logit| (a systematic fault, a lost key or a wrong slot, moves the
# mean; rounding in random directions does not). A first card run held
# atol 0.1, rtol 0.02 (the reduced models' tolerance): granite's
# 32 layers came to 0.055 on a scale of 4.66, mixtral's 4 to 0.113 on
# 5.31, outside it (PERF.md section 6, PR 30).
MOE_PAGED_TOL = {"worst": 2 ** -4, "mean": 2 ** -5}
# The reduced granite-moe-3b-a800m and mixtral-8x22b (2 layers, d 64, 4
# experts, top-2; mixtral's window 16) from lm_numpy_params, in float32
# and bf16, against the JAX package's values on the CPU by the same
# recipe (tests/jax_moe_values.py pins MOE_JAX_VALUES): B = 2 prompts of
# 14 tokens; prefill; the cache padded to 16 slots; 4 serve_steps fed
# JAX's greedy tokens (positions 14-17: the last two past the 16 slots,
# where the rolling buffer overwrites its oldest slot); 4 serve_step_paged
# steps from the same padded prefill, fed the same tokens, appending their
# K/V at slot pos % 16 (the last two attend to 17 keys). The first
# MOE_PARITY_COLS logits of every row of the 9 calls are pinned, and the
# experts JAX chose at each MoE call (a digit an expert, in call order).
# The port is fed JAX's experts (RouteLog): routing is discrete, and a
# near tie may go the other way under another rounding; the port's own
# choices are counted where they differ (float32: none may). Then 4
# training steps of make_train_step(lm_loss) with accum_steps 2 on
# lm_parity_batches, against JAX's losses (aux included).
MOE_PARITY_ARCHS = ("granite-moe-3b-a800m", "mixtral-8x22b")
MOE_PARITY_BATCH, MOE_PARITY_PROMPT, MOE_PARITY_SLOTS = 2, 14, 16
MOE_PARITY_STEPS, MOE_PARITY_COLS = 4, 8
# float32: the LM's card-against-CPU tolerance (the port on the CPU is
# within 5e-6 of JAX); bf16, on JAX's experts: the port's bf16 LM
# tolerance against JAX (JAX's einsum attention rounds the prefill scores
# and probabilities to bf16 where the flash kernel keeps them in float32,
# and XLA rounds silu's sigmoid step by step where torch rounds once).
MOE_PARITY_TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
                  "bfloat16": dict(atol=0.1, rtol=0.02)}
# The training losses. float32: LM_TRAIN_PARITY_TOL's (the port on the
# CPU is within 5.8e-6 of JAX's). bf16: atol 5e-2. The port on the CPU is
# already 3.6e-3 from JAX's first loss (bf16 rounding, and a route that
# flips moves its token's loss by far more than a rounding) and 1.5e-2
# from its fourth (lr 1e-2 carries the first steps' gradient differences
# on; tests/jax_moe_values.py --port); the card rounds P to bf16 besides.
# The 4 steps move the loss by 0.10 (granite) and 0.17 (mixtral), so a
# frozen state fails by the third step.
MOE_TRAIN_PARITY_TOL = {
    "float32": LM_TRAIN_PARITY_TOL["float32"],
    "bfloat16": [dict(rtol=0.0, atol=5e-2)] * 4}
# tests/jax_moe_values.py's output (JAX 0.9.0 on the CPU)
MOE_JAX_VALUES = json.loads("""
{"granite-moe-3b-a800m":{"float32":{"tokens":[[449,446],[140,69],[261,90],[484,
359]],"routes":["13133131023003323230012332323201300310020301011002010110",
"13121212313113131330301013322021212121212121322021212302","2310","1320",
"1001","3220","3201","1321","1001","3120","2310","1320","1001","3220","3201",
"1321","1001","3120"],"logits":[[[2.430576,0.23480543,2.0059996,0.82955295,
1.080083,-1.1358247,-0.081772,-0.21884777],[-1.131355,0.27714747,-1.585067,
0.21072015,-0.62298906,0.3818266,0.56727,-0.12985267]],[[0.13149771,0.66235745,
1.3567346,-1.566853,1.2461786,-0.30481756,0.7241871,-0.33427158],[-0.5822207,
0.08754636,0.06435692,1.5106347,0.37153128,0.46864322,1.0312098,0.88294494]],
[[1.5895028,-0.70402586,0.8452866,-0.66737694,2.155934,-1.5464321,0.7447327,
-0.11199763],[-0.3845128,-1.1133327,-0.80093056,0.7865434,0.13789718,
0.29547027,0.26939452,0.53407407]],[[-0.5320851,0.76583433,1.3801697,1.8609269,
1.7387166,-0.8627856,-0.9214222,-0.50303847],[-0.84937775,0.5571114,-0.6780174,
0.97547716,0.58710164,0.62094814,0.2587386,2.1741717]],[[-1.701718,-1.2211685,
1.4300697,0.5846653,0.9664103,-1.6427463,0.4541347,1.5284258],[-0.232449,
-0.5408522,-0.4154471,-0.23298442,0.34131092,0.98249364,-0.11286604,
0.45918626]],[[0.13149719,0.66235685,1.3567351,-1.566853,1.2461787,-0.30481747,
0.724187,-0.3342719],[-0.5822207,0.08754645,0.06435669,1.5106342,0.37153167,
0.4686436,1.03121,0.8829455]],[[1.5895026,-0.7040265,0.8452871,-0.66737753,
2.1559346,-1.5464321,0.7447322,-0.1119972],[-0.3845127,-1.1133331,-0.80093086,
0.786544,0.13789716,0.2954703,0.26939425,0.5340741]],[[-0.7717655,0.6410156,
0.71159184,1.9362453,1.8019563,-0.6920806,-0.8197022,-0.37682015],[-0.6125722,
0.15116014,-0.70420784,1.0974629,0.6413895,0.7487288,0.23038991,2.208678]],
[[-1.4702098,-1.4290156,1.3746933,0.7573464,1.1082029,-1.6628387,0.3969607,
1.6474315],[-0.19006047,-0.58136964,-0.46432665,-0.22864258,0.5219213,
0.49152622,-0.2932507,0.53811395]]],"losses":[6.7185674,6.709625,6.6091013,
6.609315]},"bfloat16":{"tokens":[[449,446],[140,69],[261,90],[484,359]],
"routes":["13133131023003323230012332323201300310020301011002010110",
"13121212313113131330301013322021212121212121322021212302","2310","1320",
"1001","3220","3201","1321","1001","3120","2310","1320","1001","3220","3201",
"1321","1001","3120"],"logits":[[[2.4375,0.22070312,2.0,0.83203125,1.0625,
-1.125,-0.08251953,-0.22070312],[-1.1328125,0.30078125,-1.6015625,0.20703125,
-0.65625,0.39648438,0.56640625,-0.1328125]],[[0.123535156,0.6484375,1.375,
-1.59375,1.234375,-0.28710938,0.73828125,-0.3359375],[-0.58984375,0.075683594,
0.06982422,1.5390625,0.37109375,0.43554688,1.03125,0.85546875]],[[1.6171875,
-0.69921875,0.83203125,-0.671875,2.171875,-1.5234375,0.74609375,-0.12597656],
[-0.3828125,-1.1171875,-0.796875,0.7890625,0.12988281,0.296875,0.25976562,
0.51171875]],[[-0.54296875,0.73828125,1.3828125,1.875,1.71875,-0.85546875,
-0.9296875,-0.49023438],[-0.83984375,0.5703125,-0.67578125,0.9921875,
0.58203125,0.5859375,0.26171875,2.15625]],[[-1.71875,-1.234375,1.4296875,
0.58203125,0.98046875,-1.6328125,0.45703125,1.515625],[-0.24609375,-0.53125,
-0.38867188,-0.24414062,0.3203125,0.953125,-0.12451172,0.46289062]],[[0.109375,
0.63671875,1.390625,-1.5859375,1.234375,-0.2890625,0.7265625,-0.34375],
[-0.578125,0.06591797,0.056640625,1.5390625,0.37109375,0.45117188,1.03125,
0.84375]],[[1.6171875,-0.72265625,0.8359375,-0.66015625,2.1875,-1.515625,
0.734375,-0.10888672],[-0.3828125,-1.1015625,-0.8046875,0.80078125,0.12695312,
0.29296875,0.26171875,0.515625]],[[-0.796875,0.6171875,0.6953125,1.953125,
1.8046875,-0.6796875,-0.8359375,-0.35351562],[-0.6015625,0.16503906,
-0.71484375,1.1171875,0.61328125,0.7265625,0.22949219,2.171875]],[[-1.484375,
-1.4609375,1.3828125,0.75,1.125,-1.65625,0.38476562,1.640625],[-0.21191406,
-0.57421875,-0.44921875,-0.22460938,0.5078125,0.47460938,-0.28320312,
0.54296875]]],"losses":[6.720944,6.7111425,6.620227,6.6245356]}},
"mixtral-8x22b":{"float32":{"tokens":[[449,129],[20,295],[299,67],[266,109]],
"routes":["13133131023003303230102332323201300313020301010123010110",
"13121212203113131030301231322021212112202121322320232320","1201","1020",
"1201","0212","1301","1321","2312","3121","1201","1020","1201","0212","1301",
"1320","2312","1321"],"logits":[[[1.2365541,-0.04640413,1.3906883,0.7157861,
1.6695931,-0.056624155,-0.38385332,-0.60565686],[-0.99031657,0.28709272,
-1.1595328,0.12645131,-0.6527175,0.2855547,0.37416285,-0.58900666]],
[[-0.24909574,0.4114197,1.7870461,-1.8976159,0.7635457,-0.30069453,0.15230434,
-1.5884284],[-0.5309783,-1.0443536,0.56428653,0.9098282,1.3669211,-0.25058046,
1.0093791,-0.33850142]],[[0.7951692,1.9328396,0.76467997,0.17307311,
-0.93873614,0.41687083,0.23452193,0.02192792],[-0.7544516,0.8668093,-1.8552448,
0.9739394,1.7042155,1.6304878,0.8141658,0.6386222]],[[0.45614415,1.0190098,
0.7041649,-0.602714,1.4816927,-1.5468633,-0.34164965,-1.0407717],[-1.1610612,
-0.04663966,-0.72509086,0.6074435,0.36812,0.73064303,0.964416,1.2078893]],
[[0.09264458,0.8770525,-0.9435608,-0.5177948,1.5660577,0.0093858065,0.8185502,
-1.265329],[-1.1424646,0.45940664,0.059957925,-0.45911318,0.43861747,
0.54557484,0.22302856,-0.23340121]],[[-0.24909548,0.41142014,1.7870457,
-1.8976166,0.76354456,-0.3006944,0.15230481,-1.5884284],[-0.5309788,-1.0443534,
0.5642864,0.9098279,1.3669201,-0.25057995,1.0093787,-0.33850092]],[[0.7951696,
1.9328393,0.76467884,0.17307286,-0.93873626,0.41687152,0.23452172,0.021927306],
[-0.75445145,0.8668094,-1.8552449,0.9739394,1.7042155,1.6304876,0.81416607,
0.6386221]],[[0.6466469,0.88116723,0.91839504,-0.38303366,1.458817,-1.6792859,
-0.43388447,-0.87522817],[-1.0555552,-0.52492416,-0.8254028,0.91152036,
-0.18996416,0.8050582,1.311905,0.56209046]],[[0.8911869,0.44967413,-1.039378,
-0.29109612,1.3527021,-0.17689145,0.20395944,-0.46235752],[-0.6505379,
0.38039735,0.49012554,-1.3968489,0.036434766,0.38563126,0.5274161,
-0.4767884]]],"losses":[6.7708397,6.688597,6.662448,6.6040773]},
"bfloat16":{"tokens":[[449,129],[20,295],[299,67],[266,109]],
"routes":["13133131023003303230102332323201300313020301010123010110",
"13121212203113131030301231322021212112202121322320232320","1201","1020",
"1201","0212","1301","1321","2312","3121","1201","1020","1201","0212","1301",
"1320","2312","1321"],"logits":[[[1.25,-0.07910156,1.390625,0.70703125,1.65625,
-0.053222656,-0.39648438,-0.5859375],[-0.98046875,0.28515625,-1.15625,
0.119140625,-0.66796875,0.27929688,0.36328125,-0.5859375]],[[-0.23632812,
0.40625,1.765625,-1.8828125,0.7890625,-0.29101562,0.17578125,-1.5625],
[-0.5234375,-1.0546875,0.5546875,0.91015625,1.359375,-0.25976562,1.03125,
-0.33789062]],[[0.7890625,1.9140625,0.796875,0.18359375,-0.953125,0.40820312,
0.234375,0.03149414],[-0.75390625,0.875,-1.8046875,0.95703125,1.6875,1.6015625,
0.80078125,0.6328125]],[[0.47265625,1.0234375,0.7109375,-0.5859375,1.4765625,
-1.5390625,-0.36914062,-1.0390625],[-1.171875,-0.048095703,-0.70703125,
0.58984375,0.34179688,0.71875,0.95703125,1.1953125]],[[0.08642578,0.8515625,
-0.9140625,-0.5078125,1.546875,0.012268066,0.8046875,-1.2265625],[-1.1328125,
0.44726562,0.0703125,-0.4765625,0.43554688,0.51953125,0.22753906,-0.27148438]],
[[-0.24316406,0.421875,1.7578125,-1.875,0.81640625,-0.31445312,0.17578125,
-1.546875],[-0.51171875,-1.046875,0.5625,0.8984375,1.3359375,-0.25195312,
1.015625,-0.32226562]],[[0.77734375,1.9140625,0.7890625,0.19921875,-0.9609375,
0.40820312,0.2421875,0.028808594],[-0.7578125,0.87109375,-1.8203125,0.9609375,
1.6875,1.6171875,0.80859375,0.640625]],[[0.66015625,0.89453125,0.9140625,
-0.38671875,1.4609375,-1.6796875,-0.45117188,-0.88671875],[-1.0625,-0.53515625,
-0.82421875,0.89453125,-0.19238281,0.7890625,1.3046875,0.55859375]],[[0.875,
0.421875,-1.0,-0.3046875,1.3125,-0.18164062,0.19824219,-0.4375],[-0.65234375,
0.37695312,0.48632812,-1.390625,0.038085938,0.37109375,0.515625,-0.51171875]]],
"losses":[6.7713804,6.6913247,6.6671596,6.606168]}}}
""")

# The GNN training slice: graphsage-reddit at its published width (2
# layers, d_hidden 128, mean aggregator, d_feat 602, 41 classes) on the
# minibatch_lg shape: 1,024 seeds a step, fanout 15 then 10, sampled from
# a reddit-scale source graph (232,965 nodes, 114.6M edges) and padded to
# 169,984 nodes and 168,960 edges. Every input is made here from numpy
# seeds by the functions below, which tests/jax_gnn_losses.py runs with
# the JAX package's own generators and model to pin GNN_JAX_LOSSES.
GNN_ARCH, GNN_SHAPE = "graphsage-reddit", "minibatch_lg"
GNN_STEPS, GNN_PROFILE_STEPS = 4, 1
GNN_OPT = dict(lr=3e-3, warmup_steps=5, total_steps=100, weight_decay=0.0)
GNN_KEYS = ("nodes", "edge_src", "edge_dst", "edge_mask", "node_mask",
            "labels")
# FP32 CUDA-core peak of one H100 SXM (NVIDIA's data sheet): the
# operations bound of neighbor_agg (float32 gathers, means and product).
FP32_FLOPS = 67e12
# TF32 tensor-core peak (dense) of the same card: row 5d's product.
TF32_FLOPS = 495e12
# neighbor_agg on the card against its plain version: the mean is a
# float32 sum in slot order in both (compared bit for bit); the product
# sums over D in another order (float32 rounding), and a bf16 output
# rounds once, so it may differ by one bf16 step (rtol 2**-7). The
# backward is held bit for bit to its plain version on the CPU (the
# chunk order of ref.py in both), not to this tolerance.
NA_TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
          "bfloat16": dict(atol=1e-5, rtol=2 ** -7)}
# Row 5d's output against its plain version (the float32 mean times w):
# the tile kernel multiplies on the tensor cores, each float32 mean split
# into hi = tf32(mean) and lo = tf32(mean - hi) (together within 2**-24 of
# the mean), w bfloat16 (exact in TF32) or split the same way (a third
# product, hi w_lo), every product exact, summed in float32 in the mma's
# depth steps: float32 rounding of another order, as before, so the
# tolerance stays NA_TOL's float32 one, no looser. One TF32 product (no
# split) is off by up to 2**-12 of each term and fails it
# (tests/test_torch_neighbor_agg_csr.py). The mean stays bit for bit.
NA_CSR_TOL = dict(atol=1e-5, rtol=1e-5)
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
# The float32 norm vectors of the gatedgcn and meshgraphnet layers and
# their init values (``jnp.ones``/``jnp.zeros`` in the JAX package).
GNN_NORM_INIT = {"ln_h": 1.0, "lb_h": 0.0, "ln_e": 1.0, "lb_e": 0.0}

# The other GNN archs at their published widths (src/repro/configs/
# gatedgcn.py: 16 layers of d 70, gated; meshgraphnet.py: 15 of d 128,
# sum, MLPs of 2 layers; schnet.py: 3 interactions of d 64, 300 RBFs,
# cutoff 10). gatedgcn and meshgraphnet train on gnn_setup's first
# sampled minibatch_lg batch (169,984 nodes, 168,960 edges, d_feat 602,
# 41 classes) with an edge_x (E, 4) drawn from GNN_EDGE_X_SEED; schnet on
# molecule_batch() (128 molecules: 3,840 atoms, 8,192 bonds, graph_reg).
# GNN_ARCH_STEPS AdamW steps (GNN_OPT) on that one batch, from
# gnn_numpy_params. tests/jax_gnn_losses.py runs the JAX package on the
# same inputs (gnn_arch_cfg, gnn_arch_batch, gnn_numpy_params) to pin
# GNN_ARCH_JAX_LOSSES, and the JAX train launcher at its defaults
# (full_graph_sm) for GNN_ARCH_LAUNCHER_STEPS steps to pin
# GNN_ARCH_LAUNCHER_JAX_LOSSES.
GNN_OTHER_ARCHS = ("gatedgcn", "meshgraphnet", "schnet")
GNN_ARCH_SHAPE = {"gatedgcn": "minibatch_lg", "meshgraphnet": "minibatch_lg",
                  "schnet": "molecule"}
GNN_ARCH_STEPS = 3
GNN_EDGE_X_SEED = 11
GNN_ARCH_JAX_LOSSES = {
    "gatedgcn": [14.906671524047852, 10.823894500732422, 7.5351080894470215],
    "meshgraphnet": [8.345769882202148, 6.114067554473877, 6.059131145477295],
    "schnet": [3872.765380859375, 805.4736328125, 250.62623596191406]}
GNN_ARCH_LAUNCHER_STEPS = 3
GNN_ARCH_LAUNCHER_JAX_LOSSES = {
    "gatedgcn": [2.5693013668060303, 2.569228172302246, 2.569021463394165],
    "meshgraphnet": [3.1254396438598633, 3.125066041946411,
                     3.124109983444214],
    "schnet": [4.053142547607422, 4.052979469299316, 4.0522966384887695]}
# Step 0 is one float32 forward (other summation orders: the card's
# products and the kernel's chunk order against XLA's), within float32
# rounding through 16 layers; later steps follow bf16 params updated by
# AdamW, as GNN_LOSS_TOL says.
GNN_ARCH_LOSS_TOL = GNN_LOSS_TOL[:GNN_ARCH_STEPS]
# The launcher's losses move by at least 7.3e-5 (2.8e-5 of the loss,
# gatedgcn's first step; schnet 4.0e-5, meshgraphnet 1.2e-4) a step at
# AdamWConfig()'s warm-up, so rtol 5e-6 still fails a frozen state while
# it leaves room for float32 rounding through 16 layers.
GNN_ARCH_LAUNCHER_TOL = dict(rtol=5e-6, atol=0.0)

# Full-batch GraphSAGE: graphsage-reddit at ogb_products, nothing cut
# (2,449,408 nodes and 61,859,328 edges as padded, 61,858,531 valid, d_feat
# 100, 47 classes), the train launcher's one batch (``graph_batch``:
# random_graph over the padded sizes, build_graph_batch with 5 label
# classes). Every layer aggregates through row 5d over in_neighbors_csr.
# The JAX package cannot take that shape on a host of 62 GB (its gather
# h[src] alone is 31.7 GB), so tests/jax_gnn_losses.py --what full_batch
# pins the JAX launcher's first GNN_FB_STEPS losses (AdamWConfig()) on
# the same recipe at GNN_FB_PIN_NODES nodes and the same edges a node,
# where row 5's padded matrix would pass 2**31 slots (K = 29,182).
GNN_FB_SHAPE = "ogb_products"
GNN_FB_STEPS = 3
GNN_FB_PIN_NODES = 131_072
GNN_FB_PIN_EDGES = 3_310_198      # 131,072 x 61,859,328 / 2,449,408
GNN_FULL_BATCH_JAX_LOSSES = [3.882173776626587, 3.882171154022217,
                             3.8821630477905273]
# The launcher's lr warms up, so these losses move by only 2.6e-6 and
# then 7.8e-6 a step (6.8e-7 and 2.0e-6 of the loss): rtol 5e-7, 1.9e-6
# here, about 8 float32 steps of 3.88, fails a frozen state at every
# step. The port on the CPU is within 4.8e-7 of the pins, 1.2e-7 of the
# loss (tests/jax_gnn_losses.py --what full_batch --port); the card has
# been within 6.1e-8 of the loss. The phase also asks the loss to fall.
GNN_FB_TOL = [dict(rtol=5e-7, atol=0.0)] * GNN_FB_STEPS

# The padded-array engines (hype_jax, hype_parallel): the graphs of
# benchmarks/bench_engine_scaling.py ("pl300", k=8) and
# benchmarks/bench_beyond_paper.py ("pl3000", k=16), and hype_jax on the
# 6-vertex edge graph of tests/test_hype_batched.py (two singletons, one
# empty edge), with the JAX package's (digest, k-1) of each at seed 0
# (tests/jax_hype_jax_digests.py recomputes them).
HYPE_JAX_GRAPHS = {
    "pl300": dict(n=300, m=200, seed=3, max_edge=20, max_degree=12),
    "pl3000": dict(n=3000, m=2000, seed=4, max_edge=60, max_degree=24)}
HYPE_JAX_EDGES = [[0, 1], [1, 2, 3], []]
HYPE_JAX_DIGESTS = {("hype_jax", "pl300", 8): ("3e750d64db36cd14", 166),
                    ("hype_parallel", "pl300", 8): ("ca54abcebd06a7d4", 129),
                    ("hype_jax", "pl3000", 16): ("71714f5e43d188a2", 1955),
                    ("hype_parallel", "pl3000", 16): ("5ec6ec7ecc065323",
                                                      1793),
                    ("hype_jax", "edges", 1): ("9d908ecfb6b256de", 0),
                    ("hype_jax", "edges", 3): ("ef0ad0cd848d25d6", 2),
                    ("hype_jax", "edges", 6): ("a3c9fa7cecd35741", 3)}

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


FLASH_KINDS = ("flash_tc_kernel", "flash_attention_kernel",
               "attn_bwd_dkdv_tc_kernel", "attn_bwd_dq_tc_kernel",
               "attn_bwd_dkdv_kernel", "attn_bwd_dq_kernel",
               "attn_bwd_delta_kernel")
# the bf16 tensor-core instances: each must hold HGMMA
FLASH_TC_KINDS = ("flash_tc_kernel", "attn_bwd_dkdv_tc_kernel",
                  "attn_bwd_dq_tc_kernel")


def sass_instance(kind: str, name: str) -> str:
    """``kind<args>`` from a mangled kernel name: its template arguments
    (an element type, ints such as the padded D or the tile)."""
    args = name.split(kind + "I", 1)[1]
    out = []
    while not args.startswith("E"):  # E closes the argument list
        if args.startswith("13__nv_bfloat16"):
            out.append("bf16")
            args = args[len("13__nv_bfloat16"):]
        elif args.startswith("f"):
            out.append("f32")
            args = args[1:]
        else:  # Li<n>E
            end = args.index("E")
            out.append(args[2:end])
            args = args[end + 1:]
    return f"{kind}<{','.join(out)}>"


def flash_sass(so_path: str) -> dict:
    """What the built extension's flash kernels were compiled to: per
    kernel instance (the forward's and the backward's, bf16 tensor-core and
    CUDA-core), the count of Hopper warpgroup MMA (HGMMA), warp MMA (HMMA)
    and float32 FMA (FFMA) instructions in ``cuobjdump -sass``. Raises if
    a tensor-core kind is missing or an instance of one has no HGMMA."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", so_path], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            fn = None
            for kind in FLASH_KINDS:
                if kind + "I" in name:
                    fn = sass_instance(kind, name)
                    counts[fn] = dict.fromkeys(("HGMMA", "HMMA", "FFMA"), 0)
        elif fn and "*/" in line:
            # "/*addr*/  [@P0] OPCODE.MODIFIERS operands ; /* encoding */"
            ops = [t for t in line.split("*/", 1)[1].split()
                   if not t.startswith("@")][:1]
            for key in counts[fn]:
                if ops and ops[0].split(".")[0] == key:
                    counts[fn][key] += 1
    tc = {k: v for k, v in counts.items()
          if k.split("<")[0] in FLASH_TC_KINDS}
    if ({k.split("<")[0] for k in tc} != set(FLASH_TC_KINDS)
            or any(v["HGMMA"] == 0 for v in tc.values())):
        raise SystemExit(f"a bf16 flash kernel has no HGMMA: {counts}")
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
    elif kind == "pad_phase":       # the chunked rung's padded last chunk
        nbrs[-1] = -1
        fringe[-1] = -1
        bias[-1] = np.inf
        prev[-1] = np.inf
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
    """hype_score_select against its plain version, bit for bit: the
    superstep path's shape (G=32, R=16, s=1, P=64, select_k=16) at every L
    bucket, timed eagerly and in a CUDA graph beside the launch floor (a
    one-element ``add_`` timed the same two ways), then hub rows, ties,
    pads, wide fringes and R + P past shared memory; a NaN in one row of a
    phase that spans several blocks (held as the op's contract allows:
    the other phases bit-equal, every index in [0, R + P]); and two calls
    back to back plus a CUDA graph replay, equal to one eager call (the
    kernel's ticket counters reset themselves). Returns the timed rows by
    L, the floor row and the worst error."""
    import numpy as np
    import torch
    one = torch.zeros(1, device="cuda")
    floor = {"phase": "kernel", "launch_floor": "add_ of one float32 "
             "element", "ms": cuda_ms(lambda: one.add_(1.0)),
             "graph_ms": graph_ms(lambda: one.add_(1.0))}
    emit(floor)
    rng = np.random.default_rng(0)
    P, s, R, k = 64, 1, 16, 16
    cases = [(32, R, L, s, P, k, "random") for L in (32, 128, 512, 2048)]
    cases += [(32, R, 2048, s, P, k, "hub"), (32, R, 2048, s, P, k, "ties"),
              (32, R, 2048, s, P, k, "pads"),
              (1, R, 2048, 16, P, R + P, "ties"),
              (5, 8, 33, 3, P, 8 + P, "hub"),
              # the chunked memory rung: a chunk of 16 phases (g_chunk 2
              # at k = 32), and 3 phases the last of which is all pad
              # (k = 5 in chunks of 3)
              (16, R, 2048, s, P, k, "chunk"),
              (3, R, 2048, s, P, k, "pad_phase")]
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
        if kind in ("random", "wide", "chunk"):
            nbytes = sum(t.nbytes for t in x) + sum(t.nbytes for t in out)
            # the plain version loops over the fringe in Python: one run
            # of it for the wide shapes
            few = ({} if kind != "wide"
                   else dict(reps=1, iters=1, warmup=1))
            row.update(
                ms=cuda_ms(lambda: ops.hype_score_select(*x, select_k=k_)),
                plain_ms=cuda_ms(lambda: ref.hype_score_select_ref(*x, k_),
                                 **({"iters": 20} | few)),
                bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
            if kind == "random":
                row["graph_ms"] = graph_ms(
                    lambda: ops.hype_score_select(*x, select_k=k_))
                per_l[L] = row
        emit(row)
        if not equal:
            raise SystemExit(f"kernel disagrees with its plain version: "
                             f"{row}")

    # a NaN score in phase 3 (16 blocks a phase at L = 2048)
    G, R, L, P, k = 8, 16, 2048, 64, 16
    x = kernel_inputs(rng, G, R, L, 1, P, "random")
    x[2][3, 5] = float("nan")
    out = ops.hype_score_select(*x, select_k=k)
    torch.cuda.synchronize()
    want = ref.hype_score_select_ref(*x, k)
    fin = torch.tensor([g for g in range(G) if g != 3], device="cuda")
    row = {"phase": "kernel", "G": G, "R": R, "L": L, "s": 1, "P": P,
           "select_k": k, "inputs": "nan in phase 3",
           "finite_phases_equal": all(torch.equal(a[fin], b[fin])
                                      for a, b in zip(out, want)),
           "indices_in_range": bool(((out[1] >= 0)
                                     & (out[1] <= R + P)).all()),
           "nan_phase": {"sel_idx_all_R_plus_P": bool((out[1][3]
                                                       == R + P).all()),
                         "sel_val_all_nan": bool(out[2][3].isnan().all()),
                         "rem": int(out[3][3]), "plain_rem": int(want[3][3])}}
    emit(row)
    if not (row["finite_phases_equal"] and row["indices_in_range"]):
        raise SystemExit(f"kernel breaks its NaN contract: {row}")

    # the ticket counters reset: two calls back to back, then a graph of
    # one call replayed three times, all equal to the first call
    for L in (512, 2048):
        x = kernel_inputs(rng, 32, 16, L, 1, 64, "random")
        first = ops.hype_score_select(*x, select_k=16)
        second = ops.hype_score_select(*x, select_k=16)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            ops.hype_score_select(*x, select_k=16)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = ops.hype_score_select(*x, select_k=16)
        replays = []
        for _ in range(3):
            graph.replay()
            replays.append(all(torch.equal(a, b)
                               for a, b in zip(captured, first)))
        torch.cuda.synchronize()
        row = {"phase": "kernel", "G": 32, "R": 16, "L": L,
               "inputs": "repeat and graph replay",
               "second_call_equal": all(torch.equal(a, b)
                                        for a, b in zip(second, first)),
               "replays_equal": replays}
        emit(row)
        if not (row["second_call_equal"] and all(replays)):
            raise SystemExit(f"kernel differs between calls: {row}")
    return per_l, floor, worst


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


def kway_tile(rng, B, L, k, kind="synthetic"):
    """A seeded (parts (B, L), own (B,)) int32 pair, numpy. ``synthetic``:
    every slot filled, 60% of a row's ids one hot part, 20% -1 pads
    anywhere, the last eighth of the rows pad rows. ``path``: rows as the
    refinement screen's tile holds them, ragged (heavy-tailed lengths,
    median 17, a few at L) and -1 past their length, about 96% of the
    tile trailing pads at L = 2048; the same hot part."""
    import numpy as np
    parts = rng.integers(0, k, size=(B, L)).astype(np.int32)
    hot = rng.integers(0, k, size=(B, 1))
    parts = np.where(rng.random((B, L)) < 0.6, hot, parts)
    own = rng.integers(0, k, size=B).astype(np.int32)
    if kind == "path":
        lens = np.minimum((rng.pareto(1.0, size=B) * 17).astype(np.int64), L)
        parts[np.arange(L)[None, :] >= lens[:, None]] = -1
    else:
        parts[rng.random((B, L)) < 0.2] = -1
        parts[B - B // 8:] = -1                    # pad rows
        own[B - B // 8:] = -1
    return parts.astype(np.int32), own


def phase_kernel_kway(kops, kref):
    """kway_gains (the tile front end) at the refinement screen's tile
    width (B=4096, every L bucket, k in {2, 32, 67}), a path-like tile
    (ragged rows, about 96% trailing pads) and edge cases, against its
    plain version. Returns the timed rows by (L, k) (the path-like tile
    under (2048, "path")) and the worst error."""
    import numpy as np
    import torch
    rng = np.random.default_rng(2)
    cases = [(4096, L, k, "synthetic") for L in (32, 128, 512, 2048)
             for k in (2, 32, 67)]
    cases += [(4096, 2048, 32, "path"), (17, 33, 5, "synthetic"),
              (8, 128, 1, "synthetic"), (4096, 2048, 1024, "synthetic")]
    # past the lane-private counters (k > 64): the shared counters up to
    # their last k (7,257), then the global scratch
    cases += [(4096, 512, k, "synthetic") for k in (64, 65, 2048, 7257,
                                                    7264, 10_000)]
    per_shape, worst = {}, 0.0
    for B, L, k, kind in cases:
        parts, own = kway_tile(rng, B, L, k, kind)
        x = [torch.from_numpy(a).cuda() for a in (parts, own)]
        info = {"B": B, "L": L, "k": k, "inputs": kind}
        if kind == "path":
            info["fill"] = float((parts >= 0).mean())
        row = compare_and_time(
            "kernel_kway_gains", lambda p, o: kops.kway_gains(p, o, k=k),
            lambda p, o: kref.kway_gains_ref(p, o, k), x, info,
            timed=B == 4096 and (k in (2, 32, 67) or k >= 2048),
            graph=kind == "path" or (L, k) == (2048, 32))
        worst = max(worst, row["max_abs_err"])
        if "ms" in row:
            per_shape[(L, "path" if kind == "path" else k)] = row
    return per_shape, worst


class FirstScreen:
    """While active, ``scoring.refine_gains_device`` keeps a copy of its
    first call's arguments (``args``, the assignment and delta cloned
    before the call writes into them), then runs as it would."""

    def __init__(self, scoring):
        self.scoring, self.real, self.args = scoring, None, None

    def __enter__(self):
        self.real = self.scoring.refine_gains_device
        self.scoring.refine_gains_device = self._spy
        return self

    def __exit__(self, *exc):
        self.scoring.refine_gains_device = self.real

    def _spy(self, indptr, indices, assign, delta_ids, delta_vals, cand, *,
             tile_l, k):
        if self.args is None:
            self.args = dict(indptr=indptr, indices=indices,
                             assign=assign.clone(),
                             delta_ids=delta_ids.clone(),
                             delta_vals=delta_vals.clone(),
                             cand=cand.clone(), tile_l=tile_l, k=k)
        return self.real(indptr, indices, assign, delta_ids, delta_vals,
                         cand, tile_l=tile_l, k=k)


def phase_kernel_kway_screen(kops, kref, scoring, args):
    """kway_gains_csr at the quality path's first screen (``args``, from
    ``FirstScreen``: github_like(1.0, seed=0), the supersteps' assignment,
    the first 4,096 boundary ids, tile_l 2,048, k=32): its fill, the
    kernel bit-equal to its plain version, ``refine_gains_device`` whole
    (the delta and the gains, one device program) and the kernel alone
    timed eagerly and in a CUDA graph beside the launch floor, and the
    tile chain this route replaced (the gather into a (B, tile_l) tile,
    the own parts and the tile kernel) on the same inputs, as the
    yardstick; then the kernel and the screen at k = 67 on the same
    inputs, bit-equal and timed."""
    import torch
    indptr, indices, cand = args["indptr"], args["indices"], args["cand"]
    tile_l, k = args["tile_l"], args["k"]
    assign = args["assign"].clone()
    # the first screen's delta applied, as refine_gains_device applies it
    delta = [args["delta_ids"], args["delta_vals"]]
    assign, _ = scoring.refine_gains_device(indptr, indices, assign, *delta,
                                            cand, tile_l=tile_l, k=k)
    x = (indptr, indices, assign, cand)

    def kernel():
        return kops.kway_gains_csr(*x, tile_l=tile_l, k=k)

    def plain():
        return kref.kway_gains_csr_ref(*x, tile_l, k)

    def chain():
        csafe = torch.where(cand >= 0, cand, 0).long()
        own = torch.where(cand >= 0, assign[csafe], -1).to(torch.int32)
        return kops.kway_gains(kref.gather_part_tiles(*x, tile_l), own, k=k)

    def screen():
        return scoring.refine_gains_device(indptr, indices, assign, *delta,
                                           cand, tile_l=tile_l, k=k)[1]

    out, again = kernel(), kernel()
    torch.cuda.synchronize()
    want = plain()
    err = max_abs_err([out], [want])
    # the bytes the screen must move: the candidates, two offsets and the
    # own part of each real one, its ids up to the cut and their parts,
    # and the gains; the fill is the mean of min(deg, tile_l) / tile_l
    real = cand >= 0
    c = cand[real].long()
    ids = int((indptr[c + 1] - indptr[c]).clamp(0, tile_l).sum())
    nbytes = (cand.nbytes + int(real.sum()) * (2 * indptr.element_size() + 4)
              + ids * 8 + out.nbytes)
    fill = ids / (cand.shape[0] * tile_l)
    one = torch.zeros(1, device="cuda")
    row = {"phase": "kernel_kway_screen", "B": cand.shape[0],
           "real_rows": int((cand >= 0).sum()), "tile_l": tile_l, "k": k,
           "indptr_dtype": str(indptr.dtype).split(".")[1], "fill": fill,
           "equal": torch.equal(out, want), "max_abs_err": err,
           "second_call_equal": torch.equal(again, out),
           "chain_equal": torch.equal(chain(), want),
           "screen_equal": torch.equal(screen(), want),
           "ms": cuda_ms(kernel), "graph_ms": graph_ms(kernel),
           "plain_ms": cuda_ms(plain, iters=20),
           "screen_ms": cuda_ms(screen), "screen_graph_ms": graph_ms(screen),
           "chain_ms": cuda_ms(chain), "chain_graph_ms": graph_ms(chain),
           "launch_floor_ms": cuda_ms(lambda: one.add_(1.0)),
           "launch_floor_graph_ms": graph_ms(lambda: one.add_(1.0)),
           "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    # k = 67 on the same inputs: the kernel alone and the screen whole
    # (its delta written again: the same values)
    w67 = kref.kway_gains_csr_ref(*x, tile_l, 67)
    k67 = {"k": 67,
           "equal": torch.equal(kops.kway_gains_csr(*x, tile_l=tile_l,
                                                    k=67), w67),
           "screen_equal": torch.equal(scoring.refine_gains_device(
               indptr, indices, assign, *delta, cand, tile_l=tile_l,
               k=67)[1], w67),
           "ms": cuda_ms(lambda: kops.kway_gains_csr(*x, tile_l=tile_l,
                                                     k=67)),
           "graph_ms": graph_ms(lambda: kops.kway_gains_csr(
               *x, tile_l=tile_l, k=67)),
           "screen_ms": cuda_ms(lambda: scoring.refine_gains_device(
               indptr, indices, assign, *delta, cand, tile_l=tile_l, k=67)),
           "screen_graph_ms": graph_ms(lambda: scoring.refine_gains_device(
               indptr, indices, assign, *delta, cand, tile_l=tile_l, k=67))}
    k67["bound_ms"] = (nbytes - out.nbytes + w67.nbytes) / HBM_BYTES_PER_S \
        * 1e3
    row["k67"] = k67
    emit(row)
    if not (row["equal"] and row["second_call_equal"] and row["chain_equal"]
            and row["screen_equal"] and k67["equal"]
            and k67["screen_equal"]):
        raise SystemExit(f"kway_gains_csr disagrees with its plain "
                         f"version: {row}")
    return row


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


# tiny kernels run ahead of the profiled call in its window, and the
# name that marks the call (phase_profile)
PROFILE_WARMUP_LAUNCHES = 1000
PROFILE_MARK = "phase_profile.call"


def phase_profile(label, fn, watch=(), ops=()):
    """Where the time goes in one path, from one more run of it under
    torch.profiler: the card's busy time (kernels and copies, summed over
    device-side events only) and its largest consumers. The run ends in
    a synchronize, so the wall time covers the card's work. ``watch``
    names kernels (substrings of their names) whose device time and
    launch count are also reported, each summed, with its share of the
    busy time. ``device_launches`` counts the call's device events
    (kernels and copies).

    Once a process has run for a while, the profiler drops kernel
    records at the start of a window, with no error: they are missing
    from its trace, more of them the longer the process has run. So the
    window opens with PROFILE_WARMUP_LAUNCHES one-element adds,
    synchronised, and only device events that start inside the call's
    PROFILE_MARK range are counted; ``warmup_kept`` says how many of the
    adds' records survived (fewer than were launched: some were lost,
    ahead of the call). ``ops`` names aten ops (``aten::bmm``) whose
    self device time, the kernels each launched itself (in the forward
    and the backward), is also reported, summed by name, with its share
    of the busy time.
    """
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    one = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_WARMUP_LAUNCHES):
            one.add_(1.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with record_function(PROFILE_MARK):
            fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    start = min(e.time_range.start for e in events
                if e.name == PROFILE_MARK)
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.name != PROFILE_MARK]
    dev, calls = collections.Counter(), collections.Counter()
    for e in device:
        if e.time_range.start >= start:
            dev[e.name] += e.time_range.elapsed_us()
            calls[e.name] += 1
    busy_s = sum(dev.values()) / 1e6
    top = collections.Counter()
    for key, us in dev.items():
        top[key[:60]] += us
    watched = {w: sum(us for key, us in dev.items() if w in key)
               for w in watch}
    op_us = dict.fromkeys(ops, 0.0)
    for e in events:
        if (e.device_type == DeviceType.CPU and e.name in op_us
                and e.time_range.start >= start):
            us = getattr(e, "self_device_time_total", None)
            op_us[e.name] += e.self_cuda_time_total if us is None else us
    emit({"phase": "profile", "path": label, "wall_s": wall,
          "device_busy_s": busy_s, "device_idle_share": 1 - busy_s / wall,
          "device_launches": sum(calls.values()),
          "top_device_us": dict(top.most_common(6)),
          "warmup_launches": PROFILE_WARMUP_LAUNCHES,
          "warmup_kept": len(device) - sum(calls.values())} | ({
              "watched_device_us": watched,
              "watched_launches": {w: sum(n for key, n in calls.items()
                                          if w in key) for w in watch},
              "watched_share_of_busy": {
                  w: us / 1e6 / busy_s for w, us in watched.items()}}
              if watch else {}) | ({
              "op_device_us": op_us,
              "op_share_of_busy": {o: us / 1e6 / busy_s
                                   for o, us in op_us.items()}}
              if ops else {}))


def kernel_split(fn, iters: int = 5) -> dict:
    """Each launch's share of ``fn``: its device events (kernels and
    memsets) under torch.profiler over ``iters`` calls after one warm-up,
    summed by the kernel's name (namespace and template arguments cut),
    ms a call. The window opens as phase_profile's does, and only events
    inside the calls' PROFILE_MARK range count."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    one = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_WARMUP_LAUNCHES):
            one.add_(1.0)
        torch.cuda.synchronize()
        with record_function(PROFILE_MARK):
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
    events = prof.events()
    start = min(e.time_range.start for e in events
                if e.name == PROFILE_MARK)
    split = collections.Counter()
    for e in events:
        if (e.device_type == DeviceType.CUDA and e.name != PROFILE_MARK
                and e.time_range.start >= start):
            name = e.name.split("<")[0].split("::")[-1].split("(")[0]
            split[name.removeprefix("void ").strip()] += \
                e.time_range.elapsed_us()
    return {k: us / iters / 1e3 for k, us in split.items()}


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
                                                  combine=combine),
                       iters=20),
            plain_ms=cuda_ms(lambda: bref.embedding_bag_ref(table, ids,
                                                            combine),
                             reps=3, iters=20),
            library_ms=cuda_ms(lambda: F.embedding_bag(
                flat, table, mode="sum", per_sample_weights=weights),
                iters=20),
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


def twotower_numpy_params(cfg, rng) -> dict:
    """Two-tower params as numpy float64, in the JAX package's layout:
    each table ``normal * 0.02``, each tower weight ``normal /
    sqrt(fan_in)`` and bias ``normal * 0.1``, drawn in this order from
    ``rng`` (a numpy Generator, advanced). ``cfg`` is either package's
    TwoTowerConfig."""
    import numpy as np
    dims = (cfg.n_fields * cfg.embed_dim,) + tuple(cfg.tower_dims[1:])

    def tower():
        p = {f"w{i}": rng.normal(size=(dims[i], dims[i + 1])) /
             np.sqrt(dims[i]) for i in range(len(dims) - 1)}
        p.update({f"b{i}": rng.normal(size=dims[i + 1]) * 0.1
                  for i in range(len(dims) - 1)})
        return p

    return {"user_table": rng.normal(size=(cfg.user_vocab,
                                           cfg.embed_dim)) * 0.02,
            "item_table": rng.normal(size=(cfg.item_vocab,
                                           cfg.embed_dim)) * 0.02,
            "user_tower": tower(), "item_tower": tower()}


def recsys_parity_batches(cfg, B: int = 32) -> list:
    """The recsys_train_parity phase's batches as numpy: RecsysStream's
    recipe (B rows of n_fields bags, 30% of the slots dropped to -1, the
    item bags drawn first) with uniform ids from ``rng.integers``, a fifth
    of them set to row 0 (a popular row, many slots on one table row),
    and ``item_logq`` uniform in (-8, 0], from ``default_rng([13,
    step])``. RecsysStream's ``Generator.zipf`` gives other numbers under
    other numpy versions (see lm_parity_batches); these streams do not."""
    import numpy as np
    out = []
    for step in range(RECSYS_PARITY_STEPS):
        rng = np.random.default_rng([13, step])

        def bags(vocab):
            ids = rng.integers(0, vocab, size=(B, cfg.n_fields,
                                               cfg.bag_size))
            ids[rng.random(ids.shape) < 0.2] = 0
            return np.where(rng.random(ids.shape) < 0.3, -1,
                            ids).astype(np.int32)

        item_ids = bags(cfg.item_vocab)
        logq = (-8.0 * rng.random(B)).astype(np.float32)
        out.append({"user_ids": bags(cfg.user_vocab), "item_ids": item_ids,
                    "item_logq": logq})
    return out


def phase_recsys_parity(recsys, convert, cfg):
    """The reduced config from numpy params: the card (the kernel)
    against the CPU (the plain version), within PARITY_TOL; top-k
    indices equal except between scores that tie within it."""
    import numpy as np
    import torch
    rng = np.random.default_rng(5)
    tree = twotower_numpy_params(cfg, rng)
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


def bag_bwd_bound(g, ids, V, out_itemsize):
    """(bytes, bound ms) of the table's gradient: the rows of g whose bag
    has a valid slot and the ids read once, the (V, D) gradient written
    once (zeros where no slot names a row); an add (and for ``mean`` a
    division) per valid slot and element is far below the bytes."""
    B, D = g.shape
    live = int(((ids >= 0).sum(1) > 0).sum())
    nbytes = live * D * 4 + ids.numel() * 4 + V * D * out_itemsize
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3


def bag_bwd_case(bops, bref, g, ids, V, combine, dtype, row):
    """One embedding_bag_bwd case: the kernel on the card against the
    plain version on the CPU, bit for bit (``index_add_`` adds in index
    order there, the kernel's chunk order; on the card it adds with
    atomics), and a second launch equal to the first. Returns the row
    and the kernel's output."""
    import torch
    out = bops.embedding_bag_bwd(g, ids, V, combine, dtype)
    again = bops.embedding_bag_bwd(g, ids, V, combine, dtype)
    torch.cuda.synchronize()
    want = bref.embedding_bag_bwd_ref(g.cpu(), ids.cpu(), V,
                                      combine).to(dtype)
    got = out.cpu()
    row = {"phase": "kernel_embedding_bag_bwd", **row,
           "dtype": str(dtype).removeprefix("torch."), "combine": combine,
           "V": V, "bags": ids.shape[0], "bag": ids.shape[1],
           "D": g.shape[1], "equal": torch.equal(got, want),
           "run_to_run_equal": torch.equal(out, again),
           "max_abs_err": max_abs_err([got], [want])}
    emit(row)
    if not (row["equal"] and row["run_to_run_equal"]):
        raise SystemExit(f"embedding_bag_bwd disagrees with its plain "
                         f"version: {row}")
    return row, out


def phase_kernel_bag_bwd(bops, bref):
    """The table's gradient (row 4b: the neighbour aggregation's backward
    kernel with the bags as rows, in its mean and sum modes) on the card
    against its plain version on the CPU, bit for bit: edge cases on small
    tables in fp32 and bf16, mean and sum; one case run twice for equal
    bits; ids near V - 1 of a 16,777,216 x 256 output (row offsets past
    2**32 elements), checked on the named rows with every other element
    zero; then the training shape: both towers' 262,144 bags of 8 from
    RecsysStream at V = 2,097,152, timed eagerly (the kernel alone on a
    built index, and the wrapper with its index build) and in a CUDA
    graph, beside the plain version on the card and autograd's backward
    of F.embedding_bag(mode='mean') (its forward not timed), with each
    launch's share (the tickets' memset and the one launch of the heavy
    and light passes), and for the user tower again with the heaviest
    id's, then every heavy id's, slots moved to random rows (the split
    of the heavy ids' cost).
    Returns the user tower's timed row and the worst error."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.data.pipeline import RecsysStream
    from repro_torch.kernels._build import load_extension
    from repro_torch.kernels.neighbor_agg import ops as nops
    from repro_torch.kernels.neighbor_agg import ref as nref
    ext = load_extension()
    rng = np.random.default_rng(29)
    gen = torch.Generator("cuda").manual_seed(29)
    worst = 0.0
    small = [(1000, 256, 512, 8, "random"), (100, 33, 64, 5, "odd_d"),
             (50, 64, 40, 1, "bag1"), (300, 128, 17, 40, "wide_bag"),
             (200, 256, 64, 8, "duplicates"), (200, 256, 64, 8, "all_pad"),
             (500, 128, 4000, 8, "hub")]
    for V, D, B, bag, kind in small:
        ids = rng.integers(-1, V, size=(B, bag)).astype(np.int32)
        if kind == "duplicates":
            ids[:, 1:] = ids[:, :1]
        elif kind == "all_pad":
            ids[::2] = -1
        elif kind == "hub":                # row 3 named by ~16,000 slots
            ids[rng.random(ids.shape) < 0.5] = 3
        ids = torch.from_numpy(ids).cuda()
        g = torch.randn((B, D), device="cuda", generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            for combine in ("mean", "sum"):
                row, _ = bag_bwd_case(bops, bref, g, ids, V, combine, dtype,
                                      {"inputs": kind})
                worst = max(worst, row["max_abs_err"])

    # ids near V - 1 of the full-width table: the kernel writes the whole
    # (V, D) gradient; the plain version runs on the named rows only
    # (compacted in id order, which keeps each row's slots in order)
    V, D = 16_777_216, 256
    ids = (V - 1 - rng.integers(0, 4096, size=(4096, 8))).astype(np.int32)
    ids[0] = V - 1
    ids[rng.random(ids.shape) < 0.1] = -1
    named, compact = np.unique(ids[ids >= 0], return_inverse=True)
    cids = np.full(ids.shape, -1, np.int32)
    cids[ids >= 0] = compact
    ids, cids = torch.from_numpy(ids).cuda(), torch.from_numpy(cids)
    rows = torch.from_numpy(named).cuda().long()
    g = torch.randn((ids.shape[0], D), device="cuda", generator=gen)
    for dtype, combine in ((torch.float32, "mean"), (torch.float32, "sum"),
                           (torch.bfloat16, "mean"),
                           (torch.bfloat16, "sum")):
        out = bops.embedding_bag_bwd(g, ids, V, combine, dtype)
        torch.cuda.synchronize()
        want = bref.embedding_bag_bwd_ref(g.cpu(), cids, len(named),
                                          combine).to(dtype)
        got = out[rows].cpu()
        row = {"phase": "kernel_embedding_bag_bwd", "inputs": "ids_near_V-1",
               "dtype": str(dtype).removeprefix("torch."),
               "combine": combine, "V": V, "D": D,
               "named_rows": len(named),
               "equal": torch.equal(got, want),
               "zero_elsewhere": int(torch.count_nonzero(out))
               == int(torch.count_nonzero(out[rows])),
               "max_abs_err": max_abs_err([got], [want])}
        emit(row)
        worst = max(worst, row["max_abs_err"])
        del out
        if not (row["equal"] and row["zero_elsewhere"]):
            raise SystemExit(f"embedding_bag_bwd disagrees near V - 1: "
                             f"{row}")
    torch.cuda.empty_cache()

    # the training shape: both towers' bags of step 0 of the launcher's
    # stream at the cut vocabulary
    V, D = RECSYS_TRAIN_VOCAB, 256
    batch = RecsysStream(V, V, 65_536, n_fields=4, bag=8).batch_at(0)
    timed = {}
    for side in ("user", "item"):
        ids = torch.from_numpy(batch[f"{side}_ids"].reshape(-1, 8)).cuda()
        g = torch.randn((ids.shape[0], D), device="cuda", generator=gen)
        row, out = bag_bwd_case(bops, bref, g, ids, V, "mean",
                                torch.float32,
                                {"inputs": f"training shape, {side} tower"})
        worst = max(worst, row["max_abs_err"])
        index = nops.transpose_index(ids, V)
        counts = index.rowptr[1:] - index.rowptr[:-1]
        nbytes, bound = bag_bwd_bound(g, ids, V, 4)
        # F.embedding_bag over a table with a zero row at V for the pads
        table = torch.zeros((V + 1, D), device="cuda", requires_grad=True)
        flat = torch.where(ids >= 0, ids, V).long()
        lib_out = F.embedding_bag(flat, table, mode="mean", padding_idx=V)
        lib_grad = torch.autograd.grad(lib_out, table, g,
                                       retain_graph=True)[0]
        row.update(
            valid_slots=int((ids >= 0).sum()),
            heaviest_id_slots=int(counts.max()),
            heaviest_id=int(counts.argmax()),
            chunk_units=int(index.hptr[-1]),
            rows_named=int((counts > 0).sum()),
            ms=cuda_ms(lambda: ext.neighbor_agg_bwd(g, *index, False, True),
                       reps=5, iters=10, warmup=3),
            graph_ms=graph_ms(lambda: ext.neighbor_agg_bwd(
                g, *index, False, True), iters=10),
            wrapper_ms=cuda_ms(lambda: bops.embedding_bag_bwd(g, ids, V),
                               reps=3, iters=5, warmup=2),
            plain_ms=cuda_ms(lambda: bref.embedding_bag_bwd_ref(g, ids, V),
                             reps=3, iters=3, warmup=1),
            library_ms=cuda_ms(lambda: torch.autograd.grad(
                lib_out, table, g, retain_graph=True), reps=5, iters=10,
                warmup=3),
            library_call="autograd of F.embedding_bag(mode='mean', "
                         "padding_idx=V) on a zero-padded table, forward "
                         "not timed",
            library_max_abs_err=float((lib_grad[:V] - out).abs().max()),
            bytes=nbytes, bound_ms=bound, bound_by="bytes",
            # each launch's share (the memset, the one launch of both
            # passes), and the light pass alone (the light ids and the
            # runs of empty ids: no unit list, so no heavy block)
            split_ms=kernel_split(lambda: ext.neighbor_agg_bwd(
                g, *index, False, True)),
            light_pass_ms=cuda_ms(lambda: ext.neighbor_agg_bwd(
                g, *index[:4], index.hunit[:0], False, True), reps=5,
                iters=10, warmup=3))
        if side == "user":
            # where the time goes: the same launch with the heaviest id's
            # slots, then every heavy id's (more than CHUNK slots), moved
            # to random rows, so that their chunk sums and the serial
            # tail of adding a hub's partials drop out
            heavy = counts > nref.CHUNK
            for key, moved in (("no_hub", ids == int(counts.argmax())),
                               ("light_only", (ids >= 0) & heavy[
                                   ids.clamp_min(0).long()])):
                spread = torch.where(moved, torch.randint(
                    0, V, ids.shape, device="cuda", generator=gen,
                    dtype=torch.int32), ids)
                idx = nops.transpose_index(spread, V)
                row[f"{key}_ms"] = cuda_ms(lambda: ext.neighbor_agg_bwd(
                    g, *idx, False, True), reps=5, iters=10, warmup=3)
                row[f"{key}_chunk_units"] = int(idx.hptr[-1])
                del idx, spread
        emit({"phase": "kernel_embedding_bag_bwd", "shape":
              f"training shape timing, {side} tower",
              **{k: v for k, v in row.items() if k != "phase"}})
        timed[side] = row
        del out, index, table, lib_out, lib_grad, g
        torch.cuda.empty_cache()
    return timed["user"] | {"item_tower": {k: timed["item"][k] for k in (
        "ms", "graph_ms", "plain_ms", "library_ms", "bound_ms",
        "heaviest_id_slots", "chunk_units")}}, worst


def recsys_train_step_fn(cfg):
    """make_train_step of twotower_loss with the launcher's AdamW."""
    from repro_torch.launch.cells import opt_config
    from repro_torch.models import recsys
    from repro_torch.train.train_loop import make_train_step
    return make_train_step(lambda p, b: recsys.twotower_loss(p, b, cfg),
                           opt_config("two-tower-retrieval"))


def phase_recsys_train(launches):
    """two-tower-retrieval at its published width, its vocabularies cut to
    RECSYS_TRAIN_VOCAB: the launcher's params and RecsysStream batches
    at B = 65,536, RECSYS_TRAIN_STEPS AdamW steps through
    make_train_step (fp32, TF32 off), each launching the EmbeddingBag
    kernel and its backward once a tower; wall per step, examples/s, the
    peak memory after the first step and over the run, finite losses, no
    all-zero gradient leaf (one more value_and_grad), the loss's forward
    and backward alone in CUDA events; then one more step under the
    profiler (the two kernels' and the GEMMs' device time)."""
    import dataclasses as dc

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import train as launch_train
    from repro_torch.models import recsys
    from repro_torch.train.optimizer import init_adamw
    from repro_torch.launch.cells import opt_config
    from repro_torch.train.train_loop import value_and_grad
    from repro_torch.train.tree import tree_flatten

    torch.backends.cuda.matmul.allow_tf32 = False
    arch = get_arch("two-tower-retrieval")
    cfg = dc.replace(arch.build_cfg(), user_vocab=RECSYS_TRAIN_VOCAB,
                     item_vocab=RECSYS_TRAIN_VOCAB)
    (B, _, _), _ = arch.input_specs("train_batch")["user_ids"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = launch_train.recsys_params(cfg, "cuda")
    opt = init_adamw(params, opt_config("two-tower-retrieval"))
    batch_at = launch_train.recsys_batches(arch, "train_batch", False, cfg,
                                           "cuda")
    batches = [batch_at(i) for i in range(RECSYS_TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    step_fn = recsys_train_step_fn(cfg)
    walls, losses, peaks = [], [], []

    def steps():
        nonlocal params, opt
        for b in batches[:RECSYS_TRAIN_STEPS]:
            t1 = time.perf_counter()
            params, opt, m = step_fn(params, opt, b)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
            peaks.append(torch.cuda.max_memory_allocated() / 1e9)

    _, wall, counts = launches.drive(steps)
    need = {"embedding_bag": 2 * RECSYS_TRAIN_STEPS,
            "embedding_bag_bwd": 2 * RECSYS_TRAIN_STEPS}
    _, grads = value_and_grad(lambda p, b: recsys.twotower_loss(p, b, cfg),
                              params, batches[0])
    names = [f"{k}/{n}" if isinstance(v, dict) else k
             for k, v in sorted(params.items())
             for n in (sorted(v) if isinstance(v, dict) else [None])]
    zero = [n for n, g in zip(names, tree_flatten(grads)) if not g.any()]
    del grads
    # the loss alone at the step's shape: forward and hand-written
    # backward from the towers' outputs
    gen = torch.Generator("cuda").manual_seed(3)
    u = torch.nn.functional.normalize(torch.randn(
        (B, cfg.tower_dims[-1]), device="cuda", generator=gen), dim=-1)
    i = torch.nn.functional.normalize(torch.randn(
        (B, cfg.tower_dims[-1]), device="cuda", generator=gen), dim=-1)
    u.requires_grad_(True)
    i.requires_grad_(True)
    logq = batches[0]["item_logq"]

    def loss_fwd_bwd():
        loss = recsys._InBatchSoftmax.apply(u, i, logq, cfg.temperature)
        torch.autograd.grad(loss, (u, i))

    loss_ms = cuda_ms(loss_fwd_bwd, reps=3, iters=3, warmup=1)
    del u, i
    row = {"phase": "recsys_train", "config": "two-tower-retrieval",
           "embed_dim": cfg.embed_dim, "tower_dims": cfg.tower_dims,
           "n_fields": cfg.n_fields, "bag_size": cfg.bag_size, "batch": B,
           "vocab": RECSYS_TRAIN_VOCAB, "published_vocab": 16_777_216,
           "tf32": torch.backends.cuda.matmul.allow_tf32,
           "param_gb": sum(t.nbytes for t in tree_flatten(params)) / 1e9,
           "setup_s": setup_s, "step_wall_s": walls,
           "examples_per_s": [B / w for w in walls], "wall_s": wall,
           "losses": losses, "peak_gb_first_step": peaks[0],
           "peak_gb": max(peaks), "zero_grad_leaves": zero,
           "loss_fwd_bwd_ms": loss_ms, "launches": counts,
           "expected_launches": need}
    emit(row)
    if {k: v for k, v in counts.items() if v} != need:
        raise SystemExit(f"recsys_train launched {counts}, not {need}")
    if zero or not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"recsys_train failed: {row}")
    b = batches[RECSYS_TRAIN_STEPS]
    phase_profile("recsys_train_step", lambda: step_fn(params, opt, b),
                  watch=("embedding_bag_kernel", "neighbor_agg_bwd_kernel",
                         "gemm"))
    del params, opt, batches, b
    torch.cuda.empty_cache()


def phase_recsys_train_parity(launches):
    """The reduced two-tower config on the card in float32 (TF32 off):
    params from twotower_numpy_params, batches from
    recsys_parity_batches, RECSYS_PARITY_STEPS steps of make_train_step
    with and without compress_grads, held to the JAX package's pinned
    losses (RECSYS_PARITY_TOL); each step launches the EmbeddingBag
    kernel and its backward once a tower."""
    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.configs import get_arch
    from repro_torch.models import recsys
    from repro_torch.train.grad_compression import init_error_feedback
    from repro_torch.train.optimizer import AdamWConfig, init_adamw
    from repro_torch.train.train_loop import make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("two-tower-retrieval").build_cfg(reduced=True)
    tree = twotower_numpy_params(cfg, np.random.default_rng(5))
    batches = [{k: torch.from_numpy(v).cuda() for k, v in b.items()}
               for b in recsys_parity_batches(cfg)]
    opt_cfg = AdamWConfig(**RECSYS_PARITY_OPT)
    for variant in ("plain", "compressed"):
        compress = variant == "compressed"
        params = convert.twotower_params_from_numpy(tree, cfg, "cuda")
        state = [params, init_adamw(params, opt_cfg)]
        if compress:
            state.append(init_error_feedback(params))
        step_fn = make_train_step(
            lambda p, b: recsys.twotower_loss(p, b, cfg), opt_cfg,
            compress_grads=compress)

        def run():
            nonlocal state
            out = []
            for b in batches:
                p, o, m, *err = step_fn(*state[:2], b, *state[2:])
                state = [p, o, *err]
                out.append(float(m["loss"]))
            return out

        losses, wall, counts = launches.drive(run)
        need = {"embedding_bag": 2 * RECSYS_PARITY_STEPS,
                "embedding_bag_bwd": 2 * RECSYS_PARITY_STEPS}
        pinned = RECSYS_TRAIN_JAX_LOSSES[variant]
        close = [bool(math.isclose(a, b, rel_tol=t["rtol"],
                                   abs_tol=t["atol"]))
                 for a, b, t in zip(losses, pinned, RECSYS_PARITY_TOL)]
        row = {"phase": "recsys_train_parity",
               "config": "two-tower-retrieval reduced, float32",
               "compress_grads": compress, "opt": RECSYS_PARITY_OPT,
               "tf32": torch.backends.cuda.matmul.allow_tf32,
               "losses": losses, "jax_losses": pinned,
               "max_abs_diff": max(abs(a - b)
                                   for a, b in zip(losses, pinned)),
               "tol": RECSYS_PARITY_TOL, "close": close, "wall_s": wall,
               "launches": counts, "expected_launches": need}
        emit(row)
        if {k: v for k, v in counts.items() if v} != need:
            raise SystemExit(f"recsys_train_parity launched {counts}")
        if len(losses) != len(pinned) or not all(close):
            raise SystemExit(f"recsys_train_parity differs from JAX's "
                             f"losses: {row}")


def phase_recsys_launcher(launches):
    """``python -m repro_torch.launch.train --arch two-tower-retrieval
    --reduced --steps 4`` on the card, in a fresh checkpoint directory:
    4 steps, no failure, finite losses, and the EmbeddingBag kernel and
    its backward launched once a tower and step."""
    import tempfile

    from repro_torch.launch import train as launch_train
    argv = ["--arch", "two-tower-retrieval", "--reduced", "--steps",
            str(RECSYS_LAUNCHER_STEPS)]
    with tempfile.TemporaryDirectory() as d:
        res, wall, counts = launches.drive(lambda: launch_train.main(
            argv + ["--ckpt_dir", d]))
    need = {"embedding_bag": 2 * RECSYS_LAUNCHER_STEPS,
            "embedding_bag_bwd": 2 * RECSYS_LAUNCHER_STEPS}
    losses = [m["loss"] for m in res.metrics_history]
    row = {"phase": "recsys_launcher", "argv": argv, "wall_s": wall,
           "steps": res.steps_done,
           "failures_recovered": res.failures_recovered, "losses": losses,
           "launches": counts, "expected_launches": need}
    emit(row)
    if (res.steps_done != RECSYS_LAUNCHER_STEPS or res.failures_recovered
            or len(losses) != RECSYS_LAUNCHER_STEPS
            or not all(math.isfinite(x) for x in losses)):
        raise SystemExit(f"the two-tower train launcher failed: {row}")
    if {k: v for k, v in counts.items() if v} != need:
        raise SystemExit(f"the two-tower train launcher launched {counts}")


def run_recsys(launches, bops, bref):
    """The two-tower slice: full-width tables drawn on the card, the
    EmbeddingBag kernel phase on them, the serving paths, the serve
    launcher (after the tables are freed), the reduced parity run and
    the placement; then training: the table-gradient kernel phase, the
    full-width step at the cut vocabulary, the reduced config on JAX's
    losses and the train launcher. Returns the forward kernel's timed
    rows and its worst error, and the backward's."""
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
    t0 = time.perf_counter()
    bwd_row, worst_bwd = phase_kernel_bag_bwd(bops, bref)
    phase_recsys_train(launches)
    phase_recsys_train_parity(launches)
    phase_recsys_launcher(launches)
    emit({"phase": "recsys_train_done", "wall_s": time.perf_counter() - t0})
    return timed, worst, bwd_row, worst_bwd


def attention_bound(B, S, Hq, Hkv, D, window=None):
    """(FLOPs, bytes, bound ms) of one causal bf16 attention call: 4 D
    FLOP (QK^T and PV) per unmasked (query, key) pair, S (S + 1) / 2 of
    them per batch row and q-head (with a window W < S: W (W + 1) / 2 +
    (S - W) W), at the bf16 tensor-core peak; q, k and v read once and
    the output written once. The bound is the larger of the two times."""
    W = S if window is None else min(window, S)
    pairs = W * (W + 1) // 2 + (S - W) * W
    flops = 4 * B * Hq * D * pairs
    nbytes = (2 * Hq + 2 * Hkv) * B * S * D * 2
    bound_ms = max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
    return flops, nbytes, bound_ms


def attention_rows_plain(q, k, v, start, window=None):
    """The plain version's formula (kernels/flash_attention/ref.py),
    causal (and windowed: key j seen by query i when i - window < j), for
    query rows start..S-1 only: (B, S - start, Hq, D)."""
    import torch
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q[:, start:].reshape(B, S - start, Hkv, Hq // Hkv, D)
    scores = torch.einsum("bshgd,bthd->bhgst", qg.float(),
                          k.float()) / math.sqrt(D)
    i = torch.arange(start, S, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    seen = j <= i
    if window is not None:
        seen &= j > i - window
    probs = torch.softmax(torch.where(seen, scores, -1e30), dim=-1)
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
    the FLASH_TIMED shapes: the full-width layers of qwen3-8b (B=8,
    S=4096, 32 q-heads, 8 kv-heads, D=128), granite-moe-3b-a800m (B=4,
    S=4096, 24/8 heads, D=64) and mixtral-8x22b's training forward (B=4,
    S=4096, 48/8 heads, D=128, window 4,096), compared one sequence at a
    time so the plain scores stay at 3.2 GB; qwen3-8b's at B=1, S=32,768 and
    mixtral-8x22b's (B=1, S=16,384, 48/8 heads, D=128, window 4,096),
    where the plain version is neither run whole nor timed (its scores
    would be 137 and 51.5 GB) and the last LONG_CHECK_ROWS query rows of
    every head are compared with its formula. Each is timed beside
    F.scaled_dot_product_attention (sdpa_ms)."""
    import torch
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
        out, lse = fops.flash_attention(*x, causal=causal, window=window,
                                        return_lse=True)
        torch.cuda.synchronize()
        want = fref.attention_ref(*x, causal=causal, window=window)
        want_lse = fref.attention_lse_ref(*x[:2], causal=causal,
                                          window=window)
        row = {"phase": "kernel_flash_attention", "B": B, "S": S, "Hq": Hq,
               "Hkv": Hkv, "D": D, "causal": causal, "window": window,
               "dtype": dtype, **flash_check(out, want, x[2], dtype),
               "lse_max_abs_err": float((lse - want_lse).abs().max()),
               "lse_tol": LSE_TOL,
               "lse_close": bool(torch.allclose(lse, want_lse, **LSE_TOL))}
        worst = max(worst, row["max_abs_err"])
        emit(row)
        if not (row["close"] and row["lse_close"]):
            raise SystemExit(f"flash_attention disagrees with its plain "
                             f"version: {row}")

    timed = {}
    for name, (B, S, Hq, Hkv, D, window) in FLASH_TIMED.items():
        x = inputs(B, S, Hq, Hkv, D, "bfloat16")
        row = {"phase": "kernel_flash_attention", "shape": name, "B": B,
               "S": S, "Hq": Hq, "Hkv": Hkv, "D": D, "causal": True,
               "window": window, "dtype": "bfloat16"}
        out = fops.flash_attention(*x, window=window)
        torch.cuda.synchronize()
        whole = S <= LM_PROMPT
        if whole:
            checks = []
            for b in range(B):
                xb = [t[b:b + 1] for t in x]
                want = fref.attention_ref(*xb, window=window)
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
        else:
            if not bool(torch.isfinite(out.float()).all()):
                raise SystemExit(f"flash_attention at S={S} gave non-finite "
                                 f"values")
            start = S - LONG_CHECK_ROWS
            want = attention_rows_plain(*x, start, window=window)
            got = out[:, start:]
            row.update(**flash_check(got, want, x[2], "bfloat16"),
                       compared=f"query rows {start}..{S - 1} of every head")
            del want, got
        worst = max(worst, row["max_abs_err"])
        del out
        flops, nbytes, bound_ms = attention_bound(B, S, Hq, Hkv, D, window)
        iters = 5 if whole else 2
        row.update(ms=cuda_ms(lambda: fops.flash_attention(
            *x, window=window), reps=3, iters=iters, warmup=2),
            flops=flops, bytes=nbytes, bound_ms=bound_ms,
            bound_by="operations")
        row["tflops"] = flops / row["ms"] / 1e9
        row.update(sdpa_ms(x, window, iters))
        if whole:
            torch.cuda.empty_cache()
            row["plain_ms"] = cuda_ms(lambda: fref.attention_ref(
                *x, window=window), reps=3, iters=1, warmup=1)
        emit(row)
        if not row["close"]:
            raise SystemExit(f"flash_attention disagrees with its plain "
                             f"version at {name}: {row}")
        timed[name] = row
        del x
        torch.cuda.empty_cache()
    return timed, worst


def sdpa_ms(x, window, iters):
    """The library call's time on the same inputs: causal
    ``F.scaled_dot_product_attention`` with ``enable_gqa`` on (B, H, S, D)
    copies; with a window, an explicit (S, S) band mask on the
    memory-efficient backend, with k and v repeated to the q-heads (that
    backend takes no GQA, and the math backend would hold the whole
    score matrix)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in x)
    if window is None:
        ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), reps=3,
            iters=iters, warmup=2)
        return {"library_ms": ms, "library_call":
                "F.scaled_dot_product_attention(is_causal=True, "
                "enable_gqa=True) on (B, H, S, D) copies"}
    S, G = qt.shape[2], qt.shape[1] // kt.shape[1]
    kt, vt = (t.repeat_interleave(G, dim=1) for t in (kt, vt))
    i = torch.arange(S, device="cuda")[:, None]
    j = torch.arange(S, device="cuda")[None, :]
    band = (j <= i) & (j > i - window)
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=band), reps=3, iters=iters, warmup=2)
    return {"library_ms": ms, "library_call":
            "F.scaled_dot_product_attention(attn_mask=band) on the "
            "memory-efficient backend, k and v repeated to the q-heads"}


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
    tree = lm_numpy_params(cfg, rng)
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
    tree = lm_numpy_params(cfg, rng)
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


def bwd_check(got, want, dtype, absp=None):
    """The row fields of one backward comparison under BWD_TOL: the worst
    and mean error of each of dq, dk, dv, the largest share of its
    element limit an error takes, the limits, and whether all hold. bf16
    needs ``absp``, the products on absolute values
    (ref.attention_bwd_abs_ref) that widen each element's limit."""
    import torch
    tol = BWD_TOL[dtype]
    atol = tol["atol_frac"] * max(float(w.float().abs().max()) for w in want)
    row = {"max_abs_err": 0.0, "mean_abs_err": {}, "mean_abs_ref": {},
           "limit_share": {}, "tol": {key: val for key, val in tol.items()
                                      if key != "atol_frac"} | {
               "atol": atol}, "close": True}
    absp = absp if dtype == "bfloat16" else (None,) * 3
    for name, g, w, a in zip(("dq", "dk", "dv"), got, want, absp):
        g, w = g.float(), w.float()
        d = (g - w).abs()
        limit = tol["rtol"] * w.abs() + atol
        if a is not None:
            limit += tol["abs_ulp"] * a
        row["max_abs_err"] = max(row["max_abs_err"], float(d.max()))
        row["mean_abs_err"][name] = float(d.mean())
        row["mean_abs_ref"][name] = float(w.abs().mean())
        row["limit_share"][name] = float((d / limit).max())
        ok = bool((d <= limit).all())
        if dtype == "bfloat16":
            ok = ok and row["mean_abs_err"][name] <= \
                FLASH_P_ULP * row["mean_abs_ref"][name] + atol
        row["close"] = row["close"] and ok
    return row


def phase_kernel_flash_bwd(fops, fref):
    """flash_attention_bwd on the card against attention_bwd_ref (BWD_TOL)
    on the same inputs and the card's forward output: fp32 and bf16,
    causal, non-causal, windows, Hkv = 1, ragged S, D in {16, 64, 80, 128,
    192, 256}; then the LM training shape (B=2, S=4,096, 32 heads of 80,
    bf16, causal), qwen3-8b's layer (B=8, S=4,096, 32/8 heads, D=128,
    bf16) and the MoE training layers at their phases' microbatches
    (granite_train: 24/8 heads of 64; mixtral_train: 48/8 heads of 128,
    window 4,096), compared one sequence at a time; one case repeated for
    equal bits. The four big shapes are timed eagerly and in a CUDA graph,
    beside the plain version and SDPA's backward (autograd of
    F.scaled_dot_product_attention on (B, H, S, D) copies, its forward
    out of the timing). Returns the timed rows and the worst error."""
    import torch
    import torch.nn.functional as F
    cases = [(B, S, Hq, Hkv, D, True, w, dt)
             for dt in ("float32", "bfloat16")
             for B, S, Hq, Hkv, D, w in (
                 (2, 128, 4, 4, 64, None), (1, 256, 8, 2, 64, None),
                 (2, 256, 4, 4, 16, 64), (1, 128, 2, 1, 128, None),
                 (2, 200, 8, 8, 80, None), (1, 300, 4, 1, 256, 77))]
    cases += [(1, 128, 2, 2, 32, False, None, "float32"),
              (2, 256, 4, 2, 64, False, 48, "float32"),
              (2, 129, 4, 1, 128, False, None, "bfloat16"),
              (1, 512, 8, 2, 128, True, 100, "bfloat16"),
              (1, 1000, 4, 1, 64, True, 256, "float32"),
              (3, 1, 4, 4, 16, True, None, "bfloat16"),
              (2, 333, 4, 2, 8, False, None, "bfloat16"),
              (1, 150, 4, 4, 192, True, None, "float32"),
              (1, 70, 2, 1, 256, False, 33, "bfloat16")]
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = 0.0

    def inputs(B, S, Hq, Hkv, D, dtype):
        return [torch.randn((B, S, h, D), device="cuda",
                            generator=gen).to(getattr(torch, dtype))
                for h in (Hq, Hkv, Hkv, Hq)]

    for B, S, Hq, Hkv, D, causal, window, dtype in cases:
        q, k, v, g = inputs(B, S, Hq, Hkv, D, dtype)
        out, lse = fops.flash_attention(q, k, v, causal=causal,
                                        window=window, return_lse=True)
        got = fops.flash_attention_bwd(q, k, v, out, g, lse, causal=causal,
                                       window=window)
        torch.cuda.synchronize()
        want = fref.attention_bwd_ref(q, k, v, out, g, causal=causal,
                                      window=window)
        absp = fref.attention_bwd_abs_ref(q, k, v, out, g, causal=causal,
                                          window=window)
        row = {"phase": "kernel_flash_bwd", "B": B, "S": S, "Hq": Hq,
               "Hkv": Hkv, "D": D, "causal": causal, "window": window,
               "dtype": dtype, **bwd_check(got, want, dtype, absp)}
        worst = max(worst, row["max_abs_err"])
        emit(row)
        if not row["close"]:
            raise SystemExit(f"flash_attention_bwd disagrees with its "
                             f"plain version: {row}")

    # the same inputs twice: no atomics, so the same bits
    q, k, v, g = inputs(2, 333, 8, 2, 80, "bfloat16")
    out, lse = fops.flash_attention(q, k, v, window=100, return_lse=True)
    first = fops.flash_attention_bwd(q, k, v, out, g, lse, window=100)
    again = fops.flash_attention_bwd(q, k, v, out, g, lse, window=100)
    equal = all(bool(torch.equal(a, b)) for a, b in zip(first, again))
    emit({"phase": "kernel_flash_bwd", "repeat": "B=2, S=333, 8/2 heads, "
          "D=80, bf16, window 100", "bit_equal": equal})
    if not equal:
        raise SystemExit("flash_attention_bwd gave other bits on a repeat")

    timed = {}
    # the LM training shape, qwen3-8b's layer, and the MoE training
    # layers at their phases' microbatches: granite's (G = 3, D = 64) and
    # mixtral's (G = 6, D = 128, its window of 4,096, which at S = 4,096
    # masks no key)
    for name, (B, Hq, Hkv, D, window) in (
            ("train", (LM_TRAIN_MB, 32, 32, 80, None)),
            ("layer", (LM_BATCH, 32, 8, 128, None)),
            ("granite_train", (MOE_TRAIN["moe_train"]["mb"], 24, 8, 64,
                               None)),
            ("mixtral_train", (MOE_TRAIN["moe_window_train"]["mb"], 48, 8,
                               128, 4096))):
        S = LM_TRAIN_SEQ
        torch.cuda.empty_cache()
        q, k, v, g = inputs(B, S, Hq, Hkv, D, "bfloat16")
        out, lse = fops.flash_attention(q, k, v, window=window,
                                        return_lse=True)
        got = fops.flash_attention_bwd(q, k, v, out, g, lse, window=window)
        torch.cuda.synchronize()
        row = {"phase": "kernel_flash_bwd", "shape": name, "B": B, "S": S,
               "Hq": Hq, "Hkv": Hkv, "D": D, "causal": True,
               "window": window, "dtype": "bfloat16"}
        checks = []
        for b in range(B):
            sl = [t[b:b + 1] for t in (q, k, v, out, g)]
            want = fref.attention_bwd_ref(*sl, window=window)
            absp = fref.attention_bwd_abs_ref(*sl, window=window)
            checks.append(bwd_check([t[b:b + 1] for t in got], want,
                                    "bfloat16", absp))
            del want, absp
        del got
        row.update(max_abs_err=max(c["max_abs_err"] for c in checks),
                   limit_share={n: max(c["limit_share"][n] for c in checks)
                                for n in ("dq", "dk", "dv")},
                   tol=[c["tol"] for c in checks],
                   close=all(c["close"] for c in checks),
                   mean_abs_err=checks[0]["mean_abs_err"],
                   mean_abs_ref=checks[0]["mean_abs_ref"],
                   compared="one sequence at a time")
        worst = max(worst, row["max_abs_err"])
        flops, _, fwd_bound = attention_bound(B, S, Hq, Hkv, D, window)
        call = lambda: fops.flash_attention_bwd(  # noqa: E731
            q, k, v, out, g, lse, window=window)
        row.update(ms=cuda_ms(call, reps=3, iters=2, warmup=1),
                   graph_ms=graph_ms(call, iters=1),
                   flops=BWD_CYCLES * flops,
                   bound_ms=BWD_CYCLES * fwd_bound, bound_by="operations")
        row["tflops"] = row["flops"] / row["ms"] / 1e9
        if window is not None and window < S:
            raise SystemExit("a window that masks keys needs SDPA's mask")
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, k, v))
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                            enable_gqa=True)
        gt = g.transpose(1, 2).contiguous()
        row.update(library_ms=cuda_ms(
            lambda: torch.autograd.grad(ot, (qt, kt, vt), gt,
                                        retain_graph=True),
            reps=3, iters=2, warmup=1),
            library_call="the backward of F.scaled_dot_product_attention("
                         "is_causal=True, enable_gqa=True) on (B, H, S, D) "
                         "copies (torch.autograd.grad, forward not timed)"
                         + ("; the window masks no key at this S"
                            if window else ""))
        del qt, kt, vt, ot, gt
        torch.cuda.empty_cache()
        if name == "train":
            row["plain_ms"] = cuda_ms(lambda: fref.attention_bwd_ref(
                q, k, v, out, g), reps=2, iters=1, warmup=1)
        else:
            # the whole batch at once would materialise 8.6 GB of float32
            # scores per copy: one call walks the B sequences in turn
            row["plain_ms"] = cuda_ms(lambda: [fref.attention_bwd_ref(
                *[t[b:b + 1] for t in (q, k, v, out, g)], window=window)
                for b in range(B)], reps=2, iters=1, warmup=1)
            row["plain_call"] = "attention_bwd_ref on each sequence in turn"
        emit(row)
        if not row["close"]:
            raise SystemExit(f"flash_attention_bwd disagrees with its "
                             f"plain version at full width: {row}")
        timed[name] = row
        del q, k, v, g, out, lse
        torch.cuda.empty_cache()
    return timed, worst


def phase_lm_train(tf, launches):
    """stablelm-3b at its published width on the card (bf16, params drawn
    there), remat on, the launcher's AdamW: LM_TRAIN_STEPS steps of
    LM_TRAIN_ACCUM microbatches of LM_TRAIN_MB x LM_TRAIN_SEQ tokens. Each
    step must launch the forward kernel twice a layer and microbatch (the
    forward and the recompute) and the backward once; every loss finite;
    after the first step every leaf's first moment, (1 - b1) times its
    clipped gradient, nonzero (a gradient zeroed by a missing backward
    would leave it 0). Then one more step under the profiler."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch.cells import opt_config
    from repro_torch.train.optimizer import init_adamw
    from repro_torch.train.train_loop import (make_train_step,
                                              split_microbatches)
    from repro_torch.train.tree import tree_flatten

    cfg = get_arch(LM_TRAIN_ARCH).build_cfg()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    emit({"phase": "lm_train_memory", "allocated_gb":
          torch.cuda.memory_allocated() / 1e9,
          "free_gb": torch.cuda.mem_get_info()[0] / 1e9})
    t0 = time.perf_counter()
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(0),
                            cfg, "cuda")
    opt_cfg = opt_config(LM_TRAIN_ARCH)
    opt = init_adamw(params, opt_cfg)
    torch.cuda.synchronize()
    # (counts only: a list of the leaves would keep the first params alive
    # beside every later step's)
    leaves = tree_flatten(params)
    n_leaves, n_params = len(leaves), sum(t.numel() for t in leaves)
    param_gb = sum(t.nbytes for t in leaves) / 1e9
    del leaves
    emit({"phase": "lm_train_setup", "config": LM_TRAIN_ARCH,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
          "d_head": cfg.d_head, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
          "dtype": str(cfg.dtype).removeprefix("torch."),
          "remat": cfg.remat, "params": n_params,
          "params_dense": cfg.params_dense,
          "param_gb": param_gb,
          "moment_gb": sum(t.nbytes for t in tree_flatten(opt.m))
          * 2 / 1e9, "opt": dataclasses.asdict(opt_cfg) | {
              "moment_dtype": str(opt_cfg.moment_dtype)},
          "seq": LM_TRAIN_SEQ, "accum_steps": LM_TRAIN_ACCUM,
          "micro_batch": LM_TRAIN_MB,
          "cut": "train_4k's microbatch of 128 sequences cut to 2, 3 steps",
          "init_s": time.perf_counter() - t0})
    if n_params != cfg.params_dense:
        raise SystemExit(f"{LM_TRAIN_ARCH} has {n_params} params, not "
                         f"params_dense {cfg.params_dense}")
    stream = TokenStream(cfg.vocab, LM_TRAIN_ACCUM * LM_TRAIN_MB,
                         LM_TRAIN_SEQ, seed=0)
    step_fn = make_train_step(lambda p, b: tf.lm_loss(p, b, cfg), opt_cfg,
                              accum_steps=LM_TRAIN_ACCUM)
    need = {"flash_attention": 2 * cfg.n_layers * LM_TRAIN_ACCUM,
            "flash_attention_bwd": cfg.n_layers * LM_TRAIN_ACCUM}
    losses, walls = [], []
    for step in range(LM_TRAIN_STEPS):
        batch = split_microbatches({k: torch.from_numpy(v).cuda() for k, v
                                    in stream.batch_at(step).items()},
                                   LM_TRAIN_ACCUM)

        def run():
            out = step_fn(params, opt, batch)
            torch.cuda.synchronize()
            return out

        (params, opt, metrics), wall, counts = launches.drive(run)
        loss = float(metrics["loss"])
        losses.append(loss)
        walls.append(wall)
        tokens = LM_TRAIN_ACCUM * LM_TRAIN_MB * LM_TRAIN_SEQ
        row = {"phase": "lm_train", "step": step, "loss": loss,
               "grad_norm": float(metrics["grad_norm"]), "wall_s": wall,
               "tokens": tokens, "tokens_per_s": tokens / wall,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches": counts, "expected_launches": need}
        if step == 0:
            firsts = named_leaves(opt.m)
            row["leaves"] = len(firsts)
            row["zero_grad_leaves"] = [n for n, m in firsts.items()
                                       if float(m.abs().max()) == 0.0]
            del firsts
        emit(row)
        if {k: v for k, v in counts.items() if v} != need:
            raise SystemExit(f"lm_train step {step} launched {counts}, not "
                             f"{need}")
        if not math.isfinite(loss):
            raise SystemExit(f"lm_train step {step} gave loss {loss}")
        if step == 0 and (row["zero_grad_leaves"]
                          or row["leaves"] != n_leaves):
            raise SystemExit(f"lm_train: leaves with a zero gradient on the "
                             f"first step: {row['zero_grad_leaves']}")
    # one more step under the profiler (its params are dropped, its
    # moments move in place and nothing reads them after it): the
    # card's busy share and the kernels that lead a step
    phase_profile("lm_train_step", lambda: step_fn(params, opt, batch),
                  watch=("flash_tc_kernel", "attn_bwd_delta_kernel",
                         "attn_bwd_dkdv_tc_kernel", "attn_bwd_dq_tc_kernel"))
    emit({"phase": "lm_train_done", "losses": losses, "step_wall_s": walls,
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
          "card_gb": torch.cuda.get_device_properties(0).total_memory
          / 1e9})
    del params, opt, batch
    torch.cuda.empty_cache()


def phase_lm_train_parity(tf, convert, launches):
    """The reduced stablelm-3b on the card in float32 (TF32 off) and
    bf16: params from lm_numpy_params, batches from lm_parity_batches,
    LM_TRAIN_PARITY_STEPS steps of accum 2,
    held to the JAX package's pinned losses (LM_TRAIN_PARITY_TOL); each
    microbatch launches the forward and the backward kernel once a
    layer."""
    import dataclasses as dc

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.train.optimizer import AdamWConfig, init_adamw
    from repro_torch.train.train_loop import make_train_step
    base = get_arch(LM_TRAIN_ARCH).build_cfg(reduced=True)
    for dtype in ("float32", "bfloat16"):
        cfg = dc.replace(base, dtype=getattr(torch, dtype))
        params = convert.transformer_params_from_numpy(
            lm_numpy_params(cfg), cfg, "cuda")
        opt_cfg = AdamWConfig(**LM_TRAIN_PARITY_OPT)
        opt = init_adamw(params, opt_cfg)
        step_fn = make_train_step(lambda p, b: tf.lm_loss(p, b, cfg),
                                  opt_cfg, accum_steps=2)
        batches = [{k: torch.from_numpy(v).cuda() for k, v in b.items()}
                   for b in lm_parity_batches(cfg.vocab)]

        def run():
            nonlocal params, opt
            out = []
            for b in batches:
                params, opt, m = step_fn(params, opt, b)
                out.append(float(m["loss"]))
            return out

        losses, wall, counts = launches.drive(run)
        n = 2 * cfg.n_layers * LM_TRAIN_PARITY_STEPS
        need = {"flash_attention": n, "flash_attention_bwd": n}
        pinned = LM_TRAIN_JAX_LOSSES[dtype]
        close = [bool(math.isclose(a, b, rel_tol=t["rtol"],
                                   abs_tol=t["atol"]))
                 for a, b, t in zip(losses, pinned,
                                    LM_TRAIN_PARITY_TOL[dtype])]
        row = {"phase": "lm_train_parity", "config":
               f"{LM_TRAIN_ARCH} reduced, {dtype}", "seq":
               LM_TRAIN_PARITY_SEQ, "accum_steps": 2, "micro_batch": 2,
               "opt": LM_TRAIN_PARITY_OPT,
               "tf32": torch.backends.cuda.matmul.allow_tf32,
               "losses": losses, "jax_losses": pinned,
               "max_abs_diff": max(abs(a - b)
                                   for a, b in zip(losses, pinned)),
               "tol": LM_TRAIN_PARITY_TOL[dtype], "close": close,
               "wall_s": wall, "launches": counts,
               "expected_launches": need}
        emit(row)
        if {k: v for k, v in counts.items() if v} != need:
            raise SystemExit(f"lm_train_parity launched {counts}")
        if len(losses) != len(pinned) or not all(close):
            raise SystemExit(f"lm_train_parity differs from JAX's losses: "
                             f"{row}")


def phase_lm_launcher(launches):
    """``python -m repro_torch.launch.train --arch stablelm-3b --reduced
    --steps 4`` on the card, in a fresh checkpoint directory: 4 steps, no
    failure, finite losses, and the kernels launched once a layer and
    microbatch (the reduced config's remat is off)."""
    import tempfile

    from repro_torch.configs import get_arch
    from repro_torch.launch import train as launch_train
    argv = ["--arch", LM_TRAIN_ARCH, "--reduced", "--steps",
            str(LM_LAUNCHER_STEPS)]
    with tempfile.TemporaryDirectory() as d:
        res, wall, counts = launches.drive(lambda: launch_train.main(
            argv + ["--ckpt_dir", d]))
    arch = get_arch(LM_TRAIN_ARCH)
    (accum, _, _), _ = arch.input_specs("train_4k", reduced=True)["tokens"]
    n = arch.build_cfg(reduced=True).n_layers * accum * LM_LAUNCHER_STEPS
    need = {"flash_attention": n, "flash_attention_bwd": n}
    losses = [m["loss"] for m in res.metrics_history]
    row = {"phase": "lm_launcher", "argv": argv, "wall_s": wall,
           "steps": res.steps_done,
           "failures_recovered": res.failures_recovered, "losses": losses,
           "launches": counts, "expected_launches": need}
    emit(row)
    if (res.steps_done != LM_LAUNCHER_STEPS or res.failures_recovered
            or len(losses) != LM_LAUNCHER_STEPS
            or not all(math.isfinite(x) for x in losses)):
        raise SystemExit(f"the LM train launcher failed: {row}")
    if {k: v for k, v in counts.items() if v} != need:
        raise SystemExit(f"the LM train launcher launched {counts}")


def lm_numpy_params(cfg, seed=0) -> dict:
    """An LM's params as numpy float32, in the JAX package's layout (a
    leading n_layers axis on every layer leaf, the leaves of the port's
    ``layer_shapes``): embed ``normal * 0.02``, lm_head and every layer
    weight ``normal / sqrt(fan_in)`` (an MoE expert stack's fan-in is its
    second last axis), ln_f and the norms ``1 + 0.1 normal``, drawn in
    this order from ``np.random.default_rng(seed)``
    (a Generator given as ``seed`` is drawn from and advanced). ``cfg``
    is either package's TransformerConfig."""
    import numpy as np
    from repro_torch.models.transformer import layer_shapes
    d, L = cfg.d_model, cfg.n_layers
    shapes = layer_shapes(cfg)
    rng = np.random.default_rng(seed)
    V = cfg.vocab_padded
    tree = {"embed": rng.normal(size=(V, d)) * 0.02,
            "lm_head": rng.normal(size=(d, V)) / np.sqrt(d),
            "ln_f": 1 + 0.1 * rng.normal(size=d),
            "layers": {name: (1 + 0.1 * rng.normal(size=(L,) + shape))
                       if len(shape) == 1 else
                       rng.normal(size=(L,) + shape) / np.sqrt(shape[-2])
                       for name, shape in shapes.items()}}

    def f32(node):
        if isinstance(node, dict):
            return {k: f32(v) for k, v in node.items()}
        return node.astype(np.float32)

    return f32(tree)


def lm_parity_batches(vocab: int) -> list:
    """The lm_train_parity phase's batches as numpy int32, (2, 2, seq)
    each: TokenStream's recipe (labels are the tokens shifted by one;
    half the tokens follow the bigram ``(prev * 31 + 7) % vocab``) with
    uniform unigrams from ``rng.integers`` in place of its Zipf draw,
    from ``default_rng([7, step])``. TokenStream's ``Generator.zipf``
    gives other numbers under other numpy versions (2.0.2 and 2.3.5 make
    other batches from the same seed), so a loss pinned under one would
    not hold under another; the ``integers`` and ``random`` streams
    do."""
    import numpy as np
    seq = LM_TRAIN_PARITY_SEQ
    out = []
    for step in range(LM_TRAIN_PARITY_STEPS):
        rng = np.random.default_rng([7, step])
        toks = rng.integers(0, vocab, size=(4, seq + 1))
        mask = rng.random((4, seq)) < 0.5
        toks[:, 1:] = np.where(mask, (toks[:, :-1] * 31 + 7) % vocab,
                               toks[:, 1:])
        out.append({"tokens": toks[:, :-1].astype(np.int32).reshape(
                        2, 2, seq),
                    "labels": toks[:, 1:].astype(np.int32).reshape(
                        2, 2, seq)})
    return out


def run_lm(launches, fops, fref):
    """The LM slices: the flash-attention kernel phase, qwen3-8b at full
    width through prefill and decode, the serve launcher with its
    defaults, and the reduced config card against CPU; then the backward
    kernel phase, stablelm-3b training at full width, the reduced config's
    training against JAX's losses and the train launcher. Returns the
    forward's and the backward's timed rows and worst errors."""
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
    t0 = time.perf_counter()
    bwd_timed, bwd_worst = phase_kernel_flash_bwd(fops, fref)
    phase_lm_train(tf, launches)
    phase_lm_train_parity(tf, convert, launches)
    phase_lm_launcher(launches)
    emit({"phase": "lm_train_phases_done",
          "wall_s": time.perf_counter() - t0})
    return timed, worst, bwd_timed, bwd_worst

# ------------------------------------------------------------------- MoE

class RouteLog:
    """For the length of a ``with``, a spy on ``models.moe.top_experts``
    (the experts each token takes): it keeps every call's indices in
    call order (with ``keep``) and counts the slots that each expert's
    capacity drops (``moe.capacity(cfg, S)`` a row), call by call. Given
    ``pinned``, a digit string (one digit an expert, in call order) or a
    list of index tensors (one a call), each call takes the next pinned
    experts in place of its own, so the rest of moe_ffn runs on them;
    ``own`` keeps its own choices, ``used`` the pinned ones."""

    def __init__(self, moe_mod, cfg, pinned=None, keep=True):
        self.mod, self.cfg, self.pinned, self.keep = moe_mod, cfg, pinned, keep
        self.own, self.used, self.slots, self.drops = [], [], [], []

    def __enter__(self):
        import torch
        orig = self.orig = self.mod.top_experts
        at = 0

        def spy(probs, K):
            nonlocal at
            idx = orig(probs, K)
            if self.keep:
                self.own.append(idx)
            if isinstance(self.pinned, str):
                digits = self.pinned[at:at + idx.numel()]
                if len(digits) != idx.numel():
                    raise SystemExit("the pinned routes ran out")
                at += idx.numel()
                idx = torch.tensor([int(c) for c in digits],
                                   dtype=idx.dtype).to(idx.device).view(
                                       idx.shape)
                self.used.append(idx)
            elif self.pinned is not None:
                idx = self.pinned[len(self.used)].view(idx.shape)
                self.used.append(idx)
            B, S, _ = idx.shape
            per = torch.zeros((B, probs.shape[-1]), dtype=torch.int64,
                              device=idx.device).scatter_add_(
                1, idx.reshape(B, -1), torch.ones_like(idx.reshape(B, -1)))
            C = self.mod.capacity(self.cfg, S)
            self.drops.append(torch.clamp_min(per - C, 0).sum())
            self.slots.append(idx.numel())
            return idx

        self.mod.top_experts = spy
        return self

    def __exit__(self, *exc):
        self.mod.top_experts = self.orig

    def drop_share(self) -> float:
        return sum(int(d) for d in self.drops) / max(sum(self.slots), 1)

    def drop_shares(self) -> list:
        """Each call's share of dropped slots."""
        return [int(d) / n for d, n in zip(self.drops, self.slots)]

    def digits(self) -> str:
        return "".join(str(int(i)) for r in self.own
                       for i in r.reshape(-1).tolist())

    def differing(self) -> int:
        """The (token, call) pairs whose own set of experts is not the
        pinned one."""
        return sum(int((a.sort(-1)[0] != b.sort(-1)[0]).any(-1).sum())
                   for a, b in zip(self.own, self.used))


class TrainRouteLog(RouteLog):
    """RouteLog (its own experts kept, none pinned) through remat training
    steps, with a spy on ``transformer.moe_ffn`` too: each call that
    returns keeps its aux loss under the index of its own routing. Under
    remat a microbatch routes 2 L times: the forward's layers 0 to L - 1,
    then the backward's recomputes, layer L - 1 first. A recompute may
    stop after the layer's last saved tensor, before moe_ffn returns, so
    the forward's aux losses are picked by index."""

    def __init__(self, moe_mod, tf, cfg):
        super().__init__(moe_mod, cfg)
        self.tf, self.aux = tf, {}

    def __enter__(self):
        super().__enter__()
        orig = self.orig_ffn = self.tf.moe_ffn

        def spy(cfg, lp, x):
            at = len(self.own)
            out, aux = orig(cfg, lp, x)
            self.aux[at] = aux.detach()
            return out, aux

        self.tf.moe_ffn = spy
        return self

    def __exit__(self, *exc):
        self.tf.moe_ffn = self.orig_ffn
        super().__exit__(*exc)

    def summary(self, n_layers: int, accum: int) -> dict:
        """Of a step of ``accum`` microbatches: the routings counted, each
        layer's forward and recompute experts bit-equal (over the
        microbatches), each layer's dropped share of the forward's slots,
        and the aux loss as lm_loss adds it (summed over the layers,
        averaged over the microbatches)."""
        import torch
        L = n_layers
        fwd = [[a * 2 * L + i for a in range(accum)] for i in range(L)]
        rec = [[a * 2 * L + 2 * L - 1 - i for a in range(accum)]
               for i in range(L)]
        out = {"routings": len(self.own), "expected_routings": 2 * L * accum}
        if out["routings"] != out["expected_routings"]:
            return out
        out["remat_experts_equal"] = [
            all(bool(torch.equal(self.own[f], self.own[r]))
                for f, r in zip(fs, rs)) for fs, rs in zip(fwd, rec)]
        out["dropped_share_by_layer"] = [
            round(sum(int(self.drops[c]) for c in fs)
                  / sum(self.slots[c] for c in fs), 4) for fs in fwd]
        out["dropped_share"] = sum(
            int(self.drops[c]) for fs in fwd for c in fs) / sum(
            self.slots[c] for fs in fwd for c in fs)
        aux = [sum(float(self.aux[c]) for c in fs) / accum for fs in fwd]
        out["aux"] = sum(aux)
        out["aux_by_layer"] = [round(a, 4) for a in aux]
        return out


def moe_train_flops(cfg, S: int) -> dict:
    """GFLOP a token of one remat training step of an MoE LM at sequence
    S, by part (two per multiply-add). ``forward``: one forward with the
    top-K experts a token takes; ``model``: the step as the model needs
    it (each layer's forward, its recompute and a backward of twice the
    forward; the head's forward and backward); ``executed``: what the
    port's code runs, the experts' products over the whole (E, B, C, d)
    capacity buffer (E C / S slots a token, the empty ones included) and
    the attention backward's five products to the forward's two (row
    6b). Scores count the keys each query sees (causal, within the
    window)."""
    from repro_torch.models import moe as moe_mod
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    w = cfg.window or S
    keys = sum(min(i + 1, w) for i in range(S)) / S
    slot = 6 * d * cfg.d_ff            # gate, up and down of one slot
    fwd = {"experts": L * K * slot,
           "attention_projections": L * 2 * d * (2 * Hq + 2 * Hkv) * D,
           "scores": L * 4 * keys * Hq * D, "router": L * 2 * d * E,
           "head": 2 * d * V}
    model = {k: (3 if k == "head" else 4) * v for k, v in fwd.items()}
    executed = dict(model, experts=4 * L * E * moe_mod.capacity(cfg, S)
                    / S * slot, scores=4.5 * fwd["scores"])
    g = 1e-9
    return {"forward": {k: v * g for k, v in fwd.items()},
            "forward_total": sum(fwd.values()) * g,
            "model_total": sum(model.values()) * g,
            "executed_total": sum(executed.values()) * g,
            "capacity": moe_mod.capacity(cfg, S),
            "mean_keys": keys}


def named_leaves(tree) -> dict:
    """An LM param tree's (or its moments') leaves by name: the top-level
    ones, then ``layers.<name>``."""
    out = {n: t for n, t in tree.items() if n != "layers"}
    out.update((f"layers.{n}", t) for n, t in tree["layers"].items())
    return out


def phase_moe_train(tf, moe_mod, launches, phase, probe=False):
    """An MoE LM trained at its published width on the card (MOE_TRAIN
    gives the arch, the depth cut, the microbatch and the steps; bf16,
    remat on, params drawn there, the launcher's AdamW). First microbatch
    0 through value_and_grad twice, before the moments exist: the loss
    and every gradient leaf bit-equal. Then each step, under
    TrainRouteLog: twice a layer and microbatch the attention forward
    (the forward and remat's recompute) and once its backward; a finite
    loss, printed as the cross-entropy and 0.01 aux apart; each layer's
    forward and recompute experts bit-equal; each layer's dropped share;
    after step 0, no leaf with a zero first moment. The peak, the wall,
    tokens/s and the FLOP count. Then one more step with no spy, whose
    wall and tokens/s are the phase's (the spied steps' walls carry the
    spy's launches), and one under the profiler. ``probe``
    (kernel_ab.py --moe-train) runs one step, with no repeat, no
    unspied step and no profile, to size the microbatch."""
    import dataclasses as dc

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch.cells import opt_config
    from repro_torch.train.optimizer import init_adamw
    from repro_torch.train.train_loop import (make_train_step,
                                              split_microbatches,
                                              value_and_grad)
    from repro_torch.train.tree import tree_flatten, tree_map

    spec = MOE_TRAIN[phase]
    arch, mb, accum, S = spec["arch"], spec["mb"], MOE_TRAIN_ACCUM, \
        MOE_TRAIN_SEQ
    steps = 1 if probe else spec["steps"]
    cfg = get_arch(arch).build_cfg()
    published = cfg.n_layers
    if spec["layers"] is not None:
        cfg = dc.replace(cfg, n_layers=spec["layers"])
    L = cfg.n_layers
    if torch.backends.cuda.matmul.allow_tf32 or not cfg.remat:
        raise SystemExit(f"{phase} needs TF32 off (the router is float32) "
                         f"and remat on")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    emit({"phase": f"{phase}_memory", "allocated_gb":
          torch.cuda.memory_allocated() / 1e9,
          "free_gb": torch.cuda.mem_get_info()[0] / 1e9, "card_gb": card_gb})
    t0 = time.perf_counter()
    params = tf.init_params(torch.Generator(device="cuda").manual_seed(0),
                            cfg, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # (counts only: a list of the leaves would keep the first params alive
    # beside every later step's, 2 bytes a param)
    n_params = sum(t.numel() for t in tree_flatten(params))
    param_gb = sum(t.nbytes for t in tree_flatten(params)) / 1e9
    if n_params != cfg.params_dense:
        raise SystemExit(f"{arch} has {n_params} params, not params_dense "
                         f"{cfg.params_dense}")
    stream = TokenStream(cfg.vocab, accum * mb, S, seed=0)

    def batch_at(step):
        return split_microbatches({k: torch.from_numpy(v).cuda() for k, v
                                   in stream.batch_at(step).items()}, accum)

    def loss_fn(p, b):
        return tf.lm_loss(p, b, cfg)

    names = list(named_leaves(params))
    repeat = {}
    if not probe:
        # step 0's first microbatch twice, before the moments exist, so
        # two bf16 gradient trees fit
        first = tree_map(lambda x: x[0], batch_at(0))
        (l0, g0), wall0, counts0 = launches.drive(
            lambda: value_and_grad(loss_fn, params, first))
        l1, g1 = value_and_grad(loss_fn, params, first)
        differ = [n for n, a, b in zip(names, tree_flatten(g0),
                                       tree_flatten(g1))
                  if not torch.equal(a, b)]
        repeat = {"loss_bit_equal": bool(torch.equal(l0, l1)),
                  "leaves_differ": differ, "leaves": len(names),
                  "wall_s": wall0, "launches": counts0}
        del g0, g1, first
        torch.cuda.empty_cache()
        emit({"phase": phase, "part": "step0_repeat", "micro_batch": mb,
              "loss": float(l0), **repeat})
        if differ or not repeat["loss_bit_equal"]:
            raise SystemExit(f"{phase}: microbatch 0's loss or gradients "
                             f"changed their bits on a repeat: {repeat}")
    opt_cfg = opt_config(arch)
    t0 = time.perf_counter()
    opt = init_adamw(params, opt_cfg)
    torch.cuda.synchronize()
    flops = moe_train_flops(cfg, S)
    emit({"phase": f"{phase}_setup", "config": arch, "n_layers": L,
          "published_layers": published, "d_model": cfg.d_model,
          "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
          "d_head": cfg.d_head, "d_ff": cfg.d_ff,
          "n_experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k,
          "capacity_factor": cfg.moe.capacity_factor,
          "capacity": moe_mod.capacity(cfg, S), "vocab": cfg.vocab,
          "window": cfg.window, "dtype": str(cfg.dtype).removeprefix(
              "torch."), "remat": cfg.remat, "params": n_params,
          "params_dense": cfg.params_dense,
          "param_gb": param_gb,
          "moment_gb": sum(t.nbytes for t in tree_flatten((opt.m, opt.v)))
          / 1e9, "opt": dataclasses.asdict(opt_cfg) | {
              "moment_dtype": str(opt_cfg.moment_dtype)},
          "seq": S, "accum_steps": accum, "micro_batch": mb,
          "cut": (f"train_4k's microbatch of 128 sequences cut to {mb}"
                  + (f", {published} layers to {L}" if L != published
                     else "") + f", {steps} steps"),
          "probe": probe, "init_s": init_s,
          "init_adamw_s": time.perf_counter() - t0,
          "gflop_per_token": flops})
    step_fn = make_train_step(loss_fn, opt_cfg, accum_steps=accum)
    need = {"flash_attention": 2 * L * accum,
            "flash_attention_bwd": L * accum}
    tokens = accum * mb * S
    losses, walls = [], []

    def run():
        out = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        return out

    for step in range(steps):
        batch = batch_at(step)
        torch.cuda.reset_peak_memory_stats()
        with TrainRouteLog(moe_mod, tf, cfg) as log:
            (params, opt, metrics), wall, counts = launches.drive(run)
        routes = log.summary(L, accum)
        del log
        loss = float(metrics["loss"])
        losses.append(loss)
        walls.append(wall)
        peak = torch.cuda.max_memory_allocated() / 1e9
        reserved = torch.cuda.max_memory_reserved() / 1e9
        row = {"phase": phase, "step": step, "loss": loss,
               "cross_entropy": loss - 0.01 * routes.get("aux", math.nan),
               "aux_x_0.01": 0.01 * routes.get("aux", math.nan),
               "grad_norm": float(metrics["grad_norm"]), "wall_s": wall,
               "tokens": tokens, "tokens_per_s": tokens / wall,
               "model_tflops_per_s": flops["model_total"] * tokens / wall
               / 1e3, "peak_gb": peak, "peak_reserved_gb": reserved,
               "spare_gb": card_gb - reserved,
               "launches": counts, "expected_launches": need, **routes}
        if step == 0:
            row["zero_moment_leaves"] = [
                n for n, m in named_leaves(opt.m).items()
                if float(m.abs().max()) == 0.0]
        emit(row)
        if {k: v for k, v in counts.items() if v} != need:
            raise SystemExit(f"{phase} step {step} launched {counts}, not "
                             f"{need}")
        if not math.isfinite(loss):
            raise SystemExit(f"{phase} step {step} gave loss {loss}")
        if routes["routings"] != routes["expected_routings"] or not all(
                routes["remat_experts_equal"]):
            raise SystemExit(f"{phase} step {step}: the recompute routed "
                             f"other than the forward: {routes}")
        if step == 0 and row["zero_moment_leaves"]:
            raise SystemExit(f"{phase}: leaves with a zero first moment "
                             f"after step 0: {row['zero_moment_leaves']}")
        if reserved >= card_gb:
            raise SystemExit(f"{phase}: the peak passed the card's memory")
    clean = {}
    if not probe:
        # one step with no spy, for the wall (it and the profiled step
        # move the params and moments on; nothing reads them after)
        batch = batch_at(steps)
        (params, opt, metrics), wall, counts = launches.drive(run)
        clean = {"step": steps, "loss": float(metrics["loss"]),
                 "wall_s": wall, "tokens_per_s": tokens / wall,
                 "model_tflops_per_s": flops["model_total"] * tokens / wall
                 / 1e3, "spied_wall_s": walls, "launches": counts}
        emit({"phase": phase, "part": "no_spy", **clean})
        if {k: v for k, v in counts.items() if v} != need or \
                not math.isfinite(clean["loss"]):
            raise SystemExit(f"{phase}'s unspied step: {clean}")
        # one more step under the profiler
        phase_profile(f"{phase}_step", lambda: step_fn(params, opt, batch),
                      watch=("flash_tc_kernel", "attn_bwd_delta_kernel",
                             "attn_bwd_dkdv_tc_kernel",
                             "attn_bwd_dq_tc_kernel"),
                      ops=MOE_PROFILE_OPS)
    emit({"phase": f"{phase}_done", "losses": losses, "step_wall_s": walls,
          "micro_batch": mb, "repeat": repeat, "no_spy": clean,
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
          "card_gb": card_gb})
    del params, opt, batch
    torch.cuda.empty_cache()


def moe_parity_prompts(vocab: int):
    """moe_parity's prompts: (MOE_PARITY_BATCH, MOE_PARITY_PROMPT) int32
    from ``default_rng(8)``."""
    import numpy as np
    return np.random.default_rng(8).integers(
        0, vocab, (MOE_PARITY_BATCH, MOE_PARITY_PROMPT)).astype(np.int32)


def moe_parity_serve(tf, cfg, params, prompts, tokens):
    """moe_parity's serving recipe through the port on ``params``'
    device: prefill of ``prompts``, the cache padded to MOE_PARITY_SLOTS;
    serve_step fed each of ``tokens`` ((B,) int32 each) in turn; then
    serve_step_paged from the same padded prefill fed the same tokens,
    each step's K/V appended at slot pos % MOE_PARITY_SLOTS. Returns the
    1 + 2 len(tokens) logits and a dict of the prefill's cache ``k`` and
    ``v`` and the first paged step's ``k_new`` and ``v_new``, each float32
    on the CPU."""
    import torch
    import torch.nn.functional as F
    dev = params["embed"].device
    with torch.inference_mode():
        cache, logits = tf.prefill(params, torch.as_tensor(prompts).to(dev),
                                   cfg)
        extra = {key: cache[key].float().cpu() for key in ("k", "v")}
        pad = MOE_PARITY_SLOTS - cache["k"].shape[2]
        for key in ("k", "v"):
            cache[key] = F.pad(cache[key], (0, 0, 0, 0, 0, pad))
        paged = {"k": cache["k"].clone(), "v": cache["v"].clone(),
                 "pos": cache["pos"]}
        out = [logits]
        for t in tokens:
            logits, cache = tf.serve_step(
                params, cache, torch.as_tensor(t)[:, None].to(dev), cfg)
            out.append(logits)
        for t in tokens:
            logits, k_new, v_new, pos = tf.serve_step_paged(
                params, paged, torch.as_tensor(t)[:, None].to(dev), cfg)
            slot = paged["pos"] % MOE_PARITY_SLOTS
            paged["k"][:, :, slot] = k_new[:, :, 0]
            paged["v"][:, :, slot] = v_new[:, :, 0]
            paged["pos"] = pos
            if "k_new" not in extra:
                extra.update(k_new=k_new.float().cpu(),
                             v_new=v_new.float().cpu())
            out.append(logits)
    return [o.float().cpu() for o in out], extra


def moe_train_losses(tf, convert, cfg, device, launches=None):
    """moe_parity's training recipe through the port: params from
    lm_numpy_params, make_train_step(lm_loss) with
    AdamWConfig(**LM_TRAIN_PARITY_OPT) and accum_steps 2 on
    lm_parity_batches; the losses (and, with ``launches``, the counts of
    the run)."""
    import torch
    from repro_torch.train.optimizer import AdamWConfig, init_adamw
    from repro_torch.train.train_loop import make_train_step
    params = convert.transformer_params_from_numpy(lm_numpy_params(cfg),
                                                   cfg, device)
    opt_cfg = AdamWConfig(**LM_TRAIN_PARITY_OPT)
    opt = init_adamw(params, opt_cfg)
    step_fn = make_train_step(lambda p, b: tf.lm_loss(p, b, cfg), opt_cfg,
                              accum_steps=2)
    batches = [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
               for b in lm_parity_batches(cfg.vocab)]

    def run():
        nonlocal params, opt
        out = []
        for b in batches:
            params, opt, m = step_fn(params, opt, b)
            out.append(float(m["loss"]))
        return out

    if launches is None:
        return run(), None
    losses, _, counts = launches.drive(run)
    return losses, counts


def moe_parity_check(logs, pins, dtype) -> dict:
    """The row fields of one serving comparison with the pinned JAX
    logits (their first MOE_PARITY_COLS columns) under MOE_PARITY_TOL."""
    import numpy as np
    got = np.stack([lg[:, :MOE_PARITY_COLS].numpy() for lg in logs])
    want = np.asarray(pins["logits"], np.float32)
    tol = MOE_PARITY_TOL[dtype]
    return {"max_abs_diff": float(np.abs(got - want).max()),
            "logit_scale": float(np.abs(want).max()), "tol": tol,
            "close": bool(got.shape == want.shape
                          and np.allclose(got, want, **tol))}


def phase_moe_parity(tf, convert, moe_mod, launches):
    """The reduced MoE configs on the card against the JAX package's
    pinned values (MOE_JAX_VALUES; the recipe beside MOE_PARITY_ARCHS):
    prefill, serve_step and serve_step_paged logits on JAX's experts,
    the port's own experts counted where they differ (none in float32),
    then the 4 training steps' losses. The prefill launches the
    attention kernel once a layer; each training microbatch the forward
    and the backward once a layer."""
    import dataclasses as dc

    import torch
    from repro_torch.configs import get_arch
    for arch in MOE_PARITY_ARCHS:
        for dtype in ("float32", "bfloat16"):
            cfg = dc.replace(get_arch(arch).build_cfg(reduced=True),
                             dtype=getattr(torch, dtype))
            pins = MOE_JAX_VALUES[arch][dtype]
            params = convert.transformer_params_from_numpy(
                lm_numpy_params(cfg), cfg, "cuda")
            with RouteLog(moe_mod, cfg, pinned="".join(pins["routes"])) as log:
                (logs, _), wall, counts = launches.drive(
                    lambda: moe_parity_serve(
                        tf, cfg, params, moe_parity_prompts(cfg.vocab),
                        pins["tokens"]))
            need = {"flash_attention": cfg.n_layers}
            row = {"phase": "moe_parity", "config": f"{arch} reduced, "
                   f"{dtype}", "part": "serve", "window": cfg.window,
                   "tf32": torch.backends.cuda.matmul.allow_tf32,
                   **moe_parity_check(logs, pins, dtype),
                   "routes_differ": log.differing(),
                   "routes_compared": sum(r.shape[0] * r.shape[1]
                                          for r in log.used),
                   "wall_s": wall, "launches": counts,
                   "expected_launches": need}
            emit(row)
            if {k: v for k, v in counts.items() if v} != need:
                raise SystemExit(f"moe_parity launched {counts}")
            if not row["close"] or (dtype == "float32"
                                    and row["routes_differ"]):
                raise SystemExit(f"moe_parity differs from JAX's: {row}")
            del params
            losses, counts = moe_train_losses(tf, convert, cfg, "cuda",
                                              launches)
            n = 2 * cfg.n_layers * LM_TRAIN_PARITY_STEPS
            need = {"flash_attention": n, "flash_attention_bwd": n}
            want = pins["losses"]
            close = [bool(math.isclose(a, b, rel_tol=t["rtol"],
                                       abs_tol=t["atol"]))
                     for a, b, t in zip(losses, want,
                                        MOE_TRAIN_PARITY_TOL[dtype])]
            row = {"phase": "moe_parity", "config": f"{arch} reduced, "
                   f"{dtype}", "part": "train", "accum_steps": 2,
                   "losses": losses, "jax_losses": want,
                   "max_abs_diff": max(abs(a - b)
                                       for a, b in zip(losses, want)),
                   "tol": MOE_TRAIN_PARITY_TOL[dtype], "close": close,
                   "launches": counts, "expected_launches": need}
            emit(row)
            if {k: v for k, v in counts.items() if v} != need:
                raise SystemExit(f"moe_parity training launched {counts}")
            if len(losses) != len(want) or not all(close):
                raise SystemExit(f"moe_parity training differs from JAX's "
                                 f"losses: {row}")


def phase_moe_serve(tf, moe_mod, launches, phase, arch, B, S,
                    n_layers=None):
    """An MoE LM at its published width (bf16, params drawn on the card;
    ``n_layers`` cuts the depth): prefill of B prompts of S tokens (a
    warm-up, then timed; the share of slots the capacity drops), then
    MOE_STEPS greedy serve_steps (a full cache padded by MOE_STEPS slots;
    a windowed one rolls) and MOE_STEPS serve_step_paged steps from the
    same prefill, fed the same tokens, each appending its K/V at slot
    pos % Skv. Checks: the param count against params_dense; finite
    prefill logits; the attention kernel once a layer in a prefill,
    never in decode; the first paged step's layer-0 K/V bit-equal to
    what serve_step wrote at that slot (the layers above read residuals
    the two attentions made in other roundings); each step's paged logits
    within MOE_PAGED_TOL of serve_step's on a copy of the paged cache
    that gives it the same keys (``same_keys``) and on the paged step's
    experts; the difference from the in-place decode is printed."""
    import dataclasses as dc

    import numpy as np
    import torch
    from repro_torch.configs import get_arch

    cfg = get_arch(arch).build_cfg()
    published = cfg.n_layers
    if n_layers is not None:
        cfg = dc.replace(cfg, n_layers=n_layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tf.init_params(gen, cfg, "cuda")
    torch.cuda.synchronize()
    leaves = [params["embed"], params["lm_head"], params["ln_f"],
              *params["layers"].values()]
    n_params = sum(t.numel() for t in leaves)
    emit({"phase": f"{phase}_setup", "config": arch,
          "n_layers": cfg.n_layers, "published_layers": published,
          "d_model": cfg.d_model, "n_heads": cfg.n_heads,
          "n_kv_heads": cfg.n_kv_heads, "d_head": cfg.d_head,
          "d_ff": cfg.d_ff, "n_experts": cfg.moe.n_experts,
          "top_k": cfg.moe.top_k, "vocab": cfg.vocab, "window": cfg.window,
          "dtype": str(cfg.dtype).removeprefix("torch."),
          "params": n_params, "params_dense": cfg.params_dense,
          "params_active": cfg.params_active,
          "param_gb": sum(t.nbytes for t in leaves) / 1e9,
          "init_s": time.perf_counter() - t0})
    if n_params != cfg.params_dense:
        raise SystemExit(f"{arch} params differ from params_dense")
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)).cuda()

    def run_prefill():
        out = tf.prefill(params, prompts, cfg)
        torch.cuda.synchronize()
        return out

    need = {"flash_attention": cfg.n_layers}
    with torch.inference_mode():
        for label in ("prefill_warmup", "prefill"):
            cache = logits = None
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            with RouteLog(moe_mod, cfg, keep=False) as log:
                (cache, logits), wall, counts = launches.drive(run_prefill)
            row = {"phase": phase, "path": label, "batch": B,
                   "prompt_len": S, "wall_s": wall,
                   "tokens_per_s": B * S / wall,
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "cache_gb": (cache["k"].nbytes + cache["v"].nbytes) / 1e9,
                   "capacity": moe_mod.capacity(cfg, S),
                   "dropped_share": log.drop_share(),
                   "dropped_share_by_layer": [round(x, 4) for x in
                                              log.drop_shares()],
                   "launches": counts, "expected_launches": need}
            emit(row)
            if {k: v for k, v in counts.items() if v} != need:
                raise SystemExit(f"{phase} {label} launched {counts}, not "
                                 f"{need}")
        if logits.shape != (B, cfg.vocab) or not bool(
                torch.isfinite(logits.float()).all()):
            raise SystemExit(f"{phase} prefill logits are not finite "
                             f"({B}, {cfg.vocab})")
        if cfg.window is None:
            for key in ("k", "v"):
                cache[key] = torch.cat([cache[key], cache[key].new_zeros(
                    cache[key].shape[:2] + (MOE_STEPS,)
                    + cache[key].shape[3:])], dim=2)
        Skv = cache["k"].shape[2]
        paged = {"k": cache["k"].clone(), "v": cache["v"].clone(),
                 "pos": cache["pos"]}
        first = {}

        def decode():
            nonlocal cache, logits
            toks, logs, step_s = [greedy(logits)], [], []
            for i in range(MOE_STEPS):
                t0 = time.perf_counter()
                slot = cache["pos"] % Skv
                logits, cache = tf.serve_step(params, cache, toks[-1], cfg)
                toks.append(greedy(logits))
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                logs.append(logits.float())
                if i == 0:
                    first.update(k=cache["k"][:, :, slot].clone(),
                                 v=cache["v"][:, :, slot].clone())
            return torch.cat(toks, 1), logs, step_s

        flips = []

        def decode_paged():
            logs, refs, step_s = [], [], []
            for i in range(MOE_STEPS):
                tok, pos = toks[:, i:i + 1], paged["pos"]
                ref_cache = same_keys(paged)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with RouteLog(moe_mod, cfg) as paged_log:
                    lg, k_new, v_new, nxt = tf.serve_step_paged(
                        params, paged, tok, cfg)
                paged["k"][:, :, pos % Skv] = k_new[:, :, 0]
                paged["v"][:, :, pos % Skv] = v_new[:, :, 0]
                paged["pos"] = nxt
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                logs.append(lg.float())
                # the reference takes the paged step's experts; where its
                # own would differ, a near tie went the other way
                with RouteLog(moe_mod, cfg, pinned=paged_log.own) as ref_log:
                    refs.append(tf.serve_step(params, ref_cache, tok,
                                              cfg)[0].float())
                flips.append(ref_log.differing())
                del ref_cache
                if i == 0:
                    first.update(k_new=k_new[:, :, 0], v_new=v_new[:, :, 0])
            return logs, refs, step_s

        rows, logs = {}, {}
        for path, fn in (("decode", decode), ("decode_paged", decode_paged)):
            torch.cuda.reset_peak_memory_stats()
            with RouteLog(moe_mod, cfg, keep=False) as log:
                out, wall, counts = launches.drive(fn)
            if path == "decode":
                toks, logs[path], step_s = out
            else:
                logs[path], refs, step_s = out
            step_ms = statistics.median(step_s) * 1e3
            rows[path] = {"phase": phase, "path": path, "batch": B,
                          "cache_slots": Skv, "steps": MOE_STEPS,
                          "first_pos": S, "wall_s": wall,
                          "step_ms_median": step_ms,
                          "step_ms_first": step_s[0] * 1e3,
                          "tokens_per_s": B / (step_ms / 1e3),
                          "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                          "dropped_share": log.drop_share(),
                          "launches": counts, "expected_launches": {}}
            if any(counts.values()):
                raise SystemExit(f"{phase} {path} launched {counts}; it runs "
                                 f"no kernel")
        a = torch.stack(logs["decode_paged"]).cpu()
        b = torch.stack(refs).cpu()
        d0 = {key: bool(torch.equal(first[key + "_new"][0], first[key][0]))
              for key in ("k", "v")}
        kv_diff = max(float((first[key + "_new"].float()
                             - first[key].float()).abs().max())
                      for key in ("k", "v"))
        rolling = torch.stack(logs["decode"]).cpu()
        worst, mean = float((a - b).abs().max()), float((a - b).abs().mean())
        scale, mean_ref = float(b.abs().max()), float(b.abs().mean())
        row = {"phase": phase, "path": "paged_vs_same_keys",
               "tol": MOE_PAGED_TOL, "max_abs_diff": worst,
               "mean_abs_diff": mean, "logit_scale": scale,
               "mean_abs_ref": mean_ref,
               "routes_compared": MOE_STEPS * B * cfg.n_layers,
               "routes_differ": sum(flips),
               "close": worst <= MOE_PAGED_TOL["worst"] * scale
               and mean <= MOE_PAGED_TOL["mean"] * mean_ref,
               "max_abs_diff_from_decode": float((a - rolling).abs().max()),
               "layer0_kv_bit_equal": d0, "kv_max_abs_diff": kv_diff,
               "tokens_in_range": bool(int(toks.min()) >= 0
                                       and int(toks.max()) < cfg.vocab)}
        for path in ("decode", "decode_paged"):
            emit(rows[path])
        emit(row)
        if (not row["close"] or not all(d0.values())
                or not row["tokens_in_range"]
                or not bool(torch.isfinite(a).all())):
            raise SystemExit(f"{phase}: paged decode disagrees with "
                             f"serve_step: {row}")
        if phase == "moe_serve":
            phase_profile(f"{phase}_prefill", run_prefill)
            step = {"k": paged["k"], "v": paged["v"], "pos": paged["pos"]}
            phase_profile(f"{phase}_decode_paged_step",
                          lambda: tf.serve_step_paged(params, step,
                                                      toks[:, -1:], cfg))
            phase_profile(f"{phase}_decode_step", lambda: tf.serve_step(
                params, dict(step), toks[:, -1:], cfg))
    del params, cache, paged
    torch.cuda.empty_cache()


def same_keys(cache):
    """A copy of a KV cache on which serve_step at its ``pos`` attends to
    the keys serve_step_paged does: the slots before ``pos`` and the new
    token, or on a full rolling buffer (pos >= Skv) all Skv slots and the
    new token (one slot more, rolled so that the step writes it)."""
    import torch
    pos, Skv = cache["pos"], cache["k"].shape[2]
    if pos < Skv:
        return {"k": cache["k"].clone(), "v": cache["v"].clone(),
                "pos": pos}
    return dict({key: torch.roll(torch.cat([cache[key], torch.zeros_like(
        cache[key][:, :, :1])], dim=2), (pos + 1) % (Skv + 1), dims=2)
        for key in ("k", "v")}, pos=pos)


def greedy(logits):
    """The greedy next tokens of (B, V) logits, (B, 1) int32."""
    import torch
    return torch.argmax(logits, -1)[:, None].to(torch.int32)


def run_moe(launches):
    """The MoE LM slices: granite-moe-3b-a800m at full width
    (moe_serve), mixtral-8x22b at full width and 4 layers
    (moe_window_serve), the reduced configs against JAX's pinned
    values (moe_parity), then training at full width: granite at 32
    layers (moe_train), mixtral at 1 (moe_window_train)."""
    from repro_torch import convert
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tf
    t0 = time.perf_counter()
    phase_moe_serve(tf, moe_mod, launches, "moe_serve", MOE_ARCH, MOE_BATCH,
                    MOE_PROMPT)
    phase_moe_serve(tf, moe_mod, launches, "moe_window_serve",
                    MOE_WINDOW_ARCH, MOE_WINDOW_BATCH, MOE_WINDOW_PROMPT,
                    MOE_WINDOW_LAYERS)
    phase_moe_parity(tf, convert, moe_mod, launches)
    for phase in MOE_TRAIN:
        phase_moe_train(tf, moe_mod, launches, phase)
    emit({"phase": "moe_phases_done", "wall_s": time.perf_counter() - t0})

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
    zero, as ``mlp_init`` scales them, every norm vector filled with its
    GNN_NORM_INIT value, as ``init_gnn_params`` fills it; ``shapes`` is
    the param tree with a shape tuple at each leaf. The model casts the
    MLPs to bfloat16 and keeps the norm vectors float32."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(node[k], k) for k in sorted(node)}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if key in GNN_NORM_INIT:
            return np.full(node, GNN_NORM_INIT[key], np.float32)
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
    in-degree), its forward timed; then the full-width layer shape from a real sampled batch
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

    # the launcher's batch: a hub row of 1,340 slots, the other rows
    # nearly all pads; the forward timed (its plain version walks the
    # 1,340 slots in Python: checked, not timed)
    gen = torch.Generator("cuda").manual_seed(11)
    N, K = launcher_nbrs.shape
    x, w = layer_x_w(N, gen)
    worst = tuple(map(max, worst, na_case(
        nops, nref, x, launcher_nbrs, w,
        {"phase": "kernel_neighbor_agg", "shape": "launcher batch", "N": N,
         "D": 128, "F": 128, "B": N, "K": K,
         "valid_slots": int((launcher_nbrs >= 0).sum())})))
    flops, nbytes, bound_ms, bound_by = neighbor_agg_bound(
        x, launcher_nbrs, w, 4, True)
    launcher = {"ms": cuda_ms(lambda: ext.neighbor_agg(
        x, launcher_nbrs, w, True), reps=5, iters=10, warmup=3),
        "flops": flops, "bytes": nbytes, "bound_ms": bound_ms,
        "bound_by": bound_by,
        "live_rows": int(((launcher_nbrs >= 0).sum(1) > 0).sum())}
    emit({"phase": "kernel_neighbor_agg", "shape": "launcher batch timing",
          "K": K, **launcher})
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
          "bwd_ms": cuda_ms(lambda: ext.neighbor_agg_bwd(g, *index, False,
                                                         True),
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
    bwd = {"ms": cuda_ms(lambda: ext.neighbor_agg_bwd(g, *index, False,
                                                      True),
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
        (lib - ext.neighbor_agg_bwd(g, *index, False, True)).abs()
        .max())
    bwd.update(library_ms=cuda_ms(lambda: a @ g, reps=5, iters=20, warmup=3),
               library_call="torch.sparse CSR (N x B, weights 1/count) @ g")
    row["backward"] = bwd
    row["launcher_batch"] = launcher
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
    launch count other than 2 forward (row 5d) + 2 backward a step, or a
    first loss
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
            FTConfig(ckpt_dir=d, ckpt_every=GNN_STEPS), batch_at=batch_at))
    losses = [m["loss"] for m in res.metrics_history]
    skipped = [i for i, m in enumerate(res.metrics_history)
               if m.get("skipped")]
    need = {"neighbor_agg_csr": 2 * GNN_STEPS,
            "neighbor_agg_bwd": 2 * GNN_STEPS}
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
    need = {"neighbor_agg_csr": 2 * GNN_LAUNCHER_STEPS,
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


# ------------------------------------------------ the other GNN archs

def gnn_arch_cfg(get_arch, arch, reduced=False):
    """The arch's config at its gnn_archs shape; ``get_arch`` is the
    port's registry or the JAX package's."""
    return get_arch(arch).build_cfg(reduced=reduced,
                                    shape=GNN_ARCH_SHAPE[arch])


def gnn_arch_batch(arch, first, graphs):
    """The numpy batch of ``arch``'s gnn_archs run: ``first`` (the first
    sampled minibatch_lg batch) with an edge_x drawn from GNN_EDGE_X_SEED,
    or, for schnet, ``graphs.molecule_batch()``. ``graphs`` is the port's
    data.graphs module or the JAX package's (the same arrays)."""
    import numpy as np
    if arch == "schnet":
        b = graphs.molecule_batch()
        return {k: b[k] for k in ("nodes", "pos", "edge_src", "edge_dst",
                                  "edge_mask", "node_mask", "graph_id",
                                  "graph_targets")}
    b = {k: first[k] for k in GNN_KEYS}
    b["edge_x"] = np.random.default_rng(GNN_EDGE_X_SEED).normal(
        size=(first["edge_src"].size, 4)).astype(np.float32)
    return b


def segment_sum_launches(cfg) -> int:
    """segment_sum launches of one training step, from models/gnn.py: a
    gatedgcn layer sums eta and the message by dst (2), and its backward
    the gradients of h[src] and h[dst] (2); a meshgraphnet layer sums e by
    dst (1), its backward h[src]'s and h[dst]'s (2); a schnet layer sums
    the message by dst (1), its backward xin[src]'s (1); a graph_reg loss
    pools by graph_id (1). A sum's gradient is a gather: no launch."""
    per_layer = {"gatedgcn": 4, "meshgraphnet": 3, "schnet": 2}[cfg.arch]
    return per_layer * cfg.n_layers + int(cfg.task == "graph_reg")


def segment_sum_bound(msgs, ids, n_rows):
    """(FLOPs, bytes, bound ms, bound_by) of one segment_sum: the rows of
    msgs whose id is valid and the index (N + 1 offsets, one int32 per
    valid edge) read once, the (N, D) sum written once; one add per valid
    edge and element."""
    D = msgs.shape[1]
    nv = int((ids >= 0).sum())
    nbytes = nv * D * 4 + (n_rows + 1) * 8 + nv * 4 + n_rows * D * 4
    flops = nv * D
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return flops, nbytes, max(t_ops, t_bytes) * 1e3, (
        "operations" if t_ops > t_bytes else "bytes")


def ss_case(nops, msgs, ids, n_rows, row):
    """One segment_sum case: the kernel on the card (twice) against its
    plain version on the CPU (``index_add_`` in the chunk order there),
    bit for bit. Returns the max abs error."""
    import torch
    out = nops.segment_sum(msgs, ids, n_rows)
    again = nops.segment_sum(msgs, ids, n_rows)
    torch.cuda.synchronize()
    want = nops.segment_sum(msgs.cpu(), ids.cpu(), n_rows)
    got = out.cpu()
    idc = ids.cpu()
    per_id = torch.bincount(idc[idc >= 0].long(), minlength=max(n_rows, 1))
    from repro_torch.kernels._build import load_extension
    row = {"phase": "kernel_segment_sum", **row, "E": ids.shape[0],
           "D": msgs.shape[1], "n_rows": n_rows,
           "vec_width": load_extension().segment_sum_vec_width(
               msgs.shape[1], 16),
           "valid_edges": int((idc >= 0).sum()),
           "max_edges_one_id": int(per_id.max()) if n_rows else 0,
           "equal": torch.equal(got, want),
           "run_to_run_equal": torch.equal(out, again),
           "max_abs_err": max_abs_err([got], [want])}
    emit(row)
    if not (row["equal"] and row["run_to_run_equal"]):
        raise SystemExit(f"segment_sum disagrees with its plain version: "
                         f"{row}")
    return row["max_abs_err"]


def phase_kernel_segment_sum(nops, nref, first, graphs):
    """segment_sum (row 5c's kernel over an edge list) on the card against
    its plain version, bit for bit: the graph_reg pooling (D = 1),
    gatedgcn's D = 70 and meshgraphnet's D = 128 on the first sampled
    batch's edges by dst (masked ones skipped), and by src (the gradient
    of h[src], whose ids may pass 32 edges), D = 3, 33 and 130 on the same
    edges (4-, 4- and 8-byte loads; 130 in one pass), schnet's D = 64 on
    the molecules, an all-skipped input, an id of 1,000 edges (chunks of
    32), and node 0's padding hub (the masked edges kept); then
    meshgraphnet's and gatedgcn's layer timed eagerly and in a CUDA graph
    beside the plain version, ``index_add_`` (the library call; atomics)
    and the bound. Returns the timed row (meshgraphnet's layer) and the
    worst error."""
    import numpy as np
    import torch

    from repro_torch.kernels._build import load_extension
    gen = torch.Generator("cuda").manual_seed(5)

    def msgs_of(E, D):
        return torch.randn((E, D), device="cuda", generator=gen)

    N = first["nodes"].shape[0]
    dst = torch.from_numpy(first["edge_dst"]).cuda()
    emask = torch.from_numpy(first["edge_mask"]).cuda()
    dst_ids = torch.where(emask, dst, -1)
    src_ids = torch.where(emask, torch.from_numpy(first["edge_src"]).cuda(),
                          -1)
    mol = graphs.molecule_batch()
    mol_ids = torch.from_numpy(mol["edge_dst"]).cuda()
    gid = torch.from_numpy(mol["graph_id"]).cuda()
    rng = np.random.default_rng(3)
    hub = rng.integers(-1, 500, size=5000).astype(np.int32)
    hub[rng.permutation(5000)[:1000]] = 7
    cases = [("pooling", msgs_of(gid.shape[0], 1), gid, 128),
             ("gatedgcn layer", msgs_of(dst.shape[0], 70), dst_ids, N),
             ("schnet layer", msgs_of(mol_ids.shape[0], 64), mol_ids,
              mol["nodes"].shape[0]),
             ("meshgraphnet layer", msgs_of(dst.shape[0], 128), dst_ids, N),
             ("gatedgcn h[src] gradient", msgs_of(dst.shape[0], 70),
              src_ids, N),
             ("D = 3", msgs_of(dst.shape[0], 3), dst_ids, N),
             ("D = 33", msgs_of(dst.shape[0], 33), dst_ids, N),
             ("D = 130", msgs_of(dst.shape[0], 130), dst_ids, N),
             ("all skipped", msgs_of(1000, 64),
              torch.full((1000,), -1, dtype=torch.int32, device="cuda"), 300),
             ("an id of 1,000 edges", msgs_of(5000, 128),
              torch.from_numpy(hub).cuda(), 500),
             ("node 0's padding hub", msgs_of(dst.shape[0], 128), dst, N)]
    worst = 0.0
    for name, msgs, ids, n in cases:
        worst = max(worst, ss_case(nops, msgs, ids, n, {"case": name}))

    timed = {}
    for name, D in (("gatedgcn layer", 70), ("meshgraphnet layer", 128)):
        msgs = msgs_of(dst.shape[0], D) * emask[:, None]
        index = nops.segment_index(dst_ids, N)
        dst_l = dst.long()
        flops, nbytes, bound, by = segment_sum_bound(msgs, dst_ids, N)
        row = {"phase": "kernel_segment_sum_timed", "case": name,
               "E": dst.shape[0], "D": D, "n_rows": N,
               "vec_width": load_extension().segment_sum_vec_width(D, 16),
               "valid_edges": int(emask.sum()),
               "ms": cuda_ms(lambda: nops.segment_sum(msgs, dst_ids, N,
                                                      index)),
               "graph_ms": graph_ms(lambda: nops.segment_sum(
                   msgs, dst_ids, N, index)),
               "with_index_build_ms": cuda_ms(lambda: nops.segment_sum(
                   msgs, dst_ids, N)),
               "plain_ms": cuda_ms(lambda: nref.neighbor_agg_bwd_ref(
                   msgs, dst_ids[:, None], N, mean=False), reps=3,
                   iters=10),
               "library_ms": cuda_ms(lambda: torch.zeros(
                   (N, D), device="cuda").index_add_(0, dst_l, msgs)),
               "library_graph_ms": graph_ms(lambda: torch.zeros(
                   (N, D), device="cuda").index_add_(0, dst_l, msgs)),
               "library_call": "torch.zeros((N, D)).index_add_(0, dst, "
                               "msgs), the masked rows of msgs zero "
                               "(float atomics)",
               "bound_ms": bound, "bound_by": by, "bound_bytes": nbytes,
               "bound_flops": flops}
        emit(row)
        timed[name] = row
    del cases, msgs
    torch.cuda.empty_cache()
    out = dict(timed["meshgraphnet layer"])
    out["gatedgcn_layer"] = {k: timed["gatedgcn layer"][k] for k in (
        "ms", "graph_ms", "plain_ms", "library_ms", "bound_ms")}
    return out, worst


def phase_gnn_archs(launches, first, graphs):
    """gatedgcn, meshgraphnet and schnet at their published widths
    through the port's train step and fault-tolerant driver (float32
    activations, bf16 MLPs and float32 norms as JAX's init has them):
    step 0's loss and gradients twice, bit-equal; GNN_ARCH_STEPS AdamW
    steps on one batch, each timed, the peak memory; one more step under
    the profiler. Fails on a recovered failure, a skipped step, a
    non-finite loss, a launch count other than segment_sum_launches a
    step, unequal repeats, or a loss outside GNN_ARCH_LOSS_TOL of JAX's
    pins."""
    import tempfile

    import torch
    from repro_torch import convert
    from repro_torch.configs import get_arch
    from repro_torch.models import gnn
    from repro_torch.train.fault_tolerance import FTConfig, run_training
    from repro_torch.train.optimizer import AdamWConfig, init_adamw
    from repro_torch.train.train_loop import make_train_step, value_and_grad
    from repro_torch.train.tree import tree_flatten

    opt_cfg = AdamWConfig(**GNN_OPT)
    for arch in GNN_OTHER_ARCHS:
        cfg = gnn_arch_cfg(get_arch, arch)
        b = gnn_arch_batch(arch, first, graphs)
        tb = {k: torch.from_numpy(v).cuda() for k, v in b.items()}
        params = convert.gnn_params_from_numpy(
            gnn_numpy_params(gnn.gnn_param_shapes(cfg)), cfg, "cuda",
            dtype=torch.bfloat16)

        def loss_fn(p, bb, cfg=cfg):
            return gnn.gnn_loss(p, bb, cfg)

        runs = [tree_flatten(value_and_grad(loss_fn, params, tb))
                for _ in range(2)]
        repeat_equal = all(torch.equal(x, y) for x, y in zip(*runs))
        del runs
        step_fn = make_train_step(loss_fn, opt_cfg)
        step_ms = []

        def timed_step(p, o, bb, step_fn=step_fn, step_ms=step_ms):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step_fn(p, o, bb)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with tempfile.TemporaryDirectory() as d:
            state = (params, init_adamw(params, opt_cfg))
            res, wall, counts = launches.drive(lambda: run_training(
                timed_step, state, None, GNN_ARCH_STEPS,
                FTConfig(ckpt_dir=d, ckpt_every=GNN_ARCH_STEPS),
                batch_at=lambda step: tb))
        peak = torch.cuda.max_memory_allocated() / 1e9
        losses = [m["loss"] for m in res.metrics_history]
        skipped = [i for i, m in enumerate(res.metrics_history)
                   if m.get("skipped")]
        need = {"segment_sum": GNN_ARCH_STEPS * segment_sum_launches(cfg)}
        pinned = GNN_ARCH_JAX_LOSSES[arch]
        close = [bool(math.isclose(x, y, rel_tol=t["rtol"],
                                   abs_tol=t["atol"]))
                 for x, y, t in zip(losses, pinned, GNN_ARCH_LOSS_TOL)]
        row = {"phase": "gnn_archs", "config": arch,
               "shape": GNN_ARCH_SHAPE[arch], "n_layers": cfg.n_layers,
               "d_hidden": cfg.d_hidden, "d_in": cfg.d_in,
               "mlp_layers": cfg.mlp_layers, "rbf": cfg.rbf,
               "task": cfg.task, "nodes": int(b["nodes"].shape[0]),
               "edges": int(b["edge_src"].size),
               "valid_edges": int(b["edge_mask"].sum()),
               "params": sum(t.numel() for t in tree_flatten(params)),
               "steps": res.steps_done, "wall_s": wall, "step_ms": step_ms,
               "peak_gb": peak, "failures_recovered": res.failures_recovered,
               "skipped_steps": skipped, "losses": losses,
               "jax_losses": pinned, "loss_tol": GNN_ARCH_LOSS_TOL,
               "losses_close_to_jax": close,
               "step0_repeat_bit_equal": repeat_equal, "launches": counts,
               "expected_launches": need}
        emit(row)
        if res.failures_recovered or skipped or res.steps_done != \
                GNN_ARCH_STEPS:
            raise SystemExit(f"gnn_archs recovered from failures or "
                             f"skipped steps: {row}")
        if not all(math.isfinite(v) for v in losses):
            raise SystemExit(f"gnn_archs gave non-finite losses: {row}")
        if {k: v for k, v in counts.items() if v} != need:
            raise SystemExit(f"gnn_archs launched {counts}, not {need}")
        if not repeat_equal:
            raise SystemExit(f"{arch}'s step 0 changed its bits on a "
                             f"repeat")
        if len(pinned) != len(losses) or not all(close):
            raise SystemExit(f"{arch}'s losses differ from JAX's: "
                             f"{losses} vs {pinned}")
        p, o = state
        phase_profile(f"gnn_{arch}_step", lambda: step_fn(p, o, tb),
                      watch=("neighbor_agg_bwd_kernel",))
        del state, params, p, o, tb
        torch.cuda.empty_cache()


def gnn_arch_parity_cases(cfg, graphs, arch):
    """The reduced config's batches of gnn_archs_parity (numpy): a
    padded graph batch, and for schnet also 8 small molecules under
    graph_reg. Yields (label, cfg, batch)."""
    import dataclasses
    src, dst = graphs.random_graph(200, 2.0, seed=3)
    yield "graph", cfg, graphs.build_graph_batch(
        200, src, dst, cfg.d_in, cfg.n_classes, seed=3, pad_nodes=256,
        pad_edges=512)
    if arch == "schnet":
        yield "molecules", dataclasses.replace(cfg, task="graph_reg"), \
            graphs.molecule_batch(8, 10, 20, d_feat=cfg.d_in, seed=2)


def phase_gnn_archs_parity(graphs):
    """The three reduced configs in float32 (TF32 off), card against
    CPU: the loss and every gradient within GNN_PARITY_TOL."""
    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.configs import get_arch
    from repro_torch.models import gnn
    from repro_torch.train.train_loop import value_and_grad
    from repro_torch.train.tree import tree_flatten
    for arch in GNN_OTHER_ARCHS:
        base = get_arch(arch).build_cfg(reduced=True)
        for label, cfg, b in gnn_arch_parity_cases(base, graphs, arch):
            tree = gnn_numpy_params(gnn.gnn_param_shapes(cfg), seed=3)
            out = {}
            for dev in ("cuda", "cpu"):
                p = convert.gnn_params_from_numpy(tree, cfg, dev,
                                                  dtype=torch.float32)
                tb = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
                loss, grads = value_and_grad(
                    lambda q, bb: gnn.gnn_loss(q, bb, cfg), p, tb)
                out[dev] = [loss.cpu().numpy()] + [
                    g.cpu().numpy() for g in tree_flatten(grads)]
            diffs = [float(np.abs(x - y).max())
                     for x, y in zip(out["cuda"], out["cpu"])]
            ok = all(np.allclose(x, y, **GNN_PARITY_TOL)
                     for x, y in zip(out["cuda"], out["cpu"]))
            row = {"phase": "gnn_archs_parity",
                   "config": f"{arch} reduced, float32", "batch": label,
                   "task": cfg.task,
                   "tf32": torch.backends.cuda.matmul.allow_tf32,
                   "tol": GNN_PARITY_TOL, "loss_cuda": float(out["cuda"][0]),
                   "loss_cpu": float(out["cpu"][0]),
                   "loss_abs_diff": diffs[0],
                   "grad_max_abs_diff": max(diffs[1:]), "ok": ok}
            emit(row)
            if not ok:
                raise SystemExit(f"reduced {arch} differs card vs cpu: "
                                 f"{row}")


def phase_gnn_arch_launcher(launches):
    """The train launcher for each arch at its defaults (full_graph_sm,
    full width) for GNN_ARCH_LAUNCHER_STEPS steps in a fresh checkpoint
    directory, held to the JAX launcher's losses."""
    import tempfile

    from repro_torch.configs import get_arch
    from repro_torch.launch import train as launch_train
    for arch in GNN_OTHER_ARCHS:
        argv = ["--arch", arch, "--steps", str(GNN_ARCH_LAUNCHER_STEPS)]
        with tempfile.TemporaryDirectory() as d:
            res, wall, counts = launches.drive(lambda: launch_train.main(
                argv + ["--ckpt_dir", d]))
        cfg = get_arch(arch).build_cfg()
        losses = [m["loss"] for m in res.metrics_history]
        need = {"segment_sum": GNN_ARCH_LAUNCHER_STEPS
                * segment_sum_launches(cfg)}
        pinned = GNN_ARCH_LAUNCHER_JAX_LOSSES[arch]
        t = GNN_ARCH_LAUNCHER_TOL
        close = [bool(math.isclose(x, y, rel_tol=t["rtol"],
                                   abs_tol=t["atol"]))
                 for x, y in zip(losses, pinned)]
        row = {"phase": "gnn_arch_launcher", "argv": argv, "wall_s": wall,
               "steps": res.steps_done,
               "failures_recovered": res.failures_recovered,
               "losses": losses, "jax_losses": pinned, "loss_tol": t,
               "losses_close_to_jax": close, "launches": counts,
               "expected_launches": need}
        emit(row)
        if res.failures_recovered or any(m.get("skipped")
                                         for m in res.metrics_history):
            raise SystemExit(f"the train launcher hid a failure: {row}")
        if {k: v for k, v in counts.items() if v} != need:
            raise SystemExit(f"the train launcher launched {counts}")
        if len(pinned) != len(losses) or not all(close):
            raise SystemExit(f"the train launcher's losses differ from "
                             f"JAX's: {row}")


# ------------------------------------------- row 5d and the full batch

def csr_stats(indptr, indices) -> dict:
    """The shape of a CSR's work: valid slots, rows, the longest row, the
    rows past 32 slots and their slots, and the busiest source id."""
    import torch
    cnt = indptr[1:] - indptr[:-1]
    E = int(indptr[-1])
    long_rows = cnt > 32
    per_id = torch.bincount(indices[:E].long())
    return {"rows": int(cnt.numel()), "valid_slots": E,
            "live_rows": int((cnt > 0).sum()), "K": int(cnt.max()),
            "rows_past_32": int(long_rows.sum()),
            "slots_in_rows_past_32": int(cnt[long_rows].sum()),
            "busiest_id_slots": int(per_id.max()) if E else 0}


def neighbor_agg_csr_bound(x, indptr, indices, w, with_mean):
    """(FLOPs, bytes, bound ms, bound_by) of one row 5d forward: the rows
    of x that the slots name, indptr, the valid indices and w read once,
    the float32 output (and the mean, when training keeps it) written
    once; one add per valid slot and element on the CUDA cores, and the
    product of each row with a slot on the tensor cores in TF32, 2 D F a
    row for each of its products (two for a bfloat16 w, the mean's two
    TF32 parts; three for a float32 w). The rows a hub names again (31.7
    GB of gathers at the ogb layer) are not counted: each is one read."""
    import torch
    B = indptr.numel() - 1
    D, F = w.shape
    E = int(indptr[-1])
    rows = int(torch.unique(indices[:E]).numel())
    live = int(((indptr[1:] - indptr[:-1]) > 0).sum())
    nbytes = (rows * D * x.element_size() + (B + 1) * 8 + E * 4
              + w.numel() * w.element_size() + B * F * 4
              + (B * D * 4 if with_mean else 0))
    products = 2 if w.dtype == torch.bfloat16 else 3
    adds, mma = E * D, products * 2 * live * D * F
    t_ops = adds / FP32_FLOPS + mma / TF32_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S
    return adds + mma, nbytes, max(t_ops, t_bytes) * 1e3, (
        "operations" if t_ops > t_bytes else "bytes")


def csr_case(nops, nref, x, indptr, indices, w, row, on_cpu=True):
    """One row 5d case on the card. With ``on_cpu``: the card's mean and
    its backward (row 5b's mean mode over ``csr_transpose_index``) bit
    for bit against the plain versions on the CPU (``index_add_`` in the
    chunk order), the output within NA_CSR_TOL (the product's order), each
    equal to itself on a second run. Without (the ogb layer, too large for
    the host's plain version): the output and the mean within NA_CSR_TOL
    of the plain version on the card, whose atomics add in another order.
    Returns the forward's and the backward's max abs error."""
    import torch
    from repro_torch.kernels._build import load_extension
    N = x.shape[0]
    out = nops.neighbor_agg_csr(x, indptr, indices, w)
    # the second run with the chunk units built ahead, as the model's
    # layers take them
    again, mean = nops.launch_csr(x, indptr, indices, w, nops.chunk_units(
        indptr, indices.shape[0]))
    g = torch.randn(out.shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(7))
    gw = g @ w.float().t()
    index = nops.csr_transpose_index(indptr, indices, N)
    ext = load_extension()
    gx = ext.neighbor_agg_bwd(gw, *index, False, True)
    gx2 = ext.neighbor_agg_bwd(gw, *index, False, True)
    torch.cuda.synchronize()
    row = {"phase": "kernel_neighbor_agg_csr", **row,
           **csr_stats(indptr, indices), "N": N, "D": x.shape[1],
           "F": w.shape[1], "w_dtype": str(w.dtype).removeprefix("torch."),
           "fwd_tol": NA_CSR_TOL,
           "fwd_run_to_run_equal": torch.equal(out, again),
           "bwd_run_to_run_equal": torch.equal(gx, gx2),
           "plain_on": "cpu" if on_cpu else "cuda"}
    del again, gx2, index
    if not on_cpu:            # room for the plain version's 31.7 GB
        del g, gw, gx
        torch.cuda.empty_cache()
    if on_cpu:
        args = (x.cpu(), indptr.cpu(), indices.cpu())
        want_mean, _ = nref.neighbor_mean_csr_ref(*args)
        want = (want_mean @ w.cpu().float())
        want_gx = nref.neighbor_agg_csr_bwd_ref(gw.cpu(), *args[1:], N)
        got, got_mean, got_gx = out.cpu(), mean.cpu(), gx.cpu()
        row.update(mean_bit_equal=torch.equal(got_mean, want_mean),
                   bwd_bit_equal=torch.equal(got_gx, want_gx),
                   bwd_max_abs_err=max_abs_err([got_gx], [want_gx]))
        ok = row["mean_bit_equal"] and row["bwd_bit_equal"]
    else:
        want_mean, _ = nref.neighbor_mean_csr_ref(x, indptr, indices)
        want = want_mean @ w.float()
        got, got_mean = out, mean
        row.update(mean_max_abs_err=float(
            (got_mean - want_mean).abs().max()),
            mean_close=torch.allclose(got_mean, want_mean,
                                      **NA_CSR_TOL),
            bwd_max_abs_err=None)
        ok = row["mean_close"]
        del want_mean
    row.update(fwd_max_abs_err=float((got - want).abs().max())
               if got.numel() else 0.0,
               close=torch.allclose(got, want, **NA_CSR_TOL))
    emit(row)
    if not (ok and row["close"] and row["fwd_run_to_run_equal"]
            and row["bwd_run_to_run_equal"]):
        raise SystemExit(f"neighbor_agg_csr disagrees with its plain "
                         f"version: {row}")
    return row["fwd_max_abs_err"], row["bwd_max_abs_err"] or 0.0


def csr_timed(nops, nref, x, indptr, indices, w, label, iters):
    """Row 5d at one layer: eager and in a CUDA graph with its chunk units
    built ahead, as the model's layers call it (and eager with the
    wrapper building them), each launch's share (the tickets' memset, the
    heavy pass, the tile kernel), the plain version, ``F.embedding_bag``
    (mean, by offsets) then ``torch.matmul``, the bound; the call and its
    shares without the busiest row (what its chunks and their ordered
    tail cost); then row 5b's backward over the layer's by-source index,
    with its shares."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels._build import load_extension
    ext = load_extension()
    N, D = x.shape
    E = int(indptr[-1])
    flops, nbytes, bound_ms, bound_by = neighbor_agg_csr_bound(
        x, indptr, indices, w, True)
    units = nops.chunk_units(indptr, indices.shape[0])
    reps = dict(reps=3, iters=iters, warmup=2)

    def call():
        return nops.neighbor_agg_csr(x, indptr, indices, w, units=units)

    row = {"phase": "kernel_neighbor_agg_csr_timed", "layer": label,
           **csr_stats(indptr, indices), "N": N, "D": D, "F": w.shape[1],
           "chunk_units": int(units[0][-1]),
           "ms": cuda_ms(call, **reps),
           "graph_ms": graph_ms(call, iters=iters),
           "with_units_build_ms": cuda_ms(lambda: nops.neighbor_agg_csr(
               x, indptr, indices, w), **reps),
           "split_ms": kernel_split(call, iters=min(iters, 5)),
           "flops": flops, "bytes": nbytes, "bound_ms": bound_ms,
           "bound_by": bound_by,
           "gathered_bytes": E * D * x.element_size()}
    # without the busiest row's slots: what its chunk partials and their
    # ordered tail cost beyond the rest
    cnt = indptr[1:] - indptr[:-1]
    hub = int(cnt.argmax())
    lo, hi = int(indptr[hub]), int(indptr[hub + 1])
    rest_ptr = torch.where(torch.arange(indptr.numel(), device="cuda") > hub,
                           indptr - (hi - lo), indptr)
    rest_idx = torch.cat([indices[:lo], indices[hi:]])
    rest_units = nops.chunk_units(rest_ptr, rest_idx.shape[0])

    def rest():
        return nops.neighbor_agg_csr(x, rest_ptr, rest_idx, w,
                                     units=rest_units)

    row.update(busiest_row=hub, busiest_row_slots=hi - lo,
               without_busiest_row_ms=cuda_ms(rest, **reps),
               without_busiest_row_split_ms=kernel_split(
                   rest, iters=min(iters, 5)))
    del rest_ptr, rest_idx, rest_units
    row["plain_ms"] = cuda_ms(lambda: nref.neighbor_agg_csr_ref(
        x, indptr, indices, w), reps=2, iters=1, warmup=1)
    torch.cuda.empty_cache()
    ids = indices[:E].long()
    offsets = indptr[:-1]
    wf = w.float()
    lib = F.embedding_bag(ids, x, offsets, mode="mean") @ wf
    row["library_max_abs_err"] = float((lib - call()).abs().max())
    del lib
    row.update(library_ms=cuda_ms(lambda: F.embedding_bag(
        ids, x, offsets, mode="mean") @ wf, **reps),
        library_call="two calls: F.embedding_bag(indices, x, "
                     "offsets=indptr[:-1], mode='mean'), then "
                     "torch.matmul")
    del ids
    g = torch.randn((indptr.numel() - 1, D), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(3))
    index = nops.csr_transpose_index(indptr, indices, N)

    def backward():
        return ext.neighbor_agg_bwd(g, *index, False, True)

    row["backward"] = {
        "ms": cuda_ms(backward, **reps),
        "split_ms": kernel_split(backward, iters=min(iters, 5)),
        "chunk_units": int(index.hptr[-1]),
        "heaviest_id_slots": int((index.rowptr[1:]
                                  - index.rowptr[:-1]).max())}
    emit(row)
    del g, index
    torch.cuda.empty_cache()
    return row


def phase_kernel_neighbor_agg_csr(nops, nref, first, pin_batch, ogb_batch):
    """Row 5d on the card: its mean and backward bit for bit against the
    plain versions on the CPU, its output within NA_CSR_TOL, on small
    CSRs (row 5's shapes as CSRs, hub rows of 33 to 2,049 slots, rows
    with none, F = 200 in two panels; then in bf16 and float32 w the tile
    kernel's edges: rows of 0, 32, 33, 1,024 and 1,025 slots, a hub of
    100,003, a tile of heavy rows only, a partial last tile, D = 256), at
    the minibatch_lg layer (the first sampled batch) and at the full-batch
    pin graph (131,072 nodes, 3.3M edges); within NA_CSR_TOL of the plain
    version on the card at the ogb layer (2,449,408 nodes, 61.9M edges).
    Timed at the ogb layer and the minibatch_lg layer with each launch's
    share. Returns the ogb row (the minibatch row in it) and the worst
    forward and backward errors."""
    import numpy as np
    import torch
    from repro_torch.models import gnn
    gen = torch.Generator("cuda").manual_seed(13)
    worst = (0.0, 0.0)

    def csr_of(b, n):
        t = {k: (v if torch.is_tensor(v) else torch.from_numpy(v)).cuda()
             for k, v in b.items()
             if k in ("edge_src", "edge_dst", "edge_mask")}
        return gnn.in_neighbors_csr(t["edge_src"], t["edge_dst"],
                                    t["edge_mask"], n)[:2]

    small = [(64, 32, 16, [3, 0, 4, 4, 1, 2, 0, 4], "float32"),
             (200, 128, 64, [10, 0, 33, 64, 65, 9, 1000, 2], "float32"),
             (50, 33, 7, [1, 0, 40, 70, 1], "float32"),
             (40, 5, 3, [0, 0, 2049, 0, 3], "bfloat16"),
             (300, 128, 128, [25] * 60 + [0] * 3 + [777], "bfloat16"),
             (10, 16, 8, [0, 0, 0], "float32"),
             (300, 128, 200, [25] * 70 + [0] * 3 + [777], "float32")]
    # the tile kernel's edges, in both w dtypes: rows of 0, 32, 33, 1,024
    # and 1,025 slots; a hub of 100,003 (not a multiple of 32; its tail
    # through the heavy pass's ring); a tile of heavy rows only; a partial
    # last tile (B = 209); D = 256 (two vectors a lane in the ring)
    edges = np.random.default_rng(33)
    for wd in ("bfloat16", "float32"):
        small += [(500, 128, 128, [0, 32, 33, 1024, 1025, 3, 0, 1], wd),
                  (3000, 128, 128, [5, 100_003, 0, 40, 7], wd),
                  (400, 128, 128, list(edges.integers(33, 200, size=64)),
                   wd),
                  (300, 128, 128, list(edges.integers(0, 40, size=209)), wd),
                  (64, 256, 128, [3, 0, 500, 33, 1], wd)]
    for N, D, F_, lengths, wd in small:
        rng = np.random.default_rng(N + D)
        indptr = torch.from_numpy(np.concatenate(
            [[0], np.cumsum(lengths)]).astype(np.int64)).cuda()
        E = int(indptr[-1])
        indices = torch.from_numpy(np.concatenate([rng.integers(
            0, N, size=E), [N - 1] * 3]).astype(np.int32)).cuda()
        x = torch.from_numpy(rng.normal(size=(N, D)).astype(
            np.float32)).cuda()
        w = torch.from_numpy((rng.normal(size=(D, F_)) * 0.1).astype(
            np.float32)).to(getattr(torch, wd)).cuda()
        worst = tuple(map(max, worst, csr_case(
            nops, nref, x, indptr, indices, w,
            {"case": f"small, {len(lengths)} rows of {min(lengths)}-"
                     f"{max(lengths)} slots, D {D}, F {F_}, w {wd}"})))

    for label, b, on_cpu in (("minibatch_lg layer", first, True),
                             ("full-batch pin graph", pin_batch, True),
                             ("ogb layer", ogb_batch, False)):
        n = b["nodes"].shape[0]
        indptr, indices = csr_of(b, n)
        x, w = layer_x_w(n, gen)
        worst = tuple(map(max, worst, csr_case(
            nops, nref, x, indptr, indices, w, {"case": label},
            on_cpu=on_cpu)))
        if label == "minibatch_lg layer":
            mb = csr_timed(nops, nref, x, indptr, indices, w, label, 20)
        elif label == "ogb layer":
            row = csr_timed(nops, nref, x, indptr, indices, w, label, 5)
        del x, w, indptr, indices
        torch.cuda.empty_cache()
    row["minibatch_lg_layer"] = {k: mb[k] for k in (
        "ms", "graph_ms", "with_units_build_ms", "split_ms", "plain_ms",
        "library_ms", "bound_ms", "bound_by", "backward", "valid_slots",
        "K")}
    return row, worst


def phase_gnn_full_batch_parity(launches, pin_batch):
    """The train launcher at ogb_products (its config and AdamW) for
    GNN_FB_STEPS steps on the batch its recipe makes at GNN_FB_PIN_NODES
    nodes and GNN_FB_PIN_EDGES edges, held to the JAX launcher's losses
    (GNN_FULL_BATCH_JAX_LOSSES, GNN_FB_TOL) and asked to fall."""
    import tempfile

    from repro_torch.launch import train as launch_train
    argv = ["--arch", GNN_ARCH, "--shape", GNN_FB_SHAPE, "--steps",
            str(GNN_FB_STEPS)]
    orig = launch_train.gnn_batches
    launch_train.gnn_batches = lambda *a, **k: (lambda step: pin_batch)
    try:
        with tempfile.TemporaryDirectory() as d:
            res, wall, counts = launches.drive(lambda: launch_train.main(
                argv + ["--ckpt_dir", d]))
    finally:
        launch_train.gnn_batches = orig
    losses = [m["loss"] for m in res.metrics_history]
    need = {"neighbor_agg_csr": 2 * GNN_FB_STEPS,
            "neighbor_agg_bwd": 2 * GNN_FB_STEPS}
    pinned = GNN_FULL_BATCH_JAX_LOSSES
    close = [bool(math.isclose(a, b, rel_tol=t["rtol"], abs_tol=t["atol"]))
             for a, b, t in zip(losses, pinned, GNN_FB_TOL)]
    row = {"phase": "gnn_full_batch_parity", "argv": argv,
           "nodes": GNN_FB_PIN_NODES, "edges": GNN_FB_PIN_EDGES,
           "valid_edges": int(pin_batch["edge_mask"].sum()),
           "wall_s": wall, "steps": res.steps_done,
           "failures_recovered": res.failures_recovered, "losses": losses,
           "jax_losses": pinned, "loss_tol": GNN_FB_TOL,
           "losses_close_to_jax": close,
           "max_rel_diff": max(abs(a - b) / abs(b)
                               for a, b in zip(losses, pinned)),
           "launches": counts, "expected_launches": need}
    emit(row)
    if res.failures_recovered or any(m.get("skipped")
                                     for m in res.metrics_history):
        raise SystemExit(f"gnn_full_batch_parity hid a failure: {row}")
    if {k: v for k, v in counts.items() if v} != need:
        raise SystemExit(f"gnn_full_batch_parity launched {counts}")
    if len(pinned) != len(losses) or not all(close) \
            or not losses[-1] < losses[0]:
        raise SystemExit(f"the full-batch losses differ from JAX's: {row}")


def phase_gnn_full_batch(launches, batch_at, build_s):
    """graphsage-reddit at ogb_products, nothing cut, through the train
    launcher (``python -m repro_torch.launch.train --arch
    graphsage-reddit --shape ogb_products --steps 3``, its batch built
    once and handed to it): GNN_FB_STEPS steps, finite and falling, 2 + 2
    launches a step, each step timed (a synchronise on either side) and
    its step 0's loss and gradients kept; then one more pass of step 0,
    bit-equal to the kept one; the peak memory, one profiled step."""
    import tempfile

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.cells import opt_config
    from repro_torch.models import gnn
    from repro_torch.train import train_loop
    from repro_torch.train.optimizer import init_adamw
    from repro_torch.train.tree import tree_flatten

    tb = batch_at(0)
    cfg = get_arch(GNN_ARCH).build_cfg(shape=GNN_FB_SHAPE)
    argv = ["--arch", GNN_ARCH, "--shape", GNN_FB_SHAPE, "--steps",
            str(GNN_FB_STEPS)]
    step_ms, first = [], []
    orig_vg, orig_make = (train_loop.value_and_grad,
                          launch_train.make_train_step)

    def kept_vg(*a, **k):
        out = orig_vg(*a, **k)
        if not first:
            first.extend(t.clone() for t in tree_flatten(out))
        return out

    def timed_make(*a, **k):
        step = orig_make(*a, **k)

        def timed(*sa, **sk):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*sa, **sk)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return out
        return timed

    orig_batches = launch_train.gnn_batches
    launch_train.gnn_batches = lambda *a, **k: batch_at
    train_loop.value_and_grad = kept_vg
    launch_train.make_train_step = timed_make
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        with tempfile.TemporaryDirectory() as d:
            res, wall, counts = launches.drive(lambda: launch_train.main(
                argv + ["--ckpt_dir", d]))
    finally:
        launch_train.gnn_batches = orig_batches
        train_loop.value_and_grad = orig_vg
        launch_train.make_train_step = orig_make
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [m["loss"] for m in res.metrics_history]

    def loss_fn(p, bb):
        return gnn.gnn_loss(p, bb, cfg)

    params = launch_train.launcher_params(cfg, "cuda")
    again = tree_flatten(orig_vg(loss_fn, params, tb))
    repeat_equal = len(again) == len(first) and all(
        torch.equal(a, b) for a, b in zip(first, again))
    first_equal = float(first[0]) == losses[0]
    del first, again
    batch_gb = sum(t.numel() * t.element_size() for t in tb.values()) / 1e9
    need = {"neighbor_agg_csr": 2 * GNN_FB_STEPS,
            "neighbor_agg_bwd": 2 * GNN_FB_STEPS}
    row = {"phase": "gnn_full_batch", "argv": argv, "config": GNN_ARCH,
           "shape": GNN_FB_SHAPE, "n_layers": cfg.n_layers,
           "d_hidden": cfg.d_hidden, "d_in": cfg.d_in,
           "n_classes": cfg.n_classes, "nodes": int(tb["nodes"].shape[0]),
           "edges": int(tb["edge_src"].shape[0]),
           "valid_edges": int(tb["edge_mask"].sum()),
           "batch_build_s": build_s, "batch_gb": batch_gb,
           "launcher_wall_s": wall, "steps": res.steps_done,
           "failures_recovered": res.failures_recovered, "losses": losses,
           "step_ms": step_ms, "peak_gb": peak,
           "step0_repeat_bit_equal": repeat_equal,
           "step0_equals_launcher_loss": first_equal,
           "launches": counts, "expected_launches": need,
           "launches_per_step": {k: v / GNN_FB_STEPS
                                 for k, v in counts.items() if v}}
    emit(row)
    if res.failures_recovered or res.steps_done != GNN_FB_STEPS or any(
            m.get("skipped") for m in res.metrics_history):
        raise SystemExit(f"gnn_full_batch hid a failure: {row}")
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < losses[0]:
        raise SystemExit(f"gnn_full_batch's losses are not finite and "
                         f"falling: {losses}")
    if {k: v for k, v in counts.items() if v} != need:
        raise SystemExit(f"gnn_full_batch launched {counts}, not {need}")
    if not (repeat_equal and first_equal):
        raise SystemExit(f"gnn_full_batch's step 0 changed its bits on a "
                         f"repeat: {row}")
    opt_cfg = opt_config(GNN_ARCH)
    step_fn = orig_make(loss_fn, opt_cfg)
    o = init_adamw(params, opt_cfg)
    phase_profile("gnn_full_batch_step", lambda: step_fn(params, o, tb),
                  watch=("neighbor_agg_bwd_kernel",
                         "neighbor_agg_tile_kernel"))
    return row


def run_gnn(launches, nops, nref):
    """The GNN training slice: the reddit-scale source graph and sampler
    on the host, the neighbor_agg kernel phase at the layer shape of its
    first batch, graphsage-reddit trained at full width, the train
    launcher at minibatch_lg, and the reduced config card against CPU;
    then the segment_sum kernel phase and the other three archs (trained
    at their published widths, card against CPU, the launcher). Returns
    the two kernels' timed rows and worst errors."""
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
    del tb
    timed, worst = phase_kernel_neighbor_agg(nops, nref, layer_nbrs,
                                             launcher_nbrs)
    del layer_nbrs, launcher_nbrs
    phase_gnn_train(launches, cfg, meta, sampler, feats, labels)
    del sampler, feats, labels
    torch.cuda.empty_cache()
    phase_gnn_launcher(launches)
    torch.cuda.empty_cache()
    phase_gnn_parity(arch.build_cfg(reduced=True), graphs)
    t0 = time.perf_counter()
    ss_timed, ss_worst = phase_kernel_segment_sum(nops, nref, first, graphs)
    phase_gnn_archs(launches, first, graphs)
    phase_gnn_archs_parity(graphs)
    phase_gnn_arch_launcher(launches)
    emit({"phase": "gnn_archs_done", "wall_s": time.perf_counter() - t0})

    # full-batch GraphSAGE at ogb_products and row 5d
    t0 = time.perf_counter()
    d_feat = arch.shapes[GNN_FB_SHAPE].meta["d_feat"]
    pin_batch = launch_train.graph_batch(GNN_FB_PIN_NODES, GNN_FB_PIN_EDGES,
                                         d_feat, "cuda", keys=GNN_KEYS)
    t1 = time.perf_counter()
    fb_batch_at = launch_train.gnn_batches(arch, GNN_FB_SHAPE, False, "cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    csr_row, csr_worst = phase_kernel_neighbor_agg_csr(
        nops, nref, first, pin_batch, fb_batch_at(0))
    del first
    torch.cuda.empty_cache()
    phase_gnn_full_batch_parity(launches, pin_batch)
    del pin_batch
    fb_row = phase_gnn_full_batch(launches, fb_batch_at, build_s)
    csr_row["gnn_full_batch_step_ms"] = fb_row["step_ms"]
    del fb_batch_at
    torch.cuda.empty_cache()
    emit({"phase": "gnn_full_batch_done", "pin_batch_s": t1 - t0,
          "ogb_batch_s": build_s, "wall_s": time.perf_counter() - t0})
    return timed, worst, ss_timed, ss_worst, csr_row, csr_worst

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


def device_row(phase, hg, a, st, wall):
    """A hype_device run's row: the path's metrics, the loop's counters
    and its CUDA graph (replays, nodes, warm-up + capture seconds)."""
    row = path_row(phase, hg, a, 32, wall)
    row.update(supersteps=st.supersteps, loop_chunks=st.loop_chunks,
               loop_rounds=st.loop_rounds, loop_pack_only=st.loop_pack_only,
               loop_store_peak=st.loop_store_peak,
               graph_captures=st.graph_captures,
               graph_replays=st.graph_replays, graph_nodes=st.graph_nodes,
               graph_capture_s=st.graph_capture_s, host_s=st.host_s,
               device_s=st.device_s,
               host_share=st.host_s / max(st.host_s + st.device_s, 1e-12),
               tile_l=st.tile_l)
    return row


def phase_device(hg, same_graph, slice_row, launches, metrics,
                 SuperstepParams, hype_superstep_partition, DeviceParams,
                 hype_device_partition, PRESETS):
    """hype_device on the slice's graph: the whole growth loop on the card,
    one round captured as a CUDA graph and replayed a chunk at a time.
    Held to the depth-1 slice's digest, k-1 and supersteps; every replay
    launches score + select once, and each capture's warm-up round once
    more (a capacity rerun captures anew). Then preset="quality" (the same
    schedule, then the refinement post-pass), held to the quality path's
    digest and screens. Then the depth-1 slice and hype_device one after
    the other, in this process."""
    import torch
    dp = DeviceParams(seed=0, t=16)
    (a, st), wall, counts = launches.drive(lambda: hype_device_partition(
        hg, 32, dp, return_stats=True, device="cuda"))
    row = device_row("device", hg, a, st, wall)
    cpu = None if same_graph else slice_row["expected_digest"]
    check_path(row, SLICE_DIGESTS[1], SLICE_KM1[1], cpu, counts,
               {"hype_score_select": st.graph_replays + st.graph_captures})
    if st.supersteps != slice_row["supersteps"]:
        raise SystemExit(f"hype_device ran {st.supersteps} supersteps; the "
                         f"depth-1 slice {slice_row['supersteps']}")
    if st.graph_replays < st.supersteps or st.graph_nodes <= 0:
        raise SystemExit(f"hype_device did not run as graph replays: {row}")
    qp = DeviceParams(seed=0, t=16, **PRESETS["hype_device"]["quality"])
    (a, st), wall, counts = launches.drive(lambda: hype_device_partition(
        hg, 32, qp, return_stats=True, device="cuda"))
    row = device_row("device_quality", hg, a, st, wall)
    row["refine"] = dataclasses.asdict(st.refine)
    screens = st.refine.kernel_calls
    if same_graph and screens != QUALITY_SCREENS:
        raise SystemExit(f"hype_device quality screened {screens} tiles; "
                         f"the JAX run screened {QUALITY_SCREENS}")
    cpu = None if same_graph else digest(hype_device_partition(
        hg, 32, qp, device="cpu"))
    check_path(row, PATH_DIGESTS["quality"], PATH_KM1["quality"], cpu,
               counts, {"hype_score_select": st.graph_replays
                        + st.graph_captures, "kway_gains_csr": screens})
    _, srow = run_slice(hg, 1, "cuda", metrics, SuperstepParams,
                        hype_superstep_partition)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a, st = hype_device_partition(hg, 32, dp, return_stats=True,
                                  device="cuda")
    drow = device_row("device", hg, a, st, time.perf_counter() - t0)
    if drow["digest"] != srow["digest"]:
        raise SystemExit(f"hype_device and the slice differ: {drow}")
    emit({"phase": "device_turns", "turns": [{
        "slice": {key: srow[key] for key in ("wall_s", "host_s",
                                             "device_s")},
        "device": {key: drow[key] for key in (
            "wall_s", "host_s", "device_s", "host_share",
            "graph_captures", "graph_replays", "graph_nodes",
            "graph_capture_s", "loop_chunks", "loop_rounds")}}]})


def snapshot_root(name):
    """A fresh snapshot directory for one run, under the checkout's
    gitignored build/ (nothing is written outside the checkout)."""
    import shutil
    root = pathlib.Path(__file__).resolve().parent
    d = root / "build" / "snapshots" / name
    shutil.rmtree(d, ignore_errors=True)
    return str(d)


def snapshot_bytes(d):
    """Bytes of one snapshot file in ``d`` (the newest)."""
    files = sorted(pathlib.Path(d).glob("snap_*.ckpt"))
    return files[-1].stat().st_size if files else 0


def resilience_row(label, hg, a, st, wall, snap_dir=None):
    """A resilient run's row: the path's metrics, its time split, the
    fault and snapshot counters, and its CUDA graph where it has one."""
    row = path_row(f"resilience_{label}", hg, a, 32, wall)
    row.update({key: getattr(st, key) for key in (
        "supersteps", "host_s", "device_s", "snapshots", "snapshot_s",
        "restore_s", "resumed_at", "faults_injected", "retries",
        "fallbacks", "graph_captures", "graph_replays", "graph_nodes",
        "graph_off_rounds", "kernel_calls", "host_rows")})
    if snap_dir is not None:
        row["snapshot_bytes"] = snapshot_bytes(snap_dir)
    return row


def phase_resilience(hg, same_graph, launches, metrics, res, DeviceParams,
                     hype_device_partition, SuperstepParams,
                     hype_superstep_partition, BatchedParams,
                     hype_batched_partition, partition_resilient,
                     batched_host_rows):
    """Snapshots, resume, fault plans and the degradation ladder on the
    card, github_like(1.0), k=32, t=16. hype_device clean, snapshotting
    every 64 supersteps, killed by a fatal fault at 200 and resumed, and
    with a transient dispatch fault and a NaN tile: each on the depth-1
    digest; the same kill and resume on hype_superstep at depth 1 (the
    digest) and depth 2 (the uninterrupted run with the same cadence);
    hype_batched with a NaN tile in the middle (the batched digest, the
    tile's rows rescored on the host); partition_resilient from
    hype_device killed at 100, finishing on hype_superstep from the
    snapshot at 64, held to the JAX package's ladder."""
    want = SLICE_DIGESTS[1] if same_graph else None
    rows = {}

    def check(row, want_digest, counts, need):
        """Emit the row; fail on another digest than ``want_digest`` (when
        known) or a launch count other than ``need``."""
        row["launches"] = counts
        row["expected_launches"] = need
        row["expected_digest"] = want_digest
        emit(row)
        if want_digest is not None and row["digest"] != want_digest:
            raise SystemExit(f"{row['phase']} digest differs: {row}")
        for name, n in need.items():
            got = counts[name]
            if got == 0 or got != n:
                raise SystemExit(f"{row['phase']} launched {name} {got} "
                                 f"times; expected {n}")
        rows[row["phase"]] = row

    def dev(**kw):
        return lambda: hype_device_partition(
            hg, 32, DeviceParams(seed=0, t=16, **kw), return_stats=True,
            device="cuda")

    # hype_device: clean, then snapshotting, killed and resumed
    (a, st), wall, counts = launches.drive(dev(fault_plan=res.FaultPlan()))
    clean = resilience_row("device_clean", hg, a, st, wall)
    check(clean, want, counts,
          {"hype_score_select": st.graph_replays + st.graph_captures})
    if (st.graph_off_rounds
            or abs(st.graph_nodes - DEVICE_GRAPH_NODES)
            > 0.02 * DEVICE_GRAPH_NODES
            or st.graph_replays < st.supersteps):
        raise SystemExit(f"a clean hype_device left its graph: {clean}")
    want = want or clean["digest"]
    d = snapshot_root("device_full")
    (a, st), wall, counts = launches.drive(dev(
        snapshot_every=64, snapshot_dir=d, keep_last=100,
        fault_plan=res.FaultPlan()))
    row = resilience_row("device_snapshotting", hg, a, st, wall, d)
    check(row, want, counts,
          {"hype_score_select": st.graph_replays + st.graph_captures})
    if st.snapshots != st.supersteps // 64:
        raise SystemExit(f"hype_device published {st.snapshots} snapshots")
    d = snapshot_root("device_killed")
    t0 = time.perf_counter()
    try:
        dev(snapshot_every=64, snapshot_dir=d,
            fault_plan="dispatch@200:fatal")()
        raise SystemExit("hype_device survived a fatal fault")
    except res.UnrecoverableFault as exc:
        emit({"phase": "resilience_device_killed", "error": str(exc),
              "wall_s": time.perf_counter() - t0,
              "snapshot_bytes": snapshot_bytes(d)})
    (a, st), wall, counts = launches.drive(dev(
        snapshot_every=64, snapshot_dir=d, resume=d,
        fault_plan=res.FaultPlan()))
    row = resilience_row("device_resumed", hg, a, st, wall, d)
    check(row, want, counts,
          {"hype_score_select": st.graph_replays + st.graph_captures})
    if st.resumed_at != 192:
        raise SystemExit(f"hype_device resumed at {st.resumed_at}")
    (a, st), wall, counts = launches.drive(dev(
        fault_plan="dispatch@50;nan@120"))
    row = resilience_row("device_faults", hg, a, st, wall)
    # the poisoned round and those before it in its chunk run off the
    # graph; its replay launches score + select once more
    check(row, want, counts, {"hype_score_select": st.graph_replays
                              + st.graph_captures + st.graph_off_rounds
                              + 1})
    if ((st.faults_injected, st.retries) != (2, 2)
            or not st.graph_off_rounds):
        raise SystemExit(f"hype_device fault counters: {row}")

    # hype_superstep at depth 1 and 2: kill at 200, resume
    def ss(depth, **kw):
        return lambda: hype_superstep_partition(
            hg, 32, SuperstepParams(seed=0, t=16, pipeline_depth=depth,
                                    snapshot_every=64, **kw),
            return_stats=True, device="cuda")

    for depth in (1, 2):
        base = None
        if depth == 2:
            d = snapshot_root("superstep_d2_full")
            (a, st), wall, counts = launches.drive(ss(
                2, snapshot_dir=d, fault_plan=res.FaultPlan()))
            row = resilience_row("superstep_d2_full", hg, a, st, wall, d)
            check(row, PATH_DIGESTS["pd2_cadence64"] if same_graph
                  else None, counts, {"hype_score_select": st.supersteps})
            base = row["digest"]
        d = snapshot_root(f"superstep_d{depth}")
        try:
            ss(depth, snapshot_dir=d, fault_plan="dispatch@200:fatal")()
            raise SystemExit("hype_superstep survived a fatal fault")
        except res.UnrecoverableFault:
            pass
        (a, st), wall, counts = launches.drive(ss(
            depth, snapshot_dir=d, resume=d, fault_plan=res.FaultPlan()))
        row = resilience_row(f"superstep_d{depth}_resumed", hg, a, st, wall,
                             d)
        check(row, want if depth == 1 else base, counts,
              {"hype_score_select": st.supersteps - st.resumed_at})
        if st.resumed_at != 192:
            raise SystemExit(f"hype_superstep resumed at {st.resumed_at}")

    # hype_batched: a NaN tile in the middle, rescored on the host
    (a, st), wall, counts = launches.drive(
        lambda: hype_batched_partition(
            hg, 32, BatchedParams(seed=0, t=16, fault_plan="nan@3000"),
            return_stats=True, device="cuda"))
    row = resilience_row("batched_nan", hg, a, st, wall)
    row["tile_rows"] = st.host_rows - batched_host_rows
    check(row, PATH_DIGESTS["batched"] if same_graph else None, counts,
          {"hype_scores": st.kernel_calls})
    if st.faults_injected != 1 or not 0 < row["tile_rows"] <= 256:
        raise SystemExit(f"hype_batched quarantined nothing: {row}")

    # the ladder's first rung alone, killed as the ladder kills it: its
    # launches before it dies (replays, and a warm-up round a capture)
    def device_rung():
        try:
            dev(snapshot_every=64, snapshot_dir=snapshot_root("ladder_rung"),
                fault_plan="dispatch@100:fatal")()
        except res.UnrecoverableFault:
            return
        raise SystemExit("hype_device survived a fatal fault")

    _, _, rung_counts = launches.drive(device_rung)
    # the ladder: hype_device killed at 100 -> hype_superstep from 64
    d = snapshot_root("ladder")
    (a, rep), wall, counts = launches.drive(lambda: partition_resilient(
        hg, 32, "hype_device", device="cuda", seed=0, t=16,
        snapshot_dir=d, snapshot_every=64, fault_plan="dispatch@100:fatal"))
    st = rep["stats"]
    row = resilience_row("ladder", hg, a, st, wall, d)
    row.update(method=rep["method"], degraded_from=rep["degraded_from"],
               k_minus_1_report=rep["k_minus_1"])
    # the superstep rung's supersteps (a warm start counts from 0), plus
    # the hype_device rung's launches before it died
    row["device_rung_launches"] = rung_counts
    check(row, LADDER_DIGEST if same_graph else digest(partition_resilient(
        hg, 32, "hype_device", device="cpu", seed=0, t=16,
        snapshot_dir=snapshot_root("ladder_cpu"), snapshot_every=64,
        fault_plan="dispatch@100:fatal")[0]), counts,
        {"hype_score_select": st.supersteps
         + rung_counts["hype_score_select"]})
    if (rep["method"] != "hype_superstep" or rep["fallbacks"] != 1
            or st.fallbacks != 1 or st.resumed_at < 64):
        raise SystemExit(f"the ladder did not land as expected: {row}")
    return rows


def phase_report(hg, same_graph, launches, partition_and_report):
    """partition_and_report on the slice's graph at k=32: the five host
    baselines and hype_device, each report equal to the JAX package's key
    for key (runtime_s aside)."""
    import numpy as np
    rows = {}
    for method, kw in (("minmax_nb", {}), ("minmax_eb", {}), ("shp", {}),
                       ("random", {}), ("hashing", {}),
                       ("hype_device", {"t": 16})):
        (rep, a), wall, counts = launches.drive(
            lambda: partition_and_report(hg, 32, method, device="cuda",
                                         seed=0, **kw))
        row = {"phase": f"report_{method}", "wall_s": wall,
               "digest": digest(a), "report": rep, "launches": counts}
        want = REPORTS.get(method) if same_graph else None
        row["expected"] = want
        emit(row)
        if want is not None:
            got = {k: v for k, v in rep.items() if k != "runtime_s"}
            if got != want["report"] or row["digest"] != want["digest"]:
                raise SystemExit(f"{row['phase']} differs from JAX: {row}")
        sizes = np.bincount(a, minlength=32)
        if (a < 0).any() or (method == "hype_device"
                             and sizes.max() - sizes.min() > 1):
            raise SystemExit(f"{row['phase']} assignment is not complete")
        if method == "hype_device" and counts["hype_score_select"] == 0:
            raise SystemExit("the report's hype_device launched nothing")
        rows[method] = row
    return rows


# mem_budget (bytes) -> the memory rung hype_superstep plans on the slice's
# graph (k=32, t=16, rows 16, pool_cap 64, depth 2: rung 0 plans
# 65,114,592 bytes, 55,232,524 of them the CSR image); None = the card's
# free memory, which rung 0 fits
MEM_BUDGETS = (None, 62_000_000, 59_000_000, 57_500_000, 57_100_000,
               32_000_000)
# the JAX package's run_pipeline(..., mem_rung=r) of the slice's config,
# computed with the JAX package on the CPU: rung 2 (tile_l 512, depth 2)
# and rung 3 (tile_l 512, depth 1); rungs 4 and 5 are bit-exact to rung 3
MEM_RUNG_DIGESTS = {2: "b375f828d4fc1261", 3: "11af1dd01f862a04"}
# card memory a recovered run may keep: a new stream's score + select
# ticket counters (4 KiB each)
MEM_SLACK = 1 << 20
# and JAX's plans there: each rung's planned bytes, and the pager's
# (uploads, hits, evictions, bytes) at rung 5 (host logic: equal exactly)
MEM_PLANNED = (65_114_592, 60_920_288, 57_774_560, 57_213_152, 57_027_896,
               32_000_000)
MEM_PAGED_COUNTERS = (5657, 2919, 5646, 14_269_714_616)


def mem_row(label, hg, a, st, wall, counts, need):
    """A memory-budgeted run's row: the path's metrics, its plan, the
    planned and observed peak bytes, retries, fallbacks, the pager's
    counters and the time split; fails on a launch count other than
    ``need`` (kernel name -> count)."""
    row = path_row(f"membudget_{label}", hg, a, 32, wall)
    row.update({key: getattr(st, key) for key in (
        "plan_rung", "peak_bytes_planned", "peak_bytes_observed",
        "mem_retries", "fallbacks", "faults_injected", "page_uploads",
        "page_hits", "page_evictions", "page_bytes", "supersteps",
        "tile_l", "host_s", "device_s")})
    row["launches"] = counts
    row["expected_launches"] = need
    for name, n in need.items():
        if counts[name] == 0 or counts[name] != n:
            emit(row)
            raise SystemExit(f"{row['phase']} launched {name} "
                             f"{counts[name]} times; expected {n}")
    return row


def phase_membudget(hg, same_graph, launches, SuperstepParams,
                    hype_superstep_partition, run_pipeline, DeviceParams,
                    hype_device_partition):
    """The memory rungs on the card, github_like(1.0), k=32, t=16.
    hype_superstep at the six budgets of MEM_BUDGETS reaches rungs 0-5 by
    its plan alone (no OOM, no retry, no fallback): rungs 0-1 on the
    depth-2 slice's digest, rung 2 on JAX's rung-2 digest, rungs 3-5 on
    JAX's rung-3 digest, each superstep launching score + select once a
    phase chunk (twice on rungs 1-3). Then an injected oom at the upload
    and a real allocator failure (a 1 TiB torch.empty) at the image upload
    of a fresh copy of the graph: one retry each, rung 1, the depth-2
    digest, the card's memory back at its level but for the fresh copy's
    CSR image. Then hype_device with oom@2 and oom@70 (in the first and
    the second chunk): down the host pipeline's rungs from rung 1 at depth
    1, warm-started from the seeds (no snapshot in between), complete,
    balanced, fallbacks 1, on the depth-1 digest, the card's memory
    released. Last, a clean hype_device on the depth-1 digest."""
    import gc
    import torch
    rows = {}

    def expect(rung):
        """JAX's digest at ``rung`` (or, on another graph, the port's own
        CPU run there: rungs 4 and 5 are bit-exact to rung 3)."""
        if same_graph:
            return (SLICE_DIGESTS[2] if rung <= 1
                    else MEM_RUNG_DIGESTS[min(rung, 3)])
        a, _ = run_pipeline(hg, 32, SuperstepParams(seed=0, t=16, rows=16),
                            device="cpu", mem_rung=min(rung, 3))
        return digest(a)

    def check(row, want):
        row["expected_digest"] = want
        emit(row)
        if row["digest"] != want:
            raise SystemExit(f"{row['phase']} digest differs: {row}")
        rows[row["phase"]] = row

    for rung, budget in enumerate(MEM_BUDGETS):
        (a, st), wall, counts = launches.drive(
            lambda: hype_superstep_partition(
                hg, 32, SuperstepParams(seed=0, t=16, mem_budget=budget),
                return_stats=True, device="cuda"))
        g_chunk = 2 if 1 <= rung <= 3 else 1
        row = mem_row(f"rung{rung}", hg, a, st, wall, counts,
                      {"hype_score_select": g_chunk * st.supersteps})
        row["mem_budget"] = budget
        if (st.plan_rung, st.mem_retries, st.fallbacks) != (rung, 0, 0):
            emit(row)
            raise SystemExit(f"budget {budget} did not plan rung {rung}: "
                             f"{row}")
        pages = (st.page_uploads, st.page_hits, st.page_evictions,
                 st.page_bytes)
        row["expected_peak_bytes_planned"] = MEM_PLANNED[rung]
        if same_graph and (
                st.peak_bytes_planned != MEM_PLANNED[rung]
                or pages != (MEM_PAGED_COUNTERS if rung == 5 else (0,) * 4)):
            emit(row)
            raise SystemExit(f"rung {rung}'s plan or pager differs from "
                             f"JAX's: {row}")
        if rung == 5 and not st.page_uploads:
            raise SystemExit(f"the paged rung paged nothing: {row}")
        check(row, expect(rung))

    # an injected oom at the upload: one retry, rung 1
    (a, st), wall, counts = launches.drive(
        lambda: hype_superstep_partition(
            hg, 32, SuperstepParams(seed=0, t=16, fault_plan="oom"),
            return_stats=True, device="cuda"))
    row = mem_row("injected_oom", hg, a, st, wall, counts,
                  {"hype_score_select": 2 * st.supersteps})
    if (st.plan_rung, st.mem_retries, st.fallbacks) != (1, 1, 0):
        raise SystemExit(f"the injected oom did not retry at rung 1: {row}")
    check(row, expect(1))

    # a real allocator failure at the image upload of a fresh copy of the
    # graph (no CSR image memoized on it; the host adjacency shared)
    fresh = dataclasses.replace(hg)
    object.__setattr__(fresh, "_adj_cache", dict(hg.__dict__["_adj_cache"]))
    cls = type(hg)
    real = cls.device_adjacency
    tried = []

    def failing_once(self, *args, **kw):
        if not tried:
            tried.append(True)
            torch.empty(1 << 40, dtype=torch.uint8, device="cuda")
        return real(self, *args, **kw)

    gc.collect()
    before = torch.cuda.memory_allocated()
    cls.device_adjacency = failing_once
    try:
        (a, st), wall, counts = launches.drive(
            lambda: hype_superstep_partition(
                fresh, 32, SuperstepParams(seed=0, t=16), return_stats=True,
                device="cuda"))
    finally:
        cls.device_adjacency = real
    gc.collect()
    after = torch.cuda.memory_allocated()
    image = sum(t.nbytes for t in fresh.device_adjacency("cuda"))
    row = mem_row("real_oom", fresh, a, st, wall, counts,
                  {"hype_score_select": 2 * st.supersteps})
    row.update(allocated_before=before, allocated_after=after,
               csr_image_bytes=image)
    if (st.plan_rung, st.mem_retries, st.fallbacks) != (1, 1, 0):
        raise SystemExit(f"the real OOM did not retry at rung 1: {row}")
    # slack: the kernel's ticket counters of a stream not seen before
    if after - before > image + MEM_SLACK:
        raise SystemExit(f"the recovered run kept card memory: {row}")
    check(row, expect(1))
    del fresh

    # hype_device: an oom in the first chunk and one in the second
    device_digests = []
    for plan in ("oom@2", "oom@70"):
        gc.collect()
        before = torch.cuda.memory_allocated()
        (a, st), wall, counts = launches.drive(
            lambda: hype_device_partition(
                hg, 32, DeviceParams(seed=0, t=16, fault_plan=plan),
                return_stats=True, device="cuda"))
        gc.collect()
        after = torch.cuda.memory_allocated()
        # two launches a superstep at rung 1, after the loop's: its
        # warm-up round (oom@2 fires before the first chunk), or that and
        # the first chunk's replays (64 supersteps and its pack-only rounds)
        row = mem_row(f"device_{plan}", hg, a, st, wall, counts, {})
        loop = counts["hype_score_select"] - 2 * st.supersteps
        row.update(loop_launches=loop, allocated_before=before,
                   allocated_after=after)
        emit(row)
        if (loop != 1 if plan == "oom@2" else not 65 <= loop <= 80):
            raise SystemExit(f"hype_device launched score + select {loop} "
                             f"times before its fallback: {row}")
        if (st.plan_rung, st.mem_retries, st.fallbacks) != (1, 1, 1):
            raise SystemExit(f"hype_device did not fall down the rungs: "
                             f"{row}")
        if after - before > MEM_SLACK:
            raise SystemExit(f"hype_device's fallback kept card memory: "
                             f"{row}")
        device_digests.append(row["digest"])
        rows[row["phase"]] = row
    # the rung-1 pipeline at depth 1 from the seeds draws its restarts
    # past them as a fresh run does: the depth-1 digest
    want = SLICE_DIGESTS[1] if same_graph else device_digests[0]
    if device_digests != [want, want]:
        raise SystemExit(f"hype_device's fallbacks landed on "
                         f"{device_digests}, not {want}")

    # a clean hype_device after the fallbacks: the depth-1 digest
    (a, st), wall, counts = launches.drive(lambda: hype_device_partition(
        hg, 32, DeviceParams(seed=0, t=16), return_stats=True,
        device="cuda"))
    row = device_row("membudget_device_clean", hg, a, st, wall)
    cpu = None if same_graph else digest(run_pipeline(
        hg, 32, SuperstepParams(seed=0, t=16, rows=16, pipeline_depth=1),
        device="cpu")[0])
    check_path(row, SLICE_DIGESTS[1], SLICE_KM1[1], cpu, counts,
               {"hype_score_select": st.graph_replays + st.graph_captures})
    return rows


# the stream phase: hype_stream_partition(github_like(1.0, seed=0), 32,
# StreamParams(seed=0)) in the JAX package on the CPU, recomputed by
# tests/jax_stream_digests.py: the clean pass (plan (64, 2048), 2,772
# micro-batches), the pass at mem_budget=20_000_000 (plan (32, 2048),
# 5,544 micro-batches) and apply_updates of stream_ops(state, seed=0) on
# the clean pass's state
STREAM_DIGEST = "ba0ebd12c7d73a12"
STREAM_KM1 = 75023
STREAM_BATCHES = 2772
STREAM_PLANNED = 26_225_024
STREAM_BUDGET = 20_000_000
STREAM_BUDGET_PLAN = (32, 2048, 17_307_904, 5544)
STREAM_BUDGET_DIGEST = "5d28ea9a479d7669"
STREAM_SKETCH_DIGEST = "5a736b1b950e1c03"
STREAM_OPS = 64
# the kill-and-resume drill: snapshots every 512 micro-batches, a fatal
# dispatch fault at 1,500, so the resume continues at 1,024
STREAM_SNAPSHOT_EVERY = 512
STREAM_KILL_AT = 1500
STREAM_UPDATE_DIGEST = "40f2df87d63b41b7"
# and that call's counters: (inserts, deletes, readmitted, refine_moves,
# rebalance_moves)
STREAM_UPDATE_COUNTERS = (42, 22, 28, 49, 0)


def stream_ops(state, seed: int = 0, n_ops: int = STREAM_OPS):
    """A seeded log of mixed stream ops against ``state``, in the form of
    the JAX package's incremental tests: remove a live vertex, remove a
    non-empty edge, add an edge over 2-5 live vertices, add a vertex
    joining 1-3 live edges. Ids are drawn from what the log has left alive
    so far, as a caller would; ``state`` is read, not changed."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n, m = state.hg.n, state.hg.m
    alive_v = set(np.flatnonzero(state.assignment >= 0).tolist())
    alive_e = set(np.flatnonzero(np.diff(state.hg.e2v_indptr) > 0).tolist())
    ops = []
    for _ in range(n_ops):
        kind = rng.integers(0, 4)
        if kind == 0 and len(alive_v) > state.k * 2:
            v = int(rng.choice(sorted(alive_v)))
            ops.append(("remove_vertex", v))
            alive_v.discard(v)
        elif kind == 1 and len(alive_e) > 2:
            e = int(rng.choice(sorted(alive_e)))
            ops.append(("remove_edge", e))
            alive_e.discard(e)
        elif kind == 2 and len(alive_v) >= 2:
            pins = rng.choice(sorted(alive_v), size=int(rng.integers(2, 6)),
                              replace=False)
            ops.append(("add_edge", [int(x) for x in pins]))
            alive_e.add(m)
            m += 1
        elif alive_e:
            es = rng.choice(sorted(alive_e),
                            size=min(int(rng.integers(1, 4)), len(alive_e)),
                            replace=False)
            ops.append(("add_vertex", [int(x) for x in es]))
            alive_v.add(n)
            n += 1
    return ops


def commit_inputs(seed, k, mb, le, bits=16, kind="random"):
    """Seeded stream_commit inputs on the card (numpy-made): pads anywhere
    in a row, a pad row at the end, sketch entries in about 30% of the
    buckets; ``kind`` forces ties (no fringe or balance term, an empty
    sketch), partitions at their cap (all but the last, or all), all-pad
    rows, duplicate buckets (16 buckets), the stream's own rows (1-3
    leading pins, about 30% of the valid rows with none: ``path``), rows
    that repeat the ids of the rows before them over an empty sketch
    (``chain``), valid rows with no pin (``nopins``), every slot a pin
    (``wide``) or sketch entries below 0 (``negative``). Past 16 bits the
    sketch holds entries only in the tile's buckets. Returns the five
    tensors and the scalar knobs."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    if kind == "dup":
        bits = 4
    edge = rng.integers(0, 200_000, size=(mb, le)).astype(np.int32)
    if kind != "wide":
        edge[rng.random((mb, le)) < 0.3] = -1
    if kind in ("path", "chain", "nopins"):
        edge[:] = -1
        pool = rng.integers(0, 200_000, size=6)
        for i in range(mb if kind != "nopins" else 0):
            n = int(rng.integers(1, min(3, le) + 1))
            if kind == "chain":
                edge[i, :n] = rng.choice(pool, size=n)
            elif rng.random() >= 0.3:
                edge[i, :n] = rng.integers(0, 200_000, size=n)
    fcnt = rng.integers(0, 5, size=(mb, k)).astype(np.float32)
    if bits <= 16:
        sketch = (rng.integers(1, 3, size=(k, 1 << bits))
                  * (rng.random((k, 1 << bits)) < 0.3)).astype(np.int32)
    else:
        sketch = np.zeros((k, 1 << bits), np.int32)
        ids = edge[edge >= 0].astype(np.uint32)
        b = (ids * np.uint32(2654435761)) >> np.uint32(32 - bits)
        hit = rng.random((k, b.size)) < 0.3
        sketch[np.nonzero(hit)[0], b[np.nonzero(hit)[1]]] = 1
    if kind == "negative":
        sketch[rng.random(sketch.shape) < 0.2] = -1
    cap = 5 * mb + 3
    sizes = rng.integers(0, cap, size=k).astype(np.int32)
    valid = np.ones(mb, bool)
    valid[-1] = mb == 1 or kind == "nopins"
    alpha, fw = 1.0, 0.5
    if kind in ("ties", "chain"):
        sketch[:] = 0
    if kind == "ties":
        alpha, fw = 0.0, 0.0
    elif kind == "cap":
        sizes[:-1] = cap
    elif kind == "full":
        sizes[:] = cap
    elif kind == "pad":
        edge[:] = -1
        valid[:] = False
    x = [torch.from_numpy(a).cuda() for a in (edge, fcnt, valid, sketch,
                                               sizes)]
    return x, dict(alpha=alpha, fringe_w=fw, inv_target=float(
        np.float32(k / 177_386)), cap=cap, sketch_bits=bits)


# stream_commit.cu's branches, by the code its launcher reports
COMMIT_BRANCHES = ("row chain", "staged", "staged, handed to the row chain")


def commit_branch(ext, x):
    """The branch of stream_commit.cu a launch on ``x`` takes, by the
    launcher's own rule (the shape and the valid rows' pins); None where
    the tree's extension predates the branches."""
    if not hasattr(ext, "stream_commit_branch"):
        return None
    edge, _, valid, sketch, _ = x
    pins = int(((edge >= 0) & valid[:, None]).sum())
    return COMMIT_BRANCHES[ext.stream_commit_branch(
        *edge.shape, sketch.shape[0], pins)]


def commit_bytes(x, kw) -> int:
    """The bytes stream_commit must move on ``x``: the tile, fcnt and the
    row mask read once, the parts written once, the sizes read and
    written, and per row k sketch entries read for each valid pin and one
    written for each valid pin of a valid row."""
    edge, fcnt, valid, sketch, sizes = x
    pins = (edge >= 0).sum(1)
    k = sketch.shape[0]
    entries = int(pins.sum()) * k + int(pins[valid].sum())
    return (edge.nbytes + fcnt.nbytes + valid.nbytes + 4 * edge.shape[0]
            + 2 * sizes.nbytes + 4 * entries)


def check_commit(ops, ref, ext, x, kw, row, branch=None):
    """stream_commit on clones of ``x`` against its plain version on
    other clones: parts, sketch and sizes bit for bit, one launch
    counted, and the branch taken (``branch``, where given, must be it).
    Emits ``row`` with the verdict; raises when they differ."""
    import torch
    got = [t.clone() for t in x]
    before = ops.stream_commit.launches
    parts = ops.stream_commit(*got, **kw)
    torch.cuda.synchronize()
    counted = ops.stream_commit.launches - before
    want = [t.clone() for t in x]
    want_parts = ref.stream_commit_ref(*want, **kw)
    equal = (torch.equal(parts, want_parts) and torch.equal(got[3], want[3])
             and torch.equal(got[4], want[4]))
    err = max_abs_err([parts, got[3], got[4]],
                      [want_parts, want[3], want[4]])
    row.update(equal=equal, max_abs_err=err, launches=counted,
               branch=commit_branch(ext, x))
    emit(row)
    if not equal or counted != 1 or (branch is not None
                                     and row["branch"] != branch):
        raise SystemExit(f"stream_commit disagrees with its plain version, "
                         f"or its launch count or branch: {row}")
    return err


def commit_ms(ops, x, kw, n=50, reps=5):
    """stream_commit's device time a launch on ``x``, in a CUDA graph and
    eagerly: ``n`` launches back to back, each on its own copy of the
    sketch and sizes, restored before every timed run, so that each
    launch commits into the state the inputs hold (a launch repeated on
    one copy would drift its sizes to the cap). Returns (graph_ms, ms),
    medians of ``reps`` runs."""
    import torch
    edge, fcnt, valid, sketch, sizes = x
    sk = [sketch.clone() for _ in range(n)]
    sz = [sizes.clone() for _ in range(n)]

    def run():
        for j in range(n):
            ops.stream_commit(edge, fcnt, valid, sk[j], sz[j], **kw)

    def timed(launch):
        out = []
        for _ in range(reps):
            for a, b in zip(sk + sz, [sketch] * n + [sizes] * n):
                a.copy_(b)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            launch()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end) / n)
        return statistics.median(out)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    return timed(graph.replay), timed(run)


def commit_timings(ops, ref, ext, mid, by_width):
    """stream_commit timed on the stream's micro-batches (k=32, mb=64, 16
    bits) by ``commit_ms`` (each launch on the state its inputs hold):
    ``mid`` (a micro-batch's arguments) widened to Le=2,048 in a CUDA
    graph and eagerly, beside its plain version and its bytes bound; the
    all-pad chain and 64 valid rows with no pin at Le=2,048; a dense tile
    (90,221 pins); each of ``by_width`` (Le -> (ordinal, arguments), the
    pass's first micro-batch of that width); and the first 1, 16 and 64
    rows of ``mid`` at its own width, whose difference is the per-row
    slope. Each with the branch it takes."""
    import torch

    def timed(x, kw):
        graph, eager = commit_ms(ops, x, kw)
        return {"pins": int(((x[0] >= 0) & x[2][:, None]).sum()),
                "bound_ms": commit_bytes(x, kw) / HBM_BYTES_PER_S * 1e3,
                "branch": commit_branch(ext, x), "graph_ms": graph,
                "ms": eager}

    args, kw = mid
    edge = torch.full((64, 2048), -1, dtype=torch.int32, device="cuda")
    edge[:, :args[0].shape[1]] = args[0]
    x = [edge] + list(args[1:])
    nbytes = commit_bytes(x, kw)
    row = {"k": 32, "mb": 64, "Le": 2048, "bytes": nbytes,
           "bound_by": "bytes", **timed(x, kw),
           "plain_ms": cuda_ms(lambda: ref.stream_commit_ref(
               *[t.clone() for t in x], **kw), reps=3, iters=5, warmup=1),
           "library_ms": None}
    pad, pkw = commit_inputs(0, 32, 64, 2048, kind="pad")
    chain = timed(pad, pkw)
    row.update(row_chain_ms=chain["graph_ms"], row_chain_branch=chain["branch"])
    nopin, nkw = commit_inputs(0, 32, 64, 2048, kind="nopins")
    chain = timed(nopin, nkw)
    row.update(nopin_chain_ms=chain["graph_ms"],
               nopin_chain_branch=chain["branch"])
    dense, dkw = commit_inputs(1, 32, 64, 2048)
    row["dense"] = timed(dense, dkw)
    row["pass_widths"] = {
        str(le): {"ordinal": ordinal, "Le": le, **timed(a, akw)}
        for le, (ordinal, (a, akw)) in sorted(by_width.items())}
    slope = {str(mb): timed([t[:mb].contiguous() for t in args[:3]]
                            + list(args[3:]), kw)["graph_ms"]
             for mb in (1, 16, 64)}
    row["rows_graph_ms"] = slope
    row["per_row_us"] = (slope["64"] - slope["1"]) / 63 * 1e3
    row["rows_Le"] = int(args[0].shape[1])
    return row


class CaptureCommits:
    """Within the block, keep clones of the stream_commit arguments that
    ``scoring`` passes at the given call ordinals (the sketch and sizes
    as they are before the call), in ``args``, and those of the first
    call at each edge-tile width of ``widths``, in ``by_width`` (width ->
    (ordinal, arguments))."""

    def __init__(self, scoring, at, widths=()):
        self.scoring, self.at, self.calls, self.args = scoring, at, 0, []
        self.widths, self.by_width = widths, {}

    def __enter__(self):
        real = self.real = self.scoring.stream_commit

        def spy(*args, **kw):
            le = args[0].shape[1]
            keep = self.calls in self.at
            first = le in self.widths and le not in self.by_width
            if keep or first:
                kept = ([t.clone() for t in args], dict(kw))
                if keep:
                    self.args.append(kept)
                if first:
                    self.by_width[le] = (self.calls, kept)
            self.calls += 1
            return real(*args, **kw)

        self.scoring.stream_commit = spy
        return self

    def __exit__(self, *exc):
        self.scoring.stream_commit = self.real


def stream_run_row(phase, hg, a, state, wall, counts, need, k=32):
    """A stream run's row: k-1, sizes, digest, plan, counters and
    launches. Fails on an incomplete assignment, a size gap above k or a
    launch count other than ``need`` (kernel name -> count)."""
    from repro_torch.core import metrics
    st = state.stats
    sizes = metrics.partition_sizes(a, k)
    row = {"phase": phase, "wall_s": wall,
           "k_minus_1": metrics.k_minus_1(hg, a, k),
           "sizes": [int(sizes.min()), int(sizes.max())],
           "digest": digest(a), "launches": counts,
           "expected_launches": need}
    row.update({key: getattr(st, key) for key in (
        "micro_batches", "plan_micro_batch", "plan_tile_l", "planned_bytes",
        "host_to_device_bytes", "stream_s", "vertices_per_s",
        "faults_injected", "retries", "snapshots", "snapshot_s",
        "restore_s", "resumed_at")})
    if (a < 0).any() or sizes.max() - sizes.min() > k:
        emit(row)
        raise SystemExit(f"{phase} assignment is incomplete or its sizes "
                         f"differ by more than k: {row}")
    for name, n in need.items():
        if counts[name] == 0 or counts[name] != n:
            emit(row)
            raise SystemExit(f"{phase} launched {name} {counts[name]} "
                             f"times; expected {n}")
    return row


def phase_stream(hg, same_graph, launches, ops, ref, scoring, hs, res):
    """hype_stream on the card, github_like(1.0), k=32, StreamParams(seed=0).

    The path first: one micro-batch step a row 1 and a stream_commit
    launch, JAX's digest and k-1, sizes within k, the sketch equal to its
    recount, JAX's plan and planned bytes, the observed peak beside them
    (the commit arguments of three micro-batches and of the first of each
    tile width kept on the way). Then the kernel: stream_commit against
    its plain version over k in {1, 2, 32, 67, 300}, every L bucket and mb
    in {1, 7, 64}, forced ties, partitions at their cap, all-pad rows,
    duplicate buckets, the stream's kinds of rows (path, chain, nopins) at
    k in {32, 33, 64, 65} and Le in {32, 2048}, the row chain's
    hand-overs (wide, negative, k past 256), 24 bits at k <= 8 and the
    kept real micro-batches, bit for bit, one launch counted a call and
    the branch the launcher reports; timed by ``commit_timings``; row 1
    timed at the stream's shape (G=32,
    R=64, L=2048, s=16, P=1). Then the budget (mem_budget=20e6: plan (32,
    2048), JAX's digest), a run snapshotting every 512 micro-batches killed
    by a fatal dispatch fault at 1,500 and resumed at 1,024, a retried
    dispatch fault at 3, and apply_updates of a 64-op log on the path's
    state. Returns the kernel's timed row and its worst error."""
    import numpy as np
    import torch
    p = hs.StreamParams(seed=0)
    cpu_state = None
    if not same_graph:
        _, cpu_state = hs.hype_stream_partition(hg, 32, p, return_state=True,
                                                device="cpu")

    def want(pinned, cpu_run):
        return pinned if same_graph else cpu_run()

    clean = want(STREAM_DIGEST, lambda: digest(cpu_state.assignment))

    # 1. the path
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    total = -(-hg.n // p.micro_batch)
    at = (1, total // 2, total - 1)
    with CaptureCommits(scoring, at, widths=(32, 128, 512)) as kept:
        (a, state), wall, counts = launches.drive(
            lambda: hs.hype_stream_partition(hg, 32, p, return_state=True,
                                             device="cuda"))
    peak = torch.cuda.max_memory_allocated()
    n_batches = state.stats.micro_batches
    row = stream_run_row("stream", hg, a, state, wall, counts, {
        "hype_score_select": n_batches, "stream_commit": n_batches})
    sk, sz = hs.recompute_sketch(hg, a, 32, p.sketch_bits)
    row.update(expected_digest=clean, allocated_before=before,
               peak_bytes_observed=peak, peak_over_before=peak - before,
               sketch_digest=state.sketch_digest(),
               sketch_equals_recount=bool((sk == state.sketch).all()
                                          and (sz == state.sizes).all()))
    emit(row)
    plan = (state.stats.plan_micro_batch, state.stats.plan_tile_l,
            state.stats.planned_bytes)
    if (row["digest"] != clean or not row["sketch_equals_recount"]
            or (same_graph and (row["k_minus_1"] != STREAM_KM1
                                or n_batches != STREAM_BATCHES
                                or plan != (64, 2048, STREAM_PLANNED)
                                or row["sketch_digest"]
                                != STREAM_SKETCH_DIGEST))):
        raise SystemExit(f"the stream differs from JAX's: {row}")

    # 2. the kernel
    from repro_torch.kernels._build import load_extension
    ext = load_extension()
    worst = 0.0
    for k in (1, 2, 32, 67, 300):
        for le in (32, 128, 512, 2048):
            for mb in (1, 7, 64):
                x, kw = commit_inputs(k * 1000 + le + mb, k, mb, le)
                worst = max(worst, check_commit(ops, ref, ext, x, kw, {
                    "phase": "kernel_stream_commit", "k": k, "Le": le,
                    "mb": mb, "inputs": "random"}))
    for kind in ("ties", "cap", "full", "pad", "dup"):
        for k in (3, 32):
            x, kw = commit_inputs(k, k, 64, 128, kind=kind)
            worst = max(worst, check_commit(ops, ref, ext, x, kw, {
                "phase": "kernel_stream_commit", "k": k, "Le": 128,
                "mb": 64, "inputs": kind}))
    # the stream's kinds of rows on the staged branch, past one word of
    # partitions; then the row chain: more pins than the staged table's
    # room (handed over inside the staged kernel), k past 256 (chosen by
    # the launcher), a sketch entry below 0 (handed over too, which the
    # launcher's rule does not see); 24 bits
    cases = [(kind, k, le, 1) for kind in ("path", "chain", "nopins")
             for k in (32, 33, 64, 65) for le in (32, 2048)]
    cases += [("wide", 3, 256, 2), ("wide", 32, 256, 2),
              ("wide", 256, 2048, 2), ("wide", 300, 256, 0),
              ("negative", 3, 32, 1), ("negative", 32, 32, 1),
              ("negative", 300, 32, 0), ("path", 257, 32, 0)]
    for kind, k, le, branch in cases:
        x, kw = commit_inputs(k * 7 + le, k, 64, le, kind=kind)
        worst = max(worst, check_commit(ops, ref, ext, x, kw, {
            "phase": "kernel_stream_commit", "k": k, "Le": le, "mb": 64,
            "inputs": kind}, branch=COMMIT_BRANCHES[branch]))
    for kind in ("random", "path", "chain"):
        for k in (1, 5, 8):
            x, kw = commit_inputs(k, k, 64, 32, bits=24, kind=kind)
            worst = max(worst, check_commit(ops, ref, ext, x, kw, {
                "phase": "kernel_stream_commit", "k": k, "Le": 32,
                "mb": 64, "bits": 24, "inputs": kind}))
            del x
    kept_batches = [(ordinal, args) for ordinal, args in zip(at, kept.args)]
    kept_batches += [(ordinal, args) for _, (ordinal, args)
                     in sorted(kept.by_width.items())]
    for ordinal, (args, kw) in kept_batches:
        worst = max(worst, check_commit(ops, ref, ext, args, kw, {
            "phase": "kernel_stream_commit", "inputs": "path micro-batch",
            "ordinal": ordinal, "Le": args[0].shape[1],
            "pins": int((args[0] >= 0).sum())}))
    if same_graph and sorted(kept.by_width) != [32, 128, 512]:
        raise SystemExit(f"the pass's tile widths were "
                         f"{sorted(kept.by_width)}, not 32, 128 and 512")
    # timed on the mid-stream micro-batch (its tile widened to 2,048, and
    # its first 1, 16 and 64 rows) and on the pass's first of each width
    timed = {"phase": "kernel_stream_commit",
             "inputs": f"path micro-batch {at[1]} at Le=2048",
             **commit_timings(ops, ref, ext, kept.args[1], kept.by_width),
             "max_abs_err": worst}
    emit(timed)

    # row 1 at the stream's shape: the path's neighbour tile of the same
    # micro-batch, widened to 2,048 and broadcast over the 32 fringes
    order = hs._stream_order(hg.n, p)
    batch = order[at[1] * 64:(at[1] + 1) * 64]
    _, nbr = hs._batch_tiles(hg, hg.vertex_adjacency(), batch, 2048, 64)
    tile = np.full((64, 2048), -1, np.int32)
    tile[:, :nbr.shape[1]] = nbr
    nbrs = torch.from_numpy(tile).cuda().expand(32, 64, 2048).contiguous()
    fringe = torch.from_numpy(np.random.default_rng(2).integers(
        0, hg.n, size=(32, 16)).astype(np.int32)).cuda()
    bias = torch.zeros((32, 64), device="cuda")
    prev = torch.full((32, 1), float("inf"), device="cuda")
    sel = (nbrs, fringe, bias, prev)
    out = ops.hype_score_select(*sel, select_k=1)
    torch.cuda.synchronize()
    equal = all(torch.equal(g, w) for g, w in zip(
        out, ref.hype_score_select_ref(*sel, 1)))
    nb = sum(t.nbytes for t in sel) + sum(t.nbytes for t in out)
    row1 = {"phase": "kernel_stream_row1", "G": 32, "R": 64, "L": 2048,
            "s": 16, "P": 1, "select_k": 1, "equal": equal, "bytes": nb,
            "bound_ms": nb / HBM_BYTES_PER_S * 1e3,
            "ms": cuda_ms(lambda: ops.hype_score_select(*sel, select_k=1)),
            "graph_ms": graph_ms(
                lambda: ops.hype_score_select(*sel, select_k=1))}
    emit(row1)
    if not equal:
        raise SystemExit(f"row 1 at the stream's shape differs: {row1}")

    # 3. the budget, a killed and resumed run, a retried fault
    def run(label, params, need_batches=None, expect=clean):
        (a, st), wall, counts = launches.drive(
            lambda: hs.hype_stream_partition(hg, 32, params,
                                             return_state=True,
                                             device="cuda"))
        nb_ = st.stats.micro_batches
        need = need_batches if need_batches is not None else nb_
        row = stream_run_row(f"stream_{label}", hg, a, st, wall, counts,
                             {"hype_score_select": need,
                              "stream_commit": need})
        row["expected_digest"] = expect
        emit(row)
        if row["digest"] != expect:
            raise SystemExit(f"stream_{label} digest differs: {row}")
        return row

    budget = dataclasses.replace(p, mem_budget=STREAM_BUDGET)
    row = run("budget", budget, expect=want(
        STREAM_BUDGET_DIGEST, lambda: digest(hs.hype_stream_partition(
            hg, 32, budget, device="cpu"))))
    got_plan = (row["plan_micro_batch"], row["plan_tile_l"],
                row["planned_bytes"], row["micro_batches"])
    if same_graph and got_plan != STREAM_BUDGET_PLAN:
        raise SystemExit(f"the budget planned {got_plan}, JAX "
                         f"{STREAM_BUDGET_PLAN}")
    d = snapshot_root("stream")
    snap = dataclasses.replace(p, snapshot_every=STREAM_SNAPSHOT_EVERY,
                               snapshot_dir=d)
    killed = launches.drive(lambda: expect_fault(
        res, lambda: hs.hype_stream_partition(
            hg, 32, dataclasses.replace(
                snap, fault_plan=f"dispatch@{STREAM_KILL_AT}:fatal"),
            device="cuda")))
    emit({"phase": "stream_killed", "wall_s": killed[1],
          "launches": killed[2], "error": killed[0],
          "snapshot_bytes": snapshot_bytes(d)})
    if killed[2]["stream_commit"] != STREAM_KILL_AT - 1:
        raise SystemExit(f"the killed stream launched {killed[2]}")
    last = (STREAM_KILL_AT - 1) // STREAM_SNAPSHOT_EVERY * STREAM_SNAPSHOT_EVERY
    row = run("resumed", dataclasses.replace(snap, resume=d),
              need_batches=n_batches - last)
    if row["resumed_at"] != last:
        raise SystemExit(f"the stream resumed at {row['resumed_at']}")
    row = run("retried", dataclasses.replace(p, fault_plan="dispatch@3"))
    if (row["faults_injected"], row["retries"]) != (1, 1):
        raise SystemExit(f"the dispatch fault was not retried once: {row}")

    # 4. the incremental mode on the path's state
    log = stream_ops(state, seed=0)
    _, wall, counts = launches.drive(lambda: hs.apply_updates(state, log))
    st = state.stats
    readmit = -(-st.readmitted // st.plan_micro_batch)
    row = {"phase": "stream_updates", "wall_s": wall, "ops": len(log),
           "digest": digest(state.assignment),
           "sketch_digest": state.sketch_digest(), "launches": counts,
           "expected_launches": readmit}
    row.update({key: getattr(st, key) for key in (
        "update_s", "updates_per_s", "inserts", "deletes", "readmitted",
        "refine_moves", "rebalance_moves")})
    sk, sz = hs.recompute_sketch(state.hg, state.assignment, 32,
                                 p.sketch_bits)
    row["sketch_equals_recount"] = bool((sk == state.sketch).all()
                                        and (sz == state.sizes).all())
    counters = (st.inserts, st.deletes, st.readmitted, st.refine_moves,
                st.rebalance_moves)
    if cpu_state is not None:
        hs.apply_updates(cpu_state, log)
    row["expected_digest"] = want(STREAM_UPDATE_DIGEST,
                                  lambda: digest(cpu_state.assignment))
    emit(row)
    if (row["digest"] != row["expected_digest"]
            or not row["sketch_equals_recount"]
            or (same_graph and counters != STREAM_UPDATE_COUNTERS)
            or counts["stream_commit"] != readmit
            or counts["hype_score_select"] != readmit):
        raise SystemExit(f"apply_updates differs: {row}")
    return timed, worst


def sharded_row(label, hg, a, st, wall):
    """A sharded run's row: the path's metrics, its collective counters
    and its time split."""
    row = path_row(f"sharded_{label}", hg, a, 32, wall)
    row.update({key: getattr(st, key) for key in (
        "supersteps", "collectives", "collective_bytes",
        "admission_conflicts", "stale_redraws", "cache_invalidations",
        "host_s", "device_s", "faults_injected", "retries", "fallbacks",
        "resumed_at", "tile_l")})
    return row


def phase_sharded(hg, same_graph, runs, launches, ops, ref,
                  partition_resilient):
    """hype_sharded on the slice's graph, k=32, t=16. First row 1 at the
    shard's shapes (a phase group of 8 of the 32 phases at offsets 0 and
    24, and all 32) against its plain version, timed. Then one rank with
    no group at depths 1 and 2 (the slice's digests, a collective a
    superstep counted and none run, no conflicts; the slice's wall in the
    same call beside it); one rank under a one-rank NCCL group over a
    file:// store (the digest; NCCL's all_gather timed alone at the
    superstep's payload, and its share of a superstep); four spawned
    ranks sharing the card over gloo (JAX's four-device digest,
    collectives, bytes and conflicts on every rank, and each rank's row 1
    launches); partition_resilient with its default method killed at
    100 (JAX's ladder at devices=1); and collective@2;nan@3 at one rank
    (the slice's digest). Returns the timed shard rows and the launches
    of each run for the kernels line, and the worst error."""
    import datetime
    import shutil

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.engines import sharded

    L = runs[2]["tile_l"]
    rng = np.random.default_rng(24)
    shard_rows, worst = {}, 0.0
    for gl, off in ((8, 0), (8, 24), (32, 0)):
        x = kernel_inputs(rng, 32, 16, L, 1, 64, "random")
        args = (x[0][off:off + gl].contiguous(), *x[1:])

        def call():
            return ops.hype_score_select_shard(*args, select_k=16,
                                               shard_offset=off)

        def plain():
            return ref.hype_score_select_shard_ref(*args, 16, off)

        out = call()
        torch.cuda.synchronize()
        want = plain()
        err = max_abs_err(out, want)
        worst = max(worst, err)
        nbytes = (args[0].nbytes + sum(t[off:off + gl].nbytes for t in x[1:])
                  + sum(t.nbytes for t in out))
        row = {"phase": "kernel_shard", "G": 32, "group_l": gl,
               "shard_offset": off, "R": 16, "L": L, "s": 1, "P": 64,
               "select_k": 16, "max_abs_err": err,
               "equal": all(torch.equal(a, b) for a, b in zip(out, want)),
               "ms": cuda_ms(call), "graph_ms": graph_ms(call),
               "plain_ms": cuda_ms(plain, iters=20), "bytes": nbytes,
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        emit(row)
        if not row["equal"]:
            raise SystemExit(f"the shard's call disagrees with its plain "
                             f"version: {row}")
        shard_rows.setdefault(gl, row)

    shard_launches = {}

    def one_rank(label, depth, need_digest, retried_faults=0, **kw):
        p = sharded.ShardedParams(seed=0, t=16, pipeline_depth=depth, **kw)
        (a, st), wall, counts = launches.drive(
            lambda: sharded.hype_sharded_partition(hg, 32, p, True,
                                                   device="cuda"))
        row = sharded_row(label, hg, a, st, wall)
        row["slice_wall_s_same_call"] = runs[depth]["wall_s"]
        cpu = None if same_graph else runs[depth]["digest"]
        # every launch is a superstep's or a replay's: a retry counts
        # both, and a retried dispatch or collective fault fires before
        # its launch
        need = st.supersteps + st.retries - retried_faults
        check_path(row, need_digest, SLICE_KM1[depth], cpu, counts,
                   {"hype_score_select": need})
        if (st.collectives != st.supersteps or st.admission_conflicts
                or st.collective_bytes != st.supersteps * 32 * 32 * 4):
            raise SystemExit(f"one rank's collective counters: {row}")
        shard_launches[label] = counts["hype_score_select"]
        return row, st, wall

    for depth in (1, 2):
        row, st, _ = one_rank(f"d1_depth{depth}", depth, SLICE_DIGESTS[depth])
        if st.supersteps != runs[depth]["supersteps"]:
            raise SystemExit(f"one rank ran {st.supersteps} supersteps; the "
                             f"slice {runs[depth]['supersteps']}")
        if same_graph and depth == 2 and (st.collectives, st.collective_bytes) \
                != (380, 1_556_480):
            raise SystemExit(f"depth 2 counted {row}")
    nogroup_wall = row["wall_s"]

    # one rank under a one-rank NCCL group: the all_gather runs on NCCL
    store = snapshot_root("nccl_store")
    pathlib.Path(store).mkdir(parents=True)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}/store",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=300))
    try:
        row, st, wall = one_rank("d1_nccl", 2, SLICE_DIGESTS[2])
        mesh = sharded.Mesh.of(None, "cuda")
        payload = torch.zeros((32, 16 + 16), dtype=torch.int32,
                              device="cuda")
        gather_ms = cuda_ms(lambda: mesh.all_gather(payload))
        superstep_ms = wall * 1e3 / st.supersteps
        emit({"phase": "sharded_nccl_collective",
              "backend": dist.get_backend(), "world_size": mesh.size,
              "payload": list(payload.shape), "all_gather_ms": gather_ms,
              "superstep_wall_ms": superstep_ms,
              "collective_share_of_superstep": gather_ms / superstep_ms,
              "wall_s": wall, "wall_s_no_group": nogroup_wall})
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)

    # four ranks sharing the card over gloo (the payload staged through
    # the host): the protocol at four ranks, not a speed-up
    t0 = time.perf_counter()
    with sharded.RankPool(SHARDED_RANKS, backend="gloo",
                          timeout_s=600) as pool:
        up = time.perf_counter() - t0
        t0 = time.perf_counter()
        outs = pool.run(sharded.partition_rank, hg, 32,
                        sharded.ShardedParams(seed=0, t=16), "cuda")
        wall = time.perf_counter() - t0
    a, st, _ = outs[0]
    rank_launches = [o[2] for o in outs]
    row = sharded_row("d4_gloo", hg, a, st, wall)
    row.update(ranks=SHARDED_RANKS, spawn_and_join_s=up,
               rank_launches=rank_launches,
               ranks_equal=all(np.array_equal(o[0], a)
                               and sharded.run_counters(o[1])
                               == sharded.run_counters(st) for o in outs))
    got = (row["digest"], st.collectives, st.collective_bytes,
           st.admission_conflicts, row["k_minus_1"])
    row["expected"] = list(SHARDED_D4)
    emit(row)
    if not row["ranks_equal"]:
        raise SystemExit(f"the four ranks differ: {row}")
    if same_graph and got != SHARDED_D4:
        raise SystemExit(f"four ranks differ from JAX's run: {row}")
    if any(n != st.supersteps for n in rank_launches):
        raise SystemExit(f"a rank launched row 1 {rank_launches} times for "
                         f"{st.supersteps} supersteps")
    shard_launches["d4_gloo_per_rank"] = rank_launches
    launches.total["hype_score_select"] += sum(rank_launches)

    # partition_resilient's default method (no group: one rank), killed
    # at 100 and finishing on hype_superstep from the snapshot at 64
    d = snapshot_root("sharded_ladder")
    (a, rep), wall, counts = launches.drive(lambda: partition_resilient(
        hg, 32, device="cuda", seed=0, t=16, snapshot_dir=d,
        snapshot_every=64, fault_plan="dispatch@100:fatal"))
    st = rep["stats"]
    row = sharded_row("ladder", hg, a, st, wall)
    row.update(method=rep["method"], requested_method=rep["requested_method"],
               degraded_from=rep["degraded_from"])
    # the superstep rung's supersteps, and the sharded rung's 99 before
    # its fatal fault
    check_path(row, SHARDED_LADDER[0], SHARDED_LADDER[1],
               None if same_graph else row["digest"], counts,
               {"hype_score_select": st.supersteps + 99})
    if (rep["requested_method"] != "hype_sharded"
            or rep["method"] != "hype_superstep" or st.resumed_at != 64):
        raise SystemExit(f"the ladder did not land as expected: {row}")
    shard_launches["ladder"] = counts["hype_score_select"]

    # an injected collective fault and a NaN tile at one rank
    row, st, _ = one_rank("d1_faults", 2, SLICE_DIGESTS[2], retried_faults=1,
                          fault_plan="collective@2;nan@3")
    if st.faults_injected != 2 or st.retries < 2:
        raise SystemExit(f"the faults were not retried: {row}")
    return shard_rows, shard_launches, worst


def phase_hype_jax(launches, partition, synth, Hypergraph, metrics):
    """hype_jax and hype_parallel through ``partition(..., device="cuda")``
    on pl300 (k=8) and pl3000 (k=16), and hype_jax on the edge graph at
    k = 1, 3 and 6. Each card run is held to JAX's digest and k-1 and to
    the port's CPU run, and must launch no kernel: neither engine has one
    on its path. Prints each run's wall,
    iterations, restarts and rescues, k-1 and part sizes."""
    from repro_torch.core import partition_api as api
    stats = []

    def with_stats(fn):
        def run(*args, **kw):
            out, st = fn(*args, return_stats=True, **kw)
            stats.append(st)
            return out
        return run

    graphs = {name: synth.powerlaw_hypergraph(**kw)
              for name, kw in HYPE_JAX_GRAPHS.items()}
    graphs["edges"] = Hypergraph.from_edge_lists(6, HYPE_JAX_EDGES)
    engines = {"hype_jax": api.hype_jax_partition,
               "hype_parallel": api.hype_parallel_partition}
    for (method, graph, k), want in HYPE_JAX_DIGESTS.items():
        hg = graphs[graph]
        api.hype_jax_partition = with_stats(engines["hype_jax"])
        api.hype_parallel_partition = with_stats(engines["hype_parallel"])
        try:
            a, wall, counts = launches.drive(
                lambda: partition(hg, k, method, device="cuda"))
        finally:
            api.hype_jax_partition = engines["hype_jax"]
            api.hype_parallel_partition = engines["hype_parallel"]
        st = stats.pop()
        t0 = time.perf_counter()
        cpu = partition(hg, k, method, device="cpu")
        cpu_s = time.perf_counter() - t0
        sizes = metrics.partition_sizes(a, k)
        row = {"phase": "hype_jax", "method": method, "graph": graph,
               "n": hg.n, "m": hg.m, "k": k, "wall_s": wall,
               "cpu_wall_s": cpu_s, **dataclasses.asdict(st),
               "k_minus_1": metrics.k_minus_1(hg, a, k),
               "sizes": [int(sizes.min()), int(sizes.max())],
               "digest": digest(a), "cpu_digest": digest(cpu),
               "expected": list(want), "launches": counts}
        emit(row)
        if row["digest"] != row["cpu_digest"]:
            raise SystemExit(f"{method} on {graph}: the card's run differs "
                             f"from the CPU's: {row}")
        if (row["digest"], row["k_minus_1"]) != want:
            raise SystemExit(f"{method} on {graph} differs from JAX's run: "
                             f"{row}")
        if sizes.max() - sizes.min() > 1:
            raise SystemExit(f"{method} on {graph} is unbalanced: {row}")
        if any(counts.values()):
            raise SystemExit(f"{method} launched a kernel: {counts}")


def expect_fault(res, fn):
    """Run ``fn``, which must raise ``UnrecoverableFault``; returns the
    error's text."""
    try:
        fn()
    except res.UnrecoverableFault as exc:
        return str(exc)
    raise SystemExit("the fatal fault did not stop the run")


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
    from repro_torch.core import metrics, scoring
    from repro_torch.core.hypergraph import Hypergraph
    from repro_torch.data import synthetic as synth
    from repro_torch.engines.batched import (BatchedParams,
                                             hype_batched_partition)
    from repro_torch.engines.device import (DeviceParams,
                                            hype_device_partition)
    from repro_torch.engines.superstep import (SuperstepParams,
                                               hype_superstep_partition)
    from repro_torch.engines.superstep import (
        run_pipeline as superstep_pipeline)
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
    from repro_torch.core import hype_stream
    from repro_torch.core import resilience as res
    from repro_torch.core.partition_api import (PRESETS, partition,
                                           partition_and_report,
                                           partition_resilient)

    t_start = time.perf_counter()
    t0 = time.perf_counter()
    ext = _build.load_extension()
    build_s = time.perf_counter() - t0
    card = card_line()
    emit({"phase": "env", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device_name": torch.cuda.get_device_name(0),
          "build_s": build_s, "flash_sass": flash_sass(ext.__file__)})

    per_l, select_floor, worst_err = phase_kernel(ops, ref)
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
                         "stream_commit": ops.stream_commit,
                         "kway_gains": kops.kway_gains,
                         "kway_gains_csr": kops.kway_gains_csr,
                         "embedding_bag": bops.embedding_bag,
                         "embedding_bag_bwd": bops.embedding_bag_bwd,
                         "flash_attention": fops.flash_attention,
                         "flash_attention_bwd": fops.flash_attention_bwd,
                         "neighbor_agg": nops.neighbor_agg,
                         "neighbor_agg_csr": nops.neighbor_agg_csr,
                         "neighbor_agg_bwd": nops.neighbor_agg_bwd,
                         "segment_sum": nops.segment_sum})
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
    batched_host_rows = st.host_rows

    # hype_superstep, t=16, preset="quality": supersteps, then the
    # refinement post-pass with its kway_gains screen on the card
    # (the first screen's arguments kept for the kernel_kway_screen phase)
    qp = SuperstepParams(seed=0, t=16, **PRESETS["hype_superstep"]["quality"])
    with FirstScreen(scoring) as first:
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
                        "kway_gains_csr": screens})
    quality_tile_l = st.tile_l
    if first.args is None:
        raise SystemExit("the quality path made no refinement screen")
    screen_row = phase_kernel_kway_screen(kops, kref, scoring, first.args)
    phase_device(hg, same_graph, runs[1], launches, metrics, SuperstepParams,
                 hype_superstep_partition, DeviceParams,
                 hype_device_partition, PRESETS)
    phase_resilience(hg, same_graph, launches, metrics, res, DeviceParams,
                     hype_device_partition, SuperstepParams,
                     hype_superstep_partition, BatchedParams,
                     hype_batched_partition, partition_resilient,
                     batched_host_rows)
    phase_report(hg, same_graph, launches, partition_and_report)
    t0 = time.perf_counter()
    phase_membudget(hg, same_graph, launches, SuperstepParams,
                    hype_superstep_partition, superstep_pipeline,
                    DeviceParams, hype_device_partition)
    emit({"phase": "membudget_done", "wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    commit_row, worst_commit = phase_stream(hg, same_graph, launches, ops,
                                            ref, scoring, hype_stream, res)
    emit({"phase": "stream_done", "wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    shard_rows, shard_launches, worst_shard = phase_sharded(
        hg, same_graph, runs, launches, ops, ref, partition_resilient)
    emit({"phase": "sharded_done", "wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    phase_hype_jax(launches, partition, synth, Hypergraph, metrics)
    emit({"phase": "hype_jax_done", "wall_s": time.perf_counter() - t0})

    # hype_multilevel on github_like(0.25): host coarsening, supersteps on
    # the coarsest graph, kway_gains_csr screens at the finest level
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
                        "kway_gains_csr": None})

    phase_profile("slice_depth1", lambda: run_slice(
        hg, 1, "cuda", metrics, SuperstepParams, hype_superstep_partition))
    phase_profile("device", lambda: hype_device_partition(
        hg, 32, DeviceParams(seed=0, t=16), device="cuda"))
    phase_profile("stream", lambda: hype_stream.hype_stream_partition(
        hg, 32, hype_stream.StreamParams(seed=0), device="cuda"))

    bag_rows, worst_bag, bag_bwd_row, worst_bag_bwd = run_recsys(
        launches, bops, bref)
    flash_rows, worst_flash, bwd_rows, worst_bwd = run_lm(launches, fops,
                                                          fref)
    run_moe(launches)
    (na_row, (worst_na, worst_na_bwd), ss_row, worst_ss, csr_row,
     (worst_csr, worst_csr_bwd)) = run_gnn(launches, nops, nref)

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
          "embedding_bag_bwd": {"training shape": {
              "library_ms": bag_bwd_row["library_ms"],
              "call": bag_bwd_row["library_call"]}},
          "flash_attention": {shape: {"library_ms": r["library_ms"],
                                      "call": r["library_call"]}
                              for shape, r in flash_rows.items()},
          "flash_attention_bwd": {shape: {"library_ms": r["library_ms"],
                                          "call": r["library_call"]}
                                  for shape, r in bwd_rows.items()},
          "neighbor_agg": {"layer": {"library_ms": na_row["library_ms"],
                                     "call": na_row["library_call"]}},
          "neighbor_agg_csr": {
              "ogb layer": {"library_ms": csr_row["library_ms"],
                            "call": csr_row["library_call"]},
              "minibatch_lg layer": {"library_ms": csr_row[
                  "minibatch_lg_layer"]["library_ms"]}},
          "neighbor_agg_bwd": {"layer": {
              "library_ms": na_row["backward"]["library_ms"],
              "call": na_row["backward"]["library_call"]}},
          "segment_sum": {"meshgraphnet layer": {
              "library_ms": ss_row["library_ms"],
              "call": ss_row["library_call"]}},
          "hype_score_select": None, "hype_scores": None, "kway_gains": None,
          "kway_gains_csr": None, "stream_commit": None,
          "why_none": "no single PyTorch call computes the functions of "
                      "the four partitioning kernels"})
    emit({"kernels": [
        entry("hype_score_select", csrc + "hype_score/csrc/score_select.cu",
              "src/repro/kernels/hype_score/kernel.py:160",
              per_l[runs[1]["tile_l"]], max(worst_err, worst_shard),
              graph_ms=per_l[runs[1]["tile_l"]]["graph_ms"],
              launch_floor_ms=select_floor["ms"],
              launch_floor_graph_ms=select_floor["graph_ms"],
              # the sharded engine's phase groups: G = 8 of 32 at four
              # ranks, all 32 at one
              shard={f"G{gl}": {key: r[key] for key in (
                  "ms", "graph_ms", "plain_ms", "bound_ms", "max_abs_err")}
                  for gl, r in shard_rows.items()},
              shard_launches=shard_launches),
        entry("hype_scores", csrc + "hype_score/csrc/scores.cu",
              "src/repro/kernels/hype_score/kernel.py:50",
              per_bl[(256, 2048)], worst_scores),
        # the tile front end; the paths run the row routine through the
        # CSR front end, so its launches are both front ends' sum
        dict(entry("kway_gains", csrc + "kway_refine/csrc/kway_gains.cu",
                   "src/repro/kernels/kway_refine/kernel.py:65",
                   per_lk[(quality_tile_l, 32)], worst_kway,
                   graph_ms=per_lk[(quality_tile_l, 32)]["graph_ms"],
                   path_like_tile={key: per_lk[(2048, "path")][key] for key
                                   in ("fill", "ms", "graph_ms", "bound_ms",
                                       "plain_ms")}),
             launches=launches.total["kway_gains"]
             + launches.total["kway_gains_csr"],
             launches_by_front_end={
                 "tile": launches.total["kway_gains"],
                 "csr": launches.total["kway_gains_csr"]}),
        entry("kway_gains_csr", csrc + "kway_refine/csrc/kway_gains.cu",
              "src/repro/kernels/kway_refine/kernel.py:65", screen_row,
              screen_row["max_abs_err"],
              **{key: screen_row[key] for key in (
                  "graph_ms", "screen_ms", "screen_graph_ms", "chain_ms",
                  "chain_graph_ms", "launch_floor_ms",
                  "launch_floor_graph_ms", "fill", "k67")},
              note="the refinement screen's front end: the candidates' "
                   "parts read through the CSR in place of the (B, tile_l) "
                   "tile, each block's rows packed into one list over "
                   "its warps, a shared atomic a lane; "
                   "with the host's delta (screen_ms) one device program, "
                   "the gains' kernel a programmatic dependent of the "
                   "delta's; chain_ms is the gather + tile kernel it "
                   "replaced"),
        entry("stream_commit", csrc + "hype_score/csrc/stream_commit.cu",
              None, commit_row, worst_commit,
              **{key: commit_row[key] for key in (
                  "graph_ms", "branch", "row_chain_ms", "nopin_chain_ms",
                  "dense", "per_row_us")},
              pass_widths={le: {key: r[key] for key in (
                  "ms", "graph_ms", "bound_ms", "branch")}
                  for le, r in commit_row["pass_widths"].items()},
              note="the sequential sketch commit of the streaming engine: "
                   "the fori_loop body of src/repro/core/scoring.py:545-566, "
                   "which JAX leaves to XLA (no pallas_call)"),
        entry("embedding_bag", csrc + "embedding_bag/csrc/embedding_bag.cu",
              "src/repro/kernels/embedding_bag/kernel.py:73", bulk,
              worst_bag),
        entry("embedding_bag_bwd", csrc + "neighbor_agg/csrc/neighbor_agg.cu",
              None, bag_bwd_row, worst_bag_bwd,
              graph_ms=bag_bwd_row["graph_ms"],
              wrapper_ms=bag_bwd_row["wrapper_ms"],
              split_ms=bag_bwd_row["split_ms"],
              light_pass_ms=bag_bwd_row["light_pass_ms"],
              item_tower=bag_bwd_row["item_tower"],
              note="the table's gradient through embedding_bag_kernel, "
                   "src/repro/kernels/embedding_bag/kernel.py:73, which "
                   "has no TPU backward (the JAX model differentiates "
                   "jnp.take): row 5b's kernels (neighbor_agg_bwd: the "
                   "heavy pass, then the light pass) with the bags as "
                   "rows, in its mean mode; timed at the training "
                   "shape's user tower"),
        entry("flash_attention",
              csrc + "flash_attention/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention/kernel.py:111",
              flash_rows["layer"], worst_flash,
              **{label: {key: flash_rows[shape][key] for key in (
                  "B", "ms", "plain_ms", "bound_ms", "library_ms",
                  "max_abs_err")} for label, shape in (
                  ("granite_moe_train", "granite_layer"),
                  ("mixtral_moe_train", "mixtral_train"))}),
        entry("flash_attention_bwd",
              csrc + "flash_attention/csrc/flash_attention_bwd.cu", None,
              bwd_rows["train"], worst_bwd,
              graph_ms=bwd_rows["train"]["graph_ms"],
              **{label: {key: bwd_rows[shape][key] for key in (
                  "B", "ms", "graph_ms", "plain_ms", "bound_ms",
                  "library_ms", "max_abs_err")} for label, shape in (
                  ("qwen3_8b_layer", "layer"),
                  ("granite_moe_train", "granite_train"),
                  ("mixtral_moe_train", "mixtral_train"))},
              note="the backward (dq, dk, dv) of flash_attention_fwd, "
                   "src/repro/kernels/flash_attention/kernel.py:111, which "
                   "has no TPU backward (the JAX model differentiates its "
                   "einsum attention); bf16 at D <= 128 on wgmma, D = 80 "
                   "padded to 96; timed at the LM training shape"),
        # the padded front end: GraphSAGE runs row 5d, whose launches
        # are other kernels (the heavy pass and the tile kernel) in its
        # own entry
        entry("neighbor_agg", csrc + "neighbor_agg/csrc/neighbor_agg.cu",
              "src/repro/kernels/neighbor_agg/kernel.py:72", na_row,
              worst_na, launcher_batch=na_row["launcher_batch"]),
        entry("neighbor_agg_csr", csrc + "neighbor_agg/csrc/neighbor_agg.cu",
              "src/repro/kernels/neighbor_agg/kernel.py:72", csr_row,
              worst_csr, **{key: csr_row[key] for key in (
                  "graph_ms", "with_units_build_ms", "split_ms",
                  "chunk_units", "without_busiest_row_ms",
                  "without_busiest_row_split_ms", "busiest_row_slots",
                  "gnn_full_batch_step_ms")},
              minibatch_lg_layer=csr_row["minibatch_lg_layer"],
              note="the CSR front end of neighbor_agg_kernel (row 5d): "
                   "row 5b's heavy pass over the rows' CSR (the means of "
                   "the rows past 32 slots), then the tile kernel (the "
                   "other rows' means and the TPU body's _fin, the "
                   "product with w, on the tensor cores in split TF32); "
                   "timed at the ogb_products layer"),
        entry("neighbor_agg_bwd", csrc + "neighbor_agg/csrc/neighbor_agg.cu",
              None, na_row["backward"], max(worst_na_bwd, worst_csr_bwd),
              ogb_layer=csr_row["backward"],
              minibatch_lg_layer_csr=csr_row["minibatch_lg_layer"][
                  "backward"],
              note="the backward (grad of x) of neighbor_agg_kernel, "
                   "src/repro/kernels/neighbor_agg/kernel.py:72, which has "
                   "no TPU backward; of row 5 and of row 5d"),
        entry("segment_sum", csrc + "neighbor_agg/csrc/segment_sum.cu",
              None, ss_row, worst_ss, graph_ms=ss_row["graph_ms"],
              with_index_build_ms=ss_row["with_index_build_ms"],
              library_graph_ms=ss_row["library_graph_ms"],
              gatedgcn_layer=ss_row["gatedgcn_layer"],
              note="the segment sums of gatedgcn, meshgraphnet, schnet "
                   "and the graph_reg pooling (jax.ops.segment_sum in "
                   "src/repro/models/gnn.py:56-66, 137-139, 152, 168, 196, "
                   "left to XLA; no pallas_call): row 5b's sum mode, each "
                   "edge a bag of one slot, on a kernel of its own (one "
                   "walk at any D, no memset); timed at meshgraphnet's "
                   "layer")]})
    emit({"phase": "done", "total_s": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
