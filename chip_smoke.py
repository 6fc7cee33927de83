#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check every phase.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card (one is
enough). It builds the port's CUDA kernels from this checkout, then
prints one JSON line per phase:

  env       the card's name and power limit, torch/CUDA versions, build time
  kernel    each CUDA kernel against its plain PyTorch version on the card,
            compared exactly, with times per launch: score + select per L,
            hype_scores per (B, L), kway_gains per (L, k), plus edge cases
  goldens   the seven small depth-1 golden digests of the JAX package and
            six of the refinement, batched and multilevel paths (pl600),
            reproduced through ``partition(..., device="cuda")``
  slice     github_like(1.0, seed=0), k=32, t=16, hype_superstep at
            pipeline depth 1 and 2, with its digests held against the JAX
            package's
  batched   the same graph through hype_batched, t=16
  quality   the same graph through hype_superstep, t=16, preset="quality"
            (the refinement post-pass on the card)
  multilevel  github_like(0.25, seed=0), k=32, through hype_multilevel
  profile   the depth-1 slice, the batched and the quality path each run
            twice more, under torch.profiler (the card's busy time) and
            under cProfile (the host's time per function)

Every path starts with all launch counts at 0 and reads them right after;
a path that did not launch each of its kernels fails. Then come the
``{"kernels": [...]}`` record, the card's name and power limit, and as the
last line ``{"ok": true, "device": {...}}``. Any failure raises and exits
non-zero; nothing is printed on a machine without a card or outside the
repository.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
import statistics
import subprocess
import sys
import time

# HBM rate of one H100 SXM (NVIDIA's data sheet): the bytes bound.
HBM_BYTES_PER_S = 3.35e12

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


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int = 5, iters: int = 100) -> float:
    """Median device time of one call over ``reps`` runs of ``iters``."""
    import torch
    for _ in range(10):
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
        if kind == "random":
            nbytes = sum(t.nbytes for t in x) + sum(t.nbytes for t in out)
            row.update(
                ms=cuda_ms(lambda: ops.hype_score_select(*x, select_k=k_)),
                plain_ms=cuda_ms(lambda: ref.hype_score_select_ref(*x, k_),
                                 iters=20),
                bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
            per_l[L] = row
        emit(row)
        if not equal:
            raise SystemExit(f"kernel disagrees with its plain version: "
                             f"{row}")
    return per_l, worst


def compare_and_time(phase, fn, plain, x, row, timed):
    """Run the kernel and its plain version on ``x``; emit and return the
    row (exact comparison, and times and the bytes bound when ``timed``).
    Raises when they disagree."""
    import torch
    out = fn(*x)
    torch.cuda.synchronize()
    want = plain(*x)
    err = max_abs_err([out], [want])
    row = {"phase": phase, **row, "equal": torch.equal(out, want),
           "max_abs_err": err}
    if timed:
        nbytes = sum(t.nbytes for t in x) + out.nbytes
        row.update(ms=cuda_ms(lambda: fn(*x)),
                   plain_ms=cuda_ms(lambda: plain(*x), iters=20),
                   bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
    emit(row)
    if not row["equal"]:
        raise SystemExit(f"kernel disagrees with its plain version: {row}")
    return row


def phase_kernel_scores(ops, ref):
    """hype_scores at the batched engine's shapes (B in {64, 256}, every
    L bucket, s=16) and edge cases, against its plain version."""
    import numpy as np
    import torch
    rng = np.random.default_rng(1)
    cases = [(B, L, 16, "random") for B in (64, 256)
             for L in (32, 128, 512, 2048)]
    cases += [(256, 2048, 16, "dup_fringe"), (64, 128, 16, "pads"),
              (33, 33, 3, "random"), (5, 128, 40, "dup_fringe")]
    per_shape, worst = {}, 0.0
    for B, L, s, kind in cases:
        nbrs = rng.integers(0, 2 * L, size=(B, L)).astype(np.int32)
        nbrs[rng.random((B, L)) < 0.4] = -1
        nbrs[0] = -1                                   # an all-pad row
        fringe = rng.choice(nbrs[nbrs >= 0], size=s).astype(np.int32)
        fringe[-1] = -1                                # a pad slot
        if kind == "dup_fringe":
            fringe[: s // 2] = fringe[0]
        elif kind == "pads":
            nbrs[:] = -1
        x = [torch.from_numpy(a).cuda() for a in (nbrs, fringe)]
        row = compare_and_time(
            "kernel_hype_scores", ops.hype_scores, ref.hype_scores_ref, x,
            {"B": B, "L": L, "s": s, "inputs": kind},
            timed=kind == "random" and L % 32 == 0)
        worst = max(worst, row["max_abs_err"])
        if "ms" in row:
            per_shape[(B, L)] = row
    return per_shape, worst


def phase_kernel_kway(kops, kref):
    """kway_gains at the refinement screen's tile (B=4096, every L
    bucket, k in {2, 32, 67}) and edge cases, against its plain version."""
    import numpy as np
    import torch
    rng = np.random.default_rng(2)
    cases = [(4096, L, k) for L in (32, 128, 512, 2048) for k in (2, 32, 67)]
    cases += [(17, 33, 5), (8, 128, 1), (4096, 2048, 1024)]
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
            timed=B == 4096 and k in (2, 32, 67))
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
            hg, k, device="cuda", t=t, pipeline_depth=1)), want)
    hg = synth.powerlaw_hypergraph(300, 500, seed=21, max_edge=10,
                                   max_degree=30)
    got["pl300_k24"] = (digest(partition(
        hg, 24, device="cuda", seed=1, pool_cap=16, pipeline_depth=1)),
        GOLD_PL300)
    hg = Hypergraph.from_edge_lists(6, [[0, 1], [1, 2, 3], []])
    for k, want in GOLD_TINY.items():
        got[f"tiny_k{k}"] = (digest(partition(
            hg, k, device="cuda", pipeline_depth=1)), want)
    got["reddit_k32_t16"] = (digest(partition(
        synth.reddit_like(0.005, seed=0), 32, device="cuda", t=16,
        pipeline_depth=1)), GOLD_REDDIT)
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
    summed over device-side events only) and its largest consumers.
    Under cProfile: the host's cumulative seconds per function of the
    port (cProfile inflates Python-heavy code, so read the shares, not
    the sums).
    """
    import cProfile
    import pstats

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    prof.disable()
    wall = time.perf_counter() - t0
    host = {}
    for (path, _, func), row in pstats.Stats(prof).stats.items():
        if "repro_torch" in path:
            host[func] = host.get(func, 0.0) + row[3]
    top = dict(sorted(host.items(), key=lambda kv: -kv[1])[:10])
    emit({"phase": "host_profile", "path": label,
          "wall_s_under_cprofile": wall, "cumulative_s": top})


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
    from repro_torch.kernels.hype_score import ops, ref
    from repro_torch.kernels.kway_refine import ops as kops
    from repro_torch.kernels.kway_refine import ref as kref
    from repro_torch.partition_api import PRESETS, partition

    t_start = time.perf_counter()
    t0 = time.perf_counter()
    _build.load_extension()
    build_s = time.perf_counter() - t0
    card = card_line()
    emit({"phase": "env", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device_name": torch.cuda.get_device_name(0),
          "build_s": build_s})

    per_l, worst_err = phase_kernel(ops, ref)
    per_bl, worst_scores = phase_kernel_scores(ops, ref)
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
                         "kway_gains": kops.kway_gains})
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
    bp = BatchedParams(seed=0, t=16)
    (a, st), wall, counts = launches.drive(lambda: hype_batched_partition(
        hg, 32, bp, return_stats=True, device="cuda"))
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

    def entry(name, source, replaces, main, err):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches.total[name],
                "max_abs_err": err, "ms": main["ms"],
                "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": "bytes", "library_ms": None}

    csrc = "src/repro_torch/kernels/"
    emit({"phase": "library", "library_ms": None,
          "why": "no single PyTorch call computes any of the three "
                 "kernels' functions"})
    emit({"kernels": [
        entry("hype_score_select", csrc + "hype_score/csrc/score_select.cu",
              "src/repro/kernels/hype_score/kernel.py:160",
              per_l[runs[1]["tile_l"]], worst_err),
        entry("hype_scores", csrc + "hype_score/csrc/scores.cu",
              "src/repro/kernels/hype_score/kernel.py:50",
              per_bl[(256, 2048)], worst_scores),
        entry("kway_gains", csrc + "kway_refine/csrc/kway_gains.cu",
              "src/repro/kernels/kway_refine/kernel.py:65",
              per_lk[(quality_tile_l, 32)], worst_kway)]})
    emit({"phase": "done", "total_s": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
