#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check every phase.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card (one is
enough). It builds the port's CUDA kernels from this checkout, then
prints one JSON line per phase:

  env      the card's name and power limit, torch/CUDA versions, build time
  kernel   the CUDA score + select kernel against its plain PyTorch version
           on the card, compared exactly, with times per launch per L
  goldens  the seven small depth-1 golden digests of the JAX package,
           reproduced through ``partition(..., device="cuda")``
  slice    github_like(1.0, seed=0), k=32, t=16, at pipeline depth 1 and 2:
           the main path, with its digests held against the JAX package's
  profile  the depth-1 slice run twice more, under torch.profiler (the
           card's busy time) and under cProfile (the host half)

then the ``{"kernels": [...]}`` record, the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``. Any failure
raises and exits non-zero; nothing is printed on a machine without a
card or outside the repository.
"""
from __future__ import annotations

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

# tests/test_pipeline.py:38-43 of the JAX package: depth-1 goldens
GOLD_PL600 = {(5, 8): "9e8abe668aa53a74", (16, 8): "bbcd2f732e03af91",
              (16, 16): "e67c679d4029b7d0"}
GOLD_TINY = {2: "a102badbeab32296", 3: "b4293f255e72d527"}
GOLD_PL300 = "f821db1120c8d632"
GOLD_REDDIT = "13f232f653c9c752"


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


def phase_profile(hg, metrics, SuperstepParams, run):
    """Where the time goes, from two more depth-1 runs of the slice.

    Under torch.profiler: the card's busy time (kernels and copies,
    summed over device-side events only) and its largest consumers.
    Under cProfile: the host half's cumulative seconds per function of
    the port's engines (cProfile inflates Python-heavy code, so read the
    shares, not the sums).
    """
    import cProfile
    import pstats

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_slice(hg, 1, "cuda", metrics, SuperstepParams, run)
        wall = time.perf_counter() - t0
    dev = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            dev[e.key[:60]] = dev.get(e.key[:60], 0) + e.self_device_time_total
    busy_s = sum(dev.values()) / 1e6
    top = dict(sorted(dev.items(), key=lambda kv: -kv[1])[:6])
    emit({"phase": "profile", "depth": 1, "wall_s": wall,
          "device_busy_s": busy_s, "device_idle_share": 1 - busy_s / wall,
          "top_device_us": top})

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    run_slice(hg, 1, "cuda", metrics, SuperstepParams, run)
    prof.disable()
    wall = time.perf_counter() - t0
    host = {}
    for (path, _, func), row in pstats.Stats(prof).stats.items():
        if "repro_torch" in path and "engines" in path:
            host[func] = host.get(func, 0.0) + row[3]
    top = dict(sorted(host.items(), key=lambda kv: -kv[1])[:10])
    emit({"phase": "host_profile", "depth": 1, "wall_s_under_cprofile": wall,
          "cumulative_s": top})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
    from repro_torch.core import metrics
    from repro_torch.core.hypergraph import Hypergraph
    from repro_torch.data import synthetic as synth
    from repro_torch.engines.superstep import (SuperstepParams,
                                               hype_superstep_partition)
    from repro_torch.kernels import _build
    from repro_torch.kernels.hype_score import ops, ref
    from repro_torch.partition_api import partition

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
    phase_goldens(partition, synth, Hypergraph)

    t0 = time.perf_counter()
    hg = synth.github_like(1.0, seed=0)
    hg.vertex_adjacency()
    fp = hg.fingerprint()
    emit({"phase": "slice_setup", "graph": "github_like(1.0, seed=0)",
          "n": hg.n, "m": hg.m, "pins": hg.n_pins, "fingerprint": fp,
          "expected_fingerprint": SLICE_FINGERPRINT,
          "setup_s": time.perf_counter() - t0})

    # the main path: every launch count starts at 0 here
    ops.hype_score_select.launches = 0
    runs = {}
    for depth in (1, 2):
        a, row = run_slice(hg, depth, "cuda", metrics, SuperstepParams,
                           hype_superstep_partition)
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
        emit(row)
        if not ok:
            raise SystemExit(f"slice digest differs: {row}")
    launches = ops.hype_score_select.launches
    supersteps = sum(r["supersteps"] for r in runs.values())
    if launches == 0 or launches != supersteps:
        raise SystemExit(f"main path launched the kernel {launches} times "
                         f"for {supersteps} supersteps")

    phase_profile(hg, metrics, SuperstepParams, hype_superstep_partition)

    tile_l = runs[1]["tile_l"]
    main = per_l[tile_l]
    emit({"kernels": [{
        "name": "hype_score_select", "route": "cuda",
        "source": "src/repro_torch/kernels/hype_score/csrc/score_select.cu",
        "replaces": "src/repro/kernels/hype_score/kernel.py:130",
        "launches": launches,
        "max_abs_err": worst_err,
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": "bytes",
        "library_ms": None}]})
    emit({"phase": "done", "total_s": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
