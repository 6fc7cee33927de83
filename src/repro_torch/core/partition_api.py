"""The port's entry point: ``partition(hg, k, method)``.

It runs on the card unless the caller passes ``device="cpu"``; with no
card and no ``device`` it raises instead of falling back. ``METHOD_INFO``
is the JAX package's registry (``src/repro/core/partition_api.py``) with
the port's own params dataclasses; ``METHODS`` holds the methods the port
serves (all sixteen of JAX's), and ``PENDING`` maps any other method of
the registry to the ROADMAP.md item that brings it (empty now).
``partition_and_report`` adds the quality report and
``partition_resilient`` the degradation ladder.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import metrics, resilience
from .hype import HypeParams, hype_partition
from .hype_jax import hype_jax_partition, hype_parallel_partition
from .hype_stream import StreamParams, hype_stream_partition
from .hypergraph import Hypergraph
from .minmax import hashing_partition, minmax_partition, random_partition
from .multilevel import hype_multilevel_partition, multilevel_partition
from .resilience import UnrecoverableFault
from .shp import shp_partition
from ..engines.batched import BatchedParams, hype_batched_partition
from ..engines.device import DeviceParams, hype_device_partition
from ..engines.sharded import ShardedParams, hype_sharded_partition
from ..engines.superstep import SuperstepParams, hype_superstep_partition

# preset -> the knob defaults it folds in under the explicit knobs, as
# in the JAX package's registry. The pipelined engine also pins the
# lock-step schedule at ``quality``.
_PRESETS_HOST = {"fast": {}, "balanced": {"refine_passes": 1},
                 "quality": {"refine_passes": 4}}
_PRESETS_PIPE = {"fast": {}, "balanced": {"refine_passes": 1},
                 "quality": {"refine_passes": 4, "pipeline_depth": 1}}

# method -> one-line description, the documented worst-case max - min
# partition-size gap as a callable of (n, k), the knobs: ``params`` (the
# port's dataclass; ``method_knobs`` derives the knobs from its fields
# minus ``seed`` and ``knob_exclude``) or a hand-kept ``knobs`` tuple,
# ``presets``, and for a method the port does not serve yet ``pending``,
# the ROADMAP.md item (queue 1) that brings it. The slacks are the JAX
# package's; the descriptions say what the port runs.
METHOD_INFO: Dict[str, dict] = {
    "hype": {
        "desc": "paper-faithful numpy HYPE: heap + per-vertex growth "
                "steps (fidelity reference, ablations)",
        "balance_slack": lambda n, k: 1,
        "params": HypeParams,
    },
    "hype_batched": {
        "desc": "batched-candidate HYPE: host growth, candidate tiles "
                "scored by the hype_scores kernel (bit-stable "
                "throughput default)",
        "balance_slack": lambda n, k: 1,
        "params": BatchedParams,
        "presets": _PRESETS_HOST,
    },
    "hype_jax": {
        "desc": "sequential HYPE on dense padded arrays held on the "
                "device, one vertex a loop iteration, random draws bit "
                "for bit JAX's threefry (on-device validation, small n)",
        "balance_slack": lambda n, k: 1,
    },
    "hype_parallel": {
        "desc": "parallel k-way growth on dense padded arrays: all k "
                "cores take a vertex a step, collisions to the smaller "
                "core (paper §VI future work; validation scale)",
        "balance_slack": lambda n, k: 1,
    },
    "hype_superstep": {
        "desc": "device-resident HYPE: supersteps of the fused "
                "hype_score_select kernel grow all k phases concurrently "
                "on a double-buffered pipeline (large-k choice; "
                "pipeline_depth=1 locks step)",
        "balance_slack": lambda n, k: 1,
        "params": SuperstepParams,
        "presets": _PRESETS_PIPE,
    },
    "hype_device": {
        "desc": "fully device-resident HYPE: the whole growth loop on "
                "the device, one round captured as a CUDA graph and "
                "replayed a chunk at a time; host syncs once per chunk",
        "balance_slack": lambda n, k: 1,
        "params": DeviceParams,
        "presets": _PRESETS_HOST,
    },
    "hype_sharded": {
        "desc": "sharded superstep HYPE: phase groups sharded over the "
                "ranks of a torch.distributed group, one all_gather per "
                "pipelined superstep",
        "balance_slack": lambda n, k: 1,
        "params": ShardedParams,
        "presets": _PRESETS_PIPE,
    },
    "hype_stream": {
        "desc": "single-pass streaming HYPE: micro-batched arrivals "
                "scored against the partition fringes (row 1) and "
                "committed in order against a partition sketch by the "
                "stream_commit kernel, with a FREIGHT-style balance "
                "penalty; apply_updates changes the assignment "
                "incrementally",
        # a hard ceil(n/k) capacity cap and no final rebalance: the last
        # arrivals can leave a gap of up to k
        "balance_slack": lambda n, k: k,
        "params": StreamParams,
    },
    "hype_weighted": {
        "desc": "numpy HYPE with degree-weighted balancing (HypeParams"
                "(balance='weighted'))",
        "balance_slack": lambda n, k: n,    # balances weight, not counts
        "params": HypeParams,
        "knob_exclude": ("balance",),       # pinned to "weighted"
    },
    "minmax_nb": {
        "desc": "streaming MinMax, vertex-balanced variant (HYPE paper "
                "footnote 2: slack of up to 100 vertices)",
        "balance_slack": lambda n, k: 101,  # slack + the vertex placed
        "knobs": ("slack",),
    },
    "minmax_eb": {
        "desc": "streaming MinMax, hyperedge-balanced original "
                "(Alistarh et al., NIPS'15); vertex counts may skew",
        "balance_slack": lambda n, k: n,    # balances edges, not vertices
    },
    "shp": {
        "desc": "Social-Hash-style iterative balanced swaps from a "
                "random start (Kabiljo et al., VLDB'17)",
        "balance_slack": lambda n, k: 1,    # swaps preserve random init
        "knobs": ("iters", "swap_frac"),
    },
    "multilevel": {
        "desc": "coarsen + recursive bisection + FM refinement "
                "(group (I) baseline); ~5% bisection tolerance",
        "balance_slack": lambda n, k: max(1, int(0.35 * (n / k)) + k),
    },
    "hype_multilevel": {
        "desc": "direct k-way multilevel: coarsen + hype_superstep "
                "initial partition + uncoarsening passes of the "
                "kway_gains refinement",
        "balance_slack": lambda n, k: 1,
        "knobs": ("refine_passes", "coarsest"),
    },
    "random": {
        "desc": "balanced random assignment (quality lower bound)",
        "balance_slack": lambda n, k: 1,
    },
    "hashing": {
        "desc": "deterministic multiplicative hashing (what production "
                "systems default to); only statistically balanced",
        "balance_slack": lambda n, k: n,
    },
}

# the card engines: method -> (params dataclass, runner)
_ENGINES = {"hype_batched": (BatchedParams, hype_batched_partition),
            "hype_superstep": (SuperstepParams, hype_superstep_partition),
            "hype_device": (DeviceParams, hype_device_partition),
            "hype_sharded": (ShardedParams, hype_sharded_partition)}

PENDING = {name: info["pending"] for name, info in METHOD_INFO.items()
           if "pending" in info}
METHODS = tuple(name for name in METHOD_INFO if name not in PENDING)
PRESETS = {name: info["presets"] for name, info in METHOD_INFO.items()
           if "presets" in info and name not in PENDING}

# Method-independent knobs ``partition()`` consumes itself, name ->
# default (the JAX package's): above ``auto_validate_max_n`` vertices
# ``validate="auto"`` skips the O(pins) invariant sweep.
PARTITION_KNOBS: Dict[str, object] = {
    "auto_validate_max_n": 1_000_000,
}


def _pending(method: str) -> NotImplementedError:
    return NotImplementedError(
        f"method {method!r} is not ported to torch yet; see ROADMAP.md, "
        f"queue 1: {PENDING[method]}")


def describe_methods() -> Dict[str, str]:
    """One-line description per registered method, keyed like JAX's
    ``METHODS`` (all sixteen, the pending ones included)."""
    return {name: info["desc"] for name, info in METHOD_INFO.items()}


def method_knobs(method: str) -> tuple:
    """Engine-specific keyword knobs ``partition()`` forwards.

    Derived from the method's params dataclass (minus ``seed`` and its
    ``knob_exclude`` names) or its hand-kept ``knobs`` tuple; empty for
    methods whose only knob is ``seed``. A pending method raises
    ``NotImplementedError`` naming its ROADMAP.md item.
    """
    if method in PENDING:
        raise _pending(method)
    info = METHOD_INFO[method]
    cls = info.get("params")
    if cls is None:
        return tuple(info.get("knobs", ()))
    hidden = {"seed"} | set(info.get("knob_exclude", ()))
    return tuple(f.name for f in dataclasses.fields(cls)
                 if f.name not in hidden)


def method_presets(method: str) -> Dict[str, dict]:
    """The ``preset`` vocabulary ``partition()`` accepts for ``method``:
    preset name -> the knob defaults it folds in (empty without)."""
    return {name: dict(knobs) for name, knobs
            in METHOD_INFO[method].get("presets", {}).items()}


def balance_slack(method: str, n: int, k: int) -> int:
    """Documented worst-case ``max - min`` partition-size gap."""
    return int(METHOD_INFO[method]["balance_slack"](n, k))


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; without one, say how to ask for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port on the CPU")
        device = "cuda"
    return torch.device(device)


def _resolve_validate(hg: Hypergraph, validate,
                      auto_validate_max_n: int) -> bool:
    if validate == "auto":
        return hg.n < int(auto_validate_max_n)
    if not isinstance(validate, bool):
        raise ValueError(
            f"validate must be 'auto' or a bool, got {validate!r}")
    return validate


def _resolve_preset(method: str, preset: Optional[str], kw: dict) -> dict:
    """Fold ``preset`` defaults under the explicit knobs in ``kw``."""
    if preset is None:
        return kw
    presets = PRESETS.get(method)
    if not presets:
        raise ValueError(f"method {method!r} does not support presets")
    if preset not in presets:
        raise ValueError(
            f"unknown preset {preset!r} for method {method!r}; "
            f"choose from {tuple(presets)}")
    return {**presets[preset], **kw}


def partition(hg: Hypergraph, k: int, method: str = "hype", *,
              device=None, seed: int = 0, preset: Optional[str] = None,
              validate="auto", auto_validate_max_n: int = 1_000_000,
              **knobs) -> np.ndarray:
    """Partition ``hg`` into ``k`` parts; returns an int32 assignment.

    ``method`` defaults to ``"hype"``, as in the JAX package.
    ``device`` is ``None`` (the card), ``"cuda"`` or ``"cpu"``. ``seed``,
    ``preset``, ``validate`` and ``auto_validate_max_n`` mean what they
    mean in ``repro.core.partition_api.partition``: ``preset`` is
    ``"fast"``, ``"balanced"`` or ``"quality"`` on ``hype_batched``,
    ``hype_superstep``, ``hype_device`` and ``hype_sharded`` (explicit
    knobs win) and a ``ValueError`` on the other methods. ``knobs`` go
    to ``BatchedParams``, ``SuperstepParams``, ``DeviceParams``,
    ``ShardedParams`` (``hype_sharded``, over the default process group
    when one is initialised: call it on every rank) or ``StreamParams``
    (``hype_stream``), are ``s``/``r`` of ``hype_jax`` and ``candidates``
    of ``hype_parallel`` (as in JAX, unregistered: ``method_knobs`` is
    empty for both), are
    ``refine_passes`` and ``coarsest`` of ``hype_multilevel``, go to
    ``HypeParams`` for ``hype`` and ``hype_weighted`` (which pins
    ``balance="weighted"``), or are ``slack`` of ``minmax_nb`` and
    ``iters``/``swap_frac`` of ``shp``. The host methods (``hype``,
    ``hype_weighted``, ``multilevel``, the MinMax, SHP, random and
    hashing baselines) are numpy on any ``device``. A method or knob of
    a feature the port does not have yet raises ``NotImplementedError``
    naming its ROADMAP.md item.
    """
    if method in PENDING:
        raise _pending(method)
    if method not in METHODS:
        raise ValueError(
            f"unknown method {method!r}; choose from {METHODS}")
    dev = resolve_device(device)
    if _resolve_validate(hg, validate, auto_validate_max_n):
        hg.validate()
    knobs = _resolve_preset(method, preset, knobs)
    if method in _ENGINES:
        params_cls, runner = _ENGINES[method]
        return runner(hg, k, params_cls(seed=seed, **knobs), device=dev)
    if method == "hype_multilevel":
        return hype_multilevel_partition(hg, k, seed=seed, device=dev,
                                         **knobs)
    if method == "hype_stream":
        return hype_stream_partition(hg, k, StreamParams(seed=seed, **knobs),
                                     device=dev)
    if method == "hype_jax":
        return hype_jax_partition(hg, k, seed=seed, device=dev, **knobs)
    if method == "hype_parallel":
        return hype_parallel_partition(hg, k, seed=seed, device=dev,
                                       **knobs)
    if method == "hype":
        return hype_partition(hg, k, HypeParams(seed=seed, **knobs))
    if method == "hype_weighted":
        return hype_partition(hg, k, HypeParams(seed=seed,
                                                balance="weighted", **knobs))
    if method == "minmax_nb":
        return minmax_partition(hg, k, mode="nb", seed=seed, **knobs)
    if method == "minmax_eb":
        return minmax_partition(hg, k, mode="eb", seed=seed, **knobs)
    if method == "shp":
        return shp_partition(hg, k, seed=seed, **knobs)
    if method == "random":
        return random_partition(hg, k, seed=seed)
    if method == "hashing":
        return hashing_partition(hg, k)
    return multilevel_partition(hg, k, seed=seed, **knobs)


def partition_and_report(hg: Hypergraph, k: int, method: str = "hype", *,
                         device=None, seed: int = 0,
                         preset: Optional[str] = None, validate="auto",
                         **knobs) -> Tuple[dict, np.ndarray]:
    """Partition and measure: returns ``(report, assignment)``.

    Parameters are ``partition``'s. ``report`` is
    ``metrics.all_metrics`` plus ``method``, ``k`` and ``runtime_s``
    (the wall time of the ``partition`` call).
    """
    t0 = time.perf_counter()
    assignment = partition(hg, k, method, device=device, seed=seed,
                           preset=preset, validate=validate, **knobs)
    dt = time.perf_counter() - t0
    rep = metrics.all_metrics(hg, assignment, k)
    rep.update(method=method, k=k, runtime_s=dt)
    return rep, assignment


# ----------------------------------------------------- degradation ladder

# Each engine's fallback when it raises UnrecoverableFault: shed one
# capability a rung (the mesh or the device loop -> the host-driven
# pipeline on one device -> host tiles -> pure numpy). The rungs above ``hype`` keep the caller's
# device; only the last one has none, so the ladder always ends.
_LADDER = {
    "hype_device": "hype_superstep",
    "hype_sharded": "hype_superstep",
    "hype_superstep": "hype_batched",
    "hype_batched": "hype",
}

def _run_rung(hg: Hypergraph, k: int, method: str, seed: int, resume,
              snapshot_dir, snapshot_every: int, keep_last: int, plan,
              kw: dict, dev):
    """One ladder rung: run ``method``; returns ``(assignment, stats)``.

    ``kw`` is filtered down to the rung's registered knobs, so a knob of
    a rung above survives the hop to one that lacks it.
    """
    knobs = set(method_knobs(method))
    sub = {key: val for key, val in kw.items() if key in knobs}
    if method == "hype":
        warm = None
        if resume:
            ckpt = resilience.load_latest(resume)
            if ckpt is not None:
                resilience.check_checkpoint(ckpt, hg, k)
                warm = resilience.warm_assignment(ckpt)
        return hype_partition(hg, k, HypeParams(seed=seed, **sub),
                              return_stats=True, warm_start=warm)
    params_cls, runner = _ENGINES[method]
    sub.update(snapshot_every=snapshot_every, snapshot_dir=snapshot_dir,
               keep_last=keep_last, resume=resume, fault_plan=plan)
    return runner(hg, k, params_cls(seed=seed, **sub), return_stats=True,
                  device=dev)


def partition_resilient(hg: Hypergraph, k: int,
                        method: str = "hype_sharded", *,
                        device=None, seed: int = 0,
                        snapshot_dir: Optional[str] = None,
                        snapshot_every: int = 0,
                        keep_last: int = 3,
                        resume: Optional[str] = None,
                        fault_plan=None,
                        validate="auto",
                        auto_validate_max_n: int = 1_000_000,
                        **kw) -> Tuple[np.ndarray, dict]:
    """Partition with retries, snapshots and the degradation ladder.

    Runs ``method``; when the engine raises ``UnrecoverableFault`` (a
    fatal injected fault, an exhausted retry budget, a superstep that an
    injected ``nan`` poisoned still poisoned after its replay) it falls
    back one rung at a time, ``hype_sharded`` (or ``hype_device``) ``->
    hype_superstep -> hype_batched -> hype``, each
    fallback resuming from the last snapshot in ``snapshot_dir`` (another
    engine's snapshot warm-starts from its assignment; ``hype`` adopts it
    through ``warm_start=``). Injected transient faults are retried
    inside each engine, and a device OOM walks the engine's memory rungs
    first: the ladder takes over only when they are exhausted. Any other
    real exception propagates as itself. The
    default ``method`` is the JAX package's, ``hype_sharded``; a knob of
    a rung above, such as its ``devices``, is dropped on the way down.

    ``snapshot_every > 0`` needs ``snapshot_dir``. ``fault_plan`` (a
    ``FaultPlan``, a spec string, or None for ``REPRO_FAULT_PLAN``) is
    resolved once and shared across rungs, so a consumed fault does not
    fire again after a fallback. ``device`` is ``partition``'s; ``**kw``
    are engine knobs, filtered per rung.

    Returns ``(assignment, report)``: the quality metrics plus ``method``
    (the rung that finished), ``requested_method``, ``degraded_from``
    (one ``{"method", "error"}`` record per abandoned rung),
    ``fallbacks`` and the finishing engine's ``stats``.
    """
    if method in PENDING:
        raise _pending(method)
    if method not in ("hype", *_LADDER):
        raise ValueError(
            f"unknown resilient method {method!r}; choose from "
            f"{('hype', *_LADDER)}")
    dev = resolve_device(device)
    if _resolve_validate(hg, validate, auto_validate_max_n):
        hg.validate()
    plan = resilience.resolve_fault_plan(fault_plan)
    t0 = time.perf_counter()
    attempted = []
    cur = method
    while True:
        try:
            assignment, stats = _run_rung(
                hg, k, cur, seed, resume, snapshot_dir, snapshot_every,
                keep_last, plan, kw, dev)
            break
        except UnrecoverableFault as e:
            nxt = _LADDER.get(cur)
            if nxt is None:
                raise
            attempted.append({"method": cur, "error": str(e)})
            cur = nxt
            # a fallback resumes from what the failed rung last
            # published; with no snapshot_dir it starts cold
            resume = snapshot_dir
    dt = time.perf_counter() - t0
    if hasattr(stats, "fallbacks"):
        stats.fallbacks = len(attempted)
    rep = metrics.all_metrics(hg, assignment, k)
    rep.update(method=cur, requested_method=method, k=k, runtime_s=dt,
               degraded_from=attempted, fallbacks=len(attempted),
               stats=stats)
    return assignment, rep
