"""The port's entry point: ``partition(hg, k, method)``.

It runs on the card unless the caller passes ``device="cpu"``; with no
card and no ``device`` it raises instead of falling back. ``METHODS``
holds the methods the port serves; ``PENDING`` maps every other method
of the JAX package's registry to the ROADMAP.md item that brings it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .core.hype import HypeParams, hype_partition
from .core.hypergraph import Hypergraph
from .core.multilevel import hype_multilevel_partition, multilevel_partition
from .engines.batched import BatchedParams, hype_batched_partition
from .engines.device import DeviceParams, hype_device_partition
from .engines.superstep import SuperstepParams, hype_superstep_partition

METHODS = ("hype_batched", "hype_superstep", "hype_device",
           "hype_multilevel", "multilevel", "hype", "hype_weighted")

_HOST = "host-only methods (numpy copies)"
PENDING = {
    "minmax_nb": _HOST,
    "minmax_eb": _HOST,
    "shp": _HOST,
    "random": _HOST,
    "hashing": _HOST,
    "hype_sharded": "hype_sharded",
    "hype_stream": "hype_stream",
    "hype_jax": "hype_jax and hype_parallel",
    "hype_parallel": "hype_jax and hype_parallel",
}

# preset -> the knob defaults it folds in under the explicit knobs, as
# in the JAX package's registry. The pipelined engine also pins the
# lock-step schedule at ``quality``.
_PRESETS_HOST = {"fast": {}, "balanced": {"refine_passes": 1},
                 "quality": {"refine_passes": 4}}
_PRESETS_PIPE = {"fast": {}, "balanced": {"refine_passes": 1},
                 "quality": {"refine_passes": 4, "pipeline_depth": 1}}
PRESETS = {"hype_batched": _PRESETS_HOST, "hype_superstep": _PRESETS_PIPE,
           "hype_device": _PRESETS_HOST}


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; without one, say how to ask for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port on the CPU")
        device = "cuda"
    return torch.device(device)


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
    ``hype_superstep`` and ``hype_device`` (explicit knobs win) and a
    ``ValueError`` on the other methods. ``knobs`` go to
    ``BatchedParams``, ``SuperstepParams`` or ``DeviceParams``, are
    ``refine_passes`` and ``coarsest`` of
    ``hype_multilevel``, or go to ``HypeParams`` for ``hype`` and
    ``hype_weighted`` (the host partitioner, numpy on any ``device``;
    ``hype_weighted`` pins ``balance="weighted"``). A method or knob of
    a feature the port does not have yet raises ``NotImplementedError``
    naming its ROADMAP.md item.
    """
    if method in PENDING:
        raise NotImplementedError(
            f"method {method!r} is not ported to torch yet; see "
            f"ROADMAP.md, queue 1: {PENDING[method]}")
    if method not in METHODS:
        raise ValueError(
            f"unknown method {method!r}; choose from {METHODS}")
    dev = resolve_device(device)
    if validate == "auto":
        validate = hg.n < int(auto_validate_max_n)
    elif not isinstance(validate, bool):
        raise ValueError(
            f"validate must be 'auto' or a bool, got {validate!r}")
    if validate:
        hg.validate()
    knobs = _resolve_preset(method, preset, knobs)
    if method == "hype_batched":
        return hype_batched_partition(
            hg, k, BatchedParams(seed=seed, **knobs), device=dev)
    if method == "hype_superstep":
        return hype_superstep_partition(
            hg, k, SuperstepParams(seed=seed, **knobs), device=dev)
    if method == "hype_device":
        return hype_device_partition(
            hg, k, DeviceParams(seed=seed, **knobs), device=dev)
    if method == "hype_multilevel":
        return hype_multilevel_partition(hg, k, seed=seed, device=dev,
                                         **knobs)
    if method == "hype":
        return hype_partition(hg, k, HypeParams(seed=seed, **knobs))
    if method == "hype_weighted":
        return hype_partition(hg, k, HypeParams(seed=seed,
                                                balance="weighted", **knobs))
    return multilevel_partition(hg, k, seed=seed, **knobs)
