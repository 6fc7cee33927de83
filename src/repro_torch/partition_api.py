"""The port's entry point: ``partition(hg, k, "hype_superstep")``.

It runs on the card unless the caller passes ``device="cpu"``; with no
card and no ``device`` it raises instead of falling back. ``METHODS``
holds the methods the port serves; ``PENDING`` maps every other method
of the JAX package's registry to the ROADMAP.md item that brings it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .core.hypergraph import Hypergraph
from .engines.superstep import SuperstepParams, hype_superstep_partition

METHODS = ("hype_superstep",)

_HOST = "host-only methods (numpy copies)"
PENDING = {
    "hype": _HOST,
    "hype_weighted": _HOST,
    "minmax_nb": _HOST,
    "minmax_eb": _HOST,
    "shp": _HOST,
    "multilevel": _HOST,
    "random": _HOST,
    "hashing": _HOST,
    "hype_batched": "hype_batched",
    "hype_multilevel": "refinement, hype_multilevel and preset='quality'",
    "hype_device": "hype_device",
    "hype_sharded": "hype_sharded",
    "hype_stream": "hype_stream",
    "hype_jax": "hype_jax and hype_parallel",
    "hype_parallel": "hype_jax and hype_parallel",
}


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; without one, say how to ask for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port on the CPU")
        device = "cuda"
    return torch.device(device)


def partition(hg: Hypergraph, k: int, method: str = "hype_superstep", *,
              device=None, seed: int = 0, preset: Optional[str] = None,
              validate="auto", auto_validate_max_n: int = 1_000_000,
              **knobs) -> np.ndarray:
    """Partition ``hg`` into ``k`` parts; returns an int32 assignment.

    ``device`` is ``None`` (the card), ``"cuda"`` or ``"cpu"``. ``seed``,
    ``validate`` and ``auto_validate_max_n`` mean what they mean in
    ``repro.core.partition_api.partition``; ``knobs`` go to
    ``SuperstepParams``. ``preset`` may be ``None`` or ``"fast"`` (the
    engine's own defaults). A method or knob of a feature the port does
    not have yet raises ``NotImplementedError`` naming its ROADMAP.md
    item.
    """
    if method in PENDING:
        raise NotImplementedError(
            f"method {method!r} is not ported to torch yet; see "
            f"ROADMAP.md, queue 1: {PENDING[method]}")
    if method not in METHODS:
        raise ValueError(
            f"unknown method {method!r}; choose from {METHODS}")
    if preset not in (None, "fast"):
        raise NotImplementedError(
            f"preset {preset!r} needs the refinement post-pass, which the "
            f"torch port does not have yet; see ROADMAP.md, queue 1: "
            f"{PENDING['hype_multilevel']}")
    dev = resolve_device(device)
    if validate == "auto":
        validate = hg.n < int(auto_validate_max_n)
    elif not isinstance(validate, bool):
        raise ValueError(
            f"validate must be 'auto' or a bool, got {validate!r}")
    if validate:
        hg.validate()
    return hype_superstep_partition(hg, k, SuperstepParams(seed=seed,
                                                           **knobs),
                                    device=dev)
