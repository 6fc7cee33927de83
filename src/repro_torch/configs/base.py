"""ArchDef: the uniform interface of an architecture config, as in
``src/repro/configs/base.py``.

An ArchDef carries:
  * ``build_cfg(reduced)``            -- model config (the public
    source's numbers, or a tiny same-family config for CPU tests);
  * ``shapes``                        -- shape-name -> ShapeSpec;
  * ``input_specs(shape, reduced)``   -- ``(shape, torch dtype)`` of
    every model input, where the JAX package gives a
    ``jax.ShapeDtypeStruct``;
  * ``step_kind(shape)``              -- train | prefill | decode | serve
    | retrieve;
  * ``skip(shape)``                   -- reason string if the
    (arch, shape) cell is skipped.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping


def spec(shape, dtype):
    """``(shape, dtype)`` of one input: the port's ShapeDtypeStruct."""
    return tuple(int(x) for x in shape), dtype


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                      # train|prefill|decode|serve|retrieve
    meta: Mapping                  # family-specific numbers


@dataclasses.dataclass(frozen=True)
class ArchDef:
    arch_id: str
    family: str                    # lm | gnn | recsys
    build_cfg: Callable            # (reduced) -> model config
    shapes: Mapping[str, ShapeSpec]
    input_specs: Callable          # (shape_name, reduced) -> dict of specs
    skip: Callable = lambda shape: None
    accum_steps: Mapping[str, int] = dataclasses.field(default_factory=dict)
    notes: str = ""

    def step_kind(self, shape: str) -> str:
        return self.shapes[shape].kind


def round_up(x: int, mult: int) -> int:
    return int(math.ceil(x / mult) * mult)
