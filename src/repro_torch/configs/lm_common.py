"""Shared config code of the five LM architectures, as
``src/repro/configs/lm_common.py`` has them (same numbers, reduced
configs and input specs). The reduced config of an MoE arch keeps at
most 4 experts and top-2.

LM shape set:
  train_4k      seq 4,096   global_batch 256    (training)
  prefill_32k   seq 32,768  global_batch 32     (inference prefill)
  decode_32k    seq 32,768  global_batch 128    (one-token decode vs cache)
  long_500k     seq 524,288 global_batch 1      (long-context decode;
                 only a sliding-window arch runs it)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models.moe import MoEConfig
from ..models.transformer import TransformerConfig
from .base import ArchDef, ShapeSpec, spec

LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train",
                          {"seq": 4096, "batch": 256}),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill",
                             {"seq": 32768, "batch": 32}),
    "decode_32k": ShapeSpec("decode_32k", "decode",
                            {"seq": 32768, "batch": 128}),
    "long_500k": ShapeSpec("long_500k", "decode",
                           {"seq": 524288, "batch": 1}),
}


def _decode_specs(cfg: TransformerConfig, B: int, Skv: int) -> dict:
    cache = (cfg.n_layers, B, Skv, cfg.n_kv_heads, cfg.d_head)
    return {"tokens": spec((B, 1), torch.int32),
            "cache_k": spec(cache, cfg.dtype),
            "cache_v": spec(cache, cfg.dtype),
            "cache_pos": spec((), torch.int32)}


def lm_input_specs(cfg: TransformerConfig, shape_name: str, accum: int):
    meta = LM_SHAPES[shape_name].meta
    B, S = meta["batch"], meta["seq"]
    if shape_name == "train_4k":
        mb = B // accum
        return {"tokens": spec((accum, mb, S), torch.int32),
                "labels": spec((accum, mb, S), torch.int32)}
    if shape_name == "prefill_32k":
        return {"tokens": spec((B, S), torch.int32)}
    # decode shapes: one new token against a seq-length cache
    return _decode_specs(cfg, B, min(S, cfg.window) if cfg.window else S)


def make_lm_arch(arch_id: str, *, n_layers: int, d_model: int, n_heads: int,
                 n_kv_heads: int, d_ff: int, vocab: int, qk_norm: bool = False,
                 window: Optional[int] = None, moe: Optional[MoEConfig] = None,
                 rope_theta: float = 500_000.0,
                 accum_steps: Optional[dict] = None,
                 notes: str = "") -> ArchDef:
    d_head = d_model // n_heads
    accum_steps = accum_steps or {"train_4k": 2}

    def build_cfg(reduced: bool = False) -> TransformerConfig:
        kw = dict(name=arch_id, qk_norm=qk_norm, rope_theta=rope_theta)
        if reduced:
            r_moe = None if moe is None else dataclasses.replace(
                moe, n_experts=min(moe.n_experts, 4),
                top_k=min(moe.top_k, 2))
            return TransformerConfig(
                n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=max(1, 4 * n_kv_heads // n_heads),
                d_head=16, d_ff=128, vocab=512,
                window=(16 if window else None), moe=r_moe, remat=False,
                **kw)
        return TransformerConfig(
            n_layers=n_layers, d_model=d_model, n_heads=n_heads,
            n_kv_heads=n_kv_heads, d_head=d_head, d_ff=d_ff, vocab=vocab,
            window=window, moe=moe, **kw)

    def input_specs(shape_name: str, reduced: bool = False):
        cfg = build_cfg(reduced)
        if reduced:
            # tiny shapes for CPU smoke tests
            table = {
                "train_4k": {"tokens": spec((2, 2, 32), torch.int32),
                             "labels": spec((2, 2, 32), torch.int32)},
                "prefill_32k": {"tokens": spec((2, 64), torch.int32)},
                "decode_32k": _decode_specs(cfg, 2, min(64, cfg.window or 64)),
            }
            table["long_500k"] = table["decode_32k"]
            return table[shape_name]
        return lm_input_specs(cfg, shape_name,
                              accum_steps.get(shape_name, 1))

    def skip(shape_name: str):
        if shape_name == "long_500k" and window is None:
            return ("full quadratic attention at 524k context is "
                    "infeasible (O(S^2) scores); arch has no sub-quadratic "
                    "mode — skipped per assignment note, see DESIGN.md")
        return None

    return ArchDef(arch_id=arch_id, family="lm", build_cfg=build_cfg,
                   shapes=LM_SHAPES, input_specs=input_specs, skip=skip,
                   accum_steps=accum_steps, notes=notes)
