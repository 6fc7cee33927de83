"""two-tower-retrieval [recsys] embed_dim=256 tower_mlp=1024-512-256
interaction=dot -- sampled-softmax retrieval [RecSys'19 (YouTube);
unverified]. The numbers are those of
``src/repro/configs/two_tower_retrieval.py``.

Shapes:
  train_batch     batch=65,536               (training)
  serve_p99       batch=512                  (online inference)
  serve_bulk      batch=262,144              (offline scoring)
  retrieval_cand  batch=1 n_cand=1,048,576   (retrieval scoring)
"""
from __future__ import annotations

import torch

from ..models.recsys import TwoTowerConfig
from .base import ArchDef, ShapeSpec, spec

SHAPES = {
    "train_batch": ShapeSpec("train_batch", "train", {"batch": 65_536}),
    "serve_p99": ShapeSpec("serve_p99", "serve", {"batch": 512}),
    "serve_bulk": ShapeSpec("serve_bulk", "serve", {"batch": 262_144}),
    "retrieval_cand": ShapeSpec("retrieval_cand", "retrieve",
                                {"batch": 1, "n_cand": 1_048_576}),
}

_FULL = dict(embed_dim=256, tower_dims=(1024, 512, 256), n_fields=4,
             bag_size=8, user_vocab=16_777_216, item_vocab=16_777_216)
_RED = dict(embed_dim=16, tower_dims=(64, 32, 16), n_fields=4, bag_size=4,
            user_vocab=1024, item_vocab=1024)


def build_cfg(reduced: bool = False) -> TwoTowerConfig:
    return TwoTowerConfig(name="two-tower-retrieval",
                          **(_RED if reduced else _FULL))


def input_specs(shape_name: str, reduced: bool = False):
    cfg = build_cfg(reduced)
    meta = SHAPES[shape_name].meta
    B = 32 if reduced else meta["batch"]
    ids = (B, cfg.n_fields, cfg.bag_size)
    if shape_name == "train_batch":
        return {"user_ids": spec(ids, torch.int32),
                "item_ids": spec(ids, torch.int32),
                "item_logq": spec((B,), torch.float32)}
    if shape_name in ("serve_p99", "serve_bulk"):
        return {"user_ids": spec(ids, torch.int32),
                "item_ids": spec(ids, torch.int32)}
    n_cand = 2048 if reduced else meta["n_cand"]
    return {"user_ids": spec(ids, torch.int32),
            "cand_embs": spec((n_cand, cfg.tower_dims[-1]), torch.float32)}


ARCH = ArchDef(arch_id="two-tower-retrieval", family="recsys",
               build_cfg=build_cfg, shapes=SHAPES, input_specs=input_specs,
               notes="embedding tables are the HYPE placement target")
