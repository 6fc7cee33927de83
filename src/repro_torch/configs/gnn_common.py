"""Shared builders of the GNN architectures, as
``src/repro/configs/gnn_common.py`` has them (same shapes, reduced
config and input specs).

GNN shape set (assigned; identical across the four archs):
  full_graph_sm  n=2,708 e=10,556 d_feat=1,433      (full-batch, cora)
  minibatch_lg   n=232,965 e=114,615,892 batch=1,024 fanout 15-10
                 (the 114M-edge graph lives host-side in the sampler; the
                  step consumes the *sampled* padded subgraph)
  ogb_products   n=2,449,029 e=61,859,140 d_feat=100 (full-batch-large)
  molecule       n=30 e=64 batch=128                 (batched small graphs)

Node/edge counts are padded up to multiples of 512 so every mesh shards
them evenly.
"""
from __future__ import annotations

import torch

from ..models.gnn import GNNConfig
from .base import ArchDef, ShapeSpec, round_up, spec

# sampled-subgraph sizing for minibatch_lg: 1024 seeds, fanout 15 then 10
# (the JAX package's comments; round_up gives 169,984 and 168,960)
_MB_SEEDS = 1024
_MB_NODES = round_up(_MB_SEEDS * (1 + 15 + 15 * 10), 512)      # 170,496
_MB_EDGES = round_up(_MB_SEEDS * (15 + 15 * 10), 512)          # 169,472

GNN_SHAPES = {
    "full_graph_sm": ShapeSpec("full_graph_sm", "train", {
        "nodes": round_up(2708, 512), "edges": round_up(10556, 512),
        "d_feat": 1433, "n_classes": 7, "task": "node_class"}),
    "minibatch_lg": ShapeSpec("minibatch_lg", "train", {
        "nodes": _MB_NODES, "edges": _MB_EDGES,
        "d_feat": 602, "n_classes": 41, "task": "node_class",
        "graph_nodes": 232_965, "graph_edges": 114_615_892,
        "fanout": (15, 10), "batch_nodes": _MB_SEEDS}),
    "ogb_products": ShapeSpec("ogb_products", "train", {
        "nodes": round_up(2_449_029, 512), "edges": round_up(61_859_140, 512),
        "d_feat": 100, "n_classes": 47, "task": "node_class"}),
    "molecule": ShapeSpec("molecule", "train", {
        "nodes": round_up(30 * 128, 512), "edges": round_up(64 * 128, 512),
        "d_feat": 16, "n_classes": 2, "task": "graph_reg",
        "n_graphs": 128}),
}

_REDUCED = {"nodes": 256, "edges": 512, "d_feat": 24, "n_classes": 5,
            "task": "node_class", "n_graphs": 8}


def gnn_batch_specs(meta: dict, d_edge: int = 4) -> dict:
    N, E = meta["nodes"], meta["edges"]
    return {
        "nodes": spec((N, meta["d_feat"]), torch.float32),
        "pos": spec((N, 3), torch.float32),
        "edge_src": spec((E,), torch.int32),
        "edge_dst": spec((E,), torch.int32),
        "edge_x": spec((E, d_edge), torch.float32),
        "node_mask": spec((N,), torch.bool),
        "edge_mask": spec((E,), torch.bool),
        "graph_id": spec((N,), torch.int32),
        "labels": spec((N,), torch.int32),
        "targets": spec((N, meta["d_feat"]), torch.float32),
        "graph_targets": spec((max(meta.get("n_graphs", 1), 1),),
                              torch.float32),
    }


def make_gnn_arch(arch_id: str, *, arch: str, n_layers: int, d_hidden: int,
                  aggregator: str = "sum", mlp_layers: int = 2,
                  rbf: int = 300, cutoff: float = 10.0,
                  notes: str = "") -> ArchDef:

    def build_cfg(reduced: bool = False,
                  shape: str = "full_graph_sm") -> GNNConfig:
        meta = _REDUCED if reduced else GNN_SHAPES[shape].meta
        return GNNConfig(
            name=arch_id, arch=arch,
            n_layers=2 if reduced else n_layers,
            d_hidden=16 if reduced else d_hidden,
            d_in=meta["d_feat"], d_edge_in=4,
            n_classes=meta["n_classes"],
            aggregator=aggregator, mlp_layers=mlp_layers,
            rbf=16 if reduced else rbf, cutoff=cutoff,
            task=meta["task"])

    def input_specs(shape_name: str, reduced: bool = False) -> dict:
        meta = _REDUCED if reduced else GNN_SHAPES[shape_name].meta
        return gnn_batch_specs(meta)

    return ArchDef(arch_id=arch_id, family="gnn", build_cfg=build_cfg,
                   shapes=GNN_SHAPES, input_specs=input_specs, notes=notes)
