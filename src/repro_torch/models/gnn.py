"""GNN architectures: the GraphSAGE training path.

The counterpart of ``src/repro/models/gnn.py``. Every arch consumes a
``GraphBatch`` dict of statically-shaped tensors:

  nodes     (N, F)  float   node features
  pos       (N, 3)  float   positions (SchNet; zeros elsewhere)
  edge_src  (E,)    int32   source node per edge
  edge_dst  (E,)    int32   destination node per edge
  edge_x    (E, Fe) float   edge features
  node_mask (N,)    bool    valid nodes (padding = False)
  edge_mask (E,)    bool    valid edges
  graph_id  (N,)    int32   component id (batched small graphs; else zeros)
  labels    (N,) or (G,)    targets

Padding edges point at node 0 with ``edge_mask`` False. The JAX
GraphSAGE layer aggregates with ``segment_sum`` over the edge list; here
each layer's mean and projection go through ``kernels/neighbor_agg``
(the hand-written CUDA kernel on the card, its plain version on the
CPU) over a padded in-neighbour matrix that ``in_neighbors`` builds on
the device once per forward. The JAX mean divides by every edge into a
node, padding edges included, whose messages are zero
(``_segment_agg(..., "mean")``); the kernel counts the valid slots only,
so each row is scaled by ``max(valid, 1) / max(all, 1)`` after it: 1
exactly on every row but the padding edges' target, node 0.

Params are the JAX package's nested dicts, bfloat16 as ``mlp_init``
draws them, against float32 activations (``GNNConfig.dtype``): the
products run in float32 as in JAX (``common.mlp_apply``), and a bfloat16
param's gradient is its float32 gradient rounded to bfloat16, as JAX's
cotangent is. gatedgcn, meshgraphnet and schnet raise
``NotImplementedError`` naming their ROADMAP.md item.
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs import PENDING_FULL_BATCH, PENDING_GNN_ARCHS
from ..kernels.neighbor_agg.ops import SlotIndex, chunk_units, neighbor_agg
from .common import (DEFAULT_DTYPE, mlp_apply, mlp_init,
                     softmax_cross_entropy)

ARCHS = ("gatedgcn", "meshgraphnet", "schnet", "graphsage")
TASKS = ("node_class", "node_reg", "graph_reg")
# int32 slot offsets of the neighbour matrix: N * K must stay below this
MAX_SLOTS = 2 ** 31


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    arch: str                       # gatedgcn | meshgraphnet | schnet | graphsage
    n_layers: int
    d_hidden: int
    d_in: int
    d_edge_in: int
    n_classes: int
    aggregator: str = "sum"
    mlp_layers: int = 2             # meshgraphnet MLP depth
    rbf: int = 300                  # schnet radial basis size
    cutoff: float = 10.0
    task: str = "node_class"        # node_class | node_reg | graph_reg
    dtype: torch.dtype = torch.float32


def _check_arch(cfg: GNNConfig) -> None:
    if cfg.arch not in ARCHS:
        raise ValueError(cfg.arch)
    if cfg.arch != "graphsage":
        raise NotImplementedError(
            f"GNN arch {cfg.arch!r} is not ported to torch yet; see "
            f"{PENDING_GNN_ARCHS}")


def _out_dim(cfg: GNNConfig) -> int:
    if cfg.task == "node_class":
        return cfg.n_classes
    return 1 if cfg.task != "node_reg" else cfg.d_in


# ------------------------------------------------------------------ params

def _mlp_dims(cfg: GNNConfig) -> dict:
    d = cfg.d_hidden
    return {"enc_node": [cfg.d_in, d],
            "layers": [{"w_self": [d, d], "w_nbr": [d, d]}
                       for _ in range(cfg.n_layers)],
            "dec": [d, d, _out_dim(cfg)]}


def gnn_param_shapes(cfg: GNNConfig) -> dict:
    """The GraphSAGE param tree with a shape tuple at every leaf."""
    _check_arch(cfg)

    def mlp(dims):
        out = {f"w{i}": (dims[i], dims[i + 1]) for i in range(len(dims) - 1)}
        out.update({f"b{i}": (dims[i + 1],) for i in range(len(dims) - 1)})
        return out

    dims = _mlp_dims(cfg)
    return {"enc_node": mlp(dims["enc_node"]),
            "layers": [{k: mlp(v) for k, v in lp.items()}
                       for lp in dims["layers"]],
            "dec": mlp(dims["dec"])}


def init_gnn_params(gen: torch.Generator, cfg: GNNConfig,
                    device="cpu") -> dict:
    """Random GraphSAGE params on ``device`` in the JAX layout, bfloat16
    as ``mlp_init`` draws them there: ``enc_node`` (d_in -> d), per layer
    ``w_self`` and ``w_nbr`` (d -> d), ``dec`` (d -> d -> out)."""
    _check_arch(cfg)
    dims = _mlp_dims(cfg)

    def mlp(d):
        return mlp_init(gen, d, DEFAULT_DTYPE, device)

    return {"enc_node": mlp(dims["enc_node"]),
            "layers": [{k: mlp(v) for k, v in lp.items()}
                       for lp in dims["layers"]],
            "dec": mlp(dims["dec"])}


# -------------------------------------------------------------- neighbours

def in_neighbors(edge_src: torch.Tensor, edge_dst: torch.Tensor,
                 edge_mask: torch.Tensor, n_nodes: int):
    """The padded in-neighbour matrix of the valid edges, on their device.

    Returns ``(nbrs, scale, index)``: nbrs (n_nodes, K) int32, row v
    holding the sources of the valid edges into v in edge order (a stable
    sort by destination, so duplicate edges stay), -1 past them, with K
    the largest valid in-degree (at least 1); scale (n_nodes,) float32,
    ``max(valid in-degree, 1) / max(in-degree, 1)`` with padding edges
    counted, as the JAX mean counts them; index, the backward's
    ``SlotIndex`` of nbrs, from a second stable sort (by source) of the
    same edges, so both layers' backwards share it (its chunk units
    sized by the E edges, a bound on the valid slots). Reading K syncs
    once. Raises ``NotImplementedError`` when the matrix would pass 2**31
    slots.
    """
    E = edge_dst.shape[0]
    dst = edge_dst.long()
    key = torch.where(edge_mask, dst, n_nodes)      # invalid edges last
    cnt_valid = torch.bincount(key, minlength=n_nodes + 1)[:n_nodes]
    cnt_all = torch.bincount(dst, minlength=n_nodes)[:n_nodes]
    K = max(int(cnt_valid.max()), 1) if n_nodes else 1
    if n_nodes * K >= MAX_SLOTS:
        raise NotImplementedError(
            f"the in-neighbour matrix would hold {n_nodes} x {K} slots, "
            f"past 2**31; see {PENDING_FULL_BATCH}")
    skey, order = torch.sort(key, stable=True)
    start = torch.cumsum(cnt_valid, 0) - cnt_valid  # first slot of each row
    valid = skey < n_nodes
    row = skey.clamp_max(max(n_nodes - 1, 0))
    slot = torch.arange(E, device=key.device) - start[row]
    # invalid edges all land on one spare slot past the matrix
    flat = torch.where(valid, row * K + slot, n_nodes * K)
    nbrs = torch.full((n_nodes * K + 1,), -1, dtype=torch.int32,
                      device=key.device)
    nbrs[flat] = edge_src[order].to(torch.int32)
    scale = (cnt_valid.clamp_min(1).float()
             / cnt_all.clamp_min(1).float())
    # the slots grouped by source in (row, slot) order: the valid edges
    # in slot order, sorted stably by source (invalid edges last)
    skey2 = torch.where(valid, edge_src[order].long(), n_nodes)
    _, by_src = torch.sort(skey2, stable=True)
    rowptr = torch.zeros(n_nodes + 1, dtype=torch.int64, device=key.device)
    torch.cumsum(torch.bincount(skey2, minlength=n_nodes + 1)[:n_nodes], 0,
                 out=rowptr[1:])
    index = SlotIndex(cnt_valid.to(torch.int32), rowptr,
                      row[by_src].to(torch.int32), *chunk_units(rowptr, E))
    return nbrs[:n_nodes * K].view(n_nodes, K), scale, index


# ----------------------------------------------------------------- forward

def gnn_forward(params: dict, batch: dict, cfg: GNNConfig) -> torch.Tensor:
    """Per-node outputs (N, out_dim) (graph tasks pool afterwards)."""
    _check_arch(cfg)
    N = batch["nodes"].shape[0]
    h = mlp_apply(params["enc_node"], batch["nodes"].to(cfg.dtype), 1)
    nbrs, scale, index = in_neighbors(batch["edge_src"], batch["edge_dst"],
                                      batch["edge_mask"], N)
    for lp in params["layers"]:
        nbr = lp["w_nbr"]
        agg = (neighbor_agg(h.contiguous(), nbrs, nbr["w0"], index)
               * scale[:, None].to(h.dtype) + nbr["b0"])
        h = torch.relu(mlp_apply(lp["w_self"], h, 1) + agg)
        h = h / torch.linalg.vector_norm(h, dim=-1,
                                         keepdim=True).clamp_min(1e-6)
    return mlp_apply(params["dec"], h, 2)


def gnn_loss(params: dict, batch: dict, cfg: GNNConfig) -> torch.Tensor:
    if cfg.task not in TASKS:
        raise ValueError(cfg.task)
    out = gnn_forward(params, batch, cfg)
    nmask = batch["node_mask"].float()
    if cfg.task == "node_class":
        return softmax_cross_entropy(out, batch["labels"], mask=nmask)
    if cfg.task == "node_reg":
        err = torch.sum((out - batch["targets"]) ** 2, dim=-1)
        return torch.sum(err * nmask) / torch.clamp_min(torch.sum(nmask),
                                                        1.0)
    G = batch["graph_targets"].shape[0]
    pooled = torch.zeros((G, out.shape[1]), dtype=out.dtype,
                         device=out.device).index_add_(
        0, batch["graph_id"].long(), out * nmask[:, None])[:, 0]
    return torch.mean((pooled - batch["graph_targets"]) ** 2)
