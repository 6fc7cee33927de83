"""GNN architectures: GatedGCN, MeshGraphNet, SchNet, GraphSAGE.

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

Padding edges point at node 0 with ``edge_mask`` False. The JAX package
passes messages as a gather by edge index, then ``segment_sum`` by
``dst``. Here GatedGCN, MeshGraphNet and SchNet gather with
``gather_rows`` and sum with ``segment_sum`` (``kernels/neighbor_agg``:
row 5b's deterministic kernel in its sum mode on the card, its plain
version on the CPU), over an ``EdgeIndex`` built once per forward, so a
training step adds no float with atomics and a replayed step gives the
same bits. The sums skip the masked edges: JAX multiplies their
messages by the mask, so they only ever add zeros, and every use of a
padding edge's state ends in that product, so their gradients are zero
too. ``gnn_loss``'s ``graph_reg`` pooling goes the same way by
``graph_id``.

The GraphSAGE layer goes through ``neighbor_agg_csr`` (row 5d: the
hand-written kernels of the mean and its projection) over a CSR of the
in-neighbours that ``in_neighbors_csr`` builds on the device once per
forward, with no sync and at any degree: one path for a sampled batch
and a full graph. The JAX mean divides by every edge into a node,
padding edges included, whose messages are zero (``_segment_agg(...,
"mean")``); the kernel counts the valid slots only, so each row is
scaled by ``max(valid, 1) / max(all, 1)`` after it: 1 exactly on every
row but the padding edges' target, node 0. ``in_neighbors`` pads the
same CSR into row 5's (N, K) matrix, for row 5's own checks.

Params are the JAX package's nested dicts, the MLPs bfloat16 as
``mlp_init`` draws them and the norm vectors float32, against float32
activations (``GNNConfig.dtype``): the products run in float32 as in JAX
(``common.mlp_apply``), and a bfloat16 param's gradient is its float32
gradient rounded to bfloat16, as JAX's cotangent is.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..kernels.neighbor_agg.ops import (SlotIndex, chunk_units,
                                        csr_transpose_index, gather_rows,
                                        neighbor_agg_csr, segment_index,
                                        segment_sum)
from .common import (DEFAULT_DTYPE, layer_norm, mlp_apply, mlp_init,
                     softmax_cross_entropy)

ARCHS = ("gatedgcn", "meshgraphnet", "schnet", "graphsage")
TASKS = ("node_class", "node_reg", "graph_reg")
# int32 slot offsets of row 5's padded matrix: N * K must stay below this
MAX_SLOTS = 2 ** 31
# The float32 norm vectors of gatedgcn and meshgraphnet layers and the
# value ``init_gnn_params`` fills each with (JAX's ``jnp.ones``/``zeros``).
NORM_INIT = {"ln_h": 1.0, "lb_h": 0.0, "ln_e": 1.0, "lb_e": 0.0}


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


def _out_dim(cfg: GNNConfig) -> int:
    if cfg.task == "node_class":
        return cfg.n_classes
    return 1 if cfg.task != "node_reg" else cfg.d_in


# ------------------------------------------------------------------ params

def _param_tree(cfg: GNNConfig, mlp, norm) -> dict:
    """The param tree of ``src/repro/models/gnn.py``'s ``init_gnn_params``
    with ``mlp(dims)`` at each MLP and ``norm(d, name)`` at each norm
    vector."""
    _check_arch(cfg)
    d, depth = cfg.d_hidden, cfg.mlp_layers
    d_edge = max(cfg.d_edge_in, 1)

    def norms():
        return {name: norm(d, name) for name in NORM_INIT}

    p = {"enc_node": mlp([cfg.d_in, d])}
    if cfg.arch == "gatedgcn":
        p["enc_edge"] = mlp([d_edge, d])
        p["layers"] = [{**{n: mlp([d, d]) for n in "ABCDE"}, **norms()}
                       for _ in range(cfg.n_layers)]
    elif cfg.arch == "meshgraphnet":
        p["enc_edge"] = mlp([d_edge] + [d] * depth)
        p["enc_node2"] = mlp([d] + [d] * depth)
        p["layers"] = [{"edge_mlp": mlp([3 * d] + [d] * depth),
                        "node_mlp": mlp([2 * d] + [d] * depth), **norms()}
                       for _ in range(cfg.n_layers)]
    elif cfg.arch == "schnet":
        p["layers"] = [{"filter": mlp([cfg.rbf, d, d]), "w_in": mlp([d, d]),
                        "out": mlp([d, d, d])}
                       for _ in range(cfg.n_layers)]
    else:
        p["layers"] = [{"w_self": mlp([d, d]), "w_nbr": mlp([d, d])}
                       for _ in range(cfg.n_layers)]
    p["dec"] = mlp([d, d, _out_dim(cfg)])
    return p


def gnn_param_shapes(cfg: GNNConfig) -> dict:
    """The param tree with a shape tuple at every leaf."""

    def mlp(dims):
        out = {f"w{i}": (dims[i], dims[i + 1]) for i in range(len(dims) - 1)}
        out.update({f"b{i}": (dims[i + 1],) for i in range(len(dims) - 1)})
        return out

    return _param_tree(cfg, mlp, lambda d, name: (d,))


def init_gnn_params(gen: torch.Generator, cfg: GNNConfig,
                    device="cpu") -> dict:
    """Random params on ``device`` in the JAX layout: every MLP bfloat16
    as ``mlp_init`` draws it there, every norm vector float32, filled
    with its ``NORM_INIT`` value as JAX fills it."""
    return _param_tree(
        cfg, lambda dims: mlp_init(gen, dims, DEFAULT_DTYPE, device),
        lambda d, name: torch.full((d,), NORM_INIT[name],
                                   dtype=torch.float32, device=device))


# -------------------------------------------------------------- neighbours

def in_neighbors_csr(edge_src: torch.Tensor, edge_dst: torch.Tensor,
                     edge_mask: torch.Tensor, n_nodes: int):
    """The in-neighbours of the valid edges as a CSR, on their device, with
    no host sync and no size limit.

    Returns ``(indptr, indices, scale, units, index)``: indptr (n_nodes +
    1,) int64 and indices (E,) int32, node v's in-neighbours
    ``indices[indptr[v]:indptr[v + 1]]``, the sources of the valid edges
    into v in edge order (a stable sort by destination, so duplicate edges
    stay), the invalid edges' sources past ``indptr[n_nodes]``; scale
    (n_nodes,) float32, ``max(valid in-degree, 1) / max(in-degree, 1)``
    with padding edges counted, as the JAX mean counts them; units, the
    forward's ``chunk_units(indptr, E)``, and index, the backward's
    by-source ``SlotIndex`` (``csr_transpose_index``), both built once so
    that every layer's ``neighbor_agg_csr`` shares them.
    """
    dst = edge_dst.long()
    key = torch.where(edge_mask, dst, n_nodes)      # invalid edges last
    cnt_valid = torch.bincount(key, minlength=n_nodes + 1)[:n_nodes]
    cnt_all = torch.bincount(dst, minlength=n_nodes)[:n_nodes]
    _, order = torch.sort(key, stable=True)
    indptr = torch.zeros(n_nodes + 1, dtype=torch.int64, device=key.device)
    torch.cumsum(cnt_valid, 0, out=indptr[1:])
    indices = edge_src[order].to(torch.int32)
    scale = (cnt_valid.clamp_min(1).float()
             / cnt_all.clamp_min(1).float())
    return (indptr, indices, scale, chunk_units(indptr, indices.shape[0]),
            csr_transpose_index(indptr, indices, n_nodes))


def in_neighbors(edge_src: torch.Tensor, edge_dst: torch.Tensor,
                 edge_mask: torch.Tensor, n_nodes: int):
    """The padded in-neighbour matrix of the valid edges, on their device:
    the inputs of row 5 (``neighbor_agg``), for its checks and timings;
    the GraphSAGE layer aggregates through ``in_neighbors_csr`` and row
    5d.

    Returns ``(nbrs, scale, index)``: nbrs (n_nodes, K) int32, row v
    holding ``in_neighbors_csr``'s neighbours of v in order, -1 past them,
    with K the largest valid in-degree (at least 1); scale and index as
    ``in_neighbors_csr`` returns them (the index equals
    ``transpose_index(nbrs, n_nodes)``). Reading K syncs once. Raises
    ``ValueError`` when the matrix would pass 2**31 slots.
    """
    indptr, indices, scale, _, index = in_neighbors_csr(
        edge_src, edge_dst, edge_mask, n_nodes)
    cnt = indptr[1:] - indptr[:-1]
    K = max(int(cnt.max()), 1) if n_nodes else 1
    if n_nodes * K >= MAX_SLOTS:
        raise ValueError(
            f"the in-neighbour matrix would hold {n_nodes} x {K} slots, "
            f"past 2**31; row 5d (neighbor_agg_csr over in_neighbors_csr) "
            f"takes any degree")
    E = indices.shape[0]
    pos = torch.arange(E, device=indptr.device)
    row = (torch.searchsorted(indptr, pos, right=True) - 1).clamp_max(
        max(n_nodes - 1, 0))
    # invalid edges all land on one spare slot past the matrix
    flat = torch.where(pos < indptr[-1], row * K + pos - indptr[row],
                       n_nodes * K)
    nbrs = torch.full((n_nodes * K + 1,), -1, dtype=torch.int32,
                      device=indptr.device)
    nbrs[flat] = indices
    return nbrs[:n_nodes * K].view(n_nodes, K), scale, index


# -------------------------------------------------------------- edge index

class EdgeIndex(NamedTuple):
    """An edge list as every gather and sum of one forward reads it."""
    src: torch.Tensor       # (E,) int64: each edge's source, padding too
    dst: torch.Tensor       # (E,) int64: each edge's destination
    src_ids: torch.Tensor   # (E,) int32: src, -1 on a masked edge
    dst_ids: torch.Tensor   # (E,) int32: dst, -1 on a masked edge
    by_src: SlotIndex       # the valid edges grouped by source
    by_dst: SlotIndex       # the valid edges grouped by destination


def edge_index(edge_src: torch.Tensor, edge_dst: torch.Tensor,
               edge_mask: torch.Tensor, n_nodes: int) -> EdgeIndex:
    """The ``EdgeIndex`` of a batch's edges, on their device, with no
    sync (two stable sorts)."""
    src_ids = torch.where(edge_mask, edge_src.to(torch.int32), -1)
    dst_ids = torch.where(edge_mask, edge_dst.to(torch.int32), -1)
    return EdgeIndex(edge_src.long(), edge_dst.long(), src_ids, dst_ids,
                     segment_index(src_ids, n_nodes),
                     segment_index(dst_ids, n_nodes))


def _gather_src(h: torch.Tensor, edges: EdgeIndex) -> torch.Tensor:
    """``h[src]``; its gradient skips the masked edges."""
    return gather_rows(h, edges.src, edges.src_ids, edges.by_src)


def _gather_dst(h: torch.Tensor, edges: EdgeIndex) -> torch.Tensor:
    """``h[dst]``; its gradient skips the masked edges."""
    return gather_rows(h, edges.dst, edges.dst_ids, edges.by_dst)


def _segment_agg(msgs: torch.Tensor, edges: EdgeIndex, n_nodes: int,
                 how: str = "sum") -> torch.Tensor:
    """JAX's ``_segment_agg(msgs, dst, n_nodes, how)`` for messages that
    are zero on the masked edges (every caller multiplies them by the
    mask): ``sum`` and ``gated`` skip those edges; ``mean`` divides by
    ``max(count, 1)`` with every edge counted, as JAX counts; ``max``
    takes every edge (a padding edge gives node 0 a 0), -inf for a node
    with none, as ``segment_max`` gives."""
    if how in ("sum", "gated", "mean"):
        out = segment_sum(msgs, edges.dst_ids, n_nodes, edges.by_dst)
        if how != "mean":
            return out
        cnt = torch.bincount(edges.dst, minlength=n_nodes)[:n_nodes]
        return out / cnt.clamp_min(1).to(out.dtype)[:, None]
    if how == "max":
        out = torch.full((n_nodes, msgs.shape[1]), -math.inf,
                         dtype=msgs.dtype, device=msgs.device)
        return out.scatter_reduce(0, edges.dst[:, None].expand_as(msgs),
                                  msgs, "amax", include_self=False)
    raise ValueError(how)


def _linspace(start: float, stop: float, num: int, device) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` in float32 by its formula:
    ``step = iota / (num - 1)``, ``start * (1 - step) + stop * step``,
    then ``stop``. (XLA on the CPU divides within one ulp of the correct
    rounding, so its centres may differ from these in the last bits.)"""
    if num < 2:
        return torch.full((num,), start, dtype=torch.float32, device=device)
    step = torch.arange(num - 1, dtype=torch.float32, device=device) / (
        num - 1)
    out = start * (1 - step) + stop * step
    return torch.cat([out, torch.full((1,), stop, dtype=torch.float32,
                                      device=device)])


def _rbf_expand(dist: torch.Tensor, n_rbf: int,
                cutoff: float) -> torch.Tensor:
    centers = _linspace(0.0, cutoff, n_rbf, dist.device)
    gamma = 10.0 / cutoff
    return torch.exp(-gamma * (dist[:, None] - centers[None, :]) ** 2)


# ----------------------------------------------------------------- forward

def _graphsage(params: dict, h: torch.Tensor, batch: dict,
               N: int) -> torch.Tensor:
    indptr, indices, scale, units, index = in_neighbors_csr(
        batch["edge_src"], batch["edge_dst"], batch["edge_mask"], N)
    for lp in params["layers"]:
        nbr = lp["w_nbr"]
        agg = (neighbor_agg_csr(h.contiguous(), indptr, indices, nbr["w0"],
                                index, units)
               * scale[:, None].to(h.dtype) + nbr["b0"])
        h = torch.relu(mlp_apply(lp["w_self"], h, 1) + agg)
        h = h / torch.linalg.vector_norm(h, dim=-1,
                                         keepdim=True).clamp_min(1e-6)
    return h


def _gatedgcn(params: dict, h: torch.Tensor, batch: dict, edges: EdgeIndex,
              emask: torch.Tensor, cfg: GNNConfig) -> torch.Tensor:
    N = h.shape[0]
    e = mlp_apply(params["enc_edge"], batch["edge_x"].to(cfg.dtype), 1)
    for lp in params["layers"]:
        hs, hd = _gather_src(h, edges), _gather_dst(h, edges)
        e_new = (mlp_apply(lp["C"], e, 1) + mlp_apply(lp["D"], hd, 1)
                 + mlp_apply(lp["E"], hs, 1))
        e = e + torch.relu(layer_norm(e_new, lp["ln_e"], lp["lb_e"]))
        eta = torch.sigmoid(e) * emask
        denom = _segment_agg(eta, edges, N, "sum") + 1e-6
        msg = eta * mlp_apply(lp["B"], hs, 1) * emask
        agg = _segment_agg(msg, edges, N, "sum") / denom
        h_new = mlp_apply(lp["A"], h, 1) + agg
        h = h + torch.relu(layer_norm(h_new, lp["ln_h"], lp["lb_h"]))
    return h


def _meshgraphnet(params: dict, h: torch.Tensor, batch: dict,
                  edges: EdgeIndex, emask: torch.Tensor,
                  cfg: GNNConfig) -> torch.Tensor:
    N, depth = h.shape[0], cfg.mlp_layers
    e = mlp_apply(params["enc_edge"], batch["edge_x"].to(cfg.dtype), depth)
    h = mlp_apply(params["enc_node2"], h, depth)
    for lp in params["layers"]:
        cat_e = torch.cat([e, _gather_src(h, edges), _gather_dst(h, edges)],
                          dim=-1)
        e = e + layer_norm(mlp_apply(lp["edge_mlp"], cat_e, depth),
                           lp["ln_e"], lp["lb_e"])
        agg = _segment_agg(e * emask, edges, N, cfg.aggregator)
        cat_h = torch.cat([h, agg], dim=-1)
        h = h + layer_norm(mlp_apply(lp["node_mlp"], cat_h, depth),
                           lp["ln_h"], lp["lb_h"])
    return h


def _schnet(params: dict, h: torch.Tensor, batch: dict, edges: EdgeIndex,
            emask: torch.Tensor, cfg: GNNConfig) -> torch.Tensor:
    N = h.shape[0]
    pos = batch["pos"]
    dvec = pos.index_select(0, edges.src) - pos.index_select(0, edges.dst)
    dist = torch.sqrt(torch.sum(dvec * dvec, dim=-1) + 1e-12)
    rbf = _rbf_expand(dist, cfg.rbf, cfg.cutoff).to(cfg.dtype)
    cut = 0.5 * (torch.cos(math.pi * dist / cfg.cutoff) + 1.0)
    cut = torch.where(dist <= cfg.cutoff, cut, 0.0)[:, None].to(cfg.dtype)
    for lp in params["layers"]:
        w = mlp_apply(lp["filter"], rbf, 2, act=F.softplus) * cut
        xin = mlp_apply(lp["w_in"], h, 1)
        msg = _gather_src(xin, edges) * w * emask
        agg = _segment_agg(msg, edges, N, "sum")
        h = h + mlp_apply(lp["out"], agg, 2, act=F.softplus)
    return h


_ARCH_LAYERS = {"gatedgcn": _gatedgcn, "meshgraphnet": _meshgraphnet,
                "schnet": _schnet}


def gnn_forward(params: dict, batch: dict, cfg: GNNConfig) -> torch.Tensor:
    """Per-node outputs (N, out_dim) (graph tasks pool afterwards)."""
    _check_arch(cfg)
    N = batch["nodes"].shape[0]
    h = mlp_apply(params["enc_node"], batch["nodes"].to(cfg.dtype), 1)
    if cfg.arch == "graphsage":
        h = _graphsage(params, h, batch, N)
    else:
        edges = edge_index(batch["edge_src"], batch["edge_dst"],
                           batch["edge_mask"], N)
        emask = batch["edge_mask"][:, None].to(cfg.dtype)
        h = _ARCH_LAYERS[cfg.arch](params, h, batch, edges, emask, cfg)
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
    # padding nodes (times nmask = 0 in JAX) and ids past the G graphs
    # (which segment_sum drops) are skipped
    G = batch["graph_targets"].shape[0]
    gid = batch["graph_id"]
    keep = batch["node_mask"] & (gid >= 0) & (gid < G)
    pooled = segment_sum(out * nmask[:, None],
                         torch.where(keep, gid.to(torch.int32), -1), G)[:, 0]
    return torch.mean((pooled - batch["graph_targets"]) ** 2)
