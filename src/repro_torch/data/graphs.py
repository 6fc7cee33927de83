"""Graph generators, batch builders and the neighbour sampler of the GNNs.

A numpy copy of ``src/repro/data/graphs.py``: given the same seed or
``rng``, every function returns the same arrays as the JAX package's.
The one change is in ``NeighborSampler.__init__``: the in-degree count
is ``np.bincount`` where JAX has ``np.add.at`` (the same ``indptr``; at
reddit scale, 114.6M edges, ``np.add.at`` takes tens of seconds).

Statically-shaped ``GraphBatch`` dicts (see models/gnn.py) for the four
assigned GNN shapes:

  full_graph_sm  n=2,708  e=10,556    d_feat=1,433   (cora-scale)
  minibatch_lg   n=232,965 e=114.6M   batch=1,024 fanout 15-10 (reddit-scale)
  ogb_products   n=2,449,029 e=61.9M  d_feat=100     (full-batch-large)
  molecule       n=30 e=64 batch=128  (batched small graphs)
"""
from __future__ import annotations

import numpy as np


def random_graph(n: int, avg_degree: float, seed: int = 0,
                 power_law: bool = True):
    """Directed edge list with power-law-ish out-degrees (src, dst)."""
    rng = np.random.default_rng(seed)
    n_edges = int(n * avg_degree)
    if power_law:
        # preferential-attachment-flavoured endpoints
        u = rng.random(n_edges * 2)
        idx = ((u ** 2.5) * n).astype(np.int64) % n
        src, dst = idx[:n_edges], idx[n_edges:]
    else:
        src = rng.integers(0, n, n_edges)
        dst = rng.integers(0, n, n_edges)
    keep = src != dst
    return src[keep].astype(np.int32), dst[keep].astype(np.int32)


def build_graph_batch(n: int, src: np.ndarray, dst: np.ndarray, d_feat: int,
                      n_classes: int, seed: int = 0, d_edge: int = 4,
                      n_graphs: int = 1, pad_nodes: int | None = None,
                      pad_edges: int | None = None):
    """Statically-shaped GraphBatch with masks; labels correlated with
    features so training can actually learn."""
    rng = np.random.default_rng(seed)
    N = pad_nodes or n
    E = pad_edges or src.size
    assert N >= n and E >= src.size
    nodes = np.zeros((N, d_feat), np.float32)
    labels = np.zeros((N,), np.int32)
    proto = rng.normal(size=(n_classes, d_feat)).astype(np.float32)
    lab = rng.integers(0, n_classes, n)
    nodes[:n] = proto[lab] * 0.5 + rng.normal(size=(n, d_feat)) * 0.5
    labels[:n] = lab
    es = np.zeros((E,), np.int32)
    ed = np.zeros((E,), np.int32)
    es[:src.size] = src
    ed[:dst.size] = dst
    emask = np.zeros((E,), bool)
    emask[:src.size] = True
    nmask = np.zeros((N,), bool)
    nmask[:n] = True
    gid = np.zeros((N,), np.int32)
    if n_graphs > 1:
        per = n // n_graphs
        gid[:n] = np.minimum(np.arange(n) // per, n_graphs - 1)
    return {
        "nodes": nodes,
        "pos": rng.normal(size=(N, 3)).astype(np.float32) * 3.0,
        "edge_src": es,
        "edge_dst": ed,
        "edge_x": rng.normal(size=(E, d_edge)).astype(np.float32),
        "node_mask": nmask,
        "edge_mask": emask,
        "graph_id": gid,
        "labels": labels,
        "targets": nodes[:, :d_feat].astype(np.float32),
        "graph_targets": rng.normal(size=(max(n_graphs, 1),)).astype(np.float32),
    }


def molecule_batch(n_mols: int = 128, n_atoms: int = 30, n_bonds: int = 64,
                   d_feat: int = 16, seed: int = 0):
    """Batch of small molecules flattened into one padded graph."""
    rng = np.random.default_rng(seed)
    N = n_mols * n_atoms
    E = n_mols * n_bonds
    src = np.zeros((E,), np.int32)
    dst = np.zeros((E,), np.int32)
    for g in range(n_mols):
        s = rng.integers(0, n_atoms, n_bonds) + g * n_atoms
        d = rng.integers(0, n_atoms, n_bonds) + g * n_atoms
        src[g * n_bonds:(g + 1) * n_bonds] = s
        dst[g * n_bonds:(g + 1) * n_bonds] = d
    batch = build_graph_batch(N, src, dst, d_feat, 2, seed=seed,
                              n_graphs=n_mols)
    batch["graph_id"] = (np.arange(N) // n_atoms).astype(np.int32)
    # positions clustered per molecule so schnet cutoffs are meaningful
    centers = rng.normal(size=(n_mols, 3)) * 50
    batch["pos"] = (np.repeat(centers, n_atoms, axis=0)
                    + rng.normal(size=(N, 3)) * 2).astype(np.float32)
    return batch


# --------------------------------------------------------------- sampler

class NeighborSampler:
    """CSR uniform neighbor sampler (GraphSAGE fanout sampling).

    Real sampler over the in-edges CSR: for each seed node, samples up to
    ``fanout[h]`` neighbors per hop (with replacement when the degree is
    large, deterministic subsampling otherwise), producing a statically
    padded subgraph in GraphBatch edge-list form that every GNN arch
    consumes unchanged.
    """

    def __init__(self, n: int, src: np.ndarray, dst: np.ndarray):
        self.n = n
        order = np.argsort(dst, kind="stable")
        self.in_src = src[order]
        self.indptr = np.zeros(n + 1, dtype=np.int64)
        self.indptr[1:] = np.bincount(dst, minlength=n)
        np.cumsum(self.indptr, out=self.indptr)

    def sample(self, seeds: np.ndarray, fanouts, rng) -> dict:
        """Returns dict with local subgraph: seeds first in `node_ids`."""
        layers = [np.asarray(seeds, np.int64)]
        edges_src, edges_dst = [], []
        frontier = layers[0]
        for f in fanouts:
            lo = self.indptr[frontier]
            hi = self.indptr[frontier + 1]
            deg = (hi - lo).astype(np.int64)
            # sample f neighbors per frontier node (with replacement)
            offs = (rng.random((frontier.size, f))
                    * np.maximum(deg, 1)[:, None]).astype(np.int64)
            # zero-degree nodes gather a dummy (masked below); clamp index
            idx = np.minimum(lo[:, None] + offs,
                             max(self.in_src.size - 1, 0))
            nbr = self.in_src[idx] if self.in_src.size else \
                np.zeros_like(idx)
            valid = np.broadcast_to(deg[:, None] > 0, nbr.shape)
            src_flat = nbr[valid]
            dst_flat = np.repeat(frontier, f).reshape(frontier.size, f)[valid]
            edges_src.append(src_flat.astype(np.int64))
            edges_dst.append(dst_flat.astype(np.int64))
            frontier = np.unique(src_flat)
            layers.append(frontier)
        node_ids, inv = np.unique(np.concatenate(layers), return_inverse=True)
        # relabel seeds first
        seed_pos = np.searchsorted(node_ids, np.asarray(seeds, np.int64))
        perm = np.full(node_ids.size, -1, np.int64)
        perm[seed_pos] = np.arange(len(seeds))
        rest = np.flatnonzero(perm < 0)
        perm[rest] = len(seeds) + np.arange(rest.size)
        relabel = perm
        src = relabel[np.searchsorted(node_ids, np.concatenate(edges_src))]
        dst = relabel[np.searchsorted(node_ids, np.concatenate(edges_dst))]
        new_ids = np.empty_like(node_ids)
        new_ids[perm] = node_ids
        return {
            "node_ids": new_ids,            # global id per local slot
            "n_seeds": len(seeds),
            "edge_src": src.astype(np.int32),
            "edge_dst": dst.astype(np.int32),
        }

    def sample_padded(self, seeds, fanouts, rng, max_nodes: int,
                      max_edges: int, features: np.ndarray,
                      labels: np.ndarray, d_edge: int = 4) -> dict:
        sub = self.sample(seeds, fanouts, rng)
        n, e = sub["node_ids"].size, sub["edge_src"].size
        n_keep = min(n, max_nodes)
        # drop edges touching clipped nodes
        emask_src = (sub["edge_src"] < n_keep) & (sub["edge_dst"] < n_keep)
        src = sub["edge_src"][emask_src][:max_edges]
        dst = sub["edge_dst"][emask_src][:max_edges]
        ids = sub["node_ids"][:n_keep]
        batch = {
            "nodes": np.zeros((max_nodes, features.shape[1]), np.float32),
            "pos": np.zeros((max_nodes, 3), np.float32),
            "edge_src": np.zeros((max_edges,), np.int32),
            "edge_dst": np.zeros((max_edges,), np.int32),
            "edge_x": np.zeros((max_edges, d_edge), np.float32),
            "node_mask": np.zeros((max_nodes,), bool),
            "edge_mask": np.zeros((max_edges,), bool),
            "graph_id": np.zeros((max_nodes,), np.int32),
            "labels": np.zeros((max_nodes,), np.int32),
        }
        batch["nodes"][:n_keep] = features[ids]
        batch["labels"][:n_keep] = labels[ids]
        # loss only on seed nodes
        batch["node_mask"][:sub["n_seeds"]] = True
        batch["edge_src"][:src.size] = src
        batch["edge_dst"][:dst.size] = dst
        batch["edge_mask"][:src.size] = True
        batch["targets"] = batch["nodes"].copy()
        batch["graph_targets"] = np.zeros((1,), np.float32)
        return batch
