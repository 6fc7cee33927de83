"""Partitioned GNN aggregation: what an assignment costs at runtime.

A numpy copy of ``src/repro/placement/partitioned_gnn.py``. A directed
graph (src -> dst) aggregated per destination maps onto a hypergraph
with one hyperedge per destination vertex containing the destination
and all of its sources ((k-1) of that hypergraph counts the replica rows
the aggregation must materialise). ``build_partitioned_graph`` then
measures, for a given k-way assignment, the halo each device must
receive: every remote source row feeding a local destination is one
exchanged feature row, and the all-to-all payload is bounded by the
*largest* per-device halo (``s_max``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.hypergraph import Hypergraph


def graph_to_hypergraph(n: int, src: np.ndarray,
                        dst: np.ndarray) -> Hypergraph:
    """One hyperedge per destination: {v} ∪ {u : (u -> v) in E}.

    Duplicate (src, dst) pairs collapse to one pin; vertices with no
    in-edges become singleton hyperedges (zero (k-1) weight).
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if src.shape != dst.shape:
        raise ValueError("src and dst must have the same shape")
    order = np.argsort(dst, kind="stable")
    s, d = src[order], dst[order]
    starts = np.searchsorted(d, np.arange(n), side="left")
    ends = np.searchsorted(d, np.arange(n), side="right")
    edges = [np.unique(np.concatenate(([v], s[starts[v]:ends[v]])))
             for v in range(n)]
    return Hypergraph.from_edge_lists(n, edges)


@dataclasses.dataclass(frozen=True)
class PartitionedGraph:
    """A k-way placement of a directed graph plus its exchange costs."""
    k: int
    owner: np.ndarray          # (n,) int32 device of each vertex
    halo_rows: np.ndarray      # (k,) int64 remote rows device p receives
    s_max: int                 # max(halo_rows) -- the collective's bound
    stats: dict                # exchanged_rows, remote_edge_frac


def build_partitioned_graph(n: int, src: np.ndarray, dst: np.ndarray,
                            assignment: np.ndarray,
                            k: int) -> PartitionedGraph:
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    owner = np.asarray(assignment, dtype=np.int32)
    if owner.shape != (n,):
        raise ValueError(f"assignment must have shape ({n},)")
    remote = owner[src] != owner[dst]
    # a source row is exchanged once per destination device, however
    # many local destinations consume it: unique (recv device, src row)
    pairs = owner[dst[remote]].astype(np.int64) * np.int64(n) \
        + src[remote]
    uniq = np.unique(pairs)
    halo = np.bincount((uniq // n).astype(np.int64), minlength=k)
    n_edges = max(int(src.size), 1)
    stats = {
        "exchanged_rows": int(uniq.size),
        "remote_edge_frac": float(np.count_nonzero(remote)) / n_edges,
    }
    return PartitionedGraph(k=k, owner=owner,
                            halo_rows=halo.astype(np.int64),
                            s_max=int(halo.max()) if k > 0 else 0,
                            stats=stats)
