"""Partitioning quality metrics (paper §IV), vectorized over the pins."""
from __future__ import annotations

from typing import Optional

import numpy as np

from .hypergraph import Hypergraph


def _edge_partition_pairs(hg: Hypergraph, assignment: np.ndarray,
                          k: Optional[int] = None) -> np.ndarray:
    """Edge id of every unique (edge, partition) pair over all pins."""
    part_of_pin = assignment[hg.e2v_indices].astype(np.int64)
    if np.any(part_of_pin < 0):
        raise ValueError("metrics require a complete assignment")
    if k is None:
        k = int(assignment.max()) + 1 if assignment.size else 1
    elif part_of_pin.size and part_of_pin.max() >= k:
        raise ValueError(
            f"assignment uses partition {int(part_of_pin.max())} "
            f">= k = {k}")
    edge_of_pin = np.repeat(np.arange(hg.m, dtype=np.int64),
                            hg.edge_sizes)
    key = edge_of_pin * np.int64(k) + part_of_pin
    return np.unique(key) // np.int64(k)


def spans_per_edge(hg: Hypergraph, assignment: np.ndarray,
                   k: Optional[int] = None) -> np.ndarray:
    """For each hyperedge, the number of distinct partitions it spans."""
    spans = np.zeros(hg.m, dtype=np.int64)
    np.add.at(spans, _edge_partition_pairs(hg, assignment, k), 1)
    return spans


def k_minus_1(hg: Hypergraph, assignment: np.ndarray,
              k: Optional[int] = None) -> int:
    """The (k-1) metric: sum over hyperedges of (#partitions spanned - 1).

    The paper's primary quality objective (§II); empty hyperedges
    contribute 0.
    """
    spans = spans_per_edge(hg, assignment, k)
    nonempty = hg.edge_sizes > 0
    return int(np.sum(spans[nonempty] - 1))


def partition_sizes(assignment: np.ndarray, k: int) -> np.ndarray:
    sizes = np.zeros(k, dtype=np.int64)
    np.add.at(sizes, assignment.astype(np.int64), 1)
    return sizes


def vertex_imbalance(assignment: np.ndarray, k: int) -> float:
    """(maxsize - minsize) / maxsize, the paper's fairness metric (§IV)."""
    sizes = partition_sizes(assignment, k)
    mx = sizes.max()
    return float((mx - sizes.min()) / mx) if mx > 0 else 0.0
