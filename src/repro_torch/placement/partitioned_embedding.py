"""Partitioned embedding tables: co-access-aware row sharding.

An embedding lookup batch is a hypergraph — rows are vertices, each
query's row set is a hyperedge — so HYPE's (k-1) objective directly
minimises the number of shards a query touches. ``partition_rows_hype``
runs the offline partitioner over a query log; ``RowPlacement`` is the
serving-side routing table (row -> shard) from which shards-touched /
remote-fraction under affinity routing are read. A copy of
``src/repro/placement/partitioned_embedding.py``; its assignments equal
the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

from ..core.hype import HypeParams, hype_partition
from ..core.hypergraph import Hypergraph


@dataclasses.dataclass(frozen=True)
class RowPlacement:
    """Routing table of a k-way sharded embedding table."""
    k: int
    owner: np.ndarray          # (vocab,) int32 shard of each row
    shard_rows: np.ndarray     # (k,) int64 rows per shard

    @classmethod
    def from_assignment(cls, assignment: np.ndarray,
                        k: int) -> "RowPlacement":
        owner = np.asarray(assignment, dtype=np.int32)
        if owner.size and (owner.min() < 0 or owner.max() >= k):
            raise ValueError("assignment ids must lie in [0, k)")
        return cls(k=k, owner=owner,
                   shard_rows=np.bincount(owner, minlength=k)
                   .astype(np.int64))


def queries_to_hypergraph(vocab: int,
                          queries: Sequence[Iterable[int]]) -> Hypergraph:
    """Rows = vertices, one hyperedge per query's co-accessed row set."""
    return Hypergraph.from_edge_lists(
        vocab, [np.unique(np.asarray(q, dtype=np.int64))
                for q in queries])


def partition_rows_hype(vocab: int, queries: Sequence[Iterable[int]],
                        k: int, seed: int = 0) -> np.ndarray:
    """k-way row assignment minimising shards-per-query via HYPE."""
    hg = queries_to_hypergraph(vocab, queries)
    return hype_partition(hg, k, HypeParams(seed=seed))
