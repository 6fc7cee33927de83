"""Hypergraph data structure (CSR in both directions).

A hypergraph G = (V, E) with |V| = n vertices and |E| = m hyperedges is
stored as two CSR structures:

  * ``v2e``: for each vertex, the list of incident hyperedge ids.
  * ``e2v``: for each hyperedge, the list of member vertex ids (its "pins").

All arrays are plain numpy, built exactly as the JAX package builds
them, so one seed gives one CSR and one ``fingerprint()`` in both.
``device_adjacency`` is the device CSR image that the superstep engine
and the refinement screen gather from.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Iterable, Sequence

import numpy as np
import torch

# Ids at or above 2**31 no longer fit int32.
INT32_LIMIT = 2**31


def device_ptr_dtype(n_indices: int) -> torch.dtype:
    """Dtype of a device CSR ``indptr``: int32 while offsets fit."""
    return torch.int32 if int(n_indices) < INT32_LIMIT else torch.int64


def csr_index_dtype(n: int, m: int):
    """Numpy dtype for CSR *indices* arrays of an (n, m) hypergraph.

    int32 while every vertex AND hyperedge id fits, int64 otherwise.
    Indptr arrays stay int64 regardless (pin counts overflow first).
    """
    return np.int32 if max(int(n), int(m)) < INT32_LIMIT else np.int64


@dataclasses.dataclass(frozen=True)
class Hypergraph:
    n: int                     # number of vertices
    m: int                     # number of hyperedges
    v2e_indptr: np.ndarray     # (n+1,) int64
    v2e_indices: np.ndarray    # (n_pins,) int32/int64 hyperedge ids
    e2v_indptr: np.ndarray     # (m+1,) int64
    e2v_indices: np.ndarray    # (n_pins,) int32/int64 vertex ids

    @classmethod
    def from_pins(cls, n: int, m: int, vertex_ids: np.ndarray,
                  edge_ids: np.ndarray) -> "Hypergraph":
        """Build from parallel pin arrays (vertex_ids[i] in edge edge_ids[i]).

        Ids outside ``[0, n)`` / ``[0, m)`` raise ``ValueError``; duplicate
        (vertex, edge) pins are dropped. Index dtype is int32 when ids
        fit, int64 otherwise.
        """
        vertex_ids = np.asarray(vertex_ids, dtype=np.int64)
        edge_ids = np.asarray(edge_ids, dtype=np.int64)
        if vertex_ids.shape != edge_ids.shape:
            raise ValueError("pin arrays must be parallel")
        if vertex_ids.size and (vertex_ids.min() < 0
                                or vertex_ids.max() >= n):
            raise ValueError("vertex id out of range")
        if edge_ids.size and (edge_ids.min() < 0 or edge_ids.max() >= m):
            raise ValueError("edge id out of range")

        # de-duplicate pins (a vertex may appear at most once per hyperedge)
        key = edge_ids * np.int64(n) + vertex_ids
        _, uniq = np.unique(key, return_index=True)
        vertex_ids, edge_ids = vertex_ids[uniq], edge_ids[uniq]

        idx_dtype = csr_index_dtype(n, m)

        order = np.argsort(edge_ids, kind="stable")
        e2v_indices = vertex_ids[order].astype(idx_dtype)
        e2v_indptr = np.zeros(m + 1, dtype=np.int64)
        np.add.at(e2v_indptr, edge_ids + 1, 1)
        np.cumsum(e2v_indptr, out=e2v_indptr)

        order = np.argsort(vertex_ids, kind="stable")
        v2e_indices = edge_ids[order].astype(idx_dtype)
        v2e_indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(v2e_indptr, vertex_ids + 1, 1)
        np.cumsum(v2e_indptr, out=v2e_indptr)

        return cls(n=n, m=m, v2e_indptr=v2e_indptr, v2e_indices=v2e_indices,
                   e2v_indptr=e2v_indptr, e2v_indices=e2v_indices)

    @classmethod
    def from_edge_lists(cls, n: int,
                        edges: Sequence[Iterable[int]]) -> "Hypergraph":
        """Build from a list of hyperedges, each an iterable of vertex ids."""
        edge_ids, vertex_ids = [], []
        for e, pins in enumerate(edges):
            for v in pins:
                edge_ids.append(e)
                vertex_ids.append(v)
        return cls.from_pins(n, len(edges),
                             np.asarray(vertex_ids, dtype=np.int64),
                             np.asarray(edge_ids, dtype=np.int64))

    @property
    def n_pins(self) -> int:
        return int(self.e2v_indices.shape[0])

    @property
    def edge_sizes(self) -> np.ndarray:
        return np.diff(self.e2v_indptr)

    @property
    def vertex_degrees(self) -> np.ndarray:
        return np.diff(self.v2e_indptr)

    def edge_pins(self, e: int) -> np.ndarray:
        return self.e2v_indices[self.e2v_indptr[e]:self.e2v_indptr[e + 1]]

    def vertex_adjacency(self, max_expanded: int = 80_000_000):
        """CSR of unique neighbour lists N(v) for ALL vertices, memoized.

        Every pin (v, e) contributes all pins of e and the (v, u) pairs
        are deduplicated globally. Returns ``(indptr int64, indices
        int32)`` (self-loops excluded), or None when the expansion would
        exceed ``max_expanded`` pairs (pathological hub edges).
        """
        cache = self.__dict__.get("_adj_cache")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_adj_cache", cache)
        if max_expanded in cache:
            return cache[max_expanded]
        expanded = int((self.edge_sizes.astype(np.int64) ** 2).sum())
        if expanded > max_expanded:
            adj = None
        else:
            from .scoring import gather_csr_rows
            sizes = self.edge_sizes.astype(np.int64)
            edge_of_pin = np.repeat(np.arange(self.m, dtype=np.int64),
                                    sizes)
            nbr, owner_pin = gather_csr_rows(self.e2v_indptr,
                                             self.e2v_indices, edge_of_pin)
            nbr = nbr.astype(np.int64)
            owner = self.e2v_indices[owner_pin].astype(np.int64)
            keys = np.unique(owner * np.int64(self.n) + nbr)
            ov, nb = keys // self.n, keys % self.n
            keep = ov != nb
            ov, nb = ov[keep], nb[keep]
            indptr = np.zeros(self.n + 1, dtype=np.int64)
            indptr[1:] = np.cumsum(np.bincount(ov, minlength=self.n))
            adj = (indptr, nb.astype(np.int32))
        cache[max_expanded] = adj               # frozen-dataclass memo
        return adj

    def device_adjacency(self, device, max_expanded: int = 80_000_000):
        """``vertex_adjacency`` uploaded to ``device`` once, memoized.

        Returns ``(indptr, indices)`` torch tensors (``indptr`` int32
        where the offsets fit, int64 otherwise; ``indices`` int32), or
        None when the host-side expansion guard trips. Memoized per
        (device, max_expanded).
        """
        cache = self.__dict__.get("_device_adj_cache")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_device_adj_cache", cache)
        dev = torch.device(device)
        key = (str(dev), max_expanded)
        if key in cache:
            return cache[key]
        adj = self.vertex_adjacency(max_expanded)
        out = None
        if adj is not None:
            indptr, indices = adj
            out = (torch.from_numpy(indptr)
                   .to(device_ptr_dtype(indices.size)).to(dev),
                   torch.from_numpy(indices).to(dev))
        cache[key] = out
        return out

    def flip(self) -> "Hypergraph":
        """Swap roles of vertices and hyperedges (paper §III-C).

        Flipping twice is the identity (up to pin ordering). Used for
        perfect hyperedge balancing: balance vertices in the flipped graph.
        """
        return Hypergraph(n=self.m, m=self.n,
                          v2e_indptr=self.e2v_indptr,
                          v2e_indices=self.e2v_indices,
                          e2v_indptr=self.v2e_indptr,
                          e2v_indices=self.v2e_indices)

    def validate(self) -> None:
        """Check the CSR invariants; raise ``ValueError`` on corruption."""
        if self.v2e_indptr.shape != (self.n + 1,):
            raise ValueError(
                f"v2e_indptr shape {self.v2e_indptr.shape} != (n+1,) "
                f"= ({self.n + 1},)")
        if self.e2v_indptr.shape != (self.m + 1,):
            raise ValueError(
                f"e2v_indptr shape {self.e2v_indptr.shape} != (m+1,) "
                f"= ({self.m + 1},)")
        if self.v2e_indptr[-1] != self.v2e_indices.shape[0]:
            raise ValueError(
                f"v2e_indptr[-1] = {int(self.v2e_indptr[-1])} does not "
                f"match v2e_indices size {self.v2e_indices.shape[0]}")
        if self.e2v_indptr[-1] != self.e2v_indices.shape[0]:
            raise ValueError(
                f"e2v_indptr[-1] = {int(self.e2v_indptr[-1])} does not "
                f"match e2v_indices size {self.e2v_indices.shape[0]}")
        if self.v2e_indices.shape != self.e2v_indices.shape:
            raise ValueError(
                f"pin-count mismatch: {self.v2e_indices.shape[0]} v2e "
                f"pins vs {self.e2v_indices.shape[0]} e2v pins")
        if self.e2v_indices.size:
            if self.e2v_indices.min() < 0:
                raise ValueError("negative vertex id in e2v_indices")
            if self.e2v_indices.max() >= self.n:
                raise ValueError(
                    f"vertex id {int(self.e2v_indices.max())} out of "
                    f"range [0, {self.n})")
        if self.v2e_indices.size:
            if self.v2e_indices.min() < 0:
                raise ValueError("negative edge id in v2e_indices")
            if self.v2e_indices.max() >= self.m:
                raise ValueError(
                    f"edge id {int(self.v2e_indices.max())} out of "
                    f"range [0, {self.m})")

    def fingerprint(self) -> str:
        """Stable 16-hex-digit digest of the CSR structure, memoized.

        Covers (n, m) and all four CSR arrays; equal to the JAX
        package's ``Hypergraph.fingerprint`` for the same arrays.
        """
        cached = self.__dict__.get("_fingerprint")
        if cached is not None:
            return cached
        h = hashlib.sha256()
        h.update(np.asarray([self.n, self.m], dtype=np.int64).tobytes())
        for a in (self.v2e_indptr, self.v2e_indices,
                  self.e2v_indptr, self.e2v_indices):
            h.update(np.ascontiguousarray(a).tobytes())
        fp = h.hexdigest()[:16]
        object.__setattr__(self, "_fingerprint", fp)
        return fp

    def stats(self) -> dict:
        es, vd = self.edge_sizes, self.vertex_degrees
        return {
            "n_vertices": self.n,
            "n_hyperedges": self.m,
            "n_pins": self.n_pins,
            "max_edge_size": int(es.max()) if self.m else 0,
            "mean_edge_size": float(es.mean()) if self.m else 0.0,
            "max_vertex_degree": int(vd.max()) if self.n else 0,
            "mean_vertex_degree": float(vd.mean()) if self.n else 0.0,
        }
