"""Synthetic hypergraph generators: the scale models of the paper's data.

Copies of the JAX package's generators (``src/repro/data/synthetic.py``),
draw for draw, so the same seed gives the same CSR and the same
``fingerprint()`` in both packages (with the same numpy).

Each vertex gets a power-law number of "stub slots" laid out on a ring;
a hyperedge samples pins at heavy-tailed distances from its centre, so
both degrees and edge sizes follow power laws and communities form at
every scale, with a ``1 - locality`` share of global pins.
"""
from __future__ import annotations

import numpy as np

from ..core.hypergraph import Hypergraph


def _powerlaw_sizes(rng, count, alpha, lo, hi):
    """Discrete power-law samples in [lo, hi] via inverse CDF."""
    u = rng.random(count)
    a1 = 1.0 - alpha
    x = ((hi ** a1 - lo ** a1) * u + lo ** a1) ** (1.0 / a1)
    return np.clip(x.astype(np.int64), lo, hi)


def powerlaw_hypergraph(n: int, m: int, *, alpha_edge: float = 2.2,
                        alpha_vertex: float = 2.5,
                        max_edge: int | None = None,
                        max_degree: int | None = None, seed: int = 0,
                        locality: float = 0.9) -> Hypergraph:
    """Power-law hyperedge sizes AND vertex degrees, with spatial locality."""
    rng = np.random.default_rng(seed)
    max_edge = max_edge or max(4, n // 20)
    max_degree = max_degree or max(4, m // 20)
    sizes = _powerlaw_sizes(rng, m, alpha_edge, 2, max_edge)
    degs = _powerlaw_sizes(rng, n, alpha_vertex, 1, max_degree)
    slots = np.repeat(np.arange(n, dtype=np.int64), degs)
    n_slots = slots.size
    total = int(sizes.sum())
    edge_of_pin = np.repeat(np.arange(m, dtype=np.int64), sizes)
    centers = rng.integers(0, n_slots, size=m)
    center_of_pin = centers[edge_of_pin]
    local = rng.random(total) < locality
    u = rng.random(total)
    beta = 0.9
    disp = (2.0 * u ** (-1.0 / beta)).astype(np.int64)
    disp = np.minimum(disp, n_slots // 2)
    sign = rng.integers(0, 2, size=total) * 2 - 1
    local_slot = (center_of_pin + sign * disp) % n_slots
    global_slot = rng.integers(0, n_slots, size=total)
    pins = slots[np.where(local, local_slot, global_slot)]
    return Hypergraph.from_pins(n, m, pins, edge_of_pin)


def community_hypergraph(n: int, m: int, n_communities: int, *,
                         p_intra: float = 0.95, alpha_edge: float = 2.3,
                         max_edge: int | None = None,
                         seed: int = 0) -> Hypergraph:
    """Planted-community hypergraph.

    Each hyperedge belongs to a community; ``p_intra`` of its pins come
    from that community, the rest are global. The planted assignment
    gives a quality reference point for partitioners.
    """
    rng = np.random.default_rng(seed)
    max_edge = max_edge or max(4, n // n_communities)
    sizes = _powerlaw_sizes(rng, m, alpha_edge, 2, max_edge)
    total = int(sizes.sum())
    comm_of_edge = rng.integers(0, n_communities, size=m)
    edge_of_pin = np.repeat(np.arange(m, dtype=np.int64), sizes)
    comm_of_pin = comm_of_edge[edge_of_pin]
    csize = n // n_communities
    intra = rng.random(total) < p_intra
    local_pins = comm_of_pin * csize + rng.integers(0, csize, size=total)
    global_pins = rng.integers(0, n, size=total)
    pins = np.clip(np.where(intra, local_pins, global_pins), 0, n - 1)
    return Hypergraph.from_pins(n, m, pins, edge_of_pin)


def github_like(scale: float = 1.0, seed: int = 0) -> Hypergraph:
    """Github: 177,386 vertices / 56,519 hyperedges / 440,237 pins."""
    n = int(177_386 * scale)
    m = int(56_519 * scale)
    return powerlaw_hypergraph(n, m, alpha_edge=2.0,
                               max_edge=max(8, n // 40), seed=seed)


def stackoverflow_like(scale: float = 1.0, seed: int = 0) -> Hypergraph:
    """StackOverflow: 641,876 vertices / 545,196 hyperedges / 1.3M pins."""
    n = int(641_876 * scale)
    m = int(545_196 * scale)
    return powerlaw_hypergraph(n, m, alpha_edge=2.6,
                               max_edge=max(8, n // 100), seed=seed)


def reddit_like(scale: float = 0.02, seed: int = 0) -> Hypergraph:
    """Reddit: 430,156 vertices / 21.2M hyperedges / 179.7M pins."""
    n = int(430_156 * scale)
    m = int(21_169_586 * scale)
    return powerlaw_hypergraph(n, m, alpha_edge=2.4,
                               max_edge=max(8, n // 4), seed=seed)
