"""Device-resident HYPE on dense padded arrays: the sequential and the
parallel growth engine (``hype_jax`` and ``hype_parallel``).

The counterpart of the JAX package's ``src/repro/core/hype_jax.py``,
whose engines are one traced program each:

1. ``hype_jax_partition``: the sequential HYPE of Algorithms 1-3 with the
   s/r/caching optimizations on (n, max_deg) / (m, max_size) padded CSR
   arrays; one loop iteration moves one vertex.
2. ``hype_parallel_partition``: all k cores take one growth step per
   iteration, each scoring ``candidates`` vertices drawn from its
   smallest live hyperedges; a collision goes to the smaller core, then
   the lower score, then the lower partition id.

Both hold every tensor on one device. JAX's ``while_loop`` becomes a
Python loop that reads its condition with one host sync per iteration,
the ``scan`` of ``r`` a Python loop, and each ``cond`` (the seed add,
the restart, ``upd8_core``'s add, the rescue) a host branch on a flag
read once; the key advances only inside the taken branch, where JAX's
does. The random draws come from ``core/threefry.py``, a bit-exact copy
of ``jax.random``, so the assignments are JAX's bit for bit.

JAX's ``mode="drop"`` scatters become writes to a scratch element past
the end (``cache`` is (n + 1,), ``edge_active`` (m + 1,) or (k, m + 1),
the parallel assignment (n + 1,)); nothing reads it back. Every real
scatter target is unique, so CUDA's unordered ``index_put_`` is safe.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import threefry
from .hypergraph import Hypergraph
from .scoring import batched_dext_torch

_INF = float(np.float32(3.4e38))
_INT32_MAX = int(np.iinfo(np.int32).max)


@dataclasses.dataclass
class GrowthStats:
    """What a run of either engine did."""
    iterations: int = 0     # loop iterations over all phases
    restarts: int = 0       # hype_jax: empty-fringe random restarts
    rescues: int = 0        # hype_parallel: steps no core won


def _pad_csr(indptr: np.ndarray, indices: np.ndarray, rows: int,
             width: int) -> np.ndarray:
    """Dense (rows, width) -1-padded view of a CSR structure."""
    out = np.full((rows, width), -1, dtype=np.int32)
    if rows and indices.size:
        lens = np.diff(indptr).astype(np.int64)
        r = np.repeat(np.arange(rows, dtype=np.int64), lens)
        c = (np.arange(indices.size, dtype=np.int64)
             - np.repeat(indptr[:-1].astype(np.int64), lens))
        out[r, c] = indices
    return out


def _member_mask(n: int, ids: torch.Tensor) -> torch.Tensor:
    """(n,) bool mask with True at every non-negative id in ``ids``; -1
    pads go to the scratch index n, which is cut off."""
    mask = torch.zeros(n + 1, dtype=torch.bool, device=ids.device)
    mask[torch.where(ids >= 0, ids, n).long()] = True
    return mask[:n]


class PaddedHypergraph(NamedTuple):
    """Dense padded views of a hypergraph on one device."""
    v2e: torch.Tensor          # (n, max_deg) int32, -1 padded
    e2v: torch.Tensor          # (m, max_size) int32, -1 padded
    edge_sizes: torch.Tensor   # (m,) int32

    @property
    def n(self) -> int:
        return self.v2e.shape[0]

    @property
    def m(self) -> int:
        return self.e2v.shape[0]

    @classmethod
    def from_hypergraph(cls, hg: Hypergraph,
                        device=None) -> "PaddedHypergraph":
        max_deg = max(1, int(hg.vertex_degrees.max()) if hg.n else 1)
        max_size = max(1, int(hg.edge_sizes.max()) if hg.m else 1)
        v2e = _pad_csr(hg.v2e_indptr, hg.v2e_indices, hg.n, max_deg)
        e2v = _pad_csr(hg.e2v_indptr, hg.e2v_indices, hg.m, max_size)
        return cls(v2e=torch.from_numpy(v2e).to(device),
                   e2v=torch.from_numpy(e2v).to(device),
                   edge_sizes=torch.from_numpy(
                       hg.edge_sizes.astype(np.int32)).to(device))


class _SeqState(NamedTuple):
    assignment: torch.Tensor   # (n,) int32, -1 unassigned
    in_fringe: torch.Tensor    # (n,) bool
    fringe: torch.Tensor       # (s,) int32, -1 empty slots
    cache: torch.Tensor        # (n + 1,) float32, < 0 = missing; scratch
    edge_active: torch.Tensor  # (m + 1,) bool, incident to the core; scratch
    core_size: int
    rand_key: threefry.Key     # (k1, k2) uint32 lanes as ints


def _random_vertex(sub: threefry.Key, avail: torch.Tensor) -> torch.Tensor:
    """JAX's ``argmax(avail * uniform(sub, 0.5, 1))``: a uniformly drawn
    available vertex as a (1,) tensor (0 when none is). No host sync."""
    u = threefry.uniform(sub, avail.shape[0], 0.5, 1.0, avail.device)
    return torch.argmax(avail.to(torch.float32) * u).view(1)


def _pick_random(key: threefry.Key, avail: torch.Tensor):
    """Split ``key`` and draw from ``avail``; returns ``(key, v)``, v a
    host int, -1 when nothing is available (one host read)."""
    key, sub = threefry.split(key)
    v, any_avail = torch.stack([_random_vertex(sub, avail)[0],
                                avail.any().long()]).tolist()
    return key, (v if any_avail else -1)


def _seq_grow(ph: PaddedHypergraph, state: _SeqState, part: int,
              target: int, s: int, r: int, stats: GrowthStats) -> _SeqState:
    """Grow core set ``part`` to ``target`` vertices."""
    n, m = ph.n, ph.m
    e2v_n = torch.where(ph.e2v >= 0, ph.e2v, n).long()   # pads -> scratch
    assignment = state.assignment.clone()
    in_fringe = state.in_fringe.clone()
    cache = torch.full((n + 1,), -1.0, dtype=torch.float32,
                       device=ph.v2e.device)
    edge_active = torch.zeros(m + 1, dtype=torch.bool, device=ph.v2e.device)
    fringe = torch.full((s,), -1, dtype=torch.int32, device=ph.v2e.device)
    core_size = 0

    def add_to_core(v: int) -> None:
        nonlocal core_size
        assignment[v] = part
        in_fringe[v] = False
        es = ph.v2e[v]
        edge_active[torch.where(es >= 0, es, m).long()] = True
        core_size += 1

    # the seed vertex
    key, seed_v = _pick_random(state.rand_key, (assignment < 0) & ~in_fringe)
    if seed_v >= 0:
        add_to_core(seed_v)
    no = torch.zeros(1, dtype=torch.bool, device=ph.v2e.device)
    while core_size < target:
        stats.iterations += 1
        # upd8_fringe: r candidates from the smallest live edges
        ext = (assignment < 0) & ~in_fringe
        pins_univ = torch.cat([ext, no])[e2v_n]            # (m, max_size)
        edge_live = edge_active[:m] & pins_univ.any(dim=1)
        sizes = torch.where(edge_live, ph.edge_sizes, _INT32_MAX)
        taken = torch.zeros(n + 1, dtype=torch.bool, device=ext.device)
        picked = []
        for _ in range(r):
            pin_ok = pins_univ & ~taken[e2v_n]
            live = edge_live & pin_ok.any(dim=1)
            e = torch.argmin(torch.where(live, sizes, _INT32_MAX)).view(1)
            row_ok = pin_ok[e]                              # (1, max_size)
            j = torch.argmax(row_ok.to(torch.int32), dim=1)
            ok = live.any() & row_ok.gather(1, j[:, None])[:, 0]
            v = torch.where(ok, ph.e2v[e, j], -1)
            taken[torch.where(v >= 0, v, n).long()] = True
            picked.append(v)
        # JAX writes each pick at the count of valid picks so far; a
        # round that finds none leaves ``taken`` as it was, so no later
        # round finds one, and the picks in order are JAX's array
        cand = torch.cat(picked) if picked else fringe.new_empty(0)
        # lazy cache: score only the candidates that miss it
        scores_new = batched_dext_torch(ph.v2e, ph.e2v, cand, ext)
        miss = (cand >= 0) & (cache[torch.where(cand >= 0, cand, 0).long()]
                              < 0)
        cache[torch.where(miss, cand, n).long()] = scores_new
        # fringe = the s best of fringe + candidates, stably sorted
        pool = torch.cat([fringe, cand])
        valid = pool >= 0
        scores = torch.where(
            valid, cache[torch.where(valid, pool, 0).long()], _INF)
        pool = pool[torch.argsort(scores, stable=True)]
        fringe = pool[:s].clone()
        in_fringe = ((in_fringe & ~_member_mask(n, pool[s:]))
                     | _member_mask(n, fringe))
        # Valid entries hold finite cached scores and sort before the
        # pads, so slot 0 is both "is the fringe empty" and the argmin
        # upd8_core takes: one host read serves the restart cond and
        # the add.
        v = int(fringe[0])
        if v < 0:
            # random restart: the drawn vertex enters slot 0 with score 0
            stats.restarts += 1
            key, v = _pick_random(key, (assignment < 0) & ~in_fringe)
            if v >= 0:
                cache[v] = 0.0
        # upd8_core: take slot 0 (its in_fringe bit clears on admission)
        fringe[0] = -1
        if v >= 0:
            add_to_core(v)
    return _SeqState(assignment=assignment, in_fringe=in_fringe,
                     fringe=fringe, cache=cache, edge_active=edge_active,
                     core_size=core_size, rand_key=key)


def _release_fringe(state: _SeqState, n: int, s: int) -> _SeqState:
    """§III-B1 step 4: evicted fringe vertices rejoin the universe; after
    this ``in_fringe`` is all-False."""
    in_fringe = state.in_fringe & ~_member_mask(n, state.fringe)
    return state._replace(in_fringe=in_fringe,
                          fringe=torch.full_like(state.fringe, -1))


def _fresh_seq_state(ph: PaddedHypergraph, s: int, seed: int) -> _SeqState:
    dev = ph.v2e.device
    return _SeqState(
        assignment=torch.full((ph.n,), -1, dtype=torch.int32, device=dev),
        in_fringe=torch.zeros(ph.n, dtype=torch.bool, device=dev),
        fringe=torch.full((s,), -1, dtype=torch.int32, device=dev),
        cache=torch.full((ph.n + 1,), -1.0, dtype=torch.float32, device=dev),
        edge_active=torch.zeros(ph.m + 1, dtype=torch.bool, device=dev),
        core_size=0, rand_key=threefry.prng_key(seed))


def hype_jax_partition(hg: Hypergraph, k: int, *, s: int = 10, r: int = 2,
                       seed: int = 0, device=None,
                       return_stats: bool = False):
    """Sequential HYPE on padded arrays; an int32 ``(n,)`` assignment
    (with ``GrowthStats`` when ``return_stats``). ``device`` is ``None``
    (the card; raises without one), ``"cuda"`` or ``"cpu"``."""
    from .partition_api import resolve_device
    ph = PaddedHypergraph.from_hypergraph(hg, resolve_device(device))
    stats = GrowthStats()
    n = ph.n
    base, rem = divmod(n, k)
    state = _fresh_seq_state(ph, s, seed)
    for i in range(k - 1):
        state = _seq_grow(ph, state, i, base + (1 if i < rem else 0), s, r,
                          stats)
        state = _release_fringe(state, n, s)
    # the last partition absorbs the remainder
    a = torch.where(state.assignment < 0, k - 1, state.assignment)
    a = a.cpu().numpy().astype(np.int32)
    return (a, stats) if return_stats else a


# --------------------------------------------------------------------------- #
# Parallel k-way growth (paper §VI future work)
# --------------------------------------------------------------------------- #

def _parallel_impl(ph: PaddedHypergraph, k: int, c: int, seed: int,
                   stats: GrowthStats) -> torch.Tensor:
    """All k cores grow at once; one step assigns at most k vertices.

    Each partition scores ``c`` candidates drawn from its smallest live
    hyperedges and picks its best; collisions go to the smaller core,
    then the lower score, then the lower partition id, and the losers
    retry next step. A step nobody wins places a random vertex in the
    emptiest open partition. Returns the (n,) int32 assignment.
    """
    n, m = ph.n, ph.m
    dev = ph.v2e.device
    base, rem = divmod(n, k)
    targets = torch.tensor([base + (1 if i < rem else 0) for i in range(k)],
                           dtype=torch.int32, device=dev)
    parts = torch.arange(k, dtype=torch.int32, device=dev)
    rows = parts.long()

    key, sub = threefry.split(threefry.prng_key(seed))
    seeds = threefry.choice_without_replacement(sub, n, k, dev)
    assignment = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
    assignment[seeds] = parts
    core_sizes = torch.ones(k, dtype=torch.int32, device=dev)
    # edge_active[p, e]: edge e incident to core p (column m: scratch)
    edge_active = torch.zeros((k, m + 1), dtype=torch.bool, device=dev)
    es0 = ph.v2e[seeds]
    edge_active[rows[:, None], torch.where(es0 >= 0, es0, m).long()] = True

    e2v_safe = torch.where(ph.e2v >= 0, ph.e2v, 0).long()
    e2v_valid = ph.e2v >= 0

    def cond() -> torch.Tensor:
        return (assignment[:n] < 0).any() & (core_sizes < targets).any()

    go = bool(cond())
    while go:
        stats.iterations += 1
        unassigned = assignment[:n] < 0
        pin_univ = unassigned[e2v_safe] & e2v_valid          # (m, max_size)
        live = edge_active[:, :m] & pin_univ.any(dim=1)[None, :]
        sizes = torch.where(live, ph.edge_sizes[None, :], _INT32_MAX)
        # lax.top_k(-sizes, c): the c smallest, the lower index first
        eidx = torch.argsort(sizes, dim=1, stable=True)[:, :c]   # (k, c)
        has_edge = sizes.gather(1, eidx) < _INT32_MAX
        pins = pin_univ[eidx]                                # (k, c, S)
        j = torch.argmax(pins.to(torch.int32), dim=-1)       # first True
        first_ok = pins.gather(-1, j[..., None])[..., 0]
        cand = torch.where(has_edge & first_ok, ph.e2v[eidx, j], -1)
        sc = batched_dext_torch(ph.v2e, ph.e2v, cand.reshape(-1),
                                unassigned)
        scores = torch.where(cand >= 0, sc.view(k, c), _INF)
        bi = torch.argmin(scores, dim=1)
        pick = cand[rows, bi]
        pick_score = scores[rows, bi]
        full = core_sizes >= targets
        want = (pick >= 0) & ~full
        # collision priority: smaller core, then lower score (two float32
        # roundings, as JAX's program)
        prio = core_sizes.to(torch.float32) * 1e6
        prio = torch.where(want, prio + pick_score, _INF)
        at = torch.where(want, pick, n).long()
        best = torch.full((n + 1,), _INF, dtype=torch.float32, device=dev)
        best.scatter_reduce_(0, at, prio, "amin", include_self=True)
        win = want & (prio <= best[at])
        # exact ties: the lowest partition id wins
        at = torch.where(win, pick, n).long()
        first_p = torch.full((n + 1,), k, dtype=torch.int32, device=dev)
        first_p.scatter_reduce_(0, at, torch.where(win, parts, k), "amin",
                                include_self=True)
        win = win & (first_p[at] == parts)
        assignment[torch.where(win, pick, n).long()] = parts
        core_sizes = core_sizes + win.to(torch.int32)
        es = ph.v2e[torch.where(win, pick, 0).long()]        # (k, max_deg)
        upd = (es >= 0) & win[:, None]
        edge_active[rows[:, None], torch.where(upd, es, m).long()] = True
        key, sub = threefry.split(key)
        any_win, go = torch.stack([win.any(), cond()]).tolist()
        if not any_win:
            # rescue: a random vertex for the emptiest open partition
            stats.rescues += 1
            p = torch.argmin(torch.where(full, _INT32_MAX,
                                         core_sizes)).view(1)
            avail = assignment[:n] < 0
            v = _random_vertex(sub, avail)
            ok = avail.any()
            assignment[v] = torch.where(ok, p.to(torch.int32), assignment[v])
            core_sizes[p] += ok.to(torch.int32)
            es = ph.v2e[v][0]
            upd = (es >= 0) & ok
            edge_active[p, torch.where(upd, es, m).long()] = True
            go = bool(cond())
    # distribute leftovers by per-partition deficit (keeps balance exact)
    a = assignment[:n]
    deficit = torch.clamp_min(targets - core_sizes, 0).long()
    bounds = torch.cumsum(deficit, 0)
    rank = torch.cumsum((a < 0).long(), 0) - 1
    part_for_rank = torch.clamp_max(
        torch.searchsorted(bounds, rank, right=True), k - 1)
    return torch.where(a < 0, part_for_rank.to(torch.int32), a)


def hype_parallel_partition(hg: Hypergraph, k: int, *, candidates: int = 4,
                            seed: int = 0, device=None,
                            return_stats: bool = False):
    """Parallel k-way neighbourhood expansion; an int32 ``(n,)``
    assignment (with ``GrowthStats`` when ``return_stats``).

    Raises ``ValueError``, as JAX's does, when ``k`` exceeds the vertex
    count or ``candidates`` the hyperedge count (checked in that order).
    """
    from .partition_api import resolve_device
    if k > hg.n:
        raise ValueError(
            f"Cannot take a larger sample (size {k}) than population "
            f"(size {hg.n}) when 'replace=False'")
    if candidates > hg.m:
        raise ValueError(
            f"candidates={candidates} exceeds the {hg.m} hyperedges: "
            f"each step takes the candidates' edges by top_k")
    ph = PaddedHypergraph.from_hypergraph(hg, resolve_device(device))
    stats = GrowthStats()
    a = _parallel_impl(ph, k, candidates, seed, stats)
    a = a.cpu().numpy().astype(np.int32)
    return (a, stats) if return_stats else a
