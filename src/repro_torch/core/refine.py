"""K-way refinement post-pass, with the screen on the device.

The port of ``src/repro/core/refine.py``. Given a complete k-way
assignment, boundary-vertex passes move vertices between partitions to
shrink the (k-1) objective while keeping the engine's balance
guarantee. Each pass is screen -> verify -> admit:

  1. **boundary detection** (host, one vectorized pin scan): vertices on
     cut hyperedges, the only vertices whose move can change (k-1);
  2. **screening** (device): the boundary ids go down in fixed-size
     tiles, and the ``kway_gains_csr`` kernel ranks every candidate's k
     move targets by connectivity gain over its first ``tile_l``
     neighbours' partitions, read in one launch from
     ``Hypergraph.device_adjacency`` and a device assignment that the
     host's admitted-move deltas keep in sync
     (``scoring.refine_gains_device``); only (B, k) gain rows come back;
  3. **exact verification** (host, vectorized): the top screened
     candidates get their exact per-edge (k-1) deltas. The screen only
     ranks, but the rank decides which ``cand_cap`` candidates are
     verified, so the kernel's gains must be bit-exact;
  4. **deterministic balance-capped admission**: positive-exact-gain
     moves are admitted greedily (gain descending, vertex id as the tie
     break) under edge-disjointness (admitted gains are exactly
     additive) and the balance window ``[lo, hi]``; moves blocked only
     by balance wait in per-direction pending lists and are admitted as
     balance-neutral swap pairs when an opposite move shows up.

``refine_passes = 0`` is a strict no-op; a pass that admits nothing
stops the refinement. The same machinery drives the multilevel
partitioners' uncoarsening (``multilevel.py``), with vertex weights and
a widened window.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .hypergraph import Hypergraph
from . import scoring


@dataclasses.dataclass
class RefineStats:
    """Counters for one ``refine_kway`` call."""
    passes_run: int = 0         # passes that admitted at least one move
    boundary_rows: int = 0      # candidate rows screened (device or host)
    kernel_calls: int = 0       # device screening calls
    host_rows: int = 0          # rows screened by the host path
    proposals: int = 0          # positive-exact-gain admission proposals
    moves: int = 0              # admitted moves (swap members included)
    swaps: int = 0              # balance-neutral swap pairs admitted
    gain: int = 0               # exact total k-1 reduction (additive)
    rejected_conflict: int = 0  # proposals dropped by edge-disjointness
    rejected_balance: int = 0   # proposals left pending without a partner


def _cut_boundary(hg: Hypergraph, assignment: np.ndarray) -> np.ndarray:
    """Unique vertices incident to cut hyperedges (one vectorized scan)."""
    part_of_pin = assignment[hg.e2v_indices]
    sizes = hg.edge_sizes
    nz = sizes > 0
    if not nz.any():
        return np.empty(0, dtype=np.int64)
    starts = hg.e2v_indptr[:-1][nz]
    pmin = np.minimum.reduceat(part_of_pin, starts)
    pmax = np.maximum.reduceat(part_of_pin, starts)
    cut_edges = np.flatnonzero(nz)[pmin != pmax]
    if cut_edges.size == 0:
        return np.empty(0, dtype=np.int64)
    pins, _ = scoring.gather_csr_rows(hg.e2v_indptr, hg.e2v_indices,
                                      cut_edges)
    return np.unique(pins.astype(np.int64))


def _host_gains(adj, cand: np.ndarray, assignment: np.ndarray,
                k: int) -> np.ndarray:
    """Host twin of the ``kway_gains`` screen (full width, no tile cut)."""
    nbrs, owner = scoring.gather_csr_rows(adj[0], adj[1], cand)
    cnt = np.zeros((cand.size, k), dtype=np.int64)
    if nbrs.size:
        parts = assignment[nbrs.astype(np.int64)].astype(np.int64)
        cnt = np.bincount(owner * k + parts,
                          minlength=cand.size * k).reshape(cand.size, k)
    own = assignment[cand]
    return (cnt - cnt[np.arange(cand.size), own][:, None]).astype(
        np.float32)


def exact_gain_matrix(hg: Hypergraph, cand: np.ndarray,
                      assignment: np.ndarray, k: int) -> np.ndarray:
    """Exact per-vertex (k-1) move gains, all k targets at once.

    For ``v`` in partition ``p``, moving to ``q`` changes (k-1) by
    ``-(free(v) - pen(v, q))`` where ``free(v)`` counts incident edges
    whose only ``p``-pin is ``v`` and ``pen(v, q)`` counts incident
    edges with no ``q``-pin yet. Returned as gain = free - pen, positive
    = (k-1) drops; column ``own`` is fixed to 0. No (m, k) matrix is
    ever materialized.
    """
    M = cand.size
    gains = np.zeros((M, k), dtype=np.int64)
    es, owner = scoring.gather_csr_rows(hg.v2e_indptr, hg.v2e_indices,
                                        cand)
    if es.size == 0:
        return gains
    es = es.astype(np.int64)
    ue, inv = np.unique(es, return_inverse=True)
    pins, prow = scoring.gather_csr_rows(hg.e2v_indptr, hg.e2v_indices,
                                         ue)
    cnt = np.bincount(
        prow * k + assignment[pins.astype(np.int64)].astype(np.int64),
        minlength=ue.size * k).reshape(ue.size, k)
    own = assignment[cand].astype(np.int64)
    sole = cnt[inv, own[owner]] == 1
    free = np.bincount(owner[sole], minlength=M)
    # pen via the present (edge, partition) pairs: a cut edge spans few
    # of the k partitions, so expanding each (v, e) incidence by its
    # edge's present-partition list stays O(pins * mean span)
    pres_pairs = cnt > 0
    span = pres_pairs.sum(axis=1)
    ei, qi = np.nonzero(pres_pairs)              # sorted by edge row
    eptr = np.zeros(ue.size + 1, dtype=np.int64)
    eptr[1:] = np.cumsum(span)
    qs, pidx = scoring.gather_csr_rows(eptr, qi, inv)
    pres = np.bincount(owner[pidx] * k + qs,
                       minlength=M * k).reshape(M, k)
    deg = (hg.v2e_indptr[cand + 1] - hg.v2e_indptr[cand]).astype(np.int64)
    gains = free[:, None] - (deg[:, None] - pres)
    gains[np.arange(M), own] = 0
    return gains


def admit_moves(vs: np.ndarray, src: np.ndarray, dst: np.ndarray,
                gain: np.ndarray, hg: Hypergraph, sizes: np.ndarray,
                lo: np.ndarray, hi: np.ndarray, stats: RefineStats,
                weights: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy edge-disjoint balance-capped admission (deterministic).

    Proposals must arrive sorted (gain descending, vertex id ascending).
    A proposal is admitted when none of its incident hyperedges is
    frozen by an earlier admission and the move keeps every partition
    size inside ``[lo, hi]``. Balance-blocked unit-weight proposals wait
    in per-direction pending lists and are admitted as swap pairs when
    an opposite-direction proposal arrives (both sides' edges still
    unfrozen and mutually disjoint). ``sizes`` is updated in place;
    returns the admitted ``(vertices, targets)``.
    """
    indptr, indices = hg.v2e_indptr, hg.v2e_indices
    frozen = np.zeros(hg.m, dtype=bool)
    pending: dict = {}
    adm_v: list = []
    adm_dst: list = []
    for i in range(vs.size):
        v, p, q = int(vs[i]), int(src[i]), int(dst[i])
        es = indices[indptr[v]:indptr[v + 1]]
        if frozen[es].any():
            stats.rejected_conflict += 1
            continue
        wv = 1 if weights is None else weights[v]
        if sizes[p] - wv >= lo[p] and sizes[q] + wv <= hi[q]:
            sizes[p] -= wv
            sizes[q] += wv
            frozen[es] = True
            adm_v.append(v)
            adm_dst.append(q)
            stats.moves += 1
            stats.gain += int(gain[i])
            continue
        if weights is None:
            matched = False
            partners = pending.get((q, p))
            if partners:
                for pos, j in enumerate(partners):
                    u = int(vs[j])
                    eu = indices[indptr[u]:indptr[u + 1]]
                    if frozen[eu].any():
                        continue        # partner went stale; skip it
                    frozen[es] = True   # mutual disjointness check
                    if frozen[eu].any():
                        frozen[es] = False
                        continue
                    frozen[eu] = True
                    adm_v.extend((v, u))
                    adm_dst.extend((q, p))
                    partners.pop(pos)
                    stats.moves += 2
                    stats.swaps += 1
                    stats.gain += int(gain[i]) + int(gain[j])
                    stats.rejected_balance -= 1   # the revived partner
                    matched = True
                    break
            if matched:
                continue
            pending.setdefault((p, q), []).append(i)
        stats.rejected_balance += 1
    return (np.asarray(adm_v, dtype=np.int64),
            np.asarray(adm_dst, dtype=np.int32))


def _padded(ids: np.ndarray, size: int, device,
            fill: int = -1) -> torch.Tensor:
    """``ids`` in a ``fill``-padded int32 device tensor of ``size``."""
    buf = np.full(size, fill, dtype=np.int32)
    buf[:ids.size] = ids
    return torch.from_numpy(buf).to(device)


def refine_kway(hg: Hypergraph, assignment: np.ndarray, k: int,
                passes: int, *, weights: Optional[np.ndarray] = None,
                lo: Optional[np.ndarray] = None,
                hi: Optional[np.ndarray] = None,
                cand_cap: int = 8192, tile_rows: int = 4096,
                use_device: Optional[bool] = None, device=None,
                candidates: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, RefineStats]:
    """Run up to ``passes`` boundary-refinement passes; see module doc.

    Returns ``(refined assignment copy, RefineStats)``. With the default
    unit weights the balance window is the engines'
    ``[floor(n/k), ceil(n/k)]`` contract, widened to the incoming sizes
    when those already sit outside it. ``weights``/``lo``/``hi`` switch
    to weighted windows (the multilevel uncoarsening path; the swap
    matcher is unit-weight-only and disabled there). The screen runs on
    ``device`` through the ``kway_gains_csr`` kernel unless ``use_device``
    is False or the adjacency guard trips, and on the host otherwise;
    ``use_device=None`` means True. A device screen needs ``device``.
    ``passes <= 0`` or ``k <= 1`` return the input unchanged (same
    array, zero stats). ``candidates`` restricts every pass to the given
    vertex ids.
    """
    stats = RefineStats()
    if passes <= 0 or k <= 1 or hg.n == 0:
        return assignment, stats
    if (assignment < 0).any():
        raise ValueError("refinement requires a complete assignment")
    assignment = np.array(assignment, dtype=np.int32, copy=True)
    n = hg.n
    if weights is None:
        sizes = np.bincount(assignment, minlength=k).astype(np.int64)
        if lo is None:
            lo = np.full(k, n // k, dtype=np.int64)
        if hi is None:
            hi = np.full(k, -(-n // k), dtype=np.int64)
    else:
        if lo is None or hi is None:
            raise ValueError("weighted refinement needs explicit lo/hi")
        sizes = np.zeros(k, dtype=np.float64)
        np.add.at(sizes, assignment, weights)
    lo = np.minimum(np.asarray(lo), sizes)   # inherited violations never
    hi = np.maximum(np.asarray(hi), sizes)   # block (nor worsen) a pass

    adj = hg.vertex_adjacency()
    if adj is None:
        return assignment, stats    # hub-expansion guard: skip refining
    use_dev = use_device if use_device is not None else True
    if use_dev:
        if device is None:
            raise ValueError("a device screen needs a device")
        dev = hg.device_adjacency(device)
        if dev is None:
            use_dev = False
    if use_dev:
        # (n + 1,): the last element is the scratch slot of the masked
        # delta writes (core/scoring.py)
        tdev = dev[0].device
        dev_assign = torch.from_numpy(
            np.append(assignment, np.int32(-1))).to(tdev)
        deg = np.diff(adj[0])
        tile_l = scoring._bucket_width(int(min(
            np.percentile(deg, 99.5) if deg.size else 1,
            scoring.L_BUCKETS[-1])))
        # a pass admits at most cand_cap moves (moves <= proposals), so
        # the delta buffer must hold that many, not just one tile
        delta_cap = max(tile_rows, cand_cap)
        pend_ids = np.empty(0, dtype=np.int64)
        pend_vals = np.empty(0, dtype=np.int32)

    if candidates is not None:
        candidates = np.unique(np.asarray(candidates, dtype=np.int64))
    for _ in range(passes):
        boundary = _cut_boundary(hg, assignment)
        if candidates is not None:
            boundary = np.intersect1d(boundary, candidates,
                                      assume_unique=True)
        if boundary.size == 0:
            break
        stats.boundary_rows += int(boundary.size)
        # ---- screen: rank the boundary by best-target move gain ----
        # (the ranking only needs each row's best gain; the admitted
        # target is recomputed from the exact gains below)
        best_g = np.empty(boundary.size, dtype=np.float32)
        if use_dev:
            for b0 in range(0, boundary.size, tile_rows):
                chunk = boundary[b0:b0 + tile_rows]
                dev_assign, gains = scoring.refine_gains_device(
                    dev[0], dev[1], dev_assign,
                    _padded(pend_ids, delta_cap, tdev),
                    _padded(pend_vals, delta_cap, tdev, fill=0),
                    _padded(chunk, tile_rows, tdev),
                    tile_l=tile_l, k=k)
                pend_ids = np.empty(0, dtype=np.int64)
                pend_vals = np.empty(0, dtype=np.int32)
                stats.kernel_calls += 1
                g = gains[:chunk.size].cpu().numpy().copy()
                own = assignment[chunk]
                g[np.arange(chunk.size), own] = -np.inf
                best_g[b0:b0 + chunk.size] = g.max(axis=1)
        else:
            g = _host_gains(adj, boundary, assignment, k)
            stats.host_rows += int(boundary.size)
            own = assignment[boundary]
            g[np.arange(boundary.size), own] = -np.inf
            best_g = g.max(axis=1)
        # ---- verify: exact (k-1) gains for the top screened rows ----
        order = np.lexsort((boundary, -best_g))
        cand = boundary[order][:cand_cap]
        exact = exact_gain_matrix(hg, cand, assignment, k)
        own = assignment[cand].astype(np.int64)
        exact[np.arange(cand.size), own] = np.iinfo(np.int64).min
        bq = exact.argmax(axis=1)
        bgain = exact[np.arange(cand.size), bq]
        pos = bgain > 0
        stats.proposals += int(pos.sum())
        if not pos.any():
            break
        pv, pq, pg = cand[pos], bq[pos], bgain[pos]
        psrc = own[pos]
        order2 = np.lexsort((pv, -pg))
        adm_v, adm_dst = admit_moves(
            pv[order2], psrc[order2], pq[order2], pg[order2], hg,
            sizes, lo, hi, stats, weights=weights)
        if adm_v.size == 0:
            break
        assignment[adm_v] = adm_dst
        stats.passes_run += 1
        if use_dev:     # sync the device assignment at the next screen
            pend_ids = adm_v
            pend_vals = adm_dst
    return assignment, stats


def rebalance_kway(hg: Hypergraph, assignment: np.ndarray,
                   k: int) -> np.ndarray:
    """Force exact ``max - min <= 1`` balance with least-damage moves.

    Used by the multilevel partitioner's finest level, where projected
    coarse assignments balance coarse-vertex weights only. Target sizes
    are the balanced ``base (+1)`` vector permuted so the largest
    incoming partitions keep the ``+1`` slots (fewest forced moves);
    donors' vertices flow to deficit partitions in connectivity-gain
    order. Deterministic; returns a copy.
    """
    assignment = np.array(assignment, dtype=np.int32, copy=True)
    n = hg.n
    sizes = np.bincount(assignment, minlength=k).astype(np.int64)
    base, rem = divmod(n, k)
    order = np.argsort(-sizes, kind="stable")
    target = np.full(k, base, dtype=np.int64)
    target[order[:rem]] += 1
    excess = sizes - target
    if not excess.any():
        return assignment
    adj = hg.vertex_adjacency()
    donors = np.flatnonzero(excess > 0)
    cand = np.flatnonzero(np.isin(assignment, donors))
    if adj is not None:
        # chunked: the (cand, k) gain matrix of a large donor set would
        # otherwise dominate memory for the handful of needed moves
        g = np.empty((cand.size, k), dtype=np.float32)
        for c0 in range(0, cand.size, 65536):
            g[c0:c0 + 65536] = _host_gains(adj, cand[c0:c0 + 65536],
                                           assignment, k)
    else:
        g = np.zeros((cand.size, k), dtype=np.float32)
    own = assignment[cand]
    g[np.arange(cand.size), own] = -np.inf
    bg = g.max(axis=1)
    for i in np.lexsort((cand, -bg)):
        v = int(cand[i])
        p = int(assignment[v])
        if excess[p] <= 0:
            continue
        recv = excess < 0
        row = np.where(recv, g[i], -np.inf)
        q = int(row.argmax())
        if not recv[q]:
            continue
        assignment[v] = q
        excess[p] -= 1
        excess[q] += 1
        if not (excess > 0).any():
            break
    return assignment
