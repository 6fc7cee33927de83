"""Candidate-scoring machinery shared by the port's engines.

Host side (numpy, copied from the JAX package): CSR slice gathering, the
tile-width buckets, the padded (B, L) neighbour tiles the ``hype_scores``
kernel consumes (``neighbor_tile_adj``, ``neighbor_tile``) and the
direct d_ext counts of the host-scored dribbles (``batched_dext_adj``,
``batched_dext_numpy``). Device side: torch versions of the four helpers
the JAX superstep programs trace around the fused score + select kernel,
and of the refinement screen around the ``kway_gains`` kernel
(``src/repro/core/scoring.py``), with the same semantics on any device.

JAX's ``mode="drop"`` scatters have no torch counterpart. The port's
image tensors therefore carry one scratch element at the end (``assign``
and ``cache`` are (n + 1,), ``acc`` is (k + 1,)): a masked-out write goes
to the scratch index, and nothing reads it back. This keeps every
scatter free of host syncs (no boolean-mask indexing) and every real
target unique, which CUDA's unordered ``index_put_`` needs.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..kernels.kway_refine.ops import kway_gains

# Width buckets for the (B, L) neighbour tile; rows wider than the last
# bucket are truncated and penalized.
L_BUCKETS = (32, 128, 512, 2048)
# Score added to candidates whose neighbour scan was truncated: they
# compare as "huge neighbourhood".
TRUNC_PENALTY = 1e12


def gather_csr_rows(indptr: np.ndarray, indices: np.ndarray,
                    ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate CSR slices ``indices[indptr[i]:indptr[i+1]]`` for ``ids``.

    Returns ``(values, owner)`` where ``owner[j]`` is the position in
    ``ids`` that produced ``values[j]``.
    """
    ids = np.asarray(ids, dtype=np.int64)
    starts = indptr[ids].astype(np.int64)
    lens = (indptr[ids + 1] - indptr[ids]).astype(np.int64)
    total = int(lens.sum())
    if total == 0:
        return (np.empty(0, dtype=indices.dtype),
                np.empty(0, dtype=np.int64))
    out_start = np.cumsum(lens) - lens
    pos = (np.arange(total, dtype=np.int64)
           - np.repeat(out_start, lens) + np.repeat(starts, lens))
    owner = np.repeat(np.arange(ids.size, dtype=np.int64), lens)
    return indices[pos], owner


def _bucket_width(width: int) -> int:
    for b in L_BUCKETS:
        if width <= b:
            return b
    return L_BUCKETS[-1]


def _pin_budget(erow: np.ndarray, elen: np.ndarray, rows: int,
                cap: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row pin budget over row-major (owner, length) edge pairs.

    Keeps whole edges until a row's cumulative pin count reaches ``cap``
    (hub protection). Returns ``(keep, truncated)``: a mask over the edge
    pairs and the per-row truncation flags — the single source of truth
    for the budget semantics shared by the kernel-tile and host paths.
    """
    excl = np.cumsum(elen) - elen
    row_first = np.searchsorted(erow, np.arange(rows, dtype=np.int64))
    # rows with no edges point past the end; they contribute nothing
    row_base = np.zeros(rows, dtype=np.int64)
    has = row_first < erow.size
    row_base[has] = excl[row_first[has]]
    keep = (excl - row_base[erow]) < cap
    truncated = np.zeros(rows, dtype=bool)
    np.logical_or.at(truncated, erow[~keep], True)
    return keep, truncated


def neighbor_tile_adj(adj, cands: np.ndarray, assignment: np.ndarray, *,
                      pad_b: int | None = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(B, L) tile from a precomputed adjacency CSR — gather only, no sort.

    ``adj`` is ``Hypergraph.vertex_adjacency()`` output: rows are already
    unique neighbor lists with self excluded, so building the tile is one
    CSR gather + an assigned-filter + a compacting scatter. Rows with more
    than ``L_BUCKETS[-1]`` surviving neighbors are truncated and flagged.
    """
    indptr, indices = adj
    cands = np.asarray(cands, dtype=np.int64)
    B = cands.size
    rows_out = pad_b or max(B, 1)
    if B == 0:
        return (np.full((rows_out, L_BUCKETS[0]), -1, np.int32),
                np.zeros(0, dtype=bool))
    nbrs, prow = gather_csr_rows(indptr, indices, cands)
    truncated = np.zeros(B, dtype=bool)
    if nbrs.size:
        nbrs = nbrs.astype(np.int64)
        keep = assignment[nbrs] < 0
        nbrs, prow = nbrs[keep], prow[keep]
    if nbrs.size:
        counts = np.bincount(prow, minlength=B)
        row_start = np.cumsum(counts) - counts
        offs = np.arange(nbrs.size, dtype=np.int64) - row_start[prow]
        max_w = L_BUCKETS[-1]
        truncated |= counts > max_w
        keep2 = offs < max_w
        prow, nbrs, offs = prow[keep2], nbrs[keep2], offs[keep2]
        L = _bucket_width(int(counts.clip(max=max_w).max()))
        tile = np.full((rows_out, L), -1, np.int32)
        tile[prow, offs] = nbrs
    else:
        tile = np.full((rows_out, L_BUCKETS[0]), -1, np.int32)
    return tile, truncated


def batched_dext_adj(adj, vs: np.ndarray, in_fringe: np.ndarray,
                     assignment: np.ndarray) -> np.ndarray:
    """d_ext over a precomputed adjacency CSR.

    Applies the same hub convention as ``neighbor_tile_adj``: vertices
    with more than ``L_BUCKETS[-1]`` unassigned neighbors (the tile width
    cut) get ``TRUNC_PENALTY`` added, so a candidate scores as a "huge
    neighborhood" hub regardless of which path scored it.
    """
    vs = np.asarray(vs, dtype=np.int64)
    if vs.size == 0:
        return np.zeros(0, dtype=np.float64)
    indptr, indices = adj
    nbrs, prow = gather_csr_rows(indptr, indices, vs)
    if not nbrs.size:
        return np.zeros(vs.size, dtype=np.float64)
    nbrs = nbrs.astype(np.int64)
    unassigned = assignment[nbrs] < 0
    ext = (~in_fringe[nbrs]) & unassigned
    scores = np.bincount(prow[ext], minlength=vs.size).astype(np.float64)
    wide = np.bincount(prow[unassigned],
                       minlength=vs.size) > L_BUCKETS[-1]
    scores[wide] += TRUNC_PENALTY
    return scores


def neighbor_tile(hg, cands: np.ndarray, assignment: np.ndarray, *,
                  cap_pins: int = 8192, pad_b: int | None = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Build the dense (B, L) neighbor tile for a candidate batch.

    For each candidate v, the row holds the *unique unassigned* neighbors
    of v (v itself excluded), -1 padded. Per-candidate work is capped at
    ``cap_pins`` scanned pins / ``L_BUCKETS[-1]`` unique neighbors; capped
    rows are flagged in the returned ``truncated`` mask and must receive a
    large score penalty (hubs compare as "huge neighborhood", which is
    what the paper's score wants anyway).

    Returns ``(tile, truncated)``: tile is int32 (pad_b or B, L) with L in
    ``L_BUCKETS``; truncated is bool (B,).
    """
    cands = np.asarray(cands, dtype=np.int64)
    B = cands.size
    rows_out = pad_b or max(B, 1)
    n = hg.n
    if B == 0:
        return (np.full((rows_out, L_BUCKETS[0]), -1, np.int32),
                np.zeros(0, dtype=bool))

    edges, erow = gather_csr_rows(hg.v2e_indptr, hg.v2e_indices, cands)
    edges = edges.astype(np.int64)
    truncated = np.zeros(B, dtype=bool)
    if edges.size:
        elen = (hg.e2v_indptr[edges + 1] - hg.e2v_indptr[edges]).astype(
            np.int64)
        keep, truncated = _pin_budget(erow, elen, B, cap_pins)
        edges, erow = edges[keep], erow[keep]

    pins, pidx = gather_csr_rows(hg.e2v_indptr, hg.e2v_indices, edges)
    prow = erow[pidx] if pins.size else pidx
    if pins.size:
        pins = pins.astype(np.int64)
        ok = (assignment[pins] < 0) & (pins != cands[prow])
        pins, prow = pins[ok], prow[ok]

    if pins.size:
        key = np.unique(prow * np.int64(n) + pins)
        prow2 = key // n
        pins2 = key % n
        counts = np.bincount(prow2, minlength=B)
        row_start = np.zeros(B, dtype=np.int64)
        row_start[1:] = np.cumsum(counts)[:-1]
        offs = np.arange(key.size, dtype=np.int64) - row_start[prow2]
        max_w = L_BUCKETS[-1]
        wide = counts > max_w
        truncated |= wide
        keep2 = offs < max_w
        prow2, pins2, offs = prow2[keep2], pins2[keep2], offs[keep2]
        L = _bucket_width(int(counts.clip(max=max_w).max()))
        tile = np.full((rows_out, L), -1, np.int32)
        tile[prow2, offs] = pins2
    else:
        tile = np.full((rows_out, L_BUCKETS[0]), -1, np.int32)
    return tile, truncated


def batched_dext_numpy(hg, vs: np.ndarray, in_fringe: np.ndarray,
                       assignment: np.ndarray, *,
                       cap_pins: int | None = None,
                       max_width: int | None = None) -> np.ndarray:
    """Vectorized d_ext(v, F) = |N(v) ∩ V'| for a batch of vertices.

    One pass over the concatenated pin lists of all candidates: gather,
    dedup (vertex, neighbor) pairs, count external ones. Bit-identical to
    the JAX package's ``core/hype.py`` per-vertex d_ext in the default
    "universe" mode when ``cap_pins`` and ``max_width`` are None. ``cap_pins`` truncates the
    per-candidate pin scan; ``max_width`` applies the kernel tile's
    width cut (> max_width unique unassigned neighbors). Either
    truncation adds ``TRUNC_PENALTY`` (same convention as the tile path).
    """
    vs = np.asarray(vs, dtype=np.int64)
    if vs.size == 0:
        return np.zeros(0, dtype=np.float64)
    n = hg.n
    edges, erow = gather_csr_rows(hg.v2e_indptr, hg.v2e_indices, vs)
    edges = edges.astype(np.int64)
    truncated = np.zeros(vs.size, dtype=bool)
    if cap_pins is not None and edges.size:
        elen = (hg.e2v_indptr[edges + 1] - hg.e2v_indptr[edges]).astype(
            np.int64)
        keep, truncated = _pin_budget(erow, elen, vs.size, cap_pins)
        edges, erow = edges[keep], erow[keep]
    pins, pidx = gather_csr_rows(hg.e2v_indptr, hg.e2v_indices, edges)
    scores = np.zeros(vs.size, dtype=np.float64)
    if pins.size:
        prow = erow[pidx]
        key = np.unique(prow * np.int64(n) + pins.astype(np.int64))
        prow2 = key // n
        pins2 = key % n
        unassigned = assignment[pins2] < 0
        ext = (~in_fringe[pins2]) & unassigned
        scores = np.bincount(prow2[ext], minlength=vs.size).astype(
            np.float64)
        # v itself is a pin of each incident edge: counted once iff it is
        # still "external" and has at least one edge.
        deg = hg.v2e_indptr[vs + 1] - hg.v2e_indptr[vs]
        self_ext = (~in_fringe[vs]) & (assignment[vs] < 0) & (deg > 0)
        scores = np.maximum(scores - self_ext, 0.0)
        if max_width is not None:
            nonself = pins2 != vs[prow2]
            wide = np.bincount(prow2[unassigned & nonself],
                               minlength=vs.size) > max_width
            scores[wide] += TRUNC_PENALTY
    scores[truncated] += TRUNC_PENALTY
    return scores


# ------------------------------------------------------------ device side

def _apply_host_injections(assign, cache, acc, delta_ids, delta_vals,
                           dirty_ids, dirty_counts):
    """Apply the host's seeds/restarts and the queued cache decrements.

    Returns new ``(assign, cache, acc)`` tensors; the inputs stay as they
    were (the poison guard reverts to them). The injected ids are unique
    and the dirty ids are unique, so each real element takes exactly one
    write or one IEEE add, as in JAX; only the scratch slot sees repeats.
    """
    n = assign.shape[0] - 1
    n_acc = acc.shape[0] - 1
    inj = delta_ids >= 0
    assign = assign.index_put((torch.where(inj, delta_ids, n).long(),),
                              delta_vals)
    acc = acc.index_add(0, torch.where(inj, delta_vals, n_acc).long(),
                        torch.ones_like(delta_vals))
    cache = cache.index_add(
        0, torch.where(dirty_ids >= 0, dirty_ids, n).long(), -dirty_counts)
    return assign, cache, acc


def _gather_fresh_tiles(indptr, indices, assign, flat, tile_l: int):
    """Gather the fresh candidates' CSR rows at the fixed width ``tile_l``.

    Assigned neighbours are masked to -1 in place (no compaction: the
    kernel counts valid entries, not positions). Every index is clamped
    before it is used: CUDA raises on an out-of-range gather where JAX
    clamps.
    """
    fsafe = torch.where(flat >= 0, flat, 0).long()
    fstart = indptr[fsafe]
    fdeg = indptr[fsafe + 1] - fstart
    col = torch.arange(tile_l, dtype=indptr.dtype, device=indptr.device)
    fvalid = (col < fdeg[:, None]) & (flat >= 0)[:, None]
    nbr = indices[torch.where(fvalid, fstart[:, None] + col, 0).long()]
    unassigned = assign[torch.where(fvalid, nbr, 0).long()] < 0
    return torch.where(fvalid & unassigned, nbr, -1).to(torch.int32)


def _stale_masked_prev(pool, assign, cache):
    """Held pool scores from the cache; stale slots masked to +inf.

    A slot is stale when an interleaved superstep of the pipeline has
    assigned its vertex. Returns ``(prev (G, P) f32, n_stale i32)``.
    """
    psafe = torch.where(pool >= 0, pool, 0).long()
    pool_ok = (pool >= 0) & (assign[psafe] < 0)
    prev = torch.where(pool_ok, cache[psafe], float("inf"))
    n_stale = ((pool >= 0) & ~pool_ok).sum(dtype=torch.int32)
    return prev, n_stale


def _poison_guard(flat, scores_flat, poison, reset):
    """True when the superstep must revert (a 0-d bool tensor, no sync).

    A real row (``flat >= 0``) with a non-finite score poisons the
    superstep; the sticky ``poison`` flag of an earlier superstep
    poisons it too unless ``reset`` marks a replay.
    """
    bad = ((flat >= 0) & ~torch.isfinite(scores_flat)).any()
    return bad | ((poison[0] > 0) & (reset[0] == 0))


# ------------------------------------------------------------ k-way refine
# Device half of the refinement screen: apply the host's admitted-move
# delta to the device assignment, gather the candidates' neighbour
# *partitions* from the device CSR, and run the ``kway_gains`` kernel, so
# only candidate ids go down and (B, k) gain rows come back.

def _gather_part_tiles(indptr, indices, assign, cand, tile_l: int):
    """Neighbour-partition tile for ``cand`` at the fixed width ``tile_l``.

    The refinement sibling of ``_gather_fresh_tiles``: the same CSR
    gather, but rows hold the neighbours' partition ids (every
    neighbour, assigned or not) instead of unassigned vertex ids. Pads
    are -1; every gather index is clamped first.
    """
    csafe = torch.where(cand >= 0, cand, 0).long()
    start = indptr[csafe]
    deg = indptr[csafe + 1] - start
    col = torch.arange(tile_l, dtype=indptr.dtype, device=indptr.device)
    valid = (col < deg[:, None]) & (cand >= 0)[:, None]
    nbr = indices[torch.where(valid, start[:, None] + col, 0).long()]
    return torch.where(valid, assign[nbr.long()], -1).to(torch.int32)


def refine_gains_device(indptr, indices, assign, delta_ids, delta_vals,
                        cand, *, tile_l: int, k: int):
    """One refinement screening call; returns ``(assign, gains)``.

    ``assign`` is the (n + 1,) int32 device assignment with its scratch
    slot; the host's admitted moves since the previous call
    (``delta_ids``/``delta_vals``, -1 padded, unique ids) are written
    into it in place, pads landing on the scratch slot. ``cand`` is the
    (-1 padded) int32 candidate tile. ``gains`` is (B, k) float32:
    ``gains[b, q]`` is the connectivity gain of moving ``cand[b]`` to
    partition ``q`` (0 for ``q == own`` and for pad rows).
    """
    n = assign.shape[0] - 1
    inj = delta_ids >= 0
    assign.index_put_((torch.where(inj, delta_ids, n).long(),), delta_vals)
    parts = _gather_part_tiles(indptr, indices, assign, cand, tile_l)
    csafe = torch.where(cand >= 0, cand, 0).long()
    own = torch.where(cand >= 0, assign[csafe], -1).to(torch.int32)
    return assign, kway_gains(parts, own, k=k)
