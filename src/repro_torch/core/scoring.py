"""Candidate-scoring machinery shared by the port's engines.

Host side (numpy, copied from the JAX package): CSR slice gathering and
the tile-width buckets. Device side: torch versions of the four helpers
the JAX superstep programs trace around the fused score + select kernel
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
