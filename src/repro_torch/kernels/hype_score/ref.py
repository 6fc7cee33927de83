"""Plain PyTorch versions of the scoring kernels.

The same functions as ``csrc/score_select.cu``, ``csrc/scores.cu`` and
``csrc/stream_commit.cu`` in tensor ops: the CPU paths of
``ops.hype_score_select``, ``ops.hype_scores`` and ``ops.stream_commit``
and the yardsticks the card's kernels are compared with. Selection is an iterative argmin that mirrors the TPU
kernel round for round (lowest index wins a tie, a taken slot becomes
+inf, a NaN in a phase gives index R + P) -- not ``torch.topk``, whose
tie order differs from the reference's stable order.
"""
from __future__ import annotations

import torch

# Scores at or above this are "not a candidate" (padded rows, empty pool
# slots); +inf marks a slot already taken. Any real score, the 1e12 hub
# penalty included, sits far below it.
SELECT_PAD = 1e30


def _external_count(nbrs: torch.Tensor, fringe: torch.Tensor,
                    ) -> torch.Tensor:
    """``#valid - #(valid & in fringe)`` over the last axis, as int32.

    ``fringe`` holds one row of s ids per leading index of ``nbrs``
    (broadcast over the rows); membership ORs the fringe slots, so a
    duplicated fringe id counts a neighbour once.
    """
    valid = nbrs >= 0
    member = torch.zeros_like(valid)
    for j in range(fringe.shape[-1]):
        member |= nbrs == fringe[..., j, None, None]
    member &= valid
    return (valid.sum(-1, dtype=torch.int32)
            - member.sum(-1, dtype=torch.int32))


def hype_scores_ref(nbrs: torch.Tensor, fringe: torch.Tensor
                    ) -> torch.Tensor:
    """d_ext score per row: nbrs (B, L) int32, -1 padded; fringe (s,)
    int32, -1 padded. Returns (B,) int32."""
    return _external_count(nbrs[None], fringe[None])[0]


def hype_score_select_ref(nbrs: torch.Tensor, fringe: torch.Tensor,
                          bias: torch.Tensor, prev: torch.Tensor,
                          select_k: int):
    """Score every fresh row, then take each phase's ``select_k`` best.

    nbrs (G, R, L) int32, -1 padded; fringe (G, s) int32, -1 padded;
    bias (G, R) float32; prev (G, P) float32 held pool scores (+inf =
    empty). Returns ``(scores (G, R) f32, sel_idx (G, select_k) i32,
    sel_val (G, select_k) f32, rem (G,) i32)``: ``sel_idx < R`` names a
    fresh row, ``>= R`` pool slot ``idx - R``; ``rem`` counts the slots
    still below ``SELECT_PAD`` after selection.
    """
    G, R, _ = nbrs.shape
    scores = _external_count(nbrs, fringe).to(torch.float32) + bias
    # clamp keeps NaN, as jnp.minimum does; the scalar bounds are cast
    # to float32, so no tensor constant (and no host copy) is needed
    merged = torch.clamp(torch.cat([scores, prev], dim=1), max=SELECT_PAD)
    n_slots = merged.shape[1]
    pos = torch.arange(n_slots, dtype=torch.int32, device=nbrs.device)
    sel_i, sel_v = [], []
    for _ in range(select_k):
        mv = merged.amin(dim=1, keepdim=True)
        am = torch.where(merged == mv, pos, n_slots).amin(dim=1)
        sel_i.append(am)
        sel_v.append(mv[:, 0])
        merged = torch.where(pos == am[:, None], float("inf"), merged)
    rem = (merged < SELECT_PAD).sum(dim=1, dtype=torch.int32)
    return (scores, torch.stack(sel_i, dim=1).to(torch.int32),
            torch.stack(sel_v, dim=1), rem)


def hype_score_select_shard_ref(nbrs_local: torch.Tensor,
                                fringe: torch.Tensor, bias: torch.Tensor,
                                prev: torch.Tensor, select_k: int,
                                shard_offset: int):
    """``hype_score_select_ref`` of one phase-group shard: the global
    (G, ...) ``fringe``, ``bias`` and ``prev`` sliced to the shard's
    ``nbrs_local.shape[0]`` phases from ``shard_offset``."""
    gl = slice(int(shard_offset), int(shard_offset) + nbrs_local.shape[0])
    return hype_score_select_ref(nbrs_local, fringe[gl], bias[gl], prev[gl],
                                 select_k)


# Fibonacci multiplicative hashing of the streaming engine's sketch: an
# id's bucket is the top ``bits`` bits of uint32(id) * STREAM_HASH_MULT,
# in uint32 arithmetic.
STREAM_HASH_MULT = 2654435761


def stream_bucket_ref(ids: torch.Tensor, bits: int) -> torch.Tensor:
    """Bucket of each id of an integer tensor, as int64 in [0, 2**bits).

    A pad id (-1) hashes as uint32 0xFFFFFFFF does, to a bucket in range.
    torch has no uint32 product, so the product is taken mod 2**32 in
    int64 with the multiplier split in 16-bit halves (nothing passes
    2**49).
    """
    x = ids.to(torch.int64) & 0xFFFFFFFF
    hi, lo = STREAM_HASH_MULT >> 16, STREAM_HASH_MULT & 0xFFFF
    h = ((((x * hi) & 0xFFFF) << 16) + x * lo) & 0xFFFFFFFF
    return h >> (32 - bits)


def stream_commit_ref(edge_tile: torch.Tensor, fcnt: torch.Tensor,
                      valid_row: torch.Tensor, sketch: torch.Tensor,
                      sizes: torch.Tensor, *, alpha: float, fringe_w: float,
                      inv_target: float, cap: int,
                      sketch_bits: int) -> torch.Tensor:
    """Commit a micro-batch row by row against the live sketch and sizes.

    edge_tile (mb, Le) int32 incident-edge ids, -1 padded; fcnt (mb, k)
    float32 fringe counts; valid_row (mb,) bool; sketch (k, 2**bits) and
    sizes (k,) int32, updated in place. Row i scores partition p as
    ``(conn + fringe_w * fcnt[i, p]) - (alpha * sizes[p]) * inv_target``
    in float32 (-inf where ``sizes[p] >= cap``), ``conn`` counting the
    row's valid pins whose bucket is present in ``sketch[p]``; the first
    maximum wins, and a valid row adds one to its partition's size and
    to the partition's bucket of each valid pin. Returns parts (mb,)
    int32, -1 on pad rows. Makes no host sync.
    """
    dev = edge_tile.device
    mb, k = edge_tile.shape[0], sketch.shape[0]

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    alpha, fringe_w, inv_target = f32(alpha), f32(fringe_w), f32(inv_target)
    e_valid = edge_tile >= 0
    buckets = stream_bucket_ref(edge_tile, sketch_bits)
    pos = torch.arange(k, device=dev)
    parts = torch.full((mb,), -1, dtype=torch.int32, device=dev)
    for i in range(mb):
        conn = ((sketch[:, buckets[i]] > 0) & e_valid[i]).sum(1)
        score = ((conn.to(torch.float32) + fringe_w * fcnt[i])
                 - (alpha * sizes.to(torch.float32)) * inv_target)
        score = torch.where(sizes >= cap, float("-inf"), score)
        p = torch.where(score == score.max(), pos, k).min()
        upd = valid_row[i]
        sizes.index_add_(0, p.view(1), upd.to(sizes.dtype).view(1))
        sketch.index_put_((p.expand(buckets.shape[1]), buckets[i]),
                          (e_valid[i] & upd).to(sketch.dtype),
                          accumulate=True)
        parts[i] = torch.where(upd, p, -1)
    return parts
