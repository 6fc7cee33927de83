"""The scoring wrappers: the tensors' device picks the kernel.

A CUDA tensor goes to the hand-written Hopper kernel
(``csrc/score_select.cu``, ``csrc/scores.cu`` and
``csrc/stream_commit.cu``, built by ``kernels._build``); a CPU tensor
goes to the plain version in ``ref.py``. There is no other switch and no
fallback: a failed build or launch raises. ``hype_score_select.launches``,
``hype_scores.launches`` and ``stream_commit.launches`` count the CUDA
launches, so a run can show that its path went through the kernels.
"""
from __future__ import annotations

import torch

from .._build import load_extension, on_cuda
from .ref import (SELECT_PAD, hype_score_select_ref, hype_scores_ref,
                  stream_commit_ref)

__all__ = ["SELECT_PAD", "hype_score_select", "hype_score_select_shard",
           "hype_scores", "stream_commit"]


def hype_scores(nbrs: torch.Tensor, fringe: torch.Tensor) -> torch.Tensor:
    """d_ext score per row of a (B, L) int32 tile (-1 pad) against one
    (s,) int32 fringe (-1 pad); returns (B,) int32 as
    ``ref.hype_scores_ref`` defines it, on either device."""
    if not on_cuda(nbrs, "hype_scores"):
        return hype_scores_ref(nbrs, fringe)
    out = load_extension().scores(nbrs, fringe)
    hype_scores.launches += 1
    return out


def hype_score_select(nbrs: torch.Tensor, fringe: torch.Tensor,
                      bias: torch.Tensor, prev: torch.Tensor, *,
                      select_k: int):
    """Fused scoring + per-phase top-``select_k`` selection.

    nbrs (G, R, L) int32 stacked phase tiles, -1 padded; fringe (G, s)
    int32, any width; bias (G, R) float32 additive row bias (the
    hub penalty, or +inf for a pad row); prev (G, P) float32 held pool
    scores. Returns ``(scores (G, R), sel_idx (G, select_k), sel_val
    (G, select_k), rem (G,))`` as ``ref.hype_score_select_ref`` defines
    them, bit for bit on either device. Where a phase holds a NaN the
    outputs are unspecified, except that every ``sel_idx`` stays in
    ``[0, R + P]``.
    """
    if not on_cuda(nbrs, "hype_score_select"):
        return hype_score_select_ref(nbrs, fringe, bias, prev, select_k)
    out = load_extension().score_select(nbrs, fringe, bias, prev,
                                        int(select_k))
    hype_score_select.launches += 1
    return out  # a tuple from the binding


def hype_score_select_shard(nbrs_local: torch.Tensor, fringe: torch.Tensor,
                            bias: torch.Tensor, prev: torch.Tensor, *,
                            select_k: int, shard_offset: int):
    """Fused score + select for one phase-group shard of a superstep.

    The sharded engine stacks all G phases' ``fringe`` (G, s), ``bias``
    (G, R) and ``prev`` (G, P), but each rank gathers and scores only its
    own contiguous group of ``gL = nbrs_local.shape[0]`` phases, starting
    at phase ``shard_offset``. The three global arrays are sliced to
    ``[shard_offset, shard_offset + gL)`` (slices along dim 0 of a
    contiguous tensor stay contiguous, as the kernel requires) and go to
    ``hype_score_select``: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU one. Returns its four outputs for the shard's phases.
    """
    gl = slice(int(shard_offset), int(shard_offset) + nbrs_local.shape[0])
    return hype_score_select(nbrs_local, fringe[gl], bias[gl], prev[gl],
                             select_k=select_k)


def stream_commit(edge_tile: torch.Tensor, fcnt: torch.Tensor,
                  valid_row: torch.Tensor, sketch: torch.Tensor,
                  sizes: torch.Tensor, *, alpha: float, fringe_w: float,
                  inv_target: float, cap: int,
                  sketch_bits: int) -> torch.Tensor:
    """The streaming engine's sequential commit of one micro-batch.

    edge_tile (mb, Le) int32 (-1 pad), fcnt (mb, k) float32, valid_row
    (mb,) bool; sketch (k, 2**sketch_bits) and sizes (k,) int32 are
    updated in place. Returns parts (mb,) int32 as
    ``ref.stream_commit_ref`` defines them, with the same sketch and
    sizes, bit for bit on either device.
    """
    if not on_cuda(edge_tile, "stream_commit"):
        return stream_commit_ref(edge_tile, fcnt, valid_row, sketch, sizes,
                                 alpha=alpha, fringe_w=fringe_w,
                                 inv_target=inv_target, cap=cap,
                                 sketch_bits=sketch_bits)
    out = load_extension().stream_commit(
        edge_tile, fcnt, valid_row, sketch, sizes, float(alpha),
        float(fringe_w), float(inv_target), int(cap), int(sketch_bits))
    stream_commit.launches += 1
    return out


hype_score_select.launches = 0
hype_scores.launches = 0
stream_commit.launches = 0
