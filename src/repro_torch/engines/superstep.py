"""Device-resident superstep engine (``hype_superstep``).

The port of ``src/repro/engines/superstep.py``: all ``k`` partitions
grow concurrently. Every superstep stacks the fresh candidates of all
growing phases into one call of the fused score + select kernel against
a graph image (CSR + assignment + score cache) uploaded once. Scores
survive across refills and phases: admissions *decrement* their
neighbours' cached scores instead of wiping the cache. Supersteps run
double-buffered on the shared pipeline driver; ``pipeline_depth=1`` is
the lock-step schedule.

The memory plan (``core/membudget.py``) picks the device program: the
default one, or a memory rung's (phase-chunked scoring, the score cache
spilled to the host, the CSR paged in chunks), each bit-exact to the
default and each launching ``hype_score_select`` on the state's device.
A device OOM runs the engine again at the next rung
(``runtime.run_pipeline_budgeted``). Snapshots, resume and fault plans
run on the shared driver (``runtime.run_pipeline``).
With ``refine_passes`` > 0 the k-way refinement post-pass runs after the
pipeline, its screen on the same device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.hypergraph import Hypergraph
from ..core.scoring import (_apply_host_injections, _gather_fresh_tiles,
                            _poison_guard, _stale_masked_prev)
from ..kernels.hype_score.ops import SELECT_PAD, hype_score_select
from .batched import BatchedParams, hype_batched_partition
from .pipeline import PipelineState, _CallArgs
from .runtime import BatchedStats, maybe_refine
from .runtime import run_pipeline as _run_pipeline
from .runtime import run_pipeline_budgeted as _run_pipeline_budgeted


@dataclasses.dataclass
class SuperstepParams(BatchedParams):
    """Knobs of the superstep engine: the JAX ``SuperstepParams`` fields
    (its ``BatchedParams`` parent's included) with the same defaults.

    ``t`` (admissions per phase per superstep), ``pool_cap``, ``rows``,
    ``pipeline_depth``, ``refine_passes`` and ``seed`` steer this
    engine; ``b``, ``s``, ``refill_lo``, ``cap_pins`` and ``kernel_min``
    steer only the ``hype_batched`` fallback, as in the JAX engine.
    ``mem_budget`` is the device byte budget the memory plan is sized
    against (bytes, ``"512MB"``/``"2GiB"``, or None for the
    ``REPRO_DEVICE_MEM_BUDGET`` environment variable, then the card's
    free memory).
    """
    # fresh candidate rows per phase per superstep; None = max(8, t)
    rows: Optional[int] = None
    # in-flight supersteps of the double-buffered pipeline; 1 = lock-step
    pipeline_depth: int = 2
    mem_budget: Optional[object] = None


def superstep_device(indptr, indices, assign, cache, acc, poison,
                     delta_ids, delta_vals, dirty_ids, dirty_counts, fresh,
                     bias, pool, fringe, targets, reset, *, tile_l: int,
                     select_k: int, g_chunk: int = 1, debug: bool = False):
    """One device superstep: the torch counterpart of the JAX program.

    Steps as in ``src/repro/engines/superstep.py::_pipeline_program``:
    apply the host's injections and cache decrements, gather the fresh
    tiles from the device CSR, mask stale pool slots, run the fused
    score + select kernel, write the fresh scores into the cache, admit
    each phase's winners under its remaining target, and revert
    everything if a score came out non-finite. ``assign``/``cache`` are
    (n + 1,) and ``acc`` is (k + 1,) with a scratch slot at the end
    (``core/scoring.py``); the inputs are left unchanged and new tensors
    are returned: ``(assign, cache, acc, poison, winners (G, select_k),
    n_stale)``. Nothing here synchronizes with the device unless
    ``debug`` asks for the scatter-uniqueness checks.

    ``g_chunk`` > 1 is the phase-chunked scoring of memory rungs 1-3
    (JAX's ``chunked_superstep_device``), with the same contract and the
    same bits: the G phases are padded to a ``g_chunk`` multiple (pad
    phases hold -1 candidates and fringe, +inf bias and +inf held
    scores, so they select nothing) and scored in ``g_chunk`` slices,
    one tile gather and one kernel launch each, so only 1/``g_chunk`` of
    the phases' tiles exists at a time. Phases are independent until
    admission, so the slices compute the scores of the full call.
    """
    image0 = (assign, cache, acc)
    assign, cache, acc = _apply_host_injections(
        assign, cache, acc, delta_ids, delta_vals, dirty_ids, dirty_counts)
    prev, n_stale = _stale_masked_prev(pool, assign, cache)

    def tiles(flat):
        return _gather_fresh_tiles(indptr, indices, assign, flat, tile_l)

    out = _score_and_admit(image0, (assign, cache, acc), poison, fresh,
                           bias, pool, prev, n_stale, fringe, targets,
                           reset, tiles, g_chunk, select_k, debug)
    return out[:6]


def spill_superstep_device(indptr, indices, assign, acc, poison, delta_ids,
                           delta_vals, fresh, bias, pool, prev_host, fringe,
                           targets, reset, *, tile_l: int, select_k: int,
                           debug: bool = False):
    """``superstep_device`` with the score cache on the host (rung 4).

    The caller applied the dirty decrements to its float32 mirror and
    ships the held pool's scores in as ``prev_host``; stale slots are
    still masked here, against the post-injection assignment. Returns
    ``(assign, acc, poison, winners, n_stale, scores)``: the fresh
    (G, R) scores go back to the host, which writes them into its mirror
    after the poison check. Every skipped device add is the same float32
    add on the host, so the run is bit-identical to the resident cache's.
    """
    image0 = (assign, None, acc)
    n = assign.shape[0] - 1
    inj = delta_ids >= 0
    assign = assign.index_put((torch.where(inj, delta_ids, n).long(),),
                              delta_vals)
    acc = acc.index_add(0, torch.where(inj, delta_vals,
                                       acc.shape[0] - 1).long(),
                        torch.ones_like(delta_vals))
    psafe = torch.where(pool >= 0, pool, 0).long()
    pool_ok = (pool >= 0) & (assign[psafe] < 0)
    prev = torch.where(pool_ok, prev_host, float("inf"))
    n_stale = ((pool >= 0) & ~pool_ok).sum(dtype=torch.int32)

    def tiles(flat):
        return _gather_fresh_tiles(indptr, indices, assign, flat, tile_l)

    assign, _, acc, poison, winners, n_stale, scores = _score_and_admit(
        image0, (assign, None, acc), poison, fresh, bias, pool, prev,
        n_stale, fringe, targets, reset, tiles, 1, select_k, debug)
    return assign, acc, poison, winners, n_stale, scores


def paged_superstep_device(assign, cache, acc, poison, delta_ids,
                           delta_vals, dirty_ids, dirty_counts, tile_raw,
                           fresh, bias, pool, fringe, targets, reset, *,
                           select_k: int, debug: bool = False):
    """``superstep_device`` without a resident CSR image (rung 5).

    ``tile_raw`` is the (G*R, tile_l) unmasked neighbour tile that
    ``membudget.PagedAdjacency.gather`` assembled on the device; masking
    its assigned neighbours here, against the post-injection assignment,
    reproduces the resident gather's tile, so the run is bit-identical.
    The program's only other CSR use, the winners' decrements, lives on
    the host already. Returns what ``superstep_device`` returns.
    """
    image0 = (assign, cache, acc)
    assign, cache, acc = _apply_host_injections(
        assign, cache, acc, delta_ids, delta_vals, dirty_ids, dirty_counts)
    prev, n_stale = _stale_masked_prev(pool, assign, cache)
    valid = tile_raw >= 0
    unassigned = assign[torch.where(valid, tile_raw, 0).long()] < 0
    tile = torch.where(valid & unassigned, tile_raw, -1)
    out = _score_and_admit(image0, (assign, cache, acc), poison, fresh,
                           bias, pool, prev, n_stale, fringe, targets,
                           reset, lambda _flat: tile, 1, select_k, debug)
    return out[:6]


def _pad_phases(a: torch.Tensor, pad: int, fill) -> torch.Tensor:
    """``a`` with ``pad`` phases of ``fill`` appended (dim 0)."""
    if pad == 0:
        return a
    return torch.cat([a, a.new_full((pad,) + tuple(a.shape[1:]), fill)])


def _score_and_admit(image0, image, poison, fresh, bias, pool, prev,
                     n_stale, fringe, targets, reset, tiles, g_chunk: int,
                     select_k: int, debug: bool):
    """Steps 3 and 5-9 of every superstep program, after its injections.

    ``image0`` is the ``(assign, cache, acc)`` the program was given,
    ``image`` the same after the injections (its own tensors, updated in
    place here; ``cache`` None on the spill rung). ``tiles(flat)`` gives
    the masked int32 tile of flat fresh ids. The phases are scored in
    ``g_chunk`` slices of ``ceil(G / g_chunk)`` phases, the last one
    padded with pad phases, one ``hype_score_select`` launch each.
    Returns ``(assign, cache, acc, poison, winners, n_stale, scores)``.
    """
    assign0, cache0, acc0 = image0
    assign, cache, acc = image
    n = assign.shape[0] - 1
    G, R = fresh.shape
    flat = fresh.reshape(-1)
    if g_chunk == 1:
        scores, sel_idx, sel_val, _ = hype_score_select(
            tiles(flat).reshape(G, R, -1), fringe, bias, prev,
            select_k=select_k)
    else:
        # 3.+5. phase-chunked gather + score + select
        gc_ = -(-G // g_chunk)
        pad = g_chunk * gc_ - G
        fresh_p = _pad_phases(fresh, pad, -1)
        bias_p = _pad_phases(bias, pad, float("inf"))
        prev_p = _pad_phases(prev, pad, float("inf"))
        fringe_p = _pad_phases(fringe, pad, -1)
        outs = []
        for c in range(g_chunk):
            ph = slice(c * gc_, (c + 1) * gc_)
            outs.append(hype_score_select(
                tiles(fresh_p[ph].reshape(-1)).reshape(gc_, R, -1),
                fringe_p[ph], bias_p[ph], prev_p[ph], select_k=select_k))
        scores, sel_idx, sel_val = (torch.cat([o[i] for o in outs])[:G]
                                    for i in range(3))
    # 6. fresh scores enter the cache (pad rows go to the scratch slot)
    real = flat >= 0
    if cache is not None:
        cache.index_put_((torch.where(real, flat, n).long(),),
                         scores.reshape(-1))
    # 7. map selected slots to vertex ids; admissible = a real score on a
    #    still-unassigned id, capped by the phase's remaining target as
    #    the device counts it. A NaN phase may give index R + P: clamp it
    #    (the poison guard drops that superstep anyway).
    slots = torch.cat([fresh, pool], dim=1)
    sel = sel_idx.long().clamp_(max=slots.shape[1] - 1)
    cand = torch.gather(slots, 1, sel)
    ok = (sel_val < SELECT_PAD) & (cand >= 0)
    ok &= assign[torch.where(cand >= 0, cand, 0).long()] < 0
    cap = torch.clamp(targets - acc[:G], min=0)
    rank = torch.cumsum(ok.to(torch.int32), dim=1)
    adm = ok & (rank <= cap[:, None])
    winners = torch.where(adm, cand, -1)
    # 8. apply the winners on the device (the host mirrors them later;
    #    their cache decrements ride the next dispatch's dirty pairs)
    phase_row = torch.arange(G, dtype=torch.int32,
                             device=adm.device)[:, None].expand_as(adm)
    assign.index_put_((torch.where(adm, cand, n).long().reshape(-1),),
                      phase_row.reshape(-1))
    acc[:G] += adm.sum(dim=1, dtype=torch.int32)
    if debug:
        _check_unique(flat[real], "fresh candidates")
        _check_unique(cand[adm], "admitted winners")
    # 9. NaN/inf quarantine: a poisoned superstep reverts every mutation
    #    and admits nothing, decided on the device without a host sync
    poisoned = _poison_guard(flat, scores.reshape(-1), poison, reset)
    assign = torch.where(poisoned, assign0, assign)
    if cache is not None:
        cache = torch.where(poisoned, cache0, cache)
    acc = torch.where(poisoned, acc0, acc)
    winners = torch.where(poisoned, -1, winners)
    n_stale = torch.where(poisoned, 0, n_stale)
    poison = poisoned.to(torch.int32).reshape(1)
    return assign, cache, acc, poison, winners, n_stale, scores


def _check_unique(ids: torch.Tensor, what: str) -> None:
    """Debug check: a scatter target set must hold no repeats (CUDA's
    ``index_put_`` does not order duplicate writes)."""
    if torch.unique(ids).numel() != ids.numel():
        raise AssertionError(f"duplicate scatter targets among {what}")


class SuperstepState(PipelineState):
    """Pipeline state wired to this module's device programs."""

    def __init__(self, hg: Hypergraph, k: int, p, device,
                 mem_rung: int = 0, debug: bool = False):
        super().__init__(hg, k, p, device, mem_rung=mem_rung)
        self.debug = debug

    def _call_program(self, args: _CallArgs,
                      reset: torch.Tensor) -> torch.Tensor:
        """Run the superstep program of the memory plan's rung; rotate the
        image; return the block ``winners | n_stale | poison`` that
        harvest reads (then the fresh scores' float32 bits on the spill
        rung, which the host adopts after the poison check)."""
        common = dict(select_k=args.select_k, debug=self.debug)
        if self.paged_adj is not None:
            tile_raw = self.paged_adj.gather(args.host_fresh.reshape(-1),
                                             self.tile_l)
            (self.dev_assign, self.dev_cache, self.dev_acc, self.dev_poison,
             winners, n_stale) = paged_superstep_device(
                self.dev_assign, self.dev_cache, self.dev_acc,
                self.dev_poison, args.delta, args.vals, args.dirty,
                args.dcnt, tile_raw, args.fresh, args.bias, args.pool_arr,
                args.fringe, args.targets, reset, **common)
        elif self.host_cache is not None:
            (self.dev_assign, self.dev_acc, self.dev_poison, winners,
             n_stale, scores) = spill_superstep_device(
                self.dev[0], self.dev[1], self.dev_assign, self.dev_acc,
                self.dev_poison, args.delta, args.vals, args.fresh,
                args.bias, args.pool_arr, args.prev, args.fringe,
                args.targets, reset, tile_l=self.tile_l, **common)
            return torch.cat([winners.reshape(-1), n_stale.reshape(1),
                              self.dev_poison,
                              scores.reshape(-1).view(torch.int32)])
        else:
            (self.dev_assign, self.dev_cache, self.dev_acc, self.dev_poison,
             winners, n_stale) = superstep_device(
                self.dev[0], self.dev[1], self.dev_assign, self.dev_cache,
                self.dev_acc, self.dev_poison, args.delta, args.vals,
                args.dirty, args.dcnt, args.fresh, args.bias, args.pool_arr,
                args.fringe, args.targets, reset, tile_l=self.tile_l,
                g_chunk=self.g_chunk, **common)
        return torch.cat([winners.reshape(-1), n_stale.reshape(1),
                          self.dev_poison])


def _state_factory(hg: Hypergraph, k: int, device, debug: bool = False):
    return lambda p, rung: SuperstepState(hg, k, p, device, mem_rung=rung,
                                          debug=debug)


def run_pipeline(hg: Hypergraph, k: int, p: SuperstepParams, *, device,
                 mem_rung: int = 0, mem_warm: Optional[np.ndarray] = None,
                 mem_retries: int = 0, debug: bool = False):
    """One superstep-engine pipeline run at memory rung ``mem_rung`` (or
    the first one from there that fits), with no retry loop: for callers
    that walk the rungs themselves (``hype_device``'s OOM fallback, the
    tests). ``runtime.run_pipeline`` with this engine's state."""
    return _run_pipeline(hg, k, p, _state_factory(hg, k, device, debug),
                         "hype_superstep", mem_rung=mem_rung,
                         mem_warm=mem_warm, mem_retries=mem_retries)


def run_pipeline_budgeted(hg: Hypergraph, k: int, p: SuperstepParams, *,
                          device, debug: bool = False):
    """``run_pipeline`` under the memory-rung retry loop."""
    return _run_pipeline_budgeted(hg, k, p,
                                  _state_factory(hg, k, device, debug),
                                  "hype_superstep")


def hype_superstep_partition(hg: Hypergraph, k: int,
                             params: Optional[SuperstepParams] = None,
                             return_stats: bool = False, *, device,
                             debug: bool = False):
    """Partition ``hg`` with the device-resident superstep engine.

    Returns a complete int32 assignment with ``max - min <= 1`` vertex
    balance (and the ``BatchedStats`` with ``return_stats``). ``device``
    is where the image lives and the kernel runs (``"cuda"`` or
    ``"cpu"``); ``debug`` adds the scatter-uniqueness checks, which
    synchronize. Falls back to ``hype_batched_partition`` on the same
    device when the adjacency guard trips (pathological hub expansion),
    as the JAX engine does.
    """
    if params is None:
        params = SuperstepParams()
    if params.rows is None:
        params = dataclasses.replace(params, rows=max(8, params.t))
    if k < 1:
        raise ValueError("k must be >= 1")
    if params.t < 1 or params.rows < 1 or params.pool_cap < 1:
        raise ValueError("rows, pool_cap, t must all be >= 1")
    if params.pipeline_depth < 1:
        raise ValueError("pipeline_depth must be >= 1")
    if params.snapshot_every > 0 and not params.snapshot_dir:
        raise ValueError("snapshot_every requires snapshot_dir")
    if k == 1:
        out = np.zeros(hg.n, dtype=np.int32)
        return (out, BatchedStats()) if return_stats else out
    assignment, st = run_pipeline_budgeted(hg, k, params, device=device,
                                           debug=debug)
    if assignment is None:
        return hype_batched_partition(hg, k, params, return_stats,
                                      device=device)
    assert (assignment >= 0).all()
    assignment = maybe_refine(hg, k, params, assignment, st.stats, device)
    if return_stats:
        return assignment, st.stats
    return assignment
