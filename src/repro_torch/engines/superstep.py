"""Device-resident superstep engine (``hype_superstep``).

The port of ``src/repro/engines/superstep.py``: all ``k`` partitions
grow concurrently. Every superstep stacks the fresh candidates of all
growing phases into one call of the fused score + select kernel against
a graph image (CSR + assignment + score cache) uploaded once. Scores
survive across refills and phases: admissions *decrement* their
neighbours' cached scores instead of wiping the cache. Supersteps run
double-buffered on the shared pipeline driver; ``pipeline_depth=1`` is
the lock-step schedule.

Only the default device program is ported; the memory-rung variants,
snapshots and fault plans raise ``NotImplementedError`` (ROADMAP.md,
queue 1). With ``refine_passes`` > 0 the k-way refinement post-pass runs
after the pipeline, its screen on the same device.
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
from .batched import BatchedParams, check_ported, hype_batched_partition
from .batched import UNPORTED_KNOBS as BATCHED_UNPORTED
from .pipeline import PipelineState, _CallArgs
from .runtime import BatchedStats, maybe_refine
from .runtime import run_pipeline as _run_pipeline


@dataclasses.dataclass
class SuperstepParams(BatchedParams):
    """Knobs of the superstep engine: the JAX ``SuperstepParams`` fields
    (its ``BatchedParams`` parent's included) with the same defaults.

    ``t`` (admissions per phase per superstep), ``pool_cap``, ``rows``,
    ``pipeline_depth``, ``refine_passes`` and ``seed`` steer this
    engine; ``b``, ``s``, ``refill_lo``, ``cap_pins`` and ``kernel_min``
    steer only the ``hype_batched`` fallback, as in the JAX engine.
    ``snapshot_every``, ``resume``, ``fault_plan`` and ``mem_budget``
    raise ``NotImplementedError`` when set away from their defaults.
    """
    # fresh candidate rows per phase per superstep; None = max(8, t)
    rows: Optional[int] = None
    # in-flight supersteps of the double-buffered pipeline; 1 = lock-step
    pipeline_depth: int = 2
    mem_budget: Optional[object] = None


# knob -> the ROADMAP.md item (queue 1) that brings its feature
UNPORTED_KNOBS = {**BATCHED_UNPORTED, "mem_budget": "memory rungs"}


def superstep_device(indptr, indices, assign, cache, acc, poison,
                     delta_ids, delta_vals, dirty_ids, dirty_counts, fresh,
                     bias, pool, fringe, targets, reset, *, tile_l: int,
                     select_k: int, debug: bool = False):
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
    """
    n = assign.shape[0] - 1
    G, R = fresh.shape
    assign0, cache0, acc0 = assign, cache, acc
    # 1.-2. host injections and the pre-aggregated dirty decrements
    assign, cache, acc = _apply_host_injections(
        assign, cache, acc, delta_ids, delta_vals, dirty_ids, dirty_counts)
    # 3. gather fresh candidate tiles from the device CSR
    flat = fresh.reshape(-1)
    tile = _gather_fresh_tiles(indptr, indices, assign, flat, tile_l)
    # 4. held pool scores, stale slots masked (the redraw rule)
    prev, n_stale = _stale_masked_prev(pool, assign, cache)
    # 5. fused score + per-phase top-select
    scores, sel_idx, sel_val, _ = hype_score_select(
        tile.view(G, R, tile_l), fringe, bias, prev, select_k=select_k)
    # 6. fresh scores enter the cache (pad rows go to the scratch slot);
    #    assign/cache/acc are this step's own tensors from here on, so
    #    they are updated in place
    real = flat >= 0
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
    cache = torch.where(poisoned, cache0, cache)
    acc = torch.where(poisoned, acc0, acc)
    winners = torch.where(poisoned, -1, winners)
    n_stale = torch.where(poisoned, 0, n_stale)
    poison = poisoned.to(torch.int32).reshape(1)
    return assign, cache, acc, poison, winners, n_stale


def _check_unique(ids: torch.Tensor, what: str) -> None:
    """Debug check: a scatter target set must hold no repeats (CUDA's
    ``index_put_`` does not order duplicate writes)."""
    if torch.unique(ids).numel() != ids.numel():
        raise AssertionError(f"duplicate scatter targets among {what}")


class SuperstepState(PipelineState):
    """Pipeline state wired to this module's device program."""

    def __init__(self, hg: Hypergraph, k: int, p, device,
                 debug: bool = False):
        super().__init__(hg, k, p, device)
        self.debug = debug
        self._reset0 = (torch.zeros(1, dtype=torch.int32, device=device)
                        if self.dev is not None else None)

    def _call_program(self, args: _CallArgs) -> torch.Tensor:
        """Run the superstep program; rotate the image; return the block
        ``winners | n_stale | poison`` that harvest reads."""
        (self.dev_assign, self.dev_cache, self.dev_acc, self.dev_poison,
         winners, n_stale) = superstep_device(
            self.dev[0], self.dev[1], self.dev_assign, self.dev_cache,
            self.dev_acc, self.dev_poison, args.delta, args.vals,
            args.dirty, args.dcnt, args.fresh, args.bias, args.pool_arr,
            args.fringe, args.targets, self._reset0, tile_l=self.tile_l,
            select_k=args.select_k, debug=self.debug)
        return torch.cat([winners.reshape(-1), n_stale.reshape(1),
                          self.dev_poison])


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
    check_ported(params, UNPORTED_KNOBS)
    if k == 1:
        out = np.zeros(hg.n, dtype=np.int32)
        return (out, BatchedStats()) if return_stats else out
    assignment, st = _run_pipeline(
        hg, k, params,
        lambda p: SuperstepState(hg, k, p, device, debug=debug))
    if assignment is None:
        return hype_batched_partition(hg, k, params, return_stats,
                                      device=device)
    assert (assignment >= 0).all()
    assignment = maybe_refine(hg, k, params, assignment, st.stats, device)
    if return_stats:
        return assignment, st.stats
    return assignment
