"""Phase-group-sharded superstep engine (``hype_sharded``).

The port of ``src/repro/engines/sharded.py``. JAX drives D devices from
one process with ``shard_map``; the port runs SPMD over a
``torch.distributed`` process group, one rank per device. Every rank
holds the whole graph image (CSR, assignment, score cache) and runs the
same host pipeline; its inputs after each harvest are replicated, so the
host state stays identical across the ranks without being shipped. Each
rank gathers, scores and selects only its own contiguous phase group
``[rank * kL, (rank + 1) * kL)``, and ONE ``all_gather`` per superstep
exchanges the (kL, R + t) int32 payload of fresh scores and proposed
admissions, after which every rank applies the same cache writes, the
lowest-phase-wins conflict rule and the exact decrements. Every rank
returns the same assignment.

The group is NCCL on cards and gloo on the CPU; gloo gathers host
tensors, so there a card's payload crosses through a pinned host copy (a
few KB a superstep), which is also what lets several ranks share one
card. ``devices=None`` means the group's world size, or 1 without a
group; without a group at one rank no collective runs. Ranks past the
mesh (``devices`` or ``k`` below the world size) take rank 0's result by
a broadcast.

Every rank must make the same decisions, or the ranks wait on each other
in a collective: the memory rung is agreed across the ranks before the
upload, an injected fault fires on every rank at the same ordinal before
the ``all_gather``, and the poison guard reads the gathered scores. A
real exception on one rank cannot be matched on the others: they raise
when the group's timeout ends their wait. Snapshots are written by rank
0, and every rank waits for the write.

``spawn_partition`` gives one caller a D-rank mesh, as JAX's single
process has D devices: it starts the ranks (``RankPool``) over a
``file://`` store and returns rank 0's result after checking that every
rank returned the same.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..core import membudget
from ..core.hypergraph import Hypergraph
from ..core.scoring import (_apply_host_injections, _gather_fresh_tiles,
                            _poison_guard, _stale_masked_prev,
                            gather_csr_rows)
from ..kernels.hype_score.ops import (SELECT_PAD, hype_score_select,
                                      hype_score_select_shard)
from .pipeline import PipelineState, _CallArgs
from .runtime import BatchedStats, maybe_refine
from .runtime import run_pipeline_budgeted as _run_pipeline_budgeted
from .superstep import SuperstepParams, hype_superstep_partition

# the timeout of every group this module creates (the sub-group of a
# mesh narrower than its group, and ``RankPool``'s by default): a dead
# peer then raises on the others instead of hanging them
GROUP_TIMEOUT_S = 600.0


@dataclasses.dataclass
class ShardedParams(SuperstepParams):
    """Knobs of the sharded engine: every superstep knob, plus
    ``devices``, the number of ranks the k phases are sharded over
    (None: the group's world size, or 1 without a group; capped at the
    world size and at ``k``)."""
    devices: Optional[int] = None


# ---------------------------------------------------------------- the mesh

class Mesh:
    """The ranks one sharded run spans: ``size`` ranks, this one at
    ``rank``, the collective on ``group`` (None: one rank and no
    collective). ``device`` is where this rank's image lives."""

    def __init__(self, size: int, rank: int, group, device):
        self.size = int(size)
        self.rank = int(rank)
        self.group = group
        self.device = torch.device(device)
        # gloo reduces and gathers host tensors
        self.host_staged = (group is not None
                            and dist.get_backend(group) == "gloo")

    @classmethod
    def of(cls, group=None, device="cpu") -> "Mesh":
        """The mesh of all of ``group``'s ranks (default: the default
        group, or one rank when none is initialised)."""
        group = _resolve_group(group)
        if group is None:
            return cls(1, 0, None, device)
        return cls(dist.get_world_size(group), dist.get_rank(group), group,
                   device)

    def all_gather(self, payload: torch.Tensor) -> torch.Tensor:
        """Stack every rank's (rows, ...) ``payload`` along dim 0, in rank
        order: the superstep's one collective."""
        if self.group is None:
            return payload
        shape = (self.size * payload.shape[0],) + tuple(payload.shape[1:])
        staged = self.host_staged and payload.device.type != "cpu"
        if staged:
            src = torch.empty(payload.shape, dtype=payload.dtype,
                              pin_memory=True)
            src.copy_(payload)
            out = torch.empty(shape, dtype=payload.dtype, pin_memory=True)
        else:
            src = payload.contiguous()
            out = payload.new_empty(shape)
        self._collective("the superstep's all_gather", dist.all_gather,
                         list(out.chunk(self.size)), src, group=self.group)
        return out.to(payload.device, non_blocking=True) if staged else out

    def max(self, value: int) -> int:
        """The largest ``value`` over the ranks (a barrier as well)."""
        if self.group is None:
            return int(value)
        dev = torch.device("cpu") if self.host_staged else self.device
        t = torch.tensor([int(value)], dtype=torch.int64, device=dev)
        self._collective("the all_reduce (MAX)", dist.all_reduce, t,
                         op=dist.ReduceOp.MAX, group=self.group)
        return int(t.item())

    def _collective(self, what: str, fn, *args, **kwargs) -> None:
        """Run one collective; a failure (a peer that raised or died, and
        so left this rank waiting until the group's timeout) raises
        naming the collective."""
        try:
            fn(*args, **kwargs)
        except Exception as exc:
            raise RuntimeError(
                f"{what} over {self.size} ranks failed on rank "
                f"{self.rank}: {exc}") from exc


def _resolve_group(group):
    """``group``, else the default group when one is initialised."""
    if group is not None:
        return group
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


# process groups live for the process (torch.distributed keeps them
# too), and every rank must make a sub-group once, in the same order
_SUBGROUPS: dict = {}


def _subgroup(group, num: int):
    """The cached sub-group of ``group``'s ranks ``[0, num)``. Every rank
    of the default group must call it (``dist.new_group``)."""
    key = (group, num)
    if key not in _SUBGROUPS:
        ranks = [dist.get_global_rank(group, r) for r in range(num)]
        _SUBGROUPS[key] = dist.new_group(
            ranks, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    return _SUBGROUPS[key]


# ------------------------------------------------------- sharded superstep

def sharded_superstep_device(indptr, indices, assign, cache, acc, poison,
                             delta_ids, delta_vals, dirty_ids, dirty_counts,
                             fresh, bias, pool, fringe, targets, reset, *,
                             mesh: Mesh, group_l: int, tile_l: int,
                             select_k: int):
    """One sharded superstep on this rank; steps 1-12 of JAX's program.

    ``fresh``/``bias``/``pool``/``fringe``/``targets`` stack all ``G =
    mesh.size * group_l`` phases; this rank gathers, scores and selects
    the group ``[mesh.rank * group_l, ...)``, and one ``all_gather``
    exchanges (fresh scores | proposed admissions), after which every
    rank applies the same cache writes, lowest-phase-wins conflict
    resolution, admissions and exact decrements (clipped at ``tile_l``;
    the host queues the tails of wider winners). ``assign``/``cache``
    are (n + 1,) and ``acc`` (G + 1,) with a scratch slot at the end
    (``core/scoring.py``); the inputs stay unchanged and new tensors are
    returned: ``(assign, cache, acc, poison, winners (G, select_k),
    n_conflicts, n_stale)``. A non-finite gathered score reverts the
    superstep on every rank alike.
    """
    image0 = (assign, cache, acc)
    # 1. host injections + dirty decrements: replicated inputs
    assign, cache, acc = _apply_host_injections(
        assign, cache, acc, delta_ids, delta_vals, dirty_ids, dirty_counts)
    n = assign.shape[0] - 1
    G, R = fresh.shape
    t = select_k
    kl = group_l
    # 2. this rank's phase group; the cap is each phase's remaining
    #    target by the device's totals
    off = mesh.rank * kl
    fresh_l = fresh[off:off + kl]
    pool_l = pool[off:off + kl]
    cap_l = torch.clamp(targets - acc[:G], min=0)[off:off + kl]
    # 3. only the group's fresh tiles, from the replicated CSR
    tile = _gather_fresh_tiles(indptr, indices, assign, fresh_l.reshape(-1),
                               tile_l)
    # 4. held pool scores on the global pool, so the count is replicated
    prev, n_stale = _stale_masked_prev(pool, assign, cache)
    # 5. fused score + select on the group
    scores_l, sel_idx, sel_val, _ = hype_score_select_shard(
        tile.reshape(kl, R, -1), fringe, bias, prev, select_k=t,
        shard_offset=off)
    # 6. selected slots -> ids, capped by the remaining target (a NaN
    #    phase may give index R + P: clamped, the guard drops it anyway)
    slots = torch.cat([fresh_l, pool_l], dim=1)
    sel = sel_idx.long().clamp_(max=slots.shape[1] - 1)
    cand = torch.gather(slots, 1, sel)
    ok = (sel_val < SELECT_PAD) & (cand >= 0)
    ok &= assign[torch.where(cand >= 0, cand, 0).long()] < 0
    rank = torch.cumsum(ok.to(torch.int32), dim=1)
    adm_ids = torch.where(ok & (rank <= cap_l[:, None]), cand, -1)
    # 7. the superstep's one collective: [fresh scores | admissions]; the
    #    scores travel as their bits, so a NaN stays a NaN
    payload = torch.cat([scores_l.view(torch.int32), adm_ids], dim=1)
    gathered = mesh.all_gather(payload)                      # (G, R + t)
    g_scores = gathered[:, :R].contiguous().view(torch.float32)
    g_adm = gathered[:, R:]
    # 8. the fresh scores enter every rank's cache (pads to the scratch
    #    slot; an id fresh in two groups has the same score in both)
    flat_g = fresh.reshape(-1)
    cache.index_put_((torch.where(flat_g >= 0, flat_g, n).long(),),
                     g_scores.reshape(-1))
    # 9. lowest phase wins: sort (id, flat index) with unique int64 keys
    #    (flat index = phase * t + slot, JAX's lexsort order) and keep
    #    each id's first entry
    ids_f = g_adm.reshape(-1)
    gt = G * t
    iota = torch.arange(gt, dtype=torch.int64, device=ids_f.device)
    phase_f = (iota // t).to(torch.int32)
    ids_key = torch.where(ids_f >= 0, ids_f, n).long()
    order = torch.sort(ids_key * gt + iota).indices
    sorted_ids = ids_f[order]
    first = torch.ones_like(sorted_ids, dtype=torch.bool)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    winner = torch.zeros(gt, dtype=torch.bool, device=ids_f.device)
    winner[order] = first & (sorted_ids >= 0)
    n_conflicts = ((ids_f >= 0) & ~winner).sum(dtype=torch.int32)
    # 10. the winners enter every rank's assignment and totals
    assign.index_put_((torch.where(winner, ids_f, n).long(),), phase_f)
    acc[:G] += winner.view(G, t).sum(dim=1, dtype=torch.int32)
    # 11. exact decrements of the winners' first tile_l neighbours. The
    #     masked slots add -0.0 to ids spread over the cache (x + -0.0 is
    #     x), not all to the scratch slot: a million adds to one address
    #     serialise. Each add of -1.0 meets an integer-valued score
    #     below 2**24 (exact) or a hub-penalised one past 2**25 (left
    #     unchanged), so their order does not change the bits.
    wsafe = torch.where(winner, ids_f, 0).long()
    wstart = indptr[wsafe]
    wdeg = torch.clamp(indptr[wsafe + 1] - wstart, max=tile_l)
    wcol = torch.arange(tile_l, dtype=indptr.dtype, device=indptr.device)
    wvalid = ((wcol < wdeg[:, None]) & winner[:, None]).reshape(-1)
    wnbr = indices[torch.where(
        wvalid, (wstart[:, None] + wcol).reshape(-1), 0).long()]
    spread = torch.arange(wvalid.numel(), device=wvalid.device) % n
    cache.index_add_(0, torch.where(wvalid, wnbr.long(), spread),
                     torch.where(wvalid, -1.0, -0.0))
    winners = torch.where(winner, ids_f, -1).view(G, t)
    # 12. the quarantine reads the gathered scores, so every rank takes
    #     the same branch
    poisoned = _poison_guard(flat_g, g_scores.reshape(-1), poison, reset)
    assign = torch.where(poisoned, image0[0], assign)
    cache = torch.where(poisoned, image0[1], cache)
    acc = torch.where(poisoned, image0[2], acc)
    winners = torch.where(poisoned, -1, winners)
    n_conflicts = torch.where(poisoned, 0, n_conflicts)
    n_stale = torch.where(poisoned, 0, n_stale)
    poison = poisoned.to(torch.int32).reshape(1)
    return assign, cache, acc, poison, winners, n_conflicts, n_stale


# ------------------------------------------------------------------ state

class ShardedState(PipelineState):
    """Superstep state with per-group pool masks, on one rank of a mesh.

    Groups draw candidates independently (``group_pool``, one mask per
    phase group), so two groups may pool and propose the same vertex;
    the program's lowest-phase-wins rule settles it, and the host mirrors
    the winners without queueing them as deltas.
    """

    # the dispatch site owns the superstep's all_gather, so a failed
    # collective is injected (and retried) there too
    _fault_kinds = ("dispatch", "collective", "oom")
    # the replicated image has programs for the width and depth knobs only
    _mem_features = membudget.SHARDED_FEATURES

    def __init__(self, hg: Hypergraph, k_padded: int, p, mesh: Mesh, device,
                 mem_rung: int = 0):
        self.mesh = mesh
        self.D = mesh.size
        self.kL = k_padded // mesh.size
        super().__init__(hg, k_padded, p, device, mem_rung=mem_rung)
        if self.dev is None:
            return
        self.group_pool = np.zeros((self.D, hg.n), dtype=bool)
        self.stats.device_image_bytes *= self.D   # one image per rank

    @property
    def snapshot_writer(self) -> bool:
        return self.mesh.rank == 0

    def snapshot_published(self) -> None:
        self.mesh.max(0)        # every rank waits for rank 0's write

    def _agree_rung(self, rung: int) -> int:
        return self.mesh.max(rung)

    def _pmask(self, g: int) -> np.ndarray:
        return self.group_pool[g // self.kL]

    def _restart_mask(self) -> np.ndarray:
        # an injection-safe vertex sits in no group's pool
        return self.group_pool.any(axis=0)

    def release_pools(self) -> None:
        super().release_pools()
        self.group_pool[:] = False

    def _release_members(self, vs: np.ndarray, ph: np.ndarray) -> None:
        self.group_pool[ph // self.kL, vs] = False

    def _queue_decrements(self, vs: np.ndarray, exclude=()) -> None:
        """The program already decremented each winner's first ``tile_l``
        neighbours; only the tails of wider winners ride the next
        dispatch's dirty pairs, with the in-flight rescore exclusion."""
        self.stats.cache_invalidations += int(
            np.minimum(self.deg[vs], self.tile_l).sum())
        wide = vs[self.deg[vs] > self.tile_l]
        if wide.size == 0:
            return
        indptr, indices = self.adj
        nbrs, owner = gather_csr_rows(indptr, indices, wide)
        lens = (indptr[wide + 1] - indptr[wide]).astype(np.int64)
        start = np.cumsum(lens) - lens
        off = np.arange(nbrs.size, dtype=np.int64) - start[owner]
        tail = self._filter_rescored(
            nbrs[off >= self.tile_l].astype(np.int64), exclude)
        if tail.size:
            self.pending_dirty.append(tail)

    def _call_program(self, args: _CallArgs,
                      reset: torch.Tensor) -> torch.Tensor:
        """One sharded superstep; its block is ``winners | n_stale |
        poison | n_conflicts``."""
        (self.dev_assign, self.dev_cache, self.dev_acc, self.dev_poison,
         winners, ncf, n_stale) = sharded_superstep_device(
            self.dev[0], self.dev[1], self.dev_assign, self.dev_cache,
            self.dev_acc, self.dev_poison, args.delta, args.vals,
            args.dirty, args.dcnt, args.fresh, args.bias, args.pool_arr,
            args.fringe, args.targets, reset, mesh=self.mesh,
            group_l=self.kL, tile_l=self.tile_l, select_k=args.select_k)
        return torch.cat([winners.reshape(-1), n_stale.reshape(1),
                          self.dev_poison, ncf.reshape(1)])

    def _count_dispatch(self, fresh: np.ndarray, select_k: int) -> None:
        kG, R = fresh.shape
        # one all_gather a superstep: every rank materialises the global
        # (kG, R + t) int32 payload
        self.stats.collectives += 1
        self.stats.collective_bytes += self.D * kG * (R + select_k) * 4

    def _count_harvest(self, handle, res: np.ndarray) -> None:
        kG, t = handle.shape
        self.stats.admission_conflicts += int(res[kG * t + 2])

    def capture_payload(self, acc: np.ndarray, cur_depth: int) -> dict:
        pay = super().capture_payload(acc, cur_depth)
        pay["group_pool"] = self.group_pool.copy()
        return pay

    def restore_exact(self, pay: dict):
        out = super().restore_exact(pay)
        self.group_pool = pay["group_pool"].copy()
        return out


# ------------------------------------------------------------ entry points

def _resolve_device(device) -> torch.device:
    """``None`` means the card (the current CUDA device); raise without."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port on the CPU")
        device = "cuda"
    return torch.device(device)


def _run_mesh(hg: Hypergraph, k: int, params: ShardedParams, mesh: Mesh,
              device: torch.device):
    kG = (-(-k // mesh.size)) * mesh.size   # phase groups padded to the mesh
    assignment, st = _run_pipeline_budgeted(
        hg, k, params,
        lambda p2, rung: ShardedState(hg, kG, p2, mesh, device,
                                      mem_rung=rung),
        "hype_sharded", devices=mesh.size)
    if assignment is None:
        return hype_superstep_partition(hg, k, params, True, device=device)
    assert (assignment >= 0).all()
    assignment = maybe_refine(hg, k, params, assignment, st.stats, device)
    return assignment, st.stats


def hype_sharded_partition(hg: Hypergraph, k: int,
                           params: Optional[ShardedParams] = None,
                           return_stats: bool = False, *, device=None,
                           group=None):
    """Partition ``hg`` with the phase-group-sharded superstep engine.

    ``hype_superstep_partition``'s contract (a complete int32 assignment,
    ``max - min <= 1``, all k phases grown concurrently), with the phase
    groups sharded over the ranks of ``group`` (default: the default
    group when one is initialised, else this process alone). Call it on
    every rank of the group; each returns the same assignment. ``device``
    is this rank's (None: the current CUDA device, raising without one;
    ``"cpu"`` for the plain kernels). At one rank the run equals
    ``hype_superstep_partition`` at the same depth. Falls back to
    ``hype_superstep_partition`` when the adjacency guard trips, as the
    JAX engine does.
    """
    if params is None:
        params = ShardedParams()
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
    if params.devices is not None and params.devices < 1:
        raise ValueError("devices must be >= 1")
    if k == 1:
        out = np.zeros(hg.n, dtype=np.int32)
        return (out, BatchedStats()) if return_stats else out
    dev = _resolve_device(device)
    group = _resolve_group(group)
    world = dist.get_world_size(group) if group is not None else 1
    rank = dist.get_rank(group) if group is not None else 0
    num = params.devices if params.devices is not None else world
    num = max(1, min(num, world, k))
    if num == world:
        out = _run_mesh(hg, k, params, Mesh(num, rank, group, dev), dev)
    else:
        # every rank takes part in making the sub-group; the ranks past
        # the mesh take rank 0's result, or its exception, by a
        # broadcast, so that none of them waits for a rank that raised
        sub = _subgroup(group, num) if num > 1 else None
        out = None
        if rank < num:
            try:
                out = _run_mesh(hg, k, params, Mesh(num, rank, sub, dev),
                                dev)
            except Exception as exc:
                out = exc
        box = [out]
        dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                                   group=group)
        out = box[0]
        if isinstance(out, Exception):
            raise out
    assignment, stats = out
    return (assignment, stats) if return_stats else assignment


# ---------------------------------------------------------- spawned ranks

def run_counters(stats: BatchedStats) -> dict:
    """The counters of a run that every rank shares: the stats without
    the wall-clock times and the allocator's observed peak."""
    out = {}
    for f in dataclasses.fields(stats):
        v = getattr(stats, f.name)
        if f.name == "peak_bytes_observed" or isinstance(v, float):
            continue
        out[f.name] = dataclasses.asdict(v) if f.name == "refine" and v \
            else v
    return out


def _portable(exc: BaseException, rank: int, world: int) -> BaseException:
    """``exc`` as it can cross back to the parent process."""
    try:
        exc.add_note(f"raised on rank {rank} of {world}")
        pickle.loads(pickle.dumps(exc))
        return exc
    except Exception:
        return RuntimeError(f"rank {rank} of {world} raised:\n"
                            f"{traceback.format_exc()}")


def _rank_main(rank: int, world: int, init: str, backend: str,
               timeout_s: float, tasks, results, parent: int) -> None:
    """A spawned rank: join the group, then run tasks until told to stop
    or until the parent is gone."""
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=init, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    results.put((rank, ("ready", None)))
    try:
        while True:
            try:
                item = tasks.get(timeout=1.0)
            except queue.Empty:
                if os.getppid() != parent:
                    return
                continue
            if item is None:
                return
            fn, args = item
            try:
                out = ("ok", fn(*args))
            except Exception as exc:   # sent back, raised by run()
                out = ("err", _portable(exc, rank, world))
            results.put((rank, out))
    finally:
        dist.destroy_process_group()


class RankPool:
    """``world`` ranks of one process group, spawned once, running tasks.

    Each rank is a process of the spawn context that joins a ``backend``
    group over a ``file://`` store in a temporary directory (no network),
    with ``timeout_s`` as the group's timeout, then runs every task that
    ``run`` hands it. ``run(fn, *args)`` calls ``fn(*args)`` on every rank
    (``fn`` importable, the arguments picklable) and returns the results
    in rank order; when a rank raised, it raises that rank's exception.
    The pool waits for its ranks to join, and ``run`` for a task, at most
    ``timeout_s`` (and up to 5 s more, for the group's own timeout to
    report); past that, or when a rank dies, it kills the
    ranks and raises. Ranks end with ``close`` or with their parent. A
    context manager.
    """

    def __init__(self, world: int, *, backend: str = "gloo",
                 timeout_s: float = GROUP_TIMEOUT_S):
        self.world = int(world)
        self.timeout_s = float(timeout_s)
        ctx = mp.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="repro_ranks_")
        init = "file://" + os.path.join(self._dir, "store")
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(self.world)]
        self._procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(r, self.world, init, backend, self.timeout_s,
                  self._tasks[r], self._results, os.getpid()))
            for r in range(self.world)]
        self._closed = False
        for p in self._procs:
            p.start()
        # every rank in the group (a cold start imports torch on each)
        self._collect("joining the group", max(self.timeout_s, 120.0))

    def _collect(self, what: str, limit: float) -> dict:
        """Each rank's next message, within ``limit`` seconds."""
        got: dict = {}
        deadline = time.monotonic() + limit
        while len(got) < self.world:
            left = deadline - time.monotonic()
            if left <= 0:
                self.close(kill=True)
                raise TimeoutError(
                    f"{self.world} ranks did not finish {what} in "
                    f"{limit:.0f} s; killed")
            try:
                rank, out = self._results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if r not in got and not p.is_alive()]
                if dead:
                    self.close(kill=True)
                    raise RuntimeError(f"rank(s) {dead} died {what}")
                continue
            got[rank] = out
        return got

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def run(self, fn, *args) -> list:
        if self._closed:
            raise RuntimeError("the pool's ranks are closed")
        for q in self._tasks:
            q.put((fn, args))
        # the group's own timeout reports a stuck collective first
        got = self._collect(f"running {fn.__name__}",
                            self.timeout_s + min(5.0, self.timeout_s))
        for r in range(self.world):
            if got[r][0] == "err":
                raise got[r][1]
        return [got[r][1] for r in range(self.world)]

    def close(self, kill: bool = False) -> None:
        if self._closed:
            return
        self._closed = True
        if not kill:
            for q in self._tasks:
                q.put(None)
            for p in self._procs:
                p.join(timeout=10.0)
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        for q in (*self._tasks, self._results):
            q.cancel_join_thread()
            q.close()
        shutil.rmtree(self._dir, ignore_errors=True)


def partition_rank(hg: Hypergraph, k: int,
                   params: Optional[ShardedParams] = None, device=None):
    """One rank's share of a sharded run under the default group: its
    assignment, its stats and its row 1 launches on the card."""
    before = hype_score_select.launches
    a, st = hype_sharded_partition(hg, k, params, True, device=device)
    return a, st, hype_score_select.launches - before


def spawn_partition(hg: Hypergraph, k: int,
                    params: Optional[ShardedParams] = None, world: int = 2,
                    *, backend: str = "gloo", device=None,
                    timeout_s: float = GROUP_TIMEOUT_S,
                    return_stats: bool = False):
    """``hype_sharded_partition`` on ``world`` spawned ranks.

    Starts a ``RankPool`` of ``world`` ranks (``backend`` gloo, or NCCL
    with one card a rank), runs the partition on every rank with
    ``device`` (``"cpu"``, or ``"cuda"``: under gloo every rank may share
    one card), checks that every rank returned the same assignment and
    counters, and returns rank 0's (with its stats on ``return_stats``).
    Past ``timeout_s`` the ranks are killed and it raises.
    """
    with RankPool(world, backend=backend, timeout_s=timeout_s) as pool:
        outs = pool.run(partition_rank, hg, k, params, device)
    a0, s0, _ = outs[0]
    for r, (a, s, _) in enumerate(outs[1:], 1):
        if not np.array_equal(a, a0) or run_counters(s) != run_counters(s0):
            raise RuntimeError(f"rank {r}'s result differs from rank 0's")
    return (a0, s0) if return_stats else a0


__all__ = ["Mesh", "RankPool", "ShardedParams", "ShardedState",
           "hype_sharded_partition", "partition_rank", "run_counters",
           "sharded_superstep_device", "spawn_partition"]
