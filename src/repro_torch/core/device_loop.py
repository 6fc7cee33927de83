"""Device-resident HYPE growth loop: one whole round on the device.

The port of ``src/repro/core/device_loop.py``. One round -- [stage-0
pool upkeep -> store take -> pins gather/dedup -> per-slot liveness,
draws and restarts -> requeue -> gather -> score + select kernel ->
admit -> exact cache decrement -> activation] -- runs as torch ops on
tensors, with every piece of the host scheduler's mutable state
(assignment, score cache, pools, the per-phase bucket store, pending
decrements, the restart pointer) held as device tensors in a *carry*.

On the card :class:`DeviceLoop` captures one round as a CUDA graph over
static carry tensors and replays it up to ``cap`` times a chunk; the host
reads four scalars (flags, progress, supersteps, acc) once a chunk. On
the CPU the same round runs eagerly with the plain
``hype_score_select_ref``. Every ``lax.cond`` of the JAX program is
predicated: both sides are computed and selected with ``torch.where``
or masked scatters. The loop's exit condition (all targets met, no
progress, a flag set, the chunk's supersteps reached) is computed on the
device at the top of each round; a round where it is false leaves every
carry tensor as it was. Nothing inside a round synchronizes or changes
shape: no ``.item()``, no ``nonzero``, no boolean-mask indexing.

Parity contract: bit-identical to ``hype_superstep`` at
``pipeline_depth=1`` and, field for field, to the JAX program's carry.
The invariants are the JAX module's (its docstring); the port adds:

* Scatter targets outside the valid range go to a scratch slot at the
  end of each target (``assign``, ``cache``, ``in_pool``,
  ``cache_scored``, ``pend`` at index n; ``edge_dead`` and ``dead_slot``
  at m; ``edge_queued`` flattened to ``kG*m + 1``; an extra row or
  column on the insert, draw and compaction buffers), sliced off at
  download. Every ``.set`` target outside the scratch slot is unique or
  written with one value.
* The restart draw (:func:`rand_draw`) is one running count and one
  ``searchsorted``: the ``cnt`` first available ids from the pointer in
  stream order, the pointer just past the last of them or at ``n`` when
  the stream runs out, then the stragglers by ascending id. That is
  exactly what the windowed scan of ``EngineRuntime.random_unassigned``
  gives; its chunk width is not observable.
* The stage-B slot loop keeps only what later slots observe (which ids
  are available, the pointer, the slot each restart assigned) in the
  sequential loop; each slot's liveness and pack are recorded and
  applied after the loop in one batched pass, which gives the same
  values (a slot only touches its own phase's rows, and the per-edge
  death slot is a minimum).
* Flag values past a mask are built from 0-d tensors made once
  (:class:`Scalars`), and a walk's unused slots read valid indices, so a
  round launches no fill kernel per ``torch.where`` and few masks.
* The injected ``nan`` fault (``poison_at``): JAX's round scores with
  a NaN bias at that ordinal and replays with ``lax.cond``. A captured
  graph has no data-dependent branch, and scoring twice in every round
  would double the kernel's launches, so the round takes ``poison_at``
  only off the graph: the driver runs the chunk up to the ordinal
  before it on the graph and the rest eagerly, where the replay is a
  host branch. Without ``poison_at`` a non-finite score of a real row
  raises ``FLAG_POISON`` (JAX's replay would score the same inputs
  again), and the driver raises.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..kernels.hype_score.ops import SELECT_PAD, hype_score_select
from . import membudget, scoring

# int32 key pad: larger than any live key ((cls<=31)<<25 | seq < 2^30).
PAD32 = 2**31 - 1
# Per-phase seq origin: back inserts ascend from SEQ0, requeue descends
# from SEQ0-1; FLAG_SEQ fires before either side leaves [0, 2^25).
SEQ0 = 1 << 24
CLS_SHIFT = 25          # device key = (cls << CLS_SHIFT) | seq
CLS_CLAMP = 18          # store-take size clamp, see the round's stage A
DEAD_NEVER = 1 << 30    # dead_slot value for "not killed this round"

# Host store key layout (engines/pipeline.py's _PH_SHIFT/_CLS_SHIFT;
# copied here so the module imports without the engine).
_HOST_PH_SHIFT = 50
_HOST_CLS_SHIFT = 44

# Sticky overflow / fault flags (bitmask in carry["flags"]).
FLAG_POISON = 1         # the kernel gave a non-finite score for a real row
FLAG_STORE = 2          # per-phase store rows exceeded SP
FLAG_ACT = 4            # one activation batch exceeded ACT per phase
FLAG_RAWT = 8           # flat activation walk exceeded RAWT slots
FLAG_RAWD = 16          # flat decrement walk exceeded RAWD slots
FLAG_SEQ = 32           # per-phase seq space exhausted (unrecoverable)

# Loop counter slots in the carry["stats"] vector.
S_ROUNDS = 0
S_KERNEL_ROWS = 1
S_EDGES_SCANNED = 2
S_CACHE_INV = 3
S_CACHE_HITS = 4
S_RESTARTS = 5
S_STALE = 6
S_RETRIES = 7
S_REFILL = 8
S_PACK_ONLY = 9
S_STORE_PEAK = 10
NSTATS = 11

# Distinct scratch addresses for the decrement walk's unused slots.
SCRATCH = 4096

# Carry fields, in the JAX program's order; the first five (and pend)
# are per vertex, edge_queued and edge_dead per edge.
CARRY_FIELDS = ("assign", "cache", "acc", "in_pool", "cache_scored",
                "edge_queued", "edge_dead", "skey", "sedge", "sback",
                "sfront", "pool", "pool_n", "pend", "rand_ptr",
                "supersteps", "progress", "flags", "ss_in_chunk", "stats")
_PER_VERTEX = ("assign", "cache", "in_pool", "cache_scored", "pend")
_SCALARS = ("rand_ptr", "supersteps", "progress", "flags", "ss_in_chunk")
CONST_FIELDS = ("adj_indptr", "adj_indices", "v2e_indptr", "v2e_indices",
                "e2v_indptr", "e2v_indices", "cls_edge", "deg", "vdeg",
                "targets", "rand_order", "fringe")


class DeviceLoopConfig(NamedTuple):
    """Static shape of one device-loop round (the JAX config less
    ``interpret``: the tensors' device picks the kernel)."""

    n: int              # vertices
    m: int              # hyperedges
    kG: int             # phases (k)
    rows: int           # fresh tile rows per phase (R)
    pool_cap: int       # held-pool slots per phase (P)
    t: int              # select_k / max admissions per phase per step
    tile_l: int         # adjacency tile width
    bud: int            # store-take row budget ceiling per phase
    pp: int             # pins-gather width per phase (bud + max edge)
    sp: int             # store rows per phase
    act: int            # activation insert width per phase
    rawt: int           # flat activation CSR-walk slots
    rawd: int           # flat decrement CSR-walk slots
    cw: int             # the JAX draw's scan window (max(1024, t))
    cache_f16: bool     # store the score cache as float16 between steps


def _pow2ceil(x: int) -> int:
    return 1 if x <= 1 else 1 << (int(x) - 1).bit_length()


def plan_caps(*, n, m, kG, rows, t, mean_vdeg, mean_adeg, max_edge,
              resume_store_max=0, store_cap=None, act_cap=None,
              rawt_cap=None, rawd_cap=None):
    """Pick the static capacities for :class:`DeviceLoopConfig`.

    The JAX package's heuristics: every cap is a power of two, so the
    doubling-on-overflow rerun ladder converges in a few steps. Returns
    a dict of cap fields.
    """
    bud = max(4 * int(rows), 512)
    pp = bud + _pow2ceil(max_edge)
    sp = store_cap or min(
        _pow2ceil(m),
        _pow2ceil(max(4096, int(resume_store_max), m // 4 + 4 * bud)))
    act = act_cap or min(
        _pow2ceil(m), _pow2ceil(max(1024, int(2 * t * mean_vdeg))))
    rawt = rawt_cap or _pow2ceil(max(16384, int(2 * kG * t * mean_vdeg)))
    rawd = rawd_cap or _pow2ceil(max(16384, int(2 * kG * t * mean_adeg)))
    return dict(bud=bud, pp=pp, sp=sp, act=act, rawt=rawt, rawd=rawd,
                cw=max(1024, int(t)))


def supported(*, n, m, kG, bud) -> bool:
    """Static gates for the int32 device encoding (else the host engine).

    ``bud * 2^CLS_CLAMP < 2^31`` keeps the stage-A size cumsum exact in
    int32 even when every taken row clamps.
    """
    return (kG * m < 2**31 and m < 2**26
            and bud * (1 << CLS_CLAMP) < 2**31 and n < 2**31)


def host_store_to_device(bq_key, bq_edge, kG, sp):
    """Re-encode the host's sorted int64 store as per-phase int32 rows.

    Per phase the rows keep the host's order, with fresh device seqs
    ascending from ``SEQ0``. Returns ``(skey, sedge, sback, sfront)`` as
    numpy, or None if a phase overflows ``sp``.
    """
    skey = np.full((kG, sp), PAD32, dtype=np.int32)
    sedge = np.full((kG, sp), -1, dtype=np.int32)
    sback = np.full(kG, SEQ0, dtype=np.int32)
    sfront = np.full(kG, SEQ0 - 1, dtype=np.int32)
    key = np.asarray(bq_key, dtype=np.int64)
    bounds = np.searchsorted(
        key, np.arange(kG + 1, dtype=np.int64) << _HOST_PH_SHIFT)
    for g in range(kG):
        lo, hi = int(bounds[g]), int(bounds[g + 1])
        c = hi - lo
        if c > sp:
            return None
        cls = ((key[lo:hi] >> _HOST_CLS_SHIFT) & np.int64(63)).astype(
            np.int32)
        skey[g, :c] = (cls << CLS_SHIFT) | (SEQ0 + np.arange(
            c, dtype=np.int32))
        sedge[g, :c] = bq_edge[lo:hi]
        sback[g] = SEQ0 + c
    return skey, sedge, sback, sfront


def carry_bytes(carry_np: dict) -> int:
    """Bytes of the loop state as the JAX package counts them (the numpy
    carry, without the port's scratch slots)."""
    return int(sum(np.asarray(v).nbytes for v in carry_np.values()))


def carry_to_device(carry_np: dict, device) -> dict:
    """The numpy carry (the JAX program's layout) as the port's tensors,
    with their scratch slots: per-vertex fields gain index n,
    ``edge_dead`` index m, ``edge_queued`` is flattened with index
    ``kG*m``; the scalars are 0-d int32 tensors."""
    out = {}
    for name in CARRY_FIELDS:
        a = np.asarray(carry_np[name])
        if name in _PER_VERTEX or name == "edge_dead":
            pad = -1 if name in ("assign", "cache") else 0
            a = np.concatenate([a, np.full(1, pad, dtype=a.dtype)])
        elif name == "edge_queued":
            a = np.concatenate([a.reshape(-1), np.zeros(1, dtype=bool)])
        elif name in _SCALARS:
            a = np.asarray(a, dtype=np.int32).reshape(())
        out[name] = torch.from_numpy(np.array(a)).to(device)
    return out


def carry_to_numpy(carry: dict) -> dict:
    """The port's carry back in the JAX program's numpy layout (the
    scratch slots sliced off)."""
    kG = carry["pool"].shape[0]
    m = carry["edge_dead"].shape[0] - 1
    out = {}
    for name in CARRY_FIELDS:
        a = carry[name].cpu().numpy()
        if name in _PER_VERTEX or name == "edge_dead":
            a = a[:-1]
        elif name == "edge_queued":
            a = a[:-1].reshape(kG, m)
        out[name] = a.copy()
    return out


def consts_to_device(consts: dict, device) -> dict:
    """The loop's read-only graph image on ``device``: numpy arrays are
    uploaded as int32, tensors (the memoized device CSR) kept."""
    out = {}
    for name in CONST_FIELDS:
        v = consts[name]
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.array(v, dtype=np.int32))
        out[name] = v.to(device)
    return out


def loop_live(carry: dict, targets, chunk_cap) -> torch.Tensor:
    """The JAX while_loop's condition as a 0-d bool tensor (no sync)."""
    return ((carry["acc"] < targets).any() & (carry["progress"] > 0)
            & (carry["flags"] == 0) & (carry["ss_in_chunk"] < chunk_cap))


class Scalars:
    """``torch.where`` with 0-d device tensors in place of Python scalars.

    ``torch.where`` turns a Python scalar into a 0-d tensor on the
    condition's device, which on a CUDA device is one fill kernel per
    call; a round makes hundreds of such calls. Here each (value, dtype)
    is made once, during the warm-up round, and reused by every replay.
    A scalar takes the dtype of the other operand when that is a tensor,
    so results keep the dtypes ``torch.where`` gives with the scalar.
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self.made: dict = {}

    def _t(self, v, other):
        if isinstance(v, torch.Tensor):
            return v
        if isinstance(other, torch.Tensor):
            dtype = other.dtype
        else:
            dtype = torch.float32 if isinstance(v, float) else torch.int64
        key = (type(v), v, dtype)
        if key not in self.made:
            self.made[key] = torch.full((), v, dtype=dtype,
                                        device=self.device)
        return self.made[key]

    def where(self, cond, a, b, *, out=None):
        return torch.where(cond, self._t(a, b), self._t(b, a), out=out)


def draw_stream(rand_order: torch.Tensor) -> dict:
    """The restart stream as :func:`rand_draw` reads it: ``order`` (the
    stream, int64), ``spos`` (each id's stream position) and ``vmap``
    (2n + 2,) mapping a position of the draw's virtual sequence to its id:
    n, the stream, the ids in ascending order, n."""
    n = rand_order.shape[0]
    order = rand_order.long()
    iota = torch.arange(n, device=order.device)
    spos = torch.empty_like(order).index_copy_(0, order, iota)
    none = torch.full((1,), n, device=order.device)
    return dict(order=order, spos=spos,
                vmap=torch.cat([none, order, iota, none]))


def rand_draw(avail, stream: dict, ptr, cnt, t: int, *, jt=None, out=None,
              sc=None):
    """``EngineRuntime.random_unassigned(cnt)`` over the restart stream.

    ``avail`` (n + 1,) int64 is 1 at the unassigned ids outside every
    pool and 0 elsewhere (int64, so the running count needs no cast); its
    index n is scratch. It is updated in place: the drawn ids become
    unavailable. ``stream`` is :func:`draw_stream`'s; ``ptr`` and ``cnt``
    are 0-d int64 tensors, ``cnt <= t``. The host takes the first ``cnt``
    available ids from ``ptr`` in stream order and moves the pointer just
    past the last of them, or to ``n`` when the stream runs out
    (unchanged when ``cnt`` is 0); when the stream ran out it takes the
    remaining available ids by ascending id, which are exactly the
    available ids before the pointer. So one running count over a virtual
    sequence -- the stream, then the ids whose stream position is below
    the pointer -- and one ``searchsorted`` of its j-th counts give every
    id at once. ``jt`` (arange(1, t + 1) int64), ``out`` (a (t,) int64
    buffer for ``vs``) and ``sc`` (a :class:`Scalars`) may be passed.
    Returns ``(vs (t,) int64 padded with n, got, ptr)``; nothing
    synchronizes.
    """
    order, spos, vmap = stream["order"], stream["spos"], stream["vmap"]
    n = order.shape[0]
    if sc is None:
        sc = Scalars(order.device)
    if jt is None:
        jt = torch.arange(1, t + 1, device=order.device)
    seq = torch.empty(2 * n + 1, dtype=torch.int64, device=order.device)
    seq[:1].zero_()
    torch.index_select(avail, 0, order, out=seq[1:n + 1])
    torch.mul(avail[:n], spos < ptr, out=seq[n + 1:])
    rank = torch.cumsum(seq, 0)
    base = rank.index_select(0, ptr.view(1))    # available before ptr
    got = torch.minimum(rank[-1] - base, cnt)
    pos = torch.searchsorted(rank, sc.where(jt <= cnt, jt + base, 2 * n + 1))
    vs = torch.index_select(vmap, 0, pos, out=out)
    ptr = sc.where(rank[n] - base >= cnt,
                   torch.cat([ptr.view(1), pos]).index_select(0, cnt.view(1)),
                   n)
    avail.index_fill_(0, vs, 0)
    return vs, got[0], ptr[0]


def make_round(cfg: DeviceLoopConfig, consts: dict):
    """The round as a function ``(carry, poison_at=None) -> new carry`` on
    ``consts``' device. It reads the carry and never writes it.
    ``poison_at`` (a 0-d int32 tensor) poisons the superstep of that
    ordinal and replays it; the round then synchronizes once."""
    n, m, kG = cfg.n, cfg.m, cfg.kG
    R, P, t, L = cfg.rows, cfg.pool_cap, cfg.t, cfg.tile_l
    PP, SP = cfg.pp, cfg.sp
    # the stage-A window: a phase's store holds at most SP rows, so a
    # store narrower than the budget ceiling is taken whole (the JAX
    # program assumes SP >= bud and fails to trace below it, m <= 256)
    BUD = min(cfg.bud, SP)
    ACT, RAWT, RAWD = cfg.act, cfg.rawt, cfg.rawd
    i32, i64 = torch.int32, torch.int64
    m1 = max(m, 1)                      # divisor of the composite keys

    def _nonempty(t):   # a masked gather needs one element to read
        return t if t.numel() else t.new_zeros(1)

    adj_indptr = consts["adj_indptr"]
    adj_indices = _nonempty(consts["adj_indices"])
    v2e_indptr = consts["v2e_indptr"]
    v2e_indices = _nonempty(consts["v2e_indices"])
    # one more row end, so the masked rows' edge 0 reads in range at m = 0
    e2v_indptr = torch.cat([consts["e2v_indptr"], consts["e2v_indptr"][-1:]])
    e2v_indices = _nonempty(consts["e2v_indices"])
    cls_edge = _nonempty(consts["cls_edge"])
    deg, vdeg = consts["deg"], consts["vdeg"]
    targets, fringe = consts["targets"], consts["fringe"]
    dev = targets.device
    sc = Scalars(dev)
    stream = draw_stream(consts["rand_order"])

    def ar(k, dtype=i32):
        return torch.arange(k, dtype=dtype, device=dev)

    iota_k, iota_r, iota_pool, iota_bud = ar(kG), ar(R), ar(P), ar(BUD)
    iota_sp = ar(SP)[None, :]
    pos_pp = ar(PP)
    pos_pp2 = pos_pp.expand(kG, PP).contiguous()
    pos_t, pos_t64 = ar(RAWT), ar(RAWT, i64)
    pos_d = ar(RAWD)
    ones_d = torch.ones_like(pos_d)
    # the adjacency, then RAWD scratch ids past n for the decrement walk's
    # unused slots (its virtual last row, RAWD long, starts at nnz)
    adj_tail = torch.cat([adj_indices, (n + (pos_d & (SCRATCH - 1))).to(
        adj_indices.dtype)])
    adj_nnz = torch.full((1,), adj_indices.numel(), dtype=adj_indptr.dtype,
                         device=dev)
    rawd_row = torch.full((1,), RAWD, dtype=i32, device=dev)
    iota_k1 = ar(kG + 1, i64)
    jt = ar(t, i64) + 1                 # the draw's j = 1..t
    phase_rows = ar(kG * t) // t        # the (phase, slot) rows' phases
    ph_w64 = phase_rows.long()
    slot_ids = iota_k[:, None].expand(kG, BUD).reshape(-1).contiguous()
    ph_shift = 64 * m1                  # composite key: (ph*64+cls)*m + e
    PAD64 = torch.iinfo(i64).max
    trunc = float(scoring.TRUNC_PENALTY)   # rounded to float32 by where
    inf = float("inf")

    def _walk(vflat, degs, indptr, indices, pos):
        """One flat CSR walk over the rows of ``vflat``'s ids (-1: none):
        slot p < total holds the p-th entry of those rows concatenated.
        Returns ``(entries, owner row, p < total, total)``; past total an
        entry is a valid index all the same (clamped), so gathers through
        it need no mask."""
        vok = vflat >= 0
        vsafe = sc.where(vok, vflat, 0).long()
        vd = sc.where(vok, degs[vsafe], 0)
        incl = torch.cumsum(vd, 0, dtype=i32)
        offs = incl - vd
        total = incl[-1]
        own = torch.searchsorted(offs, pos, right=True, out_int32=True) - 1
        base = indptr[vsafe] - offs
        ent = indices[torch.clamp(base[own] + pos, max=indices.numel() - 1)]
        return ent, own, pos < total, total

    def _merge(ak, av, bk, bv):
        """Merge sorted (PAD-padded) key rows, keep the first SP.

        Keys are unique and the pads' destinations collision-free (the
        JAX module's proof), so two scatters replace a sort."""
        bk, bv = bk.contiguous(), bv.contiguous()
        SA, SB = ak.shape[1], bk.shape[1]
        pa = ar(SA, i64) + torch.searchsorted(bk, ak)
        pb = ar(SB, i64) + torch.searchsorted(ak, bk, right=True)
        ok = torch.full((kG, SA + SB), PAD32, dtype=i32, device=dev)
        ok.scatter_(1, pa, ak).scatter_(1, pb, bk)
        ov = torch.full((kG, SA + SB), -1, dtype=i32, device=dev)
        ov.scatter_(1, pa, av).scatter_(1, pb, bv)
        return ok[:, :SP].contiguous(), ov[:, :SP].contiguous()

    def _activate(vs_grid, deadfn, eq, sback, skey, sedge, flags):
        """Queue the edges incident to the (kG, t) admissions
        ``vs_grid`` (``activate_many``): one flat RAWT-slot CSR walk, the
        (phase, class, edge) order of the host's lexsort from one sort of
        a composite key (which also brings duplicates together), and a
        pre-sorted per-phase block merged into the store. ``eq`` is
        updated in place."""
        ent, own, pvalid, total = _walk(vs_grid.reshape(-1), vdeg,
                                        v2e_indptr, v2e_indices, pos_t)
        e, oph = ent.long(), ph_w64[own]
        qrow = eq[oph * m + e]      # past total: an edge id all the same
        live = pvalid & ~qrow & ~deadfn(e, oph)
        comp = sc.where(live, (oph * 64 + cls_edge[e]) * m1 + e, PAD64)
        sk = torch.sort(comp).values
        prevk = torch.cat([sk.new_full((1,), -1), sk[:-1]])
        first = (sk != PAD64) & (sk != prevk)
        rank = torch.cumsum(first, 0) - 1
        ckey = torch.full((RAWT + 1,), PAD64, dtype=i64, device=dev)
        ckey.index_put_((sc.where(first, rank, RAWT),), sk)
        ckey = ckey[:RAWT]
        uvalid = ckey != PAD64
        uph = sc.where(uvalid, ckey // ph_shift, kG)
        ucls = sc.where(uvalid, (ckey // m1) % 64, 0)
        ue = sc.where(uvalid, ckey % m1, 0)
        # uph is sorted (pads last): each phase's rows are one run
        bounds = torch.searchsorted(uph, iota_k1)
        local = pos_t64 - bounds[uph]
        cnt = (bounds[1:] - bounds[:-1]).to(i32)
        seq = sback[sc.where(uvalid, uph, 0)] + local
        nkey = sc.where(uvalid, (ucls << CLS_SHIFT) | seq, PAD32).to(i32)
        sback = sback + cnt
        flags = (flags
                 | sc.where((sback >= (1 << CLS_SHIFT)).any(), FLAG_SEQ, 0)
                 | sc.where(total > RAWT, FLAG_RAWT, 0)
                 | sc.where((cnt > ACT).any(), FLAG_ACT, 0))
        cols = torch.clamp(local, max=ACT)
        ins_k = torch.full((kG + 1, ACT + 1), PAD32, dtype=i32, device=dev)
        ins_k.index_put_((uph, cols), nkey)
        ins_e = torch.full((kG + 1, ACT + 1), -1, dtype=i32, device=dev)
        ins_e.index_put_((uph, cols), sc.where(uvalid, ue, -1).to(i32))
        eq.index_fill_(0, sc.where(uvalid, uph * m + ue, kG * m), True)
        seg = (skey != PAD32).sum(1, dtype=i32)
        flags = flags | sc.where((seg + cnt > SP).any(), FLAG_STORE, 0)
        skey, sedge = _merge(skey, sedge, ins_k[:kG, :ACT], ins_e[:kG, :ACT])
        return sback, skey, sedge, flags

    def _decrements(vflat, pend, flags):
        """Add the admissions' neighbour multiset to ``pend`` in place
        (the host's ``bincount`` of the adjacency rows, duplicates
        included): one flat RAWD-slot walk and an integer ``index_add_``.
        A virtual last row reads the walk's unused slots from a tail of
        ``adj_tail`` that spreads them over SCRATCH addresses past n
        (atomics onto one address would serialize), so no slot needs a
        mask."""
        vok = vflat >= 0
        vsafe = sc.where(vok, vflat, 0).long()
        vd = torch.cat([sc.where(vok, deg[vsafe], 0), rawd_row])
        incl = torch.cumsum(vd, 0, dtype=i32)
        offs = incl - vd
        total = offs[-1]
        own = torch.searchsorted(offs, pos_d, right=True, out_int32=True) - 1
        base = torch.cat([adj_indptr[vsafe], adj_nnz]) - offs
        buf = torch.zeros(n + SCRATCH, dtype=i32, device=dev)
        buf.index_add_(0, adj_tail[base[own] + pos_d], ones_d)
        pend[:n] += buf[:n]
        return flags | sc.where(total > RAWD, FLAG_RAWD, 0)

    def _round(c, poison_at=None):
        assign = c["assign"].clone()
        acc, pool, pool_n = c["acc"], c["pool"], c["pool_n"]
        in_pool = c["in_pool"].clone()
        skey, sedge = c["skey"], c["sedge"]
        sback, sfront = c["sback"], c["sfront"]
        ss, flags = c["supersteps"], c["flags"]
        pre_dead = c["edge_dead"]   # the death view at the top of the round

        # -- slot order: the ascending active ids rolled by the superstep
        active = acc < targets
        n_active = torch.clamp(active.sum(dtype=i32), min=1)
        ord0 = torch.argsort((~active).to(i32), stable=True)
        rot = ss % n_active
        order = sc.where(iota_k < n_active,
                         ord0[(rot + iota_k) % n_active], -1)

        # -- stage 0: drop stale held ids, size each phase's draw
        pok = pool >= 0
        keep = pok & (assign[sc.where(pok, pool, 0).long()] < 0)
        in_pool.index_fill_(
            0, sc.where(pok & ~keep, pool, n).reshape(-1).long(), False)
        pool_n = keep.sum(1, dtype=i32)
        krank = torch.cumsum(keep, 1, dtype=i32) - 1
        pool = torch.full((kG, P + 1), -1, dtype=i32, device=dev).scatter_(
            1, sc.where(keep, krank, P).long(), pool)[:, :P]
        need = sc.where(active, torch.clamp(P - pool_n, max=R), 0)
        budget = sc.where(need > 0, torch.clamp(4 * need, min=512), 0)

        # -- stage A: greedy smallest-class prefix take per phase over
        #    the first BUD rows (the size clamps at 2^CLS_CLAMP, above any
        #    budget: int32 exact)
        sl_key, sl_edge = skey[:, :BUD], sedge[:, :BUD]
        live_row = sl_key != PAD32
        cls_row = sc.where(live_row, sl_key >> CLS_SHIFT, 0)
        csize = sc.where(
            live_row, 1 << torch.clamp(cls_row, max=CLS_CLAMP), 0)
        excl = torch.cumsum(csize, 1, dtype=i32) - csize
        take = live_row & (excl < budget[:, None])
        T = take.sum(1, dtype=i32)
        ek = sc.where(take, sl_edge, -1)
        tcls = sc.where(take, cls_row, 0)
        src = iota_sp + T[:, None]
        srcc = torch.clamp(src, max=SP - 1).long()
        skey = sc.where(src < SP, skey.gather(1, srcc), PAD32)
        sedge = sc.where(src < SP, sedge.gather(1, srcc), -1)

        # -- pins gather: one flat PP-slot walk per phase, then the
        #    stream-order first-occurrence dedup
        ek_safe = sc.where(take, ek, 0).long()
        esz = sc.where(
            take, e2v_indptr[ek_safe + 1] - e2v_indptr[ek_safe], 0)
        offs_ex = torch.cat([torch.zeros((kG, 1), dtype=i32, device=dev),
                             torch.cumsum(esz, 1, dtype=i32)], 1)
        jcol = torch.searchsorted(offs_ex, pos_pp2, right=True) - 1
        pv = pos_pp[None, :] < offs_ex[:, -1:]
        jsafe = sc.where(pv, jcol, 0)
        pidx = (e2v_indptr[ek_safe.gather(1, jsafe)] + pos_pp[None, :]
                - offs_ex.gather(1, jsafe))
        pins = e2v_indices[sc.where(pv, pidx, 0).long()].to(i32)
        edges_scanned = pv.sum(dtype=i32)
        spin, permd = torch.sort(sc.where(pv, pins, n), dim=1,
                                 stable=True)
        svalid = pv.gather(1, permd)
        dprev = torch.cat([torch.full((kG, 1), -1, dtype=i32, device=dev),
                           spin[:, :-1]], 1)
        dedup = torch.zeros((kG, PP), dtype=torch.bool,
                            device=dev).scatter_(
            1, permd, svalid & (spin != dprev))

        # -- stage B, in rotation order. Each slot's phase-local inputs
        #    are gathered into slot order first; only what later slots
        #    observe (which ids are available, the pointer, the slot of
        #    each restart) is updated inside the loop.
        valid_o = order >= 0
        gs_o = torch.clamp(order, min=0)
        pins_o = pins.index_select(0, gs_o)
        pins_l = pins_o.long()
        pv_o = pv.index_select(0, gs_o)
        dedup_o = (dedup.index_select(0, gs_o) & pv_o).long()
        held_o = pool_n.index_select(0, gs_o)
        need_o = need.index_select(0, gs_o)
        cntmax_o = torch.clamp(targets.index_select(0, gs_o)
                               - acc.index_select(0, gs_o), max=t)
        # a slot restarts when it holds nothing and draws nothing
        cntr_o = sc.where(valid_o & (held_o == 0), cntmax_o, 0).long()
        gs32_o = gs_o.to(i32)
        avail = ((assign < 0) & ~in_pool).long()
        # the slot at which a restart assigned each vertex (kG: none), so
        # each slot's view of the assignment is rebuilt after the loop
        rslot = torch.full((n + 1,), kG, dtype=i32, device=dev)
        drawn_o = torch.empty((kG, PP), dtype=torch.bool, device=dev)
        rvs_o = torch.empty((kG, t), dtype=i64, device=dev)
        nv_o = torch.empty(kG, dtype=i64, device=dev)
        ptr = c["rand_ptr"].long()
        for i in range(kG):
            p_i = pins_l[i]
            okc = dedup_o[i] * avail[p_i]       # int64 0/1: no cast to sum
            drawn = drawn_o[i]
            torch.logical_and(okc, torch.cumsum(okc, 0) <= need_o[i],
                              out=drawn)
            avail.index_fill_(0, sc.where(drawn, p_i, n), 0)
            vs, nv, ptr = rand_draw(
                avail, stream, ptr, sc.where(drawn.any(), 0, cntr_o[i]),
                t, jt=jt, out=rvs_o[i], sc=sc)
            rslot.index_fill_(0, vs, i)
            nv_o[i] = nv
        nv_o = nv_o.to(i32)
        # each slot saw the assignment of the round's top plus the
        # restarts of the slots before it
        unas_o = (pv_o & (assign[pins_l] < 0)
                  & (rslot[pins_l] >= iota_k[:, None]))
        assign.index_put_((rvs_o.reshape(-1),),
                          gs32_o[:, None].expand(kG, t).reshape(-1))
        rvs_o = sc.where(rvs_o < n, rvs_o, -1).to(i32)     # n: no draw

        # -- each slot's liveness, at its turn, applied in one pass
        nd_o = drawn_o.sum(1, dtype=i32)
        is_r_o = valid_o & (held_o == 0) & (nd_o == 0)
        is_p_o = valid_o & ~is_r_o
        in_pool.index_fill_(
            0, sc.where(drawn_o, pins_l, n).reshape(-1), True)
        ek_o = ek.index_select(0, gs_o)
        taken_o = ((iota_bud[None, :] < T.index_select(0, gs_o)[:, None])
                   & valid_o[:, None])
        live_e = torch.zeros((kG, BUD + 1), dtype=torch.bool,
                             device=dev).scatter_(
            1, sc.where(unas_o, jcol.index_select(0, gs_o), BUD), True)
        live_e = live_e[:, :BUD] & taken_o
        dead_idx = sc.where(taken_o & ~live_e, ek_o, m).reshape(-1).long()
        edge_dead = pre_dead.clone().index_fill_(0, dead_idx, True)
        dead_slot = torch.full((m + 1,), DEAD_NEVER, dtype=i32,
                               device=dev).scatter_reduce_(
            0, dead_idx, slot_ids, "amin")

        # -- each packing slot's rows: misses become fresh kernel rows,
        #    cache hits join the held pool
        sc_o = c["cache_scored"][pins_l]
        hit = drawn_o & sc_o & is_p_o[:, None]
        miss = drawn_o & ~sc_o & is_p_o[:, None]
        nh = hit.sum(1, dtype=i32)[:, None]
        nm = miss.sum(1, dtype=i32)[:, None]

        def compact(mask):
            rank_ = torch.cumsum(mask, 1, dtype=i32) - 1
            return torch.full((kG, R + 1), -1, dtype=i32,
                              device=dev).scatter_(
                1, sc.where(mask, rank_, R).long(), pins_o)[:, :R]

        mc, hc = compact(miss), compact(hit)
        held = held_o[:, None]
        ip_ = iota_pool[None, :]
        pool_o = pool.index_select(0, gs_o)
        pa_row = sc.where(ip_ < held, pool_o, sc.where(
            ip_ < held + nh,
            hc.gather(1, torch.clamp(ip_ - held, 0, R - 1).long()), -1))
        np_row = sc.where(ip_ < held + nh, pa_row, sc.where(
            ip_ < held + nh + nm,
            mc.gather(1, torch.clamp(ip_ - held - nh, 0, R - 1).long()),
            -1))
        bias_o = sc.where(
            iota_r[None, :] < nm,
            sc.where(deg[sc.where(mc >= 0, mc, 0).long()] > L, trunc, 0.0),
            inf)
        isp = is_p_o[:, None]
        # back to phase order in one row scatter (rows of unused slots go
        # to the scratch row kG)
        dst = sc.where(valid_o, order, kG)
        blk_o = torch.cat([
            mc, sc.where(isp, pa_row, -1), sc.where(isp, np_row, pool_o),
            rvs_o, (held_o + sc.where(is_p_o, nd_o, 0))[:, None],
            sc.where(nv_o > 0, iota_k, -1)[:, None], nv_o[:, None],
            live_e.to(i32)], 1)
        blk = torch.cat([
            torch.full((kG, R + P), -1, dtype=i32, device=dev), pool,
            torch.full((kG, t), -1, dtype=i32, device=dev), pool_n[:, None],
            torch.full((kG, 1), -1, dtype=i32, device=dev),
            torch.zeros((kG, 1 + BUD), dtype=i32, device=dev)], 1)
        blk = torch.cat([blk, blk[:1]]).index_copy_(0, dst, blk_o)[:kG]
        fresh, pool_arr = blk[:, :R], blk[:, R:R + P]
        pool = blk[:, R + P:R + 2 * P]
        o = R + 2 * P
        restart_vs = blk[:, o:o + t]
        pool_n, slot_r, nv = (blk[:, o + t], blk[:, o + t + 1],
                              blk[:, o + t + 2])
        live_rq = blk[:, o + t + 3:] > 0
        bias = torch.full((kG + 1, R), inf, device=dev).index_copy_(
            0, dst, bias_o)[:kG]
        acc = acc + nv
        injected = nv_o.sum(dtype=i32)
        packed_any = is_p_o.any()

        # -- requeue still-live taken rows at the queue fronts (front
        #    seqs descend: requeues sort before fresher rows of a class)
        rq_c = live_rq.sum(1, dtype=i32)
        qidx = sc.where(
            live_rq, torch.cumsum(live_rq, 1, dtype=i32) - 1, BUD).long()
        rq_e = torch.full((kG, BUD + 1), -1, dtype=i32,
                          device=dev).scatter_(1, qidx, ek)[:, :BUD]
        rq_cl = torch.zeros((kG, BUD + 1), dtype=i32,
                            device=dev).scatter_(1, qidx, tcls)[:, :BUD]
        colb = iota_bud[None, :]
        rq_val = colb < rq_c[:, None]
        rq_seq = (sfront - rq_c)[:, None] + 1 + colb
        rq_key = sc.where(rq_val, (rq_cl << CLS_SHIFT) | rq_seq, PAD32)
        sfront = sfront - rq_c
        seg = (skey != PAD32).sum(1, dtype=i32)
        flags = (flags | sc.where((sfront < 0).any(), FLAG_SEQ, 0)
                 | sc.where((seg + rq_c > SP).any(), FLAG_STORE, 0))
        skey, sedge = _merge(skey, sedge, rq_key,
                             sc.where(rq_val, rq_e, -1))

        # -- deferred restart activations: each sees exactly the deaths
        #    that had happened by its slot; their decrements join pend
        eq = c["edge_queued"].clone()
        sback, skey, sedge, flags = _activate(
            restart_vs,
            lambda e, ph: pre_dead[e] | (dead_slot[e] <= slot_r[ph]),
            eq, sback, skey, sedge, flags)
        pend = c["pend"].clone()
        flags = _decrements(restart_vs.reshape(-1), pend, flags)

        # -- dispatch + harvest. A pack-only round (nothing packed) runs
        #    it too: with no fresh or pool slot it admits nothing, and
        #    the superstep count, the decrement drain and its counter are
        #    masked, so it leaves the state as the JAX round's skip does.
        pk32 = packed_any.to(i32)
        cache_inv = sc.where(packed_any, (pend[:n] > 0).sum(dtype=i32), 0)
        c32 = c["cache"].float() if cfg.cache_f16 else c["cache"]
        # exact decrement drain: x - 0.0 == x (the cache holds no -0.0)
        c32 = c32 - sc.where(packed_any, pend, 0).float()
        pend = sc.where(packed_any, 0, pend)
        flat = fresh.reshape(-1)
        real = flat >= 0
        tile = scoring._gather_fresh_tiles(adj_indptr, adj_indices, assign,
                                           flat, L)
        prev, n_stale = scoring._stale_masked_prev(pool_arr, assign, c32)

        def kernel(b):
            return hype_score_select(tile.view(kG, R, L), fringe, b, prev,
                                     select_k=t)

        def bad(out):
            return (real & ~torch.isfinite(out[0].reshape(-1))).any()

        if poison_at is None:
            out = kernel(bias)
            pois = retried = bad(out)
        else:
            # the superstep of ordinal poison_at scores a NaN bias on its
            # fresh rows, finds the poison and replays with the clean one
            out = kernel(torch.where((ss + 1 == poison_at) & (fresh >= 0),
                                     float("nan"), bias))
            retried = bad(out)
            if bool(retried):
                out = kernel(bias)
            pois = bad(out)
        scores, sel_idx, sel_val, rem = out
        flags = flags | sc.where(pois, FLAG_POISON, 0)
        phase_has = (fresh >= 0).any(1) | (pool_arr >= 0).any(1)
        refill = (phase_has & (rem < t)).sum(dtype=i32)
        fidx = sc.where(real, flat, n).long()
        c32.index_put_((fidx,), scores.reshape(-1))
        slots = torch.cat([fresh, pool_arr], 1)
        cand = slots.gather(1, sel_idx.long().clamp(max=R + P - 1))
        okw = ((sel_val < SELECT_PAD) & (cand >= 0)
               & (assign[sc.where(cand >= 0, cand, 0).long()] < 0))
        cap = torch.clamp(targets - acc, min=0)
        adm = okw & (torch.cumsum(okw, 1, dtype=i32) <= cap[:, None])
        winners = sc.where(adm, cand, -1)
        assign.index_put_((sc.where(adm, cand, n).reshape(-1).long(),),
                          phase_rows)
        acc = acc + adm.sum(1, dtype=i32)
        cache_scored = c["cache_scored"].clone().index_fill_(0, fidx, True)
        widx = sc.where(winners >= 0, winners, n).reshape(-1).long()
        in_pool.index_fill_(0, widx, False)
        nwin = (winners >= 0).sum(dtype=i32)
        sback, skey, sedge, flags = _activate(
            winners, lambda e, ph: edge_dead[e], eq, sback, skey, sedge,
            flags)
        flags = _decrements(winners.reshape(-1), pend, flags)
        # release completed phases' pools
        done = adm.any(1) & (acc >= targets)
        in_pool.index_fill_(0, sc.where(
            done[:, None] & (pool >= 0), pool, n).reshape(-1).long(), False)
        pool = sc.where(done[:, None], -1, pool)
        pool_n = sc.where(done, 0, pool_n)
        cache = (torch.clamp(c32, -65504.0, 65504.0).half()
                 if cfg.cache_f16 else c32)

        zero = torch.zeros((), dtype=i32, device=dev)
        inc = torch.stack([
            torch.ones((), dtype=i32, device=dev),              # S_ROUNDS
            nm.sum(dtype=i32),                                  # KERNEL_ROWS
            edges_scanned,                                      # EDGES_SCANNED
            cache_inv,                                          # CACHE_INV
            sc.where(is_p_o, held_o + nh[:, 0], 0).sum(dtype=i32),
            (nv_o > 0).sum(dtype=i32),                          # RESTARTS
            n_stale.to(i32),                                    # STALE
            retried.to(i32),                                    # RETRIES
            refill,                                             # REFILL
            (~packed_any).to(i32),                              # PACK_ONLY
            zero])
        stats = c["stats"] + inc
        stats[S_STORE_PEAK] = torch.maximum(
            stats[S_STORE_PEAK], (skey != PAD32).sum(dtype=i32))
        return dict(
            assign=assign, cache=cache, acc=acc, in_pool=in_pool,
            cache_scored=cache_scored, edge_queued=eq, edge_dead=edge_dead,
            skey=skey, sedge=sedge, sback=sback, sfront=sfront, pool=pool,
            pool_n=pool_n, pend=pend, rand_ptr=ptr.to(i32),
            supersteps=ss + pk32,
            progress=injected + nwin, flags=flags.to(i32),
            ss_in_chunk=c["ss_in_chunk"] + pk32, stats=stats)

    return _round


def _graph_nodes(graph) -> int:
    """Node count of a kept CUDA graph, from the driver API."""
    import ctypes

    get_nodes = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes
    get_nodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.POINTER(ctypes.c_size_t)]
    get_nodes.restype = ctypes.c_int
    count = ctypes.c_size_t(0)
    rc = get_nodes(graph.raw_cuda_graph(), None, ctypes.byref(count))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed with CUresult {rc}")
    return int(count.value)


class DeviceLoop:
    """Runs the round over a carry on its device, a chunk at a time.

    On a CUDA device the constructor warms one round up on a side stream
    (so the score + select workspace and the allocator's blocks exist
    outside the capture), captures one predicated round as a CUDA graph
    and instantiates it; ``run_chunk(cap)`` replays it ``cap`` times.
    ``hype_score_select.launches`` then counts the replays times the
    launches in one captured round (the capture itself launches nothing).
    On the CPU ``run_chunk`` runs rounds eagerly while the loop's
    condition holds, as the JAX while_loop does; so does a chunk that
    holds an injected ``nan`` fault, on the card too (``off_rounds``
    counts those rounds there). Either way the host downloads flags,
    progress, supersteps and acc in one copy a chunk.
    """

    def __init__(self, cfg: DeviceLoopConfig, consts: dict, carry: dict):
        self.cfg = cfg
        self.carry = carry
        self.targets = consts["targets"]
        dev = self.targets.device
        self.chunk_cap = torch.zeros((), dtype=torch.int32, device=dev)
        self._round = make_round(cfg, consts)
        self.graph = None
        self.nodes = 0
        self.capture_s = 0.0
        self.launches_per_round = 0
        self.off_rounds = 0
        if dev.type == "cuda":
            self._capture(dev)

    def _step(self, poison_at=None) -> None:
        c = self.carry
        live = loop_live(c, self.targets, self.chunk_cap)
        new = self._round(c, poison_at)
        for name, v in c.items():     # same-index aliasing: one kernel
            torch.where(live, new[name], v, out=v)

    def _capture(self, dev) -> None:
        t0 = time.perf_counter()
        stream = torch.cuda.Stream(device=dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            # the warm-up round's results are dropped: the carry stays
            live = loop_live(self.carry, self.targets, self.chunk_cap)
            new = self._round(self.carry)
            for name, v in self.carry.items():
                torch.where(live, new[name], v)
            del new
        torch.cuda.current_stream(dev).wait_stream(stream)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = hype_score_select.launches
        try:
            with torch.cuda.graph(graph, stream=stream):
                self._step()
        except Exception as exc:
            # an allocation that failed mid-capture: the capture has ended
            # (the context manager's exit). Should ending it raise in turn,
            # the OOM underneath is what the memory rungs answer.
            under = exc.__context__
            if (not membudget.is_oom_error(exc) and under is not None
                    and membudget.is_oom_error(under)):
                raise membudget.DeviceOOM(
                    f"CUDA graph capture failed: {under!r}") from exc
            raise
        finally:
            # the capture launches nothing: its calls count per replay
            self.launches_per_round = hype_score_select.launches - before
            hype_score_select.launches = before
        self.nodes = _graph_nodes(graph)
        graph.instantiate()
        torch.cuda.synchronize(dev)
        self.graph = graph
        self.capture_s = time.perf_counter() - t0

    def run_chunk(self, cap: int, poison_at: int = 0):
        """Run up to ``cap`` supersteps; returns ``(flags, progress,
        supersteps, acc)`` from one download. ``poison_at`` > 0 runs the
        rounds eagerly with the superstep of that ordinal poisoned."""
        c = self.carry
        c["ss_in_chunk"].zero_()
        self.chunk_cap.fill_(int(cap))
        if self.graph is None or poison_at > 0:
            pa = (torch.full((), int(poison_at), dtype=torch.int32,
                             device=self.targets.device)
                  if poison_at > 0 else None)
            while bool(loop_live(c, self.targets, self.chunk_cap)):
                self._step(pa)
                self.off_rounds += self.graph is not None
        else:
            for _ in range(int(cap)):
                self.graph.replay()
            hype_score_select.launches += int(cap) * self.launches_per_round
        out = torch.cat([c["flags"].view(1), c["progress"].view(1),
                         c["supersteps"].view(1), c["acc"]]).cpu().numpy()
        return (int(out[0]), int(out[1]), int(out[2]),
                out[3:].astype(np.int64))
