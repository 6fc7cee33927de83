"""Device-memory budgeting for the superstep engines.

The port of ``src/repro/core/membudget.py``: running out of device memory
is a handled, bounded-cost event, not a crash. Three pieces make it one:

  * **Budget planner**: ``plan_memory`` estimates the bytes of every
    device-resident tensor of a superstep run (CSR image, assignment,
    score cache, gather tiles, in-flight transients) *before* upload
    with ``estimate_plan_bytes``, a pure function of the graph and knob
    sizes, and walks a deterministic **rung ladder** of smaller
    configurations until one fits the budget:

        rung 0  the engine's default plan
        rung 1  phase-chunked scoring (``g_chunk=2``)
        rung 2  ``tile_l`` one ``L_BUCKETS`` bucket down (skipped when
                already at the smallest bucket)
        rung 3  ``pipeline_depth=1`` (lock-step)
        rung 4  the score cache spilled to host (depth 1 only)
        rung 5  paged adjacency (the CSR image itself does not fit)

    Every rung except the ``tile_l`` drop is bit-exact on the
    single-device engine: phase chunks score the same tiles, depth 1 is
    the golden schedule, the host float32 cache mirror does the same
    IEEE arithmetic, and the paged gather feeds the program the raw rows
    the resident gather reads. The ``tile_l`` drop changes results only
    for rows wider than the smaller bucket (they take the hub penalty).

  * **OOM taxonomy**: ``is_oom_error`` classifies real allocator
    failures (``torch.OutOfMemoryError``, ``MemoryError``, a message
    naming an out-of-memory condition) so the upload, dispatch and
    harvest sites convert them, and the injected non-fatal ``oom``
    fault of ``resilience.FaultPlan``, into one ``DeviceOOM`` recovery
    path: retry the *same* engine at the next rung, warm-started from
    the host assignment mirror, before ``partition_resilient`` changes
    engines. A fatal ``oom:fatal`` spec still raises
    ``UnrecoverableFault``.

  * **Paged adjacency**: ``PagedAdjacency`` keeps the vertex-adjacency
    CSR on the host and uploads fixed row-range chunks to the device
    under an LRU byte budget; each superstep's candidate tile is
    gathered chunk by chunk on the device, in stream order, with no host
    sync. Row lengths are narrowed to int16 when the degrees allow.

The budget comes from the ``mem_budget`` engine knob, the
``REPRO_DEVICE_MEM_BUDGET`` environment variable (``"512MB"``,
``"2GiB"``, plain bytes) or, when neither is set, a probe of the card's
free memory (``torch.cuda.mem_get_info``); on the CPU the probe reports
nothing and the run is unconstrained (rung 0).
"""
from __future__ import annotations

import collections
import dataclasses
import os
import re
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import scoring

ENV_BUDGET = "REPRO_DEVICE_MEM_BUDGET"

# Rung feature sets: the single-device engine supports every reduction;
# the sharded engine's programs exist only for the width and depth knobs
# (its CSR is replicated, so paging would need another collective layout).
SUPERSTEP_FEATURES = ("chunk", "tile_l", "depth", "spill", "paged")
SHARDED_FEATURES = ("tile_l", "depth")


class DeviceOOM(RuntimeError):
    """A device allocation failed (real or injected, non-fatal).

    ``rung`` is the memory-plan rung the failing attempt ran at (None
    when the failure predates planning) and ``partial`` the host
    assignment mirror at failure time, a numpy array used to warm-start
    the next rung.
    """

    def __init__(self, msg: str, rung: Optional[int] = None,
                 partial: Optional[np.ndarray] = None):
        super().__init__(msg)
        self.rung = rung
        self.partial = partial


class MemoryLadderExhausted(RuntimeError):
    """Every memory rung was tried and the device still OOMs; the retry
    loop turns this into ``UnrecoverableFault`` for the engine ladder."""


def is_oom_error(exc: BaseException) -> bool:
    """True when ``exc`` is a real allocator failure.

    ``torch.OutOfMemoryError`` (the caching allocator's), ``MemoryError``,
    and any error whose message names an out-of-memory condition (the
    JAX package's rule, so a ``RESOURCE_EXHAUSTED`` status or a CUDA
    ``out of memory`` error raised as a plain ``RuntimeError`` counts).
    """
    if isinstance(exc, (MemoryError, torch.OutOfMemoryError)):
        return True
    text = f"{type(exc).__name__}: {exc}"
    return ("RESOURCE_EXHAUSTED" in text
            or "out of memory" in text.lower()
            or "OutOfMemory" in text)


def oom_guard(fn, what: str, rung: Optional[int]):
    """Call ``fn()``; a real allocator failure becomes ``DeviceOOM``
    (``what`` names the site, ``rung`` the plan's rung). Any other
    exception propagates as itself."""
    try:
        return fn()
    except DeviceOOM:
        raise
    except Exception as exc:
        if is_oom_error(exc):
            raise DeviceOOM(f"{what}: {exc!r}", rung=rung) from exc
        raise


# ----------------------------------------------------------- budget source

_UNIT = {
    "": 1, "b": 1,
    "k": 10 ** 3, "kb": 10 ** 3, "kib": 1 << 10,
    "m": 10 ** 6, "mb": 10 ** 6, "mib": 1 << 20,
    "g": 10 ** 9, "gb": 10 ** 9, "gib": 1 << 30,
    "t": 10 ** 12, "tb": 10 ** 12, "tib": 1 << 40,
}


def parse_budget(text) -> Optional[int]:
    """Parse a byte budget: int, ``"512MB"``, ``"1.5GiB"``, ``"2g"``.

    Decimal units (KB/MB/GB) are powers of 10, binary units (KiB/MiB/
    GiB) powers of 2. ``None``, ``""``, ``"none"`` and ``0`` mean
    *unconstrained* and return None.
    """
    if text is None:
        return None
    if isinstance(text, (int, np.integer)):
        return int(text) or None
    s = str(text).strip().lower()
    if s in ("", "none", "unlimited"):
        return None
    m = re.fullmatch(r"([0-9]*\.?[0-9]+)\s*([a-z]*)", s)
    if not m or m.group(2) not in _UNIT:
        raise ValueError(
            f"unparseable memory budget {text!r}; use bytes or a "
            f"KB/MB/GB/KiB/MiB/GiB suffix")
    return int(float(m.group(1)) * _UNIT[m.group(2)]) or None


def _cuda_device(device) -> Optional[torch.device]:
    """``device`` as a CUDA device, or None when it is not one. None
    means the current card where there is one (an entry point's
    default)."""
    if device is None:
        return (torch.device("cuda", torch.cuda.current_device())
                if torch.cuda.is_available() else None)
    device = torch.device(device)
    return device if device.type == "cuda" else None


def probe_device_budget(device=None) -> Optional[int]:
    """The bytes the card can still give this process, or None.

    Its free memory plus what PyTorch's caching allocator holds reserved
    but unallocated (those blocks serve a new tensor without a
    ``cudaMalloc``). None on the CPU, which the planner treats as
    unconstrained.
    """
    dev = _cuda_device(device)
    if dev is None:
        return None
    free, _ = torch.cuda.mem_get_info(dev)
    idle = (torch.cuda.memory_reserved(dev)
            - torch.cuda.memory_allocated(dev))
    return int(free + idle)


def reset_peak(device) -> None:
    """Start a run's peak-memory window on a CUDA ``device``."""
    dev = _cuda_device(device)
    if dev is not None:
        torch.cuda.reset_peak_memory_stats(dev)


def observed_peak_bytes(device=None) -> Optional[int]:
    """``torch.cuda.max_memory_allocated`` since ``reset_peak``, or None
    on the CPU (the stats then report the planned bytes, as in JAX)."""
    dev = _cuda_device(device)
    if dev is None:
        return None
    return int(torch.cuda.max_memory_allocated(dev)) or None


def resolve_budget(mem_budget=None, device=None) -> Optional[int]:
    """Resolve the device byte budget: knob > env > the card's probe.

    ``mem_budget`` (the engine knob) wins when set; otherwise the
    ``REPRO_DEVICE_MEM_BUDGET`` environment variable; otherwise
    ``probe_device_budget(device)``. None means unconstrained.
    """
    if mem_budget is not None:
        return parse_budget(mem_budget)
    env = os.environ.get(ENV_BUDGET, "").strip()
    if env:
        return parse_budget(env)
    return probe_device_budget(device)


# ---------------------------------------------------------------- planner

@dataclasses.dataclass(frozen=True)
class MemSpec:
    """The size inputs of the byte model: everything known before upload."""
    n: int              # vertices
    adj_pins: int       # vertex-adjacency indices (expanded neighbour pairs)
    k: int              # stacked phases G of one superstep
    rows: int           # fresh candidate rows per phase (R)
    pool_cap: int       # held pool slots per phase (P)
    t: int              # admissions per phase per superstep
    tile_l: int         # default gather width (L bucket)
    pipeline_depth: int


@dataclasses.dataclass(frozen=True)
class MemPlan:
    """One rung of the ladder, with its planned peak byte count."""
    rung: int
    tile_l: int
    g_chunk: int            # phases scored in g_chunk sequential slices
    pipeline_depth: int
    spill_cache: bool       # score cache lives on host (float32 mirror)
    paged: bool             # CSR paged on demand instead of resident
    page_bytes: int         # resident-page budget when paged
    planned_bytes: int
    fits: bool              # planned_bytes <= budget (best effort if not)


def device_ptr_nbytes(adj_pins: int) -> int:
    """Bytes per indptr entry of the device CSR image: int32 while the
    indices are addressable with 31 bits, int64 beyond
    (``Hypergraph.device_adjacency``)."""
    return 4 if adj_pins < 2 ** 31 else 8


def narrow_len_dtype(max_len: int):
    """Narrowest safe numpy int dtype for per-chunk row lengths."""
    return np.int16 if max_len < 2 ** 15 else np.int32


def estimate_plan_bytes(spec: MemSpec, *, tile_l: Optional[int] = None,
                        g_chunk: int = 1,
                        pipeline_depth: Optional[int] = None,
                        spill_cache: bool = False, paged: bool = False,
                        page_bytes: int = 0) -> int:
    """Planned peak device bytes of one superstep-engine configuration.

    A pure function, monotone non-decreasing in every size input. The
    model counts the CSR image (indptr + indices), or the resident-page
    budget plus the assembled full-width gather tile when ``paged``; the
    mutable image (assignment, score cache unless ``spill_cache``,
    per-phase totals, poison flag); and the per-superstep transients
    (the (G/g_chunk * rows, tile_l) gather tile, the kernel's score and
    select outputs, the host-built id buffers) times ``pipeline_depth``.
    """
    tile_l = spec.tile_l if tile_l is None else tile_l
    depth = (spec.pipeline_depth if pipeline_depth is None
             else pipeline_depth)
    n, k = spec.n, spec.k
    g, r, p, t = spec.k, spec.rows, spec.pool_cap, spec.t

    if paged:
        csr = page_bytes + (n + 1) * 8 // 64    # host indptr slices only
    else:
        csr = (n + 1) * device_ptr_nbytes(spec.adj_pins) \
            + spec.adj_pins * 4
    image = n * 4                               # assignment
    if not spill_cache:
        image += n * 4                          # score cache
    image += k * 4 + 4                          # acc + poison

    chunk_rows = -(-g // g_chunk) * r
    gather = chunk_rows * tile_l * 4            # the dominant transient
    if paged:
        gather = g * r * tile_l * 4             # full assembled tile
    kernel = g * r * 4 + g * (r + p) * 8        # scores + select scratch
    hostbuf = g * (2 * r + p + t + 2) * 4       # fresh/bias/pool/targets
    transient = gather + kernel + hostbuf
    return csr + image + max(1, depth) * transient


def rung_ladder(spec: MemSpec,
                features: Sequence[str] = SUPERSTEP_FEATURES,
                budget: Optional[int] = None) -> Tuple[MemPlan, ...]:
    """The deterministic rung ladder for ``spec``.

    Rungs are cumulative: each keeps the previous rung's reductions and
    sheds one more thing. A rung is skipped when the engine lacks its
    feature or it would change nothing (``tile_l`` already at the
    smallest bucket). ``budget`` only sizes the paged rung's resident-page
    allowance; the fit decision lives in ``plan_memory``.
    """
    cfgs = [dict(tile_l=spec.tile_l, g_chunk=1,
                 pipeline_depth=spec.pipeline_depth, spill_cache=False,
                 paged=False, page_bytes=0)]

    def push(**kw):
        cfg = dict(cfgs[-1])
        cfg.update(kw)
        cfgs.append(cfg)

    if "chunk" in features and spec.k > 1:
        push(g_chunk=2)
    if "tile_l" in features:
        buckets = [b for b in scoring.L_BUCKETS if b < spec.tile_l]
        if buckets:
            push(tile_l=buckets[-1])             # one bucket down
    if "depth" in features and spec.pipeline_depth > 1:
        push(pipeline_depth=1)
    if "spill" in features:
        # the spill program scores the full phase stack (it has no
        # chunked variant), so its config says so
        push(pipeline_depth=1, spill_cache=True, g_chunk=1)
    if "paged" in features:
        base = cfgs[-1]
        fixed = estimate_plan_bytes(
            spec, tile_l=base["tile_l"], g_chunk=1,
            pipeline_depth=1, spill_cache=False, paged=True,
            page_bytes=0)
        page_bytes = _MIN_PAGE_BYTES * 2
        if budget is not None and budget > fixed:
            page_bytes = max(page_bytes, budget - fixed)
        push(pipeline_depth=1, spill_cache=False, paged=True,
             g_chunk=1, page_bytes=int(page_bytes))

    plans = []
    for rung, cfg in enumerate(cfgs):
        bytes_ = estimate_plan_bytes(spec, **cfg)
        plans.append(MemPlan(rung=rung, planned_bytes=bytes_,
                             fits=(budget is None or bytes_ <= budget),
                             **cfg))
    return tuple(plans)


def plan_memory(spec: MemSpec, budget: Optional[int],
                features: Sequence[str] = SUPERSTEP_FEATURES,
                rung_start: int = 0) -> MemPlan:
    """Pick the largest plan (lowest rung from ``rung_start``) that fits.

    With ``budget=None`` rung ``rung_start`` is chosen directly (rung 0
    is the engine's default plan). When no rung fits, the *last* rung is
    returned with ``fits=False`` (best effort; a real allocator failure
    then walks on as ``DeviceOOM``). ``rung_start`` past the end raises
    ``MemoryLadderExhausted``.
    """
    plans = rung_ladder(spec, features, budget)
    if rung_start >= len(plans):
        raise MemoryLadderExhausted(
            f"all {len(plans)} memory rungs exhausted "
            f"(budget={budget}, spec={spec})")
    for plan in plans[rung_start:]:
        if plan.fits:
            return plan
    return plans[-1]


# ------------------------------------------------------- streaming planner

@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """Size inputs of the streaming engine's byte model."""
    n: int              # vertices
    k: int              # partitions
    micro_batch: int    # vertices per device call
    sketch_bits: int    # sketch table is (k, 2**sketch_bits) int32
    s: int              # fringe slots per partition
    tile_l: int         # neighbour-tile gather width (L bucket)


def estimate_stream_bytes(spec: StreamSpec, *,
                          micro_batch: Optional[int] = None,
                          tile_l: Optional[int] = None) -> int:
    """Planned peak device bytes of one streaming micro-batch step.

    Pure and monotone non-decreasing in every size input: the resident
    sketch + sizes image, the per-batch edge and neighbour tiles, the
    kernel's (k, mb, L) broadcast of the neighbour tile (the dominant
    transient) and the small fringe, score and output buffers.
    """
    mb = spec.micro_batch if micro_batch is None else micro_batch
    tl = spec.tile_l if tile_l is None else tile_l
    k, s = spec.k, spec.s
    image = k * (1 << spec.sketch_bits) * 4 + k * 4     # sketch + sizes
    tiles = 2 * mb * tl * 4                             # edge + nbr tile
    kernel = k * mb * tl * 4 + k * mb * 4 + k * s * 4   # broadcast+scores
    out = mb * 4                                        # chosen parts
    return image + tiles + kernel + out


def plan_stream_memory(spec: StreamSpec,
                       budget: Optional[int]) -> Tuple[int, int, int, bool]:
    """Pick the streaming rung: halve ``micro_batch``, then drop ``tile_l``.

    Returns ``(micro_batch, tile_l, planned_bytes, fits)``. The caller's
    own plan is returned untouched when the budget is None or already
    met; then the micro-batch halves down to 1, then ``tile_l`` walks
    down ``L_BUCKETS``; an exhausted ladder returns the smallest
    configuration with ``fits=False``.
    """
    mb, tl = spec.micro_batch, spec.tile_l
    planned = estimate_stream_bytes(spec)
    if budget is None or planned <= budget:
        return mb, tl, planned, True
    while mb > 1:
        mb = max(1, mb // 2)
        planned = estimate_stream_bytes(spec, micro_batch=mb)
        if planned <= budget:
            return mb, tl, planned, True
    while True:
        lower = [b for b in scoring.L_BUCKETS if b < tl]
        if not lower:
            break
        tl = lower[-1]
        planned = estimate_stream_bytes(spec, micro_batch=mb, tile_l=tl)
        if planned <= budget:
            return mb, tl, planned, True
    return mb, tl, planned, False


# ----------------------------------------------------------- paged image

_MIN_PAGE_BYTES = 1 << 18       # floor so at least two chunks stay resident


def _page_gather(out, rstart, rlen, idx, ids, lo: int):
    """Fill the rows of ``out`` whose ids fall in one resident chunk.

    ``ids`` (B,) int32 device ids (-1 pad); the chunk holds rows
    ``[lo, lo + rlen.shape[0])`` as ``(row_start int32, row_len int16 or
    int32, indices int32)``. Each row of the chunk gets its first
    ``out.shape[1]`` neighbours, -1 past its degree; other rows keep
    ``out``'s values. No host sync.
    """
    rows = rlen.shape[0]
    local = ids - lo
    in_chunk = (local >= 0) & (local < rows) & (ids >= 0)
    lsafe = torch.where(in_chunk, local, 0).long()
    start = rstart[lsafe]
    deg = rlen[lsafe].to(torch.int32)       # widen before any arithmetic
    col = torch.arange(out.shape[1], dtype=torch.int32, device=out.device)
    valid = (col < deg[:, None]) & in_chunk[:, None]
    nbr = idx[torch.where(valid, start[:, None] + col, 0).long()]
    return torch.where(valid, nbr, out)


class PagedAdjacency:
    """LRU-paged device copy of the vertex-adjacency CSR.

    The CSR is split into chunks of ``chunk_rows`` vertices; a chunk's
    device image is ``(row_start int32, row_len int16 when the degrees
    allow, indices int32)``, padded to a common shape. ``gather``
    assembles the raw (B, tile_l) neighbour-id tile of a candidate batch
    on ``device``, uploading absent chunks and evicting the least
    recently used ones to stay under ``page_bytes``. Uploads go from
    pinned host memory on the current stream, so a chunk evicted while a
    queued gather still reads it is safe: the allocator reuses its
    memory only after that stream's earlier work.

    The counters ``page_uploads``, ``page_hits``, ``page_evictions`` and
    ``page_bytes`` are host logic, accumulated on ``stats`` when given
    (a ``BatchedStats``), exactly as the JAX package counts them.
    """

    def __init__(self, adj, page_bytes: int, stats=None, device="cpu"):
        indptr, indices = adj
        self.indptr = indptr
        self.indices = indices
        self.device = torch.device(device)
        self.n = int(indptr.shape[0]) - 1
        self.page_bytes = max(int(page_bytes), 2 * _MIN_PAGE_BYTES)
        self.stats = stats
        deg = np.diff(indptr)
        self.max_deg = int(deg.max()) if deg.size else 0
        self.len_dtype = narrow_len_dtype(self.max_deg)
        # fixed row count per chunk, sized so an average chunk costs about
        # 1/16 of the page budget: fine-grained chunks make the resident
        # hit ratio track page_bytes / csr_bytes smoothly, while the floor
        # keeps the per-chunk launch overhead bounded
        mean_deg = indices.size / max(self.n, 1)
        target = max(self.page_bytes // 16, _MIN_PAGE_BYTES)
        per_row = 4 * mean_deg + 4 + self.len_dtype().itemsize
        self.chunk_rows = int(max(1, min(self.n, target // max(per_row, 1))))
        self.n_chunks = -(-self.n // self.chunk_rows)
        bounds = np.minimum(
            np.arange(self.n_chunks + 1, dtype=np.int64) * self.chunk_rows,
            self.n)
        self.chunk_pins = int(
            (indptr[bounds[1:]] - indptr[bounds[:-1]]).max()
        ) if self.n_chunks else 0
        self._resident: "collections.OrderedDict[int, tuple]" = \
            collections.OrderedDict()
        self._resident_bytes = 0
        self._sweep = 0

    def chunk_of(self, ids: np.ndarray) -> np.ndarray:
        return ids // self.chunk_rows

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _upload(self, c: int):
        lo = c * self.chunk_rows
        hi = min(lo + self.chunk_rows, self.n)
        base = int(self.indptr[lo])
        rstart = np.zeros(self.chunk_rows, dtype=np.int32)
        rlen = np.zeros(self.chunk_rows, dtype=self.len_dtype)
        rstart[:hi - lo] = (self.indptr[lo:hi] - base).astype(np.int32)
        rlen[:hi - lo] = (self.indptr[lo + 1:hi + 1]
                          - self.indptr[lo:hi]).astype(self.len_dtype)
        idx = np.zeros(self.chunk_pins, dtype=np.int32)
        pins = int(self.indptr[hi]) - base
        idx[:pins] = self.indices[base:base + pins]
        nbytes = rstart.nbytes + rlen.nbytes + idx.nbytes
        # an empty chunk still needs one element for the masked gather
        dev_idx = idx if idx.size else np.zeros(1, dtype=np.int32)
        entry = (self._to_device(rstart), self._to_device(rlen),
                 self._to_device(dev_idx), lo, nbytes)
        self._resident[c] = entry
        self._resident_bytes += nbytes
        if self.stats is not None:
            self.stats.page_uploads += 1
            self.stats.page_bytes += nbytes
        while (self._resident_bytes > self.page_bytes
               and len(self._resident) > 1):
            _, old = self._resident.popitem(last=False)
            self._resident_bytes -= old[4]
            if self.stats is not None:
                self.stats.page_evictions += 1
        return entry

    def gather(self, flat_ids: np.ndarray, tile_l: int) -> torch.Tensor:
        """Raw (B, tile_l) int32 neighbour-id tile for ``flat_ids``.

        Rows of pad ids (< 0) stay all -1; real rows hold their first
        ``tile_l`` CSR neighbours, -1 padded: the rows the resident
        gather reads before it masks assigned neighbours, so the paged
        program's own masking reproduces the resident path bit for bit.
        """
        flat_ids = np.asarray(flat_ids, dtype=np.int32)
        out = torch.full((flat_ids.shape[0], tile_l), -1, dtype=torch.int32,
                         device=self.device)
        real = flat_ids[flat_ids >= 0]
        if real.size == 0:
            return out
        ids_dev = self._to_device(flat_ids)
        # Alternate the chunk visit direction per call: each chunk writes
        # a disjoint row set of `out`, so order is free, and a zigzag
        # turns the repeated full-range sweep (LRU's worst case: no hits
        # whenever capacity < total) into one that re-enters where the
        # last one ended, keeping ~capacity/total of the chunks hot.
        chunks = np.unique(self.chunk_of(real.astype(np.int64)))
        if self._sweep & 1:
            chunks = chunks[::-1]
        self._sweep += 1
        for c in chunks:
            c = int(c)
            entry = self._resident.get(c)
            if entry is None:
                entry = self._upload(c)
            else:
                self._resident.move_to_end(c)
                if self.stats is not None:
                    self.stats.page_hits += 1
            rstart, rlen, idx, lo, _ = entry
            out = _page_gather(out, rstart, rlen, idx, ids_dev, lo)
        return out

    @property
    def resident_bytes(self) -> int:
        return self._resident_bytes
