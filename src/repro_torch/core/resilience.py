"""Resilience of the partitioning engines: snapshots, fault plans, faults.

A numpy copy of the JAX package's ``src/repro/core/resilience.py``; the
plan syntax, the environment variable (``REPRO_FAULT_PLAN``), the
snapshot store's layout and the failure taxonomy are the same, so one
chaos drill drives both packages alike. Snapshots pickle the port's own
classes: they are not interchangeable with the JAX package's.

  * **Checkpoints**: ``PartitionCheckpoint`` captures an engine's state
    at a superstep (the device engines), chunk (``hype_device``) or
    phase (``hype_batched``) boundary. Snapshots are published with an
    atomic ``.tmp`` + ``os.replace`` rename and a ``LATEST`` pointer
    file, and garbage-collected down to ``keep_last``. Restoring a
    same-engine, same-config snapshot continues the run bit for bit as
    an uninterrupted run with the same cadence; a cross-engine restore
    (the degradation ladder) warm-starts from the snapshot's assignment.

  * **Fault injection**: ``FaultPlan`` injects faults at chosen
    supersteps: ``dispatch`` (an exception at the dispatch site),
    ``nan`` (a NaN-poisoned score tile), ``collective`` (the sharded
    engine's all_gather, not ported) and ``oom`` (a simulated allocation
    failure). Plans come from the ``fault_plan`` engine knob or the
    ``REPRO_FAULT_PLAN`` environment variable
    (``"dispatch@2;nan@4"``); each spec fires at most once per run.

  * **Failure taxonomy**: ``FaultInjected`` marks an injected fault at
    its site; ``UnrecoverableFault`` is what an engine raises when it
    cannot recover inside the run (a fatal injected fault, an exhausted
    retry budget). ``partition_api.partition_resilient`` catches it and
    walks the degradation ladder from the last snapshot. Only injected
    faults are retried or escalated, and real allocator failures, which
    walk the memory rungs (``core/membudget.py``): any other real
    exception of a kernel, a build or a CUDA call propagates as itself.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Optional, Sequence, Tuple

import numpy as np

FAULT_KINDS = ("dispatch", "nan", "collective", "oom")

_SNAP_FMT = "snap_%08d.ckpt"
_LATEST = "LATEST"


class FaultInjected(RuntimeError):
    """An injected fault fired at its site (see ``FaultPlan``)."""

    def __init__(self, kind: str, superstep: int, fatal: bool = False):
        super().__init__(
            f"injected {kind} fault at superstep {superstep}"
            + (" (fatal)" if fatal else ""))
        self.kind = kind
        self.superstep = superstep
        self.fatal = fatal


class UnrecoverableFault(RuntimeError):
    """The engine cannot recover inside this run.

    Raised on a fatal injected fault (``oom:fatal`` included), an
    exhausted retry budget of injected transient faults, or a superstep
    still poisoned after its clean replay. ``partition_resilient``
    catches it and falls back down the engine ladder from the last
    snapshot. A non-fatal ``oom`` (injected, or a real allocator
    failure) raises ``membudget.DeviceOOM`` instead, which the engine's
    memory-rung retry loop answers; only an exhausted rung ladder ends
    as this error.
    """


@dataclasses.dataclass
class FaultSpec:
    kind: str            # one of FAULT_KINDS
    superstep: int = 0   # 1-based dispatch ordinal; 0 for "oom" = any site
    fatal: bool = False  # fatal -> UnrecoverableFault instead of retry


class FaultPlan:
    """A deterministic, one-shot-per-spec fault schedule.

    ``fire(kinds, superstep)`` consumes and returns the first pending
    spec whose kind is in ``kinds`` and whose superstep matches. A bare
    ``"oom"`` spec (superstep 0) matches ANY site that asks for the
    kind — it fires at the first, the device-image upload — while
    ``"oom@N"`` pins the fault to dispatch ordinal ``N`` so allocation
    failures mid-run can be simulated too. ``oom:fatal`` abandons the
    engine for the degradation ladder. A plan object is stateful: pass
    the *same* instance through a degradation ladder so a consumed
    fault does not re-fire after a fallback.
    """

    def __init__(self, specs: Sequence[FaultSpec] = ()):
        self.specs = list(specs)
        self.fired: list = []

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        """Parse ``"kind@superstep[:fatal]"`` specs, ``;``/``,`` joined.

        Examples: ``"dispatch@2"``, ``"nan@4;collective@3"``,
        ``"dispatch@9:fatal"``, ``"oom"`` (fires at image upload).
        """
        specs = []
        for raw in text.replace(",", ";").split(";"):
            part = raw.strip()
            if not part:
                continue
            fatal = False
            if part.endswith(":fatal"):
                fatal = True
                part = part[: -len(":fatal")]
            if "@" in part:
                kind, _, step = part.partition("@")
                try:
                    superstep = int(step)
                except ValueError:
                    raise ValueError(
                        f"bad fault superstep in {raw!r}") from None
            else:
                kind, superstep = part, 0
            kind = kind.strip().lower()
            if kind not in FAULT_KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r} in {raw!r}; "
                    f"choose from {FAULT_KINDS}")
            specs.append(FaultSpec(kind, superstep, fatal))
        return cls(specs)

    @classmethod
    def from_env(cls) -> Optional["FaultPlan"]:
        """Fresh plan from ``REPRO_FAULT_PLAN``, or None when unset.

        Parsed *per engine run* (every ``resolve_fault_plan(None)``
        call), so each run in a chaos suite sees the full plan.
        """
        text = os.environ.get("REPRO_FAULT_PLAN", "").strip()
        return cls.parse(text) if text else None

    def fire(self, kinds: Tuple[str, ...],
             superstep: int) -> Optional[FaultSpec]:
        for sp in self.specs:
            if sp.kind in kinds and (sp.superstep == superstep
                                     or (sp.kind == "oom"
                                         and sp.superstep == 0)):
                self.specs.remove(sp)
                self.fired.append(sp)
                return sp
        return None


def resolve_fault_plan(param) -> Optional[FaultPlan]:
    """Resolve an engine's ``fault_plan`` param to a live plan.

    None -> a fresh plan parsed from ``REPRO_FAULT_PLAN`` (or None);
    str -> parsed; a ``FaultPlan`` instance -> used as-is (shared firing
    state, which is what the degradation ladder wants).
    """
    if param is None:
        return FaultPlan.from_env()
    if isinstance(param, str):
        return FaultPlan.parse(param)
    return param


# --------------------------------------------------------------- checkpoints

@dataclasses.dataclass
class PartitionCheckpoint:
    """One published snapshot of a partition run.

    ``engine`` + ``config`` decide restore semantics: an exact match
    restores the full payload and continues bit-identically; anything
    else (the ladder's cross-engine resume) warm-starts from
    ``payload["assignment"]`` only. ``fingerprint`` pins the hypergraph
    the snapshot belongs to — restoring against a different graph is a
    hard error, not a silent corruption.
    """
    engine: str
    superstep: int          # superstep (device engines) / phase (batched)
    fingerprint: str
    config: dict
    payload: dict


def save_snapshot(dirpath: str, ckpt: PartitionCheckpoint,
                  keep_last: int = 3) -> str:
    """Atomically publish ``ckpt`` under ``dirpath``; returns its path.

    Write to ``.tmp``, fsync, ``os.replace`` (atomic on POSIX), then
    update the ``LATEST`` pointer the same way and GC old snapshots down
    to ``keep_last`` (by modification time — the ladder may interleave
    engines whose step counters are not comparable).
    """
    os.makedirs(dirpath, exist_ok=True)
    name = _SNAP_FMT % ckpt.superstep
    final = os.path.join(dirpath, name)
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(ckpt, f, protocol=4)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    ltmp = os.path.join(dirpath, _LATEST + ".tmp")
    with open(ltmp, "w") as f:
        f.write(name)
    os.replace(ltmp, os.path.join(dirpath, _LATEST))
    _gc(dirpath, keep_last, keep=name)
    return final


def _gc(dirpath: str, keep_last: int, keep: str) -> None:
    snaps = [f for f in os.listdir(dirpath)
             if f.startswith("snap_") and f.endswith(".ckpt")]
    if len(snaps) <= keep_last:
        return
    snaps.sort(key=lambda f: os.path.getmtime(os.path.join(dirpath, f)))
    for f in snaps[:-keep_last]:
        if f != keep:
            try:
                os.remove(os.path.join(dirpath, f))
            except OSError:  # pragma: no cover - concurrent GC race
                pass


def latest_snapshot(dirpath: str) -> Optional[str]:
    """Path of the newest published snapshot in ``dirpath``, or None.

    Prefers the ``LATEST`` pointer (it is what the last atomic publish
    named); falls back to the newest snapshot file by mtime when the
    pointer is missing or dangling.
    """
    if not os.path.isdir(dirpath):
        return None
    ptr = os.path.join(dirpath, _LATEST)
    if os.path.exists(ptr):
        with open(ptr) as f:
            name = f.read().strip()
        path = os.path.join(dirpath, name)
        if os.path.exists(path):
            return path
    snaps = [f for f in os.listdir(dirpath)
             if f.startswith("snap_") and f.endswith(".ckpt")]
    if not snaps:
        return None
    snaps.sort(key=lambda f: os.path.getmtime(os.path.join(dirpath, f)))
    return os.path.join(dirpath, snaps[-1])


def load_snapshot(path: str) -> PartitionCheckpoint:
    with open(path, "rb") as f:
        ckpt = pickle.load(f)
    if not isinstance(ckpt, PartitionCheckpoint):
        raise ValueError(f"{path} is not a PartitionCheckpoint")
    return ckpt


def load_latest(path_or_dir: str) -> Optional[PartitionCheckpoint]:
    """Load a snapshot from a file path OR the newest one in a directory."""
    if os.path.isdir(path_or_dir):
        path = latest_snapshot(path_or_dir)
        return load_snapshot(path) if path else None
    if os.path.exists(path_or_dir):
        return load_snapshot(path_or_dir)
    return None


def check_checkpoint(ckpt: PartitionCheckpoint, hg, k: int) -> None:
    """Refuse a snapshot that does not belong to this (graph, k) run."""
    fp = hg.fingerprint()
    if ckpt.fingerprint != fp:
        raise ValueError(
            f"checkpoint fingerprint {ckpt.fingerprint} does not match "
            f"hypergraph {fp}: refusing to restore against a different "
            f"graph")
    ck = int(ckpt.config.get("k", k))
    if ck != k:
        raise ValueError(
            f"checkpoint was taken at k={ck}, cannot resume a k={k} run")


def warm_assignment(ckpt: PartitionCheckpoint) -> np.ndarray:
    """The snapshot's (possibly partial) assignment for warm starts."""
    return np.asarray(ckpt.payload["assignment"], dtype=np.int32)
