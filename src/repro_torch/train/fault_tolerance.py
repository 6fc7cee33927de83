"""Fault-tolerant training driver, as ``src/repro/train/fault_tolerance.py``.

  * checkpoint every ``ckpt_every`` steps via AsyncCheckpointer (I/O
    overlapped with compute; atomic rename publishing);
  * restore from the newest checkpoint of ``ckpt_dir`` at start;
  * on ANY step failure: restore the last checkpoint and continue --
    ``batch_at(step)`` makes the replay exact (the neighbour-aggregation
    backward sums without float atomics, so a replayed step gives the
    same bits on the card);
  * skip a batch after ``max_retries_per_step`` retries: its metrics are
    ``{"loss": nan, "skipped": True}``, and training goes on. A caller
    that must see every step succeed checks ``failures_recovered`` and
    the ``skipped`` entries of ``metrics_history``;
  * a step whose AdamW update failed after writing moments in place
    (``MomentsConsumed``) is neither replayed nor skipped on the state it
    left: it goes on from the last checkpoint, and raises where there is
    none or where its retries are spent.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Iterator, Optional

from .checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from .optimizer import MomentsConsumed
from .tree import tree_map

log = logging.getLogger("repro_torch.ft")


@dataclasses.dataclass
class FTConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    max_retries_per_step: int = 2
    keep_last: int = 3


@dataclasses.dataclass
class TrainResult:
    steps_done: int
    failures_recovered: int
    metrics_history: list


def run_training(train_step: Callable, state: tuple,
                 batches: Optional[Iterator], n_steps: int, ft: FTConfig, *,
                 batch_at: Optional[Callable] = None,
                 fail_injector: Optional[Callable] = None) -> TrainResult:
    """Drive ``train_step`` for ``n_steps`` with checkpoint/restart.

    state = (params, opt_state[, err]); train_step(*state, batch) returns
    the updated state tuple with the metrics dict appended.
    ``fail_injector(step)`` may raise to simulate a node failure (tests).
    ``batch_at(step)`` enables exact replay after restore; otherwise the
    iterator is consumed forward.
    """
    ckpt = AsyncCheckpointer(ft.ckpt_dir, keep_last=ft.keep_last)
    start = latest_step(ft.ckpt_dir)
    failures = 0
    history = []
    if start is not None:
        state = restore_checkpoint(ft.ckpt_dir, start, state)
        log.info("restored checkpoint at step %d", start)
        step = start
    else:
        step = 0
    base = step  # history[i] is the metrics of step base + i

    while step < n_steps:
        batch = batch_at(step) if batch_at is not None else next(batches)
        retries = 0
        while True:
            try:
                if fail_injector is not None:
                    fail_injector(step)
                out = train_step(*state, batch)
                *new_state, metrics = out
                state = tuple(new_state)
                break
            except Exception as e:  # noqa: BLE001 -- any device/host fault
                failures += 1
                retries += 1
                log.warning("step %d failed (%s); recovering", step, e,
                            exc_info=True)
                restore = latest_step(ft.ckpt_dir)
                if isinstance(e, MomentsConsumed) and (
                        restore is None
                        or retries > ft.max_retries_per_step):
                    ckpt.wait()
                    raise
                if retries > ft.max_retries_per_step:
                    log.error("step %d exceeded retries; skipping batch",
                              step)
                    metrics = {"loss": float("nan"), "skipped": True}
                    break
                if restore is not None:
                    state = restore_checkpoint(ft.ckpt_dir, restore, state)
                    step = restore
                    # Rewind the metrics log with the step counter: the
                    # replayed steps re-append their metrics.
                    del history[max(0, step - base):]
                    batch = batch_at(step) if batch_at is not None \
                        else next(batches)
        history.append(tree_map(
            lambda x: float(x) if hasattr(x, "item") else x, metrics))
        step += 1
        if step % ft.ckpt_every == 0 or step == n_steps:
            ckpt.save(step, state)
    ckpt.wait()
    return TrainResult(steps_done=step, failures_recovered=failures,
                       metrics_history=history)
