"""Host data pipeline: synthetic token/recsys streams with deterministic
shard-aware iteration, prefetch, and straggler-tolerant batching.

A numpy copy of ``src/repro/data/pipeline.py``: given the same arguments
and step, every batch equals the JAX package's bit for bit (numpy's
generator, seeded by ``(seed * 1_000_003 + step) * 65_537 + shard`` for
tokens and ``(seed * 999_983 + step) * 65_537 + shard`` for two-tower
batches). The stream is seeded by (seed, step, shard) so any host can
reproduce any batch: checkpoint/restart needs no data-loader state
besides the integer step.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class TokenStream:
    """Deterministic synthetic LM token stream (shard-aware).

    Produces (tokens, labels) of shape (batch, seq). Tokens follow a
    mixture of Zipf unigrams and local n-gram structure so models can
    actually reduce loss.
    """

    def __init__(self, vocab: int, batch: int, seq: int, *,
                 shard: int = 0, n_shards: int = 1, seed: int = 0):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.shard, self.n_shards, self.seed = shard, n_shards, seed

    def batch_at(self, step: int):
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.shard)
        z = rng.zipf(1.3, size=(self.batch, self.seq + 1))
        toks = (z - 1) % self.vocab
        # inject learnable bigram structure
        mask = rng.random((self.batch, self.seq)) < 0.5
        nxt = (toks[:, :-1] * 31 + 7) % self.vocab
        toks[:, 1:] = np.where(mask, nxt, toks[:, 1:])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class RecsysStream:
    """Synthetic two-tower interaction stream with Zipf item popularity."""

    def __init__(self, user_vocab: int, item_vocab: int, batch: int, *,
                 n_fields: int = 4, bag: int = 8, shard: int = 0, seed: int = 0):
        self.uv, self.iv, self.batch = user_vocab, item_vocab, batch
        self.n_fields, self.bag = n_fields, bag
        self.shard, self.seed = shard, seed

    def batch_at(self, step: int):
        rng = np.random.default_rng(
            (self.seed * 999_983 + step) * 65_537 + self.shard)

        def bags(vocab):
            ids = ((rng.zipf(1.2, size=(self.batch, self.n_fields, self.bag))
                    - 1) % vocab).astype(np.int32)
            drop = rng.random(ids.shape) < 0.3
            return np.where(drop, -1, ids)

        item_ids = bags(self.iv)
        # logQ = log sampling probability of the positive item (approx zipf)
        first = np.maximum(item_ids[:, 0, 0], 1).astype(np.float64)
        logq = (-1.2 * np.log(first)).astype(np.float32)
        return {"user_ids": bags(self.uv), "item_ids": item_ids,
                "item_logq": logq}


class Prefetcher:
    """Background-thread prefetch with a bounded queue and timeout skip.

    ``timeout_s`` models straggler mitigation at the data tier: when a
    batch is late the previous batch is re-served (training prefers a
    duplicate gradient over a stalled step); skipped steps are counted.
    """

    def __init__(self, it: Iterator, depth: int = 4,
                 timeout_s: float | None = None):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._timeout = timeout_s
        self._last = None
        self.skipped = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        for item in self._it:
            if self._stop.is_set():
                return
            self._q.put(item)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            item = self._q.get(timeout=self._timeout) \
                if self._timeout else self._q.get()
            self._last = item
            return item
        except queue.Empty:
            if self._last is None:
                raise
            self.skipped += 1
            return self._last

    def close(self):
        self._stop.set()
