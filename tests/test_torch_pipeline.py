"""The port's data streams (``repro_torch.data.pipeline``) against the JAX
package's (``repro.data.pipeline``): numpy on both sides, so every batch
is compared bit for bit. Also the cases of tests/test_train_substrate.py
for the token stream and the prefetcher, on the port's classes."""
import itertools
import time

import numpy as np
import pytest

from repro.data import pipeline as jax_pipeline
from repro_torch.data import pipeline


def _equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        assert a[key].shape == b[key].shape, key
        np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("vocab,batch,seq,shard,n_shards,seed", [
    (100, 4, 16, 0, 1, 0), (512, 4, 32, 1, 2, 1), (50_304, 2, 64, 3, 4, 7),
    (151_936, 3, 9, 0, 1, 123), (7, 1, 1, 2, 3, 0)])
@pytest.mark.parametrize("step", [0, 1, 5, 1000])
def test_token_stream_equals_jax(vocab, batch, seq, shard, n_shards, seed,
                                 step):
    got = pipeline.TokenStream(vocab, batch, seq, shard=shard,
                               n_shards=n_shards, seed=seed).batch_at(step)
    want = jax_pipeline.TokenStream(vocab, batch, seq, shard=shard,
                                    n_shards=n_shards,
                                    seed=seed).batch_at(step)
    _equal(got, want)
    assert got["tokens"].dtype == np.int32
    assert got["tokens"].shape == (batch, seq)
    assert int(got["tokens"].max()) < vocab


def test_token_stream_iterates_the_steps_in_order():
    port = pipeline.TokenStream(300, 2, 8, seed=2)
    ref = jax_pipeline.TokenStream(300, 2, 8, seed=2)
    for step, (a, b) in enumerate(itertools.islice(zip(port, ref), 4)):
        _equal(a, b)
        _equal(a, port.batch_at(step))


@pytest.mark.parametrize("uv,iv,batch,n_fields,bag,shard,seed", [
    (1000, 5000, 8, 4, 8, 0, 0), (16_777_216, 16_777_216, 4, 2, 3, 1, 5),
    (10, 20, 1, 1, 1, 2, 9), (300, 700, 16, 6, 4, 0, 31)])
@pytest.mark.parametrize("step", [0, 3, 77])
def test_recsys_stream_equals_jax(uv, iv, batch, n_fields, bag, shard, seed,
                                  step):
    got = pipeline.RecsysStream(uv, iv, batch, n_fields=n_fields, bag=bag,
                                shard=shard, seed=seed).batch_at(step)
    want = jax_pipeline.RecsysStream(uv, iv, batch, n_fields=n_fields,
                                     bag=bag, shard=shard,
                                     seed=seed).batch_at(step)
    _equal(got, want)
    assert got["user_ids"].shape == (batch, n_fields, bag)
    assert int(got["item_ids"].min()) >= -1
    assert got["item_logq"].dtype == np.float32


def test_token_stream_deterministic_and_sharded():
    """tests/test_train_substrate.py's case on the port's stream."""
    a = pipeline.TokenStream(100, 4, 16, shard=0, n_shards=2,
                             seed=1).batch_at(3)
    b = pipeline.TokenStream(100, 4, 16, shard=0, n_shards=2,
                             seed=1).batch_at(3)
    c = pipeline.TokenStream(100, 4, 16, shard=1, n_shards=2,
                             seed=1).batch_at(3)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert a["tokens"].max() < 100
    # labels are the tokens shifted by one
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])


def test_prefetcher_straggler_reserve():
    """tests/test_train_substrate.py's case on the port's prefetcher, with
    a shorter straggler: a late batch re-serves the last one and counts a
    skip."""
    def slow_gen():
        yield {"x": 1}
        time.sleep(0.3)
        yield {"x": 2}

    pf = pipeline.Prefetcher(slow_gen(), depth=1, timeout_s=0.05)
    first = next(pf)
    assert first["x"] == 1
    second = next(pf)           # times out -> re-serves last batch
    assert second["x"] == 1
    assert pf.skipped >= 1
    pf.close()


def test_prefetcher_passes_every_batch_in_order():
    stream = pipeline.TokenStream(64, 2, 4, seed=3)
    pf = pipeline.Prefetcher(iter(stream), depth=2)
    for step in range(5):
        _equal(next(pf), stream.batch_at(step))
    assert pf.skipped == 0
    pf.close()


def test_prefetcher_raises_when_the_first_batch_is_late():
    def never():
        time.sleep(0.3)
        yield {"x": 1}

    pf = pipeline.Prefetcher(never(), depth=1, timeout_s=0.02)
    with pytest.raises(Exception):
        next(pf)
    pf.close()
