"""The port's copy of the ``jax.random`` pieces the padded-array engines draw.

``hype_jax`` and ``hype_parallel`` (``core/hype_jax.py``) draw their
seed vertices, restarts and rescues from ``jax.random`` in the JAX
package. Torch's generators give other streams, so the port carries the
Threefry-2x32 counter hash over and reproduces the JAX draws bit for bit:

  * ``prng_key(seed)``: the raw key ``(0, seed & 0xFFFFFFFF)`` of an
    int32 seed (``jax.random.PRNGKey``);
  * ``split(key)``: the fold-like split, threefry of the 64-bit counters
    0 and 1, giving ``(key, sub)``;
  * ``random_bits(key, n)``: 32 random bits per element, ``bits1 ^
    bits2`` of threefry over the counters ``(hi, lo) = (0, iota)``;
  * ``uniform(key, n, minval, maxval)``: float32 in ``[minval, maxval)``
    from the top 23 bits;
  * ``permutation(key, n)``: repeated stable sorts on fresh 32-bit keys,
    ``ceil(3 ln n / ln(2**32 - 1))`` rounds;
  * ``choice_without_replacement(key, n, size)``: the permutation's
    first ``size`` ids.

Only the partitionable variant (``jax_threefry_partitionable=True``, the
default of the JAX release the reference runs on) is carried over. A key
is a pair of Python ints: the key chain depends on the seed alone, never
on device data, so a split is 20 rounds of host integer arithmetic, and
a draw hashes an iota on the device with the key as scalars, with no
host round trip either way. Every uint32 lane is held in int64 and
masked with ``0xFFFFFFFF`` after each add and shift.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_UINT32_MAX = np.uint32(0xFFFFFFFF)


def threefry2x32(k1: int, k2: int, x0, x1):
    """Threefry-2x32 with 20 rounds: the key ``(k1, k2)`` hashes the
    counter pairs ``(x0, x1)`` (ints, or int64 tensors of uint32 lanes);
    returns the two output lanes."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for rot in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = (((x1 << rot) | (x1 >> (32 - rot))) & _MASK) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


Key = Tuple[int, int]


def prng_key(seed: int) -> Key:
    """The raw key of an int32 seed: ``(0, seed & 0xFFFFFFFF)``."""
    return (0, int(seed) & _MASK)


def split(key: Key) -> Tuple[Key, Key]:
    """``jax.random.split(key)``: returns ``(key, sub)``, the hashes of
    the 64-bit counters 0 and 1."""
    return threefry2x32(*key, 0, 0), threefry2x32(*key, 0, 1)


def random_bits(key: Key, n: int, device=None) -> torch.Tensor:
    """(n,) int64 on ``device`` holding 32 random bits each."""
    lo = torch.arange(n, dtype=torch.int64, device=device)
    bits1, bits2 = threefry2x32(*key, torch.zeros_like(lo), lo)
    return bits1 ^ bits2


def uniform(key: Key, n: int, minval: float = 0.0, maxval: float = 1.0,
            device=None) -> torch.Tensor:
    """(n,) float32 uniform in ``[minval, maxval)``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    fbits = (random_bits(key, n, device) >> 9) | 0x3F800000
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    out = floats * float(hi - lo) + float(lo)
    return torch.clamp_min(out, float(lo))


def permutation(key: Key, n: int, device=None) -> torch.Tensor:
    """(n,) int64: a random permutation of ``range(n)``."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(_UINT32_MAX)))
    x = torch.arange(n, dtype=torch.int64, device=device)
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.argsort(random_bits(sub, n, device), stable=True)
        x = x[order]
    return x


def choice_without_replacement(key: Key, n: int, size: int,
                               device=None) -> torch.Tensor:
    """``jax.random.choice(key, n, (size,), replace=False)``: (size,)
    int64 distinct ids of ``range(n)``."""
    if size == 0:
        return torch.zeros(0, dtype=torch.int64, device=device)
    if n <= 0:
        raise ValueError(
            "a must be greater than 0 unless no samples are taken")
    if size > n:
        raise ValueError(
            f"Cannot take a larger sample (size {size}) than population "
            f"(size {n}) when 'replace=False'")
    return permutation(key, n, device)[:size]
