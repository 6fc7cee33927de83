"""The port's threefry (``repro_torch.core.threefry``) against
``jax.random``, bit for bit, on the CPU.

The key of a seed, ``split``, 32-bit random bits, ``uniform`` at the
engines' ``minval=0.5, maxval=1.0``, ``permutation`` and ``choice(...,
replace=False)`` over several seeds, with n on both sides of the
one-round/two-round boundary of the shuffle (n <= 1,625 sorts once).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro_torch.core import threefry

SEEDS = [0, 9, 123, -5, 2**31 - 1]
SIZES = [1, 7, 300, 1625, 1626, 5000]


def _keys(seed):
    """JAX's key of ``seed`` split once, and the port's."""
    return jax.random.split(jax.random.PRNGKey(seed)), threefry.split(
        threefry.prng_key(seed))


def test_partitionable_threefry_is_jax_default():
    """The port carries the partitionable variant only; a JAX release
    that changes the default shows here, not as a digest mismatch."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_equal_jax(seed):
    jkey, key = jax.random.PRNGKey(seed), threefry.prng_key(seed)
    assert key == tuple(np.asarray(jkey).tolist())
    for _ in range(3):      # split of a split of a split
        jkey, jsub = jax.random.split(jkey)
        key, sub = threefry.split(key)
        assert key == tuple(np.asarray(jkey).tolist())
        assert sub == tuple(np.asarray(jsub).tolist())


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_random_bits_and_uniform_equal_jax(seed, n):
    (_, jsub), (_, sub) = _keys(seed)
    want = np.asarray(jax.random.bits(jsub, (n,), jnp.uint32), np.int64)
    np.testing.assert_array_equal(threefry.random_bits(sub, n).numpy(),
                                  want)
    ju = np.asarray(jax.random.uniform(jsub, (n,), minval=0.5,
                                       maxval=1.0))
    u = threefry.uniform(sub, n, 0.5, 1.0).numpy()
    assert u.dtype == np.float32
    np.testing.assert_array_equal(u.view(np.int32), ju.view(np.int32))
    assert u.min() >= 0.5 and u.max() < 1.0


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_permutation_and_choice_equal_jax(seed, n):
    (_, jsub), (_, sub) = _keys(seed)
    np.testing.assert_array_equal(
        threefry.permutation(sub, n).numpy(),
        np.asarray(jax.random.permutation(jsub, n)))
    size = min(n, 16)
    np.testing.assert_array_equal(
        threefry.choice_without_replacement(sub, n, size).numpy(),
        np.asarray(jax.random.choice(jsub, n, shape=(size,),
                                     replace=False)))


@pytest.mark.parametrize("n,rounds", [(1625, 1), (1626, 2)])
def test_shuffle_rounds(n, rounds):
    """Each round splits the key and stably sorts on fresh 32-bit keys."""
    key = threefry.prng_key(4)
    x = np.arange(n)
    for _ in range(rounds):
        key, sub = threefry.split(key)
        x = x[np.argsort(threefry.random_bits(sub, n).numpy(),
                         kind="stable")]
    np.testing.assert_array_equal(
        threefry.permutation(threefry.prng_key(4), n).numpy(), x)


def test_choice_raises_as_jax():
    key, jkey = threefry.prng_key(0), jax.random.PRNGKey(0)
    with pytest.raises(ValueError, match="larger sample"):
        jax.random.choice(jkey, 6, shape=(7,), replace=False)
    with pytest.raises(ValueError, match="larger sample"):
        threefry.choice_without_replacement(key, 6, 7)
    assert threefry.choice_without_replacement(key, 6, 0).numel() == 0
