"""The port's EmbeddingBag against the JAX package on the CPU.

On the CPU the port's ``embedding_bag`` runs its plain version
(``kernels/embedding_bag/ref.py``); the JAX kernel runs in Pallas
interpret mode, as ``tests/test_kernels.py`` runs it. Both add the valid
rows of a bag in float32 in slot order, divide once for ``mean`` and
round once to the table's dtype, so the port equals the JAX kernel bit
for bit. The JAX oracle ``embedding_bag_ref`` sums the bag in the
table's dtype, in an order XLA picks; it is held with the tolerance of
``tests/test_kernels.py``'s ``_tol``: 2e-5 for float32, 2e-2 for
bfloat16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag.ops import embedding_bag as jax_bag
from repro.kernels.embedding_bag.ref import embedding_bag_ref as jax_ref
from repro_torch.kernels.embedding_bag import ops
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-5)


def inputs(V, D, B, bag, dtype, seed=0):
    """The table and ids of ``tests/test_kernels.py``'s sweep, on both
    sides: the table is rounded to ``dtype`` once, by JAX, and the port
    gets the same values (a bfloat16 value is exact in float32)."""
    rng = np.random.default_rng(seed)
    jt = jnp.asarray(rng.normal(size=(V, D)), DTYPES[dtype][0])
    ids = rng.integers(-1, V, size=(B, bag)).astype(np.int32)
    tt = torch.from_numpy(np.array(jt, np.float32)).to(DTYPES[dtype][1])
    return jt, tt, ids


def as_f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("V,D,B,bag,combine", [
    (128, 64, 8, 4, "mean"), (1000, 128, 16, 8, "sum"),
    (32, 256, 4, 1, "mean")])
def test_matches_jax_kernel_and_oracle(V, D, B, bag, combine, dtype):
    jt, tt, ids = inputs(V, D, B, bag, dtype)
    got = embedding_bag(tt, torch.from_numpy(ids), combine=combine)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (B, D)
    kernel = jax_bag(jt, jnp.asarray(ids), combine=combine)
    np.testing.assert_array_equal(as_f32(got), as_f32(kernel))
    oracle = jax_ref(jt, jnp.asarray(ids), combine=combine)
    np.testing.assert_allclose(as_f32(got), as_f32(oracle), **_tol(dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", ["all_pad", "bag1", "duplicates", "odd_d",
                                  "wide_bag"])
@pytest.mark.parametrize("combine", ["mean", "sum"])
def test_edge_cases_match_jax_kernel(case, combine, dtype):
    V, D, B, bag = {"all_pad": (16, 32, 6, 4), "bag1": (50, 64, 9, 1),
                    "duplicates": (20, 48, 7, 6), "odd_d": (40, 33, 5, 5),
                    "wide_bag": (64, 16, 3, 40)}[case]
    jt, tt, ids = inputs(V, D, B, bag, dtype, seed=V + D)
    if case == "all_pad":
        ids[::2] = -1                  # every other row is all pad
    elif case == "duplicates":
        ids[:, 1:] = ids[:, :1]        # one id repeated over each bag
        ids[0, 3] = -1
    got = embedding_bag(tt, torch.from_numpy(ids), combine=combine)
    kernel = jax_bag(jt, jnp.asarray(ids), combine=combine)
    np.testing.assert_array_equal(as_f32(got), as_f32(kernel))
    np.testing.assert_allclose(
        as_f32(got), as_f32(jax_ref(jt, jnp.asarray(ids), combine=combine)),
        **_tol(dtype))
    if case == "all_pad":
        assert not got[::2].any()


def test_all_padded_rows_are_zero():
    out = embedding_bag(torch.ones(16, 32), torch.full((2, 4), -1,
                                                       dtype=torch.int32))
    assert torch.equal(out, torch.zeros(2, 32))


@pytest.mark.parametrize("combine,want,running", [
    ("sum", 1.015625, 1.0), ("mean", 0.25390625, 0.25)])
def test_bfloat16_rounds_once_from_float32(combine, want, running):
    """1 + 3 * 2**-8 is exact in float32 but rounds to 1.0 at every step
    of a bfloat16 running sum. The result rounds once, from float32, to
    nearest even: 1.015625 for the sum, 0.25390625 for the mean (not
    1.0 and 0.25)."""
    table = torch.tensor([[1.0], [2.0 ** -8]], dtype=torch.bfloat16)
    ids = torch.tensor([[0, 1, 1, 1]], dtype=torch.int32)
    got = embedding_bag(table, ids, combine=combine).item()
    assert got == want != running


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    def no_build():
        raise AssertionError("a CPU tensor must not build the extension")

    monkeypatch.setattr(ops, "load_extension", no_build)
    _, tt, ids = inputs(64, 16, 5, 3, "float32")
    before = embedding_bag.launches
    got = embedding_bag(tt, torch.from_numpy(ids), combine="sum")
    assert embedding_bag.launches == before
    assert torch.equal(got, embedding_bag_ref(tt, torch.from_numpy(ids),
                                              "sum"))


@pytest.mark.parametrize("table,ids,combine,match", [
    (torch.zeros(4, 8), torch.zeros(2, 3, dtype=torch.int64), "mean",
     "int32"),
    (torch.zeros(4, 8), torch.zeros(6, dtype=torch.int32), "mean", "2-D"),
    (torch.zeros(32), torch.zeros(2, 3, dtype=torch.int32), "mean", "2-D"),
    (torch.zeros(4, 8), torch.zeros(2, 3, dtype=torch.int32), "max",
     "combine"),
    (torch.zeros(4, 8, device="meta"),
     torch.zeros(2, 3, dtype=torch.int32, device="meta"), "mean",
     "cpu or cuda"),
], ids=["int64_ids", "1d_ids", "1d_table", "bad_combine", "meta_device"])
def test_wrapper_rejects_bad_arguments(table, ids, combine, match):
    with pytest.raises(ValueError, match=match):
        embedding_bag(table, ids, combine=combine)
