"""The port's scoring kernels against the JAX package's kernels.

On the CPU the port's ``ops.hype_score_select`` runs its plain version
(``ref.py``); the JAX kernel runs in Pallas interpret mode. Every output
must agree bit for bit: scores and selected values as float32 bit
patterns, selected indices and the per-phase remaining count exactly.
The Pallas kernel unrolls ``select_k`` rounds, so each new shape costs a
trace; the JAX comparison therefore covers every value of every axis on
nine shapes, and the whole (G, R, L, s, select_k) grid is held against
the JAX package's numpy oracle instead. The plain ``hype_scores`` is
held against the JAX kernel at every L bucket, B in {8, 33, 64, 256}
and s in {1, 10, 16}, with duplicated fringe ids and all-pad rows.
"""
import itertools

import numpy as np
import pytest
import torch

from repro.kernels.hype_score.ops import hype_score_select as jax_select
from repro.kernels.hype_score.ops import hype_scores as jax_scores
from repro.kernels.hype_score.ref import hype_score_select_ref as np_select
from repro_torch.kernels.hype_score.ops import hype_score_select, hype_scores
from repro_torch.kernels.hype_score.ref import SELECT_PAD

P = 64
TRUNC_PENALTY = 1e12
KINDS = ("ties", "allpad", "infpool", "hub")


def make_inputs(G, R, L, s, kind, seed=0):
    """Seeded (nbrs, fringe, bias, prev) numpy inputs of one flavour.

    ``mixed`` carries every flavour at once: tied scores, all-pad rows,
    +inf pool slots and hub-penalty rows.
    """
    rng = np.random.default_rng(seed)
    nbrs = rng.integers(0, 3 * L, size=(G, R, L)).astype(np.int32)
    nbrs[rng.random((G, R, L)) < 0.5] = -1
    # fringe ids drawn from the phase's own rows, so membership matters
    fringe = np.full((G, s), -1, np.int32)
    for g in range(G):
        pick = nbrs[g][nbrs[g] >= 0]
        take = min(max(1, s - 1), pick.size)
        fringe[g, :take] = rng.choice(pick, size=take, replace=False)
    bias = np.zeros((G, R), np.float32)
    prev = rng.integers(0, L, size=(G, P)).astype(np.float32)
    if kind in ("ties", "mixed"):
        nbrs = np.where(rng.random((G, R, L)) < 0.5, 7, -1).astype(np.int32)
        nbrs[:, :, : L // 4] = 3
        nbrs[:, ::2] = np.where(np.arange(L) < L // 2, 5, -1)
        prev[:, ::3] = L // 2
    if kind in ("allpad", "mixed"):
        nbrs[:, 1] = -1                      # all-pad row scoring 0
        nbrs[:, 2] = -1
        bias[:, 2] = np.inf                  # absent row: +inf bias
        if G > 1:
            nbrs[G - 1] = -1
            bias[G - 1] = np.inf
    if kind in ("infpool", "mixed"):
        prev[rng.random((G, P)) < 0.5] = np.inf
        prev[0] = np.inf                     # a phase with no pool at all
    if kind in ("hub", "mixed"):
        bias[rng.random((G, R)) < 0.3] = TRUNC_PENALTY
        prev[:, 1::4] = np.float32(TRUNC_PENALTY)
    return nbrs, fringe, bias, prev


def port(nbrs, fringe, bias, prev, select_k):
    out = hype_score_select(*(torch.from_numpy(a) for a in
                              (nbrs, fringe, bias, prev)),
                            select_k=select_k)
    return [t.numpy() for t in out]


def assert_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == np.float32:
        got, want = got.view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(got, want)


def np_remaining(nbrs, fringe, bias, prev, select_k):
    """The kernel's ``rem`` from the numpy oracle: real slots left."""
    scores, _, vals = np_select(nbrs, fringe, bias, prev, select_k)
    merged = np.minimum(np.concatenate([scores, prev], axis=1),
                        np.float32(SELECT_PAD))
    real = (merged < np.float32(SELECT_PAD)).sum(axis=1)
    return (real - (vals < np.float32(SELECT_PAD)).sum(axis=1)).astype(
        np.int32)


def _jax_shapes():
    """Nine shapes on which every axis value appears at least once."""
    out = []
    for i, (G, ksel) in enumerate(itertools.product((1, 5, 32),
                                                    ("1", "R", "R+P"))):
        R = (8, 16)[i % 2]
        L = (32, 128)[(i // 2) % 2]
        s = (1, 16)[(i // 3) % 2]
        select_k = {"1": 1, "R": R, "R+P": R + P}[ksel]
        out.append((G, R, L, s, select_k))
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("G,R,L,s,select_k", _jax_shapes())
def test_matches_jax_kernel(G, R, L, s, select_k, kind):
    args = make_inputs(G, R, L, s, kind, seed=G * 100 + select_k)
    want = jax_select(*args, select_k=select_k, with_remaining=True)
    got = port(*args, select_k)
    for g, w in zip(got, want):
        assert_bits(g, w)
    for g, w in zip(got, np_select(*args, select_k)):
        assert_bits(g, w)


@pytest.mark.parametrize("ksel", ("1", "R", "R+P"))
@pytest.mark.parametrize("s", (1, 16))
@pytest.mark.parametrize("L", (32, 128))
@pytest.mark.parametrize("R", (8, 16))
@pytest.mark.parametrize("G", (1, 5, 32))
def test_matches_numpy_oracle_grid(G, R, L, s, ksel):
    select_k = {"1": 1, "R": R, "R+P": R + P}[ksel]
    args = make_inputs(G, R, L, s, "mixed", seed=G + R + L + s)
    got = port(*args, select_k)
    for g, w in zip(got[:3], np_select(*args, select_k)):
        assert_bits(g, w)
    assert_bits(got[3], np_remaining(*args, select_k))


def test_nan_phase_matches_jax_and_stays_in_range():
    """A NaN score poisons its phase: every round returns (NaN, R + P) as
    the TPU kernel does; the other phases are untouched."""
    G, R, L, s, select_k = 5, 8, 32, 1, 8
    nbrs, fringe, bias, prev = make_inputs(G, R, L, s, "hub", seed=7)
    bias[2, 3] = np.nan
    want = [np.asarray(w) for w in jax_select(
        nbrs, fringe, bias, prev, select_k=select_k, with_remaining=True)]
    got = port(nbrs, fringe, bias, prev, select_k)
    assert (got[1] >= 0).all() and (got[1] <= R + P).all()
    assert (got[1][2] == R + P).all() and np.isnan(got[2][2]).all()
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])   # NaN == NaN here
    np.testing.assert_array_equal(got[3], want[3])


def test_wrapper_refuses_other_devices():
    args = [torch.empty(shape, dtype=dt, device="meta") for shape, dt in
            (((2, 8, 32), torch.int32), ((2, 1), torch.int32),
             ((2, 8), torch.float32), ((2, P), torch.float32))]
    with pytest.raises(ValueError, match="cpu or cuda"):
        hype_score_select(*args, select_k=4)


# ------------------------------------------------------------ hype_scores


L_BUCKETS = (32, 128, 512, 2048)


def make_score_inputs(B, L, s, seed=0):
    """Seeded (nbrs (B, L), fringe (s,)) int32 inputs for ``hype_scores``.

    Fringe ids are drawn from the tile, so membership matters; with
    s >= 2 the fringe repeats one id and ends in a -1 pad slot. Rows 0
    and B - 1 are all pad, and rows hold -1 gaps mid-row.
    """
    rng = np.random.default_rng(seed)
    nbrs = rng.integers(0, 2 * L, size=(B, L)).astype(np.int32)
    nbrs[rng.random((B, L)) < 0.4] = -1
    nbrs[0] = -1
    nbrs[B - 1] = -1
    pick = nbrs[nbrs >= 0]
    fringe = rng.choice(pick, size=s).astype(np.int32)
    if s >= 2:
        fringe[1] = fringe[0]            # a duplicated fringe id
        fringe[-1] = -1                  # a pad slot
    return nbrs, fringe


@pytest.mark.parametrize("s", (1, 10, 16))
@pytest.mark.parametrize("B", (8, 33, 64, 256))
@pytest.mark.parametrize("L", L_BUCKETS)
def test_hype_scores_matches_jax_kernel(L, B, s):
    nbrs, fringe = make_score_inputs(B, L, s, seed=L + B + s)
    want = np.asarray(jax_scores(nbrs, fringe))
    got = hype_scores(torch.from_numpy(nbrs), torch.from_numpy(fringe))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == 0 and got[B - 1] == 0       # all-pad rows


def test_hype_scores_counts_a_duplicated_fringe_id_once():
    nbrs = np.array([[4, 4, 7, -1], [-1, -1, -1, -1]], np.int32)
    fringe = np.array([4, 4, -1], np.int32)
    got = hype_scores(torch.from_numpy(nbrs), torch.from_numpy(fringe))
    np.testing.assert_array_equal(got.numpy(), [1, 0])
    np.testing.assert_array_equal(np.asarray(jax_scores(nbrs, fringe)),
                                  [1, 0])


def test_hype_scores_refuses_other_devices():
    args = (torch.empty((4, 32), dtype=torch.int32, device="meta"),
            torch.empty(16, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        hype_scores(*args)
