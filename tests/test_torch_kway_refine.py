"""The port's k-way move gains and refinement against the JAX package.

On the CPU the port's ``kway_gains`` and ``kway_gains_csr`` run their
plain versions; the JAX kernel runs in Pallas interpret mode. The
refinement screen (the CSR front end against JAX's gather + kernel
program, over every tile width and rows longer than it), the exact
gains, the admission, the rebalance and whole ``refine_kway`` runs
(device screen and host screen) are held against the JAX package on the
same seeded inputs. Every output is an integer count or an assignment,
so the tolerance is 0.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import refine as jax_refine
from repro.core import scoring as jax_scoring
from repro.data import synthetic as jax_synth
from repro.kernels.kway_refine.ops import kway_gains as jax_gains
from repro_torch.core import refine, scoring
from repro_torch.core.hypergraph import Hypergraph
from repro_torch.data import synthetic
from repro_torch.kernels.kway_refine import ref as kref
from repro_torch.kernels.kway_refine.ops import kway_gains, kway_gains_csr
from repro_torch.kernels.kway_refine.ref import (kway_gains_csr_ref,
                                                 kway_gains_ref)

L_BUCKETS = (32, 128, 512, 2048)


def _pl600(synth):
    return synth.powerlaw_hypergraph(600, 400, seed=11, max_edge=30,
                                     max_degree=20)


def gain_inputs(B, L, k, seed=0):
    """Seeded (parts (B, L), own (B,)) with -1 gaps and pad rows.

    Rows draw their partitions from a few per row, so counts collide;
    rows 1 and B - 1 are pad rows (own = -1, parts all -1).
    """
    rng = np.random.default_rng(seed)
    parts = rng.integers(0, k, size=(B, L)).astype(np.int32)
    hot = rng.integers(0, k, size=(B, 1))
    parts = np.where(rng.random((B, L)) < 0.5, hot, parts).astype(np.int32)
    parts[rng.random((B, L)) < 0.3] = -1
    own = rng.integers(0, k, size=B).astype(np.int32)
    for b in (1, B - 1):
        parts[b] = -1
        own[b] = -1
    return parts, own


@pytest.mark.parametrize("k", (1, 2, 5, 32, 67))
@pytest.mark.parametrize("L", L_BUCKETS)
def test_kway_gains_matches_jax_kernel(L, k):
    parts, own = gain_inputs(40, L, k, seed=L + k)
    want = np.asarray(jax_gains(parts, own, k=k))
    got = kway_gains(torch.from_numpy(parts), torch.from_numpy(own), k=k)
    assert got.dtype == torch.float32 and got.shape == (40, k)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[1] == 0).all() and (got[-1] == 0).all()     # pad rows
    real = own >= 0
    assert (got.numpy()[real, own[real]] == 0).all()        # own column


def test_kway_gains_ref_needs_no_3d_intermediate():
    """A (B, L) tile at the main path's size: the plain version counts
    with one scatter into (B, k + 1), not a (B, k, L) compare."""
    parts, own = gain_inputs(4096, 2048, 32, seed=1)
    got = kway_gains_ref(torch.from_numpy(parts), torch.from_numpy(own), 32)
    b = 7
    cnt = np.bincount(parts[b][parts[b] >= 0], minlength=32)
    np.testing.assert_array_equal(got[b].numpy(),
                                  (cnt - cnt[own[b]]).astype(np.float32))


def test_kway_gains_refuses_other_devices():
    args = (torch.empty((4, 32), dtype=torch.int32, device="meta"),
            torch.empty(4, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        kway_gains(*args, k=4)


# ------------------------------------------------- the device screen

def _screen_inputs(seed=0, k=6, B=64):
    hg = _pl600(synthetic)
    indptr, indices = hg.vertex_adjacency()
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, k, size=hg.n).astype(np.int32)
    delta_ids = np.full(96, -1, np.int32)
    delta_vals = np.zeros(96, np.int32)
    moved = rng.choice(hg.n, size=30, replace=False)
    delta_ids[:30] = moved
    delta_vals[:30] = rng.integers(0, k, size=30)
    cand = np.full(B, -1, np.int32)
    cand[:50] = rng.choice(hg.n, size=50, replace=False)
    cand[:5] = moved[:5]                 # rows that see the delta
    return indptr, indices, assign, delta_ids, delta_vals, cand, k


@pytest.mark.parametrize("tile_l", (32, 128))
def test_refine_gains_device_matches_jax(tile_l):
    indptr, indices, assign, d_ids, d_vals, cand, k = _screen_inputs()
    want_assign, want = jax_scoring.refine_gains_device(
        jnp.asarray(indptr, jnp.int32), jnp.asarray(indices),
        jnp.asarray(assign), jnp.asarray(d_ids), jnp.asarray(d_vals),
        jnp.asarray(cand), tile_l=tile_l, k=k, interpret=True)
    got_assign, got = scoring.refine_gains_device(
        torch.from_numpy(indptr.astype(np.int32)),
        torch.from_numpy(indices),
        torch.from_numpy(np.append(assign, np.int32(-1))),
        torch.from_numpy(d_ids), torch.from_numpy(d_vals),
        torch.from_numpy(cand), tile_l=tile_l, k=k)
    np.testing.assert_array_equal(got_assign.numpy()[:-1],
                                  np.asarray(want_assign))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (np.asarray(want_assign) != assign).any()   # the delta bit


def test_gather_part_tiles_matches_jax():
    indptr, indices, assign, _, _, cand, _ = _screen_inputs(seed=2)
    want = jax_scoring._gather_part_tiles(
        jnp.asarray(indptr, jnp.int32), jnp.asarray(indices),
        jnp.asarray(assign), jnp.asarray(cand), 32)
    got = kref.gather_part_tiles(
        torch.from_numpy(indptr.astype(np.int32)),
        torch.from_numpy(indices), torch.from_numpy(assign),
        torch.from_numpy(cand), 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------- the screen's CSR front end

def csr_screen_inputs(k, seed=7):
    """A seeded CSR screen with every row shape the kernel splits.

    Degrees are mostly short, with rows of 200-700 and of 2,100-2,600
    neighbours (longer than every tile width, so the tile cut shows) and
    vertices with none. The assignment puts a few vertices at -1 and at
    k + 1 (parts that count for no column) and has its scratch slot. The
    64 candidates hold the long rows, a vertex with no neighbours, moved
    vertices and -1 pads in the middle and at the end. Returns numpy
    ``(indptr int64, indices, assign (n + 1,), delta_ids, delta_vals,
    cand)``.
    """
    rng = np.random.default_rng(seed)
    n = 3000
    deg = rng.integers(0, 20, size=n)
    long_rows = rng.choice(n, size=25, replace=False)
    deg[long_rows[:5]] = rng.integers(2100, 2600, size=5)
    deg[long_rows[5:]] = rng.integers(200, 700, size=20)
    empty = np.flatnonzero(deg == 0)[:3]
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum(deg)
    indices = rng.integers(0, n, size=int(indptr[-1])).astype(np.int32)
    assign = rng.integers(0, k, size=n + 1).astype(np.int32)
    odd = rng.choice(n, size=40, replace=False)
    assign[odd[:20]] = -1
    assign[odd[20:]] = k + 1
    assign[n] = -1                               # the scratch slot
    delta_ids = np.full(96, -1, np.int32)
    delta_vals = np.zeros(96, np.int32)
    moved = rng.choice(n, size=30, replace=False)
    delta_ids[:30] = moved
    delta_vals[:30] = rng.integers(0, k, size=30)
    cand = np.full(64, -1, np.int32)
    cand[:50] = rng.choice(n, size=50, replace=False)
    cand[:5] = long_rows[:5]
    cand[5:10] = long_rows[5:10]
    cand[10:13] = empty
    cand[13:18] = moved[:5]                     # rows that see the delta
    cand[20] = -1                               # a pad among real rows
    return indptr, indices, assign, delta_ids, delta_vals, cand


@functools.lru_cache(maxsize=None)
def _jax_screen(tile_l, k):
    indptr, indices, assign, d_ids, d_vals, cand = csr_screen_inputs(k)
    want_assign, want = jax_scoring.refine_gains_device(
        jnp.asarray(indptr, jnp.int32), jnp.asarray(indices),
        jnp.asarray(assign[:-1]), jnp.asarray(d_ids), jnp.asarray(d_vals),
        jnp.asarray(cand), tile_l=tile_l, k=k, interpret=True)
    return np.asarray(want_assign), np.asarray(want)


def _torch_screen(k, ptr_dtype):
    indptr, indices, assign, d_ids, d_vals, cand = csr_screen_inputs(k)
    return (torch.from_numpy(indptr).to(ptr_dtype),
            torch.from_numpy(indices), torch.from_numpy(assign),
            torch.from_numpy(d_ids), torch.from_numpy(d_vals),
            torch.from_numpy(cand))


SCREEN_CASES = [pytest.param(tile_l, k, ptr, id=f"L{tile_l}-k{k}-{name}")
                for tile_l in L_BUCKETS for k in (1, 2, 32, 67)
                for name, ptr in (("int32", torch.int32),
                                  ("int64", torch.int64))]


@pytest.mark.parametrize("tile_l,k,ptr_dtype", SCREEN_CASES)
def test_kway_gains_csr_ref_matches_jax_screen(tile_l, k, ptr_dtype):
    """The plain CSR front end on the assignment after JAX's delta: JAX's
    screen gains, and the tile route (gather + ``kway_gains_ref``), bit
    for bit."""
    want_assign, want = _jax_screen(tile_l, k)
    indptr, indices, _, _, _, cand = _torch_screen(k, ptr_dtype)
    assign = torch.from_numpy(np.append(want_assign, np.int32(-1)))
    got = kway_gains_csr_ref(indptr, indices, assign, cand, tile_l, k)
    assert got.dtype == torch.float32 and got.shape == (cand.shape[0], k)
    np.testing.assert_array_equal(got.numpy(), want)
    own = torch.where(cand >= 0, assign[cand.clamp(min=0).long()], -1)
    tile = kref.gather_part_tiles(indptr, indices, assign, cand, tile_l)
    assert torch.equal(kway_gains_ref(tile, own, k), got)
    # the cut shows (rows past tile_l), pads and empty rows are zero
    deg = (indptr[1:] - indptr[:-1])[cand[:5].long()]
    assert (deg > tile_l).all()
    assert (got[cand < 0] == 0).all() and (got[10:13] == 0).all()
    assert torch.equal(kway_gains_csr(indptr, indices, assign, cand,
                                      tile_l=tile_l, k=k), got)


@pytest.mark.parametrize("tile_l,k,ptr_dtype", SCREEN_CASES)
def test_refine_gains_device_csr_matches_jax(tile_l, k, ptr_dtype,
                                             monkeypatch):
    """``refine_gains_device`` on the CPU: the delta, then one call of the
    CSR front end's plain entry; equal to JAX's program."""
    want_assign, want = _jax_screen(tile_l, k)
    calls = []

    def spy(*args, **kw):
        calls.append(kw)
        return kway_gains_csr(*args, **kw)

    monkeypatch.setattr(scoring, "kway_gains_csr", spy)
    indptr, indices, assign, d_ids, d_vals, cand = _torch_screen(
        k, ptr_dtype)
    got_assign, got = scoring.refine_gains_device(
        indptr, indices, assign, d_ids, d_vals, cand, tile_l=tile_l, k=k)
    # one call, the delta handed to it (one device program on the card)
    assert [(c["tile_l"], c["k"]) for c in calls] == [(tile_l, k)]
    assert calls[0]["delta"][0] is d_ids and calls[0]["delta"][1] is d_vals
    np.testing.assert_array_equal(got_assign.numpy()[:-1], want_assign)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------- the screen's kernel schedule

S_ROWS, S_WARPS, S_PER = 8, 8, 8   # kSRows, kWarps, kSPer (kway_gains.cu)


def screen_schedule(indptr, indices, assign, cand, tile_l, k, delta=None):
    """``kway_screen_kernel`` in numpy, as its blocks and warps share the
    rows (numpy inputs; ``assign`` (n + 1,) is not changed). The delta is
    written first (the kernel reads the assignment only after the delta's
    grid has finished). Block g takes rows g + r G (G = ceil(B / 8)): each
    row's candidate, offsets cut to tile_l, own part; the block's ids as
    one packed list of ceil(total / 32) lane-loads, warp w taking
    [w n / 8, (w + 1) n / 8) in batches of 8, a lane's place p in the
    list placed in the last row whose first place is at or before p; each
    lane adding one to its (row, column) counter (column k for a part
    equal to an own part at or past k, none for a part outside [0, k) and
    not own); then the block's gains, each row once (checked)."""
    assign = assign.copy()
    if delta is not None:
        ids, vals = delta
        assign[np.where(ids >= 0, ids, assign.size - 1)] = vals
    B = cand.size
    G = -(-B // S_ROWS)
    k1 = k + 1
    gains = np.full((B, k), np.nan, np.float32)
    written = np.zeros(B, np.int64)
    lane = np.arange(32)
    for g in range(G):
        start = np.zeros(S_ROWS, np.int64)
        length = np.zeros(S_ROWS, np.int64)
        own = np.full(S_ROWS, -1, np.int64)
        for r in range(S_ROWS):
            b = g + r * G
            if b < B and cand[b] >= 0:
                c = cand[b]
                start[r] = indptr[c]
                length[r] = min(max(indptr[c + 1] - indptr[c], 0), tile_l)
                own[r] = assign[c]
        off = np.concatenate([[0], np.cumsum(length)])
        total = int(off[-1])
        nl = -(-total // 32)
        cnt = np.zeros(S_ROWS * k1, np.int64)
        for w in range(S_WARPS):
            j0, j1 = nl * w // S_WARPS, nl * (w + 1) // S_WARPS
            for jb in range(j0, j1, S_PER):
                for j in range(jb, jb + S_PER):
                    p = j * 32 + lane
                    r = (off[None, 1:S_ROWS] <= p[:, None]).sum(1)
                    live = (j < j1) & (p < total)
                    x = np.where(live, indices[np.where(
                        live, start[r] + p - off[r], 0)], -1)
                    part = np.where(x >= 0, assign[np.maximum(x, 0)], -1)
                    col = np.where((part >= 0) & (part < k), part,
                                   np.where((part >= 0) & (part == own[r]),
                                            k, -1))
                    np.add.at(cnt, (r * k1 + col)[col >= 0], 1)
        cnt = cnt.reshape(S_ROWS, k1)
        for r in range(S_ROWS):
            b = g + r * G
            if b >= B:
                break
            o = own[r]
            oc = 0 if o < 0 else cnt[r, min(o, k)]
            gains[b] = (cnt[r, :k] - oc).astype(np.float32)
            written[b] += 1
    assert (written == 1).all()
    return gains


@pytest.mark.parametrize("k", (1, 2, 32, 48, 65, 67))
@pytest.mark.parametrize("tile_l", (32, 2048))
@pytest.mark.parametrize("ptr_dtype", (torch.int32, torch.int64),
                         ids=("int32", "int64"))
def test_screen_schedule_matches_jax_and_plain_version(ptr_dtype, tile_l,
                                                       k):
    """The emulated screen, its delta included (some of whose ids are
    candidates), equals JAX's program and the plain CSR front end after
    the same delta, with pads among the candidates and rows past the
    cut; ``kway_gains_csr`` given the delta on the CPU writes it and
    gives the same gains."""
    want_assign, want = _jax_screen(tile_l, k)
    indptr, indices, assign, d_ids, d_vals, cand = csr_screen_inputs(k)
    assert np.isin(cand, d_ids[d_ids >= 0]).sum() >= 5
    got = screen_schedule(indptr.astype(ptr_dtype_np(ptr_dtype)), indices,
                          assign, cand, tile_l, k, (d_ids, d_vals))
    np.testing.assert_array_equal(got, want)
    t_indptr, t_indices, t_assign, t_ids, t_vals, t_cand = _torch_screen(
        k, ptr_dtype)
    dev = kway_gains_csr(t_indptr, t_indices, t_assign, t_cand,
                         tile_l=tile_l, k=k, delta=(t_ids, t_vals))
    np.testing.assert_array_equal(dev.numpy(), got)
    np.testing.assert_array_equal(t_assign.numpy()[:-1], want_assign)
    assert torch.equal(kway_gains_csr_ref(t_indptr, t_indices, t_assign,
                                          t_cand, tile_l, k), dev)


def ptr_dtype_np(dtype):
    return np.int32 if dtype == torch.int32 else np.int64


@pytest.mark.parametrize("tile_l,k", ((128, 32), (2048, 65)))
def test_screen_schedule_all_pad_delta(tile_l, k):
    """A delta of pads only changes no vertex (the scratch slot takes the
    pads); the gains are those of the assignment as it was, as JAX's
    program gives them."""
    indptr, indices, assign, d_ids, _, cand = csr_screen_inputs(k, seed=9)
    pad_ids = np.full_like(d_ids, -1)
    pad_vals = np.arange(d_ids.size, dtype=np.int32) % k
    want_assign, want = jax_scoring.refine_gains_device(
        jnp.asarray(indptr, jnp.int32), jnp.asarray(indices),
        jnp.asarray(assign[:-1]), jnp.asarray(pad_ids),
        jnp.asarray(pad_vals), jnp.asarray(cand), tile_l=tile_l, k=k,
        interpret=True)
    np.testing.assert_array_equal(np.asarray(want_assign), assign[:-1])
    got = screen_schedule(indptr, indices, assign, cand, tile_l, k,
                          (pad_ids, pad_vals))
    np.testing.assert_array_equal(got, np.asarray(want))
    t_assign = torch.from_numpy(assign.copy())
    dev = kway_gains_csr(torch.from_numpy(indptr), torch.from_numpy(indices),
                         t_assign, torch.from_numpy(cand), tile_l=tile_l,
                         k=k, delta=(torch.from_numpy(pad_ids),
                                     torch.from_numpy(pad_vals)))
    np.testing.assert_array_equal(dev.numpy(), got)
    assert torch.equal(t_assign[:-1], torch.from_numpy(assign[:-1]))


def test_kway_gains_csr_delta_must_be_int32():
    indptr, indices, assign, d_ids, d_vals, cand = _torch_screen(
        2, torch.int64)
    with pytest.raises(ValueError, match="int32"):
        kway_gains_csr(indptr, indices, assign, cand, tile_l=32, k=2,
                       delta=(d_ids.long(), d_vals))


def test_kway_gains_csr_refuses_other_devices():
    meta = dict(dtype=torch.int32, device="meta")
    args = (torch.empty(5, **meta), torch.empty(8, **meta),
            torch.empty(5, **meta), torch.empty(4, **meta))
    with pytest.raises(ValueError, match="cpu or cuda"):
        kway_gains_csr(*args, tile_l=32, k=4)


# ------------------------------------------- host half of a refinement

def _graphs_and_assignment(k=8, seed=3):
    hg, jhg = _pl600(synthetic), _pl600(jax_synth)
    a = np.random.default_rng(seed).integers(0, k, size=hg.n).astype(
        np.int32)
    return hg, jhg, a


def test_cut_boundary_and_host_gains_match_jax():
    hg, jhg, a = _graphs_and_assignment()
    b = refine._cut_boundary(hg, a)
    np.testing.assert_array_equal(b, jax_refine._cut_boundary(jhg, a))
    np.testing.assert_array_equal(
        refine._host_gains(hg.vertex_adjacency(), b, a, 8),
        jax_refine._host_gains(jhg.vertex_adjacency(), b, a, 8))


def test_exact_gain_matrix_matches_jax():
    hg, jhg, a = _graphs_and_assignment()
    cand = refine._cut_boundary(hg, a)[:300]
    got = refine.exact_gain_matrix(hg, cand, a, 8)
    np.testing.assert_array_equal(
        got, jax_refine.exact_gain_matrix(jhg, cand, a, 8))
    assert (got > 0).any()


@pytest.mark.parametrize("weighted", (False, True))
def test_admit_moves_matches_jax(weighted):
    hg, jhg, a = _graphs_and_assignment(k=4, seed=5)
    k = 4
    cand = refine._cut_boundary(hg, a)
    exact = refine.exact_gain_matrix(hg, cand, a, k)
    own = a[cand].astype(np.int64)
    exact[np.arange(cand.size), own] = np.iinfo(np.int64).min
    bq = exact.argmax(axis=1)
    bg = exact[np.arange(cand.size), bq]
    pos = bg > 0
    order = np.lexsort((cand[pos], -bg[pos]))
    args = (cand[pos][order], own[pos][order], bq[pos][order],
            bg[pos][order])
    weights = (np.random.default_rng(0).random(hg.n) + 0.5
               if weighted else None)
    if weighted:
        sizes = np.zeros(k)
        np.add.at(sizes, a, weights)
    else:
        sizes = np.bincount(a, minlength=k).astype(np.int64)
    # a tight window, so balance blocks moves and swaps pair them up
    lo, hi = sizes - 1, sizes + 1
    outs = []
    for mod, g in ((refine, hg), (jax_refine, jhg)):
        st = mod.RefineStats()
        sz = sizes.copy()
        v, d = mod.admit_moves(*args, g, sz, lo, hi, st, weights=weights)
        outs.append((v, d, sz, dataclasses.asdict(st)))
    for got, want in zip(*outs):
        if isinstance(got, dict):
            assert got == want
        else:
            np.testing.assert_array_equal(got, want)
    assert outs[0][3]["moves"] > 0
    if not weighted:
        assert outs[0][3]["swaps"] > 0


def test_rebalance_kway_matches_jax():
    hg, jhg, _ = _graphs_and_assignment()
    a = np.random.default_rng(1).integers(0, 2, size=hg.n).astype(np.int32)
    got = refine.rebalance_kway(hg, a, 5)
    np.testing.assert_array_equal(got, jax_refine.rebalance_kway(jhg, a, 5))
    sizes = np.bincount(got, minlength=5)
    assert sizes.max() - sizes.min() <= 1


# ------------------------------------------------------ refine_kway

def _balanced(n, k, seed):
    a = np.arange(n) % k
    return np.random.default_rng(seed).permutation(a).astype(np.int32)


@pytest.mark.parametrize("use_device", (True, False))
@pytest.mark.parametrize("k", (2, 8))
def test_refine_kway_matches_jax(k, use_device):
    hg, jhg = _pl600(synthetic), _pl600(jax_synth)
    a = _balanced(hg.n, k, seed=k)
    # small tiles and a small cap: several screening calls per pass, and
    # the verified set depends on the screen's rank
    kw = dict(tile_rows=128, cand_cap=200, use_device=use_device)
    got, st = refine.refine_kway(hg, a, k, 3, device="cpu", **kw)
    want, jst = jax_refine.refine_kway(jhg, a, k, 3, **kw)
    np.testing.assert_array_equal(got, want)
    assert dataclasses.asdict(st) == dataclasses.asdict(jst)
    assert st.moves > 0
    assert (st.kernel_calls > 0) == use_device
    assert (st.host_rows > 0) == (not use_device)


def test_refine_kway_weighted_window_and_candidates_match_jax():
    hg, jhg = _pl600(synthetic), _pl600(jax_synth)
    k = 4
    a = _balanced(hg.n, k, seed=9)
    w = np.random.default_rng(2).random(hg.n) + 0.5
    tgt = w.sum() / k
    lo, hi = np.full(k, 0.9 * tgt), np.full(k, 1.1 * tgt)
    cands = np.arange(0, hg.n, 2)
    outs = []
    for mod, g in ((refine, hg), (jax_refine, jhg)):
        kw = {"device": "cpu"} if mod is refine else {}
        out, st = mod.refine_kway(g, a, k, 2, weights=w, lo=lo, hi=hi,
                                  use_device=False, **kw)
        out2, st2 = mod.refine_kway(g, a, k, 2, candidates=cands, **kw)
        outs.append((out, dataclasses.asdict(st), out2,
                     dataclasses.asdict(st2)))
    for got, want in zip(*outs):
        if isinstance(got, dict):
            assert got == want
        else:
            np.testing.assert_array_equal(got, want)
    moved = np.flatnonzero(outs[0][2] != a)
    assert moved.size > 0 and np.isin(moved, cands).all()
    assert (outs[0][0] != a).any()


def test_refine_kway_edge_cases():
    hg = _pl600(synthetic)
    a = _balanced(hg.n, 4, seed=0)
    same, st = refine.refine_kway(hg, a, 4, 0, device="cpu")
    assert same is a and st == refine.RefineStats()
    with pytest.raises(ValueError, match="complete"):
        refine.refine_kway(hg, np.full(hg.n, -1, np.int32), 4, 1,
                           device="cpu")
    with pytest.raises(ValueError, match="needs a device"):
        refine.refine_kway(hg, a, 4, 1)
    hub = Hypergraph.from_pins(9000, 1, np.arange(9000), np.zeros(9000))
    b = (np.arange(9000) % 4).astype(np.int32)
    out, st = refine.refine_kway(hub, b, 4, 2, device="cpu")
    np.testing.assert_array_equal(out, b)          # guard: no refining
    assert st == refine.RefineStats()


def test_device_adjacency_is_memoized_per_device():
    hg = _pl600(synthetic)
    dev = hg.device_adjacency("cpu")
    assert dev is hg.device_adjacency(torch.device("cpu"))
    assert dev[0].dtype == torch.int32 and dev[1].dtype == torch.int32
    for d, h in zip(dev, hg.vertex_adjacency()):
        np.testing.assert_array_equal(d.numpy(), h)
    hub = Hypergraph.from_pins(9000, 1, np.arange(9000), np.zeros(9000))
    assert hub.device_adjacency("cpu") is None
