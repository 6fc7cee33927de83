"""Row 5c, ``segment_sum``'s kernel schedule (``csrc/segment_sum.cu``),
emulated in numpy (``tests/_torch_chunk_sums.py``) and held to the plain
version bit for bit; the plain version held to ``jax.ops.segment_sum``.

The emulation follows the kernel's warps: the heavy ids' chunk units
drawn from a counter by a random interleaving of warps, each id's last
ticket adding the partials in chunk order, the tickets and the counter
left at zero; the light warps' runs of empty ids, their packed edge lists
located as the kernel's binary search locates them, and the column tile
of the widest loads the rows' alignment allows (16, 8 or 4 bytes, up to
four vectors a lane, one pass at D <= 128 even at 4 bytes), every
element written once. The order of additions is ref.py's, so the
emulation equals ``ref.neighbor_agg_bwd_ref(..., mean=False)`` bit for
bit. JAX adds each id's edges in edge order where the port adds them in
chunks of 32: at the models' id sizes the two agree within
``tests/test_torch_gnn_archs.py``'s GRAD_TOL (1e-5), and an id of 1,000
edges lies within the float32 summation bound of its exact sum.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_chunk_sums import segment_schedule, tile_columns, vec_width
from repro_torch.kernels.neighbor_agg import ops as nops
from repro_torch.kernels.neighbor_agg.ref import neighbor_agg_bwd_ref

GRAD_TOL = dict(atol=1e-5, rtol=1e-5)   # test_torch_gnn_archs.py's
D_CASES = (1, 3, 33, 64, 70, 128, 130)


def seg_inputs(D, heavy, seed=0):
    """Seeded (msgs (E, D) float32, ids (E,) int32, N): ids of 0, 1, 31,
    32 and 33 edges, with ``heavy`` one of 1,000 edges, a run of 20 ids
    without an edge, random small ids, 10% skipped edges (-1), all in a
    shuffled edge order."""
    rng = np.random.default_rng(seed)
    N = 64
    counts = rng.integers(0, 6, size=N)
    counts[20:40] = 0                              # a run of empty ids
    counts[[1, 2, 3, 5, 7]] = [0, 1, 31, 32, 33]
    counts[11] = 1000 if heavy else 12
    ids = np.repeat(np.arange(N), counts)
    ids = np.concatenate([ids, np.full(ids.size // 9, -1)])
    ids = rng.permutation(ids).astype(np.int32)
    msgs = rng.normal(size=(ids.size, D)).astype(np.float32)
    return msgs, ids, N


def schedule_of(msgs, ids, N, **kw):
    index = nops.segment_index(torch.from_numpy(ids), N)
    return segment_schedule(msgs, index.rowptr.numpy(), index.rows.numpy(),
                            N, **kw)


def plain(msgs, ids, N):
    return neighbor_agg_bwd_ref(torch.from_numpy(msgs),
                                torch.from_numpy(ids)[:, None], N,
                                mean=False).numpy()


@pytest.mark.parametrize("heavy", (True, False), ids=("heavy", "light"))
@pytest.mark.parametrize("D", D_CASES)
def test_segment_schedule_equals_plain_version(D, heavy):
    msgs, ids, N = seg_inputs(D, heavy, seed=D)
    got, vw = schedule_of(msgs, ids, N, seed=D)
    assert vw == (4 if D % 4 == 0 else 2 if D % 2 == 0 else 1)
    want = plain(msgs, ids, N)
    np.testing.assert_array_equal(got, want)
    assert torch.equal(nops.segment_sum(torch.from_numpy(msgs),
                                        torch.from_numpy(ids), N),
                       torch.from_numpy(want))
    assert (got[20:40] == 0).all() and (got[1] == 0).all()


@pytest.mark.parametrize("D,align", ((64, 8), (70, 4), (128, 8)))
def test_segment_schedule_at_a_narrower_alignment(D, align):
    """Rows whose base is only 8- or 4-byte aligned take 8- or 4-byte
    loads, still one pass up to D = 128, with the same bits."""
    msgs, ids, N = seg_inputs(D, True, seed=1)
    got, vw = schedule_of(msgs, ids, N, align=align, heavy_warps=24)
    assert vw == (2 if align == 8 else 1)
    np.testing.assert_array_equal(got, plain(msgs, ids, N))


def test_segment_schedule_all_skipped_and_column_tiles():
    msgs = np.ones((1000, 64), np.float32)
    ids = np.full(1000, -1, np.int32)
    got, _ = schedule_of(msgs, ids, 300)
    assert (got == 0).all()
    # one pass at every D up to 128 floats, whatever the width
    for D in (1, 3, 33, 70, 128, 130):
        for vw in {vec_width(D, a) for a in (4, 8, 16)}:
            nc, passes = tile_columns(D, vw)
            assert nc <= 4 and (len(passes) == 1 or D > 128)
            covered = sorted(i for p in passes for _, _, sl in p
                             for i in range(sl.start, sl.stop))
            assert covered == list(range(D))
    assert len(tile_columns(130, 1)[1]) == 2      # 130 floats at 4 bytes


@pytest.mark.parametrize("D", D_CASES)
def test_segment_sum_plain_version_equals_jax(D):
    """At the models' id sizes (at most 33 edges an id) within GRAD_TOL of
    JAX; the 1,000-edge id, which the two add in other orders, within the
    float32 summation bound of its float64 sum: (n - 1) u sum |x| for n
    terms, u = 2**-24, which bounds either order."""
    msgs, ids, N = seg_inputs(D, False, seed=3 + D)
    want = jax.ops.segment_sum(jnp.asarray(msgs),
                               jnp.asarray(np.where(ids >= 0, ids, N)), N)
    got = nops.segment_sum(torch.from_numpy(msgs), torch.from_numpy(ids), N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)
    msgs, ids, N = seg_inputs(D, True, seed=3 + D)
    got = nops.segment_sum(torch.from_numpy(msgs), torch.from_numpy(ids), N)
    rows = msgs[ids == 11].astype(np.float64)
    bound = (rows.shape[0] - 1) * 2.0 ** -24 * np.abs(rows).sum(0)
    assert (np.abs(got.numpy()[11] - rows.sum(0)) <= bound).all()
