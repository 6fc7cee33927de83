"""The schedule of ``stream_commit.cu`` emulated in numpy, on the CPU.

The kernel (``src/repro_torch/kernels/hype_score/csrc/stream_commit.cu``)
runs on the card only. Its staged branch rests on one argument: within a
micro-batch, a row's presence bit ``sketch[p, b] > 0`` can differ from
the value read at launch only by turning from absent to present, and
only for a (p, b) that an earlier valid row committed. So it reads each
distinct bucket's k presence bits once, keeps them in a table that the
chain updates as it commits, and adds the pins' counts into the sketch
after the chain. ``emulate`` below follows that schedule step by step:
the prologue's staging (fw * fcnt, the sizes, the valid rows), the pins
listed in no particular order and placed by row, one table slot a
distinct bucket with its presence bits, the branch rule (the launcher's
shared-memory layout, the table's room, a sketch entry below 0), the
chain over the valid rows with the kernel's lane layout and its two
reductions over an ordered key, and the deferred sketch counts. It is
held against ``ref.stream_commit_ref`` on parts, sketch and sizes bit
for bit; synthetic faults (a commit that does not reach the table, one
that reaches it a row late, no check for entries below 0) must be
caught. The card tests (``tests/test_torch_cuda.py``) hold the kernel
itself to the same plain version and check the branch its launcher
reports.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.hype_score.ref import stream_commit_ref
from tests._hyp_compat import given, settings, st

# stream_commit.cu's constants, and an H100's opt-in shared memory
SMEM_OPTIN = 232_448
KEEP_L1 = 64 * 1024
STAGED_MAX_K = 256
MIN_SLOTS, MAX_SLOTS, MAX_ROWS = 64, 1 << 16, 1 << 16
HASH_MULT = np.uint32(2654435761)


def _align16(x: int) -> int:
    return (x + 15) & ~15


def layout_bytes(mb: int, k: int, slots: int) -> int:
    """The staged kernel's dynamic shared memory (make_layout)."""
    words, pins = (k + 31) // 32, slots // 2
    sizes = [4 * mb * k, 2 * mb * k, 4 * (mb + 1), 4 * mb, 4 * mb, 4 * mb,
             16 * mb, 4 * mb, 4 * pins, 2 * pins, 2 * pins, 2 * pins,
             2 * pins, 4 * slots, 4 * slots * words]
    return sum(_align16(s) for s in sizes)


def staged_slots(mb: int, le: int, k: int) -> int:
    """The launcher's hash slots for the shape; 0 = the row chain."""
    if k > STAGED_MAX_K or mb >= MAX_ROWS or mb * le >= 2**31 - 1:
        return 0
    limit = SMEM_OPTIN - KEEP_L1
    slots = MIN_SLOTS
    while slots < MAX_SLOTS and slots < 2 * mb * le:
        slots <<= 1
    while slots >= MIN_SLOTS and layout_bytes(mb, k, slots) > limit:
        slots >>= 1
    return slots if slots >= MIN_SLOTS else 0


def _bucket(ids: np.ndarray, bits: int) -> np.ndarray:
    return ((ids.astype(np.uint32) * HASH_MULT)
            >> np.uint32(32 - bits)).astype(np.int64)


def _order_key(score: np.ndarray) -> np.ndarray:
    """The kernel's order_key: -0 as +0, then the float's order as an
    unsigned key."""
    u = score.astype(np.float32).view(np.uint32).copy()
    u[u == np.uint32(0x80000000)] = 0
    neg = (u & np.uint32(0x80000000)) != 0
    return np.where(neg, ~u, u | np.uint32(0x80000000))


def _score(conn, base_row, size, alpha, inv_target, cap):
    f32 = np.float32
    score = ((conn.astype(f32) + base_row)
             - ((f32(alpha) * size.astype(f32)) * f32(inv_target)))
    return np.where(size >= cap, f32(-np.inf), score).astype(f32)


def _warp_argmax(score: np.ndarray) -> int:
    """Lane l holds p = l, l + 32, ...; each lane keeps its first best
    key, then the warp takes the max key and the lowest p holding it."""
    k = score.size
    nc = (k + 31) // 32
    keys = np.zeros(32 * nc, np.uint32)     # no partition: key 0
    keys[:k] = _order_key(score)
    keys = keys.reshape(nc, 32)
    best_c = keys.argmax(0)                 # first max over c, per lane
    best_key = keys[best_c, np.arange(32)]
    best_p = best_c * 32 + np.arange(32)
    top = best_key.max()
    return int(best_p[best_key == top].min())


def row_chain(edge, fcnt, valid, sketch, sizes, parts, rows, *, alpha,
              fringe_w, inv_target, cap, sketch_bits):
    """The second branch: each of ``rows`` against the live sketch and
    sizes, in order."""
    f32 = np.float32
    for i in rows:
        pins = _bucket(edge[i][edge[i] >= 0], sketch_bits)
        conn = (sketch[:, pins] > 0).sum(1)
        base_row = (f32(fringe_w) * fcnt[i]).astype(f32)
        p = _warp_argmax(_score(conn, base_row, sizes, alpha, inv_target,
                                cap))
        if valid[i]:
            sizes[p] += 1
            np.add.at(sketch[p], pins, 1)
            parts[i] = p
        else:
            parts[i] = -1


def emulate(edge, fcnt, valid, sketch, sizes, *, alpha, fringe_w,
            inv_target, cap, sketch_bits, fault=None, seed=0):
    """The kernel on numpy copies of its inputs: returns (parts, sketch,
    sizes, branch), branch 'chain' (the launcher's row chain), 'staged' or
    'handed' (the staged kernel handing the launch to the row chain, its
    pins past the table or a sketch entry below 0)."""
    f32 = np.float32
    sketch, sizes = sketch.copy(), sizes.copy()
    mb, le = edge.shape
    k = sketch.shape[0]
    parts = np.full(mb, -1, np.int32)
    kw = dict(alpha=alpha, fringe_w=fringe_w, inv_target=inv_target,
              cap=cap, sketch_bits=sketch_bits)
    slots = staged_slots(mb, le, k)
    if slots == 0:
        row_chain(edge, fcnt, valid, sketch, sizes, parts, range(mb), **kw)
        return parts, sketch, sizes, "chain"

    # 0-2. staging: fw * fcnt, the sizes (warp 0's registers), the valid
    # rows (a pad row's part is -1), each valid row's pins
    base = (f32(fringe_w) * fcnt).astype(f32)
    vrows = np.flatnonzero(valid)
    if ((edge >= 0) & valid[:, None]).sum() > slots // 2:
        row_chain(edge, fcnt, valid, sketch, sizes, parts, range(mb), **kw)
        return parts, sketch, sizes, "handed"

    # 3. the pins placed by row (in any order within it); one slot a
    # distinct bucket, flagged when two pins hold it, its k presence bits
    # gathered from the sketch
    rng = np.random.default_rng(seed)
    slot_of, keys, held, placed = {}, [], [], {}
    for i in vrows:
        b_row = _bucket(rng.permutation(edge[i][edge[i] >= 0]), sketch_bits)
        run = []
        for b in b_row:
            if b not in slot_of:
                slot_of[b] = len(keys)
                keys.append(b)
                held.append(0)
            held[slot_of[b]] += 1
            run.append(slot_of[b])
        placed[i] = (np.array(run, np.int64), b_row)
    gathered = sketch[:, keys]                       # (k, distinct)
    if (gathered < 0).any() and fault != "no_negative_check":
        row_chain(edge, fcnt, valid, sketch, sizes, parts, range(mb), **kw)
        return parts, sketch, sizes, "handed"
    mask = (gathered > 0).T.copy()                   # (distinct, k)
    shared = np.array(held, np.int64) >= 2

    # 4. an independent row (no shared slot): the launch's conn, added
    # into fw * fcnt now; a dependent row: the conn of its unshared slots
    first, connu, dpins = {}, {}, {}
    for i in vrows:
        run = placed[i][0]
        own = run[~shared[run]]
        conn = mask[own].sum(0)
        dpins[i] = run[shared[run]]
        if dpins[i].size == 0:
            first[i] = (conn.astype(f32) + base[i]).astype(f32)
        else:
            first[i], connu[i] = base[i], conn

    # 5. the chain: the valid rows in order, the table only
    pending = []
    for i in vrows:
        t = first[i]
        if dpins[i].size:
            conn = connu[i] + mask[dpins[i]].sum(0)
            t = (conn.astype(f32) + base[i]).astype(f32)
        score = (t - ((f32(alpha) * sizes.astype(f32))
                      * f32(inv_target))).astype(f32)
        p = _warp_argmax(np.where(sizes >= cap, f32(-np.inf),
                                  score).astype(f32))
        sizes[p] += 1
        parts[i] = p
        if fault == "late":       # a row's commit seen from two rows on
            for slots_, q in pending:
                mask[slots_, q] = True
            pending = [(dpins[i], p)]
        elif fault != "stale":    # "stale": the table never updated
            mask[dpins[i], p] = True

    # 6. each pin's count into the sketch
    for i in vrows:
        np.add.at(sketch[parts[i]], placed[i][1], 1)
    return parts, sketch, sizes, "staged"


KINDS = ("random", "path", "chain", "nopins", "pads", "ties", "cap",
         "full", "nearcap", "tight", "negalpha", "dup", "negative", "wide")


def commit_inputs(seed, k, mb, le, bits=16, kind="random"):
    """Seeded numpy inputs of one commit: the ids, fcnt, the row mask,
    the sketch, the sizes and the knobs. ``path``: 1-3 leading pins a
    row, about 30% of the valid rows with none; ``chain``: every row
    draws its pins from six ids, over an empty sketch, so each row's
    presence is what the rows before it committed; ``nopins``: valid
    rows, no pin; ``pads``: pad rows anywhere; ``ties``: no fringe or
    balance term and an empty sketch; ``cap``/``full``: all partitions
    but the last, or all, at their cap; ``nearcap``: all within 3 of it;
    ``tight``: a balance term of 0.36 a size against the fringe's 0.5 a
    neighbour; ``negalpha``: a negative balance weight; ``dup``: 4-bit
    buckets;
    ``negative``: sketch entries below 0; ``wide``: every slot a pin."""
    rng = np.random.default_rng(seed)
    if kind == "dup":
        bits = 4
    edge = rng.integers(0, 200_000, size=(mb, le)).astype(np.int32)
    if kind != "wide":
        edge[rng.random((mb, le)) < 0.3] = -1
    if kind in ("path", "chain", "nopins"):
        edge[:] = -1
        pool = rng.integers(0, 200_000, size=6)
        for i in range(mb if kind != "nopins" else 0):
            n = int(rng.integers(1, min(3, le) + 1))
            if kind == "chain":
                edge[i, :n] = rng.choice(pool, size=n)
            elif rng.random() >= 0.3:
                edge[i, :n] = rng.integers(0, 200_000, size=n)
    fcnt = rng.integers(0, 5, size=(mb, k)).astype(np.float32)
    sketch = np.zeros((k, 1 << bits), np.int32)
    b = _bucket(edge[edge >= 0], bits)               # the tile's buckets
    hit = rng.random((k, b.size)) < 0.3
    sketch[np.nonzero(hit)[0], b[np.nonzero(hit)[1]]] = rng.integers(
        1, 3, size=int(hit.sum()))
    sketch[rng.random(sketch.shape) < 0.001] = 1     # and a few others
    if kind == "negative":
        sketch[:, b] = np.where(rng.random((k, b.size)) < 0.3, -1,
                                sketch[:, b])
    cap = 5 * mb + 3
    sizes = rng.integers(0, cap, size=k).astype(np.int32)
    valid = np.ones(mb, bool)
    valid[-1] = mb == 1 or kind == "nopins"
    if kind == "pads":
        valid = rng.random(mb) < 0.6
    alpha, fw = 1.0, 0.5
    if kind in ("ties", "chain"):
        sketch[:] = 0
    if kind == "ties":
        alpha, fw = 0.0, 0.0
    elif kind == "cap":
        sizes[:-1] = cap
    elif kind == "full":
        sizes[:] = cap
    elif kind == "nearcap":
        sizes[:] = cap - rng.integers(1, 4, size=k)
    elif kind == "tight":
        alpha = float(np.float32(0.36) / np.float32(k / 177_386))
    elif kind == "negalpha":
        alpha = -3.0
    kw = dict(alpha=alpha, fringe_w=fw, inv_target=float(
        np.float32(k / 177_386)), cap=cap, sketch_bits=bits)
    return (edge, fcnt, valid, sketch, sizes), kw


def _plain(x, kw):
    """ref.stream_commit_ref on torch copies: parts, sketch, sizes."""
    t = [torch.from_numpy(a.copy()) for a in x]
    parts = stream_commit_ref(*t, **kw)
    return parts.numpy(), t[3].numpy(), t[4].numpy()


def _check(x, kw, seed=0):
    """The emulated schedule bit for bit against the plain version;
    returns the branch it took."""
    parts, sketch, sizes, branch = emulate(*x, **kw, seed=seed)
    want = _plain(x, kw)
    np.testing.assert_array_equal(parts, want[0])
    np.testing.assert_array_equal(sketch, want[1])
    np.testing.assert_array_equal(sizes, want[2])
    return branch


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [1, 3, 32, 65])
def test_schedule_equals_plain_version(kind, k):
    x, kw = commit_inputs(k * 100 + KINDS.index(kind), k, 64,
                          256 if kind == "wide" else 32, kind=kind)
    want = {"wide": "handed", "negative": "handed"}.get(kind, "staged")
    assert _check(x, kw) == want


@pytest.mark.parametrize("mb", [1, 7, 64])
@pytest.mark.parametrize("le", [32, 128, 512, 2048])
def test_schedule_at_the_pass_widths(le, mb):
    """The pass's tile widths (and the widened one): staged at the
    stream's own rows, handed to the row chain where random rows pass
    the table's room (4,096 pins at k = 32, fewer where the tile is
    small)."""
    for kind in ("path", "random"):
        x, kw = commit_inputs(le + mb, 32, mb, le, kind=kind)
        pins = int(((x[0] >= 0) & x[2][:, None]).sum())
        room = staged_slots(mb, le, 32) // 2
        assert _check(x, kw) == ("handed" if pins > room else "staged")


def test_branch_rule_at_the_stream_shape():
    """The launcher's rule at mb = 64: at k = 32, 8,192 table slots (4,096
    pins) in 129 KB, 64 KB of the SM left to L1; 512 pins at k = 256;
    the row chain past k = 256 or mb = 65,535. The card tests assert the
    same branches from the launcher itself."""
    assert staged_slots(64, 32, 32) == 4096
    assert staged_slots(64, 2048, 32) == 8192
    assert layout_bytes(64, 32, 8192) == 129_296
    assert layout_bytes(64, 32, 16384) > SMEM_OPTIN - KEEP_L1
    assert staged_slots(64, 2048, 256) == 1024
    assert staged_slots(64, 32, 257) == 0
    assert staged_slots(MAX_ROWS, 1, 1) == 0
    # the card tests' kinds and their branches
    for kind, k, le, branch in (("wide", 3, 256, "handed"),
                                ("wide", 32, 256, "handed"),
                                ("wide", 256, 2048, "handed"),
                                ("wide", 300, 256, "chain"),
                                ("negative", 3, 32, "handed"),
                                ("negative", 300, 32, "chain"),
                                ("path", 257, 32, "chain")):
        x, kw = commit_inputs(k * 7 + le, k, 64, le, kind=kind)
        assert _check(x, kw) == branch
    x, kw = commit_inputs(1, 32, 64, 2048)           # the dense tile
    assert ((x[0] >= 0) & x[2][:, None]).sum() == 90_221
    assert _check(x, kw) == "handed"


def test_presence_depends_on_the_rows_before():
    """Rows that repeat the ids of the rows before them: the staged
    table's updates decide the result (an emulation that drops them, or
    sees them a row late, disagrees), and the listing order of the pins
    does not."""
    caught = {"stale": 0, "late": 0}
    for seed in range(12):
        x, kw = commit_inputs(seed, 4, 64, 32, kind="chain")
        kw["alpha"] = 20.0            # the balance term breaks even moves
        for order in range(3):
            assert _check(x, kw, seed=order) == "staged"
        want = _plain(x, kw)
        for fault in caught:
            got = emulate(*x, **kw, fault=fault)
            caught[fault] += not (np.array_equal(got[0], want[0])
                                  and np.array_equal(got[1], want[1]))
    assert caught["stale"] > 0 and caught["late"] > 0


def test_entry_below_zero_needs_the_row_chain():
    """A sketch entry of -1 stays absent after one count: the table's
    'present once committed' would be wrong, so the staged kernel hands
    such a launch to the row chain; without that check the emulation
    disagrees with the plain version."""
    k, bits = 2, 16
    edge = np.full((2, 32), -1, np.int32)
    edge[:, 0] = 12345
    fcnt = np.array([[1, 0], [0, 0]], np.float32)
    valid = np.ones(2, bool)
    sketch = np.zeros((k, 1 << bits), np.int32)
    sketch[0, _bucket(np.array([12345]), bits)[0]] = -1
    sizes = np.zeros(k, np.int32)
    kw = dict(alpha=1.0, fringe_w=1.0, inv_target=0.5, cap=10,
              sketch_bits=bits)
    x = (edge, fcnt, valid, sketch, sizes)
    assert _check(x, kw) == "handed"
    np.testing.assert_array_equal(_plain(x, kw)[0], [0, 1])
    got = emulate(*x, **kw, fault="no_negative_check")
    np.testing.assert_array_equal(got[0], [0, 0])


def test_valid_rows_without_pins_and_pad_rows_anywhere():
    """Valid rows with no pin still score and bump a size; pad rows in
    any position change nothing and write -1."""
    x, kw = commit_inputs(5, 32, 64, 32, kind="nopins")
    assert _check(x, kw) == "staged"
    parts = _plain(x, kw)[0]
    assert (parts >= 0).all()
    x, kw = commit_inputs(6, 32, 64, 32, kind="pads")
    edge, fcnt, valid, sketch, sizes = x
    assert not valid.all() and valid.any()
    assert _check(x, kw) == "staged"
    parts, sk, sz = _plain(x, kw)
    assert (parts[~valid] == -1).all() and (parts[valid] >= 0).all()
    assert sz.sum() - sizes.sum() == valid.sum()
    assert sk.sum() - sketch.sum() == ((edge >= 0) & valid[:, None]).sum()


def test_all_at_the_cap_and_ties_pick_partition_zero():
    x, kw = commit_inputs(7, 32, 64, 32, kind="full")
    assert _check(x, kw) == "staged"
    parts = _plain(x, kw)[0]
    assert (parts[x[2]] == 0).all()
    x, kw = commit_inputs(8, 33, 8, 32, kind="ties")
    assert _check(x, kw) == "staged"


@given(seed=st.integers(0, 10**6),
       k=st.sampled_from([1, 2, 3, 32, 33, 64, 65, 300]),
       mb=st.sampled_from([1, 7, 64]), bits=st.sampled_from([4, 16]),
       kind=st.sampled_from(KINDS))
@settings(max_examples=60, deadline=None)
def test_schedule_equals_plain_version_hypothesis(seed, k, mb, bits, kind):
    le = 256 if kind == "wide" else 32
    x, kw = commit_inputs(seed, k, mb, le, bits=bits, kind=kind)
    branch = _check(x, kw, seed=seed)
    if k > STAGED_MAX_K:
        assert branch == "chain"
