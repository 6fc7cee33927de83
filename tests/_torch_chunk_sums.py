"""A numpy emulation of the schedule of the chunk-sum kernels in
``src/repro_torch/kernels/neighbor_agg/csrc/neighbor_agg.cu`` (not
collected): the heavy pass, the light pass with its runs of empty ids,
row 5d's 64-row tiles, and the tile product's split into TF32 parts.
The tests hold these to the plain versions in ``ref.py``, bit for bit
where the kernels keep the order, within the stated tolerance where the
product changes it.
"""
import numpy as np

CHUNK = 32   # ref.CHUNK, the kernels' kChunk
IDS = 4      # the light ids a warp (kIds)
TILE = 64    # row 5d's tile rows (kTile)
K_STEP = 8   # the depth of one mma.sync m16n8k8


def runs_of(mask: int):
    """The light work's runs of empty ids in a warp's mask (at most 32
    bits; IDS are used), as the kernel takes them: the lowest set bit a, the run's length from the
    first clear bit above it (32 - a when none), then the run cleared."""
    runs = []
    m = mask & 0xFFFFFFFF
    while m:
        a = (m & -m).bit_length() - 1
        above = ~(m >> a) & 0xFFFFFFFF
        n = (above & -above).bit_length() - 1 if above else 32 - a
        runs.append((a, n))
        m &= ~((((1 << n) - 1) if n < 32 else 0xFFFFFFFF) << a)
    return runs


def chunk_sum(rows: np.ndarray) -> np.ndarray:
    """An id's sum over its slots' rows (S, D) float32 in the kernels'
    order: at most CHUNK slots one chain from 0 in slot order (the light
    pass, the tile kernel's light rows); more in chunks of CHUNK, each a
    chain from 0 (a unit of the heavy pass), the partials one chain from 0
    in chunk order (the ordered tail, ring or registers)."""
    total = np.zeros(rows.shape[1], np.float32)
    if rows.shape[0] <= CHUNK:
        for r in rows:
            total = total + r
        return total
    for c in range(0, rows.shape[0], CHUNK):
        part = np.zeros(rows.shape[1], np.float32)
        for r in rows[c:c + CHUNK]:
            part = part + r
        total = total + part
    return total


def bwd_schedule(g, rowptr, rows, cnt, n_ids):
    """The backward (rows 4b, 5b, 5c) as its blocks share the ids: the
    heavy blocks write the ids of more than CHUNK slots, the light blocks
    take IDS consecutive ids a warp, zero each run of empty ids and walk
    the rest; every id is written once (checked). ``cnt`` None is the sum
    mode. Returns (n_ids, D) float32."""
    D = g.shape[1]
    out = np.full((n_ids, D), np.nan, np.float32)
    written = np.zeros(n_ids, np.int64)

    def contrib(u):
        b = rows[rowptr[u]:rowptr[u + 1]]
        if cnt is None:
            return g[b]
        return g[b] / np.maximum(cnt[b], 1).astype(np.float32)[:, None]

    for u in range(n_ids):                       # the heavy blocks
        if rowptr[u + 1] - rowptr[u] > CHUNK:
            out[u] = chunk_sum(contrib(u))
            written[u] += 1
    for u0 in range(0, n_ids, IDS):              # the light blocks
        ids = range(u0, min(u0 + IDS, n_ids))
        mask = sum(1 << (u - u0) for u in ids if rowptr[u + 1] == rowptr[u])
        for a, n in runs_of(mask):
            out[u0 + a:u0 + a + n] = 0.0
            written[u0 + a:u0 + a + n] += 1
        for u in ids:
            if 0 < rowptr[u + 1] - rowptr[u] <= CHUNK:
                out[u] = chunk_sum(contrib(u))
                written[u] += 1
    assert (written == 1).all()
    return out


def tiles_of(B: int):
    """Row 5d's tiles in the order the blocks draw them from the tile
    counter: tile t holds rows 64 t .. 64 t + 63 below B. Returns [(t,
    rows)]."""
    return [(t, np.arange(t * TILE, min(t * TILE + TILE, B)))
            for t in range(-(-B // TILE))]


def csr_mean_schedule(x, indptr, indices):
    """Row 5d's mean as its two launches compute it: the heavy pass
    divides the rows of more than CHUNK slots by their counts; the tile
    kernel, tile by tile, the light rows (a row without a slot is 0).
    Returns the (B, D) float32 mean and the tiles taken."""
    B = indptr.size - 1
    mean = np.full((B, x.shape[1]), np.nan, np.float32)
    for b in range(B):                            # the heavy pass
        n = indptr[b + 1] - indptr[b]
        if n > CHUNK:
            mean[b] = chunk_sum(x[indices[indptr[b]:indptr[b + 1]]]) \
                / np.float32(n)
    tiles = tiles_of(B)
    for _, rows in tiles:                         # the tile kernel
        for b in rows:
            n = indptr[b + 1] - indptr[b]
            if n == 0:
                mean[b] = 0.0
            elif n <= CHUNK:
                mean[b] = chunk_sum(x[indices[indptr[b]:indptr[b + 1]]]) \
                    / np.float32(n)
    return mean, tiles


def tf32_rna(a: np.ndarray) -> np.ndarray:
    """float32 rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32``: half of the last kept bit added to
    the magnitude, the 13 low bits cleared (finite inputs)."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split_product(mean: np.ndarray, w: np.ndarray, w_split: bool):
    """The tile kernel's product in float32: per depth step of K_STEP, the
    mma accumulates lo @ w then hi @ w (mean = hi + lo, each TF32); with
    ``w_split`` (a float32 w) w = w_hi + w_lo, and the products are lo @
    w_hi, hi @ w_lo, hi @ w_hi. Each step's products are exact in
    float32 (TF32 x TF32) and summed in float32."""
    hi = tf32_rna(mean)
    lo = tf32_rna(mean - hi)
    w = w.astype(np.float32)
    w_hi = tf32_rna(w) if w_split else w
    w_lo = tf32_rna(w - w_hi) if w_split else None
    acc = np.zeros((mean.shape[0], w.shape[1]), np.float32)
    for k in range(0, mean.shape[1], K_STEP):
        s = slice(k, k + K_STEP)
        acc = acc + lo[:, s] @ w_hi[s]
        if w_split:
            acc = acc + hi[:, s] @ w_lo[s]
        acc = acc + hi[:, s] @ w_hi[s]
    return acc


# ---- row 5c: csrc/segment_sum.cu

MAX_NC = 4     # vectors a lane in one pass (kMaxNC)


def vec_width(D: int, align: int) -> int:
    """The floats a lane loads at once (``segment_sum_vec_width``): 4
    where D % 4 == 0 and the bases are 16-byte aligned, 2 at 8 bytes, else
    1."""
    if D % 4 == 0 and align >= 16:
        return 4
    if D % 2 == 0 and align >= 8:
        return 2
    return 1


def tile_columns(D: int, vw: int):
    """The walk's passes over a row of D floats: for each pass (from
    vector c0, 32 NC vectors) the (lane, c, element slice) of every vector
    a lane holds, vector j = c0 + lane + 32 c below nv = D / vw."""
    nv = D // vw
    nc = min(-(-nv // 32), MAX_NC)
    passes = []
    for c0 in range(0, nv, 32 * nc):
        cols = []
        for c in range(nc):
            for lane in range(32):
                j = c0 + lane + 32 * c
                if j < nv:
                    cols.append((lane, c, slice(j * vw, j * vw + vw)))
        passes.append(cols)
    return nc, passes


def warp_list(rowptr, u0: int, n_ids: int):
    """A light warp's packed edge list: lanes t < IDS hold id u0 + t's
    first edge lo and count nl (0 past n_ids, for an id without an edge
    and for a heavy one), the exclusive scan ``off``; returns, for each
    packed place q < total, the kernel's locate: the owner t (the last
    lane with off_t <= q, by its binary search over 32 lanes), the edge's
    place in rows and whether it is t's last."""
    lo = np.zeros(32, np.int64)
    nl = np.zeros(32, np.int64)
    for t in range(IDS):
        u = u0 + t
        if u < n_ids:
            lo[t] = rowptr[u]
            n = rowptr[u + 1] - rowptr[u]
            nl[t] = n if n <= CHUNK else 0
    off = np.cumsum(nl) - nl
    total = int(nl.sum())
    placed = []
    for q in range(total):
        t = 0
        for step in (16, 8, 4, 2, 1):
            if t + step < 32 and off[t + step] <= q:
                t += step
        placed.append((t, int(lo[t] + q - off[t]), q == off[t] + nl[t] - 1))
    return placed


def segment_schedule(msgs, rowptr, rows, n_ids, align=16, heavy_warps=8,
                     seed=0):
    """Row 5c's kernel as its warps share the ids, element by element: the
    heavy units (chunks of the ids past CHUNK edges) drawn from the
    counter in a random interleaving of ``heavy_warps`` warps, each a
    partial, the id's last ticket adding the partials in chunk order; the
    light warps' runs of empty ids zeroed and their packed lists walked
    once a pass of the column tile, each id written after its last edge.
    Every element is written once (checked), and the tickets and the
    counter end at zero, as the next launch needs them (checked). Returns
    (n_ids, D) float32 and the vector width."""
    D = msgs.shape[1]
    vw = vec_width(D, align)
    nc, passes = tile_columns(D, vw)
    out = np.full((n_ids, D), np.nan, np.float32)
    written = np.zeros((n_ids, D), np.int64)

    def put(u, acc, cols):
        for _, _, sl in cols:
            out[u, sl] = acc[sl]
            written[u, sl] += 1

    count = rowptr[1:] - rowptr[:-1]
    units_of = np.where(count > CHUNK, -(-count // CHUNK), 0)
    hptr = np.concatenate([[0], np.cumsum(units_of)])
    units = int(hptr[-1])
    hunit = np.repeat(np.arange(n_ids), units_of)
    tickets = np.zeros(units + 1, np.int64)       # the counter last
    partials = np.zeros((units, D), np.float32)
    rng = np.random.default_rng(seed)
    active = list(range(heavy_warps)) if units else []
    last_draw = units + heavy_warps - 1
    while active:                                 # the heavy warps
        w = active[rng.integers(len(active))]
        i = int(tickets[units])
        tickets[units] += 1
        if i >= units:
            if i == last_draw:
                tickets[units] = 0
            active.remove(w)
            continue
        u = int(hunit[i])
        base = int(hptr[u])
        s0 = rowptr[u] + (i - base) * CHUNK
        for cols in passes:
            acc = np.zeros(D, np.float32)
            for e in rows[s0:min(s0 + CHUNK, rowptr[u + 1])]:
                acc = acc + msgs[e]
            for _, _, sl in cols:
                partials[i, sl] = acc[sl]
        ticket = int(tickets[base])
        tickets[base] += 1
        if ticket == units_of[u] - 1:
            tickets[base] = 0
            for cols in passes:
                acc = np.zeros(D, np.float32)
                for p in partials[base:base + units_of[u]]:
                    acc = acc + p
                put(u, acc, cols)
    assert not tickets.any()
    for u0 in range(0, n_ids, IDS):               # the light warps
        ids = range(u0, min(u0 + IDS, n_ids))
        mask = sum(1 << (u - u0) for u in ids if count[u] == 0)
        for a, n in runs_of(mask):
            out[u0 + a:u0 + a + n] = 0.0
            written[u0 + a:u0 + a + n] += 1
        placed = warp_list(rowptr, u0, n_ids)
        for cols in passes:
            acc = np.zeros(D, np.float32)
            for t, place, last in placed:
                acc = acc + msgs[rows[place]]
                if last:
                    put(u0 + t, acc, cols)
                    acc = np.zeros(D, np.float32)
    assert (written == 1).all()
    return out, vw
