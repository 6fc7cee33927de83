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
