// Neighbour aggregation (mean of the valid neighbour rows, times w) and
// its gradient for x, hand-written for Hopper (sm_90a).
//
// Forward. Replaces the Pallas TPU kernel ``neighbor_agg_kernel`` (body
// ``_agg_kernel``) in src/repro/kernels/neighbor_agg/kernel.py. Per row b
// of the (B, K) int32 neighbour ids (-1 pad):
//   acc[:] = 0 (float32); cnt = 0
//   for j in 0..K-1 (in slot order): if nbrs[b, j] >= 0:
//       acc[:] += float(x[nbrs[b, j], :]); cnt += 1
//   mean[b, :] = acc / max(cnt, 1)
//   out[b, :]  = T(mean[b, :] @ float(w))        (w is (D, F))
// The additions run in slot order and the mean is one IEEE division, so
// the mean equals the plain version (ref.py) bit for bit; the product
// sums over the depth in order here and in a library order there, so the
// output agrees within float32 rounding. A block whose rows all have no
// valid slot, or a warp whose rows have none, skips the product and
// writes zeros: the same +0 as 0 @ w for a finite w (the plain version's
// 0 @ w is NaN where a column of w is not finite). On request the kernel
// also writes the float32 mean, which the backward's grad_w needs, so
// the backward does not gather again.
//
// Backward (no TPU counterpart: the JAX package has no custom_vjp for
// this kernel). With g = grad_out @ w^T (B, D) float32, computed by the
// caller:
//   grad_x[u, :] = sum of g[b, :] / max(cnt_b, 1) over the valid slots
//                  (b, j) with nbrs[b, j] = u
// in a fixed order (ref.py): u's slots in (b, j) order are cut into
// chunks of kChunk; each chunk is summed in order from 0, and the chunk
// partials are added in chunk order from 0. No float atomics, so the
// result is the same bits on every run whichever warp does what, and
// equal to the plain version's on the CPU (index_add_ in index order).
// The caller's transposed index gives ``rows``, the b of every valid
// slot sorted stably by id, ``rowptr`` over the N + 1 ids, and the chunk
// units of the ids with more than kChunk slots (``hptr``, ``hunit``).
// A hub id of a power-law batch names a thousand slots, and one warp
// walking them in order took 0.29 ms on the H100 at the GraphSAGE
// layer, so:
//   * light ids (at most kChunk slots, one chunk): a warp owns kIds
//     consecutive ids, lane t holding id t's slot range. A warp scan
//     packs their slots into one list; the lanes load 32 slots' rows and
//     counts at a time (one coalesced load each), then the warp walks
//     the list with kFlight rows of g in flight, lanes over D, and
//     writes each id's row after its last slot (zeros for an id without
//     one). The walk is serial, so a warp takes few ids and many warps
//     hide the chain rowptr -> rows -> cnt -> g (of 1 to 32 ids a warp,
//     4 ran fastest on the H100 at the GraphSAGE layer);
//   * heavy ids: every chunk is a unit of its own, spread over the
//     first blocks of the grid. A warp sums its chunk into a float32
//     scratch row, then takes a ticket (an integer atomic on the id's
//     counter, zeroed before the launch); the warp that draws the last
//     ticket adds the id's partials in chunk order and writes its row.
// Every id's row is written once. Offsets are 64-bit. What bounds the
// backward: bytes, mostly the N x D output (87 MB at the GraphSAGE
// layer, most rows zeros: 0.029 ms at 3.35 TB/s).
//
// What bounds it on the H100. Forward at the GraphSAGE layer shape
// (B = N = 169,984, K = 25, D = F = 128, float32): the gather reads the
// live rows (about 77 MB), the output and the kept mean are 87 MB each:
// about 0.07 ms of bytes. Only the 16k rows with a valid slot (the seeds
// and the first hop) need the product, 0.56 GFLOP on the float32 CUDA
// cores; the padding rows' blocks and the warps whose rows are sources
// only skip it. The TPU kernel walks a sequential (row, slot) grid with a
// VMEM accumulator and feeds each row's mean to the MXU. Here a block of
// 8 warps owns 32 rows: each warp gathers 4 of them (the lane whose index
// is j holds slot j's id, read once and broadcast by shuffle, so a pad
// slot is skipped by the whole warp; lanes stride over D with 16-byte
// loads, four slots' loads in flight before their in-order adds), and
// puts the 32 means in shared memory. Then the block multiplies the
// (32, D) tile by w, staged through shared memory in (32, 64) float32
// tiles, each thread holding a 2 x 4 register tile of outputs. Every row
// offset is 64-bit (N * D may pass 2**31).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowTile = 2;   // output rows per thread in the product
constexpr int kRows = 16 * kRowTile;  // output rows per block
constexpr int kFC = 64;       // columns of w per shared tile
constexpr int kDC = 32;       // rows of w per shared tile
constexpr int kSlots = 4;     // slots' loads in flight per lane
constexpr int kChunk = 32;    // slots per chunk (bwd; ref.py's CHUNK)
constexpr int kFlight = 8;    // rows of g in flight per lane (bwd)
constexpr int kIds = 4;       // light ids per warp (bwd), at most 32
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void narrow(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(x);
}

// Four float32 values to four consecutive elements (16-byte aligned for
// float32, 8-byte for bfloat16).
__device__ __forceinline__ void store4(const float* a, float* dst) {
  *reinterpret_cast<float4*>(dst) = make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ void store4(const float* a, __nv_bfloat16* dst) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a[0], a[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(a[2], a[3]);
  uint2 q;
  q.x = *reinterpret_cast<const uint32_t*>(&lo);
  q.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = q;
}

template <typename T>
struct Vec {
  static constexpr int kN = 16 / sizeof(T);  // elements per 16-byte load
};

// One 16-byte vector of x, widened to float32.
__device__ __forceinline__ void load_vec(const float* src, float* v) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(src));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* src,
                                         float* v) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(src));
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // bfloat16 -> float32 is exact: the 16 bits become the high half
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The float32 mean of row b's valid neighbours into ``dst`` (shared
// memory, D floats) and, when ``mean_out`` is set, into mean_out[b, :].
// Called by a whole warp; returns the row's count of valid slots.
template <typename T>
__device__ int gather_mean(const T* __restrict__ x,
                            const int32_t* __restrict__ idr, int K, int D,
                            int vec, float* dst, float* mean_out) {
  constexpr int N = Vec<T>::kN;
  const int lane = threadIdx.x & 31;
  int cnt = 0;
  for (int j0 = 0; j0 < K; j0 += 32) {
    const int32_t id = j0 + lane < K ? idr[j0 + lane] : -1;
    cnt += __popc(__ballot_sync(kFull, id >= 0));
  }
  const float denom = (float)(cnt > 1 ? cnt : 1);

  // vector part: lane owns vector c = c0 + lane of the row
  const int nvec = vec ? D / N : 0;
  for (int c0 = 0; c0 < nvec; c0 += 32) {
    const int c = c0 + lane;
    float acc[N];
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = 0.0f;
    for (int j0 = 0; j0 < K; j0 += 32) {
      const int32_t mine = j0 + lane < K ? idr[j0 + lane] : -1;
      const int nj = K - j0 < 32 ? K - j0 : 32;
      for (int jj = 0; jj < nj; jj += kSlots) {
        int32_t id[kSlots];
        float v[kSlots][N];
#pragma unroll
        for (int t = 0; t < kSlots; ++t) {
#pragma unroll
          for (int i = 0; i < N; ++i) v[t][i] = 0.0f;
          // lanes at or past nj hold -1, and jj + t < 32
          id[t] = __shfl_sync(kFull, mine, jj + t);
          if (id[t] >= 0 && c < nvec)
            load_vec(x + (int64_t)id[t] * D + (int64_t)c * N, v[t]);
        }
#pragma unroll
        for (int t = 0; t < kSlots; ++t) {
          if (id[t] < 0) continue;  // the same for every lane
#pragma unroll
          for (int i = 0; i < N; ++i) acc[i] += v[t][i];
        }
      }
    }
    if (c < nvec) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        acc[i] = acc[i] / denom;
        dst[c * N + i] = acc[i];
      }
      if (mean_out) {
#pragma unroll
        for (int i = 0; i < N; i += 4) store4(acc + i, mean_out + c * N + i);
      }
    }
  }

  // scalar part: the elements past the last whole vector (all of them
  // when the rows are not 16-byte aligned)
  for (int d0 = nvec * N; d0 < D; d0 += 32) {
    const int d = d0 + lane;
    float acc = 0.0f;
    for (int j0 = 0; j0 < K; j0 += 32) {
      const int32_t mine = j0 + lane < K ? idr[j0 + lane] : -1;
      const int nj = K - j0 < 32 ? K - j0 : 32;
      for (int jj = 0; jj < nj; ++jj) {
        const int32_t id = __shfl_sync(kFull, mine, jj);
        if (id >= 0 && d < D) acc += widen(x[(int64_t)id * D + d]);
      }
    }
    if (d < D) {
      const float m = acc / denom;
      dst[d] = m;
      if (mean_out) mean_out[d] = m;
    }
  }
  return cnt;
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
neighbor_agg_kernel(const T* __restrict__ x, const int32_t* __restrict__ nbrs,
                    const W* __restrict__ w, T* __restrict__ out,
                    float* __restrict__ mean_out, int64_t B, int K, int D,
                    int F, int vec) {
  extern __shared__ float smem[];
  const int ld = D | 1;  // odd row stride: no bank conflicts below
  float* mean_s = smem;                       // kRows x ld
  float* w_s = smem + kRows * ld;             // kDC x kFC, 16-byte aligned
  const int64_t row0 = (int64_t)blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5;

  __shared__ int live_s[kRows];  // the row has a valid slot

  // 1. gather: each warp owns kRows / kWarps rows of the tile
  int live = 0;
  for (int r = warp; r < kRows; r += kWarps) {
    const int64_t b = row0 + r;
    const int l = b < B && gather_mean(x, nbrs + b * K, K, D, vec,
                                       mean_s + r * ld,
                                       mean_out ? mean_out + b * D
                                                : nullptr) > 0;
    if ((threadIdx.x & 31) == 0) live_s[r] = l;
    live |= l;
  }
  // A row without a valid slot has a zero mean and a zero output, so the
  // product skips it: the whole block when none of its rows has a slot,
  // else each warp whose rows have none (in a sampled batch only the
  // seeds and the first hop have in-edges).
  if (!__syncthreads_or(live)) {
    const int64_t nrows = B - row0 < kRows ? B - row0 : kRows;
    for (int64_t i = threadIdx.x; i < nrows * F; i += kThreads)
      narrow(0.0f, out + row0 * F + i);
    return;
  }

  // 2. product: thread (ty, tx) owns rows kRowTile * ty + r (r <
  //    kRowTile) and columns f0 + 4tx .. f0 + 4tx + 3 of the tile
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  bool mine = false;
#pragma unroll
  for (int r = 0; r < kRowTile; ++r) mine |= live_s[kRowTile * ty + r] != 0;
  const bool warp_live = __any_sync(kFull, mine);
  for (int f0 = 0; f0 < F; f0 += kFC) {
    float acc[kRowTile][4];
#pragma unroll
    for (int r = 0; r < kRowTile; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
    for (int d0 = 0; d0 < D; d0 += kDC) {
      __syncthreads();  // the last w tile is consumed
      for (int i = threadIdx.x; i < kDC * kFC; i += kThreads) {
        const int dd = i / kFC, ff = i % kFC;
        w_s[i] = (d0 + dd < D && f0 + ff < F)
                     ? widen(w[(int64_t)(d0 + dd) * F + f0 + ff])
                     : 0.0f;
      }
      __syncthreads();
      const int nd = warp_live ? (D - d0 < kDC ? D - d0 : kDC) : 0;
      const float* a = mean_s + (kRowTile * ty) * ld + d0;
      for (int dd = 0; dd < nd; ++dd) {
        const float4 bv = reinterpret_cast<const float4*>(w_s + dd * kFC)[tx];
#pragma unroll
        for (int r = 0; r < kRowTile; ++r) {
          const float xr = a[r * ld + dd];
          acc[r][0] += xr * bv.x;
          acc[r][1] += xr * bv.y;
          acc[r][2] += xr * bv.z;
          acc[r][3] += xr * bv.w;
        }
      }
    }
    const int f = f0 + 4 * tx;
#pragma unroll
    for (int r = 0; r < kRowTile; ++r) {
      const int64_t b = row0 + kRowTile * ty + r;
      if (b >= B) continue;
      if ((F & 3) == 0 && f < F) {
        store4(acc[r], out + b * F + f);  // F % 4 == 0: aligned
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (f + c < F) narrow(acc[r][c], out + b * F + f + c);
      }
    }
  }
}

// ---- backward. V floats per lane: 4 (16-byte loads) or 1.

template <int V>
__device__ __forceinline__ void load_g(const float* p, float* v) {
  if constexpr (V == 4) {
    load_vec(p, v);
  } else {
    v[0] = __ldg(p);
  }
}

// A partial written by another warp during this launch: read from L2.
template <int V>
__device__ __forceinline__ void load_partial(const float* p, float* v) {
  if constexpr (V == 4) {
    const float4 q = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = __ldcg(p);
  }
}

template <int V, typename T>
__device__ __forceinline__ void store_row(const float* a, T* dst) {
  if constexpr (V == 4) {
    store4(a, dst);
  } else {
    narrow(a[0], dst);
  }
}

// Adds slots s0 .. s0 + n - 1 (n <= 32) of the lanes' list into acc, in
// order: lane s holds slot s's row b and divisor. When ``out`` is set,
// lane s also holds the owner t (row out + t * D) and whether the slot
// is its owner's last, and the warp writes acc there and restarts from 0
// after each last slot.
template <int V, typename T>
__device__ __forceinline__ void add_slots(
    const float* __restrict__ g, int D, int col, bool mine, int n,
    int32_t my_b, float my_den, int my_t, bool my_last, T* out,
    float* acc) {
  for (int s0 = 0; s0 < n; s0 += kFlight) {
    float v[kFlight][V];
    float den[kFlight];
#pragma unroll
    for (int s = 0; s < kFlight; ++s) {
      // s0 + s < 32: kFlight divides 32
      const int32_t b = __shfl_sync(kFull, my_b, s0 + s);
      den[s] = __shfl_sync(kFull, my_den, s0 + s);
#pragma unroll
      for (int i = 0; i < V; ++i) v[s][i] = 0.0f;
      if (s0 + s < n && mine)
        load_g<V>(g + (int64_t)b * D + (int64_t)col * V, v[s]);
    }
#pragma unroll
    for (int s = 0; s < kFlight; ++s) {
      const int t = __shfl_sync(kFull, my_t, s0 + s);
      const bool last = __shfl_sync(kFull, (int)my_last, s0 + s) != 0;
      if (s0 + s >= n) break;  // the same for every lane
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] += v[s][i] / den[s];
      if (out && last) {
        if (mine) store_row<V>(acc, out + (int64_t)t * D + (int64_t)col * V);
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = 0.0f;
      }
    }
  }
}

// The ids u0 .. u0 + kIds - 1 with at most kChunk slots (one warp).
template <int V, typename T>
__device__ void light_ids(const float* __restrict__ g,
                          const int32_t* __restrict__ cnt,
                          const int64_t* __restrict__ rowptr,
                          const int32_t* __restrict__ rows,
                          T* __restrict__ grad_x, int64_t N, int D,
                          int64_t u0) {
  const int lane = threadIdx.x & 31;
  const int64_t u = lane < kIds ? u0 + lane : N;  // lanes past kIds: none
  int64_t lo = 0, hi = 0;
  if (u < N) {
    lo = rowptr[u];
    hi = rowptr[u + 1];
  }
  const int nl = hi - lo <= kChunk ? (int)(hi - lo) : 0;  // heavy: skip
  int off = nl;  // inclusive scan of nl over the lanes, then exclusive
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, off, o);
    if (lane >= o) off += y;
  }
  const int total = __shfl_sync(kFull, off, 31);
  off -= nl;
  const unsigned empty = __ballot_sync(kFull, u < N && hi == lo);
  T* out = grad_x + u0 * D;
  const int ncol = V == 4 ? D / 4 : D;
  for (int c0 = 0; c0 < ncol; c0 += 32) {
    const int col = c0 + lane;
    const bool mine = col < ncol;
    const float zero[V] = {};
    for (unsigned m = empty; m; m &= m - 1) {
      if (mine)
        store_row<V>(zero, out + (int64_t)(__ffs(m) - 1) * D +
                               (int64_t)col * V);
    }
    float acc[V] = {};
    for (int qb = 0; qb < total; qb += 32) {
      // lane l: packed slot q = qb + l, owned by the last lane t with
      // off_t <= q (off does not decrease over the lanes)
      const int q = qb + lane;
      int t = 0;
#pragma unroll
      for (int step = 16; step > 0; step >>= 1)
        if (__shfl_sync(kFull, off, t + step) <= q) t += step;
      const int64_t lo_t = __shfl_sync(kFull, lo, t);
      const int off_t = __shfl_sync(kFull, off, t);
      const int nl_t = __shfl_sync(kFull, nl, t);
      int32_t my_b = 0;
      float my_den = 1.0f;
      if (q < total) {
        my_b = rows[lo_t + (q - off_t)];
        const int c = cnt[my_b];
        my_den = (float)(c > 1 ? c : 1);
      }
      add_slots<V>(g, D, col, mine, total - qb < 32 ? total - qb : 32, my_b,
                   my_den, t, q == off_t + nl_t - 1, out, acc);
    }
  }
}

// Chunk unit i of a heavy id: its partial, then, for the warp that draws
// the id's last ticket, the sum of the id's partials in chunk order.
template <int V, typename T>
__device__ void heavy_unit(const float* __restrict__ g,
                           const int32_t* __restrict__ cnt,
                           const int64_t* __restrict__ rowptr,
                           const int32_t* __restrict__ rows,
                           const int64_t* __restrict__ hptr,
                           const int32_t* __restrict__ hunit,
                           float* __restrict__ partials,
                           int32_t* __restrict__ tickets,
                           T* __restrict__ grad_x, int D, int64_t i) {
  const int lane = threadIdx.x & 31;
  const int64_t u = hunit[i];
  const int64_t base = hptr[u], units = hptr[u + 1] - base;
  const int64_t s0 = rowptr[u] + (i - base) * kChunk;
  const int64_t left = rowptr[u + 1] - s0;
  const int n = left < kChunk ? (int)left : kChunk;
  int32_t my_b = 0;
  float my_den = 1.0f;
  if (lane < n) {
    my_b = rows[s0 + lane];
    const int c = cnt[my_b];
    my_den = (float)(c > 1 ? c : 1);
  }
  const int ncol = V == 4 ? D / 4 : D;
  for (int c0 = 0; c0 < ncol; c0 += 32) {
    const int col = c0 + lane;
    const bool mine = col < ncol;
    float acc[V] = {};
    add_slots<V, T>(g, D, col, mine, n, my_b, my_den, 0, false, nullptr,
                    acc);
    if (mine) store_row<V>(acc, partials + i * D + (int64_t)col * V);
  }
  __threadfence();  // the partial is visible before the ticket is taken
  __syncwarp();
  int ticket = 0;
  if (lane == 0) ticket = atomicAdd(tickets + base, 1);
  if (__shfl_sync(kFull, ticket, 0) != units - 1) return;
  __threadfence();
  for (int c0 = 0; c0 < ncol; c0 += 32) {
    const int col = c0 + lane;
    const bool mine = col < ncol;
    float acc[V] = {};
    for (int64_t k0 = 0; k0 < units; k0 += kFlight) {
      float v[kFlight][V];
#pragma unroll
      for (int s = 0; s < kFlight; ++s) {
#pragma unroll
        for (int e = 0; e < V; ++e) v[s][e] = 0.0f;
        if (k0 + s < units && mine)
          load_partial<V>(partials + (base + k0 + s) * D + (int64_t)col * V,
                          v[s]);
      }
#pragma unroll
      for (int s = 0; s < kFlight; ++s) {
        if (k0 + s >= units) break;
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] += v[s][e];
      }
    }
    if (mine) store_row<V>(acc, grad_x + u * D + (int64_t)col * V);
  }
}

// Blocks below ``heavy_blocks`` walk the chunk units; the others own 32
// ids a warp.
template <int V, typename T>
__global__ void __launch_bounds__(kThreads)
neighbor_agg_bwd_kernel(const float* __restrict__ g,
                        const int32_t* __restrict__ cnt,
                        const int64_t* __restrict__ rowptr,
                        const int32_t* __restrict__ rows,
                        const int64_t* __restrict__ hptr,
                        const int32_t* __restrict__ hunit,
                        float* __restrict__ partials,
                        int32_t* __restrict__ tickets,
                        T* __restrict__ grad_x, int64_t N, int D,
                        int heavy_blocks) {
  const int warp = threadIdx.x >> 5;
  if ((int)blockIdx.x < heavy_blocks) {
    const int64_t units = hptr[N];
    for (int64_t i = (int64_t)blockIdx.x * kWarps + warp; i < units;
         i += (int64_t)heavy_blocks * kWarps)
      heavy_unit<V>(g, cnt, rowptr, rows, hptr, hunit, partials, tickets,
                    grad_x, D, i);
    return;
  }
  const int64_t u0 =
      ((int64_t)(blockIdx.x - heavy_blocks) * kWarps + warp) * kIds;
  if (u0 < N) light_ids<V>(g, cnt, rowptr, rows, grad_x, N, D, u0);
}

// Dynamic shared memory of the forward: the block's means (kRows rows of
// stride D | 1) and one w tile.
size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)kRows * (D | 1) + (size_t)kDC * kFC);
}

template <typename T, typename W>
cudaError_t launch_fwd(const void* x, const int32_t* nbrs, const void* w,
                       void* out, float* mean_out, int64_t B, int K, int D,
                       int F, int vec, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  auto kernel = neighbor_agg_kernel<T, W>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int64_t blocks = (B + kRows - 1) / kRows;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), nbrs, static_cast<const W*>(w),
      static_cast<T*>(out), mean_out, B, K, D, F, vec);
  return cudaGetLastError();
}


template <int V, typename T>
cudaError_t launch_bwd(const float* g, const int32_t* cnt,
                       const int64_t* rowptr, const int32_t* rows,
                       const int64_t* hptr, const int32_t* hunit,
                       float* partials, int32_t* tickets, int64_t cap,
                       void* grad_x, int64_t N, int D, cudaStream_t stream) {
  int heavy_blocks = 0;
  if (cap > 0) {
    cudaError_t err =
        cudaMemsetAsync(tickets, 0, sizeof(int32_t) * cap, stream);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    // at most two blocks a streaming multiprocessor: the units' count is
    // on the device, and a block past it returns at once
    const int64_t want = (cap + kWarps - 1) / kWarps;
    heavy_blocks = (int)(want < 2 * sms ? want : 2 * sms);
  }
  const int64_t light = (N + kIds * kWarps - 1) / (kIds * kWarps);
  neighbor_agg_bwd_kernel<V, T>
      <<<(unsigned)(heavy_blocks + light), kThreads, 0, stream>>>(
          g, cnt, rowptr, rows, hptr, hunit, partials, tickets,
          static_cast<T*>(grad_x), N, D, heavy_blocks);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points; the PyTorch binding (hype_score/csrc/binding.cpp)
// checks the arguments, allocates the outputs and passes the current
// stream. ``x_bf16`` and ``w_bf16`` pick the element types (0: float32,
// 1: bfloat16); ``vec`` says that every row of x starts 16-byte aligned
// (the binding checks the pointer and D * itemsize); ``mean_out`` may be
// null.
extern "C" size_t neighbor_agg_smem_bytes(int D) { return smem_bytes(D); }

extern "C" cudaError_t neighbor_agg_launch(const void* x, const int32_t* nbrs,
                                           const void* w, void* out,
                                           float* mean_out, int64_t B, int K,
                                           int D, int F, int x_bf16,
                                           int w_bf16, int vec,
                                           cudaStream_t stream) {
  if (x_bf16 && w_bf16)
    return launch_fwd<__nv_bfloat16, __nv_bfloat16>(x, nbrs, w, out, mean_out,
                                                    B, K, D, F, vec, stream);
  if (x_bf16)
    return launch_fwd<__nv_bfloat16, float>(x, nbrs, w, out, mean_out, B, K,
                                            D, F, vec, stream);
  if (w_bf16)
    return launch_fwd<float, __nv_bfloat16>(x, nbrs, w, out, mean_out, B, K,
                                            D, F, vec, stream);
  return launch_fwd<float, float>(x, nbrs, w, out, mean_out, B, K, D, F, vec,
                                  stream);
}

// ``vec`` says that D is a multiple of 4 and g is 16-byte aligned.
// ``partials`` (cap x D float32) and ``tickets`` (cap int32) are scratch
// for the chunk units, ``cap`` the length of ``hunit``; the tickets are
// zeroed here, on the stream, before the launch.
extern "C" cudaError_t neighbor_agg_bwd_launch(
    const float* g, const int32_t* cnt, const int64_t* rowptr,
    const int32_t* rows, const int64_t* hptr, const int32_t* hunit,
    float* partials, int32_t* tickets, int64_t cap, void* grad_x, int64_t N,
    int D, int out_bf16, int vec, cudaStream_t stream) {
  if (out_bf16 && vec)
    return launch_bwd<4, __nv_bfloat16>(g, cnt, rowptr, rows, hptr, hunit,
                                        partials, tickets, cap, grad_x, N, D,
                                        stream);
  if (out_bf16)
    return launch_bwd<1, __nv_bfloat16>(g, cnt, rowptr, rows, hptr, hunit,
                                        partials, tickets, cap, grad_x, N, D,
                                        stream);
  if (vec)
    return launch_bwd<4, float>(g, cnt, rowptr, rows, hptr, hunit, partials,
                                tickets, cap, grad_x, N, D, stream);
  return launch_bwd<1, float>(g, cnt, rowptr, rows, hptr, hunit, partials,
                              tickets, cap, grad_x, N, D, stream);
}
