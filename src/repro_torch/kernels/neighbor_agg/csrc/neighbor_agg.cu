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
// output agrees within float32 rounding. A row with no valid slot skips
// the product and writes zeros: the same +0 as 0 @ w for a finite w (the
// plain version's 0 @ w is NaN where a column of w is not finite). On
// request the kernel also writes the float32 mean, which the backward's
// grad_w needs, so the backward does not gather again.
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
// The same kernel is the EmbeddingBag's table gradient (no TPU backward
// either: the JAX model differentiates jnp.take), with the bags as rows
// and the table rows as ids: the mean mode for a bag's mean, and for a
// bag's sum the sum mode, a null cnt, which leaves out the division.
// The caller's transposed index gives ``rows``, the b of every valid
// slot sorted stably by id, ``rowptr`` over the N + 1 ids, and the chunk
// units of the ids with more than kChunk slots (``hptr``, ``hunit``).
// A hub id of a power-law batch names thousands of slots, and one warp
// walking them in order took 0.29 ms on the H100 at the GraphSAGE layer,
// so a call is one launch (after a memset of the tickets) whose blocks
// split the ids:
//   * heavy blocks (at most 3/4 of the card's resident blocks): every chunk
//     of a heavy id is a unit of its own, and the warps take units in
//     order from a counter, so the hub's units start at once and a warp
//     busy with a long tail takes fewer. A warp sums its chunk into a
//     float32 scratch row, then takes a ticket (an integer atomic on the
//     id's counter); the warp that draws the last ticket adds the id's
//     partials in chunk order and writes its row. A long tail (16
//     partials or more, D <= 256) streams through the block's ring in
//     shared memory: flat bulk copies of 8 KB stages, two in flight while
//     the warp adds one, each column's sum still one chain from partial
//     0 (8 partials a round trip would cost the two-tower hub's 8,199,
//     D = 256, about 1.9 ms; PERF.md, row 4b);
//   * light blocks: a warp owns kIds = 4 consecutive ids, lane t holding
//     id t's slot range (8, 16 and 32 ran slower at every shape timed: a
//     warp's walk is serial). The ids without a slot come in runs of
//     consecutive rows, each zeroed as one stretch with 16-byte stores;
//     a warp scan packs the light ids' slots into one list, whose 32-slot
//     batches the lanes load at once, and the warp walks it with kFlight
//     rows of g in flight, lanes over D, writing each id's row after its
//     last slot.
// Every id's row is written once. Offsets are 64-bit. What bounds the
// backward: bytes, the gathered rows of g and the N x D output (87 MB at
// the GraphSAGE layer, most rows zeros: 0.029 ms at 3.35 TB/s; at the
// two-tower training shape, 262,144 bags of 8 over 2,097,152 rows of 256,
// 2.15 GB of output and 1.5 GB of gathered rows, 1.1 ms).
//
// Row 5d (the CSR front end of the forward, no TPU kernel of its own): the
// heavy pass over the rows' CSR (rows as ids, x as g, no division) writes
// the mean of each row of more than kChunk slots, divided once by its
// count; then the tile kernel (see its comment) sums the other rows in
// slot order, divides them, and multiplies every 64-row tile by w on the
// tensor cores. At the ogb_products layer (2,449,408 rows, 61.9M slots,
// D = F = 128) the bound is the 31.7 GB of x rows the slots name at
// random (x is 1.25 GB, L2 50 MB) plus the mean and the output, 10.2 ms
// at 3.35 TB/s with no reuse; the means never make a round trip through
// device memory before the product.
//
// What bounds the forward on the H100: bytes. At the GraphSAGE layer
// (B = N = 169,984, K = 25, D = F = 128, float32 x, bfloat16 w) the
// gather reads the named rows (about 77 MB), the output and the kept
// mean are 87 MB each, most of them zeros: about 0.07 ms. Only the 14k
// rows with a valid slot, scattered over the batch, need the product,
// 0.5 GFLOP: 0.008 ms on the float32 CUDA cores (not on tensor cores:
// TF32 would break the float32 tolerance). On the train launcher's batch
// (K = 1,340, nearly all pad slots) the ids alone are 911 MB. The TPU
// kernel walks a sequential (row, slot) grid with a VMEM accumulator and
// feeds each row's mean to the MXU. Here, in persistent blocks of 8
// warps (two an SM) that share nothing but w (widened to float32 in
// shared memory once per block, or read from global memory where it
// does not fit), each warp walks sets of rows on its own, with no block
// barrier:
//   * compacted slots: a set is 32 / sw rows whose ids the warp loads at
//     once, sw lanes a row and kIdLoads x 4 ids a lane (16-byte loads
//     where the rows allow; sw as small as the row's K allows: 8 rows of
//     K = 25 at once). A set's rows are strided by the number of sets, so
//     that a run of live rows (a sampled batch's seeds and first hop
//     come first) spreads over the warps. Three ballots of each lane's
//     valid count give every valid id its place in slot order in the
//     row's list in shared memory, so a pad costs a compare, not a round
//     trip. The next set's (or span's) ids are loaded while this one is
//     walked;
//   * a row without a valid slot writes its zeros for out and the mean
//     with 16-byte stores, before the set's live rows are walked;
//   * rows in flight: lpr lanes take a live row's list (a half-warp where
//     a row is at most 16 vectors, as bfloat16 at D = 128, so two rows
//     share the warp's loads; else the warp), lanes over D with 16-byte
//     loads, kFlightX rows of x in flight per lane, added in order. A
//     row wider than the lanes takes passes of lpr vectors, one row a
//     set;
//   * a live row's mean goes to the warp's next place (kPlaces of them,
//     fewer for a wide D), and when the places may not hold the next
//     rows the warp multiplies them by w on the CUDA cores: lane l owns
//     columns 4l .. 4l + 3 of a 128-column pass, a places x 4 register
//     tile fed by 16-byte shared loads (the means broadcast, w
//     conflict-free), up to 64 FMAs to 8 shared loads.
// The sizes were tuned on the H100 at the layer: 16 rows of x in flight
// or 8 places spill registers at two blocks an SM and ran slower; 4 id
// loads a lane ran slower at the layer, faster on the launcher's batch.
// Every row offset is 64-bit (N * D may pass 2**31).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../mbarrier.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPlaces = 4;      // live rows a warp's product takes, at most
constexpr int kColTile = 128;   // output columns a product pass (4 a lane)
constexpr int kFlightX = 8;     // rows of x in flight per lane (fwd)
constexpr int kIdLoads = 2;     // id loads in flight per lane, 4 ids each
constexpr int kBufPerWarp = 32 * 4 * kIdLoads;  // compacted ids a warp
constexpr size_t kWarpsBudget = 96 * 1024;     // the warps' buffers, at most
constexpr size_t kBlockBudget = 110 * 1024;    // two blocks an SM
constexpr int kChunk = 32;    // slots per chunk (bwd; ref.py's CHUNK)
constexpr int kFlight = 8;    // rows in flight per lane (the chunk sums)
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
template <typename T>
__device__ __forceinline__ T zero_of() {
  if constexpr (sizeof(T) == 4) {
    return 0.0f;
  } else {
    return __ushort_as_bfloat16(0);
  }
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

// bfloat16 -> float32 is exact: the 16 bits become the high half
__device__ __forceinline__ void widen2(uint32_t w, float* v) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}

// One 16-byte vector of float32 (the backward's rows of g).
__device__ __forceinline__ void load_vec(const float* src, float* v) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(src));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// V elements of a row of x, loaded raw (kept in flight as loaded) and
// added into a float32 accumulator: V = 16 / sizeof(T) (one 16-byte
// load), or 1 where the rows are not 16-byte aligned.
template <typename T, int V>
struct XLoad {  // V == 1
  using Raw = T;
  static __device__ __forceinline__ Raw load(const T* p) { return __ldg(p); }
  static __device__ __forceinline__ void add(Raw q, float* acc) {
    acc[0] += widen(q);
  }
};
template <>
struct XLoad<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void add(Raw q, float* acc) {
    acc[0] += q.x;
    acc[1] += q.y;
    acc[2] += q.z;
    acc[3] += q.w;
  }
};
template <>
struct XLoad<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void add(Raw q, float* acc) {
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v[2];
      widen2(w[i], v);
      acc[2 * i] += v[0];
      acc[2 * i + 1] += v[1];
    }
  }
};

// Four consecutive elements of w in shared memory (16-byte aligned).
__device__ __forceinline__ void w4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// The forward's shared-memory plan: w resident (ld x wld float32, ld = D
// and wld = F rounded up to 4, zero past them) when it fits beside the
// warps' buffers, else read from global memory; per warp
// ``places`` rows of means awaiting the product (ld floats each), the
// compacted-id list, the rows' list lengths and the places' rows;
// ``smem`` dynamic bytes in all.
struct FwdPlan {
  int ld, wld, resident, places;
  size_t warp_bytes, smem;
};

size_t warp_bytes(int places, int ld) {
  return sizeof(float) * places * ld +
         sizeof(int32_t) * (kBufPerWarp + 32 + kPlaces);
}

FwdPlan fwd_plan(int D, int F) {
  FwdPlan p;
  p.ld = (D + 3) & ~3;
  p.wld = (F + 3) & ~3;
  const size_t w_bytes = sizeof(float) * p.ld * p.wld;
  // w resident with as many places as fit two blocks an SM, else w from
  // global memory and as many places as the warps' budget holds
  p.places = kPlaces;
  while (p.places > 1 &&
         kWarps * warp_bytes(p.places, p.ld) + w_bytes > kBlockBudget)
    --p.places;
  p.resident = kWarps * warp_bytes(p.places, p.ld) + w_bytes <= kBlockBudget;
  if (!p.resident) {
    p.places = kPlaces;
    while (p.places > 1 &&
           kWarps * warp_bytes(p.places, p.ld) > kWarpsBudget)
      --p.places;
  }
  p.warp_bytes = warp_bytes(p.places, p.ld);
  p.smem = kWarps * p.warp_bytes + (p.resident ? w_bytes : 0);
  return p;
}

// The product of a warp's p <= kPlaces pending means (pm, row stride ld)
// with w, into their rows of out: lane l owns columns f0 + 4l .. + 3 of
// each 128-column pass, a p x 4 register tile; w from shared memory
// (kResident: zero-padded, row stride wld) or from global memory.
template <bool kResident, typename T, typename W>
__device__ void product(const float* pm, const int* prow, int p,
                        const W* __restrict__ w, const float* w_s, int wld,
                        T* __restrict__ out, int D, int F, int ld) {
  const int lane = threadIdx.x & 31;
  for (int f0 = 0; f0 < F; f0 += kColTile) {
    const int f = f0 + 4 * lane;
    if (f >= F) continue;
    float acc[kPlaces][4];
#pragma unroll
    for (int i = 0; i < kPlaces; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
    for (int d = 0; d < ld; d += 4) {
      float wv[4][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (kResident) {
          w4(w_s + (size_t)(d + e) * wld + f, wv[e]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            wv[e][c] = d + e < D && f + c < F
                           ? widen(__ldg(w + (int64_t)(d + e) * F + f + c))
                           : 0.0f;
        }
      }
#pragma unroll
      for (int i = 0; i < kPlaces; ++i) {
        if (i >= p) break;
        const float4 a = *reinterpret_cast<const float4*>(pm + i * ld + d);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[i][c] += a.x * wv[0][c];
          acc[i][c] += a.y * wv[1][c];
          acc[i][c] += a.z * wv[2][c];
          acc[i][c] += a.w * wv[3][c];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kPlaces; ++i) {
      if (i >= p) break;
      T* dst = out + (int64_t)prow[i] * F + f;
      if ((F & 3) == 0) {
        store4(acc[i], dst);  // F % 4 == 0: aligned
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (f + c < F) narrow(acc[i][c], dst + c);
      }
    }
  }
}

// w (D, F) widened to float32 into shared memory (ld x wld, zero past D
// and F), by the whole block: with F % 4 == 0 the rows are wld = F wide
// and w is read as it lies, 16 bytes a thread. The caller syncs.
template <typename W>
__device__ void stage_w(const W* __restrict__ w, float* w_s, int D, int F,
                        int ld, int wld) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  using XW = XLoad<W, 16 / sizeof(W)>;
  constexpr int WV = 16 / sizeof(W);
  if ((F & 3) == 0 && (D * F) % WV == 0 &&
      reinterpret_cast<uintptr_t>(w) % 16 == 0) {
    for (int i = threadIdx.x; i < D * F / WV; i += kThreads) {
      float v[WV];
#pragma unroll
      for (int e = 0; e < WV; ++e) v[e] = 0.0f;
      XW::add(XW::load(w + i * WV), v);
#pragma unroll
      for (int e = 0; e < WV; e += 4) store4(v + e, w_s + i * WV + e);
    }
    for (int i = D * F + threadIdx.x; i < ld * wld; i += kThreads)
      w_s[i] = 0.0f;
  } else {
    for (int d = warp; d < ld; d += kWarps)
      for (int f = lane; f < wld; f += 32)
        w_s[d * wld + f] =
            d < D && f < F ? widen(w[(int64_t)d * F + f]) : 0.0f;
  }
}

// id_vec: every row of nbrs starts 16-byte aligned (K % 4 == 0);
// out_vec: every row of out does (F * sizeof(T) % 16 == 0).
template <typename T, typename W, int V>
__global__ void __launch_bounds__(kThreads, 2)
neighbor_agg_kernel(const T* __restrict__ x, const int32_t* __restrict__ nbrs,
                    const W* __restrict__ w, T* __restrict__ out,
                    float* __restrict__ mean_out, int64_t B, int K, int D,
                    int F, int id_vec, int out_vec, int ld, int wld,
                    int resident, int places, int warp_stride) {
  using XL = XLoad<T, V>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* w_s = reinterpret_cast<float*>(smem_raw);
  unsigned char* mine = smem_raw +
                        (resident ? sizeof(float) * (size_t)ld * wld : 0) +
                        (size_t)warp * warp_stride;
  float* pm = reinterpret_cast<float*>(mine);            // places x ld
  int32_t* buf = reinterpret_cast<int32_t*>(pm + places * ld);
  int32_t* n_s = buf + kBufPerWarp;                      // list lengths
  int32_t* prow = n_s + 32;                              // places' rows
  if (resident) {
    stage_w(w, w_s, D, F, ld, wld);
    __syncthreads();  // the kernel's only barrier: warps run on their own
  }

  // gather lanes: lpr a row (a half-warp where a row is at most 16
  // vectors), gpw rows at once; a row is one pass over its columns when
  // they fit the lanes, else passes of lpr columns
  const int ncols = V > 1 ? D / V : ld;
  const int lpr = V > 1 && ncols <= 16 ? 16 : 32;
  const int gpw = 32 / lpr;
  const int glane = lane & (lpr - 1);
  const int ggroup = lane / lpr;
  const int npass = ncols > lpr ? (ncols + lpr - 1) / lpr : 1;
  // scan lanes: sw a row, so that a set of 32 / sw rows is loaded at once
  // (one row a set when a row takes several passes)
  int sw = 32;
  if (npass == 1)
    while (sw > 1 && (sw / 2) * 4 * kIdLoads >= K) sw >>= 1;
  const int rs = 32 / sw;
  const int span = sw * 4 * kIdLoads;  // slots a scan group loads at once
  const int nbatch = K > span ? (K + span - 1) / span : 1;
  const int sgroup = lane / sw;
  const unsigned smask = sw == 32 ? kFull : ((1u << sw) - 1) << (sgroup * sw);
  const unsigned slower = smask & ((1u << lane) - 1);
  // row indices fit 32 bits (the binding checks B < 2**31); offsets are
  // 64-bit where they are used
  const int nsets = (int)((B + rs - 1) / rs);
  const int warps = gridDim.x * kWarps;

  // a set's rows are set, set + nsets, set + 2 nsets, ...: a run of live
  // rows (a batch's seeds come first) spreads over the warps. A lane
  // loads slots (t * sw + its lane of the group) * 4 + 0..3 of its group's
  // row, t < kIdLoads, in the span ``batch``
  auto load_ids = [&](int4* q, int set, int batch) {
    const int b = sgroup * nsets + set;
#pragma unroll
    for (int t = 0; t < kIdLoads; ++t) {
      const int j = batch * span + (t * sw + (lane & (sw - 1))) * 4;
      q[t] = make_int4(-1, -1, -1, -1);
      if (b < B && j < K) {
        const int32_t* p = nbrs + (int64_t)b * K + j;
        if (id_vec) {
          q[t] = __ldg(reinterpret_cast<const int4*>(p));
        } else {
          q[t].x = __ldg(p);
          if (j + 1 < K) q[t].y = __ldg(p + 1);
          if (j + 2 < K) q[t].z = __ldg(p + 2);
          if (j + 3 < K) q[t].w = __ldg(p + 3);
        }
      }
    }
  };

  // a live row's mean into the warp's next place (the order of places
  // changes nothing), and the product once the places may not hold the
  // next rows; called by the whole warp, ``has``: this group has a row
  float acc[V];
  int cnt = 0, place = -1, pending = 0;
  auto finish_live = [&](bool has, int b, int pass, int col) {
    if (pass == 0) {
      const unsigned lead = __ballot_sync(kFull, glane == 0 && has);
      place = has ? pending + __popc(lead & ((1u << (ggroup * lpr)) - 1))
                  : -1;
      pending += __popc(lead);
      if (glane == 0 && has) prow[place] = b;
    }
    if (has && col < ncols) {
      const float denom = (float)(cnt > 1 ? cnt : 1);
      float m[V];
#pragma unroll
      for (int e = 0; e < V; ++e) m[e] = acc[e] / denom;
      if constexpr (V == 1) {
        pm[place * ld + col] = m[0];
        if (mean_out && col < D) mean_out[(int64_t)b * D + col] = m[0];
      } else {
#pragma unroll
        for (int e = 0; e < V; e += 4) {
          store4(m + e, pm + place * ld + col * V + e);
          if (mean_out)
            store4(m + e, mean_out + (int64_t)b * D + col * V + e);
        }
      }
    }
    if (pass == npass - 1 && pending + gpw > places) {
      __syncwarp();
      if (resident)
        product<true>(pm, prow, pending, w, w_s, wld, out, D, F, ld);
      else
        product<false>(pm, prow, pending, w, w_s, wld, out, D, F, ld);
      __syncwarp();
      pending = 0;
    }
  };

  // the rows of a set in ``dead`` (bit i: row i * nsets + set) have no
  // valid slot: their zeros for out and the mean, 16 bytes a lane
  auto zero_rows = [&](unsigned dead, int set) {
    for (unsigned m = dead; m; m &= m - 1) {
      const int b = (__ffs(m) - 1) * nsets + set;
      T* dst = out + (int64_t)b * F;
      constexpr int OV = 16 / sizeof(T);
      if (out_vec) {
        for (int f = lane * OV; f < F; f += 32 * OV)
          *reinterpret_cast<uint4*>(dst + f) = make_uint4(0, 0, 0, 0);
      } else {
        for (int f = lane; f < F; f += 32) dst[f] = zero_of<T>();
      }
      if (mean_out) {
        float* md = mean_out + (int64_t)b * D;
        if ((D & 3) == 0) {
          for (int d = lane * 4; d < D; d += 128)
            *reinterpret_cast<float4*>(md + d) =
                make_float4(0.f, 0.f, 0.f, 0.f);
        } else {
          for (int d = lane; d < D; d += 32) md[d] = 0.0f;
        }
      }
    }
  };

  int set = blockIdx.x * kWarps + warp;
  int pass = 0, batch = 0;
  int4 q[kIdLoads];
  if (set < nsets) load_ids(q, set, batch);
  while (set < nsets) {
    // each row's valid ids in slot order (load t, lane, component) into
    // its list: three ballots of each lane's count (0..4) give the count
    // of the group's lanes below
    int n = 0;
#pragma unroll
    for (int t = 0; t < kIdLoads; ++t) {
      const int c = (q[t].x >= 0) + (q[t].y >= 0) + (q[t].z >= 0) +
                    (q[t].w >= 0);
      const unsigned b0 = __ballot_sync(kFull, c & 1);
      const unsigned b1 = __ballot_sync(kFull, c & 2);
      const unsigned b2 = __ballot_sync(kFull, c & 4);
      int at = sgroup * span + n + __popc(b0 & slower) +
               2 * __popc(b1 & slower) + 4 * __popc(b2 & slower);
      if (q[t].x >= 0) buf[at++] = q[t].x;
      if (q[t].y >= 0) buf[at++] = q[t].y;
      if (q[t].z >= 0) buf[at++] = q[t].z;
      if (q[t].w >= 0) buf[at] = q[t].w;
      n += __popc(b0 & smask) + 2 * __popc(b1 & smask) +
           4 * __popc(b2 & smask);
    }
    if ((lane & (sw - 1)) == 0) n_s[sgroup] = n;
    __syncwarp();

    // the next (set, pass, batch): its ids in flight during this walk
    int nset = set;
    int npass_ = pass, nbatch_ = batch + 1;
    if (nbatch_ == nbatch) {
      nbatch_ = 0;
      if (++npass_ == npass) {
        npass_ = 0;
        nset += warps;
      }
    }
    if (nset < nsets) load_ids(q, nset, nbatch_);

    const int rows = (int)((B - set + nsets - 1) / nsets) < rs
                         ? (int)((B - set + nsets - 1) / nsets)
                         : rs;  // rows i * nsets + set < B, a prefix of i
    const int col = pass * lpr + glane;
    const bool last = batch == nbatch - 1;
    if (rs == 1 && batch == 0) {  // one row a set: summed over its spans
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = 0.0f;
      cnt = 0;
    }
    // the rows with slots in this span, gpw at a time (a set of several
    // rows is one span, so each is a whole live row); dead rows cost
    // nothing here
    const unsigned with = __ballot_sync(kFull, lane < rows && n_s[lane] > 0);
    // several rows a set: one span, so a row without slots is dead; its
    // stores go out before the walk waits on the gathers
    if (rs > 1)
      zero_rows(~with & (rows == 32 ? kFull : (1u << rows) - 1), set);
    for (unsigned todo = with; todo;) {
      int i = -1;
      for (int g = 0; g < gpw && todo; ++g, todo &= todo - 1)
        if (g == ggroup) i = __ffs(todo) - 1;
      const bool has = i >= 0;
      const bool load_col = has && col < ncols && (V > 1 || col < D);
      if (rs > 1) {
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = 0.0f;
        cnt = 0;
      }
      const int len = has ? n_s[i] : 0;
      const int32_t* lst = buf + i * span;
      // kFlightX rows of x in flight, added in slot order
      for (int s0 = 0; __any_sync(kFull, s0 < len); s0 += kFlightX) {
        typename XL::Raw v[kFlightX];
#pragma unroll
        for (int k = 0; k < kFlightX; ++k)
          if (s0 + k < len && load_col)
            v[k] = XL::load(x + (int64_t)lst[s0 + k] * D + (int64_t)col * V);
#pragma unroll
        for (int k = 0; k < kFlightX; ++k)
          if (s0 + k < len && load_col) XL::add(v[k], acc);
      }
      cnt += len;
      if (rs > 1) finish_live(has, i * nsets + set, pass, col);
    }
    if (rs == 1 && last) {  // one row a set, summed over its spans
      const bool live = __shfl_sync(kFull, cnt, 0) > 0;
      if (live) finish_live(ggroup == 0, set, pass, col);
      if (!live && pass == 0) zero_rows(1u, set);
    }
    __syncwarp();  // the lists are read before the next span fills them
    set = nset;
    pass = npass_;
    batch = nbatch_;
  }
  if (pending > 0) {
    __syncwarp();
    if (resident)
      product<true>(pm, prow, pending, w, w_s, wld, out, D, F, ld);
    else
      product<false>(pm, prow, pending, w, w_s, wld, out, D, F, ld);
  }
}

// ---- the chunk sums: row 5b's backward, rows 4b and 5c, and row 5d's
// heavy rows. V floats per lane: 4 (16-byte loads) or 1.

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

// n zero elements from dst, by the warp: 16-byte stores where V == 4
// (dst then 8-byte aligned: an 8-byte head and tail where needed).
template <int V, typename T>
__device__ __forceinline__ void zero_span(T* dst, int64_t n) {
  const int lane = threadIdx.x & 31;
  if constexpr (V == 4) {
    char* p = reinterpret_cast<char*>(dst);
    int64_t bytes = n * (int64_t)sizeof(T);
    if (reinterpret_cast<uintptr_t>(p) & 15) {
      if (lane == 0) *reinterpret_cast<uint2*>(p) = make_uint2(0, 0);
      p += 8;
      bytes -= 8;
    }
    uint4* q = reinterpret_cast<uint4*>(p);
    const int64_t n16 = bytes >> 4;
    for (int64_t i = lane; i < n16; i += 32) q[i] = make_uint4(0, 0, 0, 0);
    if ((bytes & 15) && lane == 0)
      *reinterpret_cast<uint2*>(p + (n16 << 4)) = make_uint2(0, 0);
  } else {
    for (int64_t i = lane; i < n; i += 32) dst[i] = zero_of<T>();
  }
}

// Adds slots s0 .. s0 + n - 1 (n <= 32) of the lanes' list into acc, in
// order, kFlight rows in flight: lane s holds slot s's row b, its divisor, its
// owner t and whether the slot is its owner's last; after an owner's last
// slot the warp hands acc to sink(t, acc) and restarts from 0. Without
// kDiv (the sum mode) no slot is divided: x / 1.0f is x, and the IEEE
// division costs a dozen instructions a value.
template <int V, bool kDiv, typename Sink>
__device__ __forceinline__ void add_slots(const float* __restrict__ g, int D,
                                          int col, bool mine, int n,
                                          int32_t my_b, float my_den,
                                          int my_t, bool my_last,
                                          Sink&& sink, float (&acc)[V]) {
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
      for (int i = 0; i < V; ++i)
        acc[i] += kDiv ? v[s][i] / den[s] : v[s][i];
      if (last) {
        sink(t, acc);
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = 0.0f;
      }
    }
  }
}

// The light ids of one warp: lane t holds id t's first slot ``lo`` and its
// slot count ``nl`` (at most kChunk; 0: an id the walk skips). Each id's
// slots rows[lo .. lo + nl) are added in order from 0 (g[b] / cnt[b], or
// g[b] without kDiv), lanes over the columns, and sink(t, col, mine,
// acc) takes id t's sum after its last slot. A warp scan packs the ids'
// slots into one list, whose 32-slot batches the lanes load at once (a
// slot's b and divisor a lane); the walk keeps kFlight rows of g in
// flight.
template <int V, bool kDiv, typename Sink>
__device__ __forceinline__ void light_walk(const float* __restrict__ g,
                                           const int32_t* __restrict__ cnt,
                                           const int32_t* __restrict__ rows,
                                           int D, int64_t lo, int nl,
                                           Sink&& sink) {
  const int lane = threadIdx.x & 31;
  int off = nl;  // inclusive scan of nl over the lanes, then exclusive
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, off, o);
    if (lane >= o) off += y;
  }
  const int total = __shfl_sync(kFull, off, 31);
  off -= nl;
  if (total == 0) return;
  const int ncol = V == 4 ? D / 4 : D;
  for (int c0 = 0; c0 < ncol; c0 += 32) {
    const int col = c0 + lane;
    const bool mine = col < ncol;
    float acc[V] = {};
    // lane l's slot of the batch from qb: its row b (loaded), its owner t
    // and whether it is t's last slot; the next batch's b is loaded while
    // this one is added
    auto locate = [&](int qb, int32_t& b, int& t, bool& last) {
      // packed slot q = qb + l, owned by the last lane t with off_t <= q
      // (off does not decrease over the lanes)
      const int q = qb + lane;
      t = 0;
#pragma unroll
      for (int step = 16; step > 0; step >>= 1)
        if (__shfl_sync(kFull, off, t + step) <= q) t += step;
      const int64_t lo_t = __shfl_sync(kFull, lo, t);
      const int off_t = __shfl_sync(kFull, off, t);
      const int nl_t = __shfl_sync(kFull, nl, t);
      b = q < total ? rows[lo_t + (q - off_t)] : 0;
      last = q == off_t + nl_t - 1;
    };
    int32_t nb;
    int nt;
    bool nlast;
    locate(0, nb, nt, nlast);
    for (int qb = 0; qb < total; qb += 32) {
      const int32_t my_b = nb;
      const int my_t = nt;
      const bool my_last = nlast;
      if (qb + 32 < total) locate(qb + 32, nb, nt, nlast);
      float my_den = 1.0f;
      if (kDiv && qb + lane < total) {
        const int c = cnt[my_b];
        my_den = (float)(c > 1 ? c : 1);
      }
      add_slots<V, kDiv>(
          g, D, col, mine, total - qb < 32 ? total - qb : 32, my_b, my_den,
          my_t, my_last,
          [&](int owner, const float (&a)[V]) { sink(owner, col, mine, a); },
          acc);
    }
  }
}

// The heavy pass's ring for the ordered tails: kRingStages stages of
// kStageBytes in shared memory, one barrier each, filled by flat bulk
// copies that one lane issues. One warp of the block holds it at a time
// (``lock``); ``phase`` keeps each barrier's parity between holders.
constexpr int kRingStages = 3;
constexpr int kStageBytes = 8 * 1024;
constexpr int kRingMaxD = 256;  // the ring's tails: D <= 256 (two vectors
                                // a lane), D % 4 == 0
constexpr int kRingMin = 16;    // and more than 16 partials
constexpr size_t kRingSmem =
    (size_t)kRingStages * kStageBytes + kRingStages * sizeof(uint64_t) + 16;

struct Ring {
  float* buf;
  uint64_t* bar;
  int* lock;
  unsigned* phase;
};

__device__ __forceinline__ Ring ring_of(unsigned char* smem) {
  Ring r;
  r.buf = reinterpret_cast<float*>(smem);
  r.bar = reinterpret_cast<uint64_t*>(smem + kRingStages * kStageBytes);
  r.lock = reinterpret_cast<int*>(r.bar + kRingStages);
  r.phase = reinterpret_cast<unsigned*>(r.lock + 1);
  return r;
}

// acc[c] += the rows p[0 .. units) (D floats each, D % 4 == 0, D <= 256)
// in order, lane l adding columns 4 (l + 32 c) .. + 3. The rows are
// contiguous, so each stage is one bulk copy of ``per`` rows; a stage is
// refilled as soon as the warp has added it, so kRingStages - 1 stages
// (16 KB) stay in flight while the warp adds one. Every column's sum stays
// one chain from row 0, the order of the register loop it replaces.
__device__ void ring_tail(const Ring& r, const float* __restrict__ p,
                          int64_t units, int D, float (&acc)[2][4]) {
  const int lane = threadIdx.x & 31;
  const int ncol = D / 4;
  const int per = kStageBytes / (int)(sizeof(float) * D);
  const int64_t nstage = (units + per - 1) / per;
  unsigned phase = 0;
  if (lane == 0) {
    while (atomicCAS(r.lock, 0, 1) != 0) __nanosleep(128);
    __threadfence_block();
    phase = *reinterpret_cast<volatile unsigned*>(r.phase);
  }
  phase = __shfl_sync(kFull, phase, 0);
  auto issue = [&](int64_t k) {  // lane 0: stage k into its slot
    const int s = (int)(k % kRingStages);
    const int64_t left = units - k * per;
    const uint32_t bytes =
        (uint32_t)((left < per ? left : per) * D * sizeof(float));
    const uint32_t bar = smem_u32(r.bar + s);
    mbar_expect_tx(bar, bytes);
    bulk_load(smem_u32(r.buf) + s * kStageBytes, p + k * per * D, bytes,
              bar);
  };
  if (lane == 0) {
    // the partials (other warps' generic stores) before the copies
    asm volatile("fence.proxy.async;\n" ::: "memory");
    for (int64_t k = 0; k < nstage && k < kRingStages; ++k) issue(k);
  }
  for (int64_t k = 0; k < nstage; ++k) {
    const int s = (int)(k % kRingStages);
    mbar_wait(smem_u32(r.bar + s), (phase >> s) & 1u);
    phase ^= 1u << s;
    const int64_t left = units - k * per;
    const int n = (int)(left < per ? left : per);
    const float* st = r.buf + (size_t)s * (kStageBytes / sizeof(float));
    for (int i = 0; i < n; ++i) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = lane + 32 * c;
        if (col < ncol) {
          const float4 q =
              *reinterpret_cast<const float4*>(st + i * D + col * 4);
          acc[c][0] += q.x;
          acc[c][1] += q.y;
          acc[c][2] += q.z;
          acc[c][3] += q.w;
        }
      }
    }
    __syncwarp();  // the stage is read before it is refilled
    if (lane == 0 && k + kRingStages < nstage) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(k + kRingStages);
    }
  }
  if (lane == 0) {
    *reinterpret_cast<volatile unsigned*>(r.phase) = phase;
    __threadfence_block();
    atomicExch(r.lock, 0);
  }
  __syncwarp();
}

// Id u's finished sum (lanes' columns col): its row of out, or with kMean
// (row 5d's heavy rows) the row's mean, divided once by its slot count.
template <int V, typename T, bool kMean>
__device__ __forceinline__ void finish_heavy(const float* acc, T* out,
                                             int64_t u, float den, int D,
                                             int col) {
  if constexpr (kMean) {
    float m[V];
#pragma unroll
    for (int e = 0; e < V; ++e) m[e] = acc[e] / den;
    store_row<V>(m, out + u * D + (int64_t)col * V);
  } else {
    store_row<V>(acc, out + u * D + (int64_t)col * V);
  }
}

// Chunk unit i of a heavy id: its partial, then, for the warp that draws
// the id's last ticket, the sum of the id's partials in chunk order
// (through the ring when it is long, else kFlight rows in flight).
template <int V, typename T, bool kMean>
__device__ void heavy_unit(const float* __restrict__ g,
                           const int32_t* __restrict__ cnt,
                           const int64_t* __restrict__ rowptr,
                           const int32_t* __restrict__ rows,
                           const int64_t* __restrict__ hptr,
                           const int32_t* __restrict__ hunit,
                           float* __restrict__ partials,
                           int32_t* __restrict__ tickets, const Ring& ring,
                           T* __restrict__ out, int D, int64_t i) {
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
    if (cnt) {
      const int c = cnt[my_b];
      my_den = (float)(c > 1 ? c : 1);
    }
  }
  const int ncol = V == 4 ? D / 4 : D;
  for (int c0 = 0; c0 < ncol; c0 += 32) {
    const int col = c0 + lane;
    const bool mine = col < ncol;
    float acc[V] = {};
    if (cnt)
      add_slots<V, true>(g, D, col, mine, n, my_b, my_den, 0, false,
                         [](int, const float(&)[V]) {}, acc);
    else
      add_slots<V, false>(g, D, col, mine, n, my_b, my_den, 0, false,
                          [](int, const float(&)[V]) {}, acc);
    if (mine) store_row<V>(acc, partials + i * D + (int64_t)col * V);
  }
  __threadfence();  // the partial is visible before the ticket is taken
  __syncwarp();
  int ticket = 0;
  if (lane == 0) ticket = atomicAdd(tickets + base, 1);
  if (__shfl_sync(kFull, ticket, 0) != units - 1) return;
  __threadfence();
  const float den = (float)(rowptr[u + 1] - rowptr[u]);
  const float* p = partials + base * D;
  if constexpr (V == 4) {
    if (D <= kRingMaxD && units >= kRingMin) {
      float acc[2][4] = {};
      ring_tail(ring, p, units, D, acc);
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (lane + 32 * c < ncol)
          finish_heavy<V, T, kMean>(acc[c], out, u, den, D, lane + 32 * c);
      return;
    }
  }
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
          load_partial<V>(p + (k0 + s) * D + (int64_t)col * V, v[s]);
      }
#pragma unroll
      for (int s = 0; s < kFlight; ++s) {
        if (k0 + s >= units) break;
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] += v[s][e];
      }
    }
    if (mine) finish_heavy<V, T, kMean>(acc, out, u, den, D, col);
  }
}

// The light work of kIds consecutive ids (one warp), lane t holding id u0
// + t: the ids with no slot come in runs of consecutive rows, each zeroed
// as one contiguous stretch; the ids of 1 to kChunk slots go through
// light_walk; heavy ids are the heavy pass's.
template <int V, typename T>
__device__ void light_ids(const float* __restrict__ g,
                          const int32_t* __restrict__ cnt,
                          const int64_t* __restrict__ rowptr,
                          const int32_t* __restrict__ rows,
                          T* __restrict__ grad_x, int64_t N, int D,
                          int64_t u0) {
  const int lane = threadIdx.x & 31;
  const int64_t u = lane < kIds ? u0 + lane : N;
  int64_t lo = 0, hi = 0;
  if (u < N) {
    lo = rowptr[u];
    hi = rowptr[u + 1];
  }
  T* out = grad_x + u0 * D;
  for (unsigned m = __ballot_sync(kFull, u < N && hi == lo); m;) {
    const int a = __ffs(m) - 1;
    const unsigned from = ~(m >> a);
    const int len = from ? __ffs(from) - 1 : 32 - a;
    zero_span<V>(out + (int64_t)a * D, (int64_t)len * D);
    m &= ~((len == 32 ? kFull : (1u << len) - 1) << a);
  }
  const int nl = hi - lo <= kChunk ? (int)(hi - lo) : 0;
  auto sink = [&](int t, int col, bool mine, const float (&a)[V]) {
    if (mine) store_row<V>(a, out + (int64_t)t * D + (int64_t)col * V);
  };
  if (cnt)
    light_walk<V, true>(g, cnt, rows, D, lo, nl, sink);
  else
    light_walk<V, false>(g, cnt, rows, D, lo, nl, sink);
}

// Blocks below ``heavy_blocks`` take the heavy ids' chunk units in order
// from one counter (tickets[cap], zeroed with the tickets), so the hub's
// units start at once and a warp busy with a long tail takes fewer; the
// other blocks own kIds * kWarps consecutive ids each, the light work,
// beside them (none for row 5d, whose tile kernel takes its light rows).
// With V == 4 each block's ring sits in its dynamic shared memory. Four
// blocks an SM where light blocks share the launch (the light work wants
// warps), three for row 5d's heavy units alone (fewer spills).
template <int V, typename T, bool kMean>
__global__ void __launch_bounds__(kThreads, kMean ? 3 : 4)
neighbor_agg_bwd_kernel(const float* __restrict__ g,
                        const int32_t* __restrict__ cnt,
                        const int64_t* __restrict__ rowptr,
                        const int32_t* __restrict__ rows,
                        const int64_t* __restrict__ hptr,
                        const int32_t* __restrict__ hunit,
                        float* __restrict__ partials,
                        int32_t* __restrict__ tickets, int64_t cap,
                        T* __restrict__ out, int64_t N, int D,
                        int heavy_blocks) {
  extern __shared__ __align__(16) unsigned char heavy_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if ((int)blockIdx.x >= heavy_blocks) {
    const int64_t u0 =
        ((int64_t)(blockIdx.x - heavy_blocks) * kWarps + warp) * kIds;
    if (u0 < N) light_ids<V>(g, cnt, rowptr, rows, out, N, D, u0);
    return;
  }
  const int64_t units = hptr[N];
  if (units == 0) return;
  const Ring ring = ring_of(heavy_smem);
  if constexpr (V == 4) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kRingStages; ++s)
        mbar_init(smem_u32(ring.bar + s), 1);
      *ring.lock = 0;
      *ring.phase = 0;
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  for (;;) {
    int i = 0;
    if (lane == 0) i = atomicAdd(tickets + cap, 1);
    i = __shfl_sync(kFull, i, 0);
    if (i >= units) break;
    heavy_unit<V, T, kMean>(g, cnt, rowptr, rows, hptr, hunit, partials,
                            tickets, ring, out, D, i);
  }
}

// ---- row 5d: the tile kernel, after the heavy pass over the rows' CSR.
// A tile is 64 consecutive rows. Persistent blocks (256 threads, three an
// SM) draw tiles in order from a counter (zeroed with the tickets), so a
// sampled batch's live rows (its first tiles) spread over the blocks, one
// tile each, and the blocks that drew a tile without a slot (zeros only)
// draw the next ones; a block draws its next tile while it works on this
// one. Each warp takes 8 of the tile's rows: a light row's slots (at most
// 32) are added in slot order (light_walk, the next 32 slots' ids loaded
// while these are added), divided once by the count and written to the
// mean and to the tile in shared memory; a heavy row's mean comes from
// the heavy pass; a row without a slot is zero. Then the tile times w on
// the tensor cores (mma.sync m16n8k8, TF32): each float32 mean is split
// into two TF32 parts, hi = tf32(mean) and lo = tf32(mean - hi), and a
// bfloat16 w is exact in TF32, so lo w + hi w carries float32's precision;
// a float32 w is split the same way and takes a third product, hi w_lo.
// Each warp owns 16 rows and 64 columns of a 128-column panel of w, kept
// in shared memory in w's own type (staged during the block's first tile
// when F <= 128, else before each panel's product). A row without a slot
// writes zeros (0 w would be NaN on a non-finite w) and a tile without one
// skips the product. Offsets are 64-bit. Measured on the H100 (PERF.md,
// row 5d): 512 threads a block (16 warps of 4 rows, two blocks an SM), 32-
// row tiles and 16 rows of x in flight a lane all ran slower.
constexpr int kTile = 64;
constexpr int kPanel = 128;
constexpr int kTileThreads = 256;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kTileWarpRows = kTile / kTileWarps;
constexpr int kTileMT = kTile / 16;                      // m-tiles a tile
constexpr int kTileNT = kPanel / 8 / (kTileWarps / kTileMT);  // a warp's

struct TilePlan {
  int dk, lda, fp, ldw;
  size_t w_bytes, smem;
};

// w's panel (dk x fp in w's own type, row stride ldw) and the tile (64 x
// dk float32, stride lda), then the rows' live flags and the tile drawn.
// The strides keep the fragment loads conflict-free: lda = 4 modulo 8
// words; ldw = 8 modulo 16 words (float32 w) or 8 modulo 64 halves
// (bfloat16 w). A bfloat16 panel (34 KB at D = F = 128) beside the 33 KB
// tile lets three blocks share an SM.
TilePlan tile_plan(int D, int F, int w_size) {
  TilePlan p;
  p.dk = (D + 7) & ~7;
  p.lda = p.dk + 4;
  const int f8 = (F + 7) & ~7;
  p.fp = f8 < kPanel ? f8 : kPanel;
  p.ldw = w_size == 2 ? ((p.fp + 63) & ~63) + 8 : (p.fp + 8) | 8;
  p.w_bytes = ((size_t)w_size * p.dk * p.ldw + 15) & ~(size_t)15;
  p.smem = p.w_bytes + sizeof(float) * (size_t)kTile * p.lda +
           sizeof(int) * (kTile + 1);
  return p;
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Columns f0 .. f0 + fp - 1 of w into w_s as they are (zero past D and
// F): 16-byte loads when the panel is w's whole rows, else one element a
// load, eight loads in flight a thread either way.
template <typename W>
__device__ void stage_panel(const W* __restrict__ w, W* w_s, int D, int F,
                            int f0, const TilePlan& p) {
  constexpr int E = 16 / sizeof(W);  // elements a 16-byte load
  if (f0 == 0 && p.fp == F && F % E == 0 &&
      reinterpret_cast<uintptr_t>(w) % 16 == 0) {
    const int per_row = F / E, total = p.dk * per_row;
    for (int i0 = threadIdx.x; i0 < total; i0 += 8 * kTileThreads) {
      uint4 v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = i0 + j * kTileThreads, k = i / per_row;
        v[j] = i < total && k < D
                   ? __ldg(reinterpret_cast<const uint4*>(w) + i)
                   : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = i0 + j * kTileThreads, k = i / per_row;
        if (i < total)
          *reinterpret_cast<uint4*>(w_s + k * p.ldw + (i - k * per_row) * E) =
              v[j];
      }
    }
    return;
  }
  const int total = p.dk * p.fp;
  for (int i0 = threadIdx.x; i0 < total; i0 += 8 * kTileThreads) {
    W v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = i0 + j * kTileThreads;
      const int k = i / p.fp, n = i - k * p.fp;
      v[j] = i < total && k < D && f0 + n < F
                 ? w[(int64_t)k * F + f0 + n]
                 : zero_of<W>();
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = i0 + j * kTileThreads;
      const int k = i / p.fp;
      if (i < total) w_s[k * p.ldw + i - k * p.fp] = v[j];
    }
  }
}

// out[r0 .. r0 + 63, f0 .. f0 + fp) = tile @ panel. Warp w: rows 16 (w %
// kTileMT) .. + 15, n-tiles kTileNT (w / kTileMT) .. + kTileNT - 1 of the
// panel; the mma
// fragments of the PTX ISA (g = lane / 4, t = lane % 4).
template <typename W>
__device__ void tile_product(const float* tile_s, const W* w_s,
                             const int* live_s, float* __restrict__ out,
                             int64_t r0, int64_t B, int F, int f0,
                             const TilePlan& p) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp % kTileMT;
  const int j0 = (warp / kTileMT) * kTileNT;
  const int ntn = p.fp / 8;
  if (j0 >= ntn) return;
  float acc[kTileNT][4] = {};
  const float* a0 = tile_s + (16 * mt + g) * p.lda + t;
  const float* a1 = a0 + 8 * p.lda;
  for (int k0 = 0; k0 < p.dk; k0 += 8) {
    const float av[4] = {a0[k0], a1[k0], a0[k0 + 4], a1[k0 + 4]};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hi[e] = tf32(av[e]);
      lo[e] = tf32(av[e] - __uint_as_float(hi[e]));
    }
    const W* w0 = w_s + (k0 + t) * p.ldw + g;
    const W* w1 = w0 + 4 * p.ldw;
#pragma unroll
    for (int j = 0; j < kTileNT; ++j) {
      if (j0 + j >= ntn) break;
      const float b0 = widen(w0[(j0 + j) * 8]);
      const float b1 = widen(w1[(j0 + j) * 8]);
      if constexpr (sizeof(W) == 2) {  // bfloat16 w: exact in TF32
        const uint32_t h0 = __float_as_uint(b0), h1 = __float_as_uint(b1);
        mma_tf32(acc[j], lo, h0, h1);
        mma_tf32(acc[j], hi, h0, h1);
      } else {
        const uint32_t h0 = tf32(b0), h1 = tf32(b1);
        const uint32_t l0 = tf32(b0 - __uint_as_float(h0));
        const uint32_t l1 = tf32(b1 - __uint_as_float(h1));
        mma_tf32(acc[j], lo, h0, h1);
        mma_tf32(acc[j], hi, l0, l1);
        mma_tf32(acc[j], hi, h0, h1);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * mt + g + 8 * h;
    if (r0 + r >= B) continue;
    const bool live = live_s[r] != 0;
    float* dst = out + (r0 + r) * F;
#pragma unroll
    for (int j = 0; j < kTileNT; ++j) {
      if (j0 + j >= ntn) break;
      const int f = f0 + (j0 + j) * 8 + 2 * t;
      const float v0 = live ? acc[j][2 * h] : 0.0f;
      const float v1 = live ? acc[j][2 * h + 1] : 0.0f;
      if ((F & 1) == 0 && f + 1 < F) {
        *reinterpret_cast<float2*>(dst + f) = make_float2(v0, v1);
      } else {
        if (f < F) dst[f] = v0;
        if (f + 1 < F) dst[f + 1] = v1;
      }
    }
  }
}

template <int V, typename W>
__global__ void __launch_bounds__(kTileThreads, 3)
neighbor_agg_tile_kernel(const float* __restrict__ x,
                         const int64_t* __restrict__ indptr,
                         const int32_t* __restrict__ indices,
                         const W* __restrict__ w, float* __restrict__ mean,
                         float* __restrict__ out,
                         int32_t* __restrict__ tile_next, int64_t B, int D,
                         int F, TilePlan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  W* w_s = reinterpret_cast<W*>(smem_raw);
  float* tile_s = reinterpret_cast<float*>(smem_raw + p.w_bytes);
  int* live_s = reinterpret_cast<int*>(tile_s + kTile * p.lda);
  int* next_s = live_s + kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int npanel = (F + kPanel - 1) / kPanel;
  const int pad = p.dk - D;  // the tile's columns past D: zero throughout
  for (int i = threadIdx.x; i < kTile * pad; i += kTileThreads)
    tile_s[(i / pad) * p.lda + D + i % pad] = 0.0f;
  const int64_t ntiles = (B + kTile - 1) / kTile;
  const int ncol = V == 4 ? D / 4 : D;
  const int row0 = warp * kTileWarpRows;  // the warp's rows in a tile
  // w's panel goes in after the first tile's walk (its loads then overlap
  // the walk's); thread 0 draws the next tile while this one is worked
  bool staged = npanel > 1;
  int drawn = 0;
  if (threadIdx.x == 0) drawn = atomicAdd(tile_next, 1);
  for (;;) {
    if (threadIdx.x == 0) {
      *next_s = drawn;
      drawn = atomicAdd(tile_next, 1);
    }
    __syncthreads();
    const int64_t tile = *next_s;
    if (tile >= ntiles) break;
    const int64_t r0 = tile * kTile;
    const int64_t b = r0 + row0 + lane;
    const bool mine_row = lane < kTileWarpRows;
    int64_t lo = 0, n = 0;
    if (mine_row && b < B) {
      lo = indptr[b];
      n = indptr[b + 1] - lo;
    }
    if (mine_row) live_s[row0 + lane] = n > 0;
    for (unsigned m = __ballot_sync(kFull, mine_row && n == 0); m;
         m &= m - 1) {  // no slot (or past B): zeros
      const int t = __ffs(m) - 1;
      float* tr = tile_s + (row0 + t) * p.lda;
      for (int c = lane; c < D; c += 32) tr[c] = 0.0f;
      if (r0 + row0 + t < B) zero_span<V>(mean + (r0 + row0 + t) * D, D);
    }
    for (unsigned m = __ballot_sync(kFull, n > kChunk); m; m &= m - 1) {
      const int t = __ffs(m) - 1;  // heavy: the heavy pass's mean
      const float* src = mean + (r0 + row0 + t) * D;
      float* tr = tile_s + (row0 + t) * p.lda;
      for (int c = lane; c < ncol; c += 32) {
        float v[V];
        load_g<V>(src + c * V, v);
        if constexpr (V == 4) {
          store4(v, tr + c * 4);
        } else {
          tr[c] = v[0];
        }
      }
    }
    const int nl = n <= kChunk ? (int)n : 0;
    light_walk<V, false>(
        x, nullptr, indices, D, lo, nl,
        [&](int t, int col, bool mine, const float (&a)[V]) {
          const float den = (float)__shfl_sync(kFull, nl, t);
          if (!mine) return;
          float m[V];
#pragma unroll
          for (int e = 0; e < V; ++e) m[e] = a[e] / den;
          float* tr = tile_s + (row0 + t) * p.lda + col * V;
          float* md = mean + (r0 + row0 + t) * D + (int64_t)col * V;
          if constexpr (V == 4) {
            store4(m, tr);
            store4(m, md);
          } else {
            *tr = m[0];
            *md = m[0];
          }
        });
    if (!staged) {
      stage_panel(w, w_s, D, F, 0, p);
      staged = true;
    }
    if (!__syncthreads_or(mine_row && n > 0)) {
      // no row of the tile has a slot: its rows of out, one stretch
      const int64_t rows = B - r0 < kTile ? B - r0 : kTile;
      float* dst = out + r0 * F;
      const int64_t len = rows * F;
      if ((F & 3) == 0) {
        for (int64_t i = threadIdx.x; i < len / 4; i += kTileThreads)
          reinterpret_cast<float4*>(dst)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        for (int64_t i = threadIdx.x; i < len; i += kTileThreads)
          dst[i] = 0.0f;
      }
      continue;  // nothing read the tile: the next one may fill it
    }
    for (int q = 0; q < npanel; ++q) {
      if (npanel > 1) {
        if (q > 0) __syncthreads();
        stage_panel(w, w_s, D, F, q * kPanel, p);
        __syncthreads();
      }
      tile_product<W>(tile_s, w_s, live_s, out, r0, B, F, q * kPanel, p);
    }
    __syncthreads();  // the tile is read before the next one fills it
  }
}

// Blocks of ``kernel`` the card holds at once with ``smem`` dynamic bytes
// (at least 1), after raising its dynamic shared memory limit.
template <typename K>
cudaError_t resident_blocks(K kernel, size_t smem, int64_t* fit,
                            int threads = kThreads) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *fit = (int64_t)per_sm * sms;
  return cudaSuccess;
}

template <typename T, typename W>
cudaError_t launch_fwd(const void* x, const int32_t* nbrs, const void* w,
                       void* out, float* mean_out, int64_t B, int K, int D,
                       int F, int vec, int id_vec, int out_vec,
                       cudaStream_t stream) {
  const FwdPlan p = fwd_plan(D, F);
  auto kernel = vec ? neighbor_agg_kernel<T, W, (int)(16 / sizeof(T))>
                    : neighbor_agg_kernel<T, W, 1>;
  int64_t fit = 0;
  const cudaError_t err = resident_blocks(kernel, p.smem, &fit);
  if (err != cudaSuccess) return err;
  // persistent blocks: as many as the card holds at once, fewer when the
  // rows do not give every warp a set
  const int64_t want = (B + kWarps - 1) / kWarps;
  const unsigned blocks = (unsigned)(want < fit ? want : fit);
  kernel<<<blocks, kThreads, p.smem, stream>>>(
      static_cast<const T*>(x), nbrs, static_cast<const W*>(w),
      static_cast<T*>(out), mean_out, B, K, D, F, id_vec, out_vec, p.ld,
      p.wld, p.resident, p.places, (int)p.warp_bytes);
  return cudaGetLastError();
}

// One launch after the caller's memset of the tickets (cap + 1 int32: the
// units' counter last): the heavy blocks (as many as the units may use,
// at most three quarters of the card's resident blocks when light blocks
// follow, so those start beside them; a half or all of them ran slower
// at the ogb_products layer) and, with ``light``, the light blocks over
// the N ids.
template <int V, typename T, bool kMean>
cudaError_t launch_passes(const float* g, const int32_t* cnt,
                          const int64_t* rowptr, const int32_t* rows,
                          const int64_t* hptr, const int32_t* hunit,
                          float* partials, int32_t* tickets, int64_t cap,
                          T* out, int64_t N, int D, bool light,
                          cudaStream_t stream) {
  auto kernel = neighbor_agg_bwd_kernel<V, T, kMean>;
  const size_t smem = V == 4 ? kRingSmem : 0;
  int64_t fit = 0;
  const cudaError_t err = resident_blocks(kernel, smem, &fit);
  if (err != cudaSuccess) return err;
  // the units' count is on the device: a block past it returns at once
  int64_t heavy = (cap + kWarps - 1) / kWarps;
  const int64_t most = light ? fit * 3 / 4 : fit;
  if (heavy > most) heavy = most;
  const int64_t blocks =
      heavy + (light ? (N + kIds * kWarps - 1) / (kIds * kWarps) : 0);
  if (blocks == 0) return cudaSuccess;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      g, cnt, rowptr, rows, hptr, hunit, partials, tickets, cap, out, N, D,
      (int)heavy);
  return cudaGetLastError();
}

template <int V, typename T>
cudaError_t launch_bwd(const float* g, const int32_t* cnt,
                       const int64_t* rowptr, const int32_t* rows,
                       const int64_t* hptr, const int32_t* hunit,
                       float* partials, int32_t* tickets, int64_t cap,
                       void* grad_x, int64_t N, int D, cudaStream_t stream) {
  const cudaError_t err =
      cudaMemsetAsync(tickets, 0, sizeof(int32_t) * (cap + 1), stream);
  if (err != cudaSuccess) return err;
  return launch_passes<V, T, false>(g, cnt, rowptr, rows, hptr, hunit,
                                    partials, tickets, cap,
                                    static_cast<T*>(grad_x), N, D, true,
                                    stream);
}

template <int V, typename W>
cudaError_t launch_csr(const float* x, const int64_t* indptr,
                       const int32_t* indices, const int64_t* hptr,
                       const int32_t* hunit, float* partials,
                       int32_t* tickets, int64_t cap, const void* w,
                       float* mean, float* out, int64_t B, int D, int F,
                       cudaStream_t stream) {
  // the tickets, the units' counter and the tiles' counter
  cudaError_t err =
      cudaMemsetAsync(tickets, 0, sizeof(int32_t) * (cap + 2), stream);
  if (err == cudaSuccess)
    err = launch_passes<V, float, true>(x, nullptr, indptr, indices, hptr,
                                        hunit, partials, tickets, cap, mean,
                                        B, D, false, stream);
  const TilePlan p = tile_plan(D, F, (int)sizeof(W));
  auto kernel = neighbor_agg_tile_kernel<V, W>;
  int64_t fit = 0;
  if (err == cudaSuccess)
    err = resident_blocks(kernel, p.smem, &fit, kTileThreads);
  if (err != cudaSuccess) return err;
  const int64_t ntiles = (B + kTile - 1) / kTile;
  kernel<<<(unsigned)(ntiles < fit ? ntiles : fit), kTileThreads, p.smem,
           stream>>>(x, indptr, indices, static_cast<const W*>(w), mean, out,
                     tickets + cap + 1, B, D, F, p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points; the PyTorch binding (hype_score/csrc/binding.cpp)
// checks the arguments, allocates the outputs and passes the current
// stream. ``x_bf16`` and ``w_bf16`` pick the element types (0: float32,
// 1: bfloat16); ``vec`` says that every row of x starts 16-byte aligned
// (the binding checks the pointer and D * itemsize), ``id_vec`` the same
// of nbrs (K % 4 == 0), ``out_vec`` of out (F * itemsize % 16 == 0);
// ``mean_out`` may be null.
extern "C" size_t neighbor_agg_smem_bytes(int D, int F) {
  return fwd_plan(D, F).smem;
}

extern "C" cudaError_t neighbor_agg_launch(const void* x, const int32_t* nbrs,
                                           const void* w, void* out,
                                           float* mean_out, int64_t B, int K,
                                           int D, int F, int x_bf16,
                                           int w_bf16, int vec, int id_vec,
                                           int out_vec, cudaStream_t stream) {
  if (x_bf16 && w_bf16)
    return launch_fwd<__nv_bfloat16, __nv_bfloat16>(
        x, nbrs, w, out, mean_out, B, K, D, F, vec, id_vec, out_vec, stream);
  if (x_bf16)
    return launch_fwd<__nv_bfloat16, float>(x, nbrs, w, out, mean_out, B, K,
                                            D, F, vec, id_vec, out_vec,
                                            stream);
  if (w_bf16)
    return launch_fwd<float, __nv_bfloat16>(x, nbrs, w, out, mean_out, B, K,
                                            D, F, vec, id_vec, out_vec,
                                            stream);
  return launch_fwd<float, float>(x, nbrs, w, out, mean_out, B, K, D, F, vec,
                                  id_vec, out_vec, stream);
}

// ``vec`` says that D is a multiple of 4 and g is 16-byte aligned. A
// null ``cnt`` is the sum mode: every slot's divisor is 1 (x / 1.0f is x).
// ``partials`` (cap x D float32) and ``tickets`` (cap + 1 int32) are
// scratch for the chunk units, ``cap`` the length of ``hunit``; the
// tickets are zeroed here, on the stream, before the heavy pass.
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

// Row 5d: the dynamic shared memory of its tile kernel.
extern "C" size_t neighbor_agg_csr_smem_bytes(int D, int F, int w_bf16) {
  return tile_plan(D, F, w_bf16 ? 2 : 4).smem;
}

// Row 5d: x (N, D) float32, the rows' CSR (indptr (B + 1) int64, indices
// int32), its chunk units (hptr (B + 1) int64, hunit (cap) int32), w (D,
// F) (``w_bf16``); writes mean (B, D) and out (B, F), float32.
// ``partials`` as for the backward, ``tickets`` cap + 2 int32 (the tiles'
// counter last), zeroed here; ``vec``: D % 4 == 0 and x and mean 16-byte
// aligned.
extern "C" cudaError_t neighbor_agg_csr_launch(
    const float* x, const int64_t* indptr, const int32_t* indices,
    const int64_t* hptr, const int32_t* hunit, float* partials,
    int32_t* tickets, int64_t cap, const void* w, float* mean, float* out,
    int64_t B, int D, int F, int w_bf16, int vec, cudaStream_t stream) {
  if (w_bf16 && vec)
    return launch_csr<4, __nv_bfloat16>(x, indptr, indices, hptr, hunit,
                                        partials, tickets, cap, w, mean, out,
                                        B, D, F, stream);
  if (w_bf16)
    return launch_csr<1, __nv_bfloat16>(x, indptr, indices, hptr, hunit,
                                        partials, tickets, cap, w, mean, out,
                                        B, D, F, stream);
  if (vec)
    return launch_csr<4, float>(x, indptr, indices, hptr, hunit, partials,
                                tickets, cap, w, mean, out, B, D, F, stream);
  return launch_csr<1, float>(x, indptr, indices, hptr, hunit, partials,
                              tickets, cap, w, mean, out, B, D, F, stream);
}
