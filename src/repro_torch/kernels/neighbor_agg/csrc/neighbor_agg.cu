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
    // rows d < D of w widened to float32, then zero rows up to ld; with
    // F % 4 == 0 the rows are wld = F wide and w is read as it lies, 16
    // bytes a thread
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

template <typename T, typename W>
cudaError_t launch_fwd(const void* x, const int32_t* nbrs, const void* w,
                       void* out, float* mean_out, int64_t B, int K, int D,
                       int F, int vec, int id_vec, int out_vec,
                       cudaStream_t stream) {
  const FwdPlan p = fwd_plan(D, F);
  auto kernel = vec ? neighbor_agg_kernel<T, W, (int)(16 / sizeof(T))>
                    : neighbor_agg_kernel<T, W, 1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, p.smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // persistent blocks: as many as the card holds at once, fewer when the
  // rows do not give every warp a set
  const int64_t want = (B + kWarps - 1) / kWarps;
  const int64_t fit = (int64_t)per_sm * sms;
  const unsigned blocks = (unsigned)(want < fit ? want : fit);
  kernel<<<blocks, kThreads, p.smem, stream>>>(
      static_cast<const T*>(x), nbrs, static_cast<const W*>(w),
      static_cast<T*>(out), mean_out, B, K, D, F, id_vec, out_vec, p.ld,
      p.wld, p.resident, p.places, (int)p.warp_bytes);
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
