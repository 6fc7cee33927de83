// Row 5c, the segment sum over an edge list, hand-written for Hopper
// (sm_90a):
//   out[u, :] = sum of msgs[e, :] over the edges e whose id is u
// msgs (E, D) float32, out (N, D) float32. The caller's segment index
// (ops.segment_index) gives ``rows``, the edges sorted stably by id (so
// each id's edges stay in edge order), ``rowptr`` over the N + 1 ids, and
// the chunk units of the ids of more than kChunk edges (``hptr``,
// ``hunit``). The order of additions is ref.py's (neighbor_agg_bwd_ref
// with mean=False): an id's edges cut into chunks of kChunk = 32, each
// chunk summed in order from 0, the partials added in chunk order from 0
// (an id of at most 32 edges is one chain). No float atomics, so the
// result is the same bits on every run and equal to the plain version's.
//
// No TPU kernel of its own: the JAX models sum with jax.ops.segment_sum
// (src/repro/models/gnn.py), which XLA lowers. It is row 5b's backward
// (neighbor_agg.cu) in its sum mode with the schedule redesigned for an
// edge list at any D.
//
// What bounds it on the H100: bytes, the valid edges' rows of msgs and the
// N x D output, most of it zeros in a sampled batch. gatedgcn's layer
// (169,984 ids, 148,350 valid edges, D = 70) moves 91 MB: 0.027 ms at
// 3.35 TB/s; meshgraphnet's (D = 128) 165 MB, 0.049 ms.
//
// The design:
//   * a warp owns kIds = 4 consecutive ids (lane t holding id t's edge
//     range); a warp scan packs the ids' edges into one list, whose 32-edge
//     batches the lanes load at once, and the warp walks it with kF rows
//     in flight, writing each id's row after its last edge;
//   * one walk at any D: lanes cover a row with the widest loads its
//     alignment allows, VW = 4, 2 or 1 floats (16, 8 or 4 bytes), NC
//     vectors a lane (columns lane + 32 c, a strided register tile), so
//     gatedgcn's 70 floats are 35 8-byte vectors, two a lane, in one pass
//     (row 5b's kernel took three 32-column passes of 4-byte loads there,
//     each repeating the scan, the edge loads and the shuffles). Past
//     32 NC VW floats (512 at VW = 4) the walk takes one pass a 32 NC
//     vectors;
//   * the ids without an edge come in runs of consecutive rows, each
//     zeroed as one stretch with 16-byte stores at any alignment (a head
//     and a tail of 4-byte stores);
//   * heavy ids (more than kChunk edges) as in row 5b: each chunk a unit,
//     drawn in order from a counter, summed into a float32 partial; the
//     warp that draws the id's last ticket adds the partials in chunk
//     order. The first blocks' warps draw the units before taking their
//     own light ids, so no block is launched for heavy work alone, and
//     with no unit (hptr[N] == 0, the sums by dst of a sampled batch) a
//     warp reads one offset and goes on. The tickets and the counter live
//     in a zeroed workspace that the kernel leaves zeroed (an id's last
//     ticket resets its counter, the counter's last draw resets it), so a
//     call needs no memset.
// Offsets are 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;  // edges a chunk (ref.py's CHUNK)
constexpr int kIds = 4;     // light ids a warp
constexpr int kMaxNC = 4;   // vectors a lane in one pass
constexpr unsigned kFull = 0xffffffffu;

// rows of msgs in flight a lane: about 32 floats of registers
template <int VW, int NC>
__host__ __device__ constexpr int flight() {
  return VW * NC <= 4 ? 8 : (VW * NC <= 8 ? 4 : 2);
}

template <int VW>
__device__ __forceinline__ void load_v(const float* p, float* v) {
  if constexpr (VW == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if constexpr (VW == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = __ldg(p);
  }
}

// A partial written by another warp during this launch: read from L2.
template <int VW>
__device__ __forceinline__ void load_cg(const float* p, float* v) {
  if constexpr (VW == 4) {
    const float4 q = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if constexpr (VW == 2) {
    const float2 q = __ldcg(reinterpret_cast<const float2*>(p));
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = __ldcg(p);
  }
}

template <int VW>
__device__ __forceinline__ void store_v(const float* v, float* p) {
  if constexpr (VW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VW == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// The lane's vectors of a pass from vector c0: c0 + lane + 32 c, c < NC.
template <int VW, int NC>
__device__ __forceinline__ void store_tile(const float (&a)[NC][VW],
                                           float* row, int c0, int nv) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int j = c0 + lane + 32 * c;
    if (j < nv) store_v<VW>(a[c], row + (int64_t)j * VW);
  }
}

// n zero floats from dst (4-byte aligned), by the warp: 16-byte stores
// between a head and a tail of at most three floats.
__device__ __forceinline__ void zero_floats(float* dst, int64_t n) {
  const int lane = threadIdx.x & 31;
  const int64_t lead =
      (int64_t)(((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) >> 2);
  const int64_t h = lead < n ? lead : n;
  if (lane < h) dst[lane] = 0.0f;
  dst += h;
  n -= h;
  float4* q = reinterpret_cast<float4*>(dst);
  const int64_t n4 = n >> 2;
  for (int64_t i = lane; i < n4; i += 32) q[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (lane < (n & 3)) dst[(n4 << 2) + lane] = 0.0f;
}

// Adds edges s0 .. s0 + n - 1 (n <= 32) of the lanes' list into acc, in
// order, kF rows in flight: lane s holds edge s (its row e of msgs), its
// owner t and whether it is t's last edge; after an owner's last edge the
// warp hands acc to sink(t, acc) and restarts from 0.
template <int VW, int NC, typename Sink>
__device__ __forceinline__ void add_edges(const float* __restrict__ msgs,
                                          int D, int c0, int nv, int n,
                                          int32_t my_e, int my_t,
                                          bool my_last, Sink&& sink,
                                          float (&acc)[NC][VW]) {
  constexpr int kF = flight<VW, NC>();
  const int lane = threadIdx.x & 31;
  for (int s0 = 0; s0 < n; s0 += kF) {
    float v[kF][NC][VW];
#pragma unroll
    for (int s = 0; s < kF; ++s) {
      // s0 + s < 32: kF divides 32
      const int32_t e = __shfl_sync(kFull, my_e, s0 + s);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int j = c0 + lane + 32 * c;
#pragma unroll
        for (int i = 0; i < VW; ++i) v[s][c][i] = 0.0f;
        if (s0 + s < n && j < nv)
          load_v<VW>(msgs + (int64_t)e * D + (int64_t)j * VW, v[s][c]);
      }
    }
#pragma unroll
    for (int s = 0; s < kF; ++s) {
      const int t = __shfl_sync(kFull, my_t, s0 + s);
      const bool last = __shfl_sync(kFull, (int)my_last, s0 + s) != 0;
      if (s0 + s >= n) break;  // the same for every lane
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < VW; ++i) acc[c][i] += v[s][c][i];
      if (last) {
        sink(t, acc);
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int i = 0; i < VW; ++i) acc[c][i] = 0.0f;
      }
    }
  }
}

// The light ids of one warp: lane t holds id t's first edge ``lo`` and its
// edge count ``nl`` (at most kChunk; 0: an id the walk skips). A warp scan
// packs the ids' edges into one list; each pass of 32 NC vectors walks it
// once (one pass for D <= 32 NC VW), and sink(t, c0, acc) takes id t's
// sum after its last edge.
template <int VW, int NC, typename Sink>
__device__ __forceinline__ void walk(const float* __restrict__ msgs,
                                     const int32_t* __restrict__ rows, int D,
                                     int nv, int64_t lo, int nl,
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
  // packed edge q = qb + l is owned by the last lane t with off_t <= q (off
  // does not decrease over the lanes): its row e, owner t and whether it
  // is t's last edge
  auto locate = [&](int qb, int32_t& e, int& t, bool& last) {
    const int q = qb + lane;
    t = 0;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1)
      if (__shfl_sync(kFull, off, t + step) <= q) t += step;
    const int64_t lo_t = __shfl_sync(kFull, lo, t);
    const int off_t = __shfl_sync(kFull, off, t);
    const int nl_t = __shfl_sync(kFull, nl, t);
    e = q < total ? rows[lo_t + (q - off_t)] : 0;
    last = q == off_t + nl_t - 1;
  };
  for (int c0 = 0; c0 < nv; c0 += 32 * NC) {
    float acc[NC][VW] = {};
    int32_t ne;
    int nt;
    bool nlast;
    locate(0, ne, nt, nlast);
    for (int qb = 0; qb < total; qb += 32) {
      const int32_t my_e = ne;
      const int my_t = nt;
      const bool my_last = nlast;
      if (qb + 32 < total) locate(qb + 32, ne, nt, nlast);  // in flight
      add_edges<VW, NC>(
          msgs, D, c0, nv, total - qb < 32 ? total - qb : 32, my_e, my_t,
          my_last, [&](int owner, const float (&a)[NC][VW]) {
            sink(owner, c0, a);
          },
          acc);
    }
  }
}

// Chunk unit i of a heavy id: its partial, then, for the warp that draws
// the id's last ticket, the sum of the id's partials in chunk order, and
// the ticket's reset.
template <int VW, int NC>
__device__ void heavy_unit(const float* __restrict__ msgs,
                           const int64_t* __restrict__ rowptr,
                           const int32_t* __restrict__ rows,
                           const int64_t* __restrict__ hptr,
                           const int32_t* __restrict__ hunit,
                           float* __restrict__ partials,
                           int32_t* __restrict__ tickets,
                           float* __restrict__ out, int D, int nv,
                           int64_t i) {
  constexpr int kF = flight<VW, NC>();
  const int lane = threadIdx.x & 31;
  const int64_t u = hunit[i];
  const int64_t base = hptr[u], units = hptr[u + 1] - base;
  const int64_t s0 = rowptr[u] + (i - base) * kChunk;
  const int64_t left = rowptr[u + 1] - s0;
  const int n = left < kChunk ? (int)left : kChunk;
  const int32_t my_e = lane < n ? rows[s0 + lane] : 0;
  for (int c0 = 0; c0 < nv; c0 += 32 * NC) {
    float acc[NC][VW] = {};
    add_edges<VW, NC>(msgs, D, c0, nv, n, my_e, 0, false,
                      [](int, const float(&)[NC][VW]) {}, acc);
    store_tile<VW, NC>(acc, partials + i * D, c0, nv);
  }
  __threadfence();  // the partial is visible before the ticket is taken
  __syncwarp();
  int ticket = 0;
  if (lane == 0) ticket = atomicAdd(tickets + base, 1);
  if (__shfl_sync(kFull, ticket, 0) != units - 1) return;
  __threadfence();
  if (lane == 0) tickets[base] = 0;  // every unit of u has drawn
  const float* p = partials + base * D;
  for (int c0 = 0; c0 < nv; c0 += 32 * NC) {
    float acc[NC][VW] = {};
    for (int64_t k0 = 0; k0 < units; k0 += kF) {
      float v[kF][NC][VW];
#pragma unroll
      for (int s = 0; s < kF; ++s)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int j = c0 + lane + 32 * c;
#pragma unroll
          for (int e = 0; e < VW; ++e) v[s][c][e] = 0.0f;
          if (k0 + s < units && j < nv)
            load_cg<VW>(p + (k0 + s) * D + (int64_t)j * VW, v[s][c]);
        }
#pragma unroll
      for (int s = 0; s < kF; ++s) {
        if (k0 + s >= units) break;
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int e = 0; e < VW; ++e) acc[c][e] += v[s][c][e];
      }
    }
    store_tile<VW, NC>(acc, out + u * D, c0, nv);
  }
}

// The light work of kIds consecutive ids (one warp), lane t holding id u0
// + t: runs of ids without an edge zeroed as one stretch each, the ids of
// 1 to kChunk edges walked; heavy ids are the units'.
template <int VW, int NC>
__device__ void light_ids(const float* __restrict__ msgs,
                          const int64_t* __restrict__ rowptr,
                          const int32_t* __restrict__ rows,
                          float* __restrict__ out, int64_t N, int D, int nv,
                          int64_t u0) {
  const int lane = threadIdx.x & 31;
  const int64_t u = lane < kIds ? u0 + lane : N;
  int64_t lo = 0, hi = 0;
  if (u < N) {
    lo = rowptr[u];
    hi = rowptr[u + 1];
  }
  float* o = out + u0 * D;
  for (unsigned m = __ballot_sync(kFull, u < N && hi == lo); m;) {
    const int a = __ffs(m) - 1;
    const unsigned from = ~(m >> a);
    const int len = from ? __ffs(from) - 1 : 32 - a;
    zero_floats(o + (int64_t)a * D, (int64_t)len * D);
    m &= ~((len == 32 ? kFull : (1u << len) - 1) << a);
  }
  const int nl = hi - lo <= kChunk ? (int)(hi - lo) : 0;
  walk<VW, NC>(msgs, rows, D, nv, lo, nl,
               [&](int t, int c0, const float (&a)[NC][VW]) {
                 store_tile<VW, NC>(a, o + (int64_t)t * D, c0, nv);
               });
}

// Every block owns kIds * kWarps consecutive ids. The warps of blocks
// below ``heavy_blocks`` first draw the heavy ids' chunk units from the
// counter tickets[cap] (when there are any), so a hub's units start at
// once; each of them draws once past the last unit, so the counter's last
// draw, units + heavy_blocks * kWarps - 1, is known and resets it.
template <int VW, int NC>
__global__ void __launch_bounds__(kThreads, 4)
segment_sum_kernel(const float* __restrict__ msgs,
                   const int64_t* __restrict__ rowptr,
                   const int32_t* __restrict__ rows,
                   const int64_t* __restrict__ hptr,
                   const int32_t* __restrict__ hunit,
                   float* __restrict__ partials,
                   int32_t* __restrict__ tickets, int64_t cap,
                   float* __restrict__ out, int64_t N, int D,
                   int heavy_blocks) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nv = D / VW;
  if ((int)blockIdx.x < heavy_blocks) {
    const int64_t units = hptr[N];
    if (units > 0) {
      const int64_t last = units + (int64_t)heavy_blocks * kWarps - 1;
      for (;;) {
        int i = 0;
        if (lane == 0) i = atomicAdd(tickets + cap, 1);
        i = __shfl_sync(kFull, i, 0);
        if (i >= units) {
          if (lane == 0 && i == last) tickets[cap] = 0;
          break;
        }
        heavy_unit<VW, NC>(msgs, rowptr, rows, hptr, hunit, partials,
                           tickets, out, D, nv, i);
      }
    }
  }
  const int64_t u0 = ((int64_t)blockIdx.x * kWarps + warp) * kIds;
  if (u0 < N) light_ids<VW, NC>(msgs, rowptr, rows, out, N, D, nv, u0);
}

template <int VW, int NC>
cudaError_t launch(const float* msgs, const int64_t* rowptr,
                   const int32_t* rows, const int64_t* hptr,
                   const int32_t* hunit, float* partials, int32_t* tickets,
                   int64_t cap, float* out, int64_t N, int D,
                   cudaStream_t stream) {
  auto kernel = segment_sum_kernel<VW, NC>;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (N + kIds * kWarps - 1) / (kIds * kWarps);
  // the units' count is on the device: as many heavy warps as the units
  // may use, at most one block an SM (an edge list's heavy ids are few:
  // the sampled batch's sums by src hold 73, of up to 1,056 edges), so
  // that every warp's draw past the last unit stays cheap
  int64_t heavy = (cap + kWarps - 1) / kWarps;
  if (heavy > sms) heavy = sms;
  if (heavy > blocks) heavy = blocks;
  kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      msgs, rowptr, rows, hptr, hunit, partials, tickets, cap, out, N, D,
      (int)heavy);
  return cudaGetLastError();
}

template <int VW>
cudaError_t launch_vw(int nc, const float* msgs, const int64_t* rowptr,
                      const int32_t* rows, const int64_t* hptr,
                      const int32_t* hunit, float* partials,
                      int32_t* tickets, int64_t cap, float* out, int64_t N,
                      int D, cudaStream_t stream) {
  switch (nc) {
    case 1:
      return launch<VW, 1>(msgs, rowptr, rows, hptr, hunit, partials,
                           tickets, cap, out, N, D, stream);
    case 2:
      return launch<VW, 2>(msgs, rowptr, rows, hptr, hunit, partials,
                           tickets, cap, out, N, D, stream);
    case 3:
      return launch<VW, 3>(msgs, rowptr, rows, hptr, hunit, partials,
                           tickets, cap, out, N, D, stream);
    default:
      return launch<VW, kMaxNC>(msgs, rowptr, rows, hptr, hunit, partials,
                                tickets, cap, out, N, D, stream);
  }
}

}  // namespace

// The floats a lane loads at once for a row of D floats: 4 where D % 4 ==
// 0 and every row of msgs, out and the partials starts 16-byte aligned
// (``align`` is the largest power of two, at most 16, that divides their
// base addresses), 2 at 8 bytes, else 1.
extern "C" int segment_sum_vec_width(int D, int align) {
  if (D % 4 == 0 && align >= 16) return 4;
  if (D % 2 == 0 && align >= 8) return 2;
  return 1;
}

// Plain C entry point; the PyTorch binding (hype_score/csrc/binding.cpp)
// checks the arguments, allocates the output and the partials (cap x D
// float32, ``cap`` the length of ``hunit``) and passes ``tickets``, at
// least cap + 1 int32 of a zeroed workspace that the kernel leaves zeroed,
// and the current stream. One launch, no memset.
extern "C" cudaError_t segment_sum_launch(
    const float* msgs, const int64_t* rowptr, const int32_t* rows,
    const int64_t* hptr, const int32_t* hunit, float* partials,
    int32_t* tickets, int64_t cap, float* out, int64_t N, int D, int align,
    cudaStream_t stream) {
  if (N == 0 || D == 0) return cudaSuccess;
  const int vw = segment_sum_vec_width(D, align);
  const int nv = D / vw;
  const int nc = (nv + 31) / 32;
  if (vw == 4)
    return launch_vw<4>(nc, msgs, rowptr, rows, hptr, hunit, partials,
                        tickets, cap, out, N, D, stream);
  if (vw == 2)
    return launch_vw<2>(nc, msgs, rowptr, rows, hptr, hunit, partials,
                        tickets, cap, out, N, D, stream);
  return launch_vw<1>(nc, msgs, rowptr, rows, hptr, hunit, partials,
                      tickets, cap, out, N, D, stream);
}
