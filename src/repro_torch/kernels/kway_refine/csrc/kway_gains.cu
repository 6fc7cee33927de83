// K-way move gains, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ``kway_gains_kernel`` (body
// ``_gain_kernel``) in src/repro/kernels/kway_refine/kernel.py.
//
// Per row b of the (B, L) neighbour-partition tile:
//   cnt[q]     = #(parts[b, :] == q)               for q in [0, k)
//   cnt_own    = #(parts[b, :] == own[b] and parts[b, :] >= 0)
//   gain[b, q] = float(cnt[q] - cnt_own)
// so column own[b] comes out 0, and a pad row (own = -1, parts all -1)
// all zero. Values outside [0, k) count for no column, as the TPU
// kernel's k compare passes count them for none.
//
// What bounds it on the H100: bytes. The tile (B * L int32, 33.5 MB on
// the main path: B = 4096, L = 2048) is read once; own and the (B, k)
// gains are small, and the work is a few integer operations per loaded
// id. The TPU kernel makes k broadcast-compare passes over the tile,
// which on this card would cost k times the loads' issue slots; the
// design here is one pass with a histogram instead. Each warp owns one
// row and k int32 counters in shared memory. Its lanes stride over the
// row with 16-byte loads where the row is aligned (every L bucket is a
// multiple of 4); lanes that hold the same partition id are grouped by
// ``__match_any_sync`` and their leader adds the group's size with one
// shared-memory atomic, so a row whose neighbours sit in few partitions
// (the common case on a boundary) does not serialise 32 atomics on one
// counter. cnt_own is a per-lane count and a warp-shuffle sum. Every
// lane runs the same number of iterations, so the warp-wide intrinsics
// always see all 32 lanes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// One id: add it to the warp's histogram (grouped by value) and to the
// lane's own-partition count. Called by all 32 lanes together.
__device__ __forceinline__ void tally(int32_t x, int32_t own, int k,
                                      int lane, int* hist, int& own_cnt) {
  own_cnt += (x == own && x >= 0) ? 1 : 0;
  const unsigned same = __match_any_sync(kFull, x);
  if (x >= 0 && x < k && lane == __ffs(same) - 1)
    atomicAdd(hist + x, __popc(same));
}

__global__ void __launch_bounds__(kThreads)
kway_gains_kernel(const int32_t* __restrict__ parts,
                  const int32_t* __restrict__ own,
                  float* __restrict__ gains, int B, int L, int k,
                  int vec4) {
  extern __shared__ int hist_all[];  // kWarps rows of k counters
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int* hist = hist_all + warp * k;

  for (int b = blockIdx.x * kWarps + warp; b < B;
       b += gridDim.x * kWarps) {
    for (int q = lane; q < k; q += 32) hist[q] = 0;
    __syncwarp();
    const int32_t o = own[b];
    const int32_t* row = parts + (int64_t)b * L;
    int own_cnt = 0;
    if (vec4) {
      const int4* row4 = reinterpret_cast<const int4*>(row);
      const int n4 = L >> 2;
      for (int base = 0; base < n4; base += 32) {
        const int c = base + lane;
        const int4 v = c < n4 ? __ldg(row4 + c) : make_int4(-1, -1, -1, -1);
        tally(v.x, o, k, lane, hist, own_cnt);
        tally(v.y, o, k, lane, hist, own_cnt);
        tally(v.z, o, k, lane, hist, own_cnt);
        tally(v.w, o, k, lane, hist, own_cnt);
      }
    } else {
      for (int base = 0; base < L; base += 32) {
        const int c = base + lane;
        tally(c < L ? __ldg(row + c) : -1, o, k, lane, hist, own_cnt);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      own_cnt += __shfl_xor_sync(kFull, own_cnt, off);
    __syncwarp();
    float* out = gains + (int64_t)b * k;
    for (int q = lane; q < k; q += 32) out[q] = (float)(hist[q] - own_cnt);
    __syncwarp();  // the next row's zeroing must not overtake these reads
  }
}

}  // namespace

// Plain C entry point; the PyTorch binding (hype_score/csrc/binding.cpp)
// checks the arguments, allocates the output and passes the current
// stream. ``k * kWarps`` int32 counters of shared memory per block.
extern "C" cudaError_t kway_gains_launch(const int32_t* parts,
                                         const int32_t* own, float* gains,
                                         int B, int L, int k, int vec4,
                                         cudaStream_t stream) {
  const size_t smem = sizeof(int) * (size_t)k * kWarps;
  int blocks = (B + kWarps - 1) / kWarps;
  if (blocks > 65535) blocks = 65535;
  kway_gains_kernel<<<blocks, kThreads, smem, stream>>>(parts, own, gains,
                                                        B, L, k, vec4);
  return cudaGetLastError();
}

extern "C" int kway_gains_max_k() {
  return (48 * 1024) / (int)(sizeof(int) * kWarps);
}
