// HYPE external-neighbours scores, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ``hype_scores_kernel`` (body
// ``_score_kernel``) in src/repro/kernels/hype_score/kernel.py.
//
// Per row b of the (B, L) neighbour tile against one fringe of s ids:
//   score[b] = #valid(nbrs[b, :]) - #(valid and nbrs[b, :] in fringe)
// as int32. Membership is an OR over the fringe slots, so a fringe that
// holds an id twice still counts a neighbour once; pad slots are -1 and
// never match a valid (>= 0) entry.
//
// What bounds it on the H100: bytes, and at the batched engine's shapes
// (B in {64, 256}, L in {32, 128, 512, 2048}, s = 16: at most 2 MB, 0.6
// us of bytes) the launch. The TPU kernel broadcasts the fringe against
// a (TB, L) VMEM tile, one compare per fringe slot. Here:
//   * s <= 32 (the engine's s = 16 is the main case): every thread holds
//     the fringe in registers, padded with -1 to 16 or 32 slots (the same
//     for the whole grid, so uniform values), and the membership test is
//     a fully unrolled chain of compares: no memory read per element;
//   * the rows are spread over the card: a row's L ids go to a power of
//     two of threads (tpr, up to the 128 of a block) so that each thread
//     loads about four 16-byte vectors, all in flight before its
//     compares; a block holds 128 / tpr rows. At L = 2048 a row is one
//     block (256 blocks at B = 256), at L = 32 two threads. A row's count
//     is a sum of integer partials (shuffles within a warp, then shared
//     memory across warps), exact in any order;
//   * a wider fringe keeps the general loop: one warp per row, the
//     fringe in shared memory (opted in past 48 KB up to the card's 227
//     KB, 58,112 ids) and read as a broadcast, or, wider still, read
//     from global memory (through L1) in place.
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../smem_optin.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRegThreads = 128;  // block of the register-fringe kernel
constexpr int kItems = 4;         // loads in flight per thread
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int external(int32_t x, const int32_t* f,
                                        int s) {
  if (x < 0) return 0;
  bool m = false;
  for (int j = 0; j < s; ++j) m |= (x == f[j]);
  return m ? 0 : 1;
}

template <int kS>
__device__ __forceinline__ int external_reg(int32_t x,
                                            const int32_t (&f)[kS]) {
  bool m = false;
#pragma unroll
  for (int j = 0; j < kS; ++j) m |= x == f[j];
  return x >= 0 && !m ? 1 : 0;
}

// The fringe in registers (kS >= s slots, -1 past s); tpr threads a row.
template <int kS>
__global__ void __launch_bounds__(kRegThreads)
scores_reg_kernel(const int32_t* __restrict__ nbrs,
                  const int32_t* __restrict__ fringe,
                  int32_t* __restrict__ out, int B, int L, int s, int vec4,
                  int tpr) {
  int32_t f[kS];
#pragma unroll
  for (int j = 0; j < kS; ++j) f[j] = j < s ? __ldg(fringe + j) : -1;
  const int r = threadIdx.x & (tpr - 1);
  const int64_t b = (int64_t)blockIdx.x * (kRegThreads / tpr) +
                    threadIdx.x / tpr;
  int cnt = 0;
  if (b < B) {
    const int32_t* row = nbrs + b * L;
    if (vec4) {
      const int4* row4 = reinterpret_cast<const int4*>(row);
      const int n = L >> 2;
      for (int c = r; c < n; c += kItems * tpr) {
        int4 q[kItems];
#pragma unroll
        for (int k = 0; k < kItems; ++k)
          q[k] = c + k * tpr < n ? __ldg(row4 + c + k * tpr)
                                 : make_int4(-1, -1, -1, -1);
#pragma unroll
        for (int k = 0; k < kItems; ++k)
          cnt += external_reg(q[k].x, f) + external_reg(q[k].y, f) +
                 external_reg(q[k].z, f) + external_reg(q[k].w, f);
      }
    } else {
      for (int c = r; c < L; c += kItems * tpr) {
        int32_t x[kItems];
#pragma unroll
        for (int k = 0; k < kItems; ++k)
          x[k] = c + k * tpr < L ? __ldg(row + c + k * tpr) : -1;
#pragma unroll
        for (int k = 0; k < kItems; ++k) cnt += external_reg(x[k], f);
      }
    }
  }
  // a row's threads are an aligned run of tpr lanes (tpr a power of two)
  for (int o = (tpr < 32 ? tpr : 32) >> 1; o > 0; o >>= 1)
    cnt += __shfl_xor_sync(kFull, cnt, o);
  if (tpr <= 32) {
    if (r == 0 && b < B) out[b] = cnt;
    return;
  }
  __shared__ int part[kRegThreads / 32];  // one row spans tpr / 32 warps
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = cnt;
  __syncthreads();
  if (r == 0 && b < B) {
    int sum = 0;
    for (int w = 0; w < tpr / 32; ++w) sum += part[(threadIdx.x >> 5) + w];
    out[b] = sum;
  }
}

// kGlobalFringe: read the fringe where it lies instead of staging it.
template <bool kGlobalFringe>
__global__ void __launch_bounds__(kThreads)
scores_kernel(const int32_t* __restrict__ nbrs,
              const int32_t* __restrict__ fringe,
              int32_t* __restrict__ out, int B, int L, int s, int vec4) {
  extern __shared__ int32_t f_smem[];  // the s fringe ids
  const int32_t* f = f_smem;
  if constexpr (kGlobalFringe) {
    f = fringe;
  } else {
    for (int j = threadIdx.x; j < s; j += kThreads) f_smem[j] = fringe[j];
    __syncthreads();
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int b = blockIdx.x * kWarps + warp; b < B;
       b += gridDim.x * kWarps) {
    const int32_t* row = nbrs + (int64_t)b * L;
    int cnt = 0;
    if (vec4) {
      const int4* row4 = reinterpret_cast<const int4*>(row);
      for (int c = lane; c < (L >> 2); c += 32) {
        const int4 q = __ldg(row4 + c);
        cnt += external(q.x, f, s) + external(q.y, f, s) +
               external(q.z, f, s) + external(q.w, f, s);
      }
    } else {
      for (int c = lane; c < L; c += 32) cnt += external(__ldg(row + c), f, s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      cnt += __shfl_xor_sync(kFull, cnt, off);
    if (lane == 0) out[b] = cnt;
  }
}

}  // namespace

// Plain C entry point; the PyTorch binding (binding.cpp) checks the
// arguments, allocates the output and passes the current stream.
extern "C" cudaError_t hype_scores_launch(const int32_t* nbrs,
                                          const int32_t* fringe,
                                          int32_t* out, int B, int L, int s,
                                          int vec4, cudaStream_t stream) {
  if (s <= 32) {
    // about kItems loads a thread: 16-byte vectors, or ids when the rows
    // are not 16-byte aligned
    const int items = vec4 ? L / 4 : L;
    int tpr = 1;
    while (tpr < kRegThreads && tpr * kItems < items) tpr <<= 1;
    const int rows = kRegThreads / tpr;
    const unsigned blocks = (unsigned)(((int64_t)B + rows - 1) / rows);
    if (s <= 16)
      scores_reg_kernel<16><<<blocks, kRegThreads, 0, stream>>>(
          nbrs, fringe, out, B, L, s, vec4, tpr);
    else
      scores_reg_kernel<32><<<blocks, kRegThreads, 0, stream>>>(
          nbrs, fringe, out, B, L, s, vec4, tpr);
    return cudaGetLastError();
  }
  int blocks = (B + kWarps - 1) / kWarps;
  if (blocks > 65535) blocks = 65535;
  const size_t smem = sizeof(int32_t) * (size_t)s;
  if (smem > (size_t)max_smem_optin()) {
    scores_kernel<true><<<blocks, kThreads, 0, stream>>>(nbrs, fringe, out,
                                                         B, L, s, vec4);
    return cudaGetLastError();
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        scores_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  scores_kernel<false><<<blocks, kThreads, smem, stream>>>(nbrs, fringe, out,
                                                           B, L, s, vec4);
  return cudaGetLastError();
}
