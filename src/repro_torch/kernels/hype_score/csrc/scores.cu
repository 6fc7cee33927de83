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
//   * a wider fringe: one warp per row, the fringe in shared memory
//     (opted in past 48 KB up to the card's 227 KB, 58,112 ids) and read
//     as a broadcast, or, wider still, read from global memory (through
//     L1) in place.
// The row routine (loads, compares, the sum of a row's partials) is
// row_count.cuh, shared with score_select.cu.
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../smem_optin.cuh"
#include "row_count.cuh"

namespace {

using hype_row::kRowBlock;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// The fringe in registers (kS >= s slots); tpr threads a row.
template <int kS>
__global__ void __launch_bounds__(kRowBlock)
scores_reg_kernel(const int32_t* __restrict__ nbrs,
                  const int32_t* __restrict__ fringe,
                  int32_t* __restrict__ out, int B, int L, int s, int vec4,
                  int tpr) {
  hype_row::RegFringe<kS> f;
  f.load(fringe, s);
  const int r = threadIdx.x & (tpr - 1);
  const int64_t b = (int64_t)blockIdx.x * (kRowBlock / tpr) +
                    threadIdx.x / tpr;
  const int cnt = hype_row::row_total(
      b < B ? hype_row::row_share(nbrs + b * L, L, vec4, r, tpr, f) : 0, r,
      tpr);
  if (r == 0 && b < B) out[b] = cnt;
}

// A wider fringe: one warp a row; kGlobalFringe reads the fringe where it
// lies instead of staging it in shared memory.
template <bool kGlobalFringe>
__global__ void __launch_bounds__(kThreads)
scores_kernel(const int32_t* __restrict__ nbrs,
              const int32_t* __restrict__ fringe,
              int32_t* __restrict__ out, int B, int L, int s, int vec4) {
  extern __shared__ int32_t f_smem[];  // the s fringe ids
  hype_row::PtrFringe f{f_smem, s};
  if constexpr (kGlobalFringe) {
    f.f = fringe;
  } else {
    for (int j = threadIdx.x; j < s; j += kThreads) f_smem[j] = fringe[j];
    __syncthreads();
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int b = blockIdx.x * kWarps + warp; b < B;
       b += gridDim.x * kWarps) {
    const int cnt = hype_row::row_total(
        hype_row::row_share(nbrs + (int64_t)b * L, L, vec4, lane, 32, f),
        lane, 32);
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
    const int tpr = hype_row::row_threads(L, vec4);
    const int rows = kRowBlock / tpr;
    const unsigned blocks = (unsigned)(((int64_t)B + rows - 1) / rows);
    if (s <= 16)
      scores_reg_kernel<16><<<blocks, kRowBlock, 0, stream>>>(
          nbrs, fringe, out, B, L, s, vec4, tpr);
    else
      scores_reg_kernel<32><<<blocks, kRowBlock, 0, stream>>>(
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
