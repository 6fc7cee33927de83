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
// (B <= 256 rows, at most 2 MB) the launch. It is the scoring loop of
// score_select.cu without the selection: one warp per row, lanes over
// the row with 16-byte loads where the row is aligned, a warp-shuffle
// sum per row. The fringe sits in shared memory (any s), read as a
// broadcast by every lane.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int external(int32_t x, const int32_t* f,
                                        int s) {
  if (x < 0) return 0;
  bool m = false;
  for (int j = 0; j < s; ++j) m |= (x == f[j]);
  return m ? 0 : 1;
}

__global__ void __launch_bounds__(kThreads)
scores_kernel(const int32_t* __restrict__ nbrs,
              const int32_t* __restrict__ fringe,
              int32_t* __restrict__ out, int B, int L, int s, int vec4) {
  extern __shared__ int32_t f[];  // the s fringe ids
  for (int j = threadIdx.x; j < s; j += kThreads) f[j] = fringe[j];
  __syncthreads();
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
  int blocks = (B + kWarps - 1) / kWarps;
  if (blocks > 65535) blocks = 65535;
  scores_kernel<<<blocks, kThreads, sizeof(int32_t) * (size_t)s, stream>>>(
      nbrs, fringe, out, B, L, s, vec4);
  return cudaGetLastError();
}
