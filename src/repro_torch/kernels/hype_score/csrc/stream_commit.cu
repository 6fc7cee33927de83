// The streaming engine's sequential sketch commit, hand-written for Hopper
// (sm_90a).
//
// Replaces no pallas_call: it is the fori_loop body of the JAX package's
// streaming program (src/repro/core/scoring.py:545-566), which JAX leaves
// to XLA. As plain PyTorch on the card it would be about ten small
// launches a row, 1.8M over one pass of github_like(1.0); here it is one
// launch a micro-batch.
//
// Row i of the micro-batch, in order:
//   conn[p]  = #{valid pins j : sketch[p, bucket(edge[i, j])] > 0}, one
//              count per pin (two edges in one bucket both count)
//   score[p] = (conn + fw * fcnt[i, p]) - (alpha * sizes[p]) * inv_target,
//              every product and sum rounded once in float32, in this
//              order (no FMA contraction: the JAX program rounds each);
//              -inf where sizes[p] >= cap
//   p*       = argmax score, the lowest index on ties (all -inf gives 0)
//   a valid row adds 1 to sizes[p*] and to sketch[p*, bucket] for each of
//   its valid pins, and writes parts[i] = p*; a pad row writes -1
//   bucket(id) = (uint32(id) * 2654435761u) >> (32 - bits)
//
// What bounds it on the H100: latency, not bytes or operations. The rows
// depend on each other through the sketch and the sizes, so a micro-batch
// is one block, and each row is a chain: its extent, the sketch reads, a
// block argmax, the commit. The bytes (k sketch entries per pin read, one
// written per pin) take well under a microsecond for a whole micro-batch
// of the main path. The design keeps the chain short:
//   * a warp per partition (up to 32 warps; past that warp w walks p = w,
//     w + 32, ...): its lanes read the sketch entries of the row's pins
//     and count them with a ballot, and the warp keeps its best (score, p)
//     in registers; no per-partition array exists, so any k runs in a few
//     hundred bytes of static shared memory and no scratch;
//   * three barriers a row: the commit's atomics are fire-and-forget, and
//     the next row's first barrier orders them before its reads;
//   * the sketch and the sizes are read through L2 (__ldcg), where the
//     atomics and the stores of the rows before land.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr uint32_t kHashMult = 2654435761u;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 32;

__device__ __forceinline__ int64_t bucket(int32_t id, int shift) {
  return (int64_t)(((uint32_t)id * kHashMult) >> shift);
}

__global__ void stream_commit_kernel(
    const int32_t* __restrict__ edge, const float* __restrict__ fcnt,
    const bool* __restrict__ valid_row, int32_t* sketch, int32_t* sizes,
    int32_t* __restrict__ parts, int mb, int Le, int k, int bits, float alpha,
    float fw, float inv_target, int cap) {
  __shared__ int s_end[2];  // the row's extent, double-buffered
  __shared__ float s_val[kMaxWarps];
  __shared__ int s_idx[kMaxWarps];
  __shared__ int s_part;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int shift = 32 - bits;
  const int64_t n_buckets = int64_t{1} << bits;
  if (threadIdx.x == 0) s_end[0] = s_end[1] = 0;
  __syncthreads();
  for (int i = 0; i < mb; ++i) {
    const int32_t* row = edge + (int64_t)i * Le;
    // 1. the row's extent: one past its last valid pin
    int last = 0;
    for (int j = threadIdx.x; j < Le; j += blockDim.x)
      if (row[j] >= 0) last = j + 1;
    last = __reduce_max_sync(kFull, last);
    if (lane == 0 && last > 0) atomicMax(&s_end[i & 1], last);
    __syncthreads();  // also orders the row before's commit before the reads
    const int end = s_end[i & 1];

    // 2. each warp scores its partitions, keeping the first best
    float best = -INFINITY;
    int best_p = INT_MAX;
    const float* frow = fcnt + (int64_t)i * k;
    for (int p = warp; p < k; p += n_warps) {
      const int32_t* sk = sketch + (int64_t)p * n_buckets;
      int conn = 0;
      for (int j0 = 0; j0 < end; j0 += 32) {
        const int j = j0 + lane;
        bool hit = false;
        if (j < end) {
          const int32_t id = row[j];
          hit = id >= 0 && __ldcg(sk + bucket(id, shift)) > 0;
        }
        conn += __popc(__ballot_sync(kFull, hit));
      }
      const int size = __ldcg(sizes + p);
      float score = __fsub_rn(
          __fadd_rn((float)conn, __fmul_rn(fw, frow[p])),
          __fmul_rn(__fmul_rn(alpha, (float)size), inv_target));
      if (size >= cap) score = -INFINITY;
      if (best_p == INT_MAX || score > best) {
        best = score;
        best_p = p;
      }
    }
    if (lane == 0) {
      s_val[warp] = best;
      s_idx[warp] = best_p;
    }
    if (threadIdx.x == 0) s_end[(i + 1) & 1] = 0;  // the next row's extent
    __syncthreads();

    // 3. the block's argmax (the lowest index among the maxima), then the
    // sizes and the row's part
    if (warp == 0) {
      float v = lane < n_warps ? s_val[lane] : -INFINITY;
      int idx = lane < n_warps ? s_idx[lane] : INT_MAX;
      for (int off = 16; off; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, v, off);
        const int oi = __shfl_xor_sync(kFull, idx, off);
        if (ov > v || (ov == v && oi < idx)) {
          v = ov;
          idx = oi;
        }
      }
      if (lane == 0) {
        const bool ok = valid_row[i];
        if (ok) __stcg(sizes + idx, __ldcg(sizes + idx) + 1);
        parts[i] = ok ? idx : -1;
        s_part = ok ? idx : -1;
      }
    }
    __syncthreads();

    // 4. the commit: one count per valid pin
    const int p = s_part;
    if (p >= 0) {
      int32_t* sk = sketch + (int64_t)p * n_buckets;
      for (int j = threadIdx.x; j < end; j += blockDim.x) {
        const int32_t id = row[j];
        if (id >= 0) atomicAdd(sk + bucket(id, shift), 1);
      }
    }
  }
}

}  // namespace

// Plain C entry point; the PyTorch binding (binding.cpp) checks the
// arguments, allocates ``parts`` and passes the current stream. sketch
// (k, 2**bits) and sizes (k,) are updated in place. mb >= 1.
extern "C" cudaError_t stream_commit_launch(
    const int32_t* edge, const float* fcnt, const bool* valid_row,
    int32_t* sketch, int32_t* sizes, int32_t* parts, int mb, int Le, int k,
    int bits, float alpha, float fw, float inv_target, int cap,
    cudaStream_t stream) {
  const int warps = k < 4 ? 4 : (k > kMaxWarps ? kMaxWarps : k);
  stream_commit_kernel<<<1, warps * 32, 0, stream>>>(
      edge, fcnt, valid_row, sketch, sizes, parts, mb, Le, k, bits, alpha, fw,
      inv_target, cap);
  return cudaGetLastError();
}
