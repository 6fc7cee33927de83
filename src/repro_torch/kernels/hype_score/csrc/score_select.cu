// Fused HYPE score + per-phase select, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ``hype_score_select_kernel`` (body
// ``_score_select_kernel``) in src/repro/kernels/hype_score/kernel.py.
//
// Per phase g (one CTA each):
//   score[g, r] = float(#valid(nbrs[g, r, :]) - #(valid & in fringe[g]))
//                 + bias[g, r]
//   merged      = min([score[g, :] | prev[g, :]], SELECT_PAD), NaN kept
//   select_k rounds of argmin over merged on (value, index): the lowest
//   index wins a tie, a taken slot becomes +inf, and a NaN anywhere in
//   the phase makes the round return (NaN, R + P) -- what the TPU
//   kernel's min-then-first-equal-index reduction gives.
//   rem[g]      = #slots still < SELECT_PAD after selection
//
// What bounds it on the H100: by its work, bytes. The neighbour tile
// (G * R * L int32, 4 MB on the main path) is read once and every other
// input or output is tiny; the compare work is a few integer operations
// per loaded id. At the main path's size those bytes take about a
// microsecond, so the launch and the select_k serial selection rounds
// dominate. The design keeps the tile out of shared memory: warps stride
// over a phase's rows, lanes over the row with 16-byte loads where the
// row is aligned, and a warp-shuffle sum per row leaves one score. The
// fringe row sits in registers (at most 16 ids, padded with -1, which no
// valid id equals). Selection is small (R + P slots) and runs in warp 0
// alone over shared memory, so it needs no block barrier per round. Only
// G CTAs run (32 on the main path); a later change can split the rows
// over more CTAs and fuse the CSR gather in front of the scoring.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kSelectPad = 1e30f;  // SELECT_PAD of the TPU kernel
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// jnp.minimum(x, SELECT_PAD): NaN stays NaN (fminf would drop it).
__device__ __forceinline__ float clamp_pad(float v) {
  return isnan(v) ? v : fminf(v, kSelectPad);
}

struct Best {
  float v;
  int i;
};

// Lexicographic (value, index) minimum. A NaN on either side gives
// (NaN, nan_idx): associative and commutative up to the NaN payload, so
// any reduction order returns the same slot.
__device__ __forceinline__ Best take_better(Best a, Best b, int nan_idx) {
  const bool an = isnan(a.v), bn = isnan(b.v);
  if (an || bn) return Best{an ? a.v : b.v, nan_idx};
  if (b.v < a.v || (b.v == a.v && b.i < a.i)) return b;
  return a;
}

template <int MAXS>
__device__ __forceinline__ void tally(int32_t x, const int32_t (&f)[MAXS],
                                      int& valid, int& member) {
  if (x >= 0) {
    ++valid;
    bool m = false;
#pragma unroll
    for (int j = 0; j < MAXS; ++j) m |= (x == f[j]);
    member += m ? 1 : 0;
  }
}

template <int MAXS>
__global__ void __launch_bounds__(kThreads)
score_select_kernel(const int32_t* __restrict__ nbrs,
                    const int32_t* __restrict__ fringe,
                    const float* __restrict__ bias,
                    const float* __restrict__ prev,
                    float* __restrict__ scores,
                    int32_t* __restrict__ sel_idx,
                    float* __restrict__ sel_val,
                    int32_t* __restrict__ rem,
                    int R, int L, int s, int P, int select_k, int vec4) {
  extern __shared__ float merged[];  // R + P slots: [fresh | pool]
  const int g = blockIdx.x;
  const int n_slots = R + P;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  int32_t f[MAXS];
#pragma unroll
  for (int j = 0; j < MAXS; ++j)
    f[j] = j < s ? fringe[(int64_t)g * s + j] : -1;

  for (int p = threadIdx.x; p < P; p += kThreads)
    merged[R + p] = clamp_pad(prev[(int64_t)g * P + p]);

  for (int r = warp; r < R; r += kWarps) {
    const int64_t row_id = (int64_t)g * R + r;
    const int32_t* row = nbrs + row_id * L;
    int valid = 0, member = 0;
    if (vec4) {
      const int4* row4 = reinterpret_cast<const int4*>(row);
      for (int c = lane; c < (L >> 2); c += 32) {
        const int4 q = __ldg(row4 + c);
        tally<MAXS>(q.x, f, valid, member);
        tally<MAXS>(q.y, f, valid, member);
        tally<MAXS>(q.z, f, valid, member);
        tally<MAXS>(q.w, f, valid, member);
      }
    } else {
      for (int c = lane; c < L; c += 32)
        tally<MAXS>(__ldg(row + c), f, valid, member);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      valid += __shfl_xor_sync(kFull, valid, off);
      member += __shfl_xor_sync(kFull, member, off);
    }
    if (lane == 0) {
      // an exact int -> f32 conversion and one rounded add, no FMA: the
      // TPU kernel's arithmetic
      const float sc = __fadd_rn((float)(valid - member), bias[row_id]);
      scores[row_id] = sc;
      merged[r] = clamp_pad(sc);
    }
  }
  __syncthreads();
  if (warp != 0) return;

  for (int round = 0; round < select_k; ++round) {
    Best b{INFINITY, n_slots};
    for (int i = lane; i < n_slots; i += 32)
      b = take_better(b, Best{merged[i], i}, n_slots);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const Best o{__shfl_xor_sync(kFull, b.v, off),
                   __shfl_xor_sync(kFull, b.i, off)};
      b = take_better(b, o, n_slots);
    }
    if (lane == 0) {
      sel_idx[(int64_t)g * select_k + round] = b.i;
      sel_val[(int64_t)g * select_k + round] = b.v;
    }
    if (b.i < n_slots && (b.i & 31) == lane) merged[b.i] = INFINITY;
    __syncwarp();
  }
  int left = 0;
  for (int i = lane; i < n_slots; i += 32) left += merged[i] < kSelectPad;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    left += __shfl_xor_sync(kFull, left, off);
  if (lane == 0) rem[g] = left;
}

template <int MAXS>
cudaError_t launch(const int32_t* nbrs, const int32_t* fringe,
                   const float* bias, const float* prev, float* scores,
                   int32_t* sel_idx, float* sel_val, int32_t* rem, int G,
                   int R, int L, int s, int P, int select_k, int vec4,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(R + P);
  score_select_kernel<MAXS><<<G, kThreads, smem, stream>>>(
      nbrs, fringe, bias, prev, scores, sel_idx, sel_val, rem, R, L, s, P,
      select_k, vec4);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point; the PyTorch binding (binding.cpp) checks the
// arguments, allocates the outputs and passes the current stream.
extern "C" cudaError_t hype_score_select_launch(
    const int32_t* nbrs, const int32_t* fringe, const float* bias,
    const float* prev, float* scores, int32_t* sel_idx, float* sel_val,
    int32_t* rem, int G, int R, int L, int s, int P, int select_k, int vec4,
    cudaStream_t stream) {
  if (s <= 1)
    return launch<1>(nbrs, fringe, bias, prev, scores, sel_idx, sel_val,
                     rem, G, R, L, s, P, select_k, vec4, stream);
  if (s <= 4)
    return launch<4>(nbrs, fringe, bias, prev, scores, sel_idx, sel_val,
                     rem, G, R, L, s, P, select_k, vec4, stream);
  return launch<16>(nbrs, fringe, bias, prev, scores, sel_idx, sel_val,
                    rem, G, R, L, s, P, select_k, vec4, stream);
}
