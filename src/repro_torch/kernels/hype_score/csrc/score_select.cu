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
// row is aligned, and a warp-shuffle sum per row leaves one score. A
// fringe of up to 16 ids sits in registers (padded with -1, which no
// valid id equals; the main path's is 1 wide); a wider one in shared
// memory, read as a broadcast, as scores.cu keeps it. Selection runs in
// warp 0 alone over the R + P merged slots, so it needs no block barrier
// per round. The slots sit in shared memory, opted in past 48 KB up to
// the card's 227 KB (58,112 slots); past that they sit in a global
// scratch of (G, R + P) floats that the binding allocates, and a fringe
// that no longer fits beside them is read from global memory. Every slot
// is written before it is read, so the scratch needs no clearing. Only
// G CTAs run (32 on the main path); a later change can split the rows
// over more CTAs and fuse the CSR gather in front of the scoring.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../smem_optin.cuh"

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

// The fringe of a phase: MAXS > 0 ids in registers, or (MAXS == 0) s ids
// in shared or global memory.
template <int MAXS>
struct Fringe {
  int32_t f[MAXS];
  __device__ __forceinline__ bool has(int32_t x) const {
    bool m = false;
#pragma unroll
    for (int j = 0; j < MAXS; ++j) m |= (x == f[j]);
    return m;
  }
};
template <>
struct Fringe<0> {
  const int32_t* f;
  int s;
  __device__ __forceinline__ bool has(int32_t x) const {
    bool m = false;
    for (int j = 0; j < s; ++j) m |= (x == f[j]);
    return m;
  }
};

template <int MAXS>
__device__ __forceinline__ void tally(int32_t x, const Fringe<MAXS>& f,
                                      int& valid, int& member) {
  if (x >= 0) {
    ++valid;
    member += f.has(x) ? 1 : 0;
  }
}

// kGlobalSlots: the R + P slots live in ``scratch``, not in shared memory
// (a template, so that the shared route keeps shared-memory accesses).
template <int MAXS, bool kGlobalSlots>
__global__ void __launch_bounds__(kThreads)
score_select_kernel(const int32_t* __restrict__ nbrs,
                    const int32_t* __restrict__ fringe,
                    const float* __restrict__ bias,
                    const float* __restrict__ prev,
                    float* __restrict__ scores,
                    int32_t* __restrict__ sel_idx,
                    float* __restrict__ sel_val,
                    int32_t* __restrict__ rem, float* __restrict__ scratch,
                    int R, int L, int s, int P, int select_k, int vec4,
                    int fringe_in_smem) {
  // shared memory: [the R + P slots, unless in scratch | the fringe, when
  // MAXS == 0 and fringe_in_smem]
  extern __shared__ float smem[];
  const int g = blockIdx.x;
  const int n_slots = R + P;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // R + P slots: [fresh | pool]
  float* merged = kGlobalSlots ? scratch + (int64_t)g * n_slots : smem;

  Fringe<MAXS> f;
  if constexpr (MAXS > 0) {
#pragma unroll
    for (int j = 0; j < MAXS; ++j)
      f.f[j] = j < s ? fringe[(int64_t)g * s + j] : -1;
  } else {
    f.s = s;
    f.f = fringe + (int64_t)g * s;
    if (fringe_in_smem) {
      int32_t* fs =
          reinterpret_cast<int32_t*>(smem + (kGlobalSlots ? 0 : n_slots));
      for (int j = threadIdx.x; j < s; j += kThreads) fs[j] = f.f[j];
      f.f = fs;
      __syncthreads();
    }
  }

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

bool slots_fit(int R, int P) {
  return sizeof(float) * ((size_t)R + P) <= (size_t)max_smem_optin();
}

template <int MAXS, bool kGlobalSlots>
cudaError_t launch_one(const int32_t* nbrs, const int32_t* fringe,
                       const float* bias, const float* prev, float* scores,
                       int32_t* sel_idx, float* sel_val, int32_t* rem,
                       float* scratch, int G, int R, int L, int s, int P,
                       int select_k, int vec4, cudaStream_t stream) {
  const size_t slots = kGlobalSlots ? 0 : sizeof(float) * ((size_t)R + P);
  const size_t fringe_bytes = MAXS == 0 ? sizeof(int32_t) * (size_t)s : 0;
  const int fringe_in_smem =
      MAXS == 0 && slots + fringe_bytes <= (size_t)max_smem_optin();
  const size_t smem = slots + (fringe_in_smem ? fringe_bytes : 0);
  auto kernel = score_select_kernel<MAXS, kGlobalSlots>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<G, kThreads, smem, stream>>>(nbrs, fringe, bias, prev, scores,
                                        sel_idx, sel_val, rem, scratch, R, L,
                                        s, P, select_k, vec4,
                                        fringe_in_smem);
  return cudaGetLastError();
}

template <int MAXS>
cudaError_t launch(const int32_t* nbrs, const int32_t* fringe,
                   const float* bias, const float* prev, float* scores,
                   int32_t* sel_idx, float* sel_val, int32_t* rem,
                   float* scratch, int G, int R, int L, int s, int P,
                   int select_k, int vec4, cudaStream_t stream) {
  if (scratch)
    return launch_one<MAXS, true>(nbrs, fringe, bias, prev, scores, sel_idx,
                                  sel_val, rem, scratch, G, R, L, s, P,
                                  select_k, vec4, stream);
  return launch_one<MAXS, false>(nbrs, fringe, bias, prev, scores, sel_idx,
                                 sel_val, rem, nullptr, G, R, L, s, P,
                                 select_k, vec4, stream);
}

}  // namespace

// The float scratch hype_score_select_launch needs: G * (R + P) slots when
// they do not fit the block's shared memory, else 0.
extern "C" int64_t hype_score_select_scratch_len(int G, int R, int P) {
  return slots_fit(R, P) ? 0 : (int64_t)G * ((int64_t)R + P);
}

// Plain C entry point; the PyTorch binding (binding.cpp) checks the
// arguments, allocates the outputs and the scratch
// (``hype_score_select_scratch_len`` floats, or none) and passes the
// current stream.
extern "C" cudaError_t hype_score_select_launch(
    const int32_t* nbrs, const int32_t* fringe, const float* bias,
    const float* prev, float* scores, int32_t* sel_idx, float* sel_val,
    int32_t* rem, float* scratch, int G, int R, int L, int s, int P,
    int select_k, int vec4, cudaStream_t stream) {
  if (slots_fit(R, P))
    scratch = nullptr;
  else if (scratch == nullptr)
    return cudaErrorInvalidValue;
  if (s <= 1)
    return launch<1>(nbrs, fringe, bias, prev, scores, sel_idx, sel_val,
                     rem, scratch, G, R, L, s, P, select_k, vec4, stream);
  if (s <= 4)
    return launch<4>(nbrs, fringe, bias, prev, scores, sel_idx, sel_val,
                     rem, scratch, G, R, L, s, P, select_k, vec4, stream);
  if (s <= 16)
    return launch<16>(nbrs, fringe, bias, prev, scores, sel_idx, sel_val,
                      rem, scratch, G, R, L, s, P, select_k, vec4, stream);
  return launch<0>(nbrs, fringe, bias, prev, scores, sel_idx, sel_val, rem,
                   scratch, G, R, L, s, P, select_k, vec4, stream);
}
