// Fused HYPE score + per-phase select, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ``hype_score_select_kernel`` (body
// ``_score_select_kernel``) in src/repro/kernels/hype_score/kernel.py.
//
// Per phase g:
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
// (G * R * L int32, 4 MB on the main path: G = 32, R = 16, L = 2048) is
// read once and every other input or output is tiny; the compare work is
// a few integer operations per loaded id. Those bytes take 1.3 us, so
// the design is about keeping them in flight and keeping the selection
// off the critical path:
//   * rows over the card: every (phase, row) pair is scored by the row
//     routine of row_count.cuh, shared with scores.cu: tpr threads a row,
//     about four 16-byte loads in flight per thread, a fringe of up to 32
//     ids in registers (wider: in shared memory, or read from global
//     memory where it does not fit). A block holds nt / tpr rows of one
//     phase, nt = 256 threads where a row takes 128 (L >= 2048), else 128;
//     at the main shape a phase spans 8 blocks, 256 blocks in all (of
//     128 threads: 512, and 0.1-0.2 us slower on the H100, the longer
//     ticket queue);
//   * select in the same launch: a block writes its rows' scores, then
//     takes an integer ticket on its phase's counter (an acquire-release
//     atomic, after the block's barrier). The block that draws the
//     phase's last ticket resets the counter to 0 for the next launch,
//     reads the phase's scores back from L2 (__ldcg), merges them with
//     ``prev`` and selects. The counters live in a per-device, per-stream workspace
//     that the binding allocates zeroed once; since the selecting block
//     zeroes them, no launch needs a memset and a CUDA graph replays
//     correctly. A phase of one block (L <= 128 at R = 16) keeps its
//     scores in shared memory and takes no ticket. Every block loads its
//     rows' bias and its share of ``prev`` before it scores, so the
//     selecting block waits on no load but the others' scores;
//   * selection by rank where R + P <= kRankSlots (80 on the main path):
//     with no NaN in the phase, the select_k rounds take the select_k
//     smallest slots in (value, index) order (every slot is at most
//     SELECT_PAD, below the +inf of a taken one), so each slot counts the
//     slots before it in that order, reading them 16 bytes at a time, and
//     the first select_k write themselves out: no serial rounds. Past
//     that, the rounds run on the whole block, one barrier a round. Since
//     the taken slots are the smallest, rem = max(#slots below SELECT_PAD
//     - select_k, 0), one shared count. A phase with a NaN writes (NaN,
//     R + P) for every round and counts rem over all its slots, as the
//     rounds would;
//   * the slots of the selecting block sit in shared memory, opted in
//     past 48 KB up to the card's 227 KB (58,112 slots), the same bytes
//     that held a wide fringe while the block scored; past that they sit
//     in a global scratch of (G, R + P) floats that the binding
//     allocates. Every slot is written before it is read.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../smem_optin.cuh"
#include "row_count.cuh"

namespace {

using hype_row::kFull;
using hype_row::kMaxBlock;
using hype_row::kRowBlock;
constexpr float kSelectPad = 1e30f;  // SELECT_PAD of the TPU kernel
constexpr int kRankSlots = 256;      // rank selection up to this R + P
constexpr int kPre = 2;              // pool slots a thread loads up front

// jnp.minimum(x, SELECT_PAD): NaN stays NaN (fminf would drop it).
__device__ __forceinline__ float clamp_pad(float v) {
  return isnan(v) ? v : fminf(v, kSelectPad);
}

// atomicAdd(p, 1) with acquire-release order at device scope
__device__ __forceinline__ int ticket(int32_t* p) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(p)
               : "memory");
  return old;
}

// (value, index) order, for slots that hold no NaN
__device__ __forceinline__ bool before(float va, int ia, float vb, int ib) {
  return va < vb || (va == vb && ia < ib);
}

// The selection of phase g over its n = R + P slots (``slots``: shared
// memory or the phase's scratch row), by the whole block.
// The fresh scores come from ``fresh`` (the block's own rows: a phase of
// one block) or from L2 (``scores``, written by the phase's blocks); the
// thread's first kPre pool slots were loaded into ``pv`` at the start.
// ``below`` and ``any_nan`` are shared counters, zero on entry; kBlock
// threads.
template <int kBlock>
__device__ __forceinline__ void select_phase(
    float* slots, const float* fresh, const float* __restrict__ scores,
    const float* __restrict__ prev, const float (&pv)[kPre],
    int32_t* __restrict__ sel_idx, float* __restrict__ sel_val,
    int32_t* __restrict__ rem, int g, int R, int P, int select_k,
    int* below, int* any_nan) {
  const int n = R + P;
  const int tid = threadIdx.x;
  constexpr int nt = kBlock;
  // thread tid owns slots tid, tid + nt, ...: it writes them and, in the
  // rounds, reads and takes them
  auto fresh_at = [&](int i) {
    return fresh ? fresh[i] : __ldcg(scores + (int64_t)g * R + i);
  };
  bool nan = false;
  int real = 0;  // this thread's slots below SELECT_PAD
#pragma unroll
  for (int k = 0; k < kPre; ++k) {
    const int i = tid + k * nt;
    if (i < n) {
      const float v = clamp_pad(i < R ? fresh_at(i) : pv[k]);
      slots[i] = v;
      nan |= isnan(v);
      real += v < kSelectPad;
    }
  }
  for (int i = tid + kPre * nt; i < n; i += nt) {
    const float v =
        clamp_pad(i < R ? fresh_at(i) : prev[(int64_t)g * P + (i - R)]);
    slots[i] = v;
    nan |= isnan(v);
    real += v < kSelectPad;
  }
  real = __reduce_add_sync(kFull, real);  // one shared atomic a warp
  if ((tid & 31) == 0 && real) atomicAdd(below, real);
  if (__any_sync(kFull, nan) && (tid & 31) == 0) *any_nan = 1;
  if (n <= kRankSlots && tid < ((n + 3) & ~3) - n) slots[n + tid] = INFINITY;
  int32_t* out_i = sel_idx + (int64_t)g * select_k;
  float* out_v = sel_val + (int64_t)g * select_k;
  __syncthreads();
  // rem: with no NaN the rounds take the select_k smallest slots, and the
  // slots below SELECT_PAD come first, so min(select_k, below) of them
  // are taken; a NaN round takes nothing
  if (tid == 0)
    rem[g] = *any_nan ? *below : max(*below - select_k, 0);
  if (*any_nan) {
    // every round returns (NaN, n) and takes nothing
    for (int k = tid; k < select_k; k += nt) {
      out_i[k] = n;
      out_v[k] = __int_as_float(0x7fffffff);
    }
  } else if (n <= kRankSlots) {
    // slots n .. n4 - 1 hold +inf (after every real slot, none of them
    // counted), so the slots are read four at a time, 16 bytes a load,
    // the loads of a chunk in flight together
    const int n4 = (n + 3) & ~3;
    const float4* slots4 = reinterpret_cast<const float4*>(slots);
    for (int i = tid; i < n; i += nt) {
      const float v = slots[i];
      int rank = 0;
#pragma unroll 4
      for (int j = 0; j < n4; j += 4) {
        const float4 a = slots4[j >> 2];
        rank += before(a.x, j, v, i) + before(a.y, j + 1, v, i) +
                before(a.z, j + 2, v, i) + before(a.w, j + 3, v, i);
      }
      if (rank < select_k) {
        out_i[rank] = i;
        out_v[rank] = v;
      }
    }
  } else {
    // select_k rounds of a block-wide argmin; a round's winner is taken
    // by the thread that owns it, the only one that reads it again
    __shared__ float best_v[2][kBlock / 32];
    __shared__ int best_i[2][kBlock / 32];
    for (int round = 0; round < select_k; ++round) {
      float bv = INFINITY;
      int bi = n;
      for (int i = tid; i < n; i += nt) {
        const float v = slots[i];
        if (v < bv) {  // ascending i: an equal value keeps the lower index
          bv = v;
          bi = i;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, o);
        const int oi = __shfl_xor_sync(kFull, bi, o);
        if (before(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      const int buf = round & 1;  // two buffers: one barrier a round
      if ((tid & 31) == 0) {
        best_v[buf][tid >> 5] = bv;
        best_i[buf][tid >> 5] = bi;
      }
      __syncthreads();
      bv = best_v[buf][0];
      bi = best_i[buf][0];
      for (int w = 1; w < kBlock / 32; ++w)
        if (before(best_v[buf][w], best_i[buf][w], bv, bi)) {
          bv = best_v[buf][w];
          bi = best_i[buf][w];
        }
      if (tid == 0) {
        out_i[round] = bi;
        out_v[round] = bv;
      }
      if (bi % nt == tid) slots[bi] = INFINITY;
    }
  }
}

// MAXS > 0: the fringe in registers (s <= MAXS); MAXS == 0: in shared
// memory (fringe_in_smem) or read from global memory. kGlobalSlots: the
// R + P slots live in ``scratch`` (a template, so that the shared route
// keeps shared-memory accesses).
template <int MAXS, bool kGlobalSlots, int kBlock>
__global__ void __launch_bounds__(kBlock)
score_select_kernel(const int32_t* __restrict__ nbrs,
                    const int32_t* __restrict__ fringe,
                    const float* __restrict__ bias,
                    const float* __restrict__ prev,
                    float* __restrict__ scores,
                    int32_t* __restrict__ sel_idx,
                    float* __restrict__ sel_val,
                    int32_t* __restrict__ rem, float* __restrict__ scratch,
                    int32_t* __restrict__ tickets, int R, int L, int s,
                    int P, int select_k, int vec4, int tpr, int bpp,
                    int fringe_in_smem) {
  // shared memory: the fringe while the block scores (MAXS == 0 and
  // fringe_in_smem), then the R + P slots if this block selects
  extern __shared__ __align__(16) float smem[];
  const int g = blockIdx.x / bpp;
  const int r = threadIdx.x & (tpr - 1);
  constexpr int nt = kBlock;
  const int row = (blockIdx.x % bpp) * (nt / tpr) + threadIdx.x / tpr;
  const int64_t row_id = (int64_t)g * R + row;

  __shared__ int below, any_nan;  // select_phase's counters
  if (threadIdx.x == 0) below = any_nan = 0;
  // loads that do not wait on the scoring, in flight beside it: the row's
  // bias, and the pool scores this thread merges if its block selects
  const float row_bias = r == 0 && row < R ? __ldg(bias + row_id) : 0.0f;
  float pv[kPre];
#pragma unroll
  for (int k = 0; k < kPre; ++k) {
    const int i = threadIdx.x + k * nt;
    pv[k] = i >= R && i < R + P ? __ldg(prev + (int64_t)g * P + (i - R))
                                : 0.0f;
  }

  int cnt = 0;
  if constexpr (MAXS > 0) {
    hype_row::RegFringe<MAXS> f;
    f.load(fringe + (int64_t)g * s, s);
    if (row < R) cnt = hype_row::row_share(nbrs + row_id * L, L, vec4, r,
                                           tpr, f);
  } else {
    hype_row::PtrFringe f{fringe + (int64_t)g * s, s};
    if (fringe_in_smem) {
      int32_t* fs = reinterpret_cast<int32_t*>(smem);
      for (int j = threadIdx.x; j < s; j += nt) fs[j] = f.f[j];
      f.f = fs;
      __syncthreads();
    }
    if (row < R) cnt = hype_row::row_share(nbrs + row_id * L, L, vec4, r,
                                           tpr, f);
  }
  cnt = hype_row::row_total(cnt, r, tpr);
  __shared__ float fresh_s[kBlock];  // the block's scores (bpp == 1)
  __shared__ int last;
  if (r == 0 && row < R) {
    // an exact int -> f32 conversion and one rounded add, no FMA: the
    // TPU kernel's arithmetic
    const float sc = __fadd_rn((float)cnt, row_bias);
    scores[row_id] = sc;
    fresh_s[threadIdx.x / tpr] = sc;
  }
  __syncthreads();  // (the fringe's shared memory is free from here on)
  if (bpp > 1) {
    // the ticket: an acquire-release atomic after the block's barrier, so
    // the block's scores are visible device-wide before it and the last
    // block sees every block's scores after it
    if (threadIdx.x == 0) {
      last = ticket(tickets + g) == bpp - 1;
      if (last) tickets[g] = 0;  // every block of g has drawn: reset
    }
    __syncthreads();
    if (!last) return;
  }
  float* slots = kGlobalSlots ? scratch + (int64_t)g * (R + P) : smem;
  select_phase<kBlock>(slots, bpp == 1 ? fresh_s : nullptr, scores, prev, pv,
               sel_idx, sel_val, rem, g, R, P, select_k, &below, &any_nan);
}

bool slots_fit(int R, int P) {
  return sizeof(float) * (((size_t)R + P + 3) & ~(size_t)3) <=
         (size_t)max_smem_optin();
}

template <int MAXS, bool kGlobalSlots>
cudaError_t launch_one(const int32_t* nbrs, const int32_t* fringe,
                       const float* bias, const float* prev, float* scores,
                       int32_t* sel_idx, float* sel_val, int32_t* rem,
                       float* scratch, int32_t* tickets, int G, int R, int L,
                       int s, int P, int select_k, int vec4,
                       cudaStream_t stream) {
  const size_t slots =
      kGlobalSlots ? 0 : sizeof(float) * (((size_t)R + P + 3) & ~(size_t)3);
  const size_t fringe_bytes = MAXS == 0 ? sizeof(int32_t) * (size_t)s : 0;
  const int fringe_in_smem =
      MAXS == 0 && fringe_bytes <= (size_t)max_smem_optin();
  const size_t smem =
      fringe_in_smem && fringe_bytes > slots ? fringe_bytes : slots;
  const int tpr = hype_row::row_threads(L, vec4);
  // 256 threads (two rows) a block where a row takes 128, else 128: the
  // fewer blocks a phase, the shorter its ticket queue
  const bool wide = tpr == kRowBlock && R > 1;
  auto kernel = wide ? score_select_kernel<MAXS, kGlobalSlots, kMaxBlock>
                     : score_select_kernel<MAXS, kGlobalSlots, kRowBlock>;
  const int nt = wide ? kMaxBlock : kRowBlock;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int rows = nt / tpr;  // rows of one phase a block
  const int bpp = R > 0 ? (R + rows - 1) / rows : 1;
  const int64_t blocks = (int64_t)G * bpp;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, nt, smem, stream>>>(
      nbrs, fringe, bias, prev, scores, sel_idx, sel_val, rem, scratch,
      tickets, R, L, s, P, select_k, vec4, tpr, bpp, fringe_in_smem);
  return cudaGetLastError();
}

template <int MAXS>
cudaError_t launch(const int32_t* nbrs, const int32_t* fringe,
                   const float* bias, const float* prev, float* scores,
                   int32_t* sel_idx, float* sel_val, int32_t* rem,
                   float* scratch, int32_t* tickets, int G, int R, int L,
                   int s, int P, int select_k, int vec4,
                   cudaStream_t stream) {
  if (scratch)
    return launch_one<MAXS, true>(nbrs, fringe, bias, prev, scores, sel_idx,
                                  sel_val, rem, scratch, tickets, G, R, L, s,
                                  P, select_k, vec4, stream);
  return launch_one<MAXS, false>(nbrs, fringe, bias, prev, scores, sel_idx,
                                 sel_val, rem, nullptr, tickets, G, R, L, s,
                                 P, select_k, vec4, stream);
}

}  // namespace

// The float scratch hype_score_select_launch needs: G * (R + P) slots when
// they do not fit the block's shared memory, else 0.
extern "C" int64_t hype_score_select_scratch_len(int G, int R, int P) {
  return slots_fit(R, P) ? 0 : (int64_t)G * ((int64_t)R + P);
}

// Plain C entry point; the PyTorch binding (binding.cpp) checks the
// arguments, allocates the outputs and the scratch
// (``hype_score_select_scratch_len`` floats, or none), holds ``tickets``
// (at least G int32 counters, zero before the first launch; every launch
// leaves them zero) and passes the current stream.
extern "C" cudaError_t hype_score_select_launch(
    const int32_t* nbrs, const int32_t* fringe, const float* bias,
    const float* prev, float* scores, int32_t* sel_idx, float* sel_val,
    int32_t* rem, float* scratch, int32_t* tickets, int G, int R, int L,
    int s, int P, int select_k, int vec4, cudaStream_t stream) {
  if (slots_fit(R, P))
    scratch = nullptr;
  else if (scratch == nullptr)
    return cudaErrorInvalidValue;
  if (s <= 1)
    return launch<1>(nbrs, fringe, bias, prev, scores, sel_idx, sel_val,
                     rem, scratch, tickets, G, R, L, s, P, select_k, vec4,
                     stream);
  if (s <= 4)
    return launch<4>(nbrs, fringe, bias, prev, scores, sel_idx, sel_val,
                     rem, scratch, tickets, G, R, L, s, P, select_k, vec4,
                     stream);
  if (s <= 16)
    return launch<16>(nbrs, fringe, bias, prev, scores, sel_idx, sel_val,
                      rem, scratch, tickets, G, R, L, s, P, select_k, vec4,
                      stream);
  if (s <= 32)
    return launch<32>(nbrs, fringe, bias, prev, scores, sel_idx, sel_val,
                      rem, scratch, tickets, G, R, L, s, P, select_k, vec4,
                      stream);
  return launch<0>(nbrs, fringe, bias, prev, scores, sel_idx, sel_val, rem,
                   scratch, tickets, G, R, L, s, P, select_k, vec4, stream);
}
