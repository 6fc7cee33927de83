// The row routine of the two scoring kernels (scores.cu, score_select.cu):
// the external-neighbour count of one row of a -1-padded int32 tile
// against a fringe, #valid - #(valid and in the fringe), as an integer.
//
// A row's L ids go to ``tpr`` threads (a power of two, up to kRowBlock); each thread loads kItems 16-byte vectors (or ids, where the
// rows are not 16-byte aligned) before it compares any, a fixed unrolled
// trip, so about four loads are in flight per thread; ``row_threads``
// picks tpr so that a thread has about kItems of them. The fringe is
// either in registers (RegFringe<kS>: s <= kS ids padded with -1, which
// no valid id equals; an unrolled compare chain) or in shared or global
// memory (PtrFringe: a loop over s ids, read as a broadcast). Membership
// is an OR over the fringe slots, so an id held twice counts once. The
// partial counts are integers, so any order of adding them is exact.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace hype_row {

constexpr int kRowBlock = 128;  // threads a row, at most
constexpr int kMaxBlock = 256;  // threads of a block of either kernel, at most
constexpr int kItems = 4;       // loads in flight per thread
constexpr unsigned kFull = 0xffffffffu;

template <int kS>
struct RegFringe {
  int32_t f[kS];
  // s ids from ``src`` (s <= kS), -1 past them
  __device__ __forceinline__ void load(const int32_t* src, int s) {
#pragma unroll
    for (int j = 0; j < kS; ++j) f[j] = j < s ? __ldg(src + j) : -1;
  }
  __device__ __forceinline__ bool has(int32_t x) const {
    bool m = false;
#pragma unroll
    for (int j = 0; j < kS; ++j) m |= x == f[j];
    return m;
  }
};

struct PtrFringe {
  const int32_t* f;
  int s;
  __device__ __forceinline__ bool has(int32_t x) const {
    bool m = false;
    for (int j = 0; j < s; ++j) m |= x == f[j];
    return m;
  }
};

// a fringe in registers: membership first, then one select, no branch
// per id; in memory: a pad skips the loop over the fringe
template <int kS>
__device__ __forceinline__ int external(int32_t x, const RegFringe<kS>& f) {
  const bool m = f.has(x);
  return x >= 0 && !m ? 1 : 0;
}
__device__ __forceinline__ int external(int32_t x, const PtrFringe& f) {
  if (x < 0) return 0;
  return f.has(x) ? 0 : 1;
}

// This thread's share of the row: vectors (or ids) r, r + tpr, ...
template <class Fr>
__device__ __forceinline__ int row_share(const int32_t* __restrict__ row,
                                         int L, int vec4, int r, int tpr,
                                         const Fr& f) {
  int cnt = 0;
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
        cnt += external(q[k].x, f) + external(q[k].y, f) +
               external(q[k].z, f) + external(q[k].w, f);
    }
  } else {
    for (int c = r; c < L; c += kItems * tpr) {
      int32_t x[kItems];
#pragma unroll
      for (int k = 0; k < kItems; ++k)
        x[k] = c + k * tpr < L ? __ldg(row + c + k * tpr) : -1;
#pragma unroll
      for (int k = 0; k < kItems; ++k) cnt += external(x[k], f);
    }
  }
  return cnt;
}

// The row's count from its threads' shares, valid in the row's thread
// r == 0: shuffles within a warp, then, when a row spans warps, shared
// memory. Called by every thread of the block (a row's threads are an
// aligned run of tpr lanes).
__device__ __forceinline__ int row_total(int cnt, int r, int tpr) {
  for (int o = (tpr < 32 ? tpr : 32) >> 1; o > 0; o >>= 1)
    cnt += __shfl_xor_sync(kFull, cnt, o);
  if (tpr <= 32) return cnt;
  __shared__ int part[kMaxBlock / 32];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = cnt;
  __syncthreads();
  int sum = 0;
  if (r == 0)
    for (int w = 0; w < tpr / 32; ++w) sum += part[(threadIdx.x >> 5) + w];
  return sum;
}

// Threads a row: a power of two up to kRowBlock, about kItems loads each.
inline int row_threads(int L, int vec4) {
  const int items = vec4 ? L / 4 : L;
  int tpr = 1;
  while (tpr < kRowBlock && tpr * kItems < items) tpr <<= 1;
  return tpr;
}

}  // namespace hype_row
