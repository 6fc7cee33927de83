// K-way move gains, hand-written for Hopper (sm_90a): a row routine with
// two front ends, and the refinement screen's own kernel for the CSR
// front end.
//
// Replaces the Pallas TPU kernel ``kway_gains_kernel`` (body
// ``_gain_kernel``) in src/repro/kernels/kway_refine/kernel.py, and, in the
// refinement screen, the gather in front of it (``_gather_part_tiles`` of
// src/repro/core/scoring.py).
//
// Per row b:
//   cnt[q]     = #(parts of row b == q)                  for q in [0, k)
//   cnt_own    = #(parts of row b == own[b], own[b] >= 0)
//   gain[b, q] = float(cnt[q] - cnt_own)
// so column own[b] comes out 0, and a row with no parts all zero. A part
// outside [0, k) counts for no column, as the TPU kernel's k compare
// passes count it for none.
//
// The two front ends:
//   tile (kway_gains_launch): row b is parts[b, 0:L], -1 pads anywhere;
//     own[b] is given.
//   CSR (kway_gains_csr_launch): row b is assign[indices[indptr[c] + j]]
//     for j < min(deg(c), tile_l), c = cand[b], and own[b] = assign[c]; a
//     pad candidate (c < 0) has no parts and own -1. This is the tile of
//     the screen's plain version without building it: only the first
//     tile_l neighbours in CSR order count, as there. With the host's
//     delta (nd > 0) the delta is written into assign first,
//     by a kernel whose programmatic dependent the gains' kernel is: the
//     whole screen is one device program, as JAX's jitted one is.
//
// What bounds it on the H100. The CSR front end on the screen's path reads
// a few MB (the candidates' ids up to the cut, their parts from assign,
// which stays in L2) and writes the (B, k) gains; most rows are short
// (median degree 10) and few long (up to tile_l = 2,048), so it is bound
// by the latency of the chain cand -> indptr -> indices -> assign, by its
// longest rows, and by the random assign gathers (one L1 wavefront per
// id). The tile front end reads the whole (B, L) tile once: bytes.
//
// The CSR front end runs the screen's kernel (kway_screen_kernel below)
// wherever its row counters fit in shared memory, and the row
// routine's shared or global counters past that (k above about 7,250).
// The row routine (the tile front end at every k):
// - A block takes kRows rows at a time (a group: rows g, g + G, g + 2G,
//   ... of the G groups, so that a run of long rows spreads over the
//   blocks). Each row is cut into chunks of 32 * kPer ids; the group's
//   chunks are split evenly, in order, over the block's warps, so a long
//   row runs on several warps while short rows share one. A lane loads
//   all kPer ids of its chunk before it uses any (CSR: kPer loads of
//   indices, then kPer gathers of assign), so kPer loads are in flight
//   per lane. A warp whose chunk holds only pads skips the counting
//   after one vote.
// - Counting, k <= kPrivateK: every lane owns k counters in shared memory,
//   laid out [q][lane], so a lane always hits its own bank: a plain
//   increment, no atomic and no conflict, however many lanes hold the same
//   part. When a warp leaves a row it sums each column over its lanes
//   (lane q reads column q's 32 counters starting at its own bank, so the
//   lanes hit 32 banks), zeroes them, and adds the sums to the group's row
//   counters with shared atomics.
// - Larger k: lanes holding the same part are grouped by __match_any_sync
//   and the group's leader adds its size to the row counter, in shared
//   memory while the group's kRows rows of k counters fit the block's
//   opted-in shared memory (227 KB on an H100), else in a global int32
//   scratch that the binding allocates (kRows rows of k per block, the grid
//   capped at kGlobalBlocks; each block zeroes its rows before each group).
// - After a barrier the block writes the group's gains, each row's k
//   floats contiguous.
// Counts are integers, so a row's partial counts add to the same value in
// any order: every route gives the plain version's bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../smem_optin.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;        // rows a block takes at a time
constexpr int kPrivateK = 64;   // the largest k of lane-private counters
constexpr unsigned kFull = 0xffffffffu;
// blocks of the global-counter route: 2,048 rows of k counters (82 MB at
// k = 10,000)
constexpr int kGlobalBlocks = 256;

enum Route { kPrivate, kShared, kGlobal };

// The rows of the block's current group, filled by its first warp.
struct Group {
  int64_t start[kRows];   // offset of the row's first id
  int len[kRows];         // ids in the row
  int own[kRows];
  int own_cnt[kRows];     // #(parts == own, own >= 0), summed over warps
  int first[kRows + 1];   // the rows' first chunks (a prefix sum)
};

__device__ __forceinline__ int64_t load_ptr(const int32_t* p) {
  return __ldg(p);
}
__device__ __forceinline__ int64_t load_ptr(const int64_t* p) {
  return __ldg(reinterpret_cast<const long long*>(p));
}

// The screen's front end: parts gathered through the CSR.
template <typename Ptr>
struct CsrRows {
  static constexpr int kPer = 8;
  const Ptr* indptr;
  const int32_t* indices;
  const int32_t* assign;
  const int32_t* cand;
  int tile_l;

  __device__ __forceinline__ void row(int b, int64_t& start, int& len,
                                      int& own) const {
    start = 0;
    len = 0;
    own = -1;
    const int32_t c = __ldg(cand + b);
    if (c < 0) return;
    const int64_t s = load_ptr(indptr + c);
    const int64_t deg = load_ptr(indptr + c + 1) - s;
    own = __ldg(assign + c);
    start = s;
    len = deg <= 0 ? 0 : (deg < tile_l ? (int)deg : tile_l);
  }

  // The parts of the chunk's ids at ``off`` (-1 past the row's end).
  __device__ __forceinline__ void load(int64_t start, int off, int len,
                                       int lane, int32_t (&x)[kPer]) const {
    const int32_t* ids = indices + start + off + lane;
    const int left = len - off - lane;
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      x[i] = 32 * i < left ? __ldg(ids + 32 * i) : -1;
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      x[i] = x[i] >= 0 ? __ldg(assign + x[i]) : -1;
  }
};

// The tile's front end: rows of stride L hold the parts themselves.
struct TileRows {
  static constexpr int kPer = 16;
  const int32_t* parts;
  const int32_t* own;
  int L;
  int vec4;  // L % 4 == 0 and parts 16-byte aligned

  __device__ __forceinline__ void row(int b, int64_t& start, int& len,
                                      int& o) const {
    start = (int64_t)b * L;
    len = L;
    o = __ldg(own + b);
  }

  __device__ __forceinline__ void load(int64_t start, int off, int len,
                                       int lane, int32_t (&x)[kPer]) const {
    const int32_t* row = parts + start;
    if (vec4) {
#pragma unroll
      for (int h = 0; h < kPer / 4; ++h) {
        const int p = off + 128 * h + 4 * lane;
        const int4 v = p < len ? __ldg(reinterpret_cast<const int4*>(row + p))
                               : make_int4(-1, -1, -1, -1);
        x[4 * h] = v.x;
        x[4 * h + 1] = v.y;
        x[4 * h + 2] = v.z;
        x[4 * h + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int p = off + 32 * i + lane;
        x[i] = p < len ? __ldg(row + p) : -1;
      }
    }
  }
};

// A warp leaves row r: add its lane-private counts (kPrivate) and its own
// count to the group's row r. Called by all 32 lanes together.
template <Route R>
__device__ __forceinline__ void flush(int* hist, int* row_acc, int* own_slot,
                                      int& own_cnt, int lane, int k) {
  if constexpr (R == kPrivate) {
    __syncwarp();
    for (int q = lane; q < k; q += 32) {
      int* col = hist + q * 32;
      int s = 0;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int a = (j + lane) & 31;
        s += col[a];
        col[a] = 0;
      }
      if (s) atomicAdd(row_acc + q, s);
    }
    __syncwarp();
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    own_cnt += __shfl_xor_sync(kFull, own_cnt, o);
  if (lane == 0 && own_cnt) atomicAdd(own_slot, own_cnt);
  own_cnt = 0;
}

template <class Rows, Route R>
__global__ void __launch_bounds__(kThreads, 4)
kway_gains_kernel(Rows rows, float* __restrict__ gains,
                  int* __restrict__ scratch, int B, int k) {
  constexpr int kChunk = 32 * Rows::kPer;
  extern __shared__ int smem[];
  __shared__ Group grp;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int* hist = smem + warp * k * 32;  // kPrivate: this warp's [q][lane]
  int* acc = R == kPrivate ? smem + kWarps * k * 32
             : R == kShared ? smem
                            : scratch + (int64_t)blockIdx.x * kRows * k;
  if constexpr (R == kPrivate)
    for (int q = 0; q < k; ++q) hist[q * 32 + lane] = 0;

  // group g holds rows g, g + G, g + 2G, ...: a run of long rows (ids of
  // alike degree often sit together) spreads over the blocks
  const int G = (B + kRows - 1) / kRows;
  for (int g = blockIdx.x; g < G; g += gridDim.x) {
    if (warp == 0) {
      int64_t start = 0;
      int len = 0, own = -1;
      if (lane < kRows && g + lane * G < B)
        rows.row(g + lane * G, start, len, own);
      int n = (len + kChunk - 1) / kChunk;
#pragma unroll
      for (int d = 1; d < kRows; d <<= 1) {
        const int t = __shfl_up_sync(kFull, n, d);
        if (lane >= d) n += t;
      }
      if (lane < kRows) {
        grp.start[lane] = start;
        grp.len[lane] = len;
        grp.own[lane] = own;
        grp.own_cnt[lane] = 0;
        grp.first[lane + 1] = n;
      }
      if (lane == 0) grp.first[0] = 0;
    }
    for (int i = threadIdx.x; i < kRows * k; i += kThreads) acc[i] = 0;
    __syncthreads();

    // this warp's share of the group's chunks, in order
    const int n = grp.first[kRows];
    const int j1 = (int)((int64_t)n * (warp + 1) / kWarps);
    int r = -1, own_cnt = 0;
    for (int j = (int)((int64_t)n * warp / kWarps); j < j1; ++j) {
      int nr = r < 0 ? 0 : r;
      while (j >= grp.first[nr + 1]) ++nr;
      if (nr != r) {
        if (r >= 0)
          flush<R>(hist, acc + r * k, grp.own_cnt + r, own_cnt, lane, k);
        r = nr;
      }
      int32_t x[Rows::kPer];
      rows.load(grp.start[r], (j - grp.first[r]) * kChunk, grp.len[r], lane,
                x);
      bool any = false;
#pragma unroll
      for (int i = 0; i < Rows::kPer; ++i) any |= x[i] >= 0;
      if (!__any_sync(kFull, any)) continue;
      const int o = grp.own[r];
      int* row_acc = acc + r * k;
#pragma unroll
      for (int i = 0; i < Rows::kPer; ++i) {
        own_cnt += (x[i] == o && x[i] >= 0) ? 1 : 0;
        const bool in = (unsigned)x[i] < (unsigned)k;
        if constexpr (R == kPrivate) {
          if (in) hist[x[i] * 32 + lane] += 1;
        } else {
          const unsigned same = __match_any_sync(kFull, x[i]);
          if (in && lane == __ffs(same) - 1)
            atomicAdd(row_acc + x[i], __popc(same));
        }
      }
    }
    if (r >= 0)
      flush<R>(hist, acc + r * k, grp.own_cnt + r, own_cnt, lane, k);
    __syncthreads();

    for (int i = threadIdx.x; i < kRows * k; i += kThreads) {
      const int r = i / k;
      const int b = g + r * G;
      if (b >= B) break;
      int c;
      if constexpr (R == kGlobal)
        c = __ldcg(acc + i);  // the counters' atomics were made in L2
      else
        c = acc[i];
      gains[(int64_t)b * k + (i - r * k)] = (float)(c - grp.own_cnt[r]);
    }
    __syncthreads();  // the next group's counters must not overtake reads
  }
}

// ---- the screen's kernel: the CSR front end while its row counters fit
// in shared memory (k up to about 7,250 on an H100), alone or after the
// delta.
//
// A block takes kSRows rows (g, g + G, ...: a run of long rows spreads
// over the blocks). Lanes 0 .. kSRows - 1 of warp 0 load their row's
// candidate and offsets (the chain's first links, which no delta changes)
// and, after a delta, every thread waits for the delta's grid
// (griddepcontrol.wait) before the own part is read; with no delta the
// own part is read beside the offsets. After one barrier the block's
// ids, each row cut to tile_l, are one packed list: warp w takes lane-loads
// [w n / 8, (w + 1) n / 8) of its n, kSPer of them in flight a lane (ids,
// then their parts: plain loads of assign, which the wait makes see the
// delta's stores), so a row of 10 ids costs one lane-load, not a 256-id
// chunk, and a long row spreads over the block's warps. Each lane adds
// one to its (row, column) counter in shared memory with a shared atomic:
// column k of a row counts the parts equal to an own part at or past k,
// the only parts outside [0, k) that count. After a second barrier the
// block writes its rows' gains. No warp-private histogram to zero or
// flush, and no barrier but those two. Measured on the H100 (PERF.md, row
// 3b), at the first screen: grouping equal keys with __match_any_sync
// first, one atomic a group, was slower, and so were gathers from L2
// alone (ld.cg), rows cut into 32-id lane-loads counted by warp votes, and
// 4 or 16 rows a block.
constexpr int kSRows = 8;  // rows a block
constexpr int kSPer = 8;   // lane-loads of ids a warp keeps in flight

struct ScreenRows {
  int64_t start[kSRows];  // offset of the row's first id
  int own[kSRows];
  int off[kSRows + 1];    // the rows' first places in the packed list
};

size_t screen_smem(int k) { return sizeof(int) * (size_t)kSRows * (k + 1); }

bool screen_fits(int k) {
  return screen_smem(k) + sizeof(ScreenRows) <= (size_t)max_smem_optin();
}

// Waits until the grid this launch depends on programmatically (the
// delta) has completed and its stores are visible; returns at once when
// the launch has no such dependency.
__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

template <typename Ptr>
__global__ void __launch_bounds__(kThreads)
kway_screen_kernel(const Ptr* __restrict__ indptr,
                   const int32_t* __restrict__ indices,
                   const int32_t* assign, const int32_t* __restrict__ cand,
                   float* __restrict__ gains, int B, int tile_l, int k,
                   int after_delta) {
  extern __shared__ int cnt[];  // kSRows x (k + 1)
  __shared__ ScreenRows sr;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int G = (B + kSRows - 1) / kSRows;
  const int g = blockIdx.x;
  const int k1 = k + 1;
  int32_t c = -1;
  int64_t start = 0;
  int len = 0, own = -1;
  if (warp == 0 && lane < kSRows && g + lane * G < B) {
    c = __ldg(cand + g + lane * G);
    if (c >= 0) {
      if (!after_delta) own = __ldca(assign + c);  // beside the offsets
      start = load_ptr(indptr + c);
      const int64_t deg = load_ptr(indptr + c + 1) - start;
      len = deg <= 0 ? 0 : (deg < tile_l ? (int)deg : tile_l);
    }
  }
  for (int i = threadIdx.x; i < kSRows * k1; i += kThreads) cnt[i] = 0;
  if (after_delta) {
    wait_prior_grid();
    if (c >= 0) own = __ldca(assign + c);
  }
  if (warp == 0) {
    int n = len;
#pragma unroll
    for (int d = 1; d < kSRows; d <<= 1) {
      const int t = __shfl_up_sync(kFull, n, d);
      if (lane >= d) n += t;
    }
    if (lane < kSRows) {
      sr.start[lane] = start;
      sr.own[lane] = own;
      sr.off[lane + 1] = n;
    }
    if (lane == 0) sr.off[0] = 0;
  }
  __syncthreads();

  const int total = sr.off[kSRows];
  const int nl = (total + 31) / 32;
  const int j1 = (int)((int64_t)nl * (warp + 1) / kWarps);
  int first[kSRows];  // the rows' first places, in registers
#pragma unroll
  for (int r = 0; r < kSRows; ++r) first[r] = sr.off[r];
  for (int jb = (int)((int64_t)nl * warp / kWarps); jb < j1; jb += kSPer) {
    int32_t x[kSPer];
    int row[kSPer];
#pragma unroll
    for (int i = 0; i < kSPer; ++i) {
      const int p = (jb + i) * 32 + lane;
      int r = 0;  // the last row whose first place is at or before p
#pragma unroll
      for (int q = 1; q < kSRows; ++q) r += first[q] <= p ? 1 : 0;
      row[i] = r;
      x[i] = jb + i < j1 && p < total
                 ? __ldg(indices + sr.start[r] + (p - sr.off[r]))
                 : -1;
    }
#pragma unroll
    for (int i = 0; i < kSPer; ++i) x[i] = x[i] >= 0 ? __ldca(assign + x[i]) : -1;
#pragma unroll
    for (int i = 0; i < kSPer; ++i) {
      const int own = sr.own[row[i]];
      const int col = (unsigned)x[i] < (unsigned)k   ? x[i]
                      : x[i] >= 0 && x[i] == own ? k
                                                 : -1;
      if (col >= 0) atomicAdd(cnt + row[i] * k1 + col, 1);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kSRows * k; i += kThreads) {
    const int r = i / k;
    const int b = g + r * G;
    if (b >= B) break;
    const int own = sr.own[r];
    const int oc = own < 0 ? 0 : cnt[r * k1 + (own < k ? own : k)];
    gains[(int64_t)b * k + (i - r * k)] = (float)(cnt[r * k1 + i - r * k] - oc);
  }
}

// The host's admitted moves written into the assignment: assign[ids[i]] =
// vals[i], a pad id (-1) landing on the scratch slot n. Its blocks let the
// screen's grid launch at once (griddepcontrol.launch_dependents); the
// screen waits for this grid's stores before its first read of assign.
__global__ void kway_delta_kernel(const int32_t* __restrict__ ids,
                                  const int32_t* __restrict__ vals, int nd,
                                  int32_t* __restrict__ assign, int n) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < nd) {
    const int32_t u = ids[i];
    assign[u >= 0 ? u : n] = vals[i];
  }
}

// The screen's kernel on the stream, as a programmatic dependent of the
// launch before it (the delta) when ``after_delta``.
template <typename Ptr>
cudaError_t launch_screen(const Ptr* indptr, const int32_t* indices,
                          const int32_t* assign, const int32_t* cand,
                          float* gains, int B, int tile_l, int k,
                          bool after_delta, cudaStream_t stream) {
  auto kernel = kway_screen_kernel<Ptr>;
  const size_t smem = screen_smem(k);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((B + kSRows - 1) / kSRows));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = after_delta ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, indptr, indices, assign, cand,
                            gains, B, tile_l, k, (int)after_delta);
}

Route route(int k) {
  if (k <= kPrivateK) return kPrivate;
  if (sizeof(int) * (size_t)kRows * k + sizeof(Group) <=
      (size_t)max_smem_optin())
    return kShared;
  return kGlobal;
}

size_t smem_bytes(Route r, int k) {
  if (r == kPrivate) return sizeof(int) * (size_t)(kWarps * 32 + kRows) * k;
  return r == kShared ? sizeof(int) * (size_t)kRows * k : 0;
}

int grid_blocks(int B, Route r) {
  const int groups = (B + kRows - 1) / kRows;
  return r == kGlobal && groups > kGlobalBlocks ? kGlobalBlocks : groups;
}

template <class Rows>
cudaError_t launch(const Rows& rows, float* gains, int* scratch, int B, int k,
                   cudaStream_t stream) {
  const Route r = route(k);
  const int blocks = grid_blocks(B, r);
  if (r == kGlobal) {
    if (scratch == nullptr) return cudaErrorInvalidValue;
    kway_gains_kernel<Rows, kGlobal><<<blocks, kThreads, 0, stream>>>(
        rows, gains, scratch, B, k);
    return cudaGetLastError();
  }
  auto kernel = r == kPrivate ? kway_gains_kernel<Rows, kPrivate>
                              : kway_gains_kernel<Rows, kShared>;
  const size_t smem = smem_bytes(r, k);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, kThreads, smem, stream>>>(rows, gains, scratch, B, k);
  return cudaGetLastError();
}

// The CSR front end: the screen's kernel where its counters fit, else the
// row routine (its shared or global counters), after the delta when nd >
// 0.
template <typename Ptr>
cudaError_t csr_gains(const Ptr* indptr, const int32_t* indices,
                      int32_t* assign, int n, const int32_t* delta_ids,
                      const int32_t* delta_vals, int nd,
                      const int32_t* cand, float* gains, int* scratch, int B,
                      int tile_l, int k, cudaStream_t stream) {
  if (nd > 0) {
    kway_delta_kernel<<<(nd + kThreads - 1) / kThreads, kThreads, 0,
                        stream>>>(delta_ids, delta_vals, nd, assign, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (B == 0) return cudaSuccess;
  if (screen_fits(k))
    return launch_screen(indptr, indices, assign, cand, gains, B, tile_l, k,
                         nd > 0, stream);
  return launch(CsrRows<Ptr>{indptr, indices, assign, cand, tile_l}, gains,
                scratch, B, k, stream);
}

}  // namespace

// The int32 scratch either launch needs, in counters: 0 unless k's
// counters overflow the block's shared memory.
extern "C" int64_t kway_gains_scratch_len(int B, int k) {
  if (route(k) != kGlobal) return 0;
  return (int64_t)grid_blocks(B, kGlobal) * kRows * k;
}

// Plain C entry points; the PyTorch binding (hype_score/csrc/binding.cpp)
// checks the arguments, allocates the output and the scratch
// (``kway_gains_scratch_len`` counters, or none) and passes the current
// stream. L and tile_l are below 2**30.
extern "C" cudaError_t kway_gains_launch(const int32_t* parts,
                                         const int32_t* own, float* gains,
                                         int* scratch, int B, int L, int k,
                                         int vec4, cudaStream_t stream) {
  return launch(TileRows{parts, own, L, vec4}, gains, scratch, B, k, stream);
}

// The CSR front end, and the refinement screen as one device program: the
// delta (``nd`` ids and values, -1 pads landing on assign[n], the scratch
// slot; none when nd is 0) written into the (n + 1,) assignment, then the
// gains, the screen's kernel launched as the delta's programmatic
// dependent so that its launch and its first links overlap the delta.
extern "C" cudaError_t kway_gains_csr_launch(
    const void* indptr, int indptr64, const int32_t* indices,
    int32_t* assign, int n, const int32_t* delta_ids,
    const int32_t* delta_vals, int nd, const int32_t* cand, float* gains,
    int* scratch, int B, int tile_l, int k, cudaStream_t stream) {
  if (indptr64)
    return csr_gains(static_cast<const int64_t*>(indptr), indices, assign, n,
                     delta_ids, delta_vals, nd, cand, gains, scratch, B,
                     tile_l, k, stream);
  return csr_gains(static_cast<const int32_t*>(indptr), indices, assign, n,
                   delta_ids, delta_vals, nd, cand, gains, scratch, B, tile_l,
                   k, stream);
}
