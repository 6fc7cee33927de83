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
// What bounds it on the H100: latency, one dependent row after another,
// not bytes or operations. Each row reads what the rows before it wrote
// (the sketch and the sizes), so a micro-batch is one block and its rows
// a chain. The bytes (k sketch entries read per pin, one written) take
// well under a microsecond for a whole micro-batch of the stream's path
// (about 111 pins over 64 rows); what costs is each row's round trips
// and barriers, times 64.
//
// How the design shortens the chain (the staged branch). Within a
// micro-batch, a row's presence bit sketch[p, b] > 0 can differ from the
// value read at launch only by turning from absent to present, and only
// for a (p, b) that an earlier valid row of the micro-batch committed:
// the commits only add, so an entry >= 0 at launch that receives a count
// is present from then on. So, once a launch, with the whole block's
// loads in flight together:
//   * staging: fw * fcnt in shared memory, the sizes in warp 0's
//     registers (lane l holds p = l, l + 32, ...), the valid rows listed
//     (a pad row writes -1 and nothing else); one read of the valid rows
//     for each row's pin count and extent;
//   * the pins placed by row, each distinct bucket given a slot of a
//     shared-memory hash table with its k presence bits gathered from the
//     sketch, a slot flagged when two pins hold it. A pin whose slot no
//     other pin holds cannot see a commit of the micro-batch, so its
//     presence is the launch's: a row with only such pins (most of the
//     stream's rows) is independent, and its conn is added into fw * fcnt
//     there and then, by all warps at once. A dependent row keeps the
//     conn of its unshared slots and lists its shared ones;
//   * the chain is warp 0 alone, over the valid rows in order, in
//     registers and shared memory: the score's second half from the sizes
//     in registers, the argmax by two warp reductions (the max of an
//     ordered key, then the lowest partition holding it: a ballot at k <=
//     32), a size bumped in a register. The independent rows run in a
//     loop of their own; a dependent row counts its shared slots in the
//     table and sets bit p* in them, with a __syncwarp. The next row's run
//     and first sum are read ahead. No block barrier and no global memory
//     on the chain;
//   * after it, the block writes the parts and adds each pin's one count
//     into the sketch (integer atomics, whose sum does not depend on their
//     order); warp 0 writes the sizes.
//
// The branches:
//   * staged (above), chosen by the launcher on the shape: k <= 256 (eight
//     partitions a lane), mb < 65,536, mb * Le < 2^31 and the staging
//     fitting shared memory. Its table has T slots for at most T / 2 pins,
//     T the largest power of two (64 to 65,536) that fits beside the
//     staging while 64 KB of the SM's 256 KB stay L1, capped at 2 mb Le
//     (8,192 slots, 4,096 pins at k = 32, mb = 64; the stream's
//     micro-batches hold at most 521);
//   * the row chain: rows one after another, each a block-wide chain (its
//     extent, the sketch read through L2 by a warp a partition, a block
//     argmax, the commit). The launcher takes it for every other shape
//     (k > 256, say); the staged kernel hands it the whole launch, before
//     writing anything but a pad row's -1, when the valid pins pass T / 2
//     (a dense tile: 90,221 pins at Le = 2,048) or the gathered sketch
//     holds an entry below 0 (no path makes one: the sketch counts pins).
//     It reads each row's ids once a partition, from L1: beside 206 KB of
//     shared memory (L1 left 28 KB) it ran a dense tile in 3.10 ms, not
//     1.91, hence the 64 KB kept.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "../../smem_optin.cuh"

namespace {

constexpr uint32_t kHashMult = 2654435761u;
constexpr uint32_t kSlotMult = 0x9E3779B1u;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 32;
constexpr int kStagedThreads = 1024;
constexpr int kStagedMaxK = 256;
constexpr int kMinSlots = 64;
constexpr int kMaxSlots = 1 << 16;  // a slot id is 16 bits
constexpr int kMaxRows = 1 << 16;   // a row id is 16 bits
constexpr int kKeepL1 = 64 * 1024;  // of the SM's 256 KB, for L1 (header)

__device__ __forceinline__ uint32_t bucket(int32_t id, int shift) {
  return ((uint32_t)id * kHashMult) >> shift;
}

// ------------------------------------------------------------ row chain
// The second branch: the rows one after another, the whole block on each.
// Any k, any pin count; blockDim.x a multiple of 32, up to 1,024.
__device__ void row_chain(const int32_t* __restrict__ edge,
                          const float* __restrict__ fcnt,
                          const bool* __restrict__ valid_row, int32_t* sketch,
                          int32_t* sizes, int32_t* __restrict__ parts, int mb,
                          int Le, int k, int bits, float alpha, float fw,
                          float inv_target, int cap) {
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

__global__ void stream_commit_chain_kernel(
    const int32_t* __restrict__ edge, const float* __restrict__ fcnt,
    const bool* __restrict__ valid_row, int32_t* sketch, int32_t* sizes,
    int32_t* __restrict__ parts, int mb, int Le, int k, int bits, float alpha,
    float fw, float inv_target, int cap) {
  row_chain(edge, fcnt, valid_row, sketch, sizes, parts, mb, Le, k, bits,
            alpha, fw, inv_target, cap);
}

// --------------------------------------------------------------- staged
// Byte offsets of the staged kernel's dynamic shared memory, from
// (mb, k, T): T hash slots for at most T / 2 pins.
struct Layout {
  int slots, max_pins, words;  // T, T / 2, ceil(k / 32)
  int base, connu, rowstart, cnt, ext, vrows, desc, parts;
  int bkt, row, pin, dpin, taken, key, mask, bytes;
};

inline int align16(int64_t x) { return (int)((x + 15) & ~int64_t{15}); }

inline Layout make_layout(int mb, int k, int slots) {
  Layout l;
  l.slots = slots;
  l.max_pins = slots / 2;
  l.words = (k + 31) / 32;
  int64_t off = 0;
  auto take = [&off](int64_t bytes) {
    const int at = (int)off;
    off = align16(off + bytes);
    return at;
  };
  l.base = take(4 * (int64_t)mb * k);        // fw * fcnt, (mb, k) float
  l.connu = take(2 * (int64_t)mb * k);       // conn of unshared slots
  l.rowstart = take(4 * ((int64_t)mb + 1));  // each row's first pin
  l.cnt = take(4 * (int64_t)mb);             // each row's pins, its fill
  l.ext = take(4 * (int64_t)mb);             // one past its last pin
  l.vrows = take(4 * (int64_t)mb);           // the valid rows, in order
  l.desc = take(16 * (int64_t)mb);           // a valid row's run
  l.parts = take(4 * (int64_t)mb);           // each valid row's p*
  l.bkt = take(4 * (int64_t)l.max_pins);     // a pin's bucket,
  l.row = take(2 * (int64_t)l.max_pins);     // ... its row
  l.pin = take(2 * (int64_t)l.max_pins);     // ... and its slot
  l.dpin = take(2 * (int64_t)l.max_pins);    // a row's shared slots
  l.taken = take(2 * (int64_t)l.max_pins);   // the slots taken, listed
  l.key = take(4 * (int64_t)slots);          // a slot's bucket, -1 empty
  l.mask = take(4 * (int64_t)slots * l.words);  // its presence bits
  l.bytes = (int)off;
  return l;
}

// The staged branch's hash slots for this shape, 0 where the row chain
// serves it.
int staged_slots(int mb, int Le, int k) {
  if (k > kStagedMaxK || mb >= kMaxRows || (int64_t)mb * Le >= INT_MAX)
    return 0;
  const int limit = max_smem_optin() - kKeepL1;
  int slots = kMinSlots;
  while (slots < kMaxSlots && slots < 2 * (int64_t)mb * Le) slots <<= 1;
  while (slots >= kMinSlots && make_layout(mb, k, slots).bytes > limit)
    slots >>= 1;
  return slots >= kMinSlots ? slots : 0;
}

constexpr int32_t kShared = 1 << 30;  // a slot's key flag: 2+ pins hold it

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

// A float's order as an unsigned key (-0 as +0, so the two tie, as they
// compare equal); -inf maps above 0, the key of no partition.
__device__ __forceinline__ uint32_t order_key(float s) {
  uint32_t u = __float_as_uint(s);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The count pass: one read of the valid rows, V ids a load (V = 4:
// 16-byte loads, each within one row). Each warp reads a contiguous run
// of the rows' chunks, a lane every 32nd, eight loads in flight; a lane
// tallies its row's pins and extent (one past its last pin) in registers
// and adds them into shared memory when its row changes.
template <int V>
__device__ void count_pins(const int32_t* __restrict__ edge, int Le,
                           int n_valid, const int* s_vrows, int* s_cnt,
                           int* s_ext) {
  constexpr int U = 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int per_row = Le / V;
  const int n_chunks = n_valid * per_row;
  const int span = (n_chunks + n_warps - 1) / n_warps;
  const int lo = warp * span;
  const int hi = n_chunks < lo + span ? n_chunks : lo + span;
  int cur = -1, n = 0, end = 0;  // the lane's row (in s_vrows), its tally
  auto flush = [&]() {
    if (cur >= 0 && n > 0) {
      atomicAdd(s_cnt + s_vrows[cur], n);
      atomicMax(s_ext + s_vrows[cur], end);
    }
  };
  for (int f0 = lo + lane; f0 < hi; f0 += 32 * U) {
    int32_t ids[U][V];
    int rs[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int f = f0 + 32 * u;
      rs[u] = -1;
#pragma unroll
      for (int v = 0; v < V; ++v) ids[u][v] = -1;
      if (f < hi) {
        rs[u] = f / per_row;
        const int32_t* src = edge + (int64_t)s_vrows[rs[u]] * Le +
                             (f - rs[u] * per_row) * V;
        if constexpr (V == 4) {
          const int4 x = *reinterpret_cast<const int4*>(src);
          ids[u][0] = x.x;
          ids[u][1] = x.y;
          ids[u][2] = x.z;
          ids[u][3] = x.w;
        } else {
          ids[u][0] = *src;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (rs[u] < 0) continue;
      if (rs[u] != cur) {
        flush();
        cur = rs[u];
        n = end = 0;
      }
      const int col = (f0 + 32 * u - rs[u] * per_row) * V;
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (ids[u][v] >= 0) {
          ++n;
          end = col + v + 1;
        }
    }
  }
  flush();
}

template <int NC>
__global__ void __launch_bounds__(kStagedThreads) stream_commit_staged_kernel(
    const int32_t* __restrict__ edge, const float* __restrict__ fcnt,
    const bool* __restrict__ valid_row, int32_t* sketch, int32_t* sizes,
    int32_t* __restrict__ parts, Layout lay, int mb, int Le, int k, int bits,
    float alpha, float fw, float inv_target, int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_base = reinterpret_cast<float*>(smem + lay.base);
  uint16_t* s_connu = reinterpret_cast<uint16_t*>(smem + lay.connu);
  int* s_rowstart = reinterpret_cast<int*>(smem + lay.rowstart);
  int* s_cnt = reinterpret_cast<int*>(smem + lay.cnt);
  int* s_ext = reinterpret_cast<int*>(smem + lay.ext);
  int* s_vrows = reinterpret_cast<int*>(smem + lay.vrows);
  int4* s_desc = reinterpret_cast<int4*>(smem + lay.desc);
  int* s_parts = reinterpret_cast<int*>(smem + lay.parts);
  uint32_t* s_bkt = reinterpret_cast<uint32_t*>(smem + lay.bkt);
  uint16_t* s_row = reinterpret_cast<uint16_t*>(smem + lay.row);
  uint16_t* s_pin = reinterpret_cast<uint16_t*>(smem + lay.pin);
  uint16_t* s_dpin = reinterpret_cast<uint16_t*>(smem + lay.dpin);
  uint16_t* s_taken = reinterpret_cast<uint16_t*>(smem + lay.taken);
  int32_t* s_key = reinterpret_cast<int32_t*>(smem + lay.key);
  uint32_t* s_mask = reinterpret_cast<uint32_t*>(smem + lay.mask);
  __shared__ int s_nvalid, s_neg, s_ntaken;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int shift = 32 - bits;
  const int64_t n_buckets = int64_t{1} << bits;
  const int W = lay.words;

  // 0. staging: the sizes into warp 0's registers, the valid rows listed
  // (a pad row's part is -1 now); fw * fcnt, zeroed counts and an empty
  // table by the rest
  int size[NC];
  if (warp == 0) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int p = 32 * c + lane;
      size[c] = p < k ? sizes[p] : 0;
    }
    int n = 0;
    for (int i0 = 0; i0 < mb; i0 += 32) {
      const int i = i0 + lane;
      const bool ok = i < mb && valid_row[i];
      const unsigned m = __ballot_sync(kFull, ok);
      if (ok) s_vrows[n + __popc(m & lanes_below(lane))] = i;
      else if (i < mb) parts[i] = -1;
      n += __popc(m);
    }
    if (lane == 0) s_nvalid = n;
  }
  for (int e = tid; e < mb * k; e += blockDim.x)
    s_base[e] = __fmul_rn(fw, fcnt[e]);
  for (int i = tid; i < mb; i += blockDim.x) s_cnt[i] = s_ext[i] = 0;
  for (int s = tid; s < lay.slots; s += blockDim.x) s_key[s] = -1;
  if (tid == 0) s_neg = s_ntaken = 0;
  __syncthreads();
  const int n_valid = s_nvalid;
  if (n_valid == 0) return;  // every row a pad row: all written

  // 1. each valid row's pins and extent
  if ((Le & 3) == 0 && (reinterpret_cast<uintptr_t>(edge) & 15) == 0)
    count_pins<4>(edge, Le, n_valid, s_vrows, s_cnt, s_ext);
  else
    count_pins<1>(edge, Le, n_valid, s_vrows, s_cnt, s_ext);
  __syncthreads();

  // 2. warp 0: each row's first pin, an exclusive scan of the counts
  if (warp == 0) {
    int carry = 0;
    for (int i0 = 0; i0 < mb; i0 += 32) {
      const int i = i0 + lane;
      const int c = i < mb ? s_cnt[i] : 0;
      int x = c;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, x, off);
        if (lane >= off) x += y;
      }
      if (i < mb) {
        s_rowstart[i] = carry + x - c;
        s_cnt[i] = 0;  // from here, the row's fill
      }
      carry += __shfl_sync(kFull, x, 31);
    }
    if (lane == 0) s_rowstart[mb] = carry;
  }
  __syncthreads();
  const int n_pins = s_rowstart[mb];
  if (n_pins > lay.max_pins) {  // past the table: the row chain, before
                                // anything but a pad row's -1 is written
    row_chain(edge, fcnt, valid_row, sketch, sizes, parts, mb, Le, k, bits,
              alpha, fw, inv_target, cap);
    return;
  }
  int slots = kMinSlots;
  while (slots < 2 * n_pins) slots <<= 1;  // <= lay.slots

  // 3. the pins, placed in their rows' runs (a row's order does not
  // matter), by warps a row (a row split over the warps where there are
  // fewer valid rows than warps); each distinct bucket takes a slot
  // (linear probing), flagged when a second pin holds it
  const int per_row = n_warps > n_valid ? n_warps / n_valid : 1;
  for (int r = warp / per_row; r < n_valid; r += n_warps / per_row) {
    const int i = s_vrows[r];
    const int32_t* row = edge + (int64_t)i * Le;
    const int end = s_ext[i];
    for (int j0 = (warp % per_row) * 32; j0 < end; j0 += per_row * 32) {
      const int j = j0 + lane;
      const int32_t id = j < end ? row[j] : -1;
      const unsigned m = __ballot_sync(kFull, id >= 0);
      if (m == 0) continue;
      int at = 0;
      if (lane == 0) at = atomicAdd(s_cnt + i, __popc(m));
      at = s_rowstart[i] + __shfl_sync(kFull, at, 0);
      int s = 0;
      bool fresh = false;  // this lane took the slot
      if (id >= 0) {
        const int q = at + __popc(m & lanes_below(lane));
        const uint32_t b = bucket(id, shift);
        s = (int)((b * kSlotMult) >> (33 - __ffs(slots)));
        for (;;) {
          const int32_t was = atomicCAS(s_key + s, -1, (int32_t)b);
          if (was == -1) {
            fresh = true;
            break;
          }
          if ((was & ~kShared) == (int32_t)b) {
            if (!(was & kShared)) atomicOr(s_key + s, kShared);
            break;
          }
          s = (s + 1) & (slots - 1);
        }
        s_bkt[q] = b;
        s_row[q] = (uint16_t)i;
        s_pin[q] = (uint16_t)s;
      }
      const unsigned took = __ballot_sync(kFull, fresh);
      if (took) {
        int t0 = 0;
        if (lane == 0) t0 = atomicAdd(&s_ntaken, __popc(took));
        t0 = __shfl_sync(kFull, t0, 0);
        if (fresh) s_taken[t0 + __popc(took & lanes_below(lane))] = s;
      }
    }
  }
  __syncthreads();
  const int n_taken = s_ntaken;

  // each taken slot's k presence bits from the sketch: a warp a slot,
  // lanes over partitions, four slots' loads in flight
  bool neg = false;
  for (int e0 = warp * 4; e0 < n_taken; e0 += n_warps * 4) {
    int slot[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      slot[u] = e0 + u < n_taken ? s_taken[e0 + u] : -1;
    for (int c = 0; c < W; ++c) {
      const int p = 32 * c + lane;
      int32_t v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        v[u] = 0;
        if (slot[u] >= 0 && p < k)
          v[u] = sketch[p * n_buckets + (s_key[slot[u]] & ~kShared)];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const unsigned bits_c = __ballot_sync(kFull, v[u] > 0);
        neg |= v[u] < 0;
        if (slot[u] >= 0 && lane == 0) s_mask[slot[u] * W + c] = bits_c;
      }
    }
  }
  if (neg) s_neg = 1;
  __syncthreads();
  if (s_neg) {  // an entry below 0 may stay absent after a count
    row_chain(edge, fcnt, valid_row, sketch, sizes, parts, mb, Le, k, bits,
              alpha, fw, inv_target, cap);
    return;
  }

  // a row's argmax over the score's second half, from the sizes in warp
  // 0's registers: the max of an ordered key, then the lowest partition
  // holding it (a ballot where a lane holds one partition); bumps p*'s size
  auto commit = [&](const float (&t)[NC]) {
    uint32_t best_key = 0, best_p = 0xffffffffu;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int p = 32 * c + lane;
      if (p < k) {
        float score = __fsub_rn(
            t[c], __fmul_rn(__fmul_rn(alpha, (float)size[c]), inv_target));
        if (size[c] >= cap) score = -INFINITY;
        const uint32_t key = order_key(score);
        if (key > best_key) {  // strict: the lane's lowest p on ties
          best_key = key;
          best_p = (uint32_t)p;
        }
      }
    }
    const uint32_t top = __reduce_max_sync(kFull, best_key);
    int ps;
    if constexpr (NC == 1) {
      ps = __ffs(__ballot_sync(kFull, best_key == top)) - 1;
    } else {
      ps = (int)__reduce_min_sync(kFull,
                                  best_key == top ? best_p : 0xffffffffu);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (32 * c + lane == ps) ++size[c];
    return ps;
  };
  // the first sum of row d.x (fw * fcnt, plus conn where independent)
  auto first_sum = [&](const int4& d, float (&t)[NC]) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int p = 32 * c + lane;
      t[c] = p < k ? s_base[d.x * k + p] : 0.f;
    }
  };
  // conn, for lane's partitions, of the n listed slots of ``pins`` (of
  // those not shared only, where ``own``): a warp of slots at a time, each
  // slot's table word passed round by shuffles
  auto count = [&](const uint16_t* pins, int n, bool own, int (&conn)[NC]) {
#pragma unroll
    for (int c = 0; c < NC; ++c) conn[c] = 0;
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + lane;
      const int slot = j < n ? pins[j] : 0;
      const bool take = j < n && !(own && (s_key[slot] & kShared));
      const int m = n - j0 < 32 ? n - j0 : 32;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c < W) {
          const uint32_t w = take ? s_mask[slot * W + c] : 0u;
          for (int jj = 0; jj < m; ++jj)
            conn[c] += (__shfl_sync(kFull, w, jj) >> lane) & 1u;
        }
      }
    }
  };

  // 4. a warp a row: the conn of its pins whose slot no other pin holds
  // cannot change within the micro-batch. A row with only such pins is
  // independent: its conn is added into fw * fcnt here. A row with a
  // shared slot is dependent: its unshared conn is kept, its shared slots
  // listed, and the chain counts those
  for (int r = warp; r < n_valid; r += n_warps) {
    const int i = s_vrows[r];
    const int q0 = s_rowstart[i];
    const int n = s_rowstart[i + 1] - q0;
    int nd = 0;  // the row's shared slots, listed from s_dpin[q0]
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + lane;
      const int slot = j < n ? s_pin[q0 + j] : 0;
      const bool shared = j < n && (s_key[slot] & kShared) != 0;
      const unsigned m = __ballot_sync(kFull, shared);
      if (shared) s_dpin[q0 + nd + __popc(m & lanes_below(lane))] = slot;
      nd += __popc(m);
    }
    int conn[NC];
    count(s_pin + q0, n, true, conn);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int p = 32 * c + lane;
      if (p >= k) continue;
      if (nd == 0)
        s_base[i * k + p] = __fadd_rn((float)conn[c], s_base[i * k + p]);
      else
        s_connu[i * k + p] = (uint16_t)conn[c];
    }
    if (lane == 0) s_desc[r] = make_int4(i, q0, nd, 0);
  }
  __syncthreads();

  // 5. the chain: warp 0, the valid rows in order, registers and shared
  // memory only. The independent rows run in a loop of their own; a
  // dependent row counts its shared slots in the table, adds its unshared
  // conn, and sets bit p* in its shared slots. The next row's run and
  // first sum are read ahead.
  if (warp == 0) {
    int r = 0;
    int4 d = s_desc[0];
    float nxt[NC];
    first_sum(d, nxt);
    for (;;) {
      while (d.z == 0) {
        const int i = d.x;
        float t[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) t[c] = nxt[c];
        if (++r < n_valid) {
          d = s_desc[r];
          first_sum(d, nxt);
        }
        const int ps = commit(t);
        if (lane == 0) s_parts[i] = ps;
        if (r == n_valid) break;
      }
      if (r == n_valid) break;
      const int i = d.x, q0 = d.y, nd = d.z;
      float t[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) t[c] = nxt[c];
      if (++r < n_valid) {
        d = s_desc[r];
        first_sum(d, nxt);
      }
      int conn[NC];
      count(s_dpin + q0, nd, false, conn);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int p = 32 * c + lane;
        const int u = p < k ? s_connu[i * k + p] : 0;
        t[c] = __fadd_rn((float)(conn[c] + u), t[c]);
      }
      const int ps = commit(t);
      if (lane == 0) s_parts[i] = ps;
      for (int j = lane; j < nd; j += 32)
        atomicOr(s_mask + s_dpin[q0 + j] * W + (ps >> 5), 1u << (ps & 31));
      __syncwarp();
      if (r == n_valid) break;
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (32 * c + lane < k) sizes[32 * c + lane] = size[c];
  }
  __syncthreads();

  // 6. the valid rows' parts, and each pin's count into the sketch
  for (int r = tid; r < n_valid; r += blockDim.x)
    parts[s_vrows[r]] = s_parts[s_vrows[r]];
  for (int q = tid; q < n_pins; q += blockDim.x)
    atomicAdd(sketch + (int64_t)s_parts[s_row[q]] * n_buckets + s_bkt[q], 1);
}

template <int NC>
cudaError_t launch_staged(const int32_t* edge, const float* fcnt,
                          const bool* valid_row, int32_t* sketch,
                          int32_t* sizes, int32_t* parts, const Layout& lay,
                          int mb, int Le, int k, int bits, float alpha,
                          float fw, float inv_target, int cap,
                          cudaStream_t stream) {
  auto kernel = stream_commit_staged_kernel<NC>;
  // opted in once a process, to all the staging may take
  static const cudaError_t opted = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      max_smem_optin() - kKeepL1);
  if (opted != cudaSuccess) return opted;
  kernel<<<1, kStagedThreads, lay.bytes, stream>>>(
      edge, fcnt, valid_row, sketch, sizes, parts, lay, mb, Le, k, bits,
      alpha, fw, inv_target, cap);
  return cudaGetLastError();
}

}  // namespace

// The branch a launch takes, from its shape and the valid pins of its
// valid rows: 0 the row chain, 1 staged, 2 the staged kernel handing the
// launch to the row chain (pins past its table). A sketch entry below 0
// also hands over; this does not look at the sketch.
extern "C" int stream_commit_branch(int mb, int Le, int k, int64_t pins) {
  const int slots = staged_slots(mb, Le, k);
  if (slots == 0) return 0;
  return pins > slots / 2 ? 2 : 1;
}

// Plain C entry point; the PyTorch binding (binding.cpp) checks the
// arguments, allocates ``parts`` and passes the current stream. sketch
// (k, 2**bits) and sizes (k,) are updated in place. mb >= 1.
extern "C" cudaError_t stream_commit_launch(
    const int32_t* edge, const float* fcnt, const bool* valid_row,
    int32_t* sketch, int32_t* sizes, int32_t* parts, int mb, int Le, int k,
    int bits, float alpha, float fw, float inv_target, int cap,
    cudaStream_t stream) {
  const int slots = staged_slots(mb, Le, k);
  if (slots > 0) {
    const Layout lay = make_layout(mb, k, slots);
    const int words = lay.words;
    if (words <= 1)
      return launch_staged<1>(edge, fcnt, valid_row, sketch, sizes, parts,
                              lay, mb, Le, k, bits, alpha, fw, inv_target,
                              cap, stream);
    if (words <= 2)
      return launch_staged<2>(edge, fcnt, valid_row, sketch, sizes, parts,
                              lay, mb, Le, k, bits, alpha, fw, inv_target,
                              cap, stream);
    if (words <= 4)
      return launch_staged<4>(edge, fcnt, valid_row, sketch, sizes, parts,
                              lay, mb, Le, k, bits, alpha, fw, inv_target,
                              cap, stream);
    return launch_staged<8>(edge, fcnt, valid_row, sketch, sizes, parts, lay,
                            mb, Le, k, bits, alpha, fw, inv_target, cap,
                            stream);
  }
  const int warps = k < 4 ? 4 : (k > kMaxWarps ? kMaxWarps : k);
  stream_commit_chain_kernel<<<1, warps * 32, 0, stream>>>(
      edge, fcnt, valid_row, sketch, sizes, parts, mb, Le, k, bits, alpha, fw,
      inv_target, cap);
  return cudaGetLastError();
}
