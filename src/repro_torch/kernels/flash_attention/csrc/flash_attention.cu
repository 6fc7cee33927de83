// Flash attention forward (causal or sliding-window masks, GQA), hand-written
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ``flash_attention_fwd`` (body
// ``_flash_kernel``) in src/repro/kernels/flash_attention/kernel.py.
//
// q (B, S, Hq, D), k and v (B, S, Hkv, D), float32 or bfloat16, Hq a multiple
// of Hkv; out (B, S, Hq, D) in q's dtype. For each query row i of head h
// (kv-head h / (Hq / Hkv)) and each key tile, as the TPU kernel does:
//   s_j   = (q_i . k_j) * scale, scale = 1/sqrt(D), summed in float32
//   s_j   = masked where key j is (j >= S; j > i when causal; j <= i - window
//           with a window)
//   m'    = max(m, max_j s_j);  p_j = exp(s_j - m') (0 where masked)
//   l     = l * exp(m - m') + sum_j p_j;  acc = acc * exp(m - m') + p @ v
// and at the end out_i = acc / max(l, 1e-30), rounded once to the output
// dtype. Key tiles that the mask kills for the whole query tile are skipped
// (the TPU kernel's ``live`` test); m, l and acc never leave the SM.
//
// What bounds it on the H100: operations. A causal layer does
// 2 * B * Hq * D * S^2 FLOP (the unmasked half of QK^T and PV) on
// (2 Hq + 2 Hkv) * B * S * D elements, hundreds of FLOP per byte, so the
// bound is the FLOPs at the bf16 tensor-core peak (989 TFLOP/s).
//
// Two kernels, picked by the dtype (a branch on the type, not a fallback):
//
// bfloat16: the tensor-core kernel (flash_tc_kernel), laid out as
// FlashAttention-3 is. One CTA of three warpgroups owns one (b, q-head,
// 128-row query tile): warpgroup 2 is the producer, warpgroups 0 and 1 the
// consumers, each owning 64 query rows. Both products are Hopper's
// warpgroup MMA (wgmma), bf16 in, f32 sums:
//   S = Q K^T: m64n{BN}k16 with Q (loaded once per CTA) and the key tile
//     both read from shared memory; K's natural (key, d) layout is the
//     K-major B operand.
//   O += P V: m64n{Dp}k16 with P taken from registers: the f32
//     accumulator fragment of S is laid out as wgmma's register A fragment,
//     so P is rounded to bf16 in place and never goes through shared
//     memory. V's (key, d) layout is the MN-major (transposed) B operand,
//     which wgmma allows for bf16.
// Loads: one producer thread issues TMA copies (cp.async.bulk.tensor,
// 4-D maps over (D, H, S, B), boxes of 64 columns) of Q and of each K and V
// tile into shared memory, in the 128-byte swizzled layout the wgmma
// descriptors name (16-byte chunk c of row r of a 64-column block lands at
// chunk c ^ (r % 8); every tile starts 1024-byte aligned). Rows past S and
// columns past D arrive as zeros: D is zero-padded up to Dp, a multiple of
// 64 (a full swizzle row and a multiple of k16), zero columns of Q and K
// add nothing to the scores, and padded output columns are not written.
// K and V have two slots each, with mbarriers: the copies complete a slot's
// "full" barrier, the eight consumer warps' arrivals its "empty" one, so
// the producer refills a slot as soon as both consumers are done with it.
// setmaxnreg gives the consumers 240 registers and the producer 24.
// Consumers: iteration j issues S_j = Q K_j^T and O += P_{j-1} V_{j-1}
// back to back, waits for S_j only and runs the softmax of tile j while
// the tensor cores do P V (FlashAttention-3's intra-warpgroup overlap); O
// is rescaled by exp(m_{j-1} - m_j) once P V is done. The two consumers
// take turns issuing their products (two named barriers), so one's
// softmax runs while the other's products do (ping-pong). The last P V is
// peeled out of the loop: no branch lies between wgmma's fence and its
// products, or ptxas serializes them. Key tiles are BN = 128 / 96 / 48 /
// 64 keys at Dp = 64 / 128 / 192 / 256: the widest tile whose S and P
// registers fit beside O's in 240 (a wider one spills P and makes ptxas
// serialize the products: on an H100 at 700 W the qwen3-8b layer took
// 2.60 ms at BN = 128 and 2.03 ms at BN = 96). Shared memory is
// 128 Dp + 4 BN Dp bf16 (Q and
// the two slots of K and of V): 128 KB at Dp = 128, one CTA an SM (80 /
// 120 / 192 KB at Dp = 64 / 192 / 256).
// The softmax runs in registers: thread (warp w, lane l) of a consumer
// holds rows 16 w + l/4 and + 8, and each row's max and sum are taken over
// the quad of lanes that hold it (two shuffles). exp is the special-function
// unit's ex2.approx with the scale folded in by log2(e): p = exp2(s * scale
// * log2(e) - m * scale * log2(e)). The masks are applied only on key tiles
// that hold a masked key (the tiles at the diagonal, the window's edge and
// the ragged end); causal query tiles start with the last (the longest) to
// shorten the tail of the grid. The row sums l add the float32 p; only the
// operand of P V is rounded to bf16, so each p_j is off by at most 2^-8 of
// itself and an output row by at most 2^-8 max|v| (chip_smoke.py's
// FLASH_TOL).
//
// float32: the CUDA-core kernel (flash_attention_kernel). On tensor cores
// float32 inputs would run as TF32 (10 mantissa bits, about three decimal
// digits), which breaks the float32 tolerance of 2e-5 against the plain
// version and the reduced LM's card-against-CPU check at 1e-4; no path of
// the port's full-width serving runs attention in float32. It does the
// products as float32 FMAs: one CTA of 256 threads owns one (b, q-head,
// 64-row query tile) and loops over 64-key tiles, with the query tile and
// each key and value tile staged in shared memory, a 4 x 4 register tile
// of scores per thread, row max and sum as butterflies over 16 lanes, and
// the probabilities through shared memory for p @ v. Shared memory is
// (64 D + 64 (D + 4) + 64 D + 64 * 64) * 4 bytes (113 KB at D = 128).
//
// Both: rows and keys past S (S need not be a multiple of the tile) are
// loaded as zeros and masked, their outputs not written; offsets are
// 64-bit.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------------ float32: CUDA cores

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;             // query rows per CTA
constexpr int kBlockK = 64;             // keys per tile
constexpr int kColGroups = 16;          // lanes sharing one row group
constexpr int kRows = kBlockQ / (kThreads / kColGroups);  // rows per thread
constexpr int kKeys = kBlockK / kColGroups;               // keys per thread
constexpr float kNegInf = -1e30f;

static_assert(kRows == 4 && kKeys == 4, "the 4 x 4 register tile");

// Stage rows [row0, row0 + 64) of one head into shared memory, row stride
// ``ld`` floats; rows at or past S become zeros.
__device__ __forceinline__ void load_tile(const float* __restrict__ base,
                                          int64_t s_stride, int row0, int S,
                                          int D, float* dst, int ld) {
  const int per_row = D / 4;
  for (int v = threadIdx.x; v < kBlockQ * per_row; v += kThreads) {
    const int row = v / per_row;
    const int col = (v - row * per_row) * 4;
    float4 f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + row < S)
      f = __ldg(reinterpret_cast<const float4*>(
          base + (int64_t)(row0 + row) * s_stride + col));
    *reinterpret_cast<float4*>(dst + row * ld + col) = f;
  }
}

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = kColGroups / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = kColGroups / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// kChunks: float4 columns of the output each thread holds per row,
// ceil(D / 64) (D <= 256).
template <int kChunks>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int S, int group, int D, int64_t qsb, int64_t qss,
                       int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
                       int64_t osb, int64_t oss, int64_t osh, float scale,
                       int causal, int window) {
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // 64 x D
  const int ldk = D + 4;
  float* k_s = q_s + kBlockQ * D;                 // 64 x (D + 4)
  float* v_s = k_s + kBlockK * ldk;               // 64 x D
  float* p_s = v_s + kBlockK * D;                 // 64 x 64

  const int nq = gridDim.x;
  const int tile = causal ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const int q0 = tile * kBlockQ;
  const int tid = threadIdx.x;
  const int rg = tid / kColGroups, cg = tid % kColGroups;
  const int d4 = D / 4;

  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + hk * ksh;
  const float* vb = v + b * ksb + hk * ksh;
  load_tile(qb, qss, q0, S, D, q_s, D);

  float m[kRows], l[kRows], acc[kRows][kChunks][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.0f;
  }

  const int nk = (S + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBlockK;
    // the TPU kernel's block-level skip, uniform over the CTA
    if (causal && k0 > q0 + kBlockQ - 1) break;
    if (window > 0 && k0 + kBlockK - 1 <= q0 - window) continue;

    __syncthreads();  // the previous tile's readers are done
    load_tile(kb, kss, k0, S, D, k_s, ldk);
    load_tile(vb, kss, k0, S, D, v_s, D);
    __syncthreads();

    // scores: the 4 x 4 tile of rows rg + 16 i, keys cg + 16 jj
    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            q_s + (rg + 16 * i) * D + d);
#pragma unroll
      for (int j = 0; j < kKeys; ++j)
        kv[j] = *reinterpret_cast<const float4*>(
            k_s + (cg + 16 * j) * ldk + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          float t = s[i][j];
          t = fmaf(qv[i].x, kv[j].x, t);
          t = fmaf(qv[i].y, kv[j].y, t);
          t = fmaf(qv[i].z, kv[j].z, t);
          t = fmaf(qv[i].w, kv[j].w, t);
          s[i][j] = t;
        }
    }

    // mask, online softmax, probabilities to shared memory
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + rg + 16 * i;
      bool live[kKeys];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int kj = k0 + cg + 16 * j;
        live[j] = kj < S && (!causal || kj <= qi) &&
                  (window <= 0 || kj > qi - window);
        s[i][j] = live[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = live[j] ? expf(s[i][j] - m_new) : 0.0f;
        p_s[(rg + 16 * i) * kBlockK + cg + 16 * j] = p;
        sum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
    }
    __syncthreads();

    // acc += p @ v over the tile's 64 keys
#pragma unroll 2
    for (int j = 0; j < kBlockK; j += 4) {
      float4 pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pv[i] = *reinterpret_cast<const float4*>(
            p_s + (rg + 16 * i) * kBlockK + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = v_s + (j + jj) * D;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const int col = cg + kColGroups * c;
          if (col >= d4) continue;
          const float4 vv = *reinterpret_cast<const float4*>(vrow + 4 * col);
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const float p = jj == 0   ? pv[i].x
                            : jj == 1 ? pv[i].y
                            : jj == 2 ? pv[i].z
                                      : pv[i].w;
            acc[i][c][0] = fmaf(p, vv.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(p, vv.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(p, vv.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(p, vv.w, acc[i][c][3]);
          }
        }
      }
    }
  }

  float* ob = out + b * osb + h * osh;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + rg + 16 * i;
    if (qi >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = cg + kColGroups * c;
      if (col >= d4) continue;
      *reinterpret_cast<float4*>(ob + (int64_t)qi * oss + 4 * col) =
          make_float4(acc[i][c][0] / denom, acc[i][c][1] / denom,
                      acc[i][c][2] / denom, acc[i][c][3] / denom);
    }
  }
}

template <int kChunks>
cudaError_t launch_f32(const float* q, const float* k, const float* v,
                       float* out, int B, int S, int Hq, int Hkv, int D,
                       const int64_t* qst, const int64_t* kst,
                       const int64_t* ost, float scale, int causal,
                       int window, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(kBlockQ * D +
                                               kBlockK * (D + 4) +
                                               kBlockK * D +
                                               kBlockQ * kBlockK);
  auto kernel = flash_attention_kernel<kChunks>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, Hq, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      q, k, v, out, S, Hq / Hkv, D, qst[0], qst[1], qst[2], kst[0], kst[1],
      kst[2], ost[0], ost[1], ost[2], scale, causal, window);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const float* q, const float* k, const float* v,
                         float* out, int B, int S, int Hq, int Hkv, int D,
                         const int64_t* qst, const int64_t* kst,
                         const int64_t* ost, float scale, int causal,
                         int window, cudaStream_t stream) {
  switch ((D + 63) / 64) {
    case 1:
      return launch_f32<1>(q, k, v, out, B, S, Hq, Hkv, D, qst, kst, ost,
                           scale, causal, window, stream);
    case 2:
      return launch_f32<2>(q, k, v, out, B, S, Hq, Hkv, D, qst, kst, ost,
                           scale, causal, window, stream);
    case 3:
      return launch_f32<3>(q, k, v, out, B, S, Hq, Hkv, D, qst, kst, ost,
                           scale, causal, window, stream);
    case 4:
      return launch_f32<4>(q, k, v, out, B, S, Hq, Hkv, D, qst, kst, ost,
                           scale, causal, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// --------------------------------------------- bfloat16: tensor cores

constexpr int kTcConsumers = 256;               // two consumer warpgroups
constexpr int kTcThreads = kTcConsumers + 128;  // and one producer
constexpr int kTcBlockM = 128;  // query rows per CTA, 64 per warpgroup
constexpr int kConsumerRegs = 240;  // setmaxnreg: 2 x 128 x 240 + 128 x 24
constexpr int kProducerRegs = 24;   //   registers <= 65,536

// Keys per tile by the padded head dim: the widest tile whose S and P
// registers, beside O's, fit the consumers' 240 registers without
// serializing the products (measured on an H100: PERF.md).
constexpr int tc_block_n(int dp) {
  return dp == 64 ? 128 : dp == 128 ? 96 : dp == 192 ? 48 : 64;
}

template <int kDp>  // D padded up to a multiple of 64
struct TcShape {
  static constexpr int kBlockN = tc_block_n(kDp);  // keys per tile
  static constexpr int kColBlocks = kDp / 64;  // 128-byte column blocks
  static constexpr int kQBytes = kTcBlockM * kDp * 2;
  static constexpr int kTileBytes = kBlockN * kDp * 2;  // one K or V tile
  // Q, two slots each of K and V, 9 mbarriers, and slack to align the
  // base to 1024 bytes
  static constexpr int kSmem = kQBytes + 4 * kTileBytes + 128 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers: the producer's TMA loads complete the "full" barriers;
// the consumer warps' arrivals complete the "empty" ones
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Wait until the barrier's phase with this parity has completed. A wait
// that never ends (a fault of the pipeline) traps instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n > (1u << 26)) __trap();
  }
}

// One TMA box {64 columns, 1 head, rows, 1 batch} of a (B, S, H, D) tensor
// into a 128-byte-swizzled column block at dst; out-of-range rows and
// columns (past S, past D) arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
      "r"(row), "r"(batch)
      : "memory");
}

// ---- the two consumer warpgroups take turns issuing their products
// (named barriers 1 and 2 over their 256 threads), so one's softmax runs
// while the other's products run
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kTcConsumers) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kTcConsumers)
               : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), 128-byte swizzle.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accesses of wgmma's registers across the
// asynchronous region.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (m64 x n128, f32) += A (smem, K-major) . B (smem, K-major)
// scale_d = 0: d = A . B (the first k16 step)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (m64 x n64, f32) += A (smem, K-major) . B (smem, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (m64 x n48, f32) += A (smem, K-major) . B (smem, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[24], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (m64 x n96, f32) += A (smem, K-major) . B (smem, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[48], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (m64 x n64, f32) += A (registers, bf16) . B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32], uint32_t a0,
                                            uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// d (m64 x n128, f32) += A (registers, bf16) . B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[64], uint32_t a0,
                                            uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// d (m64 x n192, f32) += A (registers, bf16) . B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[96], uint32_t a0,
                                            uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// d (m64 x n256, f32) += A (registers, bf16) . B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[128], uint32_t a0,
                                            uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x on the special-function unit (relative error about 2^-22; -inf -> 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The running softmax of one key tile for the thread's rows a and b (its
// n8 blocks of S in s). s comes back holding the float32 probabilities;
// m and l are updated, alpha is exp(m_old - m_new) for the accumulator.
template <int kNB>
__device__ __forceinline__ void softmax_tile(float (&s)[kNB * 4], int k0,
                                             int row_a, int row_b, int c2,
                                             int S, int causal, int window,
                                             bool masked, float scale_log2,
                                             float& m_a, float& m_b,
                                             float& l_a, float& l_b,
                                             float& alpha_a,
                                             float& alpha_b) {
  if (masked) {
#pragma unroll
    for (int i = 0; i < kNB; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = k0 + 8 * i + c2 + e;
        const bool live_a = kj < S && (!causal || kj <= row_a) &&
                            (window <= 0 || kj > row_a - window);
        const bool live_b = kj < S && (!causal || kj <= row_b) &&
                            (window <= 0 || kj > row_b - window);
        if (!live_a) s[4 * i + e] = -INFINITY;
        if (!live_b) s[4 * i + 2 + e] = -INFINITY;
      }
  }
  // the row max over the quad of lanes holding the row
  float mx_a = m_a, mx_b = m_b;
#pragma unroll
  for (int i = 0; i < kNB; ++i) {
    mx_a = fmaxf(mx_a, fmaxf(s[4 * i], s[4 * i + 1]));
    mx_b = fmaxf(mx_b, fmaxf(s[4 * i + 2], s[4 * i + 3]));
  }
  mx_a = fmaxf(mx_a, __shfl_xor_sync(kFull, mx_a, 1));
  mx_a = fmaxf(mx_a, __shfl_xor_sync(kFull, mx_a, 2));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(kFull, mx_b, 1));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(kFull, mx_b, 2));
  // a row with no live key yet keeps m = -inf; its p and alpha are 0
  const float ms_a = mx_a == -INFINITY ? 0.0f : mx_a * scale_log2;
  const float ms_b = mx_b == -INFINITY ? 0.0f : mx_b * scale_log2;
  alpha_a = fast_exp2(m_a * scale_log2 - ms_a);
  alpha_b = fast_exp2(m_b * scale_log2 - ms_b);
  m_a = mx_a;
  m_b = mx_b;
  float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
  for (int i = 0; i < kNB; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[4 * i + e] = fast_exp2(fmaf(s[4 * i + e], scale_log2, -ms_a));
      s[4 * i + 2 + e] =
          fast_exp2(fmaf(s[4 * i + 2 + e], scale_log2, -ms_b));
      sum_a += s[4 * i + e];
      sum_b += s[4 * i + 2 + e];
    }
  }
  l_a = l_a * alpha_a + sum_a;
  l_b = l_b * alpha_b + sum_b;
}

// P as bf16 pairs in wgmma's register A fragment: the k16 slice kk of P
// is p[4 kk .. 4 kk + 3] (n8 blocks 2 kk and 2 kk + 1, rows a and b).
template <int kNB>
__device__ __forceinline__ void pack_p(const float (&s)[kNB * 4],
                                       uint32_t (&p)[kNB * 2]) {
#pragma unroll
  for (int i = 0; i < kNB; ++i) {
    p[2 * i] = pack_bf16(s[4 * i], s[4 * i + 1]);
    p[2 * i + 1] = pack_bf16(s[4 * i + 2], s[4 * i + 3]);
  }
}

// The accumulator fragment of a 64-row wgmma: element e of n8 block i of
// thread (warp w, lane l) is row 16 w + l/4 + 8 (e/2), column
// 8 i + 2 (l%4) + e%2.
template <int kDp>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ out, int S, int group, int D,
                int64_t osb, int64_t oss, int64_t osh, float scale_log2,
                int causal, int window) {
  using Shape = TcShape<kDp>;
  constexpr int BN = Shape::kBlockN;
  constexpr int kCB = Shape::kColBlocks;
  constexpr int kNB = BN / 8;  // n8 blocks of the scores
  constexpr uint32_t kTile = Shape::kTileBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + Shape::kQBytes;  // K tiles, two slots
  const uint32_t v_s = k_s + 2 * kTile;        // V tiles, two slots
  const uint32_t bars = v_s + 2 * kTile;       // 9 mbarriers of 8 bytes
  const uint32_t q_full = bars;
  auto k_full = [&](int st) { return bars + 8 + 8 * st; };
  auto v_full = [&](int st) { return bars + 24 + 8 * st; };
  auto k_empty = [&](int st) { return bars + 40 + 8 * st; };
  auto v_empty = [&](int st) { return bars + 56 + 8 * st; };

  const int nq = gridDim.x;
  const int tile = causal ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = tile * kTcBlockM;
  const int tid = threadIdx.x;
  // the live key tiles (the TPU kernel's block skip)
  const int nk = (S + BN - 1) / BN;
  const int kt_end = causal ? min(nk, (q0 + kTcBlockM - 1) / BN + 1) : nk;
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / BN : 0;
  const int n = kt_end - kt_begin;  // >= 1: row q0 sees itself

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < 2; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), kTcConsumers / 32);  // one arrival a warp
      mbar_init(v_empty(st), kTcConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kTcConsumers) {
    // ---- producer warpgroup: one thread issues every TMA load. Tile i
    // (key tile kt_begin + i) goes to slot i % 2; the slot's empty
    // barrier says when the consumers are done with tile i - 2.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == kTcConsumers) {
      const int hk = h / group;
      mbar_expect_tx(q_full, Shape::kQBytes);
      for (int cb = 0; cb < kCB; ++cb)
        tma_load(q_s + cb * kTcBlockM * 128, &tq, q_full, cb * 64, h, q0, b);
      for (int i = 0; i < n; ++i) {
        const int st = i & 1;
        const uint32_t par = ((i >> 1) & 1) ^ 1;  // tiles 0, 1: no wait
        const int row = (kt_begin + i) * BN;
        mbar_wait(k_empty(st), par);
        mbar_expect_tx(k_full(st), kTile);
        for (int cb = 0; cb < kCB; ++cb)
          tma_load(k_s + st * kTile + cb * BN * 128, &tk, k_full(st),
                   cb * 64, hk, row, b);
        mbar_wait(v_empty(st), par);
        mbar_expect_tx(v_full(st), kTile);
        for (int cb = 0; cb < kCB; ++cb)
          tma_load(v_s + st * kTile + cb * BN * 128, &tv, v_full(st),
                   cb * 64, hk, row, b);
      }
    }
    return;
  }

  // ---- consumer warpgroups 0 and 1, 64 query rows each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int row_a = q0 + wg * 64 + warp * 16 + (lane >> 2);
  const int row_b = row_a + 8;
  const int c2 = 2 * (lane & 3);
  const int my_turn = 1 + wg, other_turn = 2 - wg;
  // a tile holds a masked key: at the diagonal, the window's edge or S
  auto masked = [&](int kt) {
    const int k0 = kt * BN;
    return k0 + BN > S || (causal && k0 + BN - 1 > q0) ||
           (window > 0 && k0 <= q0 + kTcBlockM - 1 - window);
  };
  // this warp is done reading a slot
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  // S = Q K^T of the tile in K slot st (committed, not waited for)
  auto issue_s = [&](float (&s)[kNB * 4], int st) {
    const uint32_t k_st = k_s + st * kTile;
#pragma unroll
    for (int kk = 0; kk < kDp / 16; ++kk) {
      const uint32_t col = (kk & 3) * 32;  // k16 step inside the block
      wgmma_ss(s,
               make_desc(q_s + (kk >> 2) * kTcBlockM * 128 + wg * 64 * 128 +
                             col, 16, 1024),
               make_desc(k_st + (kk >> 2) * BN * 128 + col, 16, 1024),
               kk > 0);
    }
  };

  float o[kDp / 2];  // n8 block i of the output: o[4 i .. 4 i + 3]
#pragma unroll
  for (int e = 0; e < kDp / 2; ++e) o[e] = 0.0f;
  float s[kNB * 4];
  uint32_t p[kNB * 2];
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.0f, l_b = 0.0f;
  float alpha_a, alpha_b;

  // turns: warpgroup 0 first, then they alternate; each takes n + 1
  if (wg == 1) named_arrive(other_turn);
  mbar_wait(q_full, 0);
  mbar_wait(k_full(0), 0);
  named_sync(my_turn);
  wgmma_fence();
  issue_s(s, 0);
  wgmma_commit();
  named_arrive(other_turn);
  wgmma_wait<0>();
  fence_regs(s);
  release(k_empty(0));
  softmax_tile<kNB>(s, kt_begin * BN, row_a, row_b, c2, S, causal, window,
                    masked(kt_begin), scale_log2, m_a, m_b, l_a, l_b,
                    alpha_a, alpha_b);
  pack_p<kNB>(s, p);

  // O += P V of the tile in V slot st (committed, not waited for)
  auto issue_pv = [&](int st) {
    const uint32_t v_st = v_s + st * kTile;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)  // all Dp columns at once
      wgmma_rs_tb(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                  make_desc(v_st + kk * 16 * 128, BN * 128, 1024));
    wgmma_commit();
  };

  // Iteration i: S_i = Q K_i^T and O += P_i-1 V_i-1 are issued back to
  // back; the softmax of tile i runs while the tensor cores do P V. (No
  // branch between the fence and the products: ptxas would serialize.)
  for (int i = 1; i < n; ++i) {
    const int st = i & 1, pst = (i - 1) & 1;
    mbar_wait(k_full(st), (i >> 1) & 1);
    mbar_wait(v_full(pst), ((i - 1) >> 1) & 1);
    named_sync(my_turn);
    fence_regs(o);
    wgmma_fence();
    issue_s(s, st);
    wgmma_commit();
    issue_pv(pst);
    named_arrive(other_turn);
    wgmma_wait<1>();  // S_i is done; P V may still run
    fence_regs(s);
    release(k_empty(st));
    softmax_tile<kNB>(s, (kt_begin + i) * BN, row_a, row_b, c2, S, causal,
                      window, masked(kt_begin + i), scale_log2, m_a, m_b,
                      l_a, l_b, alpha_a, alpha_b);
    wgmma_wait<0>();
    fence_regs(o);
    release(v_empty(pst));
#pragma unroll
    for (int e = 0; e < kDp / 8; ++e) {
      o[4 * e] *= alpha_a;
      o[4 * e + 1] *= alpha_a;
      o[4 * e + 2] *= alpha_b;
      o[4 * e + 3] *= alpha_b;
    }
    pack_p<kNB>(s, p);
  }
  // the last tile's P V; warpgroup 1's last turn hands over nothing
  mbar_wait(v_full((n - 1) & 1), ((n - 1) >> 1) & 1);
  named_sync(my_turn);
  fence_regs(o);
  wgmma_fence();
  issue_pv((n - 1) & 1);
  if (wg == 0) named_arrive(other_turn);
  wgmma_wait<0>();
  fence_regs(o);

  l_a += __shfl_xor_sync(kFull, l_a, 1);
  l_a += __shfl_xor_sync(kFull, l_a, 2);
  l_b += __shfl_xor_sync(kFull, l_b, 1);
  l_b += __shfl_xor_sync(kFull, l_b, 2);
  const float inv_a = 1.0f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.0f / fmaxf(l_b, 1e-30f);
  __nv_bfloat16* ob = out + b * osb + h * osh;
#pragma unroll
  for (int e = 0; e < kDp / 8; ++e) {
    const int col = 8 * e + c2;
    if (col >= D) continue;
    if (row_a < S)
      *reinterpret_cast<uint32_t*>(ob + (int64_t)row_a * oss + col) =
          pack_bf16(o[4 * e] * inv_a, o[4 * e + 1] * inv_a);
    if (row_b < S)
      *reinterpret_cast<uint32_t*>(ob + (int64_t)row_b * oss + col) =
          pack_bf16(o[4 * e + 2] * inv_b, o[4 * e + 3] * inv_b);
  }
}

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault,
                            &found);
#endif
    return found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// The TMA map of a (B, S, H, D) bf16 tensor with strides st (batch, seq,
// head; elements) and unit stride in D: boxes of 64 columns x rows rows of
// one head, 128-byte swizzled.
bool make_map(CUtensorMap* map, const void* base, int B, int S, int H, int D,
              const int64_t* st, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  // bytes; a size-1 dimension's stride is never followed (a contiguous
  // tensor may carry any there), so it gets the packed one
  cuuint64_t strides[3];
  strides[0] = H == 1 ? (cuuint64_t)D * 2 : (cuuint64_t)st[2] * 2;
  strides[1] = S == 1 ? strides[0] * H : (cuuint64_t)st[1] * 2;
  strides[2] = B == 1 ? strides[1] * S : (cuuint64_t)st[0] * 2;
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kDp>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out,
                      int B, int S, int Hq, int Hkv, int D,
                      const int64_t* qst, const int64_t* kst,
                      const int64_t* ost, float scale, int causal,
                      int window, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, S, Hq, D, qst, kTcBlockM) ||
      !make_map(&tk, k, B, S, Hkv, D, kst, TcShape<kDp>::kBlockN) ||
      !make_map(&tv, v, B, S, Hkv, D, kst, TcShape<kDp>::kBlockN))
    return cudaErrorInvalidValue;
  constexpr int smem = TcShape<kDp>::kSmem;
  auto kernel = flash_tc_kernel<kDp>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTcBlockM - 1) / kTcBlockM, Hq, B);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), S, Hq / Hkv, D, ost[0],
      ost[1], ost[2], scale * 1.4426950408889634f, causal, window);
  return cudaGetLastError();
}

cudaError_t dispatch_tc(const void* q, const void* k, const void* v,
                        void* out, int B, int S, int Hq, int Hkv, int D,
                        const int64_t* qst, const int64_t* kst,
                        const int64_t* ost, float scale, int causal,
                        int window, cudaStream_t stream) {
  switch ((D + 63) / 64) {
    case 1:
      return launch_tc<64>(q, k, v, out, B, S, Hq, Hkv, D, qst, kst, ost,
                           scale, causal, window, stream);
    case 2:
      return launch_tc<128>(q, k, v, out, B, S, Hq, Hkv, D, qst, kst, ost,
                            scale, causal, window, stream);
    case 3:
      return launch_tc<192>(q, k, v, out, B, S, Hq, Hkv, D, qst, kst, ost,
                            scale, causal, window, stream);
    case 4:
      return launch_tc<256>(q, k, v, out, B, S, Hq, Hkv, D, qst, kst, ost,
                            scale, causal, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point; the PyTorch binding (hype_score/csrc/binding.cpp)
// checks the arguments (dtype, rank, Hq % Hkv, D a multiple of 8 in
// [8, 256], 16-byte aligned pointers and strides in the last dim's unit),
// allocates the output and passes the current stream. ``qst``, ``kst`` and
// ``ost`` are the (batch, seq, head) strides in elements of q, of k and v
// (which share them) and of out; the head dim has stride 1. ``bf16`` picks
// the element type (0: float32, 1: bfloat16); ``window`` <= 0 means none.
extern "C" cudaError_t flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int S,
    int Hq, int Hkv, int D, const int64_t* qst, const int64_t* kst,
    const int64_t* ost, float scale, int causal, int window, int bf16,
    cudaStream_t stream) {
  if (bf16)
    return dispatch_tc(q, k, v, out, B, S, Hq, Hkv, D, qst, kst, ost,
                              scale, causal, window, stream);
  return dispatch_f32(static_cast<const float*>(q),
                      static_cast<const float*>(k),
                      static_cast<const float*>(v), static_cast<float*>(out),
                      B, S, Hq, Hkv, D, qst, kst, ost, scale, causal, window,
                      stream);
}


