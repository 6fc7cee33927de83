// Flash attention backward (causal or sliding-window masks, GQA), hand-written
// for Hopper (sm_90a).
//
// The gradient of ``flash_attention_fwd`` (src/repro/kernels/flash_attention/
// kernel.py), which has no TPU backward: the JAX model differentiates its
// einsum attention with jax.grad, and the port's training path runs the
// forward kernel, so it needs this backward to train through it.
//
// q (B, S, Hq, D), k and v (B, S, Hkv, D), out and dout (B, S, Hq, D), all
// float32 or all bfloat16, Hq a multiple of Hkv (q-head h reads kv-head
// h / (Hq / Hkv)); lse (B, Hq, S) float32, the forward's logsumexp of each
// query row (flash_attention.cu writes it); dq, dk and dv in the input
// dtype. With P the softmax of the masked scores s = (q . k) * scale
// (scale = 1/sqrt(D)):
//   delta_i = sum_d dout_id out_id                               (pass a)
//   p_ij    = exp(s_ij - lse_i)              (0 where masked)
//   ds_ij   = p_ij (dout_i . v_j - delta_i)
//   dv_j    = sum_i p_ij dout_i,  dk_j = scale sum_i ds_ij q_i  (pass b)
//   dq_i    = scale sum_j ds_ij k_j                               (pass c)
// dk and dv of a kv-head sum over its Hq / Hkv query heads. Every sum is
// float32; the outputs are rounded once. Masks as the forward: key j is
// masked for query i when j >= S, j > i (causal) or j <= i - window (a
// window); rows and keys past S are loaded as zeros and masked, their
// outputs not written.
//
// Three launches, no atomics, so a repeated backward gives the same bits:
//   pass a (attn_bwd_delta_kernel): delta into a float32 scratch of
//     (B, Hq, Sp) rows, Sp = S rounded up to 128, beside lse * log2(e)
//     (0 past S) in the same layout, so the tensor-core passes can copy a
//     tile's rows with one flat TMA copy each;
//   pass b: one CTA per (b, kv-head, key tile) walks its G query heads
//     and, for each, the query tiles that see the tile, in that fixed
//     order; dk and dv stay in registers until the end;
//   pass c: one CTA per (b, q-head, query tile) walks the key tiles the
//     tile sees; dq stays in registers.
// Passes b and c recompute s and dout . v from the tiles (no (S, S) tensor
// is ever stored): seven products where the bound counts five.
//
// What bounds it on the H100: operations. A causal layer's backward needs
// the five products of 2 D FLOP per unmasked (query, key) pair (QK^T,
// dO V^T, P^T dO, dS^T Q, dS K): 2.5 times the forward's two, at the bf16
// tensor-core peak.
//
// Two designs, picked by the dtype and D (a branch on shape and type,
// never a fallback on failure):
//
// bfloat16 with D <= 128 (every head width of the port's LM configs): the
// tensor-core passes, laid out as FlashAttention-3's backward and built
// from the forward's machinery (flash_tc.cuh: TMA maps of swizzled column
// blocks, wgmma descriptors, mbarrier rings). D is zero-padded to Dp = 64,
// 96 or 128: the forward pads to a multiple of 64, but Dp = 96 (32-column
// blocks with a 64-byte swizzle) gives D = 80, the LM training shape's,
// 0.75x the tensor work of Dp = 128 and is the faster of the two there on
// the H100 (PERF.md, row 6b).
//   pass b (attn_bwd_dkdv_tc_kernel): two consumer warpgroups of 64 keys
//     each over a 128-key tile, thread 0 issuing the copies (no producer
//     warpgroup: kTcThreads says why). K and V are loaded once; Q, dout,
//     lse * log2(e) and delta tiles of 64 query rows stream through a
//     two-slot ring. Each consumer computes S^T = K Q^T and dP^T =
//     V dout^T on wgmma from shared memory (Q's and dout's (row, d) layout
//     is the K-major B operand), forms P^T = exp2(S^T scale log2(e) - lse
//     log2(e)) and dS^T = P^T (dP^T - delta) in registers, rounds each to
//     bf16 in place as wgmma's register A fragment (as the forward does
//     with P), and accumulates dV += P^T dout and dK += dS^T Q with dout
//     and Q as the MN-major (transposed) B operand. dV's product runs
//     while dS is formed. Causal: key tile 0, the longest walk, has the
//     lowest block index.
//   pass c (attn_bwd_dq_tc_kernel): as the forward, one CTA per 128 query
//     rows, two consumers of 64; K and V tiles of 64 keys stream through
//     the ring. S = Q K^T and dP = dout V^T from shared memory, dS formed
//     in registers as the A fragment, then dQ += dS K with K as the
//     MN-major B operand. Causal query tiles run longest first.
//   Numerics: the products are exact and summed in float32; P and dS are
//   rounded to bf16 as operands, so each term of dv moves by at most 2^-8
//   of p |dout|, and of dk and dq by 2^-8 of scale |ds| |q| or |k|
//   (chip_smoke.py's BWD_TOL). delta and the rows' exp2 stay float32.
//
// float32, and bfloat16 with D in (128, 256]: the CUDA-core passes b and c
// (attn_bwd_dkdv_kernel, attn_bwd_dq_kernel). On tensor cores float32 would
// run as TF32 and break its limits (flash_attention.cu's header says why);
// D above 128 would leave the tensor-core passes no registers. They do the
// products as float32 FMAs: 256 threads a block, tiles of kT = 64 rows and
// keys for D <= 128 and 32 above (the four D-wide float32 tiles fit 227 KB
// of shared memory); thread (rg, cg) = (tid / 16, tid % 16) holds the score
// tile's rows rg + 16 i and keys cg + 16 j, and in the products that sum
// over a tile the rows (or keys) rg + 16 i and float4 columns cg + 16 c.
// Shared rows are D + 4 floats apart, so the sixteen lanes of a row group
// read sixteen different banks. The inputs are widened to float32 in
// shared memory.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "flash_tc.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kLanes = 16;          // lanes sharing one row group
constexpr float kLog2e = 1.4426950408889634f;

// Rows of the (B, Hq, Sp) scratch: S rounded up to the tensor-core dQ
// pass's 128-row tile, so every tile's rows lie inside it.
constexpr int kPadRows = 128;
int padded_rows(int S) { return (S + kPadRows - 1) / kPadRows * kPadRows; }

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  __nv_bfloat162 a, b;
  memcpy(&a, &u.x, 4);
  memcpy(&b, &u.y, 4);
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  memcpy(&u.x, &a, 4);
  memcpy(&u.y, &b, 4);
  *reinterpret_cast<uint2*>(p) = u;
}

// The float32 dot product of 16 bytes of a and of b (4 floats, 8 bf16).
__device__ __forceinline__ float dot16(const float* a, const float* b) {
  const float4 x = load4(a), y = load4(b);
  return fmaf(x.w, y.w, fmaf(x.z, y.z, fmaf(x.y, y.y, x.x * y.x)));
}
__device__ __forceinline__ float dot16(const __nv_bfloat16* a,
                                       const __nv_bfloat16* b) {
  const uint4 x = __ldg(reinterpret_cast<const uint4*>(a));
  const uint4 y = __ldg(reinterpret_cast<const uint4*>(b));
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 xa, ya;
    memcpy(&xa, &xs[i], 4);
    memcpy(&ya, &ys[i], 4);
    const float2 fx = __bfloat1622float2(xa), fy = __bfloat1622float2(ya);
    acc = fmaf(fx.y, fy.y, fmaf(fx.x, fy.x, acc));
  }
  return acc;
}

__device__ __forceinline__ bool live(int qi, int kj, int S, int causal,
                                     int window) {
  return qi < S && kj < S && (!causal || kj <= qi) &&
         (window <= 0 || kj > qi - window);
}

struct Strides {  // elements; q, out, dout and dq share one layout, k, v,
  int64_t qb, qs, qh, kb, ks, kh;  // dk and dv another
};

// ------------------------------------------------------------ pass a: delta

constexpr int kDeltaLanes = 8;                           // lanes a row
constexpr int kDeltaRows = kThreads / kDeltaLanes;       // rows a block

// aux[0] (B, Hq, Sp): lse * log2(e); aux[1]: delta = rowsum(dout * out);
// both 0 past S. Eight lanes a row, 16 bytes a lane and load.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ aux,
                      int S, int Sp, int D, Strides st, int64_t plane) {
  constexpr int kVec = 16 / sizeof(T);
  const int h = blockIdx.y, b = blockIdx.z, Hq = gridDim.y;
  const int row = blockIdx.x * kDeltaRows + threadIdx.x / kDeltaLanes;
  const int sub = threadIdx.x % kDeltaLanes;
  float acc = 0.0f;
  if (row < S) {
    const int64_t off = b * st.qb + h * st.qh + (int64_t)row * st.qs;
    for (int c = sub * kVec; c < D; c += kDeltaLanes * kVec)
      acc += dot16(out + off + c, dout + off + c);
  }
#pragma unroll
  for (int o = kDeltaLanes / 2; o > 0; o >>= 1)
    acc += __shfl_xor_sync(kFull, acc, o);
  if (sub == 0 && row < Sp) {
    const int64_t bh = (int64_t)b * Hq + h;
    aux[bh * Sp + row] = row < S ? lse[bh * S + row] * kLog2e : 0.0f;
    aux[plane + bh * Sp + row] = acc;
  }
}

// ------------------------------------- passes b and c on the CUDA cores

// Stage rows [row0, row0 + kT) of one head into shared memory as float32,
// row stride ``ld`` floats; rows at or past S become zeros.
template <typename T, int kT>
__device__ __forceinline__ void load_tile(const T* __restrict__ base,
                                          int64_t s_stride, int row0, int S,
                                          int D, float* dst, int ld) {
  const int per_row = D / 4;
  for (int e = threadIdx.x; e < kT * per_row; e += kThreads) {
    const int row = e / per_row;
    const int col = (e - row * per_row) * 4;
    float4 f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + row < S) f = load4(base + (int64_t)(row0 + row) * s_stride + col);
    *reinterpret_cast<float4*>(dst + row * ld + col) = f;
  }
}

// out[i][j] = a_s[rg + 16 i] . b_s[cg + 16 j] over D, in float32.
template <int kR, int kK>
__device__ __forceinline__ void dot_tile(const float* a_s, const float* b_s,
                                         int ld, int D, int rg, int cg,
                                         float (&out)[kR][kK]) {
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kK; ++j) out[i][j] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 av[kR], bv[kK];
#pragma unroll
    for (int i = 0; i < kR; ++i)
      av[i] = *reinterpret_cast<const float4*>(a_s + (rg + 16 * i) * ld + d);
#pragma unroll
    for (int j = 0; j < kK; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b_s + (cg + 16 * j) * ld + d);
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kK; ++j) {
        float t = out[i][j];
        t = fmaf(av[i].x, bv[j].x, t);
        t = fmaf(av[i].y, bv[j].y, t);
        t = fmaf(av[i].z, bv[j].z, t);
        t = fmaf(av[i].w, bv[j].w, t);
        out[i][j] = t;
      }
  }
}

__device__ __forceinline__ void fma4(float (&acc)[4], float a, float4 b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

// Stage lse and delta of rows [q0, q0 + kT) (0 past S).
template <int kT>
__device__ __forceinline__ void load_rows(const float* lse_bh,
                                          const float* delta_bh, int q0,
                                          int S, float* lse_s, float* dl_s) {
  for (int r = threadIdx.x; r < kT; r += kThreads) {
    const bool in = q0 + r < S;
    lse_s[r] = in ? lse_bh[q0 + r] : 0.0f;
    dl_s[r] = in ? delta_bh[q0 + r] : 0.0f;
  }
}

// p and ds of the tile (query rows q0 + rg + 16 i, keys k0 + cg + 16 j)
// from s = Q K^T and dp = dO V^T, written to shared memory (row-major by
// query row, row stride ldp); p_s may be null.
template <int kR>
__device__ __forceinline__ void p_and_ds(float (&s)[kR][kR],
                                         float (&dp)[kR][kR],
                                         const float* lse_s,
                                         const float* dl_s, int q0, int k0,
                                         int S, int rg, int cg, float scale,
                                         int causal, int window, float* p_s,
                                         float* ds_s, int ldp) {
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = rg + 16 * i;
    const float lse_i = lse_s[r], dl_i = dl_s[r];
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int c = cg + 16 * j;
      const float p = live(q0 + r, k0 + c, S, causal, window)
                          ? expf(s[i][j] * scale - lse_i)
                          : 0.0f;
      if (p_s) p_s[r * ldp + c] = p;
      ds_s[r * ldp + c] = p * (dp[i][j] - dl_i);
    }
  }
}

// lse: the forward's (B, Hq, S); delta: pass a's rows, (B, Hq, Sp).
template <typename T, int kT, int kChunks>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int Sp, int Hq, int group,
                     int D, Strides st, float scale, int causal,
                     int window) {
  constexpr int kR = kT / 16, ldp = kT + 16;
  extern __shared__ float4 smem4[];
  const int ld = D + 4;
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + kT * ld;
  float* q_s = v_s + kT * ld;
  float* do_s = q_s + kT * ld;
  float* p_s = do_s + kT * ld;
  float* ds_s = p_s + kT * ldp;
  float* lse_s = ds_s + kT * ldp;
  float* dl_s = lse_s + kT;

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * kT;
  const int rg = threadIdx.x / kLanes, cg = threadIdx.x % kLanes;
  const int d4 = D / 4;
  load_tile<T, kT>(k + b * st.kb + hk * st.kh, st.ks, k0, S, D, k_s, ld);
  load_tile<T, kT>(v + b * st.kb + hk * st.kh, st.ks, k0, S, D, v_s, ld);

  float adk[kR][kChunks][4], adv[kR][kChunks][4];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) adk[i][c][e] = adv[i][c][e] = 0.0f;

  // the query tiles that see this key tile: from the diagonal (causal),
  // up to the window's reach
  const int nq = (S + kT - 1) / kT;
  const int qt0 = causal ? kt : 0;
  int qt1 = nq;
  if (window > 0) qt1 = min(nq, (k0 + kT - 1 + window + kT - 1) / kT);
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* qb = q + b * st.qb + h * st.qh;
    const T* gb = dout + b * st.qb + h * st.qh;
    const float* lse_bh = lse + ((int64_t)b * Hq + h) * S;
    const float* delta_bh = delta + ((int64_t)b * Hq + h) * Sp;
    for (int qt = qt0; qt < qt1; ++qt) {
      const int q0 = qt * kT;
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, kT>(qb, st.qs, q0, S, D, q_s, ld);
      load_tile<T, kT>(gb, st.qs, q0, S, D, do_s, ld);
      load_rows<kT>(lse_bh, delta_bh, q0, S, lse_s, dl_s);
      __syncthreads();
      float s[kR][kR], dp[kR][kR];
      dot_tile<kR, kR>(q_s, k_s, ld, D, rg, cg, s);
      dot_tile<kR, kR>(do_s, v_s, ld, D, rg, cg, dp);
      p_and_ds<kR>(s, dp, lse_s, dl_s, q0, k0, S, rg, cg, scale, causal,
                   window, p_s, ds_s, ldp);
      __syncthreads();
      // dv[key] += p[r][key] dout[r], dk[key] += ds[r][key] q[r]
#pragma unroll 2
      for (int r = 0; r < kT; ++r) {
        float pv[kR], sv[kR];
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          pv[i] = p_s[r * ldp + rg + 16 * i];
          sv[i] = ds_s[r * ldp + rg + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const int col = cg + kLanes * c;
          if (col >= d4) continue;
          const float4 gv = *reinterpret_cast<const float4*>(
              do_s + r * ld + 4 * col);
          const float4 qv = *reinterpret_cast<const float4*>(
              q_s + r * ld + 4 * col);
#pragma unroll
          for (int i = 0; i < kR; ++i) {
            fma4(adv[i][c], pv[i], gv);
            fma4(adk[i][c], sv[i], qv);
          }
        }
      }
    }
  }

  T* dkb = dk + b * st.kb + hk * st.kh;
  T* dvb = dv + b * st.kb + hk * st.kh;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int kj = k0 + rg + 16 * i;
    if (kj >= S) continue;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = cg + kLanes * c;
      if (col >= d4) continue;
      const int64_t off = (int64_t)kj * st.ks + 4 * col;
      store4(dkb + off, make_float4(adk[i][c][0] * scale,
                                    adk[i][c][1] * scale,
                                    adk[i][c][2] * scale,
                                    adk[i][c][3] * scale));
      store4(dvb + off, make_float4(adv[i][c][0], adv[i][c][1],
                                    adv[i][c][2], adv[i][c][3]));
    }
  }
}

template <typename T, int kT, int kChunks>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq,
                   int S, int Sp, int Hq, int group, int D, Strides st,
                   float scale, int causal, int window) {
  constexpr int kR = kT / 16, ldp = kT + 16;
  extern __shared__ float4 smem4[];
  const int ld = D + 4;
  float* q_s = reinterpret_cast<float*>(smem4);
  float* do_s = q_s + kT * ld;
  float* k_s = do_s + kT * ld;
  float* v_s = k_s + kT * ld;
  float* ds_s = v_s + kT * ld;
  float* lse_s = ds_s + kT * ldp;
  float* dl_s = lse_s + kT;

  const int nq = gridDim.x;
  // causal: the longest query tiles first, to shorten the grid's tail
  const int qt = causal ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int q0 = qt * kT;
  const int rg = threadIdx.x / kLanes, cg = threadIdx.x % kLanes;
  const int d4 = D / 4;
  load_tile<T, kT>(q + b * st.qb + h * st.qh, st.qs, q0, S, D, q_s, ld);
  load_tile<T, kT>(dout + b * st.qb + h * st.qh, st.qs, q0, S, D, do_s, ld);
  load_rows<kT>(lse + ((int64_t)b * Hq + h) * S,
                delta + ((int64_t)b * Hq + h) * Sp, q0, S, lse_s, dl_s);
  const T* kb = k + b * st.kb + hk * st.kh;
  const T* vb = v + b * st.kb + hk * st.kh;

  float acc[kR][kChunks][4];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.0f;

  const int nk = (S + kT - 1) / kT;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kT;
    if (causal && k0 > q0 + kT - 1) break;
    if (window > 0 && k0 + kT - 1 <= q0 - window) continue;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, kT>(kb, st.ks, k0, S, D, k_s, ld);
    load_tile<T, kT>(vb, st.ks, k0, S, D, v_s, ld);
    __syncthreads();
    float s[kR][kR], dp[kR][kR];
    dot_tile<kR, kR>(q_s, k_s, ld, D, rg, cg, s);
    dot_tile<kR, kR>(do_s, v_s, ld, D, rg, cg, dp);
    p_and_ds<kR>(s, dp, lse_s, dl_s, q0, k0, S, rg, cg, scale, causal,
                 window, nullptr, ds_s, ldp);
    __syncthreads();
    // dq[row] += ds[row][j] k[j] over the tile's keys
#pragma unroll 2
    for (int j = 0; j < kT; j += 4) {
      float4 sv[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i)
        sv[i] = *reinterpret_cast<const float4*>(
            ds_s + (rg + 16 * i) * ldp + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* krow = k_s + (j + jj) * ld;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const int col = cg + kLanes * c;
          if (col >= d4) continue;
          const float4 kv = *reinterpret_cast<const float4*>(krow + 4 * col);
#pragma unroll
          for (int i = 0; i < kR; ++i) {
            const float a = jj == 0   ? sv[i].x
                            : jj == 1 ? sv[i].y
                            : jj == 2 ? sv[i].z
                                      : sv[i].w;
            fma4(acc[i][c], a, kv);
          }
        }
      }
    }
  }

  T* dqb = dq + b * st.qb + h * st.qh;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int qi = q0 + rg + 16 * i;
    if (qi >= S) continue;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = cg + kLanes * c;
      if (col >= d4) continue;
      store4(dqb + (int64_t)qi * st.qs + 4 * col,
             make_float4(acc[i][c][0] * scale, acc[i][c][1] * scale,
                         acc[i][c][2] * scale, acc[i][c][3] * scale));
    }
  }
}

// ------------------------------ passes b and c on the tensor cores (bf16)

// Two warpgroups and no producer: thread 0 issues the TMA copies. ptxas
// sizes a thread's registers by whole warpgroups (a third, producer one
// would cap every thread at 168, and setmaxnreg did not lift the cap for
// these kernels), so 256 threads keep up to 255 each, which dK's and dV's
// accumulators need beside the score tiles.
constexpr int kTcThreads = 256;
constexpr int kKeyBlock = 128;  // pass b: keys per CTA, 64 per consumer
constexpr int kRowBlock = 128;  // pass c: query rows per CTA, 64 per consumer
constexpr int kKeyTile = 64;    // pass c: keys per ring slot
constexpr int kQTile = 64;      // pass b: query rows per ring slot
static_assert(kRowBlock == kPadRows, "pass c's rows lie inside Sp");

// Columns of a shared column block: D padded to a multiple of 64 is held
// in blocks of 64 columns (128-byte rows, 128-byte swizzle), Dp = 96 in
// blocks of 32 (64-byte rows and swizzle). A block's row is 2 x that many
// bytes, and a k16 step moves 32 bytes along it.
__host__ __device__ constexpr int blk_cols(int dp) {
  return dp % 64 == 0 ? 64 : 32;
}

template <int kDp>  // D padded up to 64, 96 or 128
struct DkdvShape {
  static constexpr int kKvBytes = kKeyBlock * kDp * 2;  // K or V
  static constexpr int kTileBytes = kQTile * kDp * 2;   // a Q or dout tile
  static constexpr int kRowBytes = kQTile * 4;  // a tile's lse2 or delta
  static constexpr int kRowsOff = 2 * kKvBytes + 4 * kTileBytes;
  // K, V, two slots of Q, dout, lse2 and delta, 5 mbarriers, and slack to
  // align the base to 1024 bytes
  static constexpr int kSmem = kRowsOff + 4 * kRowBytes + 64 + 1024;
};

template <int kDp>
struct DqShape {
  static constexpr int kQBytes = kRowBlock * kDp * 2;    // Q or dout
  static constexpr int kTileBytes = kKeyTile * kDp * 2;  // a K or V tile
  // Q, dout, two slots each of K and V, 5 mbarriers, slack
  static constexpr int kSmem = 2 * kQBytes + 4 * kTileBytes + 64 + 1024;
};

// The 1024-byte aligned base of the dynamic shared memory.
__device__ __forceinline__ uint8_t* aligned_base(uint8_t* raw) {
  return raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
}

// Hide a shared-memory address from the optimizer for one loop iteration,
// so the wgmma descriptors derived from it are rebuilt there (a few integer
// adds) instead of hoisted out of the loop into registers the consumers
// need for their accumulators.
__device__ __forceinline__ uint32_t opaque(uint32_t a) {
  asm volatile("" : "+r"(a));
  return a;
}

// This warp is done reading a slot.
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// d (64 x kN) = A B over Dp for a 64-row A block at a_s (in a tile of
// a_rows rows) and a kN-row B tile at b_s, both K-major in swizzled column
// blocks (committed, not waited for).
template <int kDp, int kN>
__device__ __forceinline__ void issue_scores(float (&d)[kN / 2],
                                             uint32_t a_s, int a_rows,
                                             uint32_t b_s) {
  constexpr int kRow = 2 * blk_cols(kDp), kSteps = blk_cols(kDp) / 16;
#pragma unroll
  for (int kk = 0; kk < kDp / 16; ++kk) {
    const uint32_t blk = kk / kSteps;
    const uint32_t col = (kk % kSteps) * 32;  // k16 step inside the block
    wgmma_ss(d,
             make_desc(a_s + blk * a_rows * kRow + col, 16, 8 * kRow, kRow),
             make_desc(b_s + blk * kN * kRow + col, 16, 8 * kRow, kRow),
             kk > 0);
  }
  wgmma_commit();
}

// acc += A (a 64 x kK bf16 fragment in registers) . B, B a kK-row tile at
// b_s in the MN-major layout (committed, not waited for).
template <int kDp, int kK>
__device__ __forceinline__ void issue_acc(float (&acc)[kDp / 2],
                                          const uint32_t (&a)[kK / 4],
                                          uint32_t b_s) {
  constexpr int kRow = 2 * blk_cols(kDp);
#pragma unroll
  for (int kk = 0; kk < kK / 16; ++kk)
    wgmma_rs_tb(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
                make_desc(b_s + kk * 16 * kRow, kK * kRow, 8 * kRow, kRow));
  wgmma_commit();
}

// Store a 64-row accumulator fragment's rows a and b (when < S) of the
// first D columns, times ``mul``, as bf16 at base + row * rs.
template <int kDp>
__device__ __forceinline__ void store_rows(const float (&acc)[kDp / 2],
                                           __nv_bfloat16* base, int64_t rs,
                                           int row_a, int c2, int S, int D,
                                           float mul) {
  const int row_b = row_a + 8;
#pragma unroll
  for (int e = 0; e < kDp / 8; ++e) {
    const int col = 8 * e + c2;
    if (col >= D) continue;
    if (row_a < S)
      *reinterpret_cast<uint32_t*>(base + (int64_t)row_a * rs + col) =
          pack_bf16(acc[4 * e] * mul, acc[4 * e + 1] * mul);
    if (row_b < S)
      *reinterpret_cast<uint32_t*>(base + (int64_t)row_b * rs + col) =
          pack_bf16(acc[4 * e + 2] * mul, acc[4 * e + 3] * mul);
  }
}

// Pass b. aux: pass a's lse * log2(e) and delta planes, (B, Hq, Sp) each.
// The accumulator fragment of a 64-row wgmma: element e of n8 block i of
// thread (warp w, lane l) is row 16 w + l/4 + 8 (e/2), column
// 8 i + 2 (l%4) + e%2; here rows are keys and columns query rows.
template <int kDp>
__global__ void __launch_bounds__(kTcThreads, 1)
attn_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const float* __restrict__ aux,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int S, int Sp,
                        int Hq, int group, int D, int64_t ksb, int64_t kss,
                        int64_t ksh, float scale_log2, float scale,
                        int causal, int window) {
  using Shape = DkdvShape<kDp>;
  constexpr int kBlk = blk_cols(kDp), kRow = 2 * kBlk;
  constexpr int kCB = kDp / kBlk;  // column blocks
  constexpr int kNB = kQTile / 8;  // n8 blocks of a score tile
  constexpr uint32_t kTile = Shape::kTileBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = aligned_base(smem_raw);
  const uint32_t k_s = smem_u32(base);
  const uint32_t v_s = k_s + Shape::kKvBytes;
  const uint32_t q_s = v_s + Shape::kKvBytes;  // Q tiles, two slots
  const uint32_t do_s = q_s + 2 * kTile;       // dout tiles, two slots
  const uint32_t rows_s = k_s + Shape::kRowsOff;  // lse2, delta; two slots
  const float* rows = reinterpret_cast<const float*>(base + Shape::kRowsOff);
  const uint32_t bars = rows_s + 4 * Shape::kRowBytes;  // 5 mbarriers
  const uint32_t kv_full = bars;
  auto full = [&](int st) { return bars + 8 + 8 * st; };
  auto empty = [&](int st) { return bars + 24 + 8 * st; };

  const int hk = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * kKeyBlock;  // causal: tile 0, longest, first
  const int tid = threadIdx.x;
  // the query tiles that see the key tile: from the diagonal (causal), up
  // to the window's reach; for each of the G heads in turn
  const int nq = (S + kQTile - 1) / kQTile;
  const int qt_begin = causal ? k0 / kQTile : 0;
  const int qt_end =
      window > 0 ? min(nq, (k0 + kKeyBlock - 2 + window) / kQTile + 1)
                 : nq;
  const int nqt = qt_end - qt_begin;  // >= 1: key k0 sees query k0
  const int n = group * nqt;

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < 2; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kTcThreads / 32);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Item i (head hk G + i / nqt, query tile qt_begin + i % nqt) goes to
  // slot i % 2; thread 0 loads items 0 and 1 here and item i + 1 in
  // iteration i, once every warp has released item i - 1.
  const int64_t plane = (int64_t)gridDim.z * Hq * Sp;
  auto load_item = [&](int i) {
    const int st = i & 1;
    const int h = hk * group + i / nqt;
    const int q0 = (qt_begin + i % nqt) * kQTile;
    mbar_expect_tx(full(st), 2 * kTile + 2 * Shape::kRowBytes);
    for (int cb = 0; cb < kCB; ++cb) {
      tma_load(q_s + st * kTile + cb * kQTile * kRow, &tq, full(st),
               cb * kBlk, h, q0, b);
      tma_load(do_s + st * kTile + cb * kQTile * kRow, &tdo, full(st),
               cb * kBlk, h, q0, b);
    }
    const float* lse2 = aux + ((int64_t)b * Hq + h) * Sp + q0;
    const uint32_t r_st = rows_s + st * 2 * Shape::kRowBytes;
    bulk_load(r_st, lse2, Shape::kRowBytes, full(st));
    bulk_load(r_st + Shape::kRowBytes, lse2 + plane, Shape::kRowBytes,
              full(st));
  };
  if (tid == 0) {
    mbar_expect_tx(kv_full, 2 * Shape::kKvBytes);
    for (int cb = 0; cb < kCB; ++cb) {
      tma_load(k_s + cb * kKeyBlock * kRow, &tk, kv_full, cb * kBlk, hk, k0,
               b);
      tma_load(v_s + cb * kKeyBlock * kRow, &tv, kv_full, cb * kBlk, hk, k0,
               b);
    }
    for (int i = 0; i < min(n, 2); ++i) load_item(i);
  }

  // ---- warpgroups 0 and 1, 64 keys each
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int kw0 = k0 + wg * 64;  // this warpgroup's first key
  const int key_a = kw0 + warp * 16 + (lane >> 2), key_b = key_a + 8;
  const int c2 = 2 * (lane & 3);
  const uint32_t k_wg = k_s + wg * 64 * kRow, v_wg = v_s + wg * 64 * kRow;

  float dk_acc[kDp / 2], dv_acc[kDp / 2];  // n8 block i: [4 i .. 4 i + 3]
#pragma unroll
  for (int e = 0; e < kDp / 2; ++e) dk_acc[e] = dv_acc[e] = 0.0f;
  float s[kNB * 4], dp[kNB * 4];
  uint32_t p_frag[kNB * 2], ds_frag[kNB * 2];

  mbar_wait(kv_full, 0);
  for (int i = 0; i < n; ++i) {
    const int st = i & 1;
    const int q0 = (qt_begin + i % nqt) * kQTile;
    const uint32_t q_st = opaque(q_s + st * kTile);
    const uint32_t do_st = opaque(do_s + st * kTile);
    const float* lse2_s = rows + st * 2 * kQTile;
    const float* dl_s = lse2_s + kQTile;
    // the tile holds a masked pair: rows past S, the diagonal, the window
    const bool masked = q0 + kQTile > S || kw0 + 64 > S ||
                        (causal && kw0 + 63 > q0) ||
                        (window > 0 && kw0 <= q0 + kQTile - 1 - window);
    mbar_wait(full(st), (i >> 1) & 1);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    // S^T = K Q^T, dP^T = V dout^T
    issue_scores<kDp, kQTile>(s, opaque(k_wg), kKeyBlock, q_st);
    issue_scores<kDp, kQTile>(dp, opaque(v_wg), kKeyBlock, do_st);
    if (tid == 0 && i >= 1 && i + 1 < n) {
      mbar_wait(empty((i - 1) & 1), ((i - 1) >> 1) & 1);
      load_item(i + 1);
    }
    wgmma_wait<1>();
    fence_regs(s);
    // P^T = exp2(S^T scale log2(e) - lse log2(e)), 0 where masked
#pragma unroll
    for (int j = 0; j < kNB; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float l2 = lse2_s[8 * j + c2 + e];
        s[4 * j + e] = fast_exp2(fmaf(s[4 * j + e], scale_log2, -l2));
        s[4 * j + 2 + e] = fast_exp2(fmaf(s[4 * j + 2 + e], scale_log2, -l2));
      }
    if (masked) {
#pragma unroll
      for (int j = 0; j < kNB; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = q0 + 8 * j + c2 + e;
          if (!live(qi, key_a, S, causal, window)) s[4 * j + e] = 0.0f;
          if (!live(qi, key_b, S, causal, window)) s[4 * j + 2 + e] = 0.0f;
        }
    }
    pack_p<kNB>(s, p_frag);
    fence_regs(dv_acc);
    wgmma_fence();
    issue_acc<kDp, kQTile>(dv_acc, p_frag, do_st);  // dV += P^T dout
    wgmma_wait<1>();  // dP^T is done; dV may still run
    fence_regs(dp);
    // dS^T = P^T (dP^T - delta)
#pragma unroll
    for (int j = 0; j < kNB; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dl = dl_s[8 * j + c2 + e];
        dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - dl);
        dp[4 * j + 2 + e] = s[4 * j + 2 + e] * (dp[4 * j + 2 + e] - dl);
      }
    pack_p<kNB>(dp, ds_frag);
    fence_regs(dk_acc);
    wgmma_fence();
    issue_acc<kDp, kQTile>(dk_acc, ds_frag, q_st);  // dK += dS^T Q
    wgmma_wait<0>();
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    release(empty(st), lane);
  }

  store_rows<kDp>(dk_acc, dk + b * ksb + hk * ksh, kss, key_a, c2, S, D,
                  scale);
  store_rows<kDp>(dv_acc, dv + b * ksb + hk * ksh, kss, key_a, c2, S, D,
                  1.0f);
}

// Pass c; rows are query rows and columns keys.
template <int kDp>
__global__ void __launch_bounds__(kTcThreads, 1)
attn_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ aux,
                      __nv_bfloat16* __restrict__ dq, int S, int Sp,
                      int group, int D, int64_t qsb, int64_t qss,
                      int64_t qsh, float scale_log2, float scale, int causal,
                      int window) {
  using Shape = DqShape<kDp>;
  constexpr int kBlk = blk_cols(kDp), kRow = 2 * kBlk;
  constexpr int kCB = kDp / kBlk;
  constexpr int kNB = kKeyTile / 8;
  constexpr uint32_t kTile = Shape::kTileBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = smem_u32(aligned_base(smem_raw));
  const uint32_t do_s = q_s + Shape::kQBytes;
  const uint32_t k_s = do_s + Shape::kQBytes;  // K tiles, two slots
  const uint32_t v_s = k_s + 2 * kTile;        // V tiles, two slots
  const uint32_t bars = v_s + 2 * kTile;       // 5 mbarriers
  const uint32_t q_full = bars;
  auto full = [&](int st) { return bars + 8 + 8 * st; };
  auto empty = [&](int st) { return bars + 24 + 8 * st; };

  const int nq = gridDim.x, Hq = gridDim.y;
  const int qt = causal ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int q0 = qt * kRowBlock;
  const int tid = threadIdx.x;
  // the live key tiles
  const int nk = (S + kKeyTile - 1) / kKeyTile;
  const int kt_end =
      causal ? min(nk, (q0 + kRowBlock - 1) / kKeyTile + 1) : nk;
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / kKeyTile : 0;
  const int n = kt_end - kt_begin;  // >= 1: row q0 sees itself

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < 2; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kTcThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Key tile kt_begin + i goes to slot i % 2; thread 0 loads tiles 0 and
  // 1 here and tile i + 1 in iteration i, once every warp has released
  // tile i - 1.
  auto load_item = [&](int i) {
    const int st = i & 1;
    const int row = (kt_begin + i) * kKeyTile;
    mbar_expect_tx(full(st), 2 * kTile);
    for (int cb = 0; cb < kCB; ++cb) {
      tma_load(k_s + st * kTile + cb * kKeyTile * kRow, &tk, full(st),
               cb * kBlk, hk, row, b);
      tma_load(v_s + st * kTile + cb * kKeyTile * kRow, &tv, full(st),
               cb * kBlk, hk, row, b);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(q_full, 2 * Shape::kQBytes);
    for (int cb = 0; cb < kCB; ++cb) {
      tma_load(q_s + cb * kRowBlock * kRow, &tq, q_full, cb * kBlk, h, q0,
               b);
      tma_load(do_s + cb * kRowBlock * kRow, &tdo, q_full, cb * kBlk, h, q0,
               b);
    }
    for (int i = 0; i < min(n, 2); ++i) load_item(i);
  }

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int qw0 = q0 + wg * 64;  // this warpgroup's first row
  const int row_a = qw0 + warp * 16 + (lane >> 2), row_b = row_a + 8;
  const int c2 = 2 * (lane & 3);
  // rows < ceil(S / 128) 128 <= Sp: inside the scratch (0 past S)
  const int64_t bh = ((int64_t)b * Hq + h) * Sp;
  const int64_t plane = (int64_t)gridDim.z * Hq * Sp;
  const float l2_a = aux[bh + row_a], l2_b = aux[bh + row_b];
  const float dl_a = aux[plane + bh + row_a], dl_b = aux[plane + bh + row_b];
  const uint32_t q_wg = q_s + wg * 64 * kRow, do_wg = do_s + wg * 64 * kRow;

  float dq_acc[kDp / 2];
#pragma unroll
  for (int e = 0; e < kDp / 2; ++e) dq_acc[e] = 0.0f;
  float s[kNB * 4], dp[kNB * 4];
  uint32_t ds_frag[kNB * 2];

  mbar_wait(q_full, 0);
  for (int i = 0; i < n; ++i) {
    const int st = i & 1;
    const int k0 = (kt_begin + i) * kKeyTile;
    const uint32_t k_st = opaque(k_s + st * kTile);
    const uint32_t v_st = opaque(v_s + st * kTile);
    const bool masked = k0 + kKeyTile > S || qw0 + 64 > S ||
                        (causal && k0 + kKeyTile - 1 > qw0) ||
                        (window > 0 && k0 <= qw0 + 63 - window);
    mbar_wait(full(st), (i >> 1) & 1);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    issue_scores<kDp, kKeyTile>(s, opaque(q_wg), kRowBlock, k_st);  // Q K^T
    issue_scores<kDp, kKeyTile>(dp, opaque(do_wg), kRowBlock, v_st);
    if (tid == 0 && i >= 1 && i + 1 < n) {
      mbar_wait(empty((i - 1) & 1), ((i - 1) >> 1) & 1);
      load_item(i + 1);
    }
    wgmma_wait<1>();  // S = Q K^T is done; dP = dout V^T may still run
    fence_regs(s);
#pragma unroll
    for (int j = 0; j < kNB; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * j + e] = fast_exp2(fmaf(s[4 * j + e], scale_log2, -l2_a));
        s[4 * j + 2 + e] =
            fast_exp2(fmaf(s[4 * j + 2 + e], scale_log2, -l2_b));
      }
    if (masked) {
#pragma unroll
      for (int j = 0; j < kNB; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kj = k0 + 8 * j + c2 + e;
          if (!live(row_a, kj, S, causal, window)) s[4 * j + e] = 0.0f;
          if (!live(row_b, kj, S, causal, window)) s[4 * j + 2 + e] = 0.0f;
        }
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < kNB; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - dl_a);
        dp[4 * j + 2 + e] = s[4 * j + 2 + e] * (dp[4 * j + 2 + e] - dl_b);
      }
    pack_p<kNB>(dp, ds_frag);
    fence_regs(dq_acc);
    wgmma_fence();
    issue_acc<kDp, kKeyTile>(dq_acc, ds_frag, k_st);  // dQ += dS K
    wgmma_wait<0>();
    fence_regs(dq_acc);
    release(empty(st), lane);
  }

  store_rows<kDp>(dq_acc, dq + b * qsb + h * qsh, qss, row_a, c2, S, D,
                  scale);
}

// ------------------------------------------------------------------ launch

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
cudaError_t launch_delta(const T* out, const T* dout, const float* lse,
                         float* aux, int B, int S, int Hq, int D,
                         const Strides& st, cudaStream_t stream) {
  const int Sp = padded_rows(S);
  attn_bwd_delta_kernel<T><<<dim3(Sp / kDeltaRows, Hq, B), kThreads, 0,
                             stream>>>(out, dout, lse, aux, S, Sp, D, st,
                                       (int64_t)B * Hq * Sp);
  return cudaGetLastError();
}

template <typename T, int kChunks>
cudaError_t launch_bwd(const T* q, const T* k, const T* v, const T* out,
                       const T* dout, const float* lse, T* dq, T* dk, T* dv,
                       float* aux, int B, int S, int Hq, int Hkv, int D,
                       const Strides& st, float scale, int causal,
                       int window, cudaStream_t stream) {
  constexpr int kT = kChunks <= 2 ? 64 : 32;
  constexpr int ldp = kT + 16;
  const int ld = D + 4, group = Hq / Hkv, Sp = padded_rows(S);
  const float* delta = aux + (int64_t)B * Hq * Sp;
  cudaError_t err;
  if ((err = launch_delta<T>(out, dout, lse, aux, B, S, Hq, D, st,
                             stream)) != cudaSuccess)
    return err;

  const size_t dkdv_smem =
      sizeof(float) * (4 * kT * ld + 2 * kT * ldp + 2 * kT);
  auto dkdv = attn_bwd_dkdv_kernel<T, kT, kChunks>;
  if ((err = set_smem(dkdv, dkdv_smem)) != cudaSuccess) return err;
  dkdv<<<dim3((S + kT - 1) / kT, Hkv, B), kThreads, dkdv_smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, S, Sp, Hq, group, D, st, scale,
      causal, window);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t dq_smem = sizeof(float) * (4 * kT * ld + kT * ldp + 2 * kT);
  auto dqk = attn_bwd_dq_kernel<T, kT, kChunks>;
  if ((err = set_smem(dqk, dq_smem)) != cudaSuccess) return err;
  dqk<<<dim3((S + kT - 1) / kT, Hq, B), kThreads, dq_smem, stream>>>(
      q, k, v, dout, lse, delta, dq, S, Sp, Hq, group, D, st, scale, causal,
      window);
  return cudaGetLastError();
}

template <int kDp>
cudaError_t launch_bwd_tc(const void* q, const void* k, const void* v,
                          const void* out, const void* dout,
                          const float* lse, void* dq, void* dk, void* dv,
                          float* aux, int B, int S, int Hq, int Hkv, int D,
                          const int64_t* qst, const int64_t* kst,
                          const Strides& st, float scale, int causal,
                          int window, cudaStream_t stream) {
  using T = __nv_bfloat16;
  const int Sp = padded_rows(S);
  cudaError_t err;
  if ((err = launch_delta<T>(static_cast<const T*>(out),
                             static_cast<const T*>(dout), lse, aux, B, S,
                             Hq, D, st, stream)) != cudaSuccess)
    return err;
  // out, dout and dq share q's strides; dk and dv k's
  CUtensorMap tq, tdo, tk, tv;
  constexpr int kBlk = blk_cols(kDp);
  using Dkdv = DkdvShape<kDp>;
  if (!make_map(&tq, q, B, S, Hq, D, qst, kQTile, kBlk) ||
      !make_map(&tdo, dout, B, S, Hq, D, qst, kQTile, kBlk) ||
      !make_map(&tk, k, B, S, Hkv, D, kst, kKeyBlock, kBlk) ||
      !make_map(&tv, v, B, S, Hkv, D, kst, kKeyBlock, kBlk))
    return cudaErrorInvalidValue;
  const float scale_log2 = scale * kLog2e;
  auto dkdv = attn_bwd_dkdv_tc_kernel<kDp>;
  if ((err = set_smem(dkdv, Dkdv::kSmem)) != cudaSuccess) return err;
  dkdv<<<dim3((S + kKeyBlock - 1) / kKeyBlock, Hkv, B), kTcThreads,
         Dkdv::kSmem, stream>>>(
      tq, tk, tv, tdo, aux, static_cast<T*>(dk), static_cast<T*>(dv), S, Sp,
      Hq, Hq / Hkv, D, kst[0], kst[1], kst[2], scale_log2, scale, causal,
      window);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if (!make_map(&tq, q, B, S, Hq, D, qst, kRowBlock, kBlk) ||
      !make_map(&tdo, dout, B, S, Hq, D, qst, kRowBlock, kBlk) ||
      !make_map(&tk, k, B, S, Hkv, D, kst, kKeyTile, kBlk) ||
      !make_map(&tv, v, B, S, Hkv, D, kst, kKeyTile, kBlk))
    return cudaErrorInvalidValue;
  auto dqk = attn_bwd_dq_tc_kernel<kDp>;
  if ((err = set_smem(dqk, DqShape<kDp>::kSmem)) != cudaSuccess) return err;
  dqk<<<dim3((S + kRowBlock - 1) / kRowBlock, Hq, B), kTcThreads,
        DqShape<kDp>::kSmem, stream>>>(
      tq, tk, tv, tdo, aux, static_cast<T*>(dq), S, Sp, Hq / Hkv, D, qst[0],
      qst[1], qst[2], scale_log2, scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bwd(const void* q, const void* k, const void* v,
                         const void* out, const void* dout, const float* lse,
                         void* dq, void* dk, void* dv, float* aux, int B,
                         int S, int Hq, int Hkv, int D, const Strides& st,
                         float scale, int causal, int window,
                         cudaStream_t stream) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* o_ = static_cast<const T*>(out);
  const T* g_ = static_cast<const T*>(dout);
  T* dq_ = static_cast<T*>(dq);
  T* dk_ = static_cast<T*>(dk);
  T* dv_ = static_cast<T*>(dv);
#define REPRO_BWD(C)                                                       \
  return launch_bwd<T, C>(q_, k_, v_, o_, g_, lse, dq_, dk_, dv_, aux, B, \
                          S, Hq, Hkv, D, st, scale, causal, window, stream)
  const int chunks = (D + 63) / 64;
  if (chunks == 4) REPRO_BWD(4);
  if (chunks == 3) REPRO_BWD(3);
  // bf16 at D <= 128 runs the tensor-core passes: no instances here
  if constexpr (sizeof(T) == 4) {
    if (chunks == 2) REPRO_BWD(2);
    if (chunks == 1) REPRO_BWD(1);
  }
  return cudaErrorInvalidValue;
#undef REPRO_BWD
}

}  // namespace

// Floats of the scratch ``aux`` that flash_attention_bwd_launch takes: two
// (B, Hq, Sp) planes, Sp = S rounded up to 128.
extern "C" int64_t flash_attention_bwd_aux_len(int B, int Hq, int S) {
  return 2 * (int64_t)B * Hq * padded_rows(S);
}

// qst: q's (batch, seq, head) strides in elements, shared by out, dout and
// dq; kst: k's, shared by v, dk and dv. lse: the forward's (B, Hq, S)
// float32 logsumexp; aux: flash_attention_bwd_aux_len floats of scratch.
// bf16 with D <= 128 runs the tensor-core passes, anything else the
// CUDA-core ones (the header says why). Launches the three passes on
// ``stream``; returns the first launch error.
extern "C" cudaError_t flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, void* dq, void* dk, void* dv,
    float* aux, int B, int S, int Hq, int Hkv, int D, const int64_t* qst,
    const int64_t* kst, float scale, int causal, int window, int bf16,
    cudaStream_t stream) {
  const Strides st{qst[0], qst[1], qst[2], kst[0], kst[1], kst[2]};
  if (bf16 && D <= 64)
    return launch_bwd_tc<64>(q, k, v, out, dout, lse, dq, dk, dv, aux, B, S,
                             Hq, Hkv, D, qst, kst, st, scale, causal, window,
                             stream);
  if (bf16 && D <= 96)
    return launch_bwd_tc<96>(q, k, v, out, dout, lse, dq, dk, dv, aux, B, S,
                             Hq, Hkv, D, qst, kst, st, scale, causal, window,
                             stream);
  if (bf16 && D <= 128)
    return launch_bwd_tc<128>(q, k, v, out, dout, lse, dq, dk, dv, aux, B,
                              S, Hq, Hkv, D, qst, kst, st, scale, causal,
                              window, stream);
  if (bf16)
    return dispatch_bwd<__nv_bfloat16>(q, k, v, out, dout, lse, dq, dk, dv,
                                       aux, B, S, Hq, Hkv, D, st, scale,
                                       causal, window, stream);
  return dispatch_bwd<float>(q, k, v, out, dout, lse, dq, dk, dv, aux, B, S,
                             Hq, Hkv, D, st, scale, causal, window, stream);
}
