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
// h / (Hq / Hkv)); dq, dk and dv in the input dtype. With P the softmax of
// the masked scores s = (q . k) * scale (scale = 1/sqrt(D)):
//   lse_i   = log sum_j exp(s_ij)            (pass 1, per query row)
//   delta_i = sum_d dout_id out_id           (pass 1)
//   p_ij    = exp(s_ij - lse_i)              (0 where masked)
//   ds_ij   = p_ij (dout_i . v_j - delta_i)
//   dv_j    = sum_i p_ij dout_i,  dk_j = scale sum_i ds_ij q_i  (pass 2)
//   dq_i    = scale sum_j ds_ij k_j                               (pass 3)
// dk and dv of a kv-head sum over its Hq / Hkv query heads. Every sum is
// float32; the inputs are widened to float32 in shared memory and the
// outputs rounded once. Masks as the forward: key j is masked for query i
// when j >= S, j > i (causal) or j <= i - window (a window); rows and keys
// past S are loaded as zeros and masked, their outputs not written.
//
// Three kernels, no atomics, so a repeated backward gives the same bits:
//   pass 1 (attn_bwd_prep_kernel): one block per (b, q-head, 64-row query
//     tile) walks the key tiles the tile sees, with the forward's online
//     max and sum, and writes lse and delta (B, Hq, S) float32;
//   pass 2 (attn_bwd_dkdv_kernel): one block per (b, kv-head, key tile)
//     keeps its K and V tiles in shared memory and walks its G query heads
//     and, for each, the query tiles that see the tile, in that fixed
//     order; dk and dv stay in registers until the end;
//   pass 3 (attn_bwd_dq_kernel): one block per (b, q-head, query tile)
//     walks the key tiles the tile sees; dq stays in registers.
// Passes 2 and 3 recompute s and dout . v from the tiles (no (S, S) tensor
// is ever stored). Tiles are kT = 64 rows and keys for D <= 128 and 32
// above (the four D-wide tiles fit 227 KB of shared memory), 256 threads a
// block: thread (rg, cg) = (tid / 16, tid % 16) holds the score tile's
// rows rg + 16 i and keys cg + 16 j, and in the products that sum over a
// tile the rows (or keys) rg + 16 i and float4 columns cg + 16 c. Shared
// rows are D + 4 floats apart, so the sixteen lanes of a row group read
// sixteen different banks.
//
// What bounds it on the H100: operations. A causal layer's backward needs
// the five products of 2 D FLOP per unmasked (query, key) pair (QK^T,
// dO V^T, P^T dO, dS^T Q, dS K): 2.5 times the forward's two, at the bf16
// tensor-core peak. This first version is the simple, right one: it runs
// eight products (passes 2 and 3 each recompute QK^T and dO V^T, pass 1
// one QK^T) as float32 FMAs on the CUDA cores, one block an SM; a
// tensor-core (wgmma) redesign is later work (ROADMAP.md, queue 2).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kLanes = 16;          // lanes sharing one row group
constexpr int kPrepT = 64;          // pass 1's tile
constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ bool live(int qi, int kj, int S, int causal,
                                     int window) {
  return qi < S && kj < S && (!causal || kj <= qi) &&
         (window <= 0 || kj > qi - window);
}

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

struct Strides {  // elements; q, out, dout and dq share one layout, k, v,
  int64_t qb, qs, qh, kb, ks, kh;  // dk and dv another
};

// ----------------------------------------------------- pass 1: lse, delta

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_prep_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ out, const T* __restrict__ dout,
                     float* __restrict__ lse, float* __restrict__ delta,
                     int S, int Hq, int group, int D, Strides st, float scale,
                     int causal, int window) {
  constexpr int kT = kPrepT, kR = kT / 16;
  extern __shared__ float4 smem4[];
  const int ld = D + 4;
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + kT * ld;

  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int q0 = blockIdx.x * kT;
  const int rg = threadIdx.x / kLanes, cg = threadIdx.x % kLanes;
  const T* qb = q + b * st.qb + h * st.qh;
  const T* kb = k + b * st.kb + hk * st.kh;
  load_tile<T, kT>(qb, st.qs, q0, S, D, q_s, ld);

  float m[kR], l[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
  }
  const int nk = (S + kT - 1) / kT;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kT;
    if (causal && k0 > q0 + kT - 1) break;
    if (window > 0 && k0 + kT - 1 <= q0 - window) continue;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, kT>(kb, st.ks, k0, S, D, k_s, ld);
    __syncthreads();
    float s[kR][kR];
    dot_tile<kR, kR>(q_s, k_s, ld, D, rg, cg, s);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int qi = q0 + rg + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const bool on = live(qi, k0 + cg + 16 * j, S, causal, window);
        s[i][j] = on ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kR; ++j)
        sum += s[i][j] > kNegInf ? expf(s[i][j] - m_new) : 0.0f;
      l[i] = l[i] * expf(m[i] - m_new) + row_sum(sum);
      m[i] = m_new;
    }
  }

  // delta = rowsum(dout * out), read straight from device memory
  const T* ob = out + b * st.qb + h * st.qh;
  const T* gb = dout + b * st.qb + h * st.qh;
  const int d4 = D / 4;
  float* lse_b = lse + ((int64_t)b * Hq + h) * S;
  float* delta_b = delta + ((int64_t)b * Hq + h) * S;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int qi = q0 + rg + 16 * i;
    float acc = 0.0f;
    if (qi < S)
      for (int c = cg; c < d4; c += kLanes) {
        const float4 o = load4(ob + (int64_t)qi * st.qs + 4 * c);
        const float4 g = load4(gb + (int64_t)qi * st.qs + 4 * c);
        acc = fmaf(o.x, g.x, acc);
        acc = fmaf(o.y, g.y, acc);
        acc = fmaf(o.z, g.z, acc);
        acc = fmaf(o.w, g.w, acc);
      }
    acc = row_sum(acc);
    if (qi < S && cg == 0) {
      lse_b[qi] = m[i] + logf(l[i]);
      delta_b[qi] = acc;
    }
  }
}

// ---------------------------------------------------- pass 2: dk and dv

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

template <typename T, int kT, int kChunks>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int Hq, int group, int D,
                     Strides st, float scale, int causal, int window) {
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
    const float* delta_bh = delta + ((int64_t)b * Hq + h) * S;
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

// -------------------------------------------------------------- pass 3: dq

template <typename T, int kT, int kChunks>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq,
                   int S, int Hq, int group, int D, Strides st, float scale,
                   int causal, int window) {
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
                delta + ((int64_t)b * Hq + h) * S, q0, S, lse_s, dl_s);
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

// ------------------------------------------------------------------ launch

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int kChunks>
cudaError_t launch_bwd(const T* q, const T* k, const T* v, const T* out,
                       const T* dout, T* dq, T* dk, T* dv, float* lse,
                       float* delta, int B, int S, int Hq, int Hkv, int D,
                       const Strides& st, float scale, int causal,
                       int window, cudaStream_t stream) {
  constexpr int kT = kChunks <= 2 ? 64 : 32;
  constexpr int ldp = kT + 16;
  const int ld = D + 4, group = Hq / Hkv;
  cudaError_t err;

  const size_t prep_smem = sizeof(float) * 2 * kPrepT * ld;
  auto prep = attn_bwd_prep_kernel<T>;
  if ((err = set_smem(prep, prep_smem)) != cudaSuccess) return err;
  prep<<<dim3((S + kPrepT - 1) / kPrepT, Hq, B), kThreads, prep_smem,
         stream>>>(q, k, out, dout, lse, delta, S, Hq, group, D, st, scale,
                   causal, window);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t dkdv_smem =
      sizeof(float) * (4 * kT * ld + 2 * kT * ldp + 2 * kT);
  auto dkdv = attn_bwd_dkdv_kernel<T, kT, kChunks>;
  if ((err = set_smem(dkdv, dkdv_smem)) != cudaSuccess) return err;
  dkdv<<<dim3((S + kT - 1) / kT, Hkv, B), kThreads, dkdv_smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, S, Hq, group, D, st, scale, causal,
      window);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t dq_smem = sizeof(float) * (4 * kT * ld + kT * ldp + 2 * kT);
  auto dqk = attn_bwd_dq_kernel<T, kT, kChunks>;
  if ((err = set_smem(dqk, dq_smem)) != cudaSuccess) return err;
  dqk<<<dim3((S + kT - 1) / kT, Hq, B), kThreads, dq_smem, stream>>>(
      q, k, v, dout, lse, delta, dq, S, Hq, group, D, st, scale, causal,
      window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bwd(const void* q, const void* k, const void* v,
                         const void* out, const void* dout, void* dq,
                         void* dk, void* dv, float* lse, float* delta, int B,
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
#define REPRO_BWD(C)                                                         \
  return launch_bwd<T, C>(q_, k_, v_, o_, g_, dq_, dk_, dv_, lse, delta, B, \
                          S, Hq, Hkv, D, st, scale, causal, window, stream)
  switch ((D + 63) / 64) {
    case 1:
      REPRO_BWD(1);
    case 2:
      REPRO_BWD(2);
    case 3:
      REPRO_BWD(3);
    case 4:
      REPRO_BWD(4);
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_BWD
}

}  // namespace

// qst: q's (batch, seq, head) strides in elements, shared by out, dout and
// dq; kst: k's, shared by v, dk and dv. lse and delta: (B, Hq, S) float32
// scratch. Launches the three passes on ``stream``; returns the first
// launch error.
extern "C" cudaError_t flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, void* dq, void* dk, void* dv, float* lse, float* delta,
    int B, int S, int Hq, int Hkv, int D, const int64_t* qst,
    const int64_t* kst, float scale, int causal, int window, int bf16,
    cudaStream_t stream) {
  const Strides st{qst[0], qst[1], qst[2], kst[0], kst[1], kst[2]};
  if (bf16)
    return dispatch_bwd<__nv_bfloat16>(q, k, v, out, dout, dq, dk, dv, lse,
                                       delta, B, S, Hq, Hkv, D, st, scale,
                                       causal, window, stream);
  return dispatch_bwd<float>(q, k, v, out, dout, dq, dk, dv, lse, delta, B,
                             S, Hq, Hkv, D, st, scale, causal, window,
                             stream);
}
