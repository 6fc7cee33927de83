// Flash attention forward (causal or sliding-window masks, GQA), hand-written
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ``flash_attention_fwd`` (body
// ``_flash_kernel``) in src/repro/kernels/flash_attention/kernel.py.
//
// q (B, S, Hq, D), k and v (B, S, Hkv, D), float32 or bfloat16, Hq a multiple
// of Hkv; out (B, S, Hq, D) in q's dtype. For each query row i of head h
// (kv-head h / (Hq / Hkv)) and each key tile, as the TPU kernel does:
//   s_j   = (q_i . k_j) * scale, scale = 1/sqrt(D), all in float32
//   s_j   = -1e30 where key j is masked (j >= S; j > i when causal;
//           j <= i - window with a window)
//   m'    = max(m, max_j s_j);  p_j = exp(s_j - m') (0 where masked)
//   l     = l * exp(m - m') + sum_j p_j;  acc = acc * exp(m - m') + p @ v
// and at the end out_i = acc / max(l, 1e-30), rounded once to the output
// dtype. Key tiles that the mask kills for the whole query tile are skipped
// (the TPU kernel's ``live`` test).
//
// What bounds it on the H100: operations. A causal layer does
// 2 * B * Hq * D * S^2 FLOP (the unmasked half of QK^T and PV) on
// (2 Hq + 2 Hkv) * B * S * D elements, hundreds of FLOP per byte, so the
// bound is the FLOPs at the bf16 tensor-core peak (989 TFLOP/s). This first
// kernel does them in float32 on the CUDA cores, as the TPU kernel and the
// reference do (the bf16 inputs widen exactly), so it cannot reach that
// bound; mma.sync or wgmma is later work.
//
// Design. The TPU grid (B, Hq, nq, nk) runs nk in order with the running
// max, denominator and accumulator in VMEM scratch; here one CTA of 256
// threads owns one (b, q-head, 64-row query tile) and loops over the 64-key
// tiles itself, with those three in registers. The query tile and each key
// and value tile are staged in shared memory as float32 (widened once, when
// loaded with 16-byte loads through the tensors' strides: no transpose of
// the (B, S, H, D) layout). Thread t holds rows r = t/16 + 16 i (i < 4) and,
// for the scores, keys c = t%16 + 16 jj (jj < 4): a 4 x 4 register tile fed
// by float4 shared loads (the key rows are padded by 4 floats, so the 8
// threads of a quarter warp hit 8 bank groups). The row max and sum are
// butterflies over the 16 lanes of a row group, which leave every lane with
// the same bits. The probabilities go through shared memory, and for p @ v
// the thread keeps float4 columns t%16 + 16 q of its 4 rows. Rows and keys
// past S (the ragged last tile: S need not be a multiple of 64) are loaded
// as zeros and masked; their outputs are not written. Offsets are 64-bit.
// Shared memory is (64 D + 64 (D + 4) + 64 D + 64 * 64) * 4 bytes: 113 KB at
// D = 128, 209 KB at D = 256, set through the dynamic-shared-memory
// attribute. Causal query tiles start with the last (the longest) to shorten
// the tail of the grid.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;             // query rows per CTA
constexpr int kBlockK = 64;             // keys per tile
constexpr int kColGroups = 16;          // lanes sharing one row group
constexpr int kRows = kBlockQ / (kThreads / kColGroups);  // rows per thread
constexpr int kKeys = kBlockK / kColGroups;               // keys per thread
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kRows == 4 && kKeys == 4, "the 4 x 4 register tile");

// 16 bytes of T widened to float32 into dst (4 or 8 floats).
__device__ __forceinline__ void widen16(const float* src, float* dst) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(src));
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}
__device__ __forceinline__ void widen16(const __nv_bfloat16* src,
                                        float* dst) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // bfloat16 -> float32 is exact: the 16 bits become the high half
    dst[2 * i] = __uint_as_float(w[i] << 16);
    dst[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Four float32 values rounded once to T and stored at dst.
__device__ __forceinline__ void store4(float a, float b, float c, float d,
                                       float* dst) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(float a, float b, float c, float d,
                                       __nv_bfloat16* dst) {
  const uint32_t lo =
      (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
      ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
  const uint32_t hi =
      (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(c)) |
      ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(d)) << 16);
  *reinterpret_cast<uint2*>(dst) = make_uint2(lo, hi);
}

// Stage rows [row0, row0 + 64) of one head into shared memory as float32,
// row stride ``ld`` floats; rows at or past S become zeros.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ base,
                                          int64_t s_stride, int row0, int S,
                                          int D, float* dst, int ld) {
  constexpr int N = 16 / sizeof(T);  // elements per 16-byte load
  const int per_row = D / N;
  for (int v = threadIdx.x; v < kBlockQ * per_row; v += kThreads) {
    const int row = v / per_row;
    const int col = (v - row * per_row) * N;
    float f[N];
    if (row0 + row < S) {
      widen16(base + (int64_t)(row0 + row) * s_stride + col, f);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) f[i] = 0.0f;
    }
    float* out = dst + row * ld + col;
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(out + i) =
          make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
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
template <typename T, int kChunks>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
                       int Hq, int group, int D, int64_t qsb, int64_t qss,
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

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * ksb + hk * ksh;
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

  T* ob = out + b * osb + h * osh;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + rg + 16 * i;
    if (qi >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = cg + kColGroups * c;
      if (col >= d4) continue;
      store4(acc[i][c][0] / denom, acc[i][c][1] / denom,
             acc[i][c][2] / denom, acc[i][c][3] / denom,
             ob + (int64_t)qi * oss + 4 * col);
    }
  }
}

template <typename T, int kChunks>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int Hq, int Hkv, int D,
                   const int64_t* qst, const int64_t* kst,
                   const int64_t* ost, float scale, int causal, int window,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(kBlockQ * D +
                                               kBlockK * (D + 4) +
                                               kBlockK * D +
                                               kBlockQ * kBlockK);
  auto kernel = flash_attention_kernel<T, kChunks>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, Hq, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Hq, Hq / Hkv, D,
      qst[0], qst[1], qst[2], kst[0], kst[1], kst[2], ost[0], ost[1],
      ost[2], scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int B, int S, int Hq, int Hkv, int D,
                     const int64_t* qst, const int64_t* kst,
                     const int64_t* ost, float scale, int causal, int window,
                     cudaStream_t stream) {
  switch ((D + 63) / 64) {
    case 1:
      return launch<T, 1>(q, k, v, out, B, S, Hq, Hkv, D, qst, kst, ost,
                          scale, causal, window, stream);
    case 2:
      return launch<T, 2>(q, k, v, out, B, S, Hq, Hkv, D, qst, kst, ost,
                          scale, causal, window, stream);
    case 3:
      return launch<T, 3>(q, k, v, out, B, S, Hq, Hkv, D, qst, kst, ost,
                          scale, causal, window, stream);
    case 4:
      return launch<T, 4>(q, k, v, out, B, S, Hq, Hkv, D, qst, kst, ost,
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
    return dispatch<__nv_bfloat16>(q, k, v, out, B, S, Hq, Hkv, D, qst, kst,
                                   ost, scale, causal, window, stream);
  return dispatch<float>(q, k, v, out, B, S, Hq, Hkv, D, qst, kst, ost,
                         scale, causal, window, stream);
}
