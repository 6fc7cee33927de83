// EmbeddingBag (sum or mean of the valid rows of a bag), hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ``embedding_bag_kernel`` (body
// ``_bag_kernel``) in src/repro/kernels/embedding_bag/kernel.py.
//
// Per bag row b of the (B, bag) int32 ids (-1 pad):
//   acc[:]  = 0 (float32); cnt = 0
//   for j in 0..bag-1 (in slot order): if ids[b, j] >= 0:
//       acc[:] += float(table[ids[b, j], :]); cnt += 1
//   out[b, :] = T(mean ? acc / max(cnt, 1) : acc)
// The additions run in slot order, the mean is one IEEE division and the
// cast to bfloat16 rounds to nearest even, so the result equals the plain
// version (ref.py) bit for bit. A pad slot is skipped; the TPU kernel
// still fetched row 0 for it (its index map needs a valid row).
//
// What bounds it on the H100: bytes. Each valid slot reads one table row
// (D * itemsize bytes, 1 KB at D = 256 fp32) from a table far larger than
// the 50 MB L2 (two 17.2 GB tables at the published width), so the cost
// is the gather of B * bag rows; the arithmetic is one add per element.
// The TPU kernel walks a sequential (example, slot) grid with a VMEM
// accumulator carried across slots. Here one warp owns one bag row: the
// lane whose index is j holds slot j's id, each id is read once and
// broadcast with a shuffle, so the skip of a pad slot is uniform across
// the warp, and the lanes stride over D with 16-byte loads (two float4
// per lane at D = 256 fp32, one 8 x bf16 vector at D = 256 bf16) into
// float32 registers. A row whose bytes are not a multiple of 16 (D = 33)
// takes the scalar path. Every row offset is 64-bit: at V = 2**24,
// D = 256 the table holds 2**32 elements, so id * D overflows int32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 2;  // 16-byte vectors in flight per lane and slot
constexpr unsigned kFull = 0xffffffffu;

// Element access: float32 and bfloat16 (widened exactly to float32).
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void narrow(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(x);
}

template <typename T>
struct Vec {
  static constexpr int kN = 16 / sizeof(T);  // elements per 16-byte load
};

// Add the kN elements of one 16-byte vector at ``src`` into ``acc``.
__device__ __forceinline__ void add_vec(const float* src, float* acc) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(src));
  acc[0] += v.x;
  acc[1] += v.y;
  acc[2] += v.z;
  acc[3] += v.w;
}
__device__ __forceinline__ void add_vec(const __nv_bfloat16* src,
                                        float* acc) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // bfloat16 -> float32 is exact: the 16 bits become the high half
    acc[2 * i] += __uint_as_float(w[i] << 16);
    acc[2 * i + 1] += __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T>
__device__ __forceinline__ void store_vec(const float* acc, float denom,
                                          bool mean, T* dst) {
#pragma unroll
  for (int i = 0; i < Vec<T>::kN; ++i)
    narrow(mean ? acc[i] / denom : acc[i], dst + i);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const T* __restrict__ table,
                     const int32_t* __restrict__ ids, T* __restrict__ out,
                     int64_t B, int bag, int D, int vec, int mean) {
  constexpr int N = Vec<T>::kN;
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  const int nvec = vec ? D / N : 0;  // 16-byte vectors per row

  for (int64_t b = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5); b < B;
       b += warps) {
    const int32_t* idr = ids + b * bag;
    T* outr = out + b * (int64_t)D;
    int cnt = 0;
    for (int j0 = 0; j0 < bag; j0 += 32) {
      const int32_t id = j0 + lane < bag ? idr[j0 + lane] : -1;
      cnt += __popc(__ballot_sync(kFull, id >= 0));
    }
    const float denom = (float)(cnt > 1 ? cnt : 1);

    // vector part: each lane owns kUnroll vectors per pass over D
    for (int c0 = 0; c0 < nvec; c0 += 32 * kUnroll) {
      float acc[kUnroll][N];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int i = 0; i < N; ++i) acc[u][i] = 0.0f;
      for (int j0 = 0; j0 < bag; j0 += 32) {
        const int32_t mine = j0 + lane < bag ? idr[j0 + lane] : -1;
        const int nj = bag - j0 < 32 ? bag - j0 : 32;
        for (int jj = 0; jj < nj; ++jj) {
          const int32_t id = __shfl_sync(kFull, mine, jj);
          if (id < 0) continue;  // the same for every lane
          const T* row = table + (int64_t)id * D;
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int c = c0 + u * 32 + lane;
            if (c < nvec) add_vec(row + (int64_t)c * N, acc[u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = c0 + u * 32 + lane;
        if (c < nvec) store_vec(acc[u], denom, mean, outr + (int64_t)c * N);
      }
    }

    // scalar part: the elements past the last whole vector (all of them
    // when the row is not 16-byte aligned)
    for (int d0 = nvec * N; d0 < D; d0 += 32) {
      const int d = d0 + lane;
      float acc = 0.0f;
      for (int j0 = 0; j0 < bag; j0 += 32) {
        const int32_t mine = j0 + lane < bag ? idr[j0 + lane] : -1;
        const int nj = bag - j0 < 32 ? bag - j0 : 32;
        for (int jj = 0; jj < nj; ++jj) {
          const int32_t id = __shfl_sync(kFull, mine, jj);
          if (id >= 0 && d < D) acc += widen(table[(int64_t)id * D + d]);
        }
      }
      if (d < D) narrow(mean ? acc / denom : acc, outr + d);
    }
  }
}

template <typename T>
cudaError_t launch(const void* table, const int32_t* ids, void* out,
                   int64_t B, int bag, int D, int vec, int mean,
                   cudaStream_t stream) {
  int64_t blocks = (B + kWarps - 1) / kWarps;
  if (blocks > (int64_t{1} << 20)) blocks = int64_t{1} << 20;
  embedding_bag_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(table), ids, static_cast<T*>(out), B, bag, D,
      vec, mean);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point; the PyTorch binding (hype_score/csrc/binding.cpp)
// checks the arguments, allocates the output and passes the current
// stream. ``bf16`` picks the element type (0: float32, 1: bfloat16);
// ``vec`` says that every row starts 16-byte aligned (the binding checks
// the pointers and D * itemsize).
extern "C" cudaError_t embedding_bag_launch(const void* table,
                                            const int32_t* ids, void* out,
                                            int64_t B, int bag, int D,
                                            int bf16, int vec, int mean,
                                            cudaStream_t stream) {
  if (bf16)
    return launch<__nv_bfloat16>(table, ids, out, B, bag, D, vec, mean,
                                 stream);
  return launch<float>(table, ids, out, B, bag, D, vec, mean, stream);
}
