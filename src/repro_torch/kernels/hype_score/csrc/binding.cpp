// PyTorch binding of the port's CUDA kernels: the only source that
// includes torch/extension.h, so the .cu files compile without PyTorch's
// headers. Checks every argument, allocates the outputs with
// torch::empty, launches on PyTorch's current stream and checks the
// launch; it never synchronises.
#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <cuda_runtime.h>
#include <torch/extension.h>

#include <cstdint>
#include <vector>

extern "C" cudaError_t hype_score_select_launch(
    const int32_t* nbrs, const int32_t* fringe, const float* bias,
    const float* prev, float* scores, int32_t* sel_idx, float* sel_val,
    int32_t* rem, float* scratch, int G, int R, int L, int s, int P,
    int select_k, int vec4, cudaStream_t stream);
extern "C" int64_t hype_score_select_scratch_len(int G, int R, int P);
extern "C" cudaError_t hype_scores_launch(const int32_t* nbrs,
                                          const int32_t* fringe,
                                          int32_t* out, int B, int L, int s,
                                          int vec4, cudaStream_t stream);
extern "C" cudaError_t kway_gains_launch(const int32_t* parts,
                                         const int32_t* own, float* gains,
                                         int* scratch, int B, int L, int k,
                                         int vec4, cudaStream_t stream);
extern "C" int64_t kway_gains_scratch_len(int B, int k);
extern "C" cudaError_t embedding_bag_launch(const void* table,
                                            const int32_t* ids, void* out,
                                            int64_t B, int bag, int D,
                                            int bf16, int vec, int mean,
                                            cudaStream_t stream);
extern "C" cudaError_t flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int S,
    int Hq, int Hkv, int D, const int64_t* qst, const int64_t* kst,
    const int64_t* ost, float scale, int causal, int window, int bf16,
    cudaStream_t stream);
extern "C" size_t neighbor_agg_smem_bytes(int D);
extern "C" cudaError_t neighbor_agg_launch(const void* x, const int32_t* nbrs,
                                           const void* w, void* out,
                                           float* mean_out, int64_t B, int K,
                                           int D, int F, int x_bf16,
                                           int w_bf16, int vec,
                                           cudaStream_t stream);
extern "C" cudaError_t neighbor_agg_bwd_launch(
    const float* g, const int32_t* cnt, const int64_t* rowptr,
    const int32_t* rows, const int64_t* hptr, const int32_t* hunit,
    float* partials, int32_t* tickets, int64_t cap, void* grad_x, int64_t N,
    int D, int out_bf16, int vec, cudaStream_t stream);

namespace {

constexpr int64_t kInt31 = int64_t{1} << 31;

void check_input(const torch::Tensor& t, const char* name,
                 torch::ScalarType dtype, int64_t dim,
                 const torch::Device& device) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.device() == device, name, " must be on ", device);
  TORCH_CHECK(t.scalar_type() == dtype, name, " must be ", dtype, ", got ",
              t.scalar_type());
  TORCH_CHECK(t.dim() == dim, name, " must have ", dim, " dims, got ",
              t.dim());
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
}

std::vector<torch::Tensor> score_select(const torch::Tensor& nbrs,
                                        const torch::Tensor& fringe,
                                        const torch::Tensor& bias,
                                        const torch::Tensor& prev,
                                        int64_t select_k) {
  TORCH_CHECK(nbrs.is_cuda(), "nbrs must be a CUDA tensor");
  const torch::Device device = nbrs.device();
  check_input(nbrs, "nbrs", torch::kInt32, 3, device);
  check_input(fringe, "fringe", torch::kInt32, 2, device);
  check_input(bias, "bias", torch::kFloat32, 2, device);
  check_input(prev, "prev", torch::kFloat32, 2, device);
  const int64_t G = nbrs.size(0), R = nbrs.size(1), L = nbrs.size(2);
  const int64_t s = fringe.size(1), P = prev.size(1);
  TORCH_CHECK(fringe.size(0) == G, "fringe must be (G, s)");
  TORCH_CHECK(bias.size(0) == G && bias.size(1) == R, "bias must be (G, R)");
  TORCH_CHECK(prev.size(0) == G, "prev must be (G, P)");
  TORCH_CHECK(select_k >= 1 && select_k <= R + P,
              "select_k must lie in [1, R + P]");
  TORCH_CHECK(G < kInt31 && R + P < kInt31 && L < kInt31 && s < kInt31 &&
                  G * R * L < (int64_t{1} << 40),
              "shape too large");

  const c10::cuda::CUDAGuard guard(device);
  auto f32 = nbrs.options().dtype(torch::kFloat32);
  auto i32 = nbrs.options().dtype(torch::kInt32);
  torch::Tensor scores = torch::empty({G, R}, f32);
  torch::Tensor sel_idx = torch::empty({G, select_k}, i32);
  torch::Tensor sel_val = torch::empty({G, select_k}, f32);
  torch::Tensor rem = torch::empty({G}, i32);
  if (G == 0) return {scores, sel_idx, sel_val, rem};
  // the R + P slots of each phase, where they overflow shared memory
  const int64_t n_scratch = hype_score_select_scratch_len(
      static_cast<int>(G), static_cast<int>(R), static_cast<int>(P));
  torch::Tensor scratch;
  if (n_scratch) scratch = torch::empty({n_scratch}, f32);

  const int vec4 =
      (L % 4 == 0) &&
      (reinterpret_cast<std::uintptr_t>(nbrs.data_ptr<int32_t>()) % 16 == 0);
  const cudaError_t err = hype_score_select_launch(
      nbrs.data_ptr<int32_t>(), fringe.data_ptr<int32_t>(),
      bias.data_ptr<float>(), prev.data_ptr<float>(),
      scores.data_ptr<float>(), sel_idx.data_ptr<int32_t>(),
      sel_val.data_ptr<float>(), rem.data_ptr<int32_t>(),
      scratch.defined() ? scratch.data_ptr<float>() : nullptr,
      static_cast<int>(G), static_cast<int>(R), static_cast<int>(L),
      static_cast<int>(s), static_cast<int>(P), static_cast<int>(select_k),
      vec4, at::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_CHECK(err);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return {scores, sel_idx, sel_val, rem};
}

bool aligned16(const torch::Tensor& t) {
  return reinterpret_cast<std::uintptr_t>(t.data_ptr()) % 16 == 0;
}

torch::Tensor scores(const torch::Tensor& nbrs, const torch::Tensor& fringe) {
  TORCH_CHECK(nbrs.is_cuda(), "nbrs must be a CUDA tensor");
  const torch::Device device = nbrs.device();
  check_input(nbrs, "nbrs", torch::kInt32, 2, device);
  check_input(fringe, "fringe", torch::kInt32, 1, device);
  const int64_t B = nbrs.size(0), L = nbrs.size(1), s = fringe.size(0);
  TORCH_CHECK(B < kInt31 && L < kInt31 && s < kInt31 &&
                  B * L < (int64_t{1} << 40),
              "shape too large");

  const c10::cuda::CUDAGuard guard(device);
  torch::Tensor out = torch::empty({B}, nbrs.options());
  if (B == 0) return out;
  const int vec4 = (L % 4 == 0) && aligned16(nbrs);
  C10_CUDA_CHECK(hype_scores_launch(
      nbrs.data_ptr<int32_t>(), fringe.data_ptr<int32_t>(),
      out.data_ptr<int32_t>(), static_cast<int>(B), static_cast<int>(L),
      static_cast<int>(s), vec4, at::cuda::getCurrentCUDAStream().stream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

torch::Tensor kway_gains(const torch::Tensor& parts, const torch::Tensor& own,
                         int64_t k) {
  TORCH_CHECK(parts.is_cuda(), "parts must be a CUDA tensor");
  const torch::Device device = parts.device();
  check_input(parts, "parts", torch::kInt32, 2, device);
  check_input(own, "own", torch::kInt32, 1, device);
  const int64_t B = parts.size(0), L = parts.size(1);
  TORCH_CHECK(own.size(0) == B, "own must be (B,)");
  TORCH_CHECK(k >= 1, "k must be >= 1, got ", k);
  TORCH_CHECK(B < kInt31 && L < kInt31 && k < kInt31 &&
                  B * L < (int64_t{1} << 40),
              "shape too large");

  const c10::cuda::CUDAGuard guard(device);
  torch::Tensor gains =
      torch::empty({B, k}, parts.options().dtype(torch::kFloat32));
  if (B == 0) return gains;
  // one row of k counters per warp in flight, where the histograms
  // overflow shared memory
  const int64_t n_scratch =
      kway_gains_scratch_len(static_cast<int>(B), static_cast<int>(k));
  torch::Tensor scratch;
  if (n_scratch) scratch = torch::empty({n_scratch}, parts.options());
  const int vec4 = (L % 4 == 0) && aligned16(parts);
  C10_CUDA_CHECK(kway_gains_launch(
      parts.data_ptr<int32_t>(), own.data_ptr<int32_t>(),
      gains.data_ptr<float>(),
      scratch.defined() ? scratch.data_ptr<int32_t>() : nullptr,
      static_cast<int>(B), static_cast<int>(L),
      static_cast<int>(k), vec4, at::cuda::getCurrentCUDAStream().stream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return gains;
}

torch::Tensor embedding_bag(const torch::Tensor& table,
                            const torch::Tensor& ids, bool mean) {
  TORCH_CHECK(table.is_cuda(), "table must be a CUDA tensor");
  const torch::Device device = table.device();
  TORCH_CHECK(table.scalar_type() == torch::kFloat32 ||
                  table.scalar_type() == torch::kBFloat16,
              "table must be float32 or bfloat16, got ",
              table.scalar_type());
  check_input(table, "table", table.scalar_type(), 2, device);
  check_input(ids, "ids", torch::kInt32, 2, device);
  const int64_t D = table.size(1), B = ids.size(0), bag = ids.size(1);
  TORCH_CHECK(D < (int64_t{1} << 31) && bag < (int64_t{1} << 31),
              "shape too large");

  const c10::cuda::CUDAGuard guard(device);
  torch::Tensor out = torch::empty({B, D}, table.options());
  if (B == 0 || D == 0) return out;
  const int vec = (D * table.element_size()) % 16 == 0 && aligned16(table) &&
                  aligned16(out);
  C10_CUDA_CHECK(embedding_bag_launch(
      table.data_ptr(), ids.data_ptr<int32_t>(), out.data_ptr(), B,
      static_cast<int>(bag), static_cast<int>(D),
      table.scalar_type() == torch::kBFloat16, vec, mean,
      at::cuda::getCurrentCUDAStream().stream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

torch::Tensor flash_attention(const torch::Tensor& q, const torch::Tensor& k,
                              const torch::Tensor& v, bool causal,
                              int64_t window, double scale) {
  TORCH_CHECK(q.is_cuda(), "q must be a CUDA tensor");
  const torch::Device device = q.device();
  const auto dtype = q.scalar_type();
  TORCH_CHECK(dtype == torch::kFloat32 || dtype == torch::kBFloat16,
              "q must be float32 or bfloat16, got ", dtype);
  check_input(q, "q", dtype, 4, device);
  check_input(k, "k", dtype, 4, device);
  check_input(v, "v", dtype, 4, device);
  const int64_t B = q.size(0), S = q.size(1), Hq = q.size(2), D = q.size(3);
  const int64_t Hkv = k.size(2);
  TORCH_CHECK(k.sizes() == v.sizes(), "k and v must have one shape");
  TORCH_CHECK(k.size(0) == B && k.size(1) == S && k.size(3) == D,
              "k and v must be (B, S, Hkv, D) beside q's (B, S, Hq, D)");
  TORCH_CHECK(Hkv >= 1 && Hq % Hkv == 0, "Hq must be a multiple of Hkv");
  TORCH_CHECK(D >= 8 && D <= 256 && D % 8 == 0,
              "D must be a multiple of 8 in [8, 256], got ", D);
  TORCH_CHECK(B < 65536 && Hq < 65536 && S < (int64_t{1} << 31),
              "shape too large for the kernel's grid");
  TORCH_CHECK(aligned16(q) && aligned16(k) && aligned16(v),
              "q, k and v must be 16-byte aligned");

  const c10::cuda::CUDAGuard guard(device);
  torch::Tensor out = torch::empty_like(q);
  if (B == 0 || S == 0 || Hq == 0) return out;
  const int64_t qst[3] = {q.stride(0), q.stride(1), q.stride(2)};
  const int64_t kst[3] = {k.stride(0), k.stride(1), k.stride(2)};
  const int64_t ost[3] = {out.stride(0), out.stride(1), out.stride(2)};
  C10_CUDA_CHECK(flash_attention_launch(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
      static_cast<int>(B), static_cast<int>(S), static_cast<int>(Hq),
      static_cast<int>(Hkv), static_cast<int>(D), qst, kst, ost,
      static_cast<float>(scale), causal, static_cast<int>(window),
      dtype == torch::kBFloat16, at::cuda::getCurrentCUDAStream().stream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

bool float_or_bf16(const torch::Tensor& t) {
  return t.scalar_type() == torch::kFloat32 ||
         t.scalar_type() == torch::kBFloat16;
}

// Returns {out (B, F) in x's dtype, mean (B, D) float32}; the mean is an
// empty tensor unless ``want_mean``.
std::vector<torch::Tensor> neighbor_agg(const torch::Tensor& x,
                                        const torch::Tensor& nbrs,
                                        const torch::Tensor& w,
                                        bool want_mean) {
  TORCH_CHECK(x.is_cuda(), "x must be a CUDA tensor");
  const torch::Device device = x.device();
  TORCH_CHECK(float_or_bf16(x) && float_or_bf16(w),
              "x and w must be float32 or bfloat16, got ", x.scalar_type(),
              " and ", w.scalar_type());
  check_input(x, "x", x.scalar_type(), 2, device);
  check_input(nbrs, "nbrs", torch::kInt32, 2, device);
  check_input(w, "w", w.scalar_type(), 2, device);
  const int64_t D = x.size(1), B = nbrs.size(0), K = nbrs.size(1);
  const int64_t F = w.size(1);
  TORCH_CHECK(w.size(0) == D, "w must be (D, F) with D = ", D);
  TORCH_CHECK(D < (int64_t{1} << 31) && K < (int64_t{1} << 31) &&
                  F < (int64_t{1} << 31),
              "shape too large");
  TORCH_CHECK(neighbor_agg_smem_bytes(static_cast<int>(D)) <= 227 * 1024,
              "D = ", D, " exceeds the kernel's shared memory");

  const c10::cuda::CUDAGuard guard(device);
  torch::Tensor out = torch::empty({B, F}, x.options());
  torch::Tensor mean = torch::empty(
      {want_mean ? B : 0, want_mean ? D : 0},
      x.options().dtype(torch::kFloat32));
  if (B == 0) return {out, mean};
  const int vec = (D * x.element_size()) % 16 == 0 && aligned16(x);
  C10_CUDA_CHECK(neighbor_agg_launch(
      x.data_ptr(), nbrs.data_ptr<int32_t>(), w.data_ptr(), out.data_ptr(),
      want_mean ? mean.data_ptr<float>() : nullptr, B, static_cast<int>(K),
      static_cast<int>(D), static_cast<int>(F),
      x.scalar_type() == torch::kBFloat16,
      w.scalar_type() == torch::kBFloat16, vec,
      at::cuda::getCurrentCUDAStream().stream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return {out, mean};
}

// grad_x (N, D) in ``bf16 ? bfloat16 : float32`` from g (B, D) float32,
// the per-row valid counts (B,), and the transposed index: rowptr (N + 1)
// int64, rows (rowptr[N]) int32, and the chunk units of the ids with
// more than 32 slots: hptr (N + 1) int64 and hunit (at least hptr[N])
// int32, whose length sizes the units' scratch.
torch::Tensor neighbor_agg_bwd(const torch::Tensor& g,
                               const torch::Tensor& cnt,
                               const torch::Tensor& rowptr,
                               const torch::Tensor& rows,
                               const torch::Tensor& hptr,
                               const torch::Tensor& hunit, bool bf16) {
  TORCH_CHECK(g.is_cuda(), "g must be a CUDA tensor");
  const torch::Device device = g.device();
  check_input(g, "g", torch::kFloat32, 2, device);
  check_input(cnt, "cnt", torch::kInt32, 1, device);
  check_input(rowptr, "rowptr", torch::kInt64, 1, device);
  check_input(rows, "rows", torch::kInt32, 1, device);
  check_input(hptr, "hptr", torch::kInt64, 1, device);
  check_input(hunit, "hunit", torch::kInt32, 1, device);
  const int64_t B = g.size(0), D = g.size(1), N = rowptr.size(0) - 1;
  TORCH_CHECK(N >= 0, "rowptr must hold N + 1 offsets");
  TORCH_CHECK(hptr.size(0) == N + 1, "hptr must hold N + 1 offsets");
  TORCH_CHECK(cnt.size(0) == B, "cnt must be (B,)");
  TORCH_CHECK(D < (int64_t{1} << 31), "shape too large");

  const c10::cuda::CUDAGuard guard(device);
  torch::Tensor grad_x = torch::empty(
      {N, D}, g.options().dtype(bf16 ? torch::kBFloat16 : torch::kFloat32));
  if (N == 0 || D == 0) return grad_x;
  const int64_t cap = hunit.size(0);
  torch::Tensor partials = torch::empty({cap, D}, g.options());
  torch::Tensor tickets = torch::empty({cap}, hunit.options());
  const int vec = D % 4 == 0 && aligned16(g);
  C10_CUDA_CHECK(neighbor_agg_bwd_launch(
      g.data_ptr<float>(), cnt.data_ptr<int32_t>(),
      rowptr.data_ptr<int64_t>(), rows.data_ptr<int32_t>(),
      hptr.data_ptr<int64_t>(), hunit.data_ptr<int32_t>(),
      partials.data_ptr<float>(), tickets.data_ptr<int32_t>(), cap,
      grad_x.data_ptr(), N, static_cast<int>(D), bf16, vec,
      at::cuda::getCurrentCUDAStream().stream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return grad_x;
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("score_select", &score_select,
        "Fused HYPE score + per-phase select (CUDA, sm_90a)");
  m.def("scores", &scores, "HYPE external-neighbours scores (CUDA, sm_90a)");
  m.def("kway_gains", &kway_gains, "K-way move gains (CUDA, sm_90a)");
  m.def("embedding_bag", &embedding_bag,
        "EmbeddingBag sum/mean over -1-padded bags (CUDA, sm_90a)");
  m.def("flash_attention", &flash_attention,
        "Causal / sliding-window GQA attention forward (CUDA, sm_90a)");
  m.def("neighbor_agg", &neighbor_agg,
        "Mean of the -1-padded neighbour rows times w (CUDA, sm_90a)");
  m.def("neighbor_agg_bwd", &neighbor_agg_bwd,
        "Gradient of x of neighbor_agg, deterministic (CUDA, sm_90a)");
}
