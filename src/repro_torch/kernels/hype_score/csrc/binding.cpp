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
    int32_t* rem, int G, int R, int L, int s, int P, int select_k, int vec4,
    cudaStream_t stream);
extern "C" cudaError_t hype_scores_launch(const int32_t* nbrs,
                                          const int32_t* fringe,
                                          int32_t* out, int B, int L, int s,
                                          int vec4, cudaStream_t stream);
extern "C" cudaError_t kway_gains_launch(const int32_t* parts,
                                         const int32_t* own, float* gains,
                                         int B, int L, int k, int vec4,
                                         cudaStream_t stream);
extern "C" int kway_gains_max_k();

namespace {

constexpr int64_t kMaxFringe = 16;

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
  TORCH_CHECK(s <= kMaxFringe, "fringe width s must be <= ", kMaxFringe);
  TORCH_CHECK(select_k >= 1 && select_k <= R + P,
              "select_k must lie in [1, R + P]");
  TORCH_CHECK((R + P) * static_cast<int64_t>(sizeof(float)) <= 48 * 1024,
              "R + P slots exceed the kernel's shared memory");
  TORCH_CHECK(G < (int64_t{1} << 31) && G * R * L < (int64_t{1} << 40),
              "shape too large");

  const c10::cuda::CUDAGuard guard(device);
  auto f32 = nbrs.options().dtype(torch::kFloat32);
  auto i32 = nbrs.options().dtype(torch::kInt32);
  torch::Tensor scores = torch::empty({G, R}, f32);
  torch::Tensor sel_idx = torch::empty({G, select_k}, i32);
  torch::Tensor sel_val = torch::empty({G, select_k}, f32);
  torch::Tensor rem = torch::empty({G}, i32);
  if (G == 0) return {scores, sel_idx, sel_val, rem};

  const int vec4 =
      (L % 4 == 0) &&
      (reinterpret_cast<std::uintptr_t>(nbrs.data_ptr<int32_t>()) % 16 == 0);
  const cudaError_t err = hype_score_select_launch(
      nbrs.data_ptr<int32_t>(), fringe.data_ptr<int32_t>(),
      bias.data_ptr<float>(), prev.data_ptr<float>(),
      scores.data_ptr<float>(), sel_idx.data_ptr<int32_t>(),
      sel_val.data_ptr<float>(), rem.data_ptr<int32_t>(),
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
  TORCH_CHECK(s * static_cast<int64_t>(sizeof(int32_t)) <= 48 * 1024,
              "fringe width s exceeds the kernel's shared memory");
  TORCH_CHECK(B < (int64_t{1} << 31) && B * L < (int64_t{1} << 40),
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
  TORCH_CHECK(k >= 1 && k <= kway_gains_max_k(), "k must lie in [1, ",
              kway_gains_max_k(), "]: the kernel's shared-memory histogram");
  TORCH_CHECK(B < (int64_t{1} << 31) && B * L < (int64_t{1} << 40),
              "shape too large");

  const c10::cuda::CUDAGuard guard(device);
  torch::Tensor gains =
      torch::empty({B, k}, parts.options().dtype(torch::kFloat32));
  if (B == 0) return gains;
  const int vec4 = (L % 4 == 0) && aligned16(parts);
  C10_CUDA_CHECK(kway_gains_launch(
      parts.data_ptr<int32_t>(), own.data_ptr<int32_t>(),
      gains.data_ptr<float>(), static_cast<int>(B), static_cast<int>(L),
      static_cast<int>(k), vec4, at::cuda::getCurrentCUDAStream().stream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return gains;
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("score_select", &score_select,
        "Fused HYPE score + per-phase select (CUDA, sm_90a)");
  m.def("scores", &scores, "HYPE external-neighbours scores (CUDA, sm_90a)");
  m.def("kway_gains", &kway_gains, "K-way move gains (CUDA, sm_90a)");
}
