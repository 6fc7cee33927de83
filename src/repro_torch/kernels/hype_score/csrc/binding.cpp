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

#include <algorithm>
#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>
#include <utility>
#include <vector>

#include "../../smem_optin.cuh"

extern "C" cudaError_t hype_score_select_launch(
    const int32_t* nbrs, const int32_t* fringe, const float* bias,
    const float* prev, float* scores, int32_t* sel_idx, float* sel_val,
    int32_t* rem, float* scratch, int32_t* tickets, int G, int R, int L,
    int s, int P, int select_k, int vec4, cudaStream_t stream);
extern "C" int64_t hype_score_select_scratch_len(int G, int R, int P);
extern "C" cudaError_t hype_scores_launch(const int32_t* nbrs,
                                          const int32_t* fringe,
                                          int32_t* out, int B, int L, int s,
                                          int vec4, cudaStream_t stream);
extern "C" cudaError_t kway_gains_launch(const int32_t* parts,
                                         const int32_t* own, float* gains,
                                         int* scratch, int B, int L, int k,
                                         int vec4, cudaStream_t stream);
extern "C" cudaError_t kway_gains_csr_launch(
    const void* indptr, int indptr64, const int32_t* indices,
    int32_t* assign, int n, const int32_t* delta_ids,
    const int32_t* delta_vals, int nd, const int32_t* cand, float* gains,
    int* scratch, int B, int tile_l, int k, cudaStream_t stream);
extern "C" int64_t kway_gains_scratch_len(int B, int k);
extern "C" cudaError_t embedding_bag_launch(const void* table,
                                            const int32_t* ids, void* out,
                                            int64_t B, int bag, int D,
                                            int bf16, int vec, int mean,
                                            cudaStream_t stream);
extern "C" cudaError_t flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, float* lse,
    int B, int S, int Hq, int Hkv, int D, const int64_t* qst,
    const int64_t* kst, const int64_t* ost, float scale, int causal,
    int window, int bf16, cudaStream_t stream);
extern "C" int64_t flash_attention_bwd_aux_len(int B, int Hq, int S);
extern "C" cudaError_t flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, void* dq, void* dk, void* dv,
    float* aux, int B, int S, int Hq, int Hkv, int D, const int64_t* qst,
    const int64_t* kst, float scale, int causal, int window, int bf16,
    cudaStream_t stream);
extern "C" cudaError_t stream_commit_launch(
    const int32_t* edge, const float* fcnt, const bool* valid_row,
    int32_t* sketch, int32_t* sizes, int32_t* parts, int mb, int Le, int k,
    int bits, float alpha, float fw, float inv_target, int cap,
    cudaStream_t stream);
extern "C" int stream_commit_branch(int mb, int Le, int k, int64_t pins);
extern "C" size_t neighbor_agg_smem_bytes(int D, int F);
extern "C" cudaError_t neighbor_agg_launch(const void* x, const int32_t* nbrs,
                                           const void* w, void* out,
                                           float* mean_out, int64_t B, int K,
                                           int D, int F, int x_bf16,
                                           int w_bf16, int vec, int id_vec,
                                           int out_vec, cudaStream_t stream);
extern "C" cudaError_t neighbor_agg_bwd_launch(
    const float* g, const int32_t* cnt, const int64_t* rowptr,
    const int32_t* rows, const int64_t* hptr, const int32_t* hunit,
    float* partials, int32_t* tickets, int64_t cap, void* grad_x, int64_t N,
    int D, int out_bf16, int vec, cudaStream_t stream);
extern "C" cudaError_t segment_sum_launch(
    const float* msgs, const int64_t* rowptr, const int32_t* rows,
    const int64_t* hptr, const int32_t* hunit, float* partials,
    int32_t* tickets, int64_t cap, float* out, int64_t N, int D, int align,
    cudaStream_t stream);
extern "C" int segment_sum_vec_width(int D, int align);
extern "C" size_t neighbor_agg_csr_smem_bytes(int D, int F, int w_bf16);
extern "C" cudaError_t neighbor_agg_csr_launch(
    const float* x, const int64_t* indptr, const int32_t* indices,
    const int64_t* hptr, const int32_t* hunit, float* partials,
    int32_t* tickets, int64_t cap, const void* w, float* mean, float* out,
    int64_t B, int D, int F, int w_bf16, int vec, cudaStream_t stream);

namespace {

constexpr int64_t kInt31 = int64_t{1} << 31;
// kway_gains: row lengths below 2**30, kRows * k counters below 2**31
constexpr int64_t kKwayLen = int64_t{1} << 30;
constexpr int64_t kKwayK = int64_t{1} << 28;

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

// At least G zeroed int32 ticket counters on this device and stream, for
// score_select and segment_sum. Each kernel leaves the counters it used
// zero, so they are allocated once (on the stream, so the zeroing precedes
// the first launch) and kept for the process; a larger G takes a larger
// array and keeps the old one, whose address a captured CUDA graph may
// hold. One array per stream, so that launches on concurrent streams never
// share a counter (launches on one stream run in turn); the last lookup
// is remembered per host thread.
int32_t* zeroed_tickets(int64_t G, const torch::Device& device,
                        cudaStream_t stream) {
  thread_local int last_dev = -1;
  thread_local cudaStream_t last_stream = nullptr;
  thread_local int64_t last_len = 0;
  thread_local int32_t* last_ptr = nullptr;
  if (last_ptr && last_dev == device.index() && last_stream == stream &&
      last_len >= G)
    return last_ptr;
  static std::mutex mu;
  static auto* held = new std::map<std::pair<int, cudaStream_t>,
                                   std::vector<torch::Tensor>>();
  const std::lock_guard<std::mutex> lock(mu);
  auto& mine = (*held)[{device.index(), stream}];
  if (mine.empty() || mine.back().numel() < G)
    mine.push_back(torch::zeros({std::max<int64_t>(G, 1024)},
                                torch::dtype(torch::kInt32).device(device)));
  last_dev = device.index();
  last_stream = stream;
  last_len = mine.back().numel();
  last_ptr = mine.back().data_ptr<int32_t>();
  return last_ptr;
}

// A contiguous tensor of ``sizes`` and ``dtype`` at byte ``offset`` of
// ``storage``: score_select's four outputs share one allocation, since an
// allocation costs the host about as much as the kernel's launch.
torch::Tensor carve(const c10::Storage& storage, int64_t offset,
                    at::IntArrayRef sizes, caffe2::TypeMeta dtype) {
  torch::Tensor t = at::detail::make_tensor<c10::TensorImpl>(
      c10::Storage(storage), c10::DispatchKeySet(c10::DispatchKey::CUDA),
      dtype);
  t.unsafeGetTensorImpl()->set_sizes_contiguous(sizes);
  t.unsafeGetTensorImpl()->set_storage_offset(
      offset / static_cast<int64_t>(dtype.itemsize()));
  return t;
}

using Four = std::tuple<torch::Tensor, torch::Tensor, torch::Tensor,
                        torch::Tensor>;

Four score_select(const torch::Tensor& nbrs, const torch::Tensor& fringe,
                  const torch::Tensor& bias, const torch::Tensor& prev,
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
  // scores (G, R) f32 | sel_idx (G, k) i32 | sel_val (G, k) f32 | rem (G,)
  // i32, each at a 16-byte boundary of one allocation
  auto up16 = [](int64_t n) { return (n * 4 + 15) / 16 * 16; };
  const int64_t at_idx = up16(G * R), at_val = at_idx + up16(G * select_k),
                at_rem = at_val + up16(G * select_k);
  const c10::Storage storage =
      torch::empty({at_rem + up16(G)}, nbrs.options().dtype(torch::kUInt8))
          .storage();
  const auto f32 = caffe2::TypeMeta::Make<float>();
  const auto i32 = caffe2::TypeMeta::Make<int32_t>();
  torch::Tensor scores = carve(storage, 0, {G, R}, f32);
  torch::Tensor sel_idx = carve(storage, at_idx, {G, select_k}, i32);
  torch::Tensor sel_val = carve(storage, at_val, {G, select_k}, f32);
  torch::Tensor rem = carve(storage, at_rem, {G}, i32);
  if (G == 0) return {scores, sel_idx, sel_val, rem};
  // the R + P slots of each phase, where they overflow shared memory
  const int64_t n_scratch = hype_score_select_scratch_len(
      static_cast<int>(G), static_cast<int>(R), static_cast<int>(P));
  torch::Tensor scratch;
  if (n_scratch)
    scratch = torch::empty({n_scratch}, nbrs.options().dtype(torch::kFloat32));

  const int vec4 =
      (L % 4 == 0) &&
      (reinterpret_cast<std::uintptr_t>(nbrs.data_ptr<int32_t>()) % 16 == 0);
  const cudaStream_t stream = at::cuda::getCurrentCUDAStream().stream();
  int32_t* tickets = zeroed_tickets(G, device, stream);
  const cudaError_t err = hype_score_select_launch(
      nbrs.data_ptr<int32_t>(), fringe.data_ptr<int32_t>(),
      bias.data_ptr<float>(), prev.data_ptr<float>(),
      scores.data_ptr<float>(), sel_idx.data_ptr<int32_t>(),
      sel_val.data_ptr<float>(), rem.data_ptr<int32_t>(),
      scratch.defined() ? scratch.data_ptr<float>() : nullptr, tickets,
      static_cast<int>(G), static_cast<int>(R), static_cast<int>(L),
      static_cast<int>(s), static_cast<int>(P), static_cast<int>(select_k),
      vec4, stream);
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

// The int32 scratch of kway_gains' global-counter route (past shared
// memory), or an undefined tensor.
torch::Tensor kway_scratch(int64_t B, int64_t k, const torch::Tensor& like) {
  const int64_t n =
      kway_gains_scratch_len(static_cast<int>(B), static_cast<int>(k));
  return n ? torch::empty({n}, like.options().dtype(torch::kInt32))
           : torch::Tensor();
}

int* data_or_null(const torch::Tensor& t) {
  return t.defined() ? t.data_ptr<int32_t>() : nullptr;
}

torch::Tensor kway_gains(const torch::Tensor& parts, const torch::Tensor& own,
                         int64_t k) {
  TORCH_CHECK(parts.is_cuda(), "parts must be a CUDA tensor");
  const torch::Device device = parts.device();
  check_input(parts, "parts", torch::kInt32, 2, device);
  check_input(own, "own", torch::kInt32, 1, device);
  const int64_t B = parts.size(0), L = parts.size(1);
  TORCH_CHECK(own.size(0) == B, "own must be (B,)");
  TORCH_CHECK(k >= 1 && k < kKwayK, "k must lie in [1, 2**28), got ", k);
  TORCH_CHECK(B < kInt31 && L < kKwayLen && B * L < (int64_t{1} << 40),
              "shape too large");

  const c10::cuda::CUDAGuard guard(device);
  torch::Tensor gains =
      torch::empty({B, k}, parts.options().dtype(torch::kFloat32));
  if (B == 0) return gains;
  const torch::Tensor scratch = kway_scratch(B, k, parts);
  const int vec4 = (L % 4 == 0) && aligned16(parts);
  C10_CUDA_CHECK(kway_gains_launch(
      parts.data_ptr<int32_t>(), own.data_ptr<int32_t>(),
      gains.data_ptr<float>(), data_or_null(scratch), static_cast<int>(B),
      static_cast<int>(L), static_cast<int>(k), vec4,
      at::cuda::getCurrentCUDAStream().stream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return gains;
}

// The screen: gains of the candidates ``cand`` (B,) read through the CSR
// (indptr int32 or int64, indices int32) and the (n + 1,) assignment, each
// row cut to its first ``tile_l`` neighbours. With ``delta_ids`` and
// ``delta_vals`` ((nd,) int32, -1 pads landing on the scratch slot n) the
// delta is written into the assignment in place first, and the gains'
// kernel waits for its stores before it reads the assignment: one device
// program. Ids must lie in range: the kernels read what they point at.
torch::Tensor kway_gains_csr(const torch::Tensor& indptr,
                             const torch::Tensor& indices,
                             torch::Tensor assign,
                             const torch::Tensor& cand, int64_t tile_l,
                             int64_t k,
                             const c10::optional<torch::Tensor>& delta_ids,
                             const c10::optional<torch::Tensor>& delta_vals) {
  TORCH_CHECK(cand.is_cuda(), "cand must be a CUDA tensor");
  const torch::Device device = cand.device();
  const auto ptr_type = indptr.scalar_type();
  TORCH_CHECK(ptr_type == torch::kInt32 || ptr_type == torch::kInt64,
              "indptr must be int32 or int64, got ", ptr_type);
  check_input(indptr, "indptr", ptr_type, 1, device);
  check_input(indices, "indices", torch::kInt32, 1, device);
  check_input(assign, "assign", torch::kInt32, 1, device);
  check_input(cand, "cand", torch::kInt32, 1, device);
  TORCH_CHECK(delta_ids.has_value() == delta_vals.has_value(),
              "delta_ids and delta_vals come together");
  int64_t nd = 0;
  if (delta_ids.has_value()) {
    check_input(*delta_ids, "delta_ids", torch::kInt32, 1, device);
    check_input(*delta_vals, "delta_vals", torch::kInt32, 1, device);
    nd = delta_ids->size(0);
    TORCH_CHECK(delta_vals->size(0) == nd,
                "delta_ids and delta_vals must have one length");
  }
  TORCH_CHECK(indptr.size(0) >= 1, "indptr must hold n + 1 offsets");
  TORCH_CHECK(assign.size(0) >= 1, "assign must hold n + 1 entries");
  TORCH_CHECK(k >= 1 && k < kKwayK, "k must lie in [1, 2**28), got ", k);
  TORCH_CHECK(tile_l >= 1 && tile_l < kKwayLen,
              "tile_l must lie in [1, 2**30), got ", tile_l);
  const int64_t B = cand.size(0);
  TORCH_CHECK(B < kInt31 && nd < kInt31 && assign.size(0) < kInt31,
              "shape too large");

  const c10::cuda::CUDAGuard guard(device);
  torch::Tensor gains =
      torch::empty({B, k}, cand.options().dtype(torch::kFloat32));
  if (B == 0 && nd == 0) return gains;
  const torch::Tensor scratch = kway_scratch(B, k, cand);
  C10_CUDA_CHECK(kway_gains_csr_launch(
      indptr.data_ptr(), ptr_type == torch::kInt64,
      indices.data_ptr<int32_t>(), assign.data_ptr<int32_t>(),
      static_cast<int>(assign.size(0) - 1),
      nd ? delta_ids->data_ptr<int32_t>() : nullptr,
      nd ? delta_vals->data_ptr<int32_t>() : nullptr, static_cast<int>(nd),
      cand.data_ptr<int32_t>(), gains.data_ptr<float>(),
      data_or_null(scratch), static_cast<int>(B), static_cast<int>(tile_l),
      static_cast<int>(k), at::cuda::getCurrentCUDAStream().stream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return gains;
}

// The stream's sequential commit of one micro-batch: parts (mb,) int32;
// ``sketch`` (k, 2**sketch_bits) and ``sizes`` (k,) are updated in place.
// The float knobs are rounded to float32 here, as the JAX program rounds
// them.
torch::Tensor stream_commit(const torch::Tensor& edge_tile,
                            const torch::Tensor& fcnt,
                            const torch::Tensor& valid_row,
                            const torch::Tensor& sketch,
                            const torch::Tensor& sizes, double alpha,
                            double fringe_w, double inv_target, int64_t cap,
                            int64_t sketch_bits) {
  TORCH_CHECK(edge_tile.is_cuda(), "edge_tile must be a CUDA tensor");
  const torch::Device device = edge_tile.device();
  check_input(edge_tile, "edge_tile", torch::kInt32, 2, device);
  check_input(fcnt, "fcnt", torch::kFloat32, 2, device);
  check_input(valid_row, "valid_row", torch::kBool, 1, device);
  check_input(sketch, "sketch", torch::kInt32, 2, device);
  check_input(sizes, "sizes", torch::kInt32, 1, device);
  const int64_t mb = edge_tile.size(0), Le = edge_tile.size(1);
  const int64_t k = sketch.size(0);
  TORCH_CHECK(sketch_bits >= 1 && sketch_bits <= 30,
              "sketch_bits must lie in [1, 30], got ", sketch_bits);
  TORCH_CHECK(sketch.size(1) == (int64_t{1} << sketch_bits),
              "sketch must be (k, 2**sketch_bits)");
  TORCH_CHECK(k >= 1 && k < kInt31, "k must lie in [1, 2**31)");
  TORCH_CHECK(sizes.size(0) == k, "sizes must be (k,)");
  TORCH_CHECK(fcnt.size(0) == mb && fcnt.size(1) == k,
              "fcnt must be (mb, k)");
  TORCH_CHECK(valid_row.size(0) == mb, "valid_row must be (mb,)");
  TORCH_CHECK(mb < kInt31 && Le < kInt31, "shape too large");
  TORCH_CHECK(cap > -kInt31 && cap < kInt31, "cap must fit int32");

  const c10::cuda::CUDAGuard guard(device);
  torch::Tensor parts = torch::empty({mb}, edge_tile.options());
  if (mb == 0) return parts;
  C10_CUDA_CHECK(stream_commit_launch(
      edge_tile.data_ptr<int32_t>(), fcnt.data_ptr<float>(),
      valid_row.data_ptr<bool>(), sketch.data_ptr<int32_t>(),
      sizes.data_ptr<int32_t>(), parts.data_ptr<int32_t>(),
      static_cast<int>(mb), static_cast<int>(Le), static_cast<int>(k),
      static_cast<int>(sketch_bits), static_cast<float>(alpha),
      static_cast<float>(fringe_w), static_cast<float>(inv_target),
      static_cast<int>(cap), at::cuda::getCurrentCUDAStream().stream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return parts;
}

// The branch of stream_commit.cu a launch of this shape takes, given the
// valid pins of its valid rows: 0 the row chain, 1 staged, 2 the staged
// kernel handing over to the row chain. Reads the card's shared memory.
int64_t stream_commit_branch_of(int64_t mb, int64_t Le, int64_t k,
                                int64_t pins) {
  TORCH_CHECK(mb >= 1 && mb < kInt31 && Le >= 0 && Le < kInt31 && k >= 1 &&
                  k < kInt31 && pins >= 0,
              "stream_commit_branch: shape out of range");
  return stream_commit_branch(static_cast<int>(mb), static_cast<int>(Le),
                              static_cast<int>(k), pins);
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

// Returns {out, lse}: lse is the (B, Hq, S) float32 logsumexp of each query
// row when ``want_lse``, else an empty tensor (serving asks for none).
std::vector<torch::Tensor> flash_attention(const torch::Tensor& q,
                                           const torch::Tensor& k,
                                           const torch::Tensor& v,
                                           bool causal, int64_t window,
                                           double scale, bool want_lse) {
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
  const auto f32 = q.options().dtype(torch::kFloat32);
  torch::Tensor lse = want_lse ? torch::empty({B, Hq, S}, f32)
                               : torch::empty({0}, f32);
  if (B == 0 || S == 0 || Hq == 0) return {out, lse};
  const int64_t qst[3] = {q.stride(0), q.stride(1), q.stride(2)};
  const int64_t kst[3] = {k.stride(0), k.stride(1), k.stride(2)};
  const int64_t ost[3] = {out.stride(0), out.stride(1), out.stride(2)};
  C10_CUDA_CHECK(flash_attention_launch(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
      want_lse ? lse.data_ptr<float>() : nullptr, static_cast<int>(B),
      static_cast<int>(S), static_cast<int>(Hq), static_cast<int>(Hkv),
      static_cast<int>(D), qst, kst, ost,
      static_cast<float>(scale), causal, static_cast<int>(window),
      dtype == torch::kBFloat16, at::cuda::getCurrentCUDAStream().stream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return {out, lse};
}

// The gradient of flash_attention: q, out and dout (B, S, Hq, D), k and v
// (B, S, Hkv, D), one dtype; lse the forward's (B, Hq, S) float32
// logsumexp. Returns (dq, dk, dv) in that dtype; the three passes share one
// float32 scratch (the rows' lse * log2(e) and delta, padded).
std::vector<torch::Tensor> flash_attention_bwd(
    const torch::Tensor& q, const torch::Tensor& k, const torch::Tensor& v,
    const torch::Tensor& out, const torch::Tensor& dout,
    const torch::Tensor& lse, bool causal, int64_t window, double scale) {
  TORCH_CHECK(q.is_cuda(), "q must be a CUDA tensor");
  const torch::Device device = q.device();
  const auto dtype = q.scalar_type();
  TORCH_CHECK(dtype == torch::kFloat32 || dtype == torch::kBFloat16,
              "q must be float32 or bfloat16, got ", dtype);
  check_input(q, "q", dtype, 4, device);
  check_input(k, "k", dtype, 4, device);
  check_input(v, "v", dtype, 4, device);
  check_input(out, "out", dtype, 4, device);
  check_input(dout, "dout", dtype, 4, device);
  check_input(lse, "lse", torch::kFloat32, 3, device);
  const int64_t B = q.size(0), S = q.size(1), Hq = q.size(2), D = q.size(3);
  const int64_t Hkv = k.size(2);
  TORCH_CHECK(out.sizes() == q.sizes() && dout.sizes() == q.sizes(),
              "out and dout must have q's shape");
  TORCH_CHECK(lse.size(0) == B && lse.size(1) == Hq && lse.size(2) == S,
              "lse must be (B, Hq, S)");
  TORCH_CHECK(k.sizes() == v.sizes(), "k and v must have one shape");
  TORCH_CHECK(k.size(0) == B && k.size(1) == S && k.size(3) == D,
              "k and v must be (B, S, Hkv, D) beside q's (B, S, Hq, D)");
  TORCH_CHECK(Hkv >= 1 && Hq % Hkv == 0, "Hq must be a multiple of Hkv");
  TORCH_CHECK(D >= 8 && D <= 256 && D % 8 == 0,
              "D must be a multiple of 8 in [8, 256], got ", D);
  TORCH_CHECK(B < 65536 && Hq < 65536 && S < (int64_t{1} << 31),
              "shape too large for the kernel's grid");
  TORCH_CHECK(aligned16(q) && aligned16(k) && aligned16(v) &&
                  aligned16(out) && aligned16(dout),
              "q, k, v, out and dout must be 16-byte aligned");

  const c10::cuda::CUDAGuard guard(device);
  torch::Tensor dq = torch::empty_like(q);
  torch::Tensor dk = torch::empty_like(k);
  torch::Tensor dv = torch::empty_like(v);
  if (B == 0 || S == 0 || Hq == 0) return {dq, dk, dv};
  torch::Tensor aux = torch::empty(
      {flash_attention_bwd_aux_len(static_cast<int>(B), static_cast<int>(Hq),
                                   static_cast<int>(S))},
      q.options().dtype(torch::kFloat32));
  const int64_t qst[3] = {q.stride(0), q.stride(1), q.stride(2)};
  const int64_t kst[3] = {k.stride(0), k.stride(1), k.stride(2)};
  C10_CUDA_CHECK(flash_attention_bwd_launch(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
      dout.data_ptr(), lse.data_ptr<float>(), dq.data_ptr(), dk.data_ptr(),
      dv.data_ptr(), aux.data_ptr<float>(), static_cast<int>(B),
      static_cast<int>(S), static_cast<int>(Hq), static_cast<int>(Hkv),
      static_cast<int>(D), qst, kst, static_cast<float>(scale), causal,
      static_cast<int>(window), dtype == torch::kBFloat16,
      at::cuda::getCurrentCUDAStream().stream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return {dq, dk, dv};
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
  TORCH_CHECK(D < kInt31 && K < kInt31 && F < kInt31 && B < kInt31,
              "shape too large");
  const int w_bf16 = w.scalar_type() == torch::kBFloat16;
  // the dynamic shared memory of the kernel's plan
  TORCH_CHECK(neighbor_agg_smem_bytes(static_cast<int>(D),
                                      static_cast<int>(F)) <=
                  static_cast<size_t>(max_smem_optin()),
              "D = ", D, " exceeds the kernel's shared memory");

  const c10::cuda::CUDAGuard guard(device);
  torch::Tensor out = torch::empty({B, F}, x.options());
  torch::Tensor mean = torch::empty(
      {want_mean ? B : 0, want_mean ? D : 0},
      x.options().dtype(torch::kFloat32));
  if (B == 0) return {out, mean};
  const int vec = (D * x.element_size()) % 16 == 0 && aligned16(x);
  const int id_vec = K % 4 == 0 && aligned16(nbrs);
  const int out_vec = (F * out.element_size()) % 16 == 0 && aligned16(out);
  C10_CUDA_CHECK(neighbor_agg_launch(
      x.data_ptr(), nbrs.data_ptr<int32_t>(), w.data_ptr(), out.data_ptr(),
      want_mean ? mean.data_ptr<float>() : nullptr, B, static_cast<int>(K),
      static_cast<int>(D), static_cast<int>(F),
      x.scalar_type() == torch::kBFloat16, w_bf16, vec, id_vec, out_vec,
      at::cuda::getCurrentCUDAStream().stream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return {out, mean};
}

// grad_x (N, D) in ``bf16 ? bfloat16 : float32`` from g (B, D) float32,
// the per-row valid counts (B,), and the transposed index: rowptr (N + 1)
// int64, rows (rowptr[N]) int32, and the chunk units of the ids with
// more than 32 slots: hptr (N + 1) int64 and hunit (at least hptr[N])
// int32, whose length sizes the units' scratch. ``mean`` false is the
// sum mode (no division by the counts, which are then not read and may
// have any length). Launches on the stream: a memset of the tickets and
// the heavy pass (when hunit is not empty), then the light pass.
torch::Tensor neighbor_agg_bwd(const torch::Tensor& g,
                               const torch::Tensor& cnt,
                               const torch::Tensor& rowptr,
                               const torch::Tensor& rows,
                               const torch::Tensor& hptr,
                               const torch::Tensor& hunit, bool bf16,
                               bool mean) {
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
  TORCH_CHECK(!mean || cnt.size(0) == B, "cnt must be (B,)");
  TORCH_CHECK(D < (int64_t{1} << 31), "shape too large");

  const c10::cuda::CUDAGuard guard(device);
  torch::Tensor grad_x = torch::empty(
      {N, D}, g.options().dtype(bf16 ? torch::kBFloat16 : torch::kFloat32));
  if (N == 0 || D == 0) return grad_x;
  const int64_t cap = hunit.size(0);
  torch::Tensor partials = torch::empty({cap, D}, g.options());
  torch::Tensor tickets = torch::empty({cap + 1}, hunit.options());
  const int vec = D % 4 == 0 && aligned16(g);
  C10_CUDA_CHECK(neighbor_agg_bwd_launch(
      g.data_ptr<float>(), mean ? cnt.data_ptr<int32_t>() : nullptr,
      rowptr.data_ptr<int64_t>(), rows.data_ptr<int32_t>(),
      hptr.data_ptr<int64_t>(), hunit.data_ptr<int32_t>(),
      partials.data_ptr<float>(), tickets.data_ptr<int32_t>(), cap,
      grad_x.data_ptr(), N, static_cast<int>(D), bf16, vec,
      at::cuda::getCurrentCUDAStream().stream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return grad_x;
}

// Row 5c: out (N, D) float32, the sum of msgs (E, D) float32 by id over
// the segment index: rowptr (N + 1) int64, rows (at least rowptr[N]) int32
// (the edges sorted stably by id), and the chunk units of the ids of more
// than 32 edges, hptr (N + 1) int64 and hunit (at least hptr[N]) int32,
// whose length sizes the partials. One launch: the tickets come from the
// stream's zeroed workspace, which the kernel leaves zeroed.
torch::Tensor segment_sum(const torch::Tensor& msgs,
                          const torch::Tensor& rowptr,
                          const torch::Tensor& rows,
                          const torch::Tensor& hptr,
                          const torch::Tensor& hunit) {
  TORCH_CHECK(msgs.is_cuda(), "msgs must be a CUDA tensor");
  const torch::Device device = msgs.device();
  check_input(msgs, "msgs", torch::kFloat32, 2, device);
  check_input(rowptr, "rowptr", torch::kInt64, 1, device);
  check_input(rows, "rows", torch::kInt32, 1, device);
  check_input(hptr, "hptr", torch::kInt64, 1, device);
  check_input(hunit, "hunit", torch::kInt32, 1, device);
  const int64_t D = msgs.size(1), N = rowptr.size(0) - 1;
  TORCH_CHECK(N >= 0, "rowptr must hold N + 1 offsets");
  TORCH_CHECK(hptr.size(0) == N + 1, "hptr must hold N + 1 offsets");
  TORCH_CHECK(D < kInt31 && hunit.size(0) < kInt31, "shape too large");

  const c10::cuda::CUDAGuard guard(device);
  torch::Tensor out = torch::empty({N, D}, msgs.options());
  if (N == 0 || D == 0) return out;
  const int64_t cap = hunit.size(0);
  torch::Tensor partials = torch::empty({cap, D}, msgs.options());
  const cudaStream_t stream = at::cuda::getCurrentCUDAStream().stream();
  int32_t* tickets = zeroed_tickets(cap + 1, device, stream);
  // the largest power of two, at most 16, dividing every base address
  const std::uintptr_t bits =
      16 | reinterpret_cast<std::uintptr_t>(msgs.data_ptr()) |
      reinterpret_cast<std::uintptr_t>(out.data_ptr()) |
      reinterpret_cast<std::uintptr_t>(partials.data_ptr());
  const int align = static_cast<int>(bits & (~bits + 1));
  C10_CUDA_CHECK(segment_sum_launch(
      msgs.data_ptr<float>(), rowptr.data_ptr<int64_t>(),
      rows.data_ptr<int32_t>(), hptr.data_ptr<int64_t>(),
      hunit.data_ptr<int32_t>(), partials.data_ptr<float>(), tickets, cap,
      out.data_ptr<float>(), N, static_cast<int>(D), align, stream));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

// The floats a lane of segment_sum loads at once for rows of D floats at
// the given base alignment (4, 2 or 1; chip_smoke.py reports it).
int64_t segment_sum_vec_width_of(int64_t D, int64_t align) {
  return segment_sum_vec_width(static_cast<int>(D), static_cast<int>(align));
}

// Row 5d: x (N, D) float32, the rows' CSR (indptr (B + 1) int64, indices
// int32, at least indptr[B] of them) and its chunk units (hptr (B + 1)
// int64, hunit int32, whose length sizes the scratch), w (D, F) float32
// or bfloat16. Returns {out (B, F), mean (B, D)}, both float32: the heavy
// pass writes the means of the rows past 32 slots, the tile kernel the
// rest and every row of out (a memset of the tickets and the counters
// first).
std::vector<torch::Tensor> neighbor_agg_csr(const torch::Tensor& x,
                                            const torch::Tensor& indptr,
                                            const torch::Tensor& indices,
                                            const torch::Tensor& hptr,
                                            const torch::Tensor& hunit,
                                            const torch::Tensor& w) {
  TORCH_CHECK(x.is_cuda(), "x must be a CUDA tensor");
  const torch::Device device = x.device();
  TORCH_CHECK(float_or_bf16(w), "w must be float32 or bfloat16, got ",
              w.scalar_type());
  check_input(x, "x", torch::kFloat32, 2, device);
  check_input(indptr, "indptr", torch::kInt64, 1, device);
  check_input(indices, "indices", torch::kInt32, 1, device);
  check_input(hptr, "hptr", torch::kInt64, 1, device);
  check_input(hunit, "hunit", torch::kInt32, 1, device);
  check_input(w, "w", w.scalar_type(), 2, device);
  const int64_t B = indptr.size(0) - 1, D = x.size(1), F = w.size(1);
  TORCH_CHECK(B >= 0, "indptr must hold B + 1 offsets");
  TORCH_CHECK(hptr.size(0) == B + 1, "hptr must hold B + 1 offsets");
  TORCH_CHECK(w.size(0) == D, "w must be (D, F) with D = ", D);
  TORCH_CHECK(D < kInt31 && F < kInt31 && B < kInt31, "shape too large");
  const int w_bf16 = w.scalar_type() == torch::kBFloat16;
  TORCH_CHECK(neighbor_agg_csr_smem_bytes(static_cast<int>(D),
                                          static_cast<int>(F), w_bf16) <=
                  static_cast<size_t>(max_smem_optin()),
              "D = ", D, " exceeds the tile kernel's shared memory");
  const c10::cuda::CUDAGuard guard(device);
  torch::Tensor out = torch::empty({B, F}, x.options());
  torch::Tensor mean = torch::empty({B, D}, x.options());
  if (B == 0 || D == 0) return {out.zero_(), mean};
  const int64_t cap = hunit.size(0);
  torch::Tensor partials = torch::empty({cap, D}, x.options());
  torch::Tensor tickets = torch::empty({cap + 2}, hunit.options());
  const int vec = D % 4 == 0 && aligned16(x) && aligned16(mean);
  C10_CUDA_CHECK(neighbor_agg_csr_launch(
      x.data_ptr<float>(), indptr.data_ptr<int64_t>(),
      indices.data_ptr<int32_t>(), hptr.data_ptr<int64_t>(),
      hunit.data_ptr<int32_t>(), partials.data_ptr<float>(),
      tickets.data_ptr<int32_t>(), cap, w.data_ptr(), mean.data_ptr<float>(),
      out.data_ptr<float>(), B, static_cast<int>(D), static_cast<int>(F),
      w_bf16, vec,
      at::cuda::getCurrentCUDAStream().stream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return {out, mean};
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("score_select", &score_select,
        "Fused HYPE score + per-phase select (CUDA, sm_90a)");
  m.def("scores", &scores, "HYPE external-neighbours scores (CUDA, sm_90a)");
  m.def("kway_gains", &kway_gains, "K-way move gains (CUDA, sm_90a)");
  m.def("kway_gains_csr", &kway_gains_csr,
        "K-way move gains of candidates read through a CSR, after the "
        "refinement screen's delta when given (CUDA, sm_90a)");
  m.def("stream_commit", &stream_commit,
        "The streaming engine's sequential sketch commit (CUDA, sm_90a)");
  m.def("stream_commit_branch", &stream_commit_branch_of,
        "The branch of the stream_commit kernel a shape and pin count take");
  m.def("embedding_bag", &embedding_bag,
        "EmbeddingBag sum/mean over -1-padded bags (CUDA, sm_90a)");
  m.def("flash_attention", &flash_attention,
        "Causal / sliding-window GQA attention forward and, on request, "
        "its logsumexp (CUDA, sm_90a)");
  m.def("flash_attention_bwd", &flash_attention_bwd,
        "Gradient of flash_attention: dq, dk, dv, deterministic (CUDA, "
        "sm_90a)");
  m.def("neighbor_agg", &neighbor_agg,
        "Mean of the -1-padded neighbour rows times w (CUDA, sm_90a)");
  m.def("neighbor_agg_bwd", &neighbor_agg_bwd,
        "Gradient of x of neighbor_agg, or of an EmbeddingBag's table "
        "(mean or sum), deterministic (CUDA, sm_90a)");
  m.def("segment_sum", &segment_sum,
        "Row 5c: the sum of an edge list's rows by id, deterministic "
        "(CUDA, sm_90a)");
  m.def("segment_sum_vec_width", &segment_sum_vec_width_of,
        "The floats a lane of segment_sum loads at once");
  m.def("neighbor_agg_csr", &neighbor_agg_csr,
        "Row 5d: the mean of each CSR row's neighbour rows (chunk order) "
        "and its product with w on the tensor cores (CUDA, sm_90a)");
}
