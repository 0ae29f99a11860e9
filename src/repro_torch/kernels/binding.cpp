// PyTorch binding of the port's CUDA kernels, and the extension's only
// source that includes torch/extension.h.  Each function allocates its
// output, launches its kernel's C entry point (<name>/kernel.cu) on the
// current stream and raises if the launch was refused.  The Python wrappers
// in <name>/ops.py check device, dtype, shape and contiguity first.

#include <cmath>
#include <tuple>

#include <c10/cuda/CUDAStream.h>
#include <torch/extension.h>

extern "C" int rmsnorm_forward(const void* x, const float* w, void* out,
                               int rows, int D, float eps, int dtype,
                               void* stream);
extern "C" int flash_attention_forward(const void* q, const void* k,
                                       const void* v, void* o, int B, int S,
                                       int H, int Kv, int D, int causal,
                                       float scale, float softcap, int dtype,
                                       void* stream);
extern "C" int ssd_forward(const void* x, const float* dt, const float* A,
                           const void* B, const void* C, void* y,
                           float* state, int Bt, int S, int H, int G, int P,
                           int N, int Q, int dtype, void* stream);
extern "C" long long mlstm_scratch_bytes(int B, int S, int H, int D, int Q,
                                         int dtype);
extern "C" int mlstm_forward(const void* q, const void* k, const void* v,
                             const float* i_raw, const float* f_raw,
                             void* h, float* C, float* n, float* m, int B,
                             int S, int H, int D, int Q, float scale,
                             void* scratch, int dtype, void* stream);

namespace {

// the kernels' dtype codes: 0 = float32, 1 = bfloat16
int dtype_code(const torch::Tensor& t) {
  TORCH_CHECK(t.scalar_type() == torch::kFloat ||
                  t.scalar_type() == torch::kBFloat16,
              "the kernels take float32 or bfloat16, got ", t.scalar_type());
  return t.scalar_type() == torch::kFloat ? 0 : 1;
}

void* stream_of(const torch::Tensor& t) {
  return c10::cuda::getCurrentCUDAStream(t.device().index()).stream();
}

torch::Tensor rmsnorm(const torch::Tensor& x, const torch::Tensor& w,
                      double eps) {
  auto out = torch::empty_like(x);
  const int64_t D = x.size(-1);
  const int64_t rows = D ? x.numel() / D : 0;
  const int err = rmsnorm_forward(x.data_ptr(), w.data_ptr<float>(),
                                  out.data_ptr(), static_cast<int>(rows),
                                  static_cast<int>(D),
                                  static_cast<float>(eps), dtype_code(x),
                                  stream_of(x));
  TORCH_CHECK(err == 0, "rmsnorm kernel launch failed: cudaError ", err);
  return out;
}

torch::Tensor flash_attention(const torch::Tensor& q, const torch::Tensor& k,
                              const torch::Tensor& v, bool causal,
                              double softcap) {
  auto out = torch::empty_like(q);
  const int D = static_cast<int>(q.size(3));
  const int err = flash_attention_forward(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
      static_cast<int>(q.size(0)), static_cast<int>(q.size(1)),
      static_cast<int>(q.size(2)), static_cast<int>(k.size(2)), D,
      causal ? 1 : 0, static_cast<float>(1.0 / std::sqrt(double(D))),
      static_cast<float>(softcap), dtype_code(q), stream_of(q));
  TORCH_CHECK(err == 0, "flash_attention kernel launch failed: cudaError ",
              err);
  return out;
}

std::tuple<torch::Tensor, torch::Tensor> ssd(const torch::Tensor& x,
                                             const torch::Tensor& dt,
                                             const torch::Tensor& A,
                                             const torch::Tensor& B,
                                             const torch::Tensor& C,
                                             int64_t chunk) {
  auto y = torch::empty_like(x);
  const int64_t Bt = x.size(0), S = x.size(1), H = x.size(2), P = x.size(3);
  const int64_t G = B.size(2), N = B.size(3);
  auto state = torch::empty({Bt, H, P, N}, x.options().dtype(torch::kFloat));
  const int err = ssd_forward(
      x.data_ptr(), dt.data_ptr<float>(), A.data_ptr<float>(), B.data_ptr(),
      C.data_ptr(), y.data_ptr(), state.data_ptr<float>(),
      static_cast<int>(Bt), static_cast<int>(S), static_cast<int>(H),
      static_cast<int>(G), static_cast<int>(P), static_cast<int>(N),
      static_cast<int>(chunk), dtype_code(x), stream_of(x));
  TORCH_CHECK(err == 0, "ssd kernel launch failed: cudaError ", err);
  return {y, state};
}

std::tuple<torch::Tensor, torch::Tensor, torch::Tensor, torch::Tensor>
mlstm(const torch::Tensor& q, const torch::Tensor& k, const torch::Tensor& v,
      const torch::Tensor& i_raw, const torch::Tensor& f_raw,
      int64_t chunk) {
  auto h = torch::empty_like(q);
  const int64_t B = q.size(0), S = q.size(1), H = q.size(2), D = q.size(3);
  const auto f32 = q.options().dtype(torch::kFloat);
  auto C = torch::empty({B, H, D, D}, f32);
  auto n = torch::empty({B, H, D}, f32);
  auto m = torch::empty({B, H}, f32);
  // the bf16 path's gate chain and the states entering each chunk
  const int dtype = dtype_code(q);
  auto scratch = torch::empty(
      {mlstm_scratch_bytes(static_cast<int>(B), static_cast<int>(S),
                           static_cast<int>(H), static_cast<int>(D),
                           static_cast<int>(chunk), dtype)},
      q.options().dtype(torch::kUInt8));
  const int err = mlstm_forward(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), i_raw.data_ptr<float>(),
      f_raw.data_ptr<float>(), h.data_ptr(), C.data_ptr<float>(),
      n.data_ptr<float>(), m.data_ptr<float>(), static_cast<int>(B),
      static_cast<int>(S), static_cast<int>(H), static_cast<int>(D),
      static_cast<int>(chunk),
      static_cast<float>(1.0 / std::sqrt(double(D))), scratch.data_ptr(),
      dtype, stream_of(q));
  TORCH_CHECK(err == 0, "mlstm kernel launch failed: cudaError ", err);
  return {h, C, n, m};
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("rmsnorm", &rmsnorm, "RMSNorm of the rows of x (..., D)");
  m.def("flash_attention", &flash_attention,
        "GQA flash attention forward, q (B,S,H,D), k/v (B,S,Kv,D)");
  m.def("ssd", &ssd,
        "Mamba2 SSD chunked scan, x (Bt,S,H,P), dt (Bt,S,H), A (H,), "
        "B/C (Bt,S,G,N) -> (y, final state (Bt,H,P,N) f32)");
  m.def("mlstm", &mlstm,
        "chunked mLSTM, q/k/v (B,S,H,D), gates (B,S,H) f32 -> (h, C "
        "(B,H,D,D), n (B,H,D), m (B,H)), the final carry in f32");
}
