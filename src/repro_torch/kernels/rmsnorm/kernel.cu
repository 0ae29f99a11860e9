// RMSNorm forward for Hopper (sm_90a), with a plain C entry point that
// ../binding.cpp wraps for PyTorch.
//
// Replaces the Pallas kernel src/repro/kernels/rmsnorm/kernel.py
// (rmsnorm_pallas / _rmsnorm_kernel): per row of x (R, D),
//     out = x * rsqrt(mean(x^2) + eps) * w
// computed in f32 and cast back to x's dtype.  x is f32 or bf16; w is always
// f32 (the model keeps its norm weights in f32 while activations are bf16),
// so the kernel is templated on x's type only.
//
// Bound: memory.  Each element is read twice (the second read hits L1/L2)
// and written once, with ~4 flops per element, far below the card's
// flop/byte ridge.  Design: one CTA per row, so every row's reduction stays
// on one SM (warp shuffles, then one shared-memory pass across warps) and
// no second kernel or atomic is needed; any D and any row count work
// because threads stride over the row.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ out, int D, float eps) {
  __shared__ float warp_sums[kThreads / 32];
  __shared__ float row_scale;
  const long long row = blockIdx.x;
  const T* xr = x + row * D;
  T* orow = out + row * D;

  float ss = 0.f;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    float v = to_f32(xr[i]);
    ss = fmaf(v, v, ss);
  }
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    ss = lane < kThreads / 32 ? warp_sums[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (lane == 0) row_scale = rsqrtf(ss / (float)D + eps);
  }
  __syncthreads();
  const float r = row_scale;
  for (int i = threadIdx.x; i < D; i += kThreads)
    orow[i] = from_f32<T>(to_f32(xr[i]) * r * w[i]);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int rmsnorm_forward(const void* x, const float* w, void* out,
                               int rows, int D, float eps, int dtype,
                               void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    rmsnorm_kernel<float><<<rows, kThreads, 0, s>>>(
        static_cast<const float*>(x), w, static_cast<float*>(out), D, eps);
  } else if (dtype == 1) {
    rmsnorm_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), w,
        static_cast<__nv_bfloat16*>(out), D, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
