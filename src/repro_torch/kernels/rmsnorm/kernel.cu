// RMSNorm forward for Hopper (sm_90a), with a plain C entry point that
// ../binding.cpp wraps for PyTorch.
//
// Replaces the Pallas kernel src/repro/kernels/rmsnorm/kernel.py
// (rmsnorm_pallas / _rmsnorm_kernel): per row of x (R, D),
//     out = x * rsqrt(mean(x^2) + eps) * w
// computed in f32 and cast back to x's dtype.  x is f32 or bf16; w is always
// f32 (the model keeps its norm weights in f32 while activations are bf16),
// so the kernels are templated on x's type only.
//
// Bound: memory.  The least traffic is one read of x and one write of out
// (w, D floats, is read by every row but from L1 or L2), with ~4 flops per
// element, far below the card's flop/byte ridge.  A row is a few KB, so
// what holds a kernel back from that bound is latency: enough bytes must be
// in flight on each SM, and no row may wait long on its own reduction.
//
// Two kernels behind one entry point, chosen by rmsnorm_forward from D,
// dtype and pointer alignment:
//
// vector route (D a multiple of 16 bytes' worth of x, D <= 4096, x, w and
// out 16-byte aligned; every width of the serving paths): a row belongs to
// WPR warps, the fewest of 1, 2, 4 and 8 at which a lane holds at most 16
// values (2 bf16 or 4 f32 vectors): rows of 768, 1536, 2048 and 4096 take
// 2, 4, 4 and 8 warps, in either dtype.  Each lane issues all its 16-byte
// loads of the row (VPL of them, VPL a template parameter so the loop
// unrolls and the row stays in registers) before it uses any, sums the
// squares in f32, reduces across its warp with shuffles and, for WPR > 1,
// once through shared memory; then it scales the registers it holds,
// reading w as 16-byte vectors, and writes out with 16-byte stores.  x is
// read once.  A CTA holds 8 warps, each group of WPR on its own row; for
// few rows (a decode step's 8) and WPR < 8 the CTAs shrink to spread the
// rows over more SMs.
//
// scalar route (any other D or alignment, e.g. a view with an odd storage
// offset, or a row wider than 4096): one CTA of 256 threads per row
// striding over the row, warp shuffles then one shared-memory pass across
// warps; x is read twice (the second read hits L1/L2).
//
// The row loader and the reductions are separate functions so that a
// backward kernel can hold its row the same way.

#include <cstdint>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kWarp = 32;
constexpr int kScalarThreads = 256;
constexpr int kMaxWarps = 8;      // warps of a vector-route CTA
constexpr int kMaxRowWarps = 8;   // warps sharing one row, at most
// Values of x a lane holds, at most.  Rows spread thin run faster: at
// (4096, D) bf16, 64 values a lane took 0.0268 / 0.0100 / 0.0065 / 0.0038
// ms at D 4096 / 2048 / 1536 / 768, 16 a lane 0.0249 / 0.0078 / 0.0061 /
// 0.0037, and (8, 2048) fell from 0.0029 to 0.0017 ms (profiler's device
// time, H100 SXM, 700 W).  The compiler keeps a lane's values unpacked to
// f32 from the sum to the scaling: 16 bf16 vectors a lane took 148
// registers, one CTA an SM, and 2 take 32.
constexpr int kLaneValues = 16;
// widest row of the vector route: kLaneValues a lane, kMaxRowWarps warps
constexpr int kMaxVecD = kWarp * kMaxRowWarps * kLaneValues;

// ------------------------------------------------------------ scalar route

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
__global__ void __launch_bounds__(kScalarThreads)
rmsnorm_scalar_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      T* __restrict__ out, int D, float eps) {
  __shared__ float warp_sums[kScalarThreads / kWarp];
  __shared__ float row_scale;
  const long long row = blockIdx.x;
  const T* xr = x + row * D;
  T* orow = out + row * D;

  float ss = 0.f;
  for (int i = threadIdx.x; i < D; i += kScalarThreads) {
    float v = to_f32(xr[i]);
    ss = fmaf(v, v, ss);
  }
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    ss = lane < kScalarThreads / kWarp ? warp_sums[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (lane == 0) row_scale = rsqrtf(ss / (float)D + eps);
  }
  __syncthreads();
  const float r = row_scale;
  for (int i = threadIdx.x; i < D; i += kScalarThreads)
    orow[i] = from_f32<T>(to_f32(xr[i]) * r * w[i]);
}

// ------------------------------------------------------------ vector route

// One 16-byte vector of T as kN f32 values, and back.
template <typename T> struct Pack;

template <> struct Pack<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void unpack(const uint4& v,
                                                float (&f)[kN]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ __forceinline__ static uint4 pack(const float (&f)[kN]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <> struct Pack<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void unpack(const uint4& v,
                                                float (&f)[kN]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < kN / 2; ++k) {
      const float2 p = __bfloat1622float2(h[k]);
      f[2 * k] = p.x;
      f[2 * k + 1] = p.y;
    }
  }
  // rounds to nearest even, as __float2bfloat16 and torch's .to(bfloat16)
  __device__ __forceinline__ static uint4 pack(const float (&f)[kN]) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < kN / 2; ++k)
      h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
    return v;
  }
};

// The vectors of one row that lane `lane` of the row's LANES threads holds:
// vector j * LANES + lane for j < VPL, zero past nvec (a zero adds nothing
// to the sum of squares).  All the loads are issued before any is used.
template <int VPL, int LANES>
__device__ __forceinline__ void load_row(const uint4* __restrict__ row,
                                         int nvec, int lane,
                                         uint4 (&v)[VPL]) {
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int i = j * LANES + lane;
    v[j] = i < nvec ? row[i] : make_uint4(0u, 0u, 0u, 0u);
  }
}

// f32 sum of the squares of the values a lane holds.
template <typename T, int VPL>
__device__ __forceinline__ float sum_squares(const uint4 (&v)[VPL]) {
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    float f[Pack<T>::kN];
    Pack<T>::unpack(v[j], f);
#pragma unroll
    for (int k = 0; k < Pack<T>::kN; ++k) ss = fmaf(f[k], f[k], ss);
  }
  return ss;
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// The sum over the WPR warps of a row of each warp's total `s` (the same in
// every lane), through shared memory; every warp of the CTA must call it.
// Each warp adds the partial sums in the same order, so all lanes of a row
// get the same bits.
template <int WPR>
__device__ __forceinline__ float row_sum(float s, float* partial) {
  if (WPR == 1) return s;
  const int warp = threadIdx.x / kWarp;
  if (threadIdx.x % kWarp == 0) partial[warp] = s;
  __syncthreads();
  const int first = warp - warp % WPR;
  s = 0.f;
#pragma unroll
  for (int k = 0; k < WPR; ++k) s += partial[first + k];
  return s;
}

// A CTA of blockDim.x / 32 warps normalises blockDim.x / (32 * WPR) rows.
template <typename T, int VPL, int WPR>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
rmsnorm_vec_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   T* __restrict__ out, int rows, int D, float eps) {
  constexpr int kLanes = WPR * kWarp;
  constexpr int kN = Pack<T>::kN;
  __shared__ float partial[kMaxWarps];
  const long long row = static_cast<long long>(blockIdx.x) *
                            (blockDim.x / kLanes) + threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  // a row past the end loads and stores nothing, but its warps still take
  // part in row_sum's barrier
  const int nvec = row < rows ? D / kN : 0;
  const long long base = row < rows ? row * D : 0;

  uint4 v[VPL];
  load_row<VPL, kLanes>(reinterpret_cast<const uint4*>(x + base), nvec, lane,
                        v);
  const float ss = row_sum<WPR>(warp_sum(sum_squares<T, VPL>(v)), partial);
  const float r = rsqrtf(ss / (float)D + eps);

  const float4* w4 = reinterpret_cast<const float4*>(w);
  uint4* orow = reinterpret_cast<uint4*>(out + base);
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int i = j * kLanes + lane;
    if (i >= nvec) continue;
    float f[kN];
    Pack<T>::unpack(v[j], f);
#pragma unroll
    for (int q = 0; q < kN / 4; ++q) {
      const float4 wq = __ldg(w4 + i * (kN / 4) + q);
      f[4 * q] = f[4 * q] * r * wq.x;
      f[4 * q + 1] = f[4 * q + 1] * r * wq.y;
      f[4 * q + 2] = f[4 * q + 2] * r * wq.z;
      f[4 * q + 3] = f[4 * q + 3] * r * wq.w;
    }
    orow[i] = Pack<T>::pack(f);
  }
}

// One launch's arguments, as rmsnorm_forward gets them.
struct Args {
  const void* x;
  const float* w;
  void* out;
  int rows, D;
  float eps;
  cudaStream_t s;
};

// The SMs of the card, read once (the cards of one host are one model).
int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    return sms;
  }();
  return n;
}

template <typename T, int VPL, int WPR>
int launch_vec(const Args& a) {
  // fewer CTAs of kMaxWarps than the card has SMs: smaller CTAs
  int warps = kMaxWarps;
  while (warps > WPR && static_cast<long long>(a.rows) * WPR <
                            static_cast<long long>(warps) * sm_count())
    warps /= 2;
  const int rows_per_cta = warps / WPR;
  const unsigned grid = (a.rows + rows_per_cta - 1) / rows_per_cta;
  rmsnorm_vec_kernel<T, VPL, WPR><<<grid, warps * kWarp, 0, a.s>>>(
      static_cast<const T*>(a.x), a.w, static_cast<T*>(a.out), a.rows, a.D,
      a.eps);
  return static_cast<int>(cudaGetLastError());
}

// Launches the smallest VPL with vpl <= VPL <= kLaneValues' worth of
// vectors (2 bf16 or 4 f32).
template <typename T, int WPR>
int launch_vpl(int vpl, const Args& a) {
  constexpr int kTop = kLaneValues / Pack<T>::kN;
  static_assert(kTop == 2 || kTop == 4, "a lane holds 2 or 4 vectors");
  if (vpl <= 1) return launch_vec<T, 1, WPR>(a);
  if constexpr (kTop == 2) {
    return launch_vec<T, 2, WPR>(a);
  } else {
    if (vpl <= 2) return launch_vec<T, 2, WPR>(a);
    if (vpl <= 3) return launch_vec<T, 3, WPR>(a);
    return launch_vec<T, 4, WPR>(a);
  }
}

// The fewest warps a row (1, 2, 4 or 8) whose lanes hold the row's nvec
// vectors at kLaneValues values a lane (nvec <= kMaxVecD / kN).
template <typename T>
int launch_vec_for(int nvec, const Args& a) {
  constexpr int kLaneVecs = kLaneValues / Pack<T>::kN;
  const int vpl = (nvec + kWarp - 1) / kWarp;   // vectors a lane at WPR 1
  if (vpl <= kLaneVecs) return launch_vpl<T, 1>(vpl, a);
  if (vpl <= 2 * kLaneVecs) return launch_vpl<T, 2>((vpl + 1) / 2, a);
  if (vpl <= 4 * kLaneVecs) return launch_vpl<T, 4>((vpl + 3) / 4, a);
  return launch_vpl<T, 8>((vpl + 7) / 8, a);
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch(const Args& a) {
  constexpr int kN = Pack<T>::kN;
  if (a.D % kN == 0 && a.D <= kMaxVecD &&
      aligned16(a.x) && aligned16(a.w) && aligned16(a.out))
    return launch_vec_for<T>(a.D / kN, a);
  rmsnorm_scalar_kernel<T><<<a.rows, kScalarThreads, 0, a.s>>>(
      static_cast<const T*>(a.x), a.w, static_cast<T*>(a.out), a.D, a.eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int rmsnorm_forward(const void* x, const float* w, void* out,
                               int rows, int D, float eps, int dtype,
                               void* stream) {
  if (rows <= 0) return 0;
  const Args a{x, w, out, rows, D, eps, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch<float>(a);
  if (dtype == 1) return launch<__nv_bfloat16>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}
