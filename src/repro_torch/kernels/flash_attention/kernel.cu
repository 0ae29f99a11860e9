// Causal / non-causal GQA flash attention forward for Hopper (sm_90a), with a
// plain C entry point that ../binding.cpp wraps for PyTorch.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_bhsd / _attn_kernel): online softmax with m, l and acc in
// f32, scores scaled by 1/sqrt(D), optional tanh softcap applied before the
// mask, masked scores set to -1e30 (not -inf), kv tiles past the diagonal
// skipped when causal, output acc / max(l, 1e-30) in q's dtype.
//
// Layout: q (B, S, H, D), k/v (B, S, Kv, D), out (B, S, H, D), all
// contiguous -- the model's own layout, so no transpose is needed around the
// call.  Query head h of batch b reads kv head h / G (G = H / Kv), i.e. kv
// row (b*H + h) / G = b*Kv + h/G of the Pallas kernel's (B*Kv, S, D) view;
// repeated KV is never materialised.
//
// Bound: at the serving path's shapes (S = 1024, D = 64) the work is
// ~4*D flops per (query, key) pair against ~4*D bytes per query row, so the
// tensor-core rate bounds it, not memory.  This first version does the
// arithmetic as scalar f32 FMAs (no wgmma / TMA): one thread owns one query
// row (its acc[D] and the tile's scores live in registers), the CTA's q tile
// sits in shared memory transposed so a warp reads it without bank
// conflicts, and each kv tile is staged once in shared memory as f32 and
// read by all threads as broadcasts.  Ragged sequence tails are handled by
// bounds checks: out-of-range keys are masked like causal ones, and rows
// past S are computed but never stored.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kBQ = 64;       // query rows per CTA = threads per CTA
constexpr int kBK = 32;       // keys per kv tile
constexpr int kQPad = kBQ + 1;
constexpr int kKPad = kBK + 4;  // keeps float4 rows 16-byte aligned
constexpr float kNegInf = -1e30f;

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

template <int D>
constexpr int smem_floats() {
  return D * kQPad + D * kKPad + kBK * D;
}

template <typename T, int D>
__global__ void __launch_bounds__(kBQ)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int H,
                 int Kv, int causal, float scale, float softcap) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // [D][kQPad]  q tile, transposed
  float* Kt = Qs + D * kQPad;       // [D][kKPad]  k tile, transposed
  float* Vs = Kt + D * kKPad;       // [kBK][D]    v tile

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / Kv);
  const int q0 = blockIdx.y * kBQ;
  const int row = threadIdx.x;
  const int qi = q0 + row;

  const long long q_row = (long long)H * D;    // stride between positions
  const long long kv_row = (long long)Kv * D;
  const T* qb = q + (long long)b * S * q_row + (long long)h * D;
  const T* kb = k + (long long)b * S * kv_row + (long long)kvh * D;
  const T* vb = v + (long long)b * S * kv_row + (long long)kvh * D;

  for (int idx = threadIdx.x; idx < kBQ * D; idx += kBQ) {
    const int r = idx / D, d = idx % D;
    Qs[d * kQPad + r] =
        q0 + r < S ? to_f32(qb[(long long)(q0 + r) * q_row + d]) : 0.f;
  }

  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = kNegInf, l = 0.f;

  const int q_last = min(q0 + kBQ, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;   // keys [0, kv_end) are live
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();   // the previous tile is consumed (and Q is stored)
    for (int idx = threadIdx.x; idx < kBK * D; idx += kBQ) {
      const int j = idx / D, d = idx % D;
      const int key = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (key < S) {
        kx = to_f32(kb[(long long)key * kv_row + d]);
        vx = to_f32(vb[(long long)key * kv_row + d]);
      }
      Kt[d * kKPad + j] = kx;
      Vs[j * D + d] = vx;
    }
    __syncthreads();

    float s[kBK];
#pragma unroll
    for (int j = 0; j < kBK; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = Qs[d * kQPad + row];
      const float4* kr = reinterpret_cast<const float4*>(Kt + d * kKPad);
#pragma unroll
      for (int jj = 0; jj < kBK / 4; ++jj) {
        const float4 kk = kr[jj];
        s[4 * jj + 0] = fmaf(qd, kk.x, s[4 * jj + 0]);
        s[4 * jj + 1] = fmaf(qd, kk.y, s[4 * jj + 1]);
        s[4 * jj + 2] = fmaf(qd, kk.z, s[4 * jj + 2]);
        s[4 * jj + 3] = fmaf(qd, kk.w, s[4 * jj + 3]);
      }
    }

    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float sv = s[j] * scale;
      if (softcap > 0.f) sv = tanhf(sv / softcap) * softcap;
      const int key = k0 + j;
      const bool live = key < S && (!causal || key <= qi);
      sv = live ? sv : kNegInf;
      s[j] = sv;
      tmax = fmaxf(tmax, sv);
    }
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = s[j];
      const float4* vr = reinterpret_cast<const float4*>(Vs + j * D);
#pragma unroll
      for (int dd = 0; dd < D / 4; ++dd) {
        const float4 vv = vr[dd];
        acc[4 * dd + 0] = fmaf(p, vv.x, acc[4 * dd + 0]);
        acc[4 * dd + 1] = fmaf(p, vv.y, acc[4 * dd + 1]);
        acc[4 * dd + 2] = fmaf(p, vv.z, acc[4 * dd + 2]);
        acc[4 * dd + 3] = fmaf(p, vv.w, acc[4 * dd + 3]);
      }
    }
  }

  if (qi < S) {
    const float den = fmaxf(l, 1e-30f);
    T* orow = o + ((long long)b * S + qi) * q_row + (long long)h * D;
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = from_f32<T>(acc[d] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int Kv, int causal, float scale, float softcap,
           cudaStream_t stream) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  flash_fwd_kernel<T, D><<<grid, kBQ, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, Kv, causal, scale,
      softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int B,
               int S, int H, int Kv, int D, int causal, float scale,
               float softcap, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, S, H, Kv, causal, scale, softcap,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, S, H, Kv, causal, scale, softcap,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, S, H, Kv, causal, scale, softcap,
                            stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D in {32, 64, 128}; H % Kv == 0.
// Returns the cudaError_t of the launch.
extern "C" int flash_attention_forward(const void* q, const void* k,
                                       const void* v, void* o, int B, int S,
                                       int H, int Kv, int D, int causal,
                                       float scale, float softcap, int dtype,
                                       void* stream) {
  if (B <= 0 || S <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, B, S, H, Kv, D, causal, scale,
                             softcap, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, B, S, H, Kv, D, causal,
                                     scale, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
