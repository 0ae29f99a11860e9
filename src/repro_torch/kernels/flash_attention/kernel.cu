// Causal / non-causal GQA flash attention forward for Hopper (sm_90a), with a
// plain C entry point that ../binding.cpp wraps for PyTorch.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_bhsd, line 78, whose body is _attn_kernel, line 26):
// online softmax with m, l and acc in f32, scores scaled by 1/sqrt(D),
// optional tanh softcap applied before the mask, masked scores set to -1e30
// (not -inf), kv tiles past the diagonal skipped when causal, output
// acc / max(l, 1e-30) in q's dtype.
//
// Layout: q (B, S, H, D), k/v (B, S, Kv, D), out (B, S, H, D), all
// contiguous -- the model's own layout, so no transpose is needed around the
// call.  Query head h of batch b reads kv head h / G (G = H / Kv), i.e. kv
// row (b*H + h) / G = b*Kv + h/G of the Pallas kernel's (B*Kv, S, D) view;
// repeated KV is never materialised.
//
// Bound: at the serving path's shapes (S = 1024, D = 64) the work is
// ~4*D flops per (query, key) pair against ~4*D bytes per query row, so the
// tensor-core rate bounds it, not memory.
//
// Two kernels behind one entry point, chosen by dtype:
//
// f32 (dtype 0): scalar f32 FMAs on the CUDA cores, held to the JAX
// package's f32 bound of 2e-5 (tests/test_kernels.py::_tol), which
// tensor-core arithmetic (bf16 or TF32 products) cannot meet.  One thread
// owns one query row (its acc[D] and the tile's scores live in registers),
// the CTA's q tile sits in shared memory transposed so a warp reads it
// without bank conflicts, and each kv tile is staged once in shared memory
// as f32 and read by all threads as broadcasts.  Ragged sequence tails are
// handled by bounds checks: out-of-range keys are masked like causal ones,
// and rows past S are computed but never stored.
//
// bf16 (dtype 1, the serving paths): FlashAttention-2's design on the
// tensor cores, bf16 mma.sync m16n8k16 with f32 accumulation
// (../common/mma.cuh).  One CTA of 8 warps per (b, h, 128-row q tile), the
// q tiles launched heaviest (last) first so the causal tail does not leave
// SMs idle; each warp owns 16 query rows, whose Q fragments it loads once
// into registers with ldmatrix.  Tiles of 64 keys of K and V are
// double-buffered in shared memory with cp.async (zero-filled past S).  Per
// tile a warp computes its 16 x 64 scores S = Q K^T into f32 fragments,
// scales, soft-caps and masks them, and updates the online softmax in
// registers (the row max across the 4 lanes that share a row, the row sum
// kept per lane and reduced once at the end).  P is rounded to bf16 in
// registers and used as the A fragment of P.V directly (the m16n8
// accumulator layout is the m16n8k16 A layout), with V read by
// ldmatrix.trans; O stays in f32 registers.  That rounding of P is the one
// the f32 reference does not make: about 2^-9 relative per weight, inside
// bf16's 2e-2 (tests/test_torch_tc_numerics.py).  The exponentials are the
// SFU's ex2.approx.  Masks are evaluated only on tiles that cross the
// diagonal or S; a warp skips the tiles wholly above its rows.  The output
// goes through shared memory to 16-byte stores; rows past S are never
// stored.  With two CTAs of 8 warps per SM at D <= 64, each warp's mma.sync
// and its softmax arithmetic share the schedulers' dispatch slots; the
// next step, where this kernel trails its yardstick, is wgmma
// (asynchronous, one instruction per 64-row tile) with TMA loads.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma.cuh"

namespace {

constexpr int kBQ = 64;       // query rows per CTA = threads per CTA
constexpr int kBK = 32;       // keys per kv tile
constexpr int kQPad = kBQ + 1;
constexpr int kKPad = kBK + 4;  // keeps float4 rows 16-byte aligned
constexpr float kNegInf = -1e30f;

template <int D>
constexpr int smem_floats() {
  return D * kQPad + D * kKPad + kBK * D;
}

template <int D>
__global__ void __launch_bounds__(kBQ)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int H, int Kv, int causal, float scale, float softcap) {
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
  const float* qb = q + (long long)b * S * q_row + (long long)h * D;
  const float* kb = k + (long long)b * S * kv_row + (long long)kvh * D;
  const float* vb = v + (long long)b * S * kv_row + (long long)kvh * D;

  for (int idx = threadIdx.x; idx < kBQ * D; idx += kBQ) {
    const int r = idx / D, d = idx % D;
    Qs[d * kQPad + r] =
        q0 + r < S ? qb[(long long)(q0 + r) * q_row + d] : 0.f;
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
        kx = kb[(long long)key * kv_row + d];
        vx = vb[(long long)key * kv_row + d];
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
    float* orow = o + ((long long)b * S + qi) * q_row + (long long)h * D;
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = acc[d] / den;
  }
}

// ------------------------------------------------ bf16, tensor cores

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 8;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcBQ = 16 * kTcWarps;   // query rows per CTA, 16 per warp
constexpr int kTcBK = 64;              // keys per kv tile
constexpr float kLog2e = 1.4426950408889634f;

// Q tile, then two stages of K and two of V, rows of D + 8 bf16
template <int D>
constexpr int tc_smem_bytes() {
  return (kTcBQ + 4 * kTcBK) * (D + 8) * (int)sizeof(bf16);
}

// rows [r0, r0 + ROWS) of a (., D) matrix with row stride ld into a tile
// of pitch D + 8, by cp.async; rows at or past `limit` are zero-filled
template <int D, int ROWS>
__device__ __forceinline__ void tc_load_rows(bf16* dst, const bf16* src,
                                             long long ld, int r0,
                                             int limit) {
  constexpr int kChunks = D / 8;   // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kTcThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r0 + r < limit;
    tc::cp_async16(dst + r * (D + 8) + c * 8,
                   src + (long long)(ok ? r0 + r : 0) * ld + c * 8, ok);
  }
}

// kCap: a tanh softcap is applied (a separate instantiation, so the
// uncapped path carries no tanh code)
template <int D, bool kCap>
__global__ void __launch_bounds__(kTcThreads, D <= 64 ? 2 : 1)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, int S,
                    int H, int Kv, int causal, float scale, float softcap) {
  constexpr int P = D + 8;      // shared-memory pitch, in bf16
  constexpr int KD = D / 16;    // k16 steps of Q K^T
  constexpr int ND = D / 8;     // n8 tiles of O
  constexpr int NK = kTcBK / 8; // n8 tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [kTcBQ][P]
  bf16* Ks = Qs + kTcBQ * P;                       // [2][kTcBK][P]
  bf16* Vs = Ks + 2 * kTcBK * P;                   // [2][kTcBK][P]

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / Kv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcBQ;  // heaviest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;

  const long long q_ld = (long long)H * D;
  const long long kv_ld = (long long)Kv * D;
  const bf16* qb = q + (long long)b * S * q_ld + (long long)h * D;
  const bf16* kb = k + (long long)b * S * kv_ld + (long long)kvh * D;
  const bf16* vb = v + (long long)b * S * kv_ld + (long long)kvh * D;

  const int q_last = min(q0 + kTcBQ, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;      // keys [0, kv_end)
  const int n_tiles = (kv_end + kTcBK - 1) / kTcBK;
  const int w_first = q0 + warp * 16;              // this warp's rows
  const int row0 = w_first + g;                    // this lane's: row0, +8

  tc_load_rows<D, kTcBQ>(Qs, qb, q_ld, q0, S);
  tc_load_rows<D, kTcBK>(Ks, kb, kv_ld, 0, S);
  tc_load_rows<D, kTcBK>(Vs, vb, kv_ld, 0, S);
  tc::cp_async_commit();

  uint32_t qf[KD][4];
  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};    // this lane's share of the row sums

  for (int j = 0; j < n_tiles; ++j) {
    tc::cp_async_wait<0>();
    __syncthreads();   // tile j has landed; stage (j + 1) & 1 is consumed
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        tc::ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * P +
                                    kk * 16 + (lane >> 4) * 8);
    }
    if (j + 1 < n_tiles) {
      const int st = (j + 1) & 1;
      tc_load_rows<D, kTcBK>(Ks + st * kTcBK * P, kb, kv_ld,
                             (j + 1) * kTcBK, S);
      tc_load_rows<D, kTcBK>(Vs + st * kTcBK * P, vb, kv_ld,
                             (j + 1) * kTcBK, S);
      tc::cp_async_commit();
    }
    const int k0 = j * kTcBK;
    if (causal && k0 > w_first + 15) continue;    // wholly above the rows
    const bf16* Kt = Ks + (j & 1) * kTcBK * P;
    const bf16* Vt = Vs + (j & 1) * kTcBK * P;

    // S = Q K^T: key n8 tiles in pairs, one ldmatrix x4 per pair
    float s[NK][4];
#pragma unroll
    for (int i = 0; i < NK; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {
        uint32_t kf[4];
        tc::ldmatrix_x4(kf, Kt + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * P
                                + kk * 16 + ((lane >> 3) & 1) * 8);
        tc::mma_bf16(s[2 * np], qf[kk], kf[0], kf[1]);
        tc::mma_bf16(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // scale, soft-cap, mask; the row max over the 4 lanes of each row
    const bool masked = k0 + kTcBK > S ||
                        (causal && k0 + kTcBK - 1 > w_first);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < NK; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[i][e] * scale;
        if (kCap) x = tanhf(x / softcap) * softcap;
        if (masked) {
          const int key = k0 + i * 8 + 2 * c + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          const bool live = key < S && (!causal || key <= row);
          x = live ? x : kNegInf;
        }
        s[i][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2], mb[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = tc::exp2_approx((m[r] - m_new) * kLog2e);
      m[r] = m_new;
      mb[r] = m_new * kLog2e;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < NK; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            tc::exp2_approx(fmaf(s[i][e], kLog2e, -mb[e >> 1]));
        s[i][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      acc[i][0] *= corr[0];
      acc[i][1] *= corr[0];
      acc[i][2] *= corr[1];
      acc[i][3] *= corr[1];
    }

    // O += P V: P in bf16 straight from the score fragments
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      uint32_t pa[4];
      tc::acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t vf[4];
        tc::ldmatrix_x4_trans(vf, Vt + (kk * 16 + (lane & 15)) * P +
                                      dp * 16 + (lane >> 4) * 8);
        tc::mma_bf16(acc[2 * dp], pa, vf[0], vf[1]);
        tc::mma_bf16(acc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
  }

  // O / l, through this warp's own rows of the Q tile, to 16-byte stores
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  bf16* Ow = Qs + warp * 16 * P;
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    *reinterpret_cast<uint32_t*>(Ow + g * P + i * 8 + 2 * c) =
        tc::pack_bf16(acc[i][0] * inv[0], acc[i][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(Ow + (g + 8) * P + i * 8 + 2 * c) =
        tc::pack_bf16(acc[i][2] * inv[1], acc[i][3] * inv[1]);
  }
  __syncwarp();
  bf16* ob = o + (long long)b * S * q_ld + (long long)h * D;
  for (int i = lane; i < 16 * (D / 8); i += 32) {
    const int r = i / (D / 8), cc = i % (D / 8);
    if (w_first + r < S)
      *reinterpret_cast<uint4*>(ob + (long long)(w_first + r) * q_ld +
                                cc * 8) =
          *reinterpret_cast<const uint4*>(Ow + r * P + cc * 8);
  }
}

template <int D, bool kCap>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B,
              int S, int H, int Kv, int causal, float scale, float softcap,
              cudaStream_t stream) {
  const int smem = tc_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<D, kCap>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * H, (S + kTcBQ - 1) / kTcBQ);
  flash_fwd_tc_kernel<D, kCap><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), S, H, Kv, causal,
      scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ dispatch

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int Kv, int causal, float scale, float softcap,
           cudaStream_t stream) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  flash_fwd_kernel<D><<<grid, kBQ, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, Kv, causal,
      scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

// dtype 0 (f32) takes the scalar kernel, dtype 1 (bf16) the tensor-core one
template <int D>
int launch_dtype(const void* q, const void* k, const void* v, void* o,
                 int B, int S, int H, int Kv, int causal, float scale,
                 float softcap, int dtype, cudaStream_t stream) {
  if (dtype == 0)
    return launch<D>(q, k, v, o, B, S, H, Kv, causal, scale, softcap,
                     stream);
  if (dtype == 1)
    return softcap > 0.f
               ? launch_tc<D, true>(q, k, v, o, B, S, H, Kv, causal, scale,
                                    softcap, stream)
               : launch_tc<D, false>(q, k, v, o, B, S, H, Kv, causal, scale,
                                     softcap, stream);
  return static_cast<int>(cudaErrorInvalidValue);
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
  switch (D) {
    case 32:
      return launch_dtype<32>(q, k, v, o, B, S, H, Kv, causal, scale,
                              softcap, dtype, s);
    case 64:
      return launch_dtype<64>(q, k, v, o, B, S, H, Kv, causal, scale,
                              softcap, dtype, s);
    case 128:
      return launch_dtype<128>(q, k, v, o, B, S, H, Kv, causal, scale,
                               softcap, dtype, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
