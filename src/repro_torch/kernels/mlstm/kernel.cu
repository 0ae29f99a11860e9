// Chunked mLSTM (xLSTM's matrix-memory cell) forward for Hopper (sm_90a),
// with a plain C entry point that ../binding.cpp wraps for PyTorch.
//
// Replaces the Pallas kernel src/repro/kernels/mlstm/kernel.py
// (mlstm_pallas / _mlstm_kernel).  Per (batch b, head h) and chunk of Q
// tokens, with b_t the inclusive cumsum of log sigmoid(f) over the chunk,
// a_s = i_s - b_s, rm_t = max(cummax(a)_t, m0), R = rm_Q and q scaled by
// 1/sqrt(D):
//     P[t, s] = (q_t . k_s) exp(a_s - rm_t)                    (s <= t)
//     h_t     = (sum_s P[t, s] v_s + exp(m0 - rm_t) C^T q_t)
//               / max(|sum_s P[t, s] + exp(m0 - rm_t) n . q_t|,
//                     exp(-(b_t + rm_t)))
//     C      <- exp(m0 - R) C + sum_s exp(a_s - R) k_s v_s^T
//     n      <- exp(m0 - R) n + sum_s exp(a_s - R) k_s
//     m0     <- b_Q + R
// from C = n = 0 and m0 = -1e30.  All arithmetic is f32; q, k and v are
// read in their dtype (f32 or bf16), the gates in f32; h is written in q's
// dtype and the final (C, n, m) in f32.
//
// Layout: q, k, v, h (B, S, H, D); gates (B, S, H); C (B, H, D, D);
// n (B, H, D); m (B, H); all contiguous (the model's own layout).
//
// Bound: at xlstm-125m's prefill (B 4, S 1024, H 4, D 384, Q 256, bf16)
// the kernel must move ~60 MB (q, k, v, h and the final C) and do
// ~13 GFLOP, so memory bounds it at the card's peaks.  This first version
// does the arithmetic as scalar f32 FMAs (no wgmma / TMA), so the CUDA
// cores bound it.
//
// Design.  The state C of one (b, h) is D x D f32, 576 KB at D = 384:
// more than a CTA's shared memory (the Pallas kernel keeps it whole in
// VMEM).  Its value columns are independent: C[:, j], the numerator
// column j and h[:, j] depend on v[:, j] alone.  So the grid is
// (B * H, D / JV) and each CTA owns JV value columns of C (48 at D = 384:
// 72 KB of shared memory, and 128 CTAs at the serving shape).  Each CTA
// recomputes what all columns share: the gate chain (b, a, rm, the floor
// exp(-m_t), R, m0), the scores P and their row sums, and n.  That chain
// depends only on the gates and the previous m0, so the CTAs never wait on
// one another; the CTA of the first column tile writes n and m.  The
// Pallas kernel's sequential chunk axis is a loop inside the CTA.
//
// The (Q, Q) matrix P is walked in 64 x 64 tiles of (t, s <= t), its inner
// dot products in 32-wide slices of D; the weight exp(a_s - rm_t) is
// evaluated only where s <= t and written as a select, not a product with
// a mask: above the diagonal the exponent is positive and may overflow, and
// inf * 0 would be NaN.  With m0 = -1e30, exp(m0 - rm_t) is exactly 0;
// exp(-m_t) may overflow to inf, and h is then 0, as in the reference.
// Any chunk up to 256 works: rows past the chunk are loaded as zeros and
// never stored.  The 256 threads form a 16 x 16 grid: each owns rows
// ty + 16 i of a tile and columns tx + 16 j; P and the key slices are
// padded by one float so a warp's column reads hit distinct banks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;   // a 16 x 16 grid of threads
constexpr int kTile = 64;       // rows of t, of s, and of d per tile
constexpr int kMaxChunk = 256;
constexpr int kPad = kTile + 1;
constexpr int kGates = 8;       // per-token gate arrays of the chunk

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

// value columns per CTA, key depth per slice, state rows per pass
template <int D> struct Tiling {
  static constexpr int kCols = D <= 32 ? D : (D % 48 == 0 ? 48 : 32);
  static constexpr int kDepth = D < 32 ? D : 32;
  static constexpr int kRows = D < kTile ? D : kTile;
  static_assert(kCols % 16 == 0 && D % kCols == 0, "column tiles");
  static_assert(D % kDepth == 0 && D % kRows == 0 && kRows % 16 == 0,
                "key slices and state rows");
};

template <int D>
constexpr int smem_floats() {
  return kGates * kMaxChunk                        // gate arrays
         + D * Tiling<D>::kCols + D                // C columns, n
         + 2 * kTile * (Tiling<D>::kDepth + 1)     // q and k slices
         + kTile * kPad                            // P (or a k tile)
         + kTile * Tiling<D>::kCols;               // v columns
}

// rows [0, kTile) of `cols` columns of src (row stride ld elements) into
// dst (row pitch `pitch` floats), zero past n_rows; each row r optionally
// times scale[r], or all times `mul`.
template <typename T, int cols>
__device__ __forceinline__ void load_tile(float* dst, int pitch,
                                          const T* src, long long ld,
                                          int n_rows, float mul = 1.f,
                                          const float* scale = nullptr) {
  for (int idx = threadIdx.x; idx < kTile * cols; idx += kThreads) {
    const int r = idx / cols, c = idx % cols;
    float x = 0.f;
    if (r < n_rows) {
      x = to_f32(src[(long long)r * ld + c]) * mul;
      if (scale) x *= scale[r];
    }
    dst[r * pitch + c] = x;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
mlstm_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ ig,
                 const float* __restrict__ fg, T* __restrict__ h,
                 float* __restrict__ C_out, float* __restrict__ n_out,
                 float* __restrict__ m_out, int S, int H, int Q,
                 float scale) {
  constexpr int JV = Tiling<D>::kCols, JJ = JV / 16;
  constexpr int DK = Tiling<D>::kDepth, DKP = DK + 1;
  constexpr int DR = Tiling<D>::kRows, SI = DR / 16;
  extern __shared__ __align__(16) float smem[];
  float* g_lf = smem;                    // log sigmoid(f)
  float* g_i = g_lf + kMaxChunk;         // i
  float* g_b = g_i + kMaxChunk;          // b_t
  float* g_a = g_b + kMaxChunk;          // a_t
  float* g_rm = g_a + kMaxChunk;         // rm_t
  float* g_fl = g_rm + kMaxChunk;        // exp(-m_t), the floor
  float* g_isc = g_fl + kMaxChunk;       // exp(m0 - rm_t)
  float* g_dec = g_isc + kMaxChunk;      // exp(a_s - R)
  float* Cs = smem + kGates * kMaxChunk; // [D][JV]  this CTA's columns of C
  float* ns = Cs + D * JV;               // [D]
  float* Qs = ns + D;                    // [kTile][DKP]
  float* Ks = Qs + kTile * DKP;          // [kTile][DKP]
  float* Ps = Ks + kTile * DKP;          // [kTile][kPad]
  float* Vs = Ps + kTile * kPad;         // [kTile][JV]

  const int bh = blockIdx.x, b = bh / H, hh = bh % H;
  const int j0 = blockIdx.y * JV;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long ld = (long long)H * D;     // stride between tokens
  const long long off = (long long)b * S * ld + (long long)hh * D;
  const T* qb = q + off;
  const T* kb = k + off;
  const T* vb = v + off + j0;
  T* hb = h + off + j0;
  const float* igb = ig + (long long)b * S * H + hh;
  const float* fgb = fg + (long long)b * S * H + hh;
  const float neg_inf = -__int_as_float(0x7f800000);

  for (int idx = threadIdx.x; idx < kGates * kMaxChunk + D * JV + D;
       idx += kThreads)
    smem[idx] = 0.f;
  float m0 = -1e30f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    // ---- the gate chain of the chunk ----
    if (threadIdx.x < Q) {
      const float f = fgb[(long long)(c0 + threadIdx.x) * H];
      g_lf[threadIdx.x] = fminf(f, 0.f) - log1pf(expf(-fabsf(f)));
      g_i[threadIdx.x] = igb[(long long)(c0 + threadIdx.x) * H];
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      // lane l scans tokens [lo, hi): cumsum b, then cummax of a
      const int lane = threadIdx.x, per = (Q + 31) / 32;
      const int lo = min(lane * per, Q), hi = min(lo + per, Q);
      float tot = 0.f;
      for (int t = lo; t < hi; ++t) tot += g_lf[t];
      float inc = tot;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += u;
      }
      float run = __shfl_up_sync(0xffffffffu, inc, 1);
      if (lane == 0) run = 0.f;
      float amax = neg_inf;
      for (int t = lo; t < hi; ++t) {
        run += g_lf[t];
        g_b[t] = run;
        const float a = g_i[t] - run;
        g_a[t] = a;
        amax = fmaxf(amax, a);
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, amax, o);
        if (lane >= o) amax = fmaxf(amax, u);
      }
      float cm = __shfl_up_sync(0xffffffffu, amax, 1);
      if (lane == 0) cm = neg_inf;
      for (int t = lo; t < hi; ++t) {
        cm = fmaxf(cm, g_a[t]);
        g_rm[t] = fmaxf(cm, m0);
      }
    }
    __syncthreads();
    const float R = g_rm[Q - 1], b_end = g_b[Q - 1];
    if (threadIdx.x < Q) {
      const int t = threadIdx.x;
      g_fl[t] = expf(-(g_b[t] + g_rm[t]));
      g_isc[t] = expf(m0 - g_rm[t]);
      g_dec[t] = expf(g_a[t] - R);
    }
    __syncthreads();

    // ---- outputs, one 64-row tile of t at a time ----
    for (int t0 = 0; t0 < Q; t0 += kTile) {
      const int tn = min(kTile, Q - t0);
      float num[4][JJ], den[4], qn[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        den[i] = qn[i] = 0.f;
#pragma unroll
        for (int j = 0; j < JJ; ++j) num[i][j] = 0.f;
      }
      for (int s0 = 0; s0 <= t0; s0 += kTile) {
        const int sn = min(kTile, Q - s0);
        float p[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) p[i][j] = 0.f;
        for (int d0 = 0; d0 < D; d0 += DK) {
          __syncthreads();      // the last slices, P and v consumed
          load_tile<T, DK>(Qs, DKP, qb + (long long)(c0 + t0) * ld + d0, ld,
                           tn, scale);
          load_tile<T, DK>(Ks, DKP, kb + (long long)(c0 + s0) * ld + d0, ld,
                           sn);
          __syncthreads();
          if (s0 == 0) {        // inter-chunk term, once per t tile
#pragma unroll 4
            for (int c = 0; c < DK; ++c) {
              float qv[4], cv[JJ];
              const float nv = ns[d0 + c];
#pragma unroll
              for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * DKP + c];
#pragma unroll
              for (int j = 0; j < JJ; ++j) cv[j] = Cs[(d0 + c) * JV + tx + 16 * j];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                qn[i] = fmaf(qv[i], nv, qn[i]);
#pragma unroll
                for (int j = 0; j < JJ; ++j)
                  num[i][j] = fmaf(qv[i], cv[j], num[i][j]);
              }
            }
          }
#pragma unroll 4
          for (int c = 0; c < DK; ++c) {
            float qv[4], kv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * DKP + c];
#pragma unroll
            for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DKP + c];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) p[i][j] = fmaf(qv[i], kv[j], p[i][j]);
          }
        }
        if (s0 == 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float sc = g_isc[t0 + ty + 16 * i];
            qn[i] *= sc;
#pragma unroll
            for (int j = 0; j < JJ; ++j) num[i][j] *= sc;
          }
        }
        // gate weights: a select where s > t
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = ty + 16 * i;
          const float rm = g_rm[t0 + t];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = tx + 16 * j;
            const bool live = t < tn && s0 + s <= t0 + t;
            const float w = live ? p[i][j] * expf(g_a[s0 + s] - rm) : 0.f;
            Ps[t * kPad + s] = w;
            den[i] += w;
          }
        }
        load_tile<T, JV>(Vs, JV, vb + (long long)(c0 + s0) * ld, ld, sn);
        __syncthreads();
        const int s_end = s0 < t0 ? kTile : tn;   // diagonal: s <= t < tn
        for (int s = 0; s < s_end; ++s) {
          float vv[JJ];
#pragma unroll
          for (int j = 0; j < JJ; ++j) vv[j] = Vs[s * JV + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pv = Ps[(ty + 16 * i) * kPad + s];
#pragma unroll
            for (int j = 0; j < JJ; ++j) num[i][j] = fmaf(pv, vv[j], num[i][j]);
          }
        }
      }
      // row sums of P across the 16 threads of a row group (a half warp)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          den[i] += __shfl_xor_sync(0xffffffffu, den[i], o);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t < tn) {
          const float denom = fmaxf(fabsf(den[i] + qn[i]), g_fl[t0 + t]);
          T* hr = hb + (long long)(c0 + t0 + t) * ld;
#pragma unroll
          for (int j = 0; j < JJ; ++j)
            hr[tx + 16 * j] = from_f32<T>(num[i][j] / denom);
        }
      }
    }

    // ---- state update, DR rows of C (and of n) at a time ----
    const float decay = expf(m0 - R);
    for (int d0 = 0; d0 < D; d0 += DR) {
      float acc[SI][JJ];
      float nacc = 0.f;
#pragma unroll
      for (int i = 0; i < SI; ++i)
#pragma unroll
        for (int j = 0; j < JJ; ++j) acc[i][j] = 0.f;
      for (int s0 = 0; s0 < Q; s0 += kTile) {
        const int sn = min(kTile, Q - s0);
        __syncthreads();        // P, v and the k tile consumed
        // k_s exp(a_s - R) into Ps as [s][d]
        load_tile<T, DR>(Ps, kPad, kb + (long long)(c0 + s0) * ld + d0, ld,
                         sn, 1.f, g_dec + s0);
        load_tile<T, JV>(Vs, JV, vb + (long long)(c0 + s0) * ld, ld, sn);
        __syncthreads();
        for (int s = 0; s < sn; ++s) {
          float kv[SI], vv[JJ];
#pragma unroll
          for (int i = 0; i < SI; ++i) kv[i] = Ps[s * kPad + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < JJ; ++j) vv[j] = Vs[s * JV + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < SI; ++i)
#pragma unroll
            for (int j = 0; j < JJ; ++j) acc[i][j] = fmaf(kv[i], vv[j],
                                                          acc[i][j]);
        }
        if (threadIdx.x < DR)
          for (int s = 0; s < sn; ++s) nacc += Ps[s * kPad + threadIdx.x];
      }
#pragma unroll
      for (int i = 0; i < SI; ++i)
#pragma unroll
        for (int j = 0; j < JJ; ++j) {
          float* cp = Cs + (d0 + ty + 16 * i) * JV + tx + 16 * j;
          *cp = fmaf(*cp, decay, acc[i][j]);
        }
      if (threadIdx.x < DR)
        ns[d0 + threadIdx.x] = fmaf(ns[d0 + threadIdx.x], decay, nacc);
    }
    m0 = b_end + R;
    __syncthreads();            // C, n updated; the gate arrays are free
  }

  float* co = C_out + (long long)bh * D * D + j0;
  for (int idx = threadIdx.x; idx < D * JV; idx += kThreads)
    co[(long long)(idx / JV) * D + idx % JV] = Cs[idx];
  if (blockIdx.y == 0) {
    for (int idx = threadIdx.x; idx < D; idx += kThreads)
      n_out[(long long)bh * D + idx] = ns[idx];
    if (threadIdx.x == 0) m_out[bh] = m0;
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const float* ig,
           const float* fg, void* h, float* C, float* n, float* m, int B,
           int S, int H, int Q, float scale, cudaStream_t stream) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, D / Tiling<D>::kCols);
  mlstm_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), ig, fg, static_cast<T*>(h), C, n, m, S, H,
      Q, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const float* ig,
               const float* fg, void* h, float* C, float* n, float* m, int B,
               int S, int H, int D, int Q, float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, ig, fg, h, C, n, m, B, S, H, Q, scale,
                           stream);
    case 32:
      return launch<T, 32>(q, k, v, ig, fg, h, C, n, m, B, S, H, Q, scale,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, ig, fg, h, C, n, m, B, S, H, Q, scale,
                           stream);
    case 384:
      return launch<T, 384>(q, k, v, ig, fg, h, C, n, m, B, S, H, Q, scale,
                            stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype (of q, k, v and h): 0 = float32, 1 = bfloat16; the gates are f32.
// D in {16, 32, 64, 384}; 0 < Q <= 256; S % Q == 0; scale = 1/sqrt(D).
// Returns the cudaError_t of the launch.
extern "C" int mlstm_forward(const void* q, const void* k, const void* v,
                             const float* i_raw, const float* f_raw,
                             void* h, float* C, float* n, float* m, int B,
                             int S, int H, int D, int Q, float scale,
                             int dtype, void* stream) {
  if (Q <= 0 || Q > kMaxChunk || S % Q)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, i_raw, f_raw, h, C, n, m, B, S, H, D,
                             Q, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, i_raw, f_raw, h, C, n, m, B,
                                     S, H, D, Q, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
