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
// from C = n = 0 and m0 = -1e30.  q, k, v are read in their dtype (f32 or
// bf16), the gates in f32; h is written in q's dtype and the final
// (C, n, m) in f32.
//
// Layout: q, k, v, h (B, S, H, D); gates (B, S, H); C (B, H, D, D);
// n (B, H, D); m (B, H); all contiguous (the model's own layout).
//
// Bound: at xlstm-125m's prefill (B 4, S 1024, H 4, D 384, Q 256, bf16)
// the kernel must move ~60 MB (q, k, v, h and the final C) and do
// ~13 GFLOP (q.k^T and P.v over the causal pairs, q.C and the k^T v state
// update), so memory bounds it at the card's peaks (0.018 ms).
//
// Two designs behind one entry point, chosen by dtype:
//
// f32 (dtype 0): scalar f32 FMAs on the CUDA cores, held to the JAX
// package's f32 bound on h (5e-3: tests/test_kernels.py::
// test_mlstm_kernel_sweep), beyond bf16 products.  The state C of one
// (b, h) is D x D f32, 576 KB at D = 384: more than a CTA's shared memory
// (the Pallas kernel keeps it whole in VMEM).  Its value columns are
// independent: C[:, j], the numerator column j and h[:, j] depend on
// v[:, j] alone.  So the grid is (B * H, D / JV) and each CTA owns JV value
// columns of C (48 at D = 384: 72 KB of shared memory).  Each CTA
// recomputes what all columns share: the gate chain, the scores P and
// their row sums, and n; the CTA of the first column tile writes n and m.
// The Pallas kernel's sequential chunk axis is a loop inside the CTA.
// The (Q, Q) matrix P is walked in 64 x 64 tiles of (t, s <= t), its inner
// dot products in 32-wide slices of D.  The 256 threads form a 16 x 16
// grid: each owns rows ty + 16 i of a tile and columns tx + 16 j; P and the
// key slices are padded by one float so a warp's column reads hit distinct
// banks.
//
// bf16 (dtype 1, the serving path): the chunkwise-parallel form of linear
// attention on the tensor cores (bf16 mma.sync m16n8k16, f32 accumulators,
// ../common/mma.cuh), in three device kernels on the caller's stream and a
// scratch buffer the wrapper allocates (mlstm_scratch_bytes):
//   1. gates  -- one CTA per (b, h): the gate chain in f32 and in the f32
//      kernel's order (log sigmoid f, the cumsum b, a = i - b, the running
//      max of a) for all chunks at once, then m0 and R = rm_Q chunk by
//      chunk, then per token rm = max(cummax a, m0), b + rm and the key
//      weight exp(a - R), and per chunk the decay exp(m0 - R); the final m.
//   2. states -- grid (b, h, 64 x 64 tile of C): 36 CTAs per (b, h) at
//      D = 384, 576 in all at the serving shape.  Each walks the chunks in
//      order with its tile of C (and of n) in f32 registers: it stores the
//      state entering each chunk c >= 1 in the scratch, then
//      C <- exp(m0 - R) C + (k o exp(a - R))^T v, 64 tokens a step.
//   3. outputs -- grid (b, h, chunk, 64-row tile of t, 128-column tile of
//      v), 768 CTAs at the serving shape: each chunk's outputs depend only
//      on its entering state, so all chunks run at once.  Each CTA holds
//      its q tile in shared memory, adds the inter-chunk term
//      exp(m0 - rm_t) q.C_c, then for each s tile <= its t tile forms the
//      scores q.k^T, the weights exp(a_s - rm_t) by a select where s <= t
//      (never a product with a mask: above the diagonal the exponent is
//      positive and may overflow, and inf * 0 is NaN), their f32 row sums,
//      and P.v; h = num / max(|den + exp(m0 - rm_t) q.n|, exp(-(b_t +
//      rm_t))).  The scores of a (b, h, chunk) are computed once per
//      column tile: 3 times at D = 384, where the f32 kernel computes them
//      8 times.  Its tiles stream through a ring of three shared-memory
//      slots, copied two tiles ahead of the one computed.
// The products of bf16 inputs (q.k^T) are exact.  Each f32 operand of a
// product goes in as a bf16 pair hi + lo, hi = bf16(x), lo = bf16(x - hi),
// one mma each (all hi products issued before the lo ones): the state C_c
// of q.C (stored as a pair by the state kernel), the weighted scores P of
// P.v (split straight from the score accumulators) and the scaled keys
// k o exp(a - R) of the state update (scaled and split in registers from
// an ldmatrix.trans of k).  Rounded once to bf16, each of the three puts an
// output outside its bound (h 2e-2, C 1e-3): the CPU emulation in
// tests/test_torch_tc_numerics.py (test_mlstm_single_rounding_misses)
// shows it, and the pairs pass (test_mlstm_bf16_rounding_within_tolerance).
// The design's own traffic above the bound is the scratch: the states
// entering chunks 1..nc-1, 16 x 3 x 576 KB = 28 MB at the serving shape,
// written once and read once, mostly from the 50 MB L2.  Tiles are rows of
// bf16 with a pitch of width + 8 elements (an odd multiple of 16 bytes, so
// ldmatrix reads without bank conflicts: D + 8 = 392 is 784 bytes); rows
// past the chunk are zero-filled by cp.async and never stored.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kThreads = 256;   // a 16 x 16 grid of threads
constexpr int kTile = 64;       // rows of t, of s, and of d per tile
constexpr int kMaxChunk = 256;
constexpr int kPad = kTile + 1;
constexpr int kGates = 8;       // per-token gate arrays of the chunk

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
template <int cols>
__device__ __forceinline__ void load_tile(float* dst, int pitch,
                                          const float* src, long long ld,
                                          int n_rows, float mul = 1.f,
                                          const float* scale = nullptr) {
  for (int idx = threadIdx.x; idx < kTile * cols; idx += kThreads) {
    const int r = idx / cols, c = idx % cols;
    float x = 0.f;
    if (r < n_rows) {
      x = src[(long long)r * ld + c] * mul;
      if (scale) x *= scale[r];
    }
    dst[r * pitch + c] = x;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
mlstm_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ ig,
                 const float* __restrict__ fg, float* __restrict__ h,
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
  const float* qb = q + off;
  const float* kb = k + off;
  const float* vb = v + off + j0;
  float* hb = h + off + j0;
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
          load_tile<DK>(Qs, DKP, qb + (long long)(c0 + t0) * ld + d0, ld,
                           tn, scale);
          load_tile<DK>(Ks, DKP, kb + (long long)(c0 + s0) * ld + d0, ld,
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
        load_tile<JV>(Vs, JV, vb + (long long)(c0 + s0) * ld, ld, sn);
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
          float* hr = hb + (long long)(c0 + t0 + t) * ld;
#pragma unroll
          for (int j = 0; j < JJ; ++j)
            hr[tx + 16 * j] = num[i][j] / denom;
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
        load_tile<DR>(Ps, kPad, kb + (long long)(c0 + s0) * ld + d0, ld,
                         sn, 1.f, g_dec + s0);
        load_tile<JV>(Vs, JV, vb + (long long)(c0 + s0) * ld, ld, sn);
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

template <int D>
int launch(const void* q, const void* k, const void* v, const float* ig,
           const float* fg, void* h, float* C, float* n, float* m, int B,
           int S, int H, int Q, float scale, cudaStream_t stream) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, D / Tiling<D>::kCols);
  mlstm_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), ig, fg, static_cast<float*>(h), C, n, m,
      S, H, Q, scale);
  return static_cast<int>(cudaGetLastError());
}


// ------------------------------------------------ bf16, tensor cores

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kGateWarps = 8;
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr long long align256(long long x) {
  return (x + 255) & ~255LL;
}

// Byte offsets into the scratch of the bf16 path, each part 256-aligned.
// Per (b, h): the gate arrays a, rm and mt = b + rm (f32 [S] each); m0
// entering each chunk and after the last (f32 [nc + 1]); the decay
// exp(m0 - R) of each chunk (f32 [nc]); the key weights exp(a - R) (f32
// [nc][P], P the chunk rounded up to 64 tokens, zero past it); the states
// entering chunks 1..nc-1 as bf16 pairs (hi, lo [nc - 1][D][D]) and their
// n (f32 [nc - 1][D]).
struct ScratchLayout {
  long long a, rm, mt, m0, dec, wk, chi, clo, n, bytes;
  ScratchLayout(long long BH, long long S, long long D, long long nc) {
    const long long ns = nc - 1, P = (S / nc + 63) / 64 * 64;
    a = 0;
    rm = a + align256(4 * BH * S);
    mt = rm + align256(4 * BH * S);
    m0 = mt + align256(4 * BH * S);
    dec = m0 + align256(4 * BH * (nc + 1));
    wk = dec + align256(4 * BH * nc);
    chi = wk + align256(4 * BH * nc * P);
    clo = chi + align256(2 * BH * ns * D * D);
    n = clo + align256(2 * BH * ns * D * D);
    bytes = n + align256(4 * BH * ns * D);
  }
};

// rows [0, n_rows) of `cols` bf16 columns of src (row stride ld elements)
// into dst (pitch `pitch`), by cp.async; rows at or past `valid` are
// zero-filled
__device__ __forceinline__ void tc_load_rows(bf16* dst, int pitch,
                                             const bf16* src, long long ld,
                                             int cols, int n_rows,
                                             int valid) {
  const int chunks = cols / 8;   // 16-byte chunks per row
  for (int i = threadIdx.x; i < n_rows * chunks; i += kTcThreads) {
    const int r = i / chunks, c = i % chunks;
    const bool ok = r < valid;
    tc::cp_async16(dst + r * pitch + c * 8,
                   src + (long long)(ok ? r : 0) * ld + c * 8, ok);
  }
}

// x0, x1 as the bf16 pair hi + lo of one fragment register (two columns)
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tc::pack_bf16(x0, x1);
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi);
  lo = tc::pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// ---- 1. the gate chain, one CTA of kGateWarps warps per (b, h).  Only m0
// links the chunks, and only through rm = max(cummax a, m0), so (1) warps
// take the chunks in parallel: lane l scans tokens [lo, hi), the cumsum b
// and then the running max of a across lanes by shuffles (the f32
// kernel's order); (2) one thread walks the chunks for m0 and R; (3) all
// threads finish each token: rm, b + rm and the key weight exp(a - R).
// Shared memory: 4 floats per chunk.
__global__ void __launch_bounds__(32 * kGateWarps)
mlstm_gates_kernel(const float* __restrict__ ig, const float* __restrict__ fg,
                   float* __restrict__ a_g, float* __restrict__ rm_g,
                   float* __restrict__ mt_g, float* __restrict__ m0_g,
                   float* __restrict__ dec_g, float* __restrict__ wk_g,
                   float* __restrict__ m_out, int S, int H, int Q) {
  constexpr int kPer = kMaxChunk / 32;
  extern __shared__ float gsm[];
  const int nc = S / Q;
  float* s_bend = gsm;              // b at the chunk's last token
  float* s_amax = gsm + nc;         // max of a over the chunk
  float* s_m0 = gsm + 2 * nc;       // m0 entering the chunk
  float* s_R = gsm + 3 * nc;        // R = rm at its last token
  const int bh = blockIdx.x, b = bh / H, hh = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per = (Q + 31) / 32;
  const int lo = min(lane * per, Q), hi = min(lo + per, Q);
  const int last = (Q - 1) / per;       // the lane of the chunk's last token
  const float* igb = ig + (long long)b * S * H + hh;
  const float* fgb = fg + (long long)b * S * H + hh;
  float* ab = a_g + (long long)bh * S;
  float* rmb = rm_g + (long long)bh * S;
  float* mtb = mt_g + (long long)bh * S;
  const float neg_inf = -__int_as_float(0x7f800000);

  for (int c = warp; c < nc; c += kGateWarps) {
    const int c0 = c * Q;
    float lf[kPer], iv[kPer];
    float tot = 0.f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      lf[j] = iv[j] = 0.f;
      if (lo + j < hi) {
        const float f = fgb[(long long)(c0 + lo + j) * H];
        lf[j] = fminf(f, 0.f) - log1pf(expf(-fabsf(f)));
        iv[j] = igb[(long long)(c0 + lo + j) * H];
        tot += lf[j];
      }
    }
    float inc = tot;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += u;
    }
    float run = __shfl_up_sync(0xffffffffu, inc, 1);
    if (lane == 0) run = 0.f;
    float amax = neg_inf, bv[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      bv[j] = 0.f;
      if (lo + j < hi) {
        run += lf[j];
        bv[j] = run;
        iv[j] -= run;                   // a
        amax = fmaxf(amax, iv[j]);
      }
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, amax, o);
      if (lane >= o) amax = fmaxf(amax, u);
    }
    float cm = __shfl_up_sync(0xffffffffu, amax, 1);
    if (lane == 0) cm = neg_inf;
    float b_last = 0.f, cm_last = 0.f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (lo + j < hi) {
        cm = fmaxf(cm, iv[j]);
        ab[c0 + lo + j] = iv[j];
        rmb[c0 + lo + j] = cm;          // cummax a, until m0 is known
        mtb[c0 + lo + j] = bv[j];       // b, until rm is known
        b_last = bv[j];
        cm_last = cm;
      }
    }
    const float b_end = __shfl_sync(0xffffffffu, b_last, last);
    const float a_end = __shfl_sync(0xffffffffu, cm_last, last);
    if (lane == 0) {
      s_bend[c] = b_end;
      s_amax[c] = a_end;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float* m0b = m0_g + (long long)bh * (nc + 1);
    float m0 = -1e30f;
    for (int c = 0; c < nc; ++c) {
      const float R = fmaxf(s_amax[c], m0);
      s_m0[c] = m0;
      s_R[c] = R;
      m0b[c] = m0;
      dec_g[(long long)bh * nc + c] = expf(m0 - R);
      m0 = s_bend[c] + R;
    }
    m0b[nc] = m0;
    m_out[bh] = m0;
  }
  __syncthreads();
  const int P = (Q + 63) / 64 * 64;
  float* wkb = wk_g + (long long)bh * nc * P;
  for (int i = threadIdx.x; i < nc * P; i += 32 * kGateWarps) {
    const int c = i / P, t = i % P;
    float w = 0.f;
    if (t < Q) {
      const int s = c * Q + t;
      const float rm = fmaxf(rmb[s], s_m0[c]);
      rmb[s] = rm;
      mtb[s] += rm;
      w = expf(ab[s] - s_R[c]);
    }
    wkb[i] = w;
  }
}

// ---- 2. the states.  A CTA owns a T x T tile of C (rows d, columns e of
// v), T = min(D, 64); warp w owns rows 16 w.. of it (the warps past the
// tile only load).  Per chunk: store the entering state (c >= 1) as a bf16
// pair and its n; decay it by exp(m0 - R); then per 64-row step of s,
// C += (k o w)^T v with w_s = exp(a_s - R), the A operand k^T by
// ldmatrix.trans, scaled and split into a pair in registers.  The k, v and
// w tiles of the next step are copied in by cp.async while this one
// computes (two stages, 37 KB at T = 64: every CTA of the serving shape
// resident at once).
template <int D>
struct StateTiling {
  static constexpr int T = D < 64 ? D : 64;
  static constexpr int TP = T + 8;
  static constexpr int KT = D / T;                   // tiles per side of C
  static constexpr int tile_bytes = 64 * TP * 2;
  static constexpr int stage_bytes = 2 * tile_bytes + 4 * 64;   // k, v, w
  static constexpr int bytes = 2 * stage_bytes;
};

template <int D>
__global__ void __launch_bounds__(kTcThreads)
mlstm_state_tc_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                      const float* __restrict__ wk_g,
                      const float* __restrict__ dec_g, bf16* __restrict__ chi,
                      bf16* __restrict__ clo, float* __restrict__ n_g,
                      float* __restrict__ C_out, float* __restrict__ n_out,
                      int S, int H, int Q) {
  using L = StateTiling<D>;
  constexpr int T = L::T, TP = L::TP, KT = L::KT, NT = T / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int bh = blockIdx.x / (KT * KT), tile = blockIdx.x % (KT * KT);
  const int d0 = (tile / KT) * T, e0 = (tile % KT) * T;
  const int b = bh / H, hh = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, c = lane & 3;
  const bool owner = warp * 16 < T;
  const int nc = S / Q, n_s = (Q + 63) / 64, n_steps = nc * n_s;
  const long long ld = (long long)H * D;
  const bf16* kb = k + (long long)b * S * ld + (long long)hh * D + d0;
  const bf16* vb = v + (long long)b * S * ld + (long long)hh * D + e0;
  const float* wkb = wk_g + (long long)bh * nc * n_s * 64;
  const float* decb = dec_g + (long long)bh * nc;
  const int r0 = d0 + warp * 16 + gr;    // this lane's rows r0, r0 + 8

  // step = (chunk, 64-row tile of s); the key weights of step are at
  // wkb[64 step..]
  auto prefetch = [&](int step) {
    unsigned char* st = smem_raw + (step & 1) * L::stage_bytes;
    const int ci = step / n_s, si = step % n_s;
    const long long s0 = (long long)ci * Q + si * 64;
    const int valid = min(64, Q - si * 64);
    tc_load_rows(reinterpret_cast<bf16*>(st), TP, kb + s0 * ld, ld, T, 64,
                 valid);
    tc_load_rows(reinterpret_cast<bf16*>(st + L::tile_bytes), TP,
                 vb + s0 * ld, ld, T, 64, valid);
    if (threadIdx.x < 16)
      tc::cp_async16(st + 2 * L::tile_bytes + threadIdx.x * 16,
                     wkb + (long long)step * 64 + threadIdx.x * 4, true);
    tc::cp_async_commit();
  };

  float st[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[j][e] = 0.f;
  float nst[2] = {0.f, 0.f}, nacc[2] = {0.f, 0.f};
  float dec_next = decb[0];

  prefetch(0);
  for (int g = 0; g < n_steps; ++g) {
    const int ci = g / n_s, si = g % n_s;
    tc::cp_async_wait<0>();
    __syncthreads();     // this step's tiles landed; the other stage consumed
    if (g + 1 < n_steps) prefetch(g + 1);
    if (si == 0) {
      // a new chunk: store the state entering it, then decay it
      if (ci > 0 && owner) {
        const long long base = ((long long)bh * (nc - 1) + ci - 1) * D;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const long long idx = (base + r0 + 8 * half) * D + e0 + j * 8 +
                                  2 * c;
            uint32_t hi, lo;
            split_pair(st[j][2 * half], st[j][2 * half + 1], hi, lo);
            *reinterpret_cast<uint32_t*>(chi + idx) = hi;
            *reinterpret_cast<uint32_t*>(clo + idx) = lo;
          }
        if (e0 == 0 && c == 0) {
          n_g[base + r0] = nst[0];
          n_g[base + r0 + 8] = nst[1];
        }
      }
      const float decay = dec_next;
      if (ci + 1 < nc) dec_next = decb[ci + 1];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] *= decay;
      nst[0] *= decay;
      nst[1] *= decay;
    }
    if (owner) {
      const unsigned char* stg = smem_raw + (g & 1) * L::stage_bytes;
      const bf16* Kt = reinterpret_cast<const bf16*>(stg);
      const bf16* Vt = reinterpret_cast<const bf16*>(stg + L::tile_bytes);
      const float* ws =
          reinterpret_cast<const float*>(stg + 2 * L::tile_bytes);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // (k o w)^T: rows d of this warp, columns s; a0/a2 hold row gr,
        // a1/a3 row gr + 8; a0/a1 columns 2c.., a2/a3 columns 8 + 2c..
        uint32_t ka[4], khi[4], klo[4];
        tc::ldmatrix_x4_trans(ka, Kt + (kk * 16 + (lane >> 4) * 8 +
                                        (lane & 7)) * TP + warp * 16 +
                                      ((lane >> 3) & 1) * 8);
        const float* w = ws + kk * 16 + 2 * c;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const __nv_bfloat162 kv =
              *reinterpret_cast<const __nv_bfloat162*>(&ka[i]);
          const int col = i < 2 ? 0 : 8;
          const float x0 = __low2float(kv) * w[col];
          const float x1 = __high2float(kv) * w[col + 1];
          split_pair(x0, x1, khi[i], klo[i]);
          nacc[i & 1] += x0 + x1;
        }
        uint32_t vf[NT / 2][4];
#pragma unroll
        for (int np = 0; np < NT / 2; ++np)
          tc::ldmatrix_x4_trans(vf[np], Vt + (kk * 16 + (lane & 15)) * TP +
                                            np * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          tc::mma_bf16(st[2 * np], khi, vf[np][0], vf[np][1]);
          tc::mma_bf16(st[2 * np + 1], khi, vf[np][2], vf[np][3]);
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          tc::mma_bf16(st[2 * np], klo, vf[np][0], vf[np][1]);
          tc::mma_bf16(st[2 * np + 1], klo, vf[np][2], vf[np][3]);
        }
      }
    }
    if (si == n_s - 1) {
      // the chunk's key sums, across the four lanes of a row
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        nacc[i] += __shfl_xor_sync(0xffffffffu, nacc[i], 1);
        nacc[i] += __shfl_xor_sync(0xffffffffu, nacc[i], 2);
        nst[i] += nacc[i];
        nacc[i] = 0.f;
      }
    }
  }

  if (owner) {
    float* co = C_out + (long long)bh * D * D;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(co + (long long)(r0 + 8 * half) * D +
                                   e0 + j * 8 + 2 * c) =
            make_float2(st[j][2 * half], st[j][2 * half + 1]);
    if (e0 == 0 && c == 0) {
      n_out[(long long)bh * D + r0] = nst[0];
      n_out[(long long)bh * D + r0 + 8] = nst[1];
    }
  }
}

// ---- 3. the outputs.  A CTA owns 64 rows of t of one chunk and W value
// columns, W = min(D, 128); warp w owns rows 16 w.. of them; its q tile
// stays in shared memory.  Its work is a list of items, each a 64-row
// tile of W bf16 columns copied into a ring of three slots by cp.async
// two items ahead of the one computed: the state pair of the inter-chunk
// term, CD rows of hi and CD of lo per item (chunks c >= 1); then, per s
// tile <= its t tile, D / W W-wide key slices of the scores and the v
// tile of P.v.  106 KB of shared memory at D = 384: two CTAs per SM.
template <int D>
struct OutTiling {
  static constexpr int W = D < 128 ? D : 128;   // value columns, key depth
  static constexpr int CD = D < 32 ? D : 32;    // state rows per item
  static constexpr int QP = D + 8, IP = W + 8;
  static constexpr int kSlots = 3;
  static constexpr int item_bytes = 64 * IP * 2;
  static constexpr int slots = 64 * QP * 2;              // after the q tile
  static constexpr int as = slots + kSlots * item_bytes; // f32 [kMaxChunk]
  static constexpr int rows = as + 4 * kMaxChunk;        // f32 [3][64]
  static constexpr int ns = rows + 4 * 3 * 64;           // f32 [D]
  static constexpr int bytes = ns + 4 * D;
  static_assert(D % W == 0 && D % CD == 0 && W % 16 == 0 && CD % 16 == 0 &&
                    2 * CD <= 64,
                "tiles");
};

template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
mlstm_out_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const float* __restrict__ a_g,
                    const float* __restrict__ rm_g,
                    const float* __restrict__ mt_g,
                    const float* __restrict__ m0_g,
                    const bf16* __restrict__ chi,
                    const bf16* __restrict__ clo,
                    const float* __restrict__ n_g, bf16* __restrict__ h,
                    int S, int H, int Q, float scale) {
  using L = OutTiling<D>;
  constexpr int W = L::W, CD = L::CD, QP = L::QP, IP = L::IP;
  constexpr int NJ = W / 8, KS = D / W, NI = D / CD, NE = D / W;
  constexpr int per_s = KS + 1;          // items per s tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  float* as = reinterpret_cast<float*>(smem_raw + L::as);
  float* rm_r = reinterpret_cast<float*>(smem_raw + L::rows);
  float* fl_r = rm_r + 64;               // the floor exp(-(b_t + rm_t))
  float* isc_r = fl_r + 64;              // scale exp(m0 - rm_t)
  float* ns = reinterpret_cast<float*>(smem_raw + L::ns);
  auto slot_at = [&](int item) {
    return reinterpret_cast<bf16*>(smem_raw + L::slots +
                                   (item % L::kSlots) * L::item_bytes);
  };

  const int n_t = gridDim.z;
  const int ti = n_t - 1 - blockIdx.z;   // the longest tiles launch first
  const int ci = blockIdx.y, nc = gridDim.y;
  const int bh = blockIdx.x / NE, e0 = (blockIdx.x % NE) * W;
  const int b = bh / H, hh = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, c = lane & 3;
  const int t0 = ti * 64;
  const int tr = warp * 16 + gr;         // this lane's rows tr, tr + 8
  const long long ld = (long long)H * D;
  const long long c0 = (long long)b * S + (long long)ci * Q;   // token row
  const bf16* qb = q + c0 * ld + (long long)hh * D;
  const bf16* kb = k + c0 * ld + (long long)hh * D;
  const bf16* vb = v + c0 * ld + (long long)hh * D + e0;
  const int ni = ci > 0 ? NI : 0;        // chunk 0 enters from C = n = 0
  const int n_items = ni + (ti + 1) * per_s;
  const long long st_base = ((long long)bh * (nc - 1) + ci - 1) * D;

  // one commit group per item, an empty one past the last
  auto prefetch = [&](int item) {
    if (item < n_items) {
      bf16* dst = slot_at(item);
      if (item < ni) {
        const long long off = (st_base + item * CD) * D + e0;
        tc_load_rows(dst, IP, chi + off, D, W, CD, CD);
        tc_load_rows(dst + CD * IP, IP, clo + off, D, W, CD, CD);
      } else {
        const int j = item - ni, si = j / per_s, r = j % per_s;
        const int valid = Q - si * 64;
        if (r < KS)
          tc_load_rows(dst, IP, kb + (long long)si * 64 * ld + r * W, ld, W,
                       64, valid);
        else
          tc_load_rows(dst, IP, vb + (long long)si * 64 * ld, ld, W, 64,
                       valid);
      }
    }
    tc::cp_async_commit();
  };

  tc_load_rows(Qs, QP, qb + (long long)t0 * ld, ld, D, 64, Q - t0);
  prefetch(0);
  prefetch(1);
  {
    const float* ab = a_g + (long long)bh * S + (long long)ci * Q;
    const float* rmb = rm_g + (long long)bh * S + (long long)ci * Q;
    const float* mtb = mt_g + (long long)bh * S + (long long)ci * Q;
    const float m0 = m0_g[(long long)bh * (nc + 1) + ci];
    for (int s = threadIdx.x; s < min(Q, t0 + 64); s += kTcThreads)
      as[s] = ab[s];
    if (threadIdx.x < 64) {
      const int t = t0 + threadIdx.x;
      const bool in = t < Q;
      const float rm = in ? rmb[t] : 0.f;
      rm_r[threadIdx.x] = rm;
      fl_r[threadIdx.x] = in ? expf(-mtb[t]) : 1.f;
      isc_r[threadIdx.x] = in && ci > 0 ? expf(m0 - rm) * scale : 0.f;
    }
    if (ci > 0)
      for (int d = threadIdx.x; d < D; d += kTcThreads)
        ns[d] = n_g[st_base + d];
  }

  float num[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) num[j][e] = 0.f;
  float sc[8][4];                        // scores of the s tile, then P
  float den[2] = {0.f, 0.f};

  for (int g = 0; g < n_items; ++g) {
    tc::cp_async_wait<1>();
    __syncthreads();     // item g landed; the slot of item g + 2 consumed
    prefetch(g + 2);
    const bf16* slot = slot_at(g);

    if (g < ni) {
      // inter-chunk term: num += q[:, CD rows of d] . C_c[those rows, :],
      // the state as a pair, the hi products of each k16 step first
#pragma unroll
      for (int kk = 0; kk < CD / 16; ++kk) {
        uint32_t qa[4];
        tc::ldmatrix_x4(qa, Qs + (warp * 16 + (lane & 15)) * QP + g * CD +
                                kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int part = 0; part < 2; ++part) {
          const bf16* Cp = slot + (part * CD + kk * 16) * IP;
#pragma unroll
          for (int pp = 0; pp < NJ / 2; ++pp) {
            uint32_t cf[4];
            tc::ldmatrix_x4_trans(cf, Cp + (lane & 15) * IP + pp * 16 +
                                          (lane >> 4) * 8);
            tc::mma_bf16(num[2 * pp], qa, cf[0], cf[1]);
            tc::mma_bf16(num[2 * pp + 1], qa, cf[2], cf[3]);
          }
        }
      }
      if (g == ni - 1) {
        const float i0 = isc_r[tr], i1 = isc_r[tr + 8];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          num[j][0] *= i0;
          num[j][1] *= i0;
          num[j][2] *= i1;
          num[j][3] *= i1;
        }
      }
      continue;
    }

    const int j = g - ni, si = j / per_s, r = j % per_s;
    // on the diagonal tile only the 16-column blocks at or before this
    // warp's rows carry weight
    const int kmax = si == ti ? warp : 3;
    if (r < KS) {
      // scores over the key slice d in [r W, r W + W)
      if (r == 0) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[jj][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < W / 16; ++kk) {
        uint32_t qa[4];
        tc::ldmatrix_x4(qa, Qs + (warp * 16 + (lane & 15)) * QP + r * W +
                                kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int sp = 0; sp < 4; ++sp) {
          if (sp > kmax) continue;
          uint32_t kf[4];
          tc::ldmatrix_x4(kf, slot + (sp * 16 + (lane >> 4) * 8 +
                                      (lane & 7)) * IP + kk * 16 +
                                  ((lane >> 3) & 1) * 8);
          tc::mma_bf16(sc[2 * sp], qa, kf[0], kf[1]);
          tc::mma_bf16(sc[2 * sp + 1], qa, kf[2], kf[3]);
        }
      }
      continue;
    }

    // the v item.  P = scale (q . k) exp(a_s - rm_t) where s <= t < Q: a
    // select
    const int t_a = t0 + tr, t_b = t_a + 8;
    const float rm_a = rm_r[tr], rm_b = rm_r[tr + 8];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      if (jj / 2 > kmax) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = si * 64 + jj * 8 + 2 * c + (e & 1);
        const int t = e < 2 ? t_a : t_b;
        const float rm = e < 2 ? rm_a : rm_b;
        const float p =
            s <= t && t < Q
                ? sc[jj][e] * scale * tc::exp2_approx((as[s] - rm) * kLog2e)
                : 0.f;
        sc[jj][e] = p;
        den[e >> 1] += p;
      }
    }
    // num += P . v, P as a pair straight from the accumulators
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk > kmax) continue;
      uint32_t ph[4], pl[4];
      tc::acc_to_a_split(ph, pl, sc[2 * kk], sc[2 * kk + 1]);
      uint32_t vf[NJ / 2][4];
#pragma unroll
      for (int pp = 0; pp < NJ / 2; ++pp)
        tc::ldmatrix_x4_trans(vf[pp], slot + (kk * 16 + (lane & 15)) * IP +
                                          pp * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int pp = 0; pp < NJ / 2; ++pp) {
        tc::mma_bf16(num[2 * pp], ph, vf[pp][0], vf[pp][1]);
        tc::mma_bf16(num[2 * pp + 1], ph, vf[pp][2], vf[pp][3]);
      }
#pragma unroll
      for (int pp = 0; pp < NJ / 2; ++pp) {
        tc::mma_bf16(num[2 * pp], pl, vf[pp][0], vf[pp][1]);
        tc::mma_bf16(num[2 * pp + 1], pl, vf[pp][2], vf[pp][3]);
      }
    }
  }

  // the row sums across the four lanes of a row, and q . n_c in f32
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    den[i] += __shfl_xor_sync(0xffffffffu, den[i], 1);
    den[i] += __shfl_xor_sync(0xffffffffu, den[i], 2);
  }
  float qn[2] = {0.f, 0.f};
  if (ci > 0) {
    for (int r = 0; r < 16; ++r) {
      const bf16* qr = Qs + (warp * 16 + r) * QP;
      float part = 0.f;
      for (int d = lane; d < D; d += 32)
        part = fmaf(__bfloat162float(qr[d]), ns[d], part);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (r == gr) qn[0] = part;
      if (r == gr + 8) qn[1] = part;
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = tr + 8 * half, t = t0 + r;
    if (t < Q) {
      const float denom =
          fmaxf(fabsf(den[half] + isc_r[r] * qn[half]), fl_r[r]);
      bf16* hr = h + (c0 + t) * ld + (long long)hh * D + e0;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
        *reinterpret_cast<uint32_t*>(hr + jj * 8 + 2 * c) = tc::pack_bf16(
            num[jj][2 * half] / denom, num[jj][2 * half + 1] / denom);
    }
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const float* ig,
              const float* fg, void* h, float* C, float* n, float* m, int B,
              int S, int H, int Q, float scale, void* scratch,
              cudaStream_t stream) {
  const int BH = B * H, nc = S / Q;
  const ScratchLayout L(BH, S, D, nc);
  char* base = static_cast<char*>(scratch);
  float* a_g = reinterpret_cast<float*>(base + L.a);
  float* rm_g = reinterpret_cast<float*>(base + L.rm);
  float* mt_g = reinterpret_cast<float*>(base + L.mt);
  float* m0_g = reinterpret_cast<float*>(base + L.m0);
  float* dec_g = reinterpret_cast<float*>(base + L.dec);
  float* wk_g = reinterpret_cast<float*>(base + L.wk);
  bf16* chi = reinterpret_cast<bf16*>(base + L.chi);
  bf16* clo = reinterpret_cast<bf16*>(base + L.clo);
  float* n_g = reinterpret_cast<float*>(base + L.n);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);

  cudaError_t err = cudaSuccess;
  const int gate_smem = 4 * nc * (int)sizeof(float);
  if (gate_smem > 48 * 1024) {
    err = cudaFuncSetAttribute(mlstm_gates_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               gate_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  mlstm_gates_kernel<<<BH, 32 * kGateWarps, gate_smem, stream>>>(
      ig, fg, a_g, rm_g, mt_g, m0_g, dec_g, wk_g, m, S, H, Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  using SL = StateTiling<D>;
  mlstm_state_tc_kernel<D><<<BH * SL::KT * SL::KT, kTcThreads, SL::bytes,
                             stream>>>(kb, vb, wk_g, dec_g, chi, clo, n_g, C,
                                       n, S, H, Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  using OL = OutTiling<D>;
  err = cudaFuncSetAttribute(mlstm_out_tc_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             OL::bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH * (D / OL::W), nc, (Q + 63) / 64);
  mlstm_out_tc_kernel<D><<<grid, kTcThreads, OL::bytes, stream>>>(
      qb, kb, vb, a_g, rm_g, mt_g, m0_g, chi, clo, n_g,
      static_cast<bf16*>(h), S, H, Q, scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ dispatch

// dtype 0 (f32) takes the scalar kernel, dtype 1 (bf16) the tensor-core
// ones
template <int D>
int launch_dtype(const void* q, const void* k, const void* v, const float* ig,
                 const float* fg, void* h, float* C, float* n, float* m,
                 int B, int S, int H, int Q, float scale, void* scratch,
                 int dtype, cudaStream_t stream) {
  if (dtype == 0)
    return launch<D>(q, k, v, ig, fg, h, C, n, m, B, S, H, Q, scale,
                            stream);
  if (dtype == 1)
    return launch_tc<D>(q, k, v, ig, fg, h, C, n, m, B, S, H, Q, scale,
                        scratch, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

bool valid_shape(int S, int D, int Q) {
  return Q > 0 && Q <= kMaxChunk && S % Q == 0 &&
         (D == 16 || D == 32 || D == 64 || D == 384);
}

}  // namespace

// Bytes of scratch the launch below needs (0 for f32); the arguments as
// there.
extern "C" long long mlstm_scratch_bytes(int B, int S, int H, int D, int Q,
                                         int dtype) {
  if (dtype != 1 || !valid_shape(S, D, Q) || B <= 0 || H <= 0) return 0;
  return ScratchLayout((long long)B * H, S, D, S / Q).bytes;
}

// dtype (of q, k, v and h): 0 = float32, 1 = bfloat16; the gates are f32.
// D in {16, 32, 64, 384}; 0 < Q <= 256; S % Q == 0; scale = 1/sqrt(D);
// scratch: mlstm_scratch_bytes(...) bytes, 256-byte aligned (bf16 only).
// Returns the cudaError_t of the first launch that failed, or 0.
extern "C" int mlstm_forward(const void* q, const void* k, const void* v,
                             const float* i_raw, const float* f_raw,
                             void* h, float* C, float* n, float* m, int B,
                             int S, int H, int D, int Q, float scale,
                             void* scratch, int dtype, void* stream) {
  if (!valid_shape(S, D, Q)) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_dtype<16>(q, k, v, i_raw, f_raw, h, C, n, m, B, S, H, Q,
                              scale, scratch, dtype, s);
    case 32:
      return launch_dtype<32>(q, k, v, i_raw, f_raw, h, C, n, m, B, S, H, Q,
                              scale, scratch, dtype, s);
    case 64:
      return launch_dtype<64>(q, k, v, i_raw, f_raw, h, C, n, m, B, S, H, Q,
                              scale, scratch, dtype, s);
    default:
      return launch_dtype<384>(q, k, v, i_raw, f_raw, h, C, n, m, B, S, H, Q,
                               scale, scratch, dtype, s);
  }
}
