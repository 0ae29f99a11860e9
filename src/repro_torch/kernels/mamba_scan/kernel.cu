// Mamba2 SSD chunked-scan forward for Hopper (sm_90a), with a plain C entry
// point that ../binding.cpp wraps for PyTorch.
//
// Replaces the Pallas kernel src/repro/kernels/mamba_scan/kernel.py
// (ssd_pallas / _ssd_kernel).  Per (batch b, head h) and chunk of Q tokens,
// with b_t the inclusive cumsum of dt_t * A over the chunk and
// xd_s = x_s * dt_s:
//     y_t   = sum_{s<=t} (C_t . B_s) exp(b_t - b_s) xd_s      (intra-chunk)
//           + exp(b_t) C_t . state                          (inter-chunk)
//     state = exp(b_Q) state + sum_s exp(b_Q - b_s) xd_s B_s^T
// The arithmetic is f32, except the cumsum b, which is f64: every decay is
// a difference b_t - b_s of two cumsums, and in f32 each carries an error
// of order |b| 2^-24, which at Q = 256 and |dt A| ~ 1 (|b| in the
// hundreds) puts errors of 1e-4 relative into the decays next to the
// diagonal.  x, B and C are read in their dtype (f32 or bf16), dt and A in
// f32; y is written in x's dtype and the (P, N) f32 state once,
// after the last chunk.  Head h reads B/C group h / (H / G), never a
// repeated copy.
//
// Layout: x (Bt, S, H, P), dt (Bt, S, H), A (H,), B/C (Bt, S, G, N),
// y like x, state (Bt, H, P, N); all contiguous (the model's own layout).
//
// Bound: at the serving shape (Bt 4, S 1024, H 64, P = N = 64, Q 256) the
// kernel must move ~73 MB (x and y dominate) and do ~13 GFLOP, so memory
// bounds it at the card's peaks.
//
// Two kernels behind one entry point, chosen by dtype:
//
// f32 (dtype 0): scalar f32 FMAs on the CUDA cores, held to the JAX
// package's f32 bounds (y 2e-4, state 1e-3: tests/test_kernels.py::
// test_ssd_kernel_sweep), which bf16 or TF32 products cannot meet.  One
// CTA per (b, h); the Pallas kernel's sequential chunk axis is a loop
// inside the CTA, with the state in shared memory.  The (Q, Q) matrix
// C.B^T (256 KB in f32 at Q = 256) is never materialised: the chunk is
// walked in 64-row tiles of t, and for each t tile in 64-row tiles of
// s <= t, so shared memory holds one C tile, one B tile, one xd tile, one
// (64, 64) weight tile and the state (85 KB at P = N = 64, two CTAs per
// SM).  The decay exp(b_t - b_s) is evaluated only where s <= t, and the
// weight is a select, not a product with a mask: above the diagonal the
// exponent is positive and may overflow, and inf * 0 would be NaN.  Any
// chunk length up to 256 works: rows past the chunk are loaded as zeros
// and never stored.  Each thread of the 16 x 16 grid owns a 4 x (P/16)
// block of y (rows ty + 16 i, columns tx + 16 j), a 4 x 4 block of the
// weight tile, and a (P/16) x (N/16) block of the state; B, C and the state
// rows are padded by one float so a warp's column reads hit distinct banks.
//
// bf16 (dtype 1, the serving path): the same walk on the tensor cores,
// bf16 mma.sync m16n8k16 with f32 accumulation (../common/mma.cuh), one
// CTA of 4 warps per (b, h), each warp owning 16 rows of the 64-row t
// tile; the cumsum stays f64 and the weight above the diagonal a select.
// The products of bf16 inputs (C.B^T; x in W'.x and in the state update)
// are exact.  Each f32 operand of a product is split into a bf16 pair
// hi + lo, one mma each, which carries it to about 2^-17 relative where
// one rounding keeps 2^-9 and misses the bounds (y 4e-2, state 1e-3; the
// CPU emulation in tests/test_torch_tc_numerics.py shows both misses):
// the intra-chunk weight W' = (C.B^T) exp(b_t - b_s) dt_s, formed in f32
// registers and used as the A fragment of W'.x (x read raw by
// ldmatrix.trans, so x dt is never rounded); the f32 state, written to
// shared memory as a pair before each chunk for the inter-chunk term
// exp(b_t) C_t . state^T; and the scaled B' = exp(b_Q - b_s) dt_s B_s of
// the state update state' = exp(b_Q) state + x^T B', whose A operand x^T
// is an ldmatrix.trans of the x tile.  The state update rides on the
// chunk's last t tile, which visits every s tile; the f32 state lives in
// the registers of the warps that own its rows.  The decays are
// exp2(bl_t + (b_t0 - b_s0) log2 e - bl_s) on the SFU, bl the f32 offset
// of b from the start of its 64-row tile (log2 e units) and the tile
// starts' difference taken in f64, so no f64 arithmetic is left in the
// inner loop and no f32 cumsum error enters.  The B and x tiles of the
// next (t tile, s tile) job, and its C tile when it opens a t tile, are
// double-buffered with cp.async; rows past the chunk are zero-filled.
// 95 KB of shared memory at P = N = 64: two CTAs per SM.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma.cuh"

namespace {

constexpr int kThreads = 256;   // a 16 x 16 grid of threads
constexpr int kTile = 64;       // rows of t, and of s, per tile
constexpr int kMaxChunk = 256;
constexpr int kWPad = kTile + 1;

template <int P, int N>
constexpr int smem_floats() {
  return 3 * kMaxChunk            // bcum (f64), dts
         + 2 * kTile * (N + 1)    // Cs, Bs
         + kTile * P              // Xs
         + kTile * kWPad          // Ws
         + P * (N + 1);           // St
}

// Inclusive prefix sum of v over the CTA's kWarps warps, in thread order.
template <int kWarps>
__device__ double block_inclusive_scan(double v, double* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  if (warp == 0) {
    double w = lane < kWarps ? wsum[lane] : 0.0;
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += u;
    }
    if (lane < kWarps) wsum[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += wsum[warp - 1];
  return v;
}

// rows [0, kTile) of a (rows, D) tile of src (row stride ld elements) into
// dst (row pitch pitch floats), zero past n_rows; optionally scaled by
// scale[row].
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int pitch,
                                          const float* src, long long ld,
                                          int n_rows,
                                          const float* scale = nullptr) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    float v = 0.f;
    if (r < n_rows) {
      v = src[(long long)r * ld + c];
      if (scale) v *= scale[r];
    }
    dst[r * pitch + c] = v;
  }
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads, 2)
ssd_fwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ Cm, float* __restrict__ y,
               float* __restrict__ state_out, int S, int H, int G, int Q) {
  constexpr int JP = P / 16, JN = N / 16, NP = N + 1;
  extern __shared__ __align__(16) float smem[];
  double* bcum = reinterpret_cast<double*>(smem);  // [kMaxChunk] cumsum
  float* dts = smem + 2 * kMaxChunk;     // [kMaxChunk] dt, then decays
  float* Cs = dts + kMaxChunk;           // [kTile][NP]
  float* Bs = Cs + kTile * NP;           // [kTile][NP]
  float* Xs = Bs + kTile * NP;           // [kTile][P]  xd (times a decay)
  float* Ws = Xs + kTile * P;            // [kTile][kWPad]
  float* St = Ws + kTile * kWPad;        // [P][NP]     carried state
  __shared__ double wsum[kThreads / 32];

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int g = h / (H / G);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float a = A[h];

  const long long x_ld = (long long)H * P;      // stride between tokens
  const long long bc_ld = (long long)G * N;
  const float* xb = x + (long long)b * S * x_ld + (long long)h * P;
  const float* Bb = Bm + (long long)b * S * bc_ld + (long long)g * N;
  const float* Cb = Cm + (long long)b * S * bc_ld + (long long)g * N;
  const float* dtb = dt + (long long)b * S * H + h;
  float* yb = y + (long long)b * S * x_ld + (long long)h * P;

  for (int idx = threadIdx.x; idx < P * NP; idx += kThreads) St[idx] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    // ---- decays of the chunk: b_t = cumsum(dt * A) ----
    float d = 0.f;
    if (threadIdx.x < Q) d = dtb[(long long)(c0 + threadIdx.x) * H];
    const double cum = block_inclusive_scan<kThreads / 32>((double)(d * a),
                                                          wsum);
    bcum[threadIdx.x] = cum;    // past Q it holds the chunk total
    dts[threadIdx.x] = d;
    __syncthreads();
    const double total = bcum[Q - 1];

    // ---- outputs, one 64-row tile of t at a time ----
    for (int t0 = 0; t0 < Q; t0 += kTile) {
      const int tn = min(kTile, Q - t0);
      // Cs is free: the previous tile's last use was before a barrier
      load_tile<N>(Cs, NP, Cb + (long long)(c0 + t0) * bc_ld, bc_ld, tn);
      __syncthreads();

      // inter-chunk term from the state before this chunk
      float acc[4][JP];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < JP; ++j) {
          const int p = tx + 16 * j;
          float s = 0.f;
#pragma unroll 8
          for (int n = 0; n < N; ++n)
            s = fmaf(Cs[t * NP + n], St[p * NP + n], s);
          acc[i][j] = s * expf((float)bcum[t0 + t]);
        }
      }

      // intra-chunk term over the s tiles at or before this t tile
      for (int s0 = 0; s0 <= t0; s0 += kTile) {
        const int sn = min(kTile, Q - s0);
        __syncthreads();        // Bs, Xs, Ws of the last s tile consumed
        load_tile<N>(Bs, NP, Bb + (long long)(c0 + s0) * bc_ld, bc_ld,
                        sn);
        load_tile<P>(Xs, P, xb + (long long)(c0 + s0) * x_ld, x_ld, sn,
                        dts + s0);
        __syncthreads();
        float w[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) w[i][j] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty + 16 * i) * NP + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * NP + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) w[i][j] = fmaf(cv[i], bv[j], w[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = tx + 16 * j;
            const bool live = t < tn && s0 + s <= t0 + t;
            Ws[t * kWPad + s] =
                live ? w[i][j] * expf((float)(bcum[t0 + t] - bcum[s0 + s]))
                     : 0.f;
          }
        }
        __syncthreads();
        const int s_end = s0 < t0 ? kTile : tn;   // diagonal: s <= t < tn
        for (int s = 0; s < s_end; ++s) {
          float xv[JP];
#pragma unroll
          for (int j = 0; j < JP; ++j) xv[j] = Xs[s * P + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float wv = Ws[(ty + 16 * i) * kWPad + s];
#pragma unroll
            for (int j = 0; j < JP; ++j) acc[i][j] = fmaf(wv, xv[j],
                                                          acc[i][j]);
          }
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t < tn) {
          float* yr = yb + (long long)(c0 + t0 + t) * x_ld;
#pragma unroll
          for (int j = 0; j < JP; ++j) yr[tx + 16 * j] = acc[i][j];
        }
      }
      __syncthreads();          // Cs and St reads of this tile are done
    }

    // ---- state update: St = exp(total) St + sum_s decay_s xd_s B_s^T ----
    if (threadIdx.x < Q)
      dts[threadIdx.x] *= expf((float)(total - bcum[threadIdx.x]));
    float sacc[JP][JN];
#pragma unroll
    for (int i = 0; i < JP; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) sacc[i][j] = 0.f;
    for (int s0 = 0; s0 < Q; s0 += kTile) {
      const int sn = min(kTile, Q - s0);
      __syncthreads();          // decays written; last tiles consumed
      load_tile<N>(Bs, NP, Bb + (long long)(c0 + s0) * bc_ld, bc_ld, sn);
      load_tile<P>(Xs, P, xb + (long long)(c0 + s0) * x_ld, x_ld, sn,
                      dts + s0);
      __syncthreads();
      for (int s = 0; s < sn; ++s) {
        float xv[JP], bv[JN];
#pragma unroll
        for (int i = 0; i < JP; ++i) xv[i] = Xs[s * P + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < JN; ++j) bv[j] = Bs[s * NP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < JP; ++i)
#pragma unroll
          for (int j = 0; j < JN; ++j)
            sacc[i][j] = fmaf(xv[i], bv[j], sacc[i][j]);
      }
    }
    const float dtot = expf((float)total);
#pragma unroll
    for (int i = 0; i < JP; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        float* sp = St + (ty + 16 * i) * NP + tx + 16 * j;
        *sp = fmaf(*sp, dtot, sacc[i][j]);
      }
    __syncthreads();            // St, bcum and dts ready for the next chunk
  }

  float* so = state_out + (long long)blockIdx.x * P * N;
  for (int idx = threadIdx.x; idx < P * N; idx += kThreads)
    so[idx] = St[(idx / N) * NP + idx % N];
}

template <int P, int N>
int launch(const void* x, const float* dt, const float* A, const void* B,
           const void* C, void* y, float* state, int Bt, int S, int H,
           int G, int Q, cudaStream_t stream) {
  const int smem = smem_floats<P, N>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_fwd_kernel<P, N><<<Bt * H, kThreads, smem, stream>>>(
      static_cast<const float*>(x), dt, A, static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<float*>(y), state, S, H, G,
      Q);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------ bf16, tensor cores

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr double kLog2e = 1.4426950408889634;

// Shared memory of the tensor-core kernel, byte offsets.  Tiles are rows
// of bf16 with a pitch of width + 8 (conflict-free ldmatrix, mma.cuh).
template <int P, int N>
struct TcSmem {
  static constexpr int kNP = N + 8, kPP = P + 8;
  static constexpr int bcum = 0;                         // f64 [kMaxChunk]
  static constexpr int dts = bcum + 8 * kMaxChunk;       // f32 [kMaxChunk]
  static constexpr int dfac = dts + 4 * kMaxChunk;       // f32 [kMaxChunk]
  static constexpr int bl2 = dfac + 4 * kMaxChunk;       // f32 [kMaxChunk]
  static constexpr int Cs = bl2 + 4 * kMaxChunk;         // [2][kTile][kNP]
  static constexpr int Bs = Cs + 2 * kTile * kNP * 2;    // [2][kTile][kNP]
  static constexpr int Xs = Bs + 2 * kTile * kNP * 2;    // [2][kTile][kPP]
  static constexpr int Bsc = Xs + 2 * kTile * kPP * 2;   // hi, lo [kTile][kNP]
  static constexpr int St = Bsc + 2 * kTile * kNP * 2;   // hi, lo [P][kNP]
  static constexpr int bytes = St + 2 * P * kNP * 2;
};

// rows [r0, r0 + kTile) of a (., D) matrix with row stride ld into a tile
// of pitch D + 8, by cp.async; rows at or past `limit` are zero-filled
template <int D>
__device__ __forceinline__ void tc_load_tile(bf16* dst, const bf16* src,
                                             long long ld, int r0,
                                             int limit) {
  constexpr int kChunks = D / 8;   // 16-byte chunks per row
  for (int i = threadIdx.x; i < kTile * kChunks; i += kTcThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r0 + r < limit;
    tc::cp_async16(dst + r * (D + 8) + c * 8,
                   src + (long long)(ok ? r0 + r : 0) * ld + c * 8, ok);
  }
}

// v as the bf16 pair hi + lo: hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split_bf16(float v, bf16& hi, bf16& lo) {
  hi = __float2bfloat16(v);
  lo = __float2bfloat16(v - __bfloat162float(hi));
}

// Per chunk and per 64-row tile of t, each warp owns 16 rows of t.  The
// work of a CTA is a list of jobs (chunk, t tile, s tile <= t tile); the
// B and x tiles of the next job (and its C tile, when it opens a t tile)
// are copied in with cp.async while the current job computes.
template <int P, int N>
__global__ void __launch_bounds__(kTcThreads, 2)
ssd_fwd_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const bf16* __restrict__ Bm,
                  const bf16* __restrict__ Cm, bf16* __restrict__ y,
                  float* __restrict__ state_out, int S, int H, int G,
                  int Q) {
  using L = TcSmem<P, N>;
  constexpr int NP = L::kNP, PP = L::kPP;
  constexpr int KN = N / 16;           // k16 steps over n
  constexpr int NPT = P / 8;           // n8 tiles of y (over p)
  constexpr int NNT = N / 8;           // n8 tiles of the state (over n)
  constexpr int kStateWarps = P / 16;  // warps owning 16 state rows of p
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* bcum = reinterpret_cast<double*>(smem_raw + L::bcum);
  float* dts = reinterpret_cast<float*>(smem_raw + L::dts);
  float* dfac = reinterpret_cast<float*>(smem_raw + L::dfac);
  float* bl2 = reinterpret_cast<float*>(smem_raw + L::bl2);
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw + L::Cs);
  bf16* Bs = reinterpret_cast<bf16*>(smem_raw + L::Bs);
  bf16* Xs = reinterpret_cast<bf16*>(smem_raw + L::Xs);
  bf16* Bsc_hi = reinterpret_cast<bf16*>(smem_raw + L::Bsc);
  bf16* Bsc_lo = Bsc_hi + kTile * NP;
  bf16* St_hi = reinterpret_cast<bf16*>(smem_raw + L::St);
  bf16* St_lo = St_hi + P * NP;
  __shared__ double wsum[kTcWarps];

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int grp = h / (H / G);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, c = lane & 3;
  const float a = A[h];

  const long long x_ld = (long long)H * P;      // stride between tokens
  const long long bc_ld = (long long)G * N;
  const bf16* xb = x + (long long)b * S * x_ld + (long long)h * P;
  const bf16* Bb = Bm + (long long)b * S * bc_ld + (long long)grp * N;
  const bf16* Cb = Cm + (long long)b * S * bc_ld + (long long)grp * N;
  const float* dtb = dt + (long long)b * S * H + h;
  bf16* yb = y + (long long)b * S * x_ld + (long long)h * P;

  const int n_t = (Q + kTile - 1) / kTile;        // t tiles per chunk
  const int n_jobs = (S / Q) * (n_t * (n_t + 1) / 2);

  // b_t = cumsum(dt * A) over the chunk at c0, in f64 (two tokens per
  // thread; zero past Q); dfac_s = exp(b_Q - b_s) dt_s; bl2_s = (b_s - b at
  // the start of s's 64-row tile) log2(e), in f32
  auto scan = [&](int c0) {
    const int i0 = 2 * threadIdx.x, i1 = i0 + 1;
    const float d0 = i0 < Q ? dtb[(long long)(c0 + i0) * H] : 0.f;
    const float d1 = i1 < Q ? dtb[(long long)(c0 + i1) * H] : 0.f;
    const double v0 = (double)(d0 * a), v1 = (double)(d1 * a);
    const double incl = block_inclusive_scan<kTcWarps>(v0 + v1, wsum);
    bcum[i0] = incl - v1;
    bcum[i1] = incl;
    dts[i0] = d0;
    dts[i1] = d1;
    __syncthreads();
    const double total = bcum[Q - 1];
    dfac[i0] = expf((float)(total - bcum[i0])) * d0;
    dfac[i1] = expf((float)(total - bcum[i1])) * d1;
    const double start = bcum[i0 & ~(kTile - 1)];   // i0, i1 share a tile
    bl2[i0] = (float)((bcum[i0] - start) * kLog2e);
    bl2[i1] = (float)((bcum[i1] - start) * kLog2e);
  };

  auto prefetch = [&](int ci, int ti, int si, int stage) {
    const int c0 = ci * Q;
    tc_load_tile<N>(Bs + stage * kTile * NP, Bb + (long long)c0 * bc_ld,
                    bc_ld, si * kTile, Q);
    tc_load_tile<P>(Xs + stage * kTile * PP, xb + (long long)c0 * x_ld,
                    x_ld, si * kTile, Q);
    if (si == 0)
      tc_load_tile<N>(Cs + ((ci * n_t + ti) & 1) * kTile * NP,
                      Cb + (long long)c0 * bc_ld, bc_ld, ti * kTile, Q);
    tc::cp_async_commit();
  };

  for (int i = threadIdx.x; i < 2 * P * NP; i += kTcThreads)
    St_hi[i] = __float2bfloat16(0.f);          // St_hi and St_lo
  prefetch(0, 0, 0, 0);
  scan(0);

  uint32_t cf[KN][4];      // C fragments of this warp's 16 rows of t
  float yacc[NPT][4];      // y of those rows
  float st[NNT][4];        // f32 state, rows 16 warp.. of p (state warps)
#pragma unroll
  for (int j = 0; j < NNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[j][e] = 0.f;

  int ci = 0, ti = 0, si = 0;
  for (int job = 0; job < n_jobs; ++job) {
    int nci = ci, nti = ti, nsi = si + 1;
    if (nsi > nti) {
      nsi = 0;
      if (++nti == n_t) { nti = 0; ++nci; }
    }
    tc::cp_async_wait<0>();
    __syncthreads();   // this job's tiles landed; the other stage consumed
    if (job + 1 < n_jobs) prefetch(nci, nti, nsi, (job + 1) & 1);

    const bf16* Bt = Bs + (job & 1) * kTile * NP;
    const bf16* Xt = Xs + (job & 1) * kTile * PP;
    const bool last_t = ti == n_t - 1;
    const bool diag = si == ti;
    const int c0 = ci * Q, t0 = ti * kTile, s0 = si * kTile;
    const int tr = t0 + warp * 16 + gr;        // this lane's rows tr, tr + 8

    if (last_t) {
      // the scaled B of the state update, dfac_s B_s, as a bf16 pair
      for (int i = threadIdx.x; i < kTile * N; i += kTcThreads) {
        const int r = i / N, n = i % N;
        split_bf16(__bfloat162float(Bt[r * NP + n]) * dfac[s0 + r],
                   Bsc_hi[r * NP + n], Bsc_lo[r * NP + n]);
      }
      __syncthreads();
    }

    if (si == 0) {
      // a new t tile: its C fragments, and the inter-chunk term
      // y_t = exp(b_t) C_t . state^T with the state as a bf16 pair
      const bf16* Ct = Cs + ((ci * n_t + ti) & 1) * kTile * NP;
#pragma unroll
      for (int kk = 0; kk < KN; ++kk)
        tc::ldmatrix_x4(cf[kk], Ct + (warp * 16 + (lane & 15)) * NP +
                                    kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NPT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
#pragma unroll
        for (int part = 0; part < 2; ++part) {   // hi, then lo
          const bf16* Sp = part ? St_lo : St_hi;
#pragma unroll
          for (int pp = 0; pp < NPT / 2; ++pp) {
            uint32_t sf[4];
            tc::ldmatrix_x4(sf, Sp + (pp * 16 + (lane >> 4) * 8 +
                                      (lane & 7)) * NP + kk * 16 +
                                    ((lane >> 3) & 1) * 8);
            tc::mma_bf16(yacc[2 * pp], cf[kk], sf[0], sf[1]);
            tc::mma_bf16(yacc[2 * pp + 1], cf[kk], sf[2], sf[3]);
          }
        }
      }
      const float e0 = expf((float)bcum[tr]), e1 = expf((float)bcum[tr + 8]);
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        yacc[j][0] *= e0;
        yacc[j][1] *= e0;
        yacc[j][2] *= e1;
        yacc[j][3] *= e1;
      }
    }

    // intra-chunk term over this s tile.  On the diagonal tile only the
    // 16-column blocks at or before this warp's rows carry weight.
    const int kmax = diag ? warp : kTile / 16 - 1;
    float w[kTile / 8][4];
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) w[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
#pragma unroll
      for (int sp = 0; sp < kTile / 16; ++sp) {
        if (sp > kmax) continue;
        uint32_t bf[4];
        tc::ldmatrix_x4(bf, Bt + (sp * 16 + (lane >> 4) * 8 + (lane & 7)) *
                                     NP + kk * 16 + ((lane >> 3) & 1) * 8);
        tc::mma_bf16(w[2 * sp], cf[kk], bf[0], bf[1]);
        tc::mma_bf16(w[2 * sp + 1], cf[kk], bf[2], bf[3]);
      }
    }
    // W' = (C.B^T) exp(b_t - b_s) dt_s where s <= t, a select (not a
    // product with a mask: above the diagonal the exponent is positive).
    // b_t - b_s = bl_t + (b_t0 - b_s0) - bl_s, the tile starts' difference
    // taken in f64: the f32 terms are short sums, so no f32 cumsum error
    const float dj = (float)((bcum[t0] - bcum[s0]) * kLog2e);
    const float rt0 = bl2[tr] + dj, rt1 = bl2[tr + 8] + dj;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      if (j / 2 > kmax) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int sc = s0 + j * 8 + 2 * c + (e & 1);
        const int t = e < 2 ? tr : tr + 8;
        const float decay = tc::exp2_approx((e < 2 ? rt0 : rt1) - bl2[sc]);
        w[j][e] = sc <= t ? w[j][e] * decay * dts[sc] : 0.f;
      }
    }
    // y += W' x_s, W' straight from the fragments as a bf16 pair
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      if (kk > kmax) continue;
      uint32_t wh[4], wl[4];
      tc::acc_to_a_split(wh, wl, w[2 * kk], w[2 * kk + 1]);
      uint32_t xf[NPT / 2][4];
#pragma unroll
      for (int pp = 0; pp < NPT / 2; ++pp)
        tc::ldmatrix_x4_trans(xf[pp], Xt + (kk * 16 + (lane & 15)) * PP +
                                          pp * 16 + (lane >> 4) * 8);
      // the hi products, then the lo ones: NPT accumulators apart
#pragma unroll
      for (int pp = 0; pp < NPT / 2; ++pp) {
        tc::mma_bf16(yacc[2 * pp], wh, xf[pp][0], xf[pp][1]);
        tc::mma_bf16(yacc[2 * pp + 1], wh, xf[pp][2], xf[pp][3]);
      }
#pragma unroll
      for (int pp = 0; pp < NPT / 2; ++pp) {
        tc::mma_bf16(yacc[2 * pp], wl, xf[pp][0], xf[pp][1]);
        tc::mma_bf16(yacc[2 * pp + 1], wl, xf[pp][2], xf[pp][3]);
      }
    }

    // state update, during the chunk's last t tile, which visits every s
    // tile: state = exp(b_Q) state + sum_s x_s^T (dfac_s B_s)
    if (last_t && warp < kStateWarps) {
      if (si == 0) {
        const float dtot = expf((float)bcum[Q - 1]);
#pragma unroll
        for (int j = 0; j < NNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[j][e] *= dtot;
      }
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t xa[4];   // x_s^T: rows p of this warp, columns s
        tc::ldmatrix_x4_trans(xa, Xt + (kk * 16 + (lane >> 4) * 8 +
                                        (lane & 7)) * PP + warp * 16 +
                                      ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int part = 0; part < 2; ++part) {   // hi, then lo
          const bf16* Bp = part ? Bsc_lo : Bsc_hi;
#pragma unroll
          for (int np = 0; np < NNT / 2; ++np) {
            uint32_t bf[4];
            tc::ldmatrix_x4_trans(bf, Bp + (kk * 16 + (lane & 15)) * NP +
                                          np * 16 + (lane >> 4) * 8);
            tc::mma_bf16(st[2 * np], xa, bf[0], bf[1]);
            tc::mma_bf16(st[2 * np + 1], xa, bf[2], bf[3]);
          }
        }
      }
    }

    if (diag) {
      // the t tile is complete: store its rows inside the chunk
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = tr + 8 * half;
        if (t < Q) {
          bf16* yr = yb + (long long)(c0 + t) * x_ld;
#pragma unroll
          for (int j = 0; j < NPT; ++j)
            *reinterpret_cast<uint32_t*>(yr + j * 8 + 2 * c) = tc::pack_bf16(
                yacc[j][2 * half], yacc[j][2 * half + 1]);
        }
      }
    }
    if (diag && last_t) {
      // the chunk is complete: the new state as a bf16 pair for the next
      // chunk's inter-chunk term, and the next chunk's decays
      __syncthreads();   // St, bcum, dts and dfac of this chunk consumed
      if (warp < kStateWarps) {
#pragma unroll
        for (int j = 0; j < NNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int idx = (warp * 16 + gr + (e >> 1) * 8) * NP + j * 8 +
                            2 * c + (e & 1);
            split_bf16(st[j][e], St_hi[idx], St_lo[idx]);
          }
      }
      if (nci < S / Q) scan(nci * Q);
    }
    ci = nci;
    ti = nti;
    si = nsi;
  }

  if (warp < kStateWarps) {
    float* so = state_out + (long long)blockIdx.x * P * N;
#pragma unroll
    for (int j = 0; j < NNT; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(
            so + (warp * 16 + gr + 8 * half) * N + j * 8 + 2 * c) =
            make_float2(st[j][2 * half], st[j][2 * half + 1]);
  }
}

template <int P, int N>
int launch_tc(const void* x, const float* dt, const float* A, const void* B,
              const void* C, void* y, float* state, int Bt, int S, int H,
              int G, int Q, cudaStream_t stream) {
  const int smem = TcSmem<P, N>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_tc_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_fwd_tc_kernel<P, N><<<Bt * H, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(x), dt, A, static_cast<const bf16*>(B),
      static_cast<const bf16*>(C), static_cast<bf16*>(y), state, S, H, G, Q);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ dispatch

// dtype 0 (f32) takes the scalar kernel, dtype 1 (bf16) the tensor-core one
template <int P, int N>
int launch_dtype(const void* x, const float* dt, const float* A,
                 const void* B, const void* C, void* y, float* state, int Bt,
                 int S, int H, int G, int Q, int dtype, cudaStream_t stream) {
  if (dtype == 0)
    return launch<P, N>(x, dt, A, B, C, y, state, Bt, S, H, G, Q, stream);
  if (dtype == 1)
    return launch_tc<P, N>(x, dt, A, B, C, y, state, Bt, S, H, G, Q, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int P>
int dispatch_n(const void* x, const float* dt, const float* A, const void* B,
               const void* C, void* y, float* state, int Bt, int S, int H,
               int G, int N, int Q, int dtype, cudaStream_t stream) {
  switch (N) {
    case 16:
      return launch_dtype<P, 16>(x, dt, A, B, C, y, state, Bt, S, H, G, Q,
                                 dtype, stream);
    case 32:
      return launch_dtype<P, 32>(x, dt, A, B, C, y, state, Bt, S, H, G, Q,
                                 dtype, stream);
    case 64:
      return launch_dtype<P, 64>(x, dt, A, B, C, y, state, Bt, S, H, G, Q,
                                 dtype, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16; dt and A are f32.
// P in {32, 64}; N in {16, 32, 64}; H % G == 0; 0 < Q <= 256; S % Q == 0.
// Returns the cudaError_t of the launch.
extern "C" int ssd_forward(const void* x, const float* dt, const float* A,
                           const void* B, const void* C, void* y,
                           float* state, int Bt, int S, int H, int G, int P,
                           int N, int Q, int dtype, void* stream) {
  if (Q <= 0 || Q > kMaxChunk || S % Q || G <= 0 || H % G)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Bt <= 0 || S <= 0 || H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 32:
      return dispatch_n<32>(x, dt, A, B, C, y, state, Bt, S, H, G, N, Q,
                            dtype, s);
    case 64:
      return dispatch_n<64>(x, dt, A, B, C, y, state, Bt, S, H, G, N, Q,
                            dtype, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
