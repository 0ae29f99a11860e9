// Warp-level tensor-core building blocks for sm_80 and later (used on
// sm_90a): bf16 mma.sync m16n8k16 with f32 accumulation, ldmatrix, and
// cp.async with zero-fill.  Shared by the bf16 paths of the flash attention
// (K2) and SSD scan (K3) kernels.
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * g + c, g = lane / 4 the row
// group, c = lane % 4), each 32-bit register holding two bf16 of adjacent
// columns, the lower column in the low half:
//   A (16 x 16, row-major): a0 (g, 2c..2c+1)      a1 (g + 8, 2c..2c+1)
//                           a2 (g, 8 + 2c..)      a3 (g + 8, 8 + 2c..)
//   B (16 x 8, k x n):      b0 (k 2c..2c+1, n g)  b1 (k 8 + 2c.., n g)
//   C (16 x 8, f32):        c0, c1 (g, 2c..2c+1)  c2, c3 (g + 8, 2c..2c+1)
// So the f32 accumulators of two adjacent n8 tiles, packed to bf16, are the
// A fragment of the next product over those 16 columns (flash attention's
// P·V, the SSD's W'·x) with no trip through shared memory.
//
// ldmatrix x4 loads four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row
// addresses of matrix i, and register i of each lane receives matrix i in
// the layout of one fragment register above (.trans: transposed).  Shared
// tiles are rows of D bf16 with a pitch of D + 8 elements: for D in {16,
// 32, 64, 128} the pitch, 2D + 16 bytes, is an odd multiple of 16, so the 8
// rows of each matrix start in 8 distinct 16-byte slots of the 128-byte
// bank line and an ldmatrix reads without bank conflicts (padding in place
// of an XOR swizzle, at the cost of 1/8 more shared memory).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-fills the 16 bytes when
// !valid (src is then not read, but must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a * b, bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the SFU (ex2.approx.ftz: about 2^-22 relative, subnormal results
// flushed to 0), one instruction where exp2f adds range handling
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 as one register of two bf16 (round to nearest even), lo first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the A fragment of a 16 x 16 product from the f32 accumulators of its two
// n8 halves (columns 0-7 in c0, 8-15 in c1)
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// the same as a bf16 pair hi + lo of A fragments, hi = bf16(c) and
// lo = bf16(c - hi): two products carry c to about 2^-17 relative, where
// one rounding keeps 2^-9
__device__ __forceinline__ void acc_to_a_split(uint32_t (&hi)[4],
                                               uint32_t (&lo)[4],
                                               const float (&c0)[4],
                                               const float (&c1)[4]) {
  acc_to_a(hi, c0, c1);
  const float v[8] = {c0[0], c0[1], c0[2], c0[3],
                      c1[0], c1[1], c1[2], c1[3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h =
        *reinterpret_cast<const __nv_bfloat162*>(&hi[i]);
    lo[i] = pack_bf16(v[2 * i] - __low2float(h),
                      v[2 * i + 1] - __high2float(h));
  }
}

}  // namespace tc
