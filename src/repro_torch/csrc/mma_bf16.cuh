// mma_bf16.cuh: the Ampere/Hopper warp-level building blocks of the bf16
// tensor-core kernels, as inline PTX (no CUTLASS):
//
//   mma_16816   mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
//   ldsm_x4     ldmatrix.sync.aligned.m8n8.x4 (and .trans): four 8 x 8 bf16
//               matrices from shared memory into mma fragments (lane
//               addresses: a_rows, a_rows_km, b_rows_nk, b_rows_kn)
//   cp_async_16 cp.async.cg 16-byte global -> shared copy, zero-filled when
//               the source row is out of range; cp_async_4 (cp.async.ca) for
//               fp32 row statistics
//
// Fragment layout of m16n8k16 (lane = 4 * g + t, g < 8, t < 4):
//   A 16 x 16 (row-major), 4 regs of 2 bf16: (g, 2t..2t+1), (g+8, 2t..),
//     (g, 2t+8..), (g+8, 2t+8..)
//   B 16 x 8 (k x n), 2 regs: (k 2t..2t+1, n g), (k 2t+8..2t+9, n g)
//   C/D 16 x 8 fp32, 4 floats: (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
// so the accumulator of two adjacent n-tiles, packed to bf16 pairs, is the A
// fragment of the next product (the FA-2 register reuse).  The smaller
// column index sits in the low half of a packed register.
//
// Shared-memory tiles are row-major with a row pitch of (width + 8) bf16 for
// rows of `width` elements: an odd multiple of 16 bytes modulo 128 for every
// width that is a multiple of 16, so the eight row addresses of each
// ldmatrix phase fall in eight different 16-byte bank groups (no
// conflicts).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_mma {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// row pitch, in elements, of a shared-memory tile of hd-wide bf16 rows
template <int HD>
__host__ __device__ constexpr int pitch() {
  return HD + 8;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const unsigned (&a)[4],
                                          unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Lane addresses for ldsm_x4 over a row-major tile `base` of row pitch
// `pitch` elements:
// A operand stored [m][k] (rows r0..r0+15 x cols c0..c0+15) -> a0..a3
__device__ __forceinline__ const bf16* a_rows(const bf16* base, int pitch,
                                              int r0, int c0, int lane) {
  return base + (r0 + (lane & 15)) * pitch + c0 + (lane >> 4) * 8;
}
// A operand stored [k][m] (rows k0..k0+15, m cols m0..m0+15), read with
// .trans -> a0..a3
__device__ __forceinline__ const bf16* a_rows_km(const bf16* base, int pitch,
                                                 int k0, int m0, int lane) {
  return base + (k0 + (lane & 7) + (lane >> 4) * 8) * pitch + m0 +
         ((lane >> 3) & 1) * 8;
}
// B operand stored as [n][k] (rows n0..n0+15, k cols c0..c0+15), read
// without .trans -> {b0, b1} of n-tile n0 and {b0, b1} of n-tile n0 + 8
__device__ __forceinline__ const bf16* b_rows_nk(const bf16* base, int pitch,
                                                 int n0, int c0, int lane) {
  return base + (n0 + (lane & 7) + (lane >> 4) * 8) * pitch + c0 +
         ((lane >> 3) & 1) * 8;
}
// B operand stored as [k][n] (rows k0..k0+15, n cols n0..n0+15), read with
// .trans -> {b0, b1} of n-tile n0 and {b0, b1} of n-tile n0 + 8
__device__ __forceinline__ const bf16* b_rows_kn(const bf16* base, int pitch,
                                                 int k0, int n0, int lane) {
  return base + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * pitch + n0 +
         (lane >> 4) * 8;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// (x0, x1) as the sum of two packed bf16 pairs: `hi` rounds them, `lo`
// rounds what `hi` left out, so hi + lo carries ~16 significant bits
__device__ __forceinline__ void split_bf16(float x0, float x1, unsigned& hi,
                                           unsigned& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<unsigned*>(&h);
  lo = *reinterpret_cast<unsigned*>(&l);
}

// 16 bytes global -> shared; zeros when !ok (the source is then not read)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows r0 .. r0 + ROWS - 1 of one (batch, head) slab of hd-wide bf16 rows
// (row stride `row_stride` elements) -> shared tile of pitch HD + 8, by
// 16-byte cp.async from all THREADS threads; rows at or past `n` are zeros
template <int HD, int ROWS, int THREADS>
__device__ __forceinline__ void cp_tile(bf16* dst, const bf16* src,
                                        long long row_stride, int r0, int n) {
  constexpr int kChunks = HD / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks, c = i % kChunks;
    const int row = r0 + r;
    const bool ok = row < n;
    cp_async_16(dst + r * pitch<HD>() + c * 8,
                ok ? src + row * row_stride + c * 8 : src, ok);
  }
}

}  // namespace repro_mma
