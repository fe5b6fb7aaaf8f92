// Tensor-core building blocks of the bf16 attention kernels (sm_80 and up,
// built here for sm_90a): 16-byte cp.async copies into shared memory,
// ldmatrix loads of 8x8 bf16 tiles, and mma.sync m16n8k16 with bf16
// operands and f32 accumulators.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, c = lane % 4):
//   A (16 x 16, row-major)  a0 = A[g][2c..2c+1]   a1 = A[g+8][2c..]
//                           a2 = A[g][2c+8..]     a3 = A[g+8][2c+8..]
//   B (16 x 8, k x n)       b0 = B[2c..2c+1][g]   b1 = B[2c+8..2c+9][g]
//   C (16 x 8, f32)         c0, c1 = C[g][2c..2c+1]   c2, c3 = C[g+8][2c..]
// so the C fragments of two neighbouring n-tiles, rounded to bf16 pairs,
// are the A fragment of the next product over those 16 columns.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace srt {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; with valid false the 16 bytes
// are filled with zeros and nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 tiles; lanes 8i..8i+7 give the row addresses of tile i,
// register i receives row lane / 4, columns 2 (lane % 4) .. +1 of tile i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// the same four tiles, each transposed on the way
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a * b on the tensor cores (bf16 in, f32 accumulate)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragment (16 rows x 16 columns) made of two f32 C fragments
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Addresses each lane gives ldmatrix for a 16 x 16 block at (r0, c0) of a
// row-major shared tile with row stride STR elements:
// - as an A operand (ldsm_x4): registers a0..a3;
__device__ __forceinline__ int frag_a_offset(int lane, int STR) {
  return (lane % 16) * STR + (lane / 16) * 8;
}
// - as the B operand of two n-tiles, the tile's rows being the n index
//   (ldsm_x4): r0, r1 = b0, b1 of rows 0-7; r2, r3 = b0, b1 of rows 8-15;
__device__ __forceinline__ int frag_bn_offset(int lane, int STR) {
  return ((lane % 8) + (lane / 16) * 8) * STR + ((lane / 8) % 2) * 8;
}
// - as the B operand of two n-tiles, the tile's rows being the k index
//   (ldsm_x4_t): r0, r1 = b0, b1 of columns 0-7; r2, r3 of columns 8-15.
__device__ __forceinline__ int frag_bk_offset(int lane, int STR) {
  return ((lane % 8) + ((lane / 8) % 2) * 8) * STR + (lane / 16) * 8;
}

// Copy ROWS rows of DH bf16 (row stride `stride` elements in global memory,
// 16-byte aligned) into a [ROWS][DH + 8] shared tile with 16-byte cp.async;
// rows >= n_valid are zero-filled. The 8 padding elements per row put the
// eight rows an ldmatrix phase reads on distinct banks.
template <int ROWS, int DH, int THREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long stride,
                                          int n_valid, int tid) {
  constexpr int kChunks = DH / 8;  // 16-byte chunks per row
  constexpr int kIters = (ROWS * kChunks + THREADS - 1) / THREADS;
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int c = tid + i * THREADS;
    if (c < ROWS * kChunks) {
      const int r = c / kChunks;
      const int col = (c % kChunks) * 8;
      const bool ok = r < n_valid;
      cp_async16(dst + r * (DH + 8) + col, src + (ok ? r : 0) * stride + col, ok);
    }
  }
}

// Store ROWS x DH bf16 from a [ROWS][DH + 8] shared tile to the rows
// row0, row0 + 1, ... of a contiguous [*, row_stride] tensor with 16-byte
// stores, rows >= n_valid left out.
template <int ROWS, int DH>
__device__ __forceinline__ void store_rows(bf16* dst, long long row_stride, const bf16* src,
                                           int n_valid, int lane) {
  constexpr int kChunks = DH / 8;
  for (int c = lane; c < ROWS * kChunks; c += 32) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    if (r < n_valid)
      *reinterpret_cast<uint4*>(dst + r * row_stride + col) =
          *reinterpret_cast<const uint4*>(src + r * (DH + 8) + col);
  }
}

}  // namespace srt
