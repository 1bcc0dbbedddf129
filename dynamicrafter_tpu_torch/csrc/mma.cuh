// Tensor-core and asynchronous-copy building blocks for Hopper (sm_90a),
// shared by the bf16 paths of flash_attention.cu (K1, K3),
// flash_attention_bwd.cu (K4a, K4b), flash_tc.cuh (K6, K9, K10) and
// small_attention.cu (K2): cp.async into shared memory, ldmatrix, and the
// m16n8k16 bf16 mma.sync with fp32 accumulators. fused_conv.cu (K7, K8)
// takes cp.async for its fp32 route and ldmatrix for the A fragments of
// its wgmma (hopper.cuh).
#pragma once

#include "common.cuh"

namespace dct {

// 16 bytes from global to shared memory, bypassing L1.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
// As cp_async16, but when `valid` is false no byte is read and the 16 bytes
// of shared memory are zero-filled (the src-size operand is 0); `gmem` must
// still be a valid address.
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}
// 4 bytes from global to shared memory (through L1: .cg takes only 16), or
// 4 zero bytes when `valid` is false; `gmem` must still be a valid address.
__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most kPending of this thread's committed groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// cp.async of rows row0 .. row0 + kRows - 1 of one 64-wide bf16 head (row
// stride `stride` elements) into dst[kRows][kDstStride]; rows >= nvalid are
// zero-filled. Consecutive threads of the block's kThreads take consecutive
// 16-byte chunks of a row.
template <int kRows, int kThreads, int kDstStride>
__device__ __forceinline__ void cp_async_head_rows(__nv_bfloat16* dst,
                                                   const __nv_bfloat16* src, size_t stride,
                                                   int row0, int nvalid, int tid) {
  constexpr int kChunksPerRow = 64 / 8;
  constexpr int kChunks = kRows * kChunksPerRow;
  static_assert(kChunks % kThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < kChunks / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kChunksPerRow, c = (i % kChunksPerRow) * 8;
    const bool valid = row0 + r < nvalid;
    cp_async16_zfill(dst + r * kDstStride + c,
                     src + (size_t)(valid ? row0 + r : 0) * stride + c, valid);
  }
}

// Four 8 x 8 b16 matrices: lane l supplies the 16-byte row l % 8 of matrix
// l / 8 and receives elements (l / 4, 2 * (l % 4) + {0, 1}) of each, or with
// .trans elements (2 * (l % 4) + {0, 1}, l / 4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
// c (16 x 8, fp32) += a (16 x 16, bf16, row-major) * b (16 x 8, bf16, column-major).
// With g = lane / 4 and t = lane % 4: a[0] holds (g, 2t + {0, 1}), a[1]
// (g + 8, 2t + {0, 1}), a[2] (g, 2t + 8 + {0, 1}), a[3] (g + 8, 2t + 8 +
// {0, 1}); b0 holds (2t + {0, 1}, g), b1 (2t + 8 + {0, 1}, g); c[0], c[1]
// hold (g, 2t + {0, 1}) and c[2], c[3] (g + 8, 2t + {0, 1}). The lower
// column of a pair sits in the lower 16 bits.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to bf16 and packed as one mma operand register,
// `lo` in the lower 16 bits.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace dct
