// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel library entry point is `extern "C"`, takes raw device
// pointers and a cudaStream_t as void*, launches on that stream without
// synchronising, and returns cudaGetLastError() so the Python wrapper can
// raise on a refused launch (too much shared memory, bad grid, ...).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace dct {

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

// 16-byte vector loads and stores between global/shared memory and fp32
// registers. kVec elements fill one 16-byte access.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kVec = 4;
  __device__ __forceinline__ static void load(const float* p, float* f) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* f) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float* f) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

// Load four consecutive T as fp32 (8-byte aligned for bf16, 16 for fp32).
__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}

// Round an fp32 value to T and back: what `x.astype(T)` does to an
// operand before a product in the Pallas kernels.
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Store four consecutive fp32 values as T (8 bytes for bf16, 16 for fp32).
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  uint2 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
  h[0] = __floats2bfloat162_rn(a, b);
  h[1] = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(p) = u;
}

// 64 x 64 tiles of a (rows, H*64) operand in fp32 shared memory, as the
// flash-attention kernels hold them. Transposed tiles are stored [col][row]
// with row stride kTileStride floats (the 4-float pad keeps the transposing
// stores and the 16-byte row reads conflict-free), plain tiles [row][col]
// with stride 64.
constexpr int kTile = 64;
constexpr int kTileStride = kTile + 4;

// Load rows row0 .. row0+63 of `src` (row stride `stride` elements, 64
// columns) into `dst`; rows >= nvalid read as zero.
template <typename T, bool kTranspose, int kThreads>
__device__ __forceinline__ void load_tile(float* dst, const T* src, size_t stride,
                                          int row0, int nvalid, int tid) {
  using V = Vec16<T>;
  constexpr int kVec = V::kVec;
  constexpr int kPerRow = kTile / kVec;
  constexpr int kTotal = kTile * kPerRow;
#pragma unroll
  for (int idx = tid; idx < kTotal; idx += kThreads) {
    // transposed: lanes walk rows (conflict-free column-major stores);
    // plain: lanes walk along a row (coalesced 16-byte loads and stores)
    const int row = kTranspose ? idx % kTile : idx / kPerRow;
    const int vec = kTranspose ? idx / kTile : idx % kPerRow;
    float f[kVec];
    if (row0 + row < nvalid) {
      V::load(src + (size_t)(row0 + row) * stride + vec * kVec, f);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) f[i] = 0.f;
    }
    if (kTranspose) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) dst[(vec * kVec + i) * kTileStride + row] = f[i];
    } else {
#pragma unroll
      for (int i = 0; i < kVec; i += 4)
        store4(dst + row * kTile + vec * kVec + i, f[i], f[i + 1], f[i + 2], f[i + 3]);
    }
  }
}

}  // namespace dct
