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

}  // namespace dct
