// Device helpers shared by the flash-forward variants (flash_packed.cu,
// flash_pairs.cu, flash_variants.cu): the 4 x 4 register patch of a 64 x 64
// score or output tile held as fp32 in shared memory (transposed Q, K and P
// tiles with row stride kTileStride, as `load_tile` in common.cuh writes
// them), and one online-softmax step over such a patch.
#pragma once

#include "common.cuh"

namespace dct {

constexpr float kLog2e = 1.4426950408889634f;

// How a score patch becomes p. kSoftmaxExp2: the logits carry log2(e) in
// their scale and the exponentials are exp2f (what K1 does); kSoftmaxExp:
// natural-log logits and __expf; kNoSoftmax: p = clip(s, -1, 1), l = 1, no
// max, no exponential, no sum (not attention: the two products alone).
enum SoftmaxMode : int { kSoftmaxExp2 = 0, kSoftmaxExp = 1, kNoSoftmax = 2 };

// s[i][j] = sum_d qt[d][ty*4 + i] * kt[d][tx*4 + j] over the 64 rows of two
// transposed tiles.
__device__ __forceinline__ void qk_patch(const float* qt, const float* kt, int ty, int tx,
                                         float (&s)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 16
  for (int d = 0; d < kTile; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(qt + d * kTileStride + ty * 4);
    const float4 b = *reinterpret_cast<const float4*>(kt + d * kTileStride + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// acc[i][c] += sum_j pt[j][ty*4 + i] * v[j][tx*4 + c] over 64 rows j of a
// transposed P tile and a plain V tile with row stride `vstride` floats.
__device__ __forceinline__ void pv_patch(const float* pt, const float* v, int vstride,
                                         int ty, int tx, float (&acc)[4][4]) {
#pragma unroll 16
  for (int j = 0; j < kTile; ++j) {
    const float4 a = *reinterpret_cast<const float4*>(pt + j * kTileStride + ty * 4);
    const float4 b = *reinterpret_cast<const float4*>(v + j * vstride + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
  }
}

// One online-softmax step on a thread's 4 x 4 score patch. Column j of the
// patch is KV position col0 + j * colstep; positions >= lk are padding and
// get p = 0. The kLanes consecutive lanes that share the thread's rows
// reduce the row maximum and sum among themselves. On return s holds p
// (unrounded), m and l are updated and alpha[i] is the factor the caller
// applies to row i of its accumulator. Every KV tile holds at least one
// valid column, so m is finite after the first step.
template <int kMode, int kLanes>
__device__ __forceinline__ void softmax_patch(float (&s)[4][4], float (&m)[4], float (&l)[4],
                                              float (&alpha)[4], int col0, int colstep,
                                              int lk, float scale) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (kMode == kNoSoftmax) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[i][j] = col0 + j * colstep < lk ? fminf(fmaxf(s[i][j] * scale, -1.f), 1.f) : 0.f;
      l[i] = 1.f;
      alpha[i] = 1.f;
      continue;
    }
    float rmax = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = col0 + j * colstep < lk ? s[i][j] * scale : -CUDART_INF_F;
      rmax = fmaxf(rmax, s[i][j]);
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1)
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
    const float m_new = fmaxf(m[i], rmax);
    alpha[i] = kMode == kSoftmaxExp ? __expf(m[i] - m_new) : exp2f(m[i] - m_new);
    float rsum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = kMode == kSoftmaxExp ? __expf(s[i][j] - m_new) : exp2f(s[i][j] - m_new);
      rsum += s[i][j];
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1)
      rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
    l[i] = l[i] * alpha[i] + rsum;
    m[i] = m_new;
  }
}

// Write column j of the patch, rounded to T as the Pallas bodies round p
// before the PV product, to row `row0 + j * rowstep` of a transposed P tile
// whose rows hold the query rows ty*4 .. ty*4+3 as one float4.
template <typename T>
__device__ __forceinline__ void store_pt(float* pt, int ptstride, const float (&s)[4][4],
                                         int row0, int rowstep, int ty) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(pt + (row0 + j * rowstep) * ptstride + ty * 4) =
        make_float4(round_to<T>(s[0][j]), round_to<T>(s[1][j]), round_to<T>(s[2][j]),
                    round_to<T>(s[3][j]));
}

}  // namespace dct
