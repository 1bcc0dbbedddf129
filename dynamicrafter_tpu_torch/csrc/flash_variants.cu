// K10: flash-attention forward variants that walk all heads in one block,
// in three softmax modes (sm_90a). A diagnosis kernel: it says where the
// forward's time goes.
//
// Replaces experiments/flash_pairs/bench_flash_variants.py::_kernel (the
// Pallas kernel behind `run_variant`). In modes `exp` and `exp2` it computes
// K1's function (flash_attention.cu): non-causal softmax(Q K^T * scale) V
// per head on (N, L, H*64) operands, online softmax in fp32, KV positions
// >= Lk masked, l == 0 guarded, p rounded to the input type before PV.
// Mode `nosoftmax` is NOT attention: p = clip(Q K^T * scale, -1, 1) with
// l = 1, no maximum, no exponential and no row sum: the two products alone
// on the same data movement. Padded KV positions give p = 0 there (the
// Pallas body masks before the clip, which makes them -1; that variant is
// only meaningful when the tile divides L).
//
// How heads are assigned, and how that differs from K1: K1 runs one block
// per (64-row Q tile, one head, n), H times as many blocks. This kernel runs
// one block per (64-row Q tile, n) and that block walks ALL heads itself,
// one after the other, as the Pallas body's `for hh in range(heads)` does.
// The Pallas program keeps every head's (m, l, acc) in scratch memory
// across its KV grid steps; 20 heads of a 64 x 64 fp32 accumulator are
// 320 KB, more than a block's shared memory, so here the head loop is the
// outer one and the KV loop runs inside it: one head's state lives in
// registers, is finished and stored, and the next head starts. The softmax
// arithmetic is compiled in per mode: `exp` takes natural-log logits
// through __expf, `exp2` folds log2(e) into the scale and uses exp2f (K1's
// choice), so the two differ by one multiply per exponential on this card.
//
// What bounds it: arithmetic, as K1 (both products on the fp32 SIMT pipes);
// `nosoftmax` has the same operations bound since it does both products.
#include "flash_tile.cuh"

namespace {

constexpr int kD = 64;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;  // 16 x 16 threads, each a 4 x 4 patch
constexpr int kTS = dct::kTileStride;
constexpr int kSmemFloats = 3 * kD * kTS + kBK * kD;  // Qt, Kt, Pt, V
constexpr int kSmemBytes = kSmemFloats * 4;

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
flash_variants_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int lq, int lk,
                      int heads, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;             // [kD][kTS]  Q^T of the current head
  float* kt = qt + kD * kTS;    // [kD][kTS]  K^T
  float* pt = kt + kD * kTS;    // [kBK][kTS] P^T
  float* vs = pt + kBK * kTS;   // [kBK][kD]  V

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * kBQ;
  const size_t n = blockIdx.y;
  const size_t hd = (size_t)heads * kD;
  const int num_kv = (lk + kBK - 1) / kBK;

  for (int h = 0; h < heads; ++h) {
    const T* qb = q + n * lq * hd + h * kD;
    const T* kb = k + n * lk * hd + h * kD;
    const T* vb = v + n * lk * hd + h * kD;
    T* ob = o + n * lq * hd + h * kD;

    // the previous head's last reads of Qt were before its last barrier
    dct::load_tile<T, true, kThreads>(qt, qb, hd, q0, lq, tid);

    float m[4], l[4], acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = -CUDART_INF_F;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
    }

    for (int kv = 0; kv < num_kv; ++kv) {
      const int k0 = kv * kBK;
      __syncthreads();  // the previous tile's P^T and V reads are done
      dct::load_tile<T, true, kThreads>(kt, kb, hd, k0, lk, tid);
      dct::load_tile<T, false, kThreads>(vs, vb, hd, k0, lk, tid);
      __syncthreads();

      float s[4][4], alpha[4];
      dct::qk_patch(qt, kt, ty, tx, s);
      dct::softmax_patch<kMode, 16>(s, m, l, alpha, k0 + tx * 4, 1, lk, scale);
      if (kMode != dct::kNoSoftmax) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][c] *= alpha[i];
      }
      dct::store_pt<T>(pt, kTS, s, tx * 4, 1, ty);
      __syncthreads();

      dct::pv_patch(pt, vs, kD, ty, tx, acc);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      if (row < lq) {
        const float inv = l[i] == 0.f ? 1.f : 1.f / l[i];
        dct::store4(ob + (size_t)row * hd + tx * 4, acc[i][0] * inv, acc[i][1] * inv,
                    acc[i][2] * inv, acc[i][3] * inv);
      }
    }
  }
}

template <typename T, int kMode>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int n, int lq,
                   int lk, int heads, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_variants_kernel<T, kMode>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + kBQ - 1) / kBQ, n);
  flash_variants_kernel<T, kMode><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lq, lk, heads,
      kMode == dct::kSoftmaxExp2 ? scale * dct::kLog2e : scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mode(int mode, const void* q, const void* k, const void* v, void* o,
                        int n, int lq, int lk, int heads, float scale, cudaStream_t stream) {
  switch (mode) {
    case dct::kSoftmaxExp2:
      return launch<T, dct::kSoftmaxExp2>(q, k, v, o, n, lq, lk, heads, scale, stream);
    case dct::kSoftmaxExp:
      return launch<T, dct::kSoftmaxExp>(q, k, v, o, n, lq, lk, heads, scale, stream);
    case dct::kNoSoftmax:
      return launch<T, dct::kNoSoftmax>(q, k, v, o, n, lq, lk, heads, scale, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// mode: 0 exp2, 1 exp, 2 nosoftmax (dct::SoftmaxMode)
extern "C" int dct_flash_variant(const void* q, const void* k, const void* v, void* o,
                                 int dtype, int mode, int n, int lq, int lk, int heads,
                                 float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dct::kBFloat16)
    return launch_mode<__nv_bfloat16>(mode, q, k, v, o, n, lq, lk, heads, scale, s);
  if (dtype == dct::kFloat32)
    return launch_mode<float>(mode, q, k, v, o, n, lq, lk, heads, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
