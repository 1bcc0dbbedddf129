// K10: the flash-attention forward in three softmax modes (sm_90a). A
// diagnosis kernel: it says where the forward's time goes.
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
// only meaningful when the tile divides L). `exp` takes natural-log logits
// through __expf, `exp2` folds log2(e) into the scale and uses exp2f (K1's
// choice). Any finite scale, as the Pallas body scales before its max.
//
// What bounds it: arithmetic, as K1: 4*N*H*Lq*Lk*64 operations against
// 2 or 4 bytes * N*H*64*(2*Lq + 2*Lk); `nosoftmax` has the same bound since
// it does both products. At (32, 2560, 5*64) bf16: 268 GFLOP, 0.271 ms at
// 989 TFLOP/s. The input type chooses the kernel:
//
// bf16: `flash_variants_tc_kernel<mode>`, both products on the tensor
//   cores, through the loop K1, K6 and K9 share (flash_tc.cuh's
//   flash_fwd_tc_block with the mode as its template parameter; only the
//   softmax step differs). K1's tile and grid: one block of 4 warps per
//   (128-row query tile, head, n), 32 query rows a warp (two m16 tiles), Q
//   in registers as ldmatrix A fragments, a cp.async K/V ring of kStages
//   slots with the Q tile in its last slot. In mode exp2 the arithmetic is
//   K1's line for line, so its output is K1's bit for bit, and the three
//   modes diagnose the loop K1 runs: nosoftmax / exp2 is the share of the
//   time the products and the data movement take, 1 - that the softmax's.
//   The Pallas program walks all heads because a TPU core runs one large
//   program; one head a block is the fastest unit for this loop on this
//   card (PERF.md §7: two and four heads a block ran 1.03-1.31x K1's time),
//   so the head loop is not carried over.
//   kStages = 3, chosen by one timing (the bring-up probe, PERF.md §6;
//   NVIDIA H100 80GB HBM3 at 700 W; 5 rounds of 10 calls in turn, medians):
//   mode exp2 0.973 / 12.198 / 1.546 ms with three slots, 0.995 / 12.133 /
//   1.623 with two, at (32, 2560, 5*64), (32, 9216, 5*64), (32, 2304,
//   10*64); K1 0.943 / 11.985 / 1.603 in the same loop. Registers 249-252,
//   no spill. Card times of the three modes beside K1, the bound and the
//   library call: PERF.md §6 (`chip_smoke.py` phase 19).
//
// fp32: `flash_variants_kernel<float, mode>`, the first version, kept for
//   fp32 inputs only (TF32 would drop 13 bits of each operand; the fp32
//   tolerance is 1e-5). One 256-thread block per (64-row Q tile, n) walks
//   all heads one after the other, as the Pallas body's `for hh in
//   range(heads)` does: one head's (m, l, acc) lives in registers, is
//   finished and stored, and the next head starts (20 heads of a 64 x 64
//   fp32 accumulator would be 320 KB, more than a block's shared memory).
//   Tiles converted to fp32 and transposed in shared memory, every thread a
//   4 x 4 patch, products as fp32 FMAs on the SIMT pipes. Card times
//   (PERF.md §6): 8.7-9.1 ms at (32, 2560, 5*64) when it also ran bf16.
#include "flash_tc.cuh"
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

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel (flash_tc.cuh's loop on K1's tile and grid)
// ---------------------------------------------------------------------------

constexpr int kStages = 3;
using TcTile = dct::FlashTcTile<1, 4, 2, kStages>;

template <int kMode>
__global__ void __launch_bounds__(TcTile::kThreads)
flash_variants_tc_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                         int lq, int lk, int heads, float mult) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t n = blockIdx.z;
  const size_t hd = (size_t)heads * kD;
  const size_t col = (size_t)blockIdx.y * kD;
  dct::flash_fwd_tc_block<TcTile, kMode>(q + n * lq * hd + col, k + n * lk * hd + col,
                                         v + n * lk * hd + col, o + n * lq * hd + col, hd,
                                         blockIdx.x * TcTile::kBQ, lq, lk, 1, mult,
                                         reinterpret_cast<__nv_bfloat16*>(smem_raw));
}

template <int kMode>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, int n, int lq,
                      int lk, int heads, float scale, cudaStream_t stream) {
  const auto kernel = flash_variants_tc_kernel<kMode>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         TcTile::kSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + TcTile::kBQ - 1) / TcTile::kBQ, heads, n);
  kernel<<<grid, TcTile::kThreads, TcTile::kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lq, lk, heads,
      kMode == dct::kSoftmaxExp2 ? scale * dct::kLog2e : scale);
  return cudaGetLastError();
}

template <int kMode>
cudaError_t launch_dtype(int dtype, const void* q, const void* k, const void* v, void* o,
                         int n, int lq, int lk, int heads, float scale, cudaStream_t stream) {
  if (dtype == dct::kBFloat16) return launch_tc<kMode>(q, k, v, o, n, lq, lk, heads, scale, stream);
  if (dtype == dct::kFloat32)
    return launch<float, kMode>(q, k, v, o, n, lq, lk, heads, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// mode: 0 exp2, 1 exp, 2 nosoftmax (dct::SoftmaxMode); bf16 on the tensor
// cores, fp32 on FMAs
extern "C" int dct_flash_variant(const void* q, const void* k, const void* v, void* o,
                                 int dtype, int mode, int n, int lq, int lk, int heads,
                                 float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case dct::kSoftmaxExp2:
      return launch_dtype<dct::kSoftmaxExp2>(dtype, q, k, v, o, n, lq, lk, heads, scale, s);
    case dct::kSoftmaxExp:
      return launch_dtype<dct::kSoftmaxExp>(dtype, q, k, v, o, n, lq, lk, heads, scale, s);
    case dct::kNoSoftmax:
      return launch_dtype<dct::kNoSoftmax>(dtype, q, k, v, o, n, lq, lk, heads, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
