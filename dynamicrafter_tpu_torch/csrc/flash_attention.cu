// K1 and K3: spatial flash-attention forward for Hopper (sm_90a).
//
// K1 replaces dynamicrafter_tpu/ops/flash_attention.py::_fwd_kernel_nlhd (the
// Pallas kernel behind `_flash_fwd_nlhd`, the inference path). Same function:
// non-causal, unmasked softmax(Q K^T * scale) V per head, with online softmax
// (fp32 running max m, sum l and accumulator), KV columns >= Lk masked, and a
// guard for l == 0. Inputs and output are (N, L, H*D) row-major with heads
// as D-wide slices of the last axis, so no head transpose touches memory.
//
// K3 replaces the same file's `_fwd_kernel` with save_lse=True (the forward
// `_nlhd_vjp_fwd` runs under a gradient): K1's math, plus the logsumexp
// lse = m + log l of every query row, written as (N, H, Lq) fp32 for the
// backward kernels in flash_attention_bwd.cu (0 where l == 0, as in the
// Pallas kernel). The Pallas path transposes q, k, v to head-major and
// stores lse replicated over 128 lanes; both were TPU layout conveniences
// and are not carried over: K3 reads and writes the same transpose-free
// layout as K1 and stores one float per row. K1 and K3 are one template;
// the lse store is compiled in only for K3.
//
// What bounds them: at 320x512 (N = 32, L = 2560, H = 5, D = 64) one call is
// 4*N*H*L^2*D = 268 GFLOP against 4*N*L*H*D*2 = 42 MB of bf16 traffic, i.e.
// ~6400 FLOP per byte -- far above the H100's ~295 FLOP/byte ridge. It is
// bound by arithmetic throughput, never by bytes; K3's lse adds 1.6 MB.
//
// Design of this first version (right before fast): one 256-thread block per
// (64-row Q tile, head, n). Q, K, V tiles are converted to fp32 in shared
// memory (Q and K transposed, so each thread reads 4 rows / 4 columns with
// one 16-byte load); every thread owns a 4x4 patch of the 64x64 score tile
// and of the 64x64 output tile, so each 16-byte shared load feeds 16 FMAs.
// The loop over KV tiles keeps m, l and the accumulator in registers and
// never writes the L x L scores to memory. Products run on the fp32 SIMT
// pipes, not the tensor cores: the kernel spends the card's arithmetic at
// the fp32 rate. Moving both products to bf16 tensor-core MMAs (mma.sync,
// then wgmma with TMA-fed K/V rings) is the path to the tensor-core bound.
#include "common.cuh"

namespace {

constexpr int kD = 64;        // head dim (the wrapper requires 64)
constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // key/value rows per KV tile
constexpr int kThreads = 256; // 16 x 16 threads, each a 4 x 4 patch
constexpr int kTS = dct::kTileStride;  // row stride of the transposed tiles
constexpr int kSmemFloats = 3 * kD * kTS + kBK * kD;  // Qt, Kt, Pt, V
constexpr int kSmemBytes = kSmemFloats * 4;

template <typename T, bool kLse>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int lq, int lk, int heads,
                 float scale_log2) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;              // [kD][kTS]  Q^T
  float* kt = qt + kD * kTS;     // [kD][kTS]  K^T
  float* pt = kt + kD * kTS;     // [kBK][kTS] P^T
  float* vs = pt + kBK * kTS;    // [kBK][kD]  V

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // owns score columns / output dims tx*4 .. tx*4+3
  const int ty = tid / 16;  // owns query rows ty*4 .. ty*4+3
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const size_t n = blockIdx.z;
  const size_t hd = (size_t)heads * kD;
  const T* qb = q + n * lq * hd + h * kD;
  const T* kb = k + n * lk * hd + h * kD;
  const T* vb = v + n * lk * hd + h * kD;
  T* ob = o + n * lq * hd + h * kD;

  dct::load_tile<T, true, kThreads>(qt, qb, hd, q0, lq, tid);

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  const int num_kv = (lk + kBK - 1) / kBK;
  for (int kv = 0; kv < num_kv; ++kv) {
    const int k0 = kv * kBK;
    __syncthreads();  // the previous tile's P^T and V reads are done
    dct::load_tile<T, true, kThreads>(kt, kb, hd, k0, lk, tid);
    dct::load_tile<T, false, kThreads>(vs, vb, hd, k0, lk, tid);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 16
    for (int d = 0; d < kD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kTS + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(kt + d * kTS + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    // online softmax in the log2 domain; every KV tile holds >= 1 valid
    // column, so the running max is finite after the first tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float rmax = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        s[i][j] = col < lk ? s[i][j] * scale_log2 : -CUDART_INF_F;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = exp2f(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(s[i][j] - m_new);
        rsum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }
    // p reaches the PV product in fp32. The Pallas kernels round it to the
    // input type first (`p.astype(v.dtype)`); doing so here was measured on
    // an NVIDIA H100 80GB HBM3 (700 W) at (32, 2560, 5*64) bf16: relative
    // L2 error against the fp32 plain version 2.257e-3 rounded, 1.661e-3
    // unrounded, at the same 8.72 ms. So p stays unrounded.
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (tx * 4 + j) * kTS + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 16
    for (int j = 0; j < kBK; ++j) {
      const float4 a = *reinterpret_cast<const float4*>(pt + j * kTS + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(vs + j * kD + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row < lq) {
      const float inv = l[i] == 0.f ? 1.f : 1.f / l[i];
      dct::store4(ob + (size_t)row * hd + tx * 4, acc[i][0] * inv, acc[i][1] * inv,
                  acc[i][2] * inv, acc[i][3] * inv);
      // m is in the log2 domain: lse = ln(2^m * l) = m * ln 2 + ln l
      if (kLse && tx == 0)
        lse[((size_t)n * heads + h) * lq + row] =
            l[i] == 0.f ? 0.f : m[i] * 0.6931471805599453f + logf(l[i]);
    }
  }
}

template <typename T, bool kLse>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   int n, int lq, int lk, int heads, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, kLse>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + kBQ - 1) / kBQ, heads, n);
  const float log2e = 1.4426950408889634f;
  flash_fwd_kernel<T, kLse><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, lq, lk, heads, scale * log2e);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dct_flash_fwd(const void* q, const void* k, const void* v, void* o,
                             int dtype, int n, int lq, int lk, int heads,
                             float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dct::kBFloat16)
    return launch<__nv_bfloat16, false>(q, k, v, o, nullptr, n, lq, lk, heads, scale, s);
  if (dtype == dct::kFloat32)
    return launch<float, false>(q, k, v, o, nullptr, n, lq, lk, heads, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int dct_flash_fwd_lse(const void* q, const void* k, const void* v, void* o,
                                 void* lse, int dtype, int n, int lq, int lk, int heads,
                                 float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == dct::kBFloat16)
    return launch<__nv_bfloat16, true>(q, k, v, o, l, n, lq, lk, heads, scale, s);
  if (dtype == dct::kFloat32)
    return launch<float, true>(q, k, v, o, l, n, lq, lk, heads, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* dct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
