// K4a and K4b: the FlashAttention-2 backward for Hopper (sm_90a).
//
// K4a replaces dynamicrafter_tpu/ops/flash_attention.py::_bwd_dq_kernel and
// K4b replaces ::_bwd_dkv_kernel (both behind `_flash_bwd`, the backward of
// the spatial self-attention under a gradient). Same function, from the
// forward's output o and logsumexp lse (K3, flash_attention.cu):
//
//   p  = exp(q k^T * scale - lse)        recomputed tile by tile
//   dp = dO v^T,   di = rowsum(dO * o)
//   ds = p * (dp - di) * scale           rounded to the input dtype
//   dq = ds k      (K4a)       dk = ds^T q,   dv = p^T dO   (K4b)
//
// As in the Pallas kernels, dO and o enter in fp32, so p reaches dv
// unrounded, and ds is rounded to the input dtype before both of its
// products; ragged KV columns get p = 0 in K4a and ragged q rows p = 0 in
// K4b. Operands keep the forward's transpose-free (N, L, H*64) layout and
// lse is (N, H, Lq) fp32: the head-major transposes and the 128-lane lse
// copy of the Pallas path are not carried over.
//
// What bounds them: at 320x512 (N = 32, L = 2560, H = 5, D = 64) K4a does
// 6*N*H*L^2*D = 403 GFLOP and K4b 8*N*H*L^2*D = 537 GFLOP per call, against
// ~80 MB of bf16 operands: thousands of FLOP per byte, far above the
// ~295 FLOP/byte ridge. They are bound by arithmetic, like K1.
//
// Design of this first version (right before fast): the Pallas kernels
// carry dq (or dk, dv) across the sequential innermost grid axis; on the
// card blocks run in no order, so each block owns its output tile outright
// and loops over the other sequence itself. K4a is one 256-thread block per
// (64-row q tile, head, n) looping over the KV tiles; K4b one per (64-row
// KV tile, head, n) looping over the q tiles. Every sum stays inside one
// block: no atomics, no second pass, deterministic results. Tiles live in
// fp32 shared memory in the layout each product reads with 16-byte loads
// (transposed for the contractions over D, plain for the contractions over
// the sequence), and every thread owns a 4x4 patch of each 64x64 product,
// as in K1. Products run on the fp32 SIMT pipes; moving them to bf16
// tensor-core MMAs is the next step, as for K1.
#include "common.cuh"

namespace {

constexpr int kD = dct::kTile;          // head dim (the wrapper requires 64)
constexpr int kB = dct::kTile;          // rows per q tile and per KV tile
constexpr int kTS = dct::kTileStride;   // row stride of the [col][row] tiles
constexpr int kThreads = 256;           // 16 x 16 threads, each a 4 x 4 patch
constexpr float kLog2e = 1.4426950408889634f;

// K4a shared memory: Q^T, dO^T, K^T, V^T, dS^T ([col][row], stride kTS), K.
constexpr int kDqSmemBytes = (5 * kD * kTS + kB * kD) * 4;
// K4b: K^T, V^T, Q^T, dO^T, P^T and dS^T stored [i][j], Q, dO, lse, di.
constexpr int kDkvSmemBytes = (6 * kD * kTS + 2 * kB * kD + 2 * kB) * 4;

__device__ __forceinline__ void fma4x4(float (&acc)[4][4], const float* a, const float* b) {
  const float4 x = *reinterpret_cast<const float4*>(a);
  const float4 y = *reinterpret_cast<const float4*>(b);
  const float av[4] = {x.x, x.y, x.z, x.w};
  const float bv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

__device__ __forceinline__ void zero4x4(float (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
}

// Store the transpose of a thread's 4x4 patch x[r][c] (rows r0.., columns
// c0..) into a [col][row] tile: dst[(c0 + c) * kTS + r0 + r].
__device__ __forceinline__ void store_patch_t(float* dst, const float (&x)[4][4], int r0,
                                              int c0) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
    *reinterpret_cast<float4*>(dst + (c0 + c) * kTS + r0) =
        make_float4(x[0][c], x[1][c], x[2][c], x[3][c]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const float* __restrict__ lse, const T* __restrict__ dout,
                    T* __restrict__ dq, int lq, int lk, int heads, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;             // [kD][kTS]  Q^T
  float* dot = qt + kD * kTS;   // [kD][kTS]  dO^T
  float* kt = dot + kD * kTS;   // [kD][kTS]  K^T
  float* vt = kt + kD * kTS;    // [kD][kTS]  V^T
  float* dst = vt + kD * kTS;   // [kB][kTS]  dS^T
  float* ks = dst + kB * kTS;   // [kB][kD]   K

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // owns KV columns / dq dims tx*4 .. tx*4+3
  const int ty = tid / 16;  // owns q rows ty*4 .. ty*4+3
  const int q0 = blockIdx.x * kB;
  const int h = blockIdx.y;
  const size_t n = blockIdx.z;
  const size_t hd = (size_t)heads * kD;
  const T* qb = q + n * lq * hd + h * kD;
  const T* kb = k + n * lk * hd + h * kD;
  const T* vb = v + n * lk * hd + h * kD;
  const T* ob = o + n * lq * hd + h * kD;
  const T* dob = dout + n * lq * hd + h * kD;
  const float* lseb = lse + (n * heads + h) * lq;

  dct::load_tile<T, true, kThreads>(qt, qb, hd, q0, lq, tid);
  dct::load_tile<T, true, kThreads>(dot, dob, hd, q0, lq, tid);

  // per row: lse in the log2 domain, and di = rowsum(dO * o), each of the
  // 16 threads of a row summing its 4 dims, then a butterfly over them
  float lse2[4], di[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    float a[4] = {0.f, 0.f, 0.f, 0.f}, b[4] = {0.f, 0.f, 0.f, 0.f};
    lse2[i] = 0.f;
    if (row < lq) {
      lse2[i] = lseb[row] * kLog2e;
      dct::load4(ob + (size_t)row * hd + tx * 4, a);
      dct::load4(dob + (size_t)row * hd + tx * 4, b);
    }
    float part = a[0] * b[0] + a[1] * b[1] + a[2] * b[2] + a[3] * b[3];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    di[i] = part;
  }

  const float scale_log2 = scale * kLog2e;
  float acc[4][4];
  zero4x4(acc);
  const int num_kv = (lk + kB - 1) / kB;
  for (int kv = 0; kv < num_kv; ++kv) {
    const int k0 = kv * kB;
    __syncthreads();  // the previous tile's dS^T and K reads are done
    dct::load_tile<T, true, kThreads>(kt, kb, hd, k0, lk, tid);
    dct::load_tile<T, true, kThreads>(vt, vb, hd, k0, lk, tid);
    dct::load_tile<T, false, kThreads>(ks, kb, hd, k0, lk, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
    zero4x4(s);
    zero4x4(dp);
#pragma unroll 8
    for (int d = 0; d < kD; ++d) {
      fma4x4(s, qt + d * kTS + ty * 4, kt + d * kTS + tx * 4);
      fma4x4(dp, dot + d * kTS + ty * 4, vt + d * kTS + tx * 4);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = k0 + tx * 4 + j < lk ? exp2f(s[i][j] * scale_log2 - lse2[i]) : 0.f;
        s[i][j] = dct::round_to<T>(p * (dp[i][j] - di[i]) * scale);  // ds
      }
    store_patch_t(dst, s, ty * 4, tx * 4);
    __syncthreads();

    // dq[i][c] += sum_j ds[i][j] k[j][c]
#pragma unroll 8
    for (int j = 0; j < kB; ++j) fma4x4(acc, dst + j * kTS + ty * 4, ks + j * kD + tx * 4);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row < lq)
      dct::store4(dq + n * lq * hd + h * kD + (size_t)row * hd + tx * 4, acc[i][0],
                  acc[i][1], acc[i][2], acc[i][3]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ o,
                     const float* __restrict__ lse, const T* __restrict__ dout,
                     T* __restrict__ dk, T* __restrict__ dv, int lq, int lk, int heads,
                     float scale) {
  using V = dct::Vec16<T>;
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;             // [kD][kTS]  K^T  (this block's KV tile)
  float* vt = kt + kD * kTS;    // [kD][kTS]  V^T
  float* qt = vt + kD * kTS;    // [kD][kTS]  Q^T  (the current q tile)
  float* dot = qt + kD * kTS;   // [kD][kTS]  dO^T
  float* pb = dot + kD * kTS;   // [kB][kTS]  P^T as [i][j]
  float* dsb = pb + kB * kTS;   // [kB][kTS]  dS^T as [i][j]
  float* qs = dsb + kB * kTS;   // [kB][kD]   Q
  float* dos = qs + kB * kD;    // [kB][kD]   dO
  float* lse_s = dos + kB * kD; // [kB]       lse * log2(e) of the q tile
  float* di_s = lse_s + kB;     // [kB]       rowsum(dO * o) of the q tile

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // owns q columns i (S^T) / dims c (dk, dv) tx*4 ..
  const int ty = tid / 16;  // owns KV rows j ty*4 .. ty*4+3
  const int k0 = blockIdx.x * kB;
  const int h = blockIdx.y;
  const size_t n = blockIdx.z;
  const size_t hd = (size_t)heads * kD;
  const T* qb = q + n * lq * hd + h * kD;
  const T* kb = k + n * lk * hd + h * kD;
  const T* vb = v + n * lk * hd + h * kD;
  const T* ob = o + n * lq * hd + h * kD;
  const T* dob = dout + n * lq * hd + h * kD;
  const float* lseb = lse + (n * heads + h) * lq;

  dct::load_tile<T, true, kThreads>(kt, kb, hd, k0, lk, tid);
  dct::load_tile<T, true, kThreads>(vt, vb, hd, k0, lk, tid);

  const float scale_log2 = scale * kLog2e;
  float dka[4][4], dva[4][4];
  zero4x4(dka);
  zero4x4(dva);
  const int num_q = (lq + kB - 1) / kB;
  for (int qi = 0; qi < num_q; ++qi) {
    const int q0 = qi * kB;
    __syncthreads();  // the previous q tile's reads are done
    dct::load_tile<T, true, kThreads>(qt, qb, hd, q0, lq, tid);
    dct::load_tile<T, false, kThreads>(qs, qb, hd, q0, lq, tid);
    dct::load_tile<T, true, kThreads>(dot, dob, hd, q0, lq, tid);
    dct::load_tile<T, false, kThreads>(dos, dob, hd, q0, lq, tid);
    {
      // di of the 64 rows: 4 threads per row, 16 dims each
      const int r = tid / 4, part = tid % 4, row = q0 + r;
      float sum = 0.f;
      if (row < lq) {
#pragma unroll
        for (int c = 0; c < 16; c += V::kVec) {
          float a[V::kVec], b[V::kVec];
          V::load(ob + (size_t)row * hd + part * 16 + c, a);
          V::load(dob + (size_t)row * hd + part * 16 + c, b);
#pragma unroll
          for (int e = 0; e < V::kVec; ++e) sum = fmaf(a[e], b[e], sum);
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        di_s[r] = sum;
        lse_s[r] = row < lq ? lseb[row] * kLog2e : 0.f;
      }
    }
    __syncthreads();

    // S^T[j][i] = k_j . q_i and dP^T[j][i] = v_j . dO_i
    float s[4][4], dp[4][4];
    zero4x4(s);
    zero4x4(dp);
#pragma unroll 8
    for (int d = 0; d < kD; ++d) {
      fma4x4(s, kt + d * kTS + ty * 4, qt + d * kTS + tx * 4);
      fma4x4(dp, vt + d * kTS + ty * 4, dot + d * kTS + tx * 4);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = tx * 4 + b;
        const float p = q0 + i < lq ? exp2f(s[a][b] * scale_log2 - lse_s[i]) : 0.f;
        s[a][b] = p;
        dp[a][b] = dct::round_to<T>(p * (dp[a][b] - di_s[i]) * scale);  // ds^T
      }
    store_patch_t(pb, s, ty * 4, tx * 4);
    store_patch_t(dsb, dp, ty * 4, tx * 4);
    __syncthreads();

    // dv[j][c] += sum_i p^T[j][i] dO[i][c];  dk[j][c] += sum_i ds^T[j][i] q[i][c]
#pragma unroll 4
    for (int i = 0; i < kB; ++i) {
      fma4x4(dva, pb + i * kTS + ty * 4, dos + i * kD + tx * 4);
      fma4x4(dka, dsb + i * kTS + ty * 4, qs + i * kD + tx * 4);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = k0 + ty * 4 + a;
    if (row < lk) {
      const size_t off = n * lk * hd + h * kD + (size_t)row * hd + tx * 4;
      dct::store4(dk + off, dka[a][0], dka[a][1], dka[a][2], dka[a][3]);
      dct::store4(dv + off, dva[a][0], dva[a][1], dva[a][2], dva[a][3]);
    }
  }
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* o,
                      const float* lse, const void* dout, void* dq, int n, int lq, int lk,
                      int heads, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + kB - 1) / kB, heads, n);
  flash_bwd_dq_kernel<T><<<grid, kThreads, kDqSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), lse, static_cast<const T*>(dout), static_cast<T*>(dq),
      lq, lk, heads, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* o,
                       const float* lse, const void* dout, void* dk, void* dv, int n,
                       int lq, int lk, int heads, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((lk + kB - 1) / kB, heads, n);
  flash_bwd_dkv_kernel<T><<<grid, kThreads, kDkvSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), lse, static_cast<const T*>(dout), static_cast<T*>(dk),
      static_cast<T*>(dv), lq, lk, heads, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dct_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                const void* lse, const void* dout, void* dq, int dtype,
                                int n, int lq, int lk, int heads, float scale,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  if (dtype == dct::kBFloat16)
    return launch_dq<__nv_bfloat16>(q, k, v, o, l, dout, dq, n, lq, lk, heads, scale, s);
  if (dtype == dct::kFloat32)
    return launch_dq<float>(q, k, v, o, l, dout, dq, n, lq, lk, heads, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int dct_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* o,
                                 const void* lse, const void* dout, void* dk, void* dv,
                                 int dtype, int n, int lq, int lk, int heads, float scale,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  if (dtype == dct::kBFloat16)
    return launch_dkv<__nv_bfloat16>(q, k, v, o, l, dout, dk, dv, n, lq, lk, heads, scale, s);
  if (dtype == dct::kFloat32)
    return launch_dkv<float>(q, k, v, o, l, dout, dk, dv, n, lq, lk, heads, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
