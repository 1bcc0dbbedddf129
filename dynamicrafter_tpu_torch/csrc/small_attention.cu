// K2 and K5: self-attention over a short token axis T <= 32, for Hopper
// (sm_90a). Both compute, for one head of one group of T tokens, softmax
// over T of the T x T logits q k^T * scale (fp32), times v; they differ in
// the memory layout they read in place, and so in how a block gathers its
// rows. The per-row arithmetic (`attend_row`) is shared.
//
// K2, time-major (B, T, G, H*D): the UNet's temporal transformers.
// K5, position-major (G, T, H*D): spatial self-attention over a tiny frame
// (the 4 x 4 middle block of the 256 x 256 model), see further down.
//
// K2 replaces dynamicrafter_tpu/ops/small_attention.py::_kernel_tmajor (the
// Pallas kernel behind `_small_t_fwd_tmajor`). Same function: for every
// (b, g, head) column of a time-major (B, T, G, H*D) tensor, softmax over
// T of the T x T logits q k^T * scale (fp32), times v, written back in the
// same layout. The TPU kernel's 128 x 128 packed tile and stripe mask were
// a v5e matrix-unit detail and are not carried over.
//
// What bounds it: each call reads q, k, v and writes o once, 4*B*T*G*H*D
// elements (210 MB in bf16 at the 320x512 level-0 shape B = 2, T = 16,
// G = 2560, H*D = 320) for only 4*B*G*H*T^2*D = 1.7 GFLOP: ~8 FLOP per
// byte, far below the ~295 FLOP/byte ridge. It is bound by bytes.
//
// Design: one block per (tile of GT positions g, head, b), GT*T threads,
// one thread per query row. The block reads its T x GT x D slices of q, k
// and v into shared memory with coalesced 16-byte loads (each element of
// each tensor is read exactly once over the grid), forms its row of T fp32
// logits, takes the softmax in registers, writes the output row over its
// own (now dead) q row in shared memory, and the block stores the result
// with coalesced 16-byte writes. Rows are padded by 16 bytes so the
// per-thread row reads hit distinct banks.
#include "common.cuh"

namespace {

constexpr int kMaxT = 32;
constexpr int kThreadsTarget = 128;

// One query row against the T key and value rows of its group, all in
// shared memory with row stride dp: T fp32 logits in registers, softmax,
// then p v accumulated in fp32. The result overwrites the query row (only
// this thread reads it). kRoundP rounds the normalised probabilities to T
// before the second product, as `att.astype(v.dtype)` does in the Pallas
// kernels and their XLA references; without it p stays fp32 and the
// normalisation is applied to the accumulated row.
template <typename T, bool kRoundP>
__device__ __forceinline__ void attend_row(T* qrow, const T* krows, const T* vrows,
                                           int tlen, int d, int dp, float scale) {
  using V = dct::Vec16<T>;
  constexpr int kVec = V::kVec;
  float s[kMaxT];
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int t2 = 0; t2 < kMaxT; ++t2) {
    if (t2 < tlen) {
      const T* krow = krows + t2 * dp;
      float acc = 0.f;
      for (int c = 0; c < d; c += kVec) {
        float a[kVec], b[kVec];
        V::load(qrow + c, a);
        V::load(krow + c, b);
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc = fmaf(a[e], b[e], acc);
      }
      s[t2] = acc * scale;
      mx = fmaxf(mx, s[t2]);
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int t2 = 0; t2 < kMaxT; ++t2) {
    if (t2 < tlen) {
      s[t2] = __expf(s[t2] - mx);
      sum += s[t2];
    }
  }
  const float inv = 1.f / sum;
  if (kRoundP) {
#pragma unroll
    for (int t2 = 0; t2 < kMaxT; ++t2)
      if (t2 < tlen) s[t2] = dct::round_to<T>(s[t2] * inv);
  }
  for (int c = 0; c < d; c += kVec) {
    float acc[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
#pragma unroll
    for (int t2 = 0; t2 < kMaxT; ++t2) {
      if (t2 < tlen) {
        float vv[kVec];
        V::load(vrows + t2 * dp + c, vv);
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[e] = fmaf(s[t2], vv[e], acc[e]);
      }
    }
    if (!kRoundP) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] *= inv;
    }
    V::store(qrow + c, acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreadsTarget)
small_t_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o, int tlen, int g,
               int heads, int d, int gt, float scale) {
  using V = dct::Vec16<T>;
  constexpr int kVec = V::kVec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dp = d + kVec;       // padded row (elements)
  const int rows = gt * tlen;    // row r = gl * tlen + t
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* sk = sq + rows * dp;
  T* sv = sk + rows * dp;

  const int g0 = blockIdx.x * gt;
  const int h = blockIdx.y;
  const size_t hd = (size_t)heads * d;
  const size_t base = (size_t)blockIdx.z * tlen * g * hd + (size_t)h * d;
  const int nvec = d / kVec;
  const int total = rows * nvec;

  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int r = idx / nvec, c = idx % nvec;
    const int gl = r / tlen, t = r % tlen;
    uint4 a = make_uint4(0, 0, 0, 0), b = a, cv = a;
    if (g0 + gl < g) {
      const size_t off = base + ((size_t)t * g + g0 + gl) * hd + c * kVec;
      a = *reinterpret_cast<const uint4*>(q + off);
      b = *reinterpret_cast<const uint4*>(k + off);
      cv = *reinterpret_cast<const uint4*>(v + off);
    }
    *reinterpret_cast<uint4*>(sq + r * dp + c * kVec) = a;
    *reinterpret_cast<uint4*>(sk + r * dp + c * kVec) = b;
    *reinterpret_cast<uint4*>(sv + r * dp + c * kVec) = cv;
  }
  __syncthreads();

  const int gl = threadIdx.x / tlen;
  const int t1 = threadIdx.x % tlen;
  if (g0 + gl < g) {
    const int r0 = gl * tlen;
    attend_row<T, false>(sq + (r0 + t1) * dp, sk + r0 * dp, sv + r0 * dp, tlen, d, dp,
                         scale);
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int r = idx / nvec, c = idx % nvec;
    const int gl2 = r / tlen, t = r % tlen;
    if (g0 + gl2 < g) {
      const size_t off = base + ((size_t)t * g + g0 + gl2) * hd + c * kVec;
      *reinterpret_cast<uint4*>(o + off) =
          *reinterpret_cast<const uint4*>(sq + r * dp + c * kVec);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b,
                   int tlen, int g, int heads, int d, float scale,
                   cudaStream_t stream) {
  constexpr int kVec = dct::Vec16<T>::kVec;
  if (tlen < 1 || tlen > kMaxT || d % kVec != 0) return cudaErrorInvalidValue;
  const int gt = kThreadsTarget / tlen > 0 ? kThreadsTarget / tlen : 1;
  const int smem = 3 * gt * tlen * (d + kVec) * (int)sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      small_t_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g + gt - 1) / gt, heads, b);
  small_t_kernel<T><<<grid, gt * tlen, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), tlen, g, heads, d, gt, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K5: the position-major layout (G, T, H*D).
//
// Replaces dynamicrafter_tpu/ops/small_attention.py::_kernel (the Pallas
// kernel behind `_small_t_fwd` / `small_t_attention`): each of G rows owns
// a contiguous (T, H*D) slab and attends over its own T tokens, per head.
// Probabilities are rounded to the input type before p v, as in that kernel.
// Its 128 x 128 packed tile and block-diagonal mask were a v5e matrix-unit
// detail and are not carried over.
//
// What bounds it: 4*G*T*H*D elements moved for 4*G*H*T^2*D FLOP, 2*T/itemsize
// = 16 FLOP per byte at T = 16 in bf16: bytes. At the shape the 256 x 256
// model gives it with 8 clips under batched CFG (G = 256, T = 16, H = 20,
// D = 64, bf16) that is 42 MB, about 12.5 us at 3.35 TB/s.
//
// Design: one block per (tile of GT rows g, head), GT*T threads, one thread
// per query token. A tile's GT*T tokens are consecutive rows of the
// (G*T, H*D) matrix, so the block copies rows g0*T .. of its head's D-wide
// column slice into shared memory with 16-byte loads (one head's row is 128
// contiguous bytes in bf16), runs `attend_row`, and copies the result back
// the same way. The last tile is ragged when GT does not divide G.
template <typename T>
__global__ void __launch_bounds__(kThreadsTarget)
small_t_posmajor_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o, int g, int tlen,
                        int heads, int d, int gt, float scale) {
  using V = dct::Vec16<T>;
  constexpr int kVec = V::kVec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dp = d + kVec;
  const int g0 = blockIdx.x * gt;
  const int gvalid = min(gt, g - g0);
  const int rows = gvalid * tlen;  // tile row r = gl * tlen + t
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* sk = sq + gt * tlen * dp;
  T* sv = sk + gt * tlen * dp;

  const size_t hd = (size_t)heads * d;
  const size_t base = (size_t)g0 * tlen * hd + (size_t)blockIdx.y * d;
  const int nvec = d / kVec;
  const int total = rows * nvec;

  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int r = idx / nvec, c = idx % nvec;
    const size_t off = base + (size_t)r * hd + c * kVec;
    *reinterpret_cast<uint4*>(sq + r * dp + c * kVec) =
        *reinterpret_cast<const uint4*>(q + off);
    *reinterpret_cast<uint4*>(sk + r * dp + c * kVec) =
        *reinterpret_cast<const uint4*>(k + off);
    *reinterpret_cast<uint4*>(sv + r * dp + c * kVec) =
        *reinterpret_cast<const uint4*>(v + off);
  }
  __syncthreads();

  if ((int)threadIdx.x < rows) {
    const int r0 = (threadIdx.x / tlen) * tlen;
    attend_row<T, true>(sq + threadIdx.x * dp, sk + r0 * dp, sv + r0 * dp, tlen, d, dp,
                        scale);
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int r = idx / nvec, c = idx % nvec;
    *reinterpret_cast<uint4*>(o + base + (size_t)r * hd + c * kVec) =
        *reinterpret_cast<const uint4*>(sq + r * dp + c * kVec);
  }
}

template <typename T>
cudaError_t launch_posmajor(const void* q, const void* k, const void* v, void* o, int g,
                            int tlen, int heads, int d, float scale,
                            cudaStream_t stream) {
  constexpr int kVec = dct::Vec16<T>::kVec;
  if (g < 1 || tlen < 1 || tlen > kMaxT || heads < 1 || heads > 65535 || d < kVec ||
      d % kVec != 0)
    return cudaErrorInvalidValue;
  const int gt = kThreadsTarget / tlen;
  const int smem = 3 * gt * tlen * (d + kVec) * (int)sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      small_t_posmajor_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g + gt - 1) / gt, heads);
  small_t_posmajor_kernel<T><<<grid, gt * tlen, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), g, tlen, heads, d, gt, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dct_small_t_fwd(const void* q, const void* k, const void* v, void* o,
                               int dtype, int b, int tlen, int g, int heads, int d,
                               float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dct::kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, o, b, tlen, g, heads, d, scale, s);
  if (dtype == dct::kFloat32)
    return launch<float>(q, k, v, o, b, tlen, g, heads, d, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int dct_small_t_fwd_posmajor(const void* q, const void* k, const void* v,
                                        void* o, int dtype, int g, int tlen, int heads,
                                        int d, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dct::kBFloat16)
    return launch_posmajor<__nv_bfloat16>(q, k, v, o, g, tlen, heads, d, scale, s);
  if (dtype == dct::kFloat32)
    return launch_posmajor<float>(q, k, v, o, g, tlen, heads, d, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
