// K2: temporal self-attention over a short T axis, for Hopper (sm_90a).
//
// Replaces dynamicrafter_tpu/ops/small_attention.py::_kernel_tmajor (the
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
    const T* qrow = sq + (gl * tlen + t1) * dp;
    float s[kMaxT];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int t2 = 0; t2 < kMaxT; ++t2) {
      if (t2 < tlen) {
        const T* krow = sk + (gl * tlen + t2) * dp;
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
    T* orow = sq + (gl * tlen + t1) * dp;  // only this thread reads this q row
    for (int c = 0; c < d; c += kVec) {
      float acc[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
#pragma unroll
      for (int t2 = 0; t2 < kMaxT; ++t2) {
        if (t2 < tlen) {
          float vv[kVec];
          V::load(sv + (gl * tlen + t2) * dp + c, vv);
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[e] = fmaf(s[t2], vv[e], acc[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] *= inv;
      V::store(orow + c, acc);
    }
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
