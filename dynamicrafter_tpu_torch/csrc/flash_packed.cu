// K6: flash-attention forward on packed rows (sm_90a).
//
// Replaces dynamicrafter_tpu/ops/flash_attention.py::_fwd_kernel_packed (the
// Pallas kernel behind `flash_attention(packed=True)`). Same function as K1
// (flash_attention.cu): non-causal softmax(Q K^T * scale) V per head on
// (N, L, H*64) row-major operands, online softmax in fp32, KV positions
// >= Lk masked, l == 0 guarded, p rounded to the input type before the PV
// product.
//
// The packed idea: whole H*64-wide rows are the unit of data movement, and
// the head is an index into them. How heads are assigned, and how that
// differs from K1: K1 runs one block per (64-row Q tile, ONE head, n); it
// reads 64-column head slices out of the rows (128 bytes of every 640 in
// bf16 at H = 5) and converts them to fp32 transposed tiles. This kernel
// runs one block per (64-row Q tile, GROUP of up to 5 heads, n). The block
// stages the group's contiguous columns of each Q row once and of each K
// and V row once per KV tile, as raw 16-byte copies in the input type (at
// H = 5 whole 640-byte rows, fully coalesced), and then one 128-thread
// warp group per head serves its head out of that staging at column offset
// g*64, all heads of the group at the same time, each with its own online
// softmax state in registers. Nothing is transposed or converted while
// staging; operands are converted to fp32 as the products read them.
//
// Shared memory decides the tile: 64 Q rows and 32 KV rows of a 5-head group
// are 128 x 320 elements (80 KB in bf16, 160 KB in fp32), plus one fp32
// P^T tile per head (43 KB for 5): 125 KB in bf16 and 205 KB in fp32, under
// the 227 KB a block may have. Hence the KV tile of 32 rows (K1: 64) and
// the group limit of 5: H = 10 runs 2 groups of 5, H = 20 runs 4, and a
// head count that does not divide is split as evenly as it goes (H = 7: 4
// and 3); warp groups without a head in the last group only help staging.
//
// What bounds it: arithmetic, as K1 (4*N*H*Lq*Lk*64 operations on the fp32
// SIMT pipes against 2 or 4 bytes * N*H*64*(2*Lq + 2*Lk)).
#include "flash_tile.cuh"

namespace {

constexpr int kD = 64;             // head dim
constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 32;            // key/value rows per KV tile
constexpr int kGroupThreads = 128; // one warp group per head
constexpr int kMaxGroupHeads = 5;  // heads a block serves at once
constexpr int kPS = kBQ + 4;       // row stride of a P^T tile (floats)

// Row stride of the staging in elements: the group's columns plus 16 bytes,
// which keeps rows 16-byte aligned and spreads them over the banks.
template <typename T>
__host__ __device__ constexpr int stage_stride(int gheads) {
  return gheads * kD + dct::Vec16<T>::kVec;
}

template <typename T>
constexpr int smem_bytes(int gheads) {
  return (kBQ + 2 * kBK) * stage_stride<T>(gheads) * (int)sizeof(T) + gheads * kBK * kPS * 4;
}

// Copy `rows` rows of `width` elements (a multiple of 16 bytes) from a
// (rows, gstride) operand into the staging, 16 bytes a thread, lanes along
// the row; rows >= nvalid are not read and land as zeros.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int dstride, const T* src, size_t gstride,
                                           int width, int row0, int rows, int nvalid,
                                           int tid, int nthreads) {
  constexpr int kVec = dct::Vec16<T>::kVec;
  const int per_row = width / kVec;
  for (int idx = tid; idx < rows * per_row; idx += nthreads) {
    const int row = idx / per_row, vec = idx % per_row;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + row < nvalid)
      u = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + row) * gstride + vec * kVec);
    *reinterpret_cast<uint4*>(dst + row * dstride + vec * kVec) = u;
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxGroupHeads * kGroupThreads)
flash_fwd_packed_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o, int lq, int lk,
                        int heads, int gheads, float scale_log2) {
  constexpr int kVec = dct::Vec16<T>::kVec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ws = stage_stride<T>(gheads);
  T* qs = reinterpret_cast<T*>(smem_raw);      // [kBQ][ws]
  T* ks = qs + kBQ * ws;                       // [kBK][ws]
  T* vs = ks + kBK * ws;                       // [kBK][ws]
  float* pts = reinterpret_cast<float*>(vs + kBK * ws);  // [gheads][kBK][kPS]

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;             // gheads * 128
  const int g = tid / kGroupThreads;           // this thread's head in the group
  const int wt = tid % kGroupThreads;
  const int tx = wt % 8;    // score columns tx + 8j; output dims tx*8 .. tx*8+7
  const int ty = wt / 8;    // query rows ty*4 .. ty*4+3
  const int q0 = blockIdx.x * kBQ;
  const int h0 = blockIdx.y * gheads;
  const int nh = min(gheads, heads - h0);      // heads of this block
  const bool active = g < nh;
  const int width = nh * kD;
  const int c0 = g * kD;                       // this head's columns in the staging
  const size_t n = blockIdx.z;
  const size_t hd = (size_t)heads * kD;
  const T* qb = q + n * lq * hd + h0 * kD;
  const T* kb = k + n * lk * hd + h0 * kD;
  const T* vb = v + n * lk * hd + h0 * kD;
  T* ob = o + n * lq * hd + h0 * kD + c0;
  float* pt = pts + g * kBK * kPS;

  stage_rows<T>(qs, ws, qb, hd, width, q0, kBQ, lq, tid, nthreads);

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }

  const int num_kv = (lk + kBK - 1) / kBK;
  for (int kv = 0; kv < num_kv; ++kv) {
    const int k0 = kv * kBK;
    __syncthreads();  // the previous tile's P^T and V reads are done
    stage_rows<T>(ks, ws, kb, hd, width, k0, kBK, lk, tid, nthreads);
    stage_rows<T>(vs, ws, vb, hd, width, k0, kBK, lk, tid, nthreads);
    __syncthreads();  // (on the first tile also: the Q staging is complete)

    if (active) {
      // S = Q K^T on rows ty*4+i, columns tx+8j, four elements of d a step
      float s[4][4], alpha[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int d0 = 0; d0 < kD; d0 += 4) {
        float kf[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) dct::load4(ks + (tx + 8 * j) * ws + c0 + d0, kf[j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float qf[4];
          dct::load4(qs + (ty * 4 + i) * ws + c0 + d0, qf);
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[i][j] = fmaf(qf[e], kf[j][e], s[i][j]);
        }
      }
      dct::softmax_patch<dct::kSoftmaxExp2, 8>(s, m, l, alpha, k0 + tx, 8, lk, scale_log2);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] *= alpha[i];
      dct::store_pt<T>(pt, kPS, s, tx, 8, ty);
    }
    __syncthreads();

    if (active) {
#pragma unroll 8
      for (int j = 0; j < kBK; ++j) {
        const float4 a = *reinterpret_cast<const float4*>(pt + j * kPS + ty * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        float vf[8];
#pragma unroll
        for (int c = 0; c < 8; c += kVec)
          dct::Vec16<T>::load(vs + j * ws + c0 + tx * 8 + c, vf + c);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(av[i], vf[c], acc[i][c]);
      }
    }
  }

  if (active) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      if (row < lq) {
        const float inv = l[i] == 0.f ? 1.f : 1.f / l[i];
        float out[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) out[c] = acc[i][c] * inv;
#pragma unroll
        for (int c = 0; c < 8; c += kVec)
          dct::Vec16<T>::store(ob + (size_t)row * hd + tx * 8 + c, out + c);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int n, int lq,
                   int lk, int heads, float scale, cudaStream_t stream) {
  const int ngroups = (heads + kMaxGroupHeads - 1) / kMaxGroupHeads;
  const int gheads = (heads + ngroups - 1) / ngroups;
  const int smem = smem_bytes<T>(gheads);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_packed_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + kBQ - 1) / kBQ, (heads + gheads - 1) / gheads, n);
  flash_fwd_packed_kernel<T><<<grid, gheads * kGroupThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lq, lk, heads, gheads, scale * dct::kLog2e);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dct_flash_fwd_packed(const void* q, const void* k, const void* v, void* o,
                                    int dtype, int n, int lq, int lk, int heads,
                                    float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dct::kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, o, n, lq, lk, heads, scale, s);
  if (dtype == dct::kFloat32) return launch<float>(q, k, v, o, n, lq, lk, heads, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
