// K6: flash-attention forward on packed rows (sm_90a).
//
// Replaces dynamicrafter_tpu/ops/flash_attention.py::_fwd_kernel_packed (the
// Pallas kernel behind `flash_attention(packed=True)`). Same function as K1
// (flash_attention.cu): non-causal softmax(Q K^T * scale) V per head on
// (N, L, H*64) row-major operands, online softmax in fp32, KV positions
// >= Lk masked, l == 0 guarded, p rounded to the input type before the PV
// product, any finite scale (negative included, as the Pallas kernel scales
// the logits before their max).
//
// The packed idea: whole multi-head rows are the unit of data movement, and
// the head is an index into them. How heads are assigned, and how that
// differs from K1: K1 runs one block per (query tile, ONE head, n) and
// reads 64-column head slices out of the rows (128 bytes of every 640 in
// bf16 at H = 5). This kernel runs one block per (query tile, GROUP of
// heads, n). The block stages the group's contiguous columns of each Q row
// once and of each K and V row once per KV tile, and serves each head out
// of that staging at column offset g*64, all heads of the group at the same
// time. In fp32 a head count that does not divide into groups of the
// largest size is split as evenly as it goes (groups of up to 5: H = 7 as 4
// and 3); in bf16 the groups are head pairs (H = 5 as 2, 2 and 1).
//
// What bounds it: arithmetic, as K1 (4*N*H*Lq*Lk*64 operations against 2 or
// 4 bytes * N*H*64*(2*Lq + 2*Lk)). The input type chooses the kernel:
//
// bf16: `flash_fwd_packed_tc_kernel`, both products on the tensor cores,
//   the main loop of flash_tc.cuh (K1's, serving several heads from one
//   staged row, bit for bit K1's output) with K9's tile and grid: one block
//   of 8 warps per (128-row query tile, head pair, n), 4 warps a head, 32
//   query rows a warp, each head's warps copying their own columns and
//   meeting at a barrier of their own. Bring-up timing chose the pair over
//   wider groups. The register file bounds the group and the rows per warp:
//   K1's 32 rows a warp (two m16 tiles, every K and V fragment feeding two
//   MMAs) take about 250 registers a thread, so 65 536 registers hold 8
//   such warps per SM: 4 warps a head fits 2 heads a block, 2 warps a head
//   (64-row tiles) 4 heads, 1 warp 8 heads; 16 rows a warp take 128-173
//   registers but double the ldmatrix traffic per MMA. Timed (PERF.md §6
//   names the probe) at N = 32 on NVIDIA H100 80GB HBM3 at 700 W, at L = 2560 x 5 heads, 9216 x 5,
//   2304 x 10 and 576 x 20, with K1 0.930 / 11.173 / 1.467 / 0.237 ms in the
//   same call: groups of up to 2 heads of 4 warps x 32 rows 0.996 / 12.056 /
//   1.510 / 0.252 ms; up to 4 heads of 2 warps x 32 rows 1.202 / 14.672 /
//   1.586 / 0.234 (H = 5 splits 3 + 2: a 6-warp block, one per SM); 1 warp
//   x 32 rows 2.288 / 27.729 / 2.931 / 0.376 (32-row tiles: K and V staged
//   four times as often); 4 warps x 16 rows 1.123 / 13.853 / 1.938 / 0.275,
//   spilling at 3 and 4 heads; one head a block (K1's tile through this
//   loop) 0.921 / 11.115 / 1.424 / 0.231, the fastest of all. One barrier
//   per KV tile for the whole group ran 9-12 % slower with pairs and 23-34 %
//   with groups of up to 4. Staging wider rows for more heads bought nothing
//   on the tensor cores, so K6 keeps the pair, as K9.
//
// fp32: `flash_fwd_packed_kernel<float>`, the first version, kept for fp32
//   inputs only (TF32 would drop 13 bits of each operand; the fp32 tolerance
//   is 1e-5). One 128-thread warp group per head of a group of up to 5; raw
//   16-byte copies of 64 Q rows and 32 KV rows of the group's columns (at
//   H = 5 whole 640-byte rows), operands converted to fp32 as the products
//   read them, one fp32 P^T tile per head in shared memory (205 KB at 5
//   heads, hence the KV tile of 32 rows), products as fp32 FMAs on the SIMT
//   pipes.
#include "flash_tc.cuh"
#include "flash_tile.cuh"

namespace {

constexpr int kD = 64;             // head dim

// ---------------------------------------------------------------------------
// fp32: the FMA kernel
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel (flash_tc.cuh's pair tile and grid)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(dct::FlashTcPairTile::kThreads, 1)
flash_fwd_packed_tc_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                           int lq, int lk, int heads, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  dct::flash_fwd_tc_pairs(q, k, v, o, lq, lk, heads, scale_log2,
                          reinterpret_cast<__nv_bfloat16*>(smem_raw));
}

}  // namespace

extern "C" int dct_flash_fwd_packed(const void* q, const void* k, const void* v, void* o,
                                    int dtype, int n, int lq, int lk, int heads,
                                    float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dct::kBFloat16)
    return dct::launch_flash_tc_pairs(flash_fwd_packed_tc_kernel, q, k, v, o, n, lq, lk, heads,
                                      scale * dct::kLog2e, s);
  if (dtype == dct::kFloat32) return launch<float>(q, k, v, o, n, lq, lk, heads, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
