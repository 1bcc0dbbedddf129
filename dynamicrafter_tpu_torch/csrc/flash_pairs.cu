// K9: flash-attention forward with two heads per block (sm_90a).
//
// Replaces experiments/flash_pairs/flash_pairs.py::_fwd_kernel_pairs (the
// Pallas kernel behind `flash_attention_pairs`). Same function as K1
// (flash_attention.cu): non-causal softmax(Q K^T * scale) V per head on
// (N, L, H*64) row-major operands, online softmax in fp32, KV positions
// >= Lk masked, l == 0 guarded, p rounded to the input type before the PV
// product, any finite scale (negative included, as the Pallas kernel scales
// the logits before their max).
//
// How heads are assigned, and how that differs from K1: K1 runs one block
// per (query tile, ONE head, n) and moves 64-column head slices. This
// kernel runs one block per (query tile, head PAIR, n): every row it moves
// is 128 columns wide, [head 2p | head 2p+1], 256 contiguous bytes in bf16.
// The Pallas kernel expands K and V into block-diagonal (2*bk, 128) form so
// that one 128-deep product serves both heads on a 128-wide systolic array;
// that has no purpose on Hopper's m16n8k16 products and is not carried
// over: each head's 64-deep products run on its own half of the staging.
//
// Odd H: the last pair has one head. The Pallas wrapper pads the last axis
// to a multiple of 128 columns on the host side; this kernel instead reads
// and writes only the 64 columns of that pair's one head, so no address at
// or beyond column H*64 of a row is touched and no padded copy of q, k, v
// is made.
//
// What bounds it: as K1, arithmetic (4*N*H*Lq*Lk*64 operations against
// 2 or 4 bytes * N*H*64*(2*Lq + 2*Lk)). The input type chooses the kernel:
//
// bf16: `flash_fwd_pairs_tc_kernel`, both products on the tensor cores, the
//   main loop of flash_tc.cuh (K1's, serving two heads from one staged
//   row, bit for bit K1's output). One block of 8 warps per (128-row query
//   tile, pair, n): warps 0-3 on head 2p and 4-7 on head 2p+1, each warp 32
//   query rows as in K1 (two m16 tiles: every K and V fragment taken from
//   shared memory feeds two MMAs). At 255 registers a thread the block is
//   65 280 registers, one block per SM: the same 8 warps per SM as K1's two
//   4-warp blocks. Shared memory: a ring of three K/V slots of 64 rows x
//   136 elements, 102 KB, the Q tile in the last slot. Each head's warps
//   copy their head's 128 bytes of every staged row and wait at a barrier
//   of their own: with one barrier per KV tile for both heads, as the
//   Pallas program shares its grid step, the kernel ran 8-10 % slower.
//   Bring-up timing (PERF.md §6 names the probe; N = 32, NVIDIA H100 80GB
//   HBM3 at 700 W, K1 in the same call): shipped
//   0.999 / 12.019 / 1.509 / 0.253 ms at L = 2560 x 5 heads, 9216 x 5,
//   2304 x 10, 576 x 20 (K1 0.930 / 11.173 / 1.467 / 0.237); one barrier
//   for both heads 1.103 / 13.240 / 1.666 / 0.274; two warps a head (64-row
//   tiles, 4-warp blocks, two blocks per SM) 1.171 / 14.505 / 1.631 /
//   0.234; two ring slots 1-2 % slower than three, four within 1 %.
//   What is left between K9 and K1 follows the block's granularity: 1.07x
//   K1's time at H = 5, where a third of the blocks hold an odd H's
//   one-head last pair (its 4 warps alone on their SM: a block frees its
//   registers only when all its warps are done), 1.03x at H = 10, where
//   none does.
//
// fp32: `flash_fwd_pairs_kernel<float>`, the first version, kept for fp32
//   inputs only (TF32 would drop 13 bits of each operand; the fp32
//   tolerance is 1e-5). One 256-thread block per (64-row Q tile, pair, n);
//   every tile converted to fp32 and transposed in shared memory (134 KB,
//   one block per SM), every thread two independent online softmaxes (a
//   4 x 4 patch per head), products as fp32 FMAs on the SIMT pipes.
#include "flash_tc.cuh"
#include "flash_tile.cuh"

namespace {

constexpr int kD = 64;         // head dim

// ---------------------------------------------------------------------------
// fp32: the FMA kernel
// ---------------------------------------------------------------------------

constexpr int kPW = 2 * kD;    // columns of a pair tile
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key/value rows per KV tile
constexpr int kThreads = 256;  // 16 x 16 threads, a 4 x 4 patch per head each
constexpr int kTS = dct::kTileStride;
// Qt and Kt [128][kTS], Pt [2][64][kTS], V [64][128]
constexpr int kSmemFloats = 2 * kPW * kTS + 2 * kBK * kTS + kBK * kPW;
constexpr int kSmemBytes = kSmemFloats * 4;

// Rows row0 .. row0+63 of a (rows, stride) operand, columns 0 .. 127 of the
// pair, into fp32 shared memory: transposed [col][row] with row stride kTS,
// or plain [row][col] with stride 128. Rows >= nrows and columns >= ncols
// are not read and land as zeros.
template <typename T, bool kTranspose>
__device__ __forceinline__ void load_pair_tile(float* dst, const T* src, size_t stride,
                                               int row0, int nrows, int ncols, int tid) {
  using V = dct::Vec16<T>;
  constexpr int kVec = V::kVec;
  constexpr int kPerRow = kPW / kVec;
  constexpr int kTotal = dct::kTile * kPerRow;
#pragma unroll
  for (int idx = tid; idx < kTotal; idx += kThreads) {
    const int row = kTranspose ? idx % dct::kTile : idx / kPerRow;
    const int vec = kTranspose ? idx / dct::kTile : idx % kPerRow;
    float f[kVec];
    if (row0 + row < nrows && vec * kVec < ncols) {
      V::load(src + (size_t)(row0 + row) * stride + vec * kVec, f);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) f[i] = 0.f;
    }
    if (kTranspose) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) dst[(vec * kVec + i) * kTS + row] = f[i];
    } else {
#pragma unroll
      for (int i = 0; i < kVec; i += 4)
        dct::store4(dst + row * kPW + vec * kVec + i, f[i], f[i + 1], f[i + 2], f[i + 3]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_pairs_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int lq, int lk,
                       int heads, float scale_log2) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;               // [kPW][kTS]    [Q_a | Q_b]^T
  float* kt = qt + kPW * kTS;     // [kPW][kTS]    [K_a | K_b]^T
  float* pt = kt + kPW * kTS;     // [2][kBK][kTS] P_a^T, P_b^T
  float* vs = pt + 2 * kBK * kTS; // [kBK][kPW]    [V_a | V_b]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * kBQ;
  const int h0 = blockIdx.y * 2;
  const int nh = min(2, heads - h0);   // 1 for the last pair of an odd H
  const int ncols = nh * kD;
  const size_t n = blockIdx.z;
  const size_t hd = (size_t)heads * kD;
  const T* qb = q + n * lq * hd + h0 * kD;
  const T* kb = k + n * lk * hd + h0 * kD;
  const T* vb = v + n * lk * hd + h0 * kD;
  T* ob = o + n * lq * hd + h0 * kD;

  load_pair_tile<T, true>(qt, qb, hd, q0, lq, ncols, tid);

  float m[2][4], l[2][4], acc[2][4][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[p][i] = -CUDART_INF_F;
      l[p][i] = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[p][i][c] = 0.f;
    }

  const int num_kv = (lk + kBK - 1) / kBK;
  for (int kv = 0; kv < num_kv; ++kv) {
    const int k0 = kv * kBK;
    __syncthreads();  // the previous tile's P^T and V reads are done
    load_pair_tile<T, true>(kt, kb, hd, k0, lk, ncols, tid);
    load_pair_tile<T, false>(vs, vb, hd, k0, lk, ncols, tid);
    __syncthreads();

#pragma unroll
    for (int p = 0; p < 2; ++p) {
      if (p < nh) {
        float s[4][4], alpha[4];
        dct::qk_patch(qt + p * kD * kTS, kt + p * kD * kTS, ty, tx, s);
        dct::softmax_patch<dct::kSoftmaxExp2, 16>(s, m[p], l[p], alpha, k0 + tx * 4, 1, lk,
                                                  scale_log2);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[p][i][c] *= alpha[i];
        dct::store_pt<T>(pt + p * kBK * kTS, kTS, s, tx * 4, 1, ty);
      }
    }
    __syncthreads();

#pragma unroll
    for (int p = 0; p < 2; ++p)
      if (p < nh) dct::pv_patch(pt + p * kBK * kTS, vs + p * kD, kPW, ty, tx, acc[p]);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row < lq) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        if (p < nh) {
          const float inv = l[p][i] == 0.f ? 1.f : 1.f / l[p][i];
          dct::store4(ob + (size_t)row * hd + p * kD + tx * 4, acc[p][i][0] * inv,
                      acc[p][i][1] * inv, acc[p][i][2] * inv, acc[p][i][3] * inv);
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int n, int lq,
                   int lk, int heads, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_pairs_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + kBQ - 1) / kBQ, (heads + 1) / 2, n);
  flash_fwd_pairs_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lq, lk, heads, scale * dct::kLog2e);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel (flash_tc.cuh's pair tile and grid)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(dct::FlashTcPairTile::kThreads, 1)
flash_fwd_pairs_tc_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                          int lq, int lk, int heads, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  dct::flash_fwd_tc_pairs(q, k, v, o, lq, lk, heads, scale_log2,
                          reinterpret_cast<__nv_bfloat16*>(smem_raw));
}

}  // namespace

extern "C" int dct_flash_fwd_pairs(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int n, int lq, int lk, int heads,
                                   float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dct::kBFloat16)
    return dct::launch_flash_tc_pairs(flash_fwd_pairs_tc_kernel, q, k, v, o, n, lq, lk, heads,
                                      scale * dct::kLog2e, s);
  if (dtype == dct::kFloat32) return launch<float>(q, k, v, o, n, lq, lk, heads, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
