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
// layout as K1 and stores one float per row. K1 and K3 are one template
// per input type; the lse store is compiled in only for K3.
//
// What bounds them: at 320x512 (N = 32, L = 2560, H = 5, D = 64) one call is
// 4*N*H*L^2*D = 268 GFLOP against 4*N*L*H*D*2 = 42 MB of bf16 traffic, i.e.
// ~6400 FLOP per byte -- far above the H100's ~295 FLOP/byte ridge. It is
// bound by arithmetic throughput, never by bytes; K3's lse adds 1.6 MB.
//
// The input type chooses the kernel, and nothing else does:
//
// bf16: `flash_fwd_tc_kernel`, both products on the tensor cores.
//   Grid: one block of four warps per (query tile, head, n); blockIdx.x is
//   the query tile, so the blocks that run together share one (n, h)'s K and
//   V in L2 (2.4 MB at L = 9216). Each warp owns kMTiles x 16 query rows.
//   Q is loaded once with cp.async and then held in registers as ldmatrix A
//   fragments for the whole KV loop (per 16 rows: 4 k-steps x 4 registers).
//   K and V tiles of 64 rows stay bf16 in shared memory, in a ring of
//   kStages cp.async stages: tile k + kStages - 1 is in flight while tile k
//   is multiplied, with one barrier per tile. Rows are padded to 72 elements
//   (144 bytes: the 8 row addresses of an ldmatrix phase fall on disjoint
//   banks), and rows at or past Lk (or Lq) are zero-filled by cp.async's
//   src-size operand, their scores masked to -inf.
//   S = Q K^T is mma.sync m16n8k16 (bf16 in, fp32 accumulators); K stored
//   [kv][d] is already the column-major B operand, so its fragments come
//   from plain ldmatrix. The online softmax runs on the accumulator
//   registers: a row lives on the 4 lanes of a quad, so its max takes two
//   __shfl_xor_sync; the row sum stays per lane until the epilogue (every
//   lane of a quad applies the same rescale factor). scale * log2(e) is
//   folded into one FFMA per logit ahead of exp2f (this needs scale > 0:
//   the running max is taken on raw logits, so the launch refuses any other
//   scale). P never touches shared memory: the fp32 C fragments of two
//   adjacent 8-column tiles, rounded to bf16, are the A fragment of one
//   k16 step of O += P V. That rounding is the Pallas kernels' own
//   (`p.astype(v.dtype)` before the PV product); l sums the unrounded p, as
//   there. V's B fragments come from ldmatrix.trans. The epilogue scales by
//   1/l (l == 0 guarded), rounds to bf16 and stores only rows < Lq; for K3
//   the first lane of each quad writes lse = m * ln 2 + ln l.
//   Error of the rounded p against the fp32 plain version, N(0, 1) inputs,
//   `chip_smoke.py` phases 2, 6 and 11 on an NVIDIA H100 80GB HBM3 (700 W):
//   relative L2 2.26e-3 at (32, 2560, 5*64) and 2.1e-3 to 2.3e-3 at every
//   other shape there, ragged ones included (tolerance 1e-2); lse max abs
//   1.9e-6. The FMA kernel, which kept p in fp32, read 1.66e-3; the flash
//   variants that round p (K6, K9, K10) read 2.34e-3.
//   kMTiles (16-row m tiles per warp) and kStages: see their definitions
//   below for the choice and its reason.
//
// fp32: `flash_fwd_fma_kernel`, the first version, kept for fp32 inputs only
//   (TF32 would drop 13 bits of each operand; the fp32 tolerance is 1e-5).
//   One 256-thread block per (64-row Q tile, head, n); Q, K tiles
//   transposed in shared memory, every thread a 4 x 4 patch of the 64 x 64
//   score tile and of the output tile, products as fp32 FMAs on the SIMT
//   pipes, p kept in fp32.
//
// wgmma with TMA-fed K/V rings and a producer warp is the next step for the
// bf16 kernel.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kD = 64;        // head dim (the wrapper requires 64)
constexpr int kBK = 64;       // key/value rows per KV tile
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// fp32: the FMA kernel
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;       // query rows per block
constexpr int kThreads = 256; // 16 x 16 threads, each a 4 x 4 patch
constexpr int kTS = dct::kTileStride;  // row stride of the transposed tiles
constexpr int kSmemFloats = 3 * kD * kTS + kBK * kD;  // Qt, Kt, Pt, V
constexpr int kSmemBytes = kSmemFloats * 4;

template <bool kLse>
__global__ void __launch_bounds__(kThreads)
flash_fwd_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
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
  const float* qb = q + n * lq * hd + h * kD;
  const float* kb = k + n * lk * hd + h * kD;
  const float* vb = v + n * lk * hd + h * kD;
  float* ob = o + n * lq * hd + h * kD;

  dct::load_tile<float, true, kThreads>(qt, qb, hd, q0, lq, tid);

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
    dct::load_tile<float, true, kThreads>(kt, kb, hd, k0, lk, tid);
    dct::load_tile<float, false, kThreads>(vs, vb, hd, k0, lk, tid);
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
    // p reaches the PV product in fp32 (the fp32 inputs' own type)
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
            l[i] == 0.f ? 0.f : m[i] * kLn2 + logf(l[i]);
    }
  }
}

template <bool kLse>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o, float* lse,
                       int n, int lq, int lk, int heads, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_fma_kernel<kLse>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + kBQ - 1) / kBQ, heads, n);
  flash_fwd_fma_kernel<kLse><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, lq, lk, heads,
      scale * kLog2e);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kStride = kD + 8;   // bf16 per shared row: 144 bytes, conflict-free ldmatrix
// Each warp owns 32 query rows (two m16 tiles, a 128-row block) and the K/V
// ring has two stages. With two m tiles every K and V fragment taken from
// shared memory feeds two MMAs: at 16 rows per warp the ldmatrix traffic
// (512 bytes per x4 against 128 bytes per clock of shared-memory bandwidth)
// costs as much time as the MMAs themselves. The price is registers (Q
// fragments, S and O accumulators for 32 rows: about 250 a thread, no spill,
// as `ptxas -v` reports in `chip_smoke.py` phase 1), which leaves two
// 128-thread blocks per SM; their 55 KB of shared memory would allow four.
// 64-row tiles (half the registers, more blocks per SM) ran slower at all
// three hot shapes in the bring-up runs, and a third stage (74 KB) bought
// nothing over two: with two blocks per SM one block's loads hide behind the
// other's products.
constexpr int kMTiles = 2;
constexpr int kStages = 2;
constexpr int kTcBQ = kTcWarps * 16 * kMTiles;   // query rows per block
constexpr int kTileElems = kBK * kStride;        // one K or V tile
constexpr int kTcSmemBytes = 2 * (2 * kStages * kTileElems + kTcBQ * kStride);

// cp.async of rows row0 .. row0 + kRows - 1 of one head into
// dst[kRows][kStride]; rows >= nvalid are zero-filled.
template <int kRows>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, size_t stride,
                                          int row0, int nvalid, int tid) {
  dct::cp_async_head_rows<kRows, kTcThreads, kStride>(dst, src, stride, row0, nvalid, tid);
}

template <bool kLse>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, int lq, int lk, int heads, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);   // [kStages][kBK][kStride]
  bf16* sv = sk + kStages * kTileElems;           // [kStages][kBK][kStride]
  bf16* sq = sv + kStages * kTileElems;           // [kTcBQ][kStride]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * kTcBQ;
  const int h = blockIdx.y;
  const size_t n = blockIdx.z;
  const size_t hd = (size_t)heads * kD;
  const bf16* kb = k + n * lk * hd + h * kD;
  const bf16* vb = v + n * lk * hd + h * kD;
  const int num_kv = (lk + kBK - 1) / kBK;

  // groups in flight: Q, then KV tiles 0 .. kStages - 2 (empty groups past
  // the last tile keep the count that cp_async_wait relies on)
  load_rows<kTcBQ>(sq, q + n * lq * hd + h * kD, hd, q0, lq, tid);
  dct::cp_async_commit();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < num_kv) {
      load_rows<kBK>(sk + s * kTileElems, kb, hd, s * kBK, lk, tid);
      load_rows<kBK>(sv + s * kTileElems, vb, hd, s * kBK, lk, tid);
    }
    dct::cp_async_commit();
  }
  dct::cp_async_wait<kStages - 1>();
  __syncthreads();

  // ldmatrix roles of this lane: A fragments and V's transposed B fragments
  // take row (lane & 7) + 8 * bit 3 and column 8 * bit 4 of a 16 x 16 block;
  // K's B fragments take row lane & 7 and column 8 * (lane >> 3) of an
  // 8 x 32 block
  const int frow = (lane & 7) + ((lane >> 3) & 1) * 8, fcol = (lane >> 4) * 8;
  const int krow = lane & 7, kcol = (lane >> 3) * 8;
  const int g = lane >> 2, t = lane & 3;   // the mma fragment row and column pair

  uint32_t qf[kMTiles][4][4];   // Q as A fragments: [m tile][k step of 16 dims]
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      dct::ldmatrix_x4(qf[mt][kk],
                       sq + ((warp * kMTiles + mt) * 16 + frow) * kStride + kk * 16 + fcol);

  // per m tile and row half (row g, row g + 8): running max (log2 domain,
  // scaled), this lane's partial row sum, and the output accumulators
  float m[kMTiles][2], l[kMTiles][2], acc[kMTiles][8][4];
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mt][r] = -CUDART_INF_F;
      l[mt][r] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
  }

  int slot = 0, fill = kStages - 1;
  for (int kv = 0; kv < num_kv; ++kv) {
    // tile kv has landed for every thread, and every warp is done with tile
    // kv - 1, whose slot (`fill`) the next load overwrites
    dct::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kv + kStages - 1;
    if (next < num_kv) {
      load_rows<kBK>(sk + fill * kTileElems, kb, hd, next * kBK, lk, tid);
      load_rows<kBK>(sv + fill * kTileElems, vb, hd, next * kBK, lk, tid);
    }
    dct::cp_async_commit();
    const bf16* skt = sk + slot * kTileElems;
    const bf16* svt = sv + slot * kTileElems;
    slot = slot + 1 == kStages ? 0 : slot + 1;
    fill = fill + 1 == kStages ? 0 : fill + 1;

    // S = Q K^T: 8 column tiles of 8 keys, 4 k steps of 16 dims
    float s[kMTiles][8][4];
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t b[4];   // k steps 2 * half and 2 * half + 1 of column tile j
        dct::ldmatrix_x4(b, skt + (j * 8 + krow) * kStride + half * 32 + kcol);
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) {
          dct::mma_bf16(s[mt][j], qf[mt][2 * half], b[0], b[1]);
          dct::mma_bf16(s[mt][j], qf[mt][2 * half + 1], b[2], b[3]);
        }
      }
    }
    const int k0 = kv * kBK;
    if (k0 + kBK > lk) {   // the last tile is ragged: keys >= lk get p = 0
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (k0 + j * 8 + 2 * t + (e & 1) < lk) continue;
#pragma unroll
          for (int mt = 0; mt < kMTiles; ++mt) s[mt][j][e] = -CUDART_INF_F;
        }
    }

    // online softmax on the accumulators; every KV tile holds >= 1 valid
    // key, so the running max is finite after the first tile
    uint32_t pf[kMTiles][4][4];   // p as A fragments: [m tile][k step of 16 keys]
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[mt][j][2 * r], s[mt][j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[mt][r], mx * scale_log2);
        const float alpha = exp2f(m[mt][r] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            s[mt][j][e] = exp2f(fmaf(s[mt][j][e], scale_log2, -m_new));
            sum += s[mt][j][e];
          }
        l[mt][r] = l[mt][r] * alpha + sum;
        m[mt][r] = m_new;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[mt][j][2 * r] *= alpha;
          acc[mt][j][2 * r + 1] *= alpha;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pf[mt][kk][0] = dct::pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        pf[mt][kk][1] = dct::pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        pf[mt][kk][2] = dct::pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        pf[mt][kk][3] = dct::pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
    }

    // O += P V: 4 k steps of 16 keys, 8 column tiles of 8 dims (in pairs)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b[4];   // dims 16 * jp .. + 7 (b[0], b[1]) and + 8 .. + 15 (b[2], b[3])
        dct::ldmatrix_x4_trans(b, svt + (kk * 16 + frow) * kStride + jp * 16 + fcol);
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) {
          dct::mma_bf16(acc[mt][2 * jp], pf[mt][kk], b[0], b[1]);
          dct::mma_bf16(acc[mt][2 * jp + 1], pf[mt][kk], b[2], b[3]);
        }
      }
    }
  }
  dct::cp_async_wait<0>();   // only empty groups remain; leave none behind

  bf16* ob = o + n * lq * hd + h * kD;
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[mt][r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int row = q0 + (warp * kMTiles + mt) * 16 + g + 8 * r;
      if (row >= lq) continue;
      const float inv = sum == 0.f ? 1.f : 1.f / sum;
      bf16* orow = ob + (size_t)row * hd + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
            __floats2bfloat162_rn(acc[mt][j][2 * r] * inv, acc[mt][j][2 * r + 1] * inv);
      // m is in the log2 domain: lse = ln(2^m * l) = m * ln 2 + ln l
      if (kLse && t == 0)
        lse[((size_t)n * heads + h) * lq + row] =
            sum == 0.f ? 0.f : m[mt][r] * kLn2 + logf(sum);
    }
  }
}

template <bool kLse>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, float* lse,
                      int n, int lq, int lk, int heads, float scale, cudaStream_t stream) {
  // the running max is taken on raw logits and scaled after (exact only
  // for a positive scale)
  if (!(scale > 0.f)) return cudaErrorInvalidValue;
  const auto kernel = flash_fwd_tc_kernel<kLse>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kTcSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + kTcBQ - 1) / kTcBQ, heads, n);
  kernel<<<grid, kTcThreads, kTcSmemBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, lq, lk, heads, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dct_flash_fwd(const void* q, const void* k, const void* v, void* o,
                             int dtype, int n, int lq, int lk, int heads,
                             float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dct::kBFloat16)
    return launch_tc<false>(q, k, v, o, nullptr, n, lq, lk, heads, scale, s);
  if (dtype == dct::kFloat32)
    return launch_fma<false>(q, k, v, o, nullptr, n, lq, lk, heads, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int dct_flash_fwd_lse(const void* q, const void* k, const void* v, void* o,
                                 void* lse, int dtype, int n, int lq, int lk, int heads,
                                 float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == dct::kBFloat16)
    return launch_tc<true>(q, k, v, o, l, n, lq, lk, heads, scale, s);
  if (dtype == dct::kFloat32)
    return launch_fma<true>(q, k, v, o, l, n, lq, lk, heads, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* dct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
