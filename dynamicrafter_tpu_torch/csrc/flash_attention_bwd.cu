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
// Ragged KV columns get p = 0 in K4a and ragged q rows p = 0 in K4b, as in
// the Pallas kernels. Operands keep the forward's transpose-free (N, L, H*64)
// layout and lse is (N, H, Lq) fp32 in the natural-log domain: the
// head-major transposes and the 128-lane lse copy of the Pallas path are not
// carried over. The Pallas kernels carry dq (or dk, dv) across the
// sequential innermost grid axis; on the card blocks run in no order, so
// each block owns its output tile outright and loops over the other
// sequence itself: no atomics, no second pass, deterministic results. The
// input type chooses the kernel, and nothing else does.
//
// What bounds them: at 320x512 (N = 32, L = 2560, H = 5, D = 64) K4a does
// 6*N*H*L^2*D = 403 GFLOP and K4b 8*N*H*L^2*D = 537 GFLOP per call, against
// ~80 MB of bf16 operands: thousands of FLOP per byte, far above the
// ~295 FLOP/byte ridge. They are bound by arithmetic, like K1.
//
// bf16: `flash_bwd_di_kernel`, then `flash_bwd_dq_tc_kernel` and
//   `flash_bwd_dkv_tc_kernel`, every product on the tensor cores.
//   di pre-pass: di = rowsum(dO * o) as (N, H, Lq) fp32, once per backward
//   (the wrapper `flash_bwd` launches it once for both kernels); eight lanes
//   per head row, each one 16-byte load of o and of dO. Both kernels read di
//   and never touch o; the FMA version recomputed di in every K4b block for
//   every q tile, reading all of o L/64 times per (n, h).
//   Grid: K4a one block of four warps per (64-row query tile, head, n), K4b
//   one per (64-row KV tile, head, n); blockIdx.x is the owned tile, so the
//   blocks that run together share one (n, h)'s streamed operands in L2.
//   Each warp owns 16 rows of the owned tile.
//   K4a: Q and dO are loaded once with cp.async and held in registers as
//   ldmatrix A fragments for the whole KV loop (per operand 4 k steps of 16
//   dims x 4 registers); -lse * log2(e) and di of the lane's two rows (g,
//   g + 8) sit in registers. K and V tiles of 64 rows stream through a ring
//   of kStages cp.async stages in shared memory (tile k + 1 in flight while
//   tile k is multiplied, one barrier per tile). Per tile: S = Q K^T and
//   dP = dO V^T as mma.sync m16n8k16 (bf16 in, fp32 accumulators); K and V
//   stored [kv][d] are already the column-major B operand (plain
//   ldmatrix). p = exp2(s * scale * log2(e) - lse * log2(e)) is one FFMA
//   and one exp2f per element on the accumulators; keys >= Lk get p = 0; ds
//   = p (dp - di) scale. ds rounded to bf16 is repacked from the C
//   fragments of two adjacent 8-key tiles into the A fragment of one k16
//   step of dQ += dS K, whose B fragments come from ldmatrix.trans of the
//   same K tile. dS never touches shared memory. The epilogue rounds dQ to
//   bf16 and stores only rows < Lq.
//   K4b: the transpose of the same arithmetic. K and V of the owned tile
//   stay in shared memory and are taken as A fragments again for each q
//   tile (held in registers beside the dK and dV accumulators they made
//   the kernel spill). Q, dO, lse and di tiles of the q sweep stream
//   through the ring (lse and di by 4-byte cp.async: a row of (N, H, Lq) is
//   not 16-byte aligned for every Lq). S^T = K Q^T and dP^T = V dO^T with Q
//   and dO as B operands by plain ldmatrix; in a C fragment column i is
//   query row q0 + i, so lse and di are read per column from shared memory
//   (one float2 per 8-column tile); query rows >= Lq get p = 0. dV += P^T
//   dO and dK += dS^T Q take the repacked C fragments as A and B from
//   ldmatrix.trans of dO and of Q. The epilogue stores only rows < Lk.
//   Shared rows are padded to 72 elements (144 bytes: the 8 row addresses
//   of an ldmatrix phase fall on disjoint banks), and rows at or past Lq
//   (or Lk) are zero-filled by cp.async's src-size operand, so no NaN can
//   come of 0 x garbage.
//   Scale: the backward takes lse as given and keeps no running max, so any
//   scale is exact (K1's scale > 0 rule does not apply; a card test runs
//   0.3 and -0.125).
//   Rounding: q, k, v and dO are bf16 already and ds is rounded by the
//   Pallas formula itself; the one rounding the Pallas kernel does not make
//   is p's before dV += P^T dO (it keeps p in fp32 there), and an m16n8k16
//   product needs it. p is rounded to bf16 for that product only, the
//   rounding K1 makes in its PV product; the sums stay fp32. Against the
//   fp32 plain version, N(0, 1) inputs, `chip_smoke.py` phase 7 on an
//   NVIDIA H100 80GB HBM3 (700 W): dv relative L2 2.340e-3 at (32, 2560,
//   5*64) (the FMA kernel, p in fp32, read 1.659e-3), dq 2.385e-3, dk
//   2.346e-3, and 2.33e-3 to 2.40e-3 at the ragged shapes (tolerance
//   2e-2). Splitting p into hi + lo bf16 halves (a fifth product) was the
//   fallback above 5e-3 for dv; it was not needed.
//   Times there (CUDA events, bf16, (32, 2560, 5*64)): K4a 1.512 ms (266
//   TFLOP/s, bound 0.407 ms), K4b 1.863 ms (288 TFLOP/s, bound 0.543 ms),
//   the pre-pass 0.050 ms (bound 0.032 ms, by bytes); together 2.09x the
//   library's backward (`F.scaled_dot_product_attention`, 1.641 ms for dq,
//   dk and dv). The FMA versions took 13.759 and 24.554 ms.
//   Tiles and registers (`ptxas -v`, chip_smoke.py phase 1): 16 rows per
//   warp because 32 do not fit (K4a would hold Q, dO, S, dP and dQ for two
//   m tiles), four warps, two stages. Tried on the card in the bring-up
//   (a probe that was not kept): __launch_bounds__ minimum of 3 blocks per
//   SM (K4a at 168 registers ran faster, but spilled, and so did K4b); a
//   third stage (K4b spilled, no gain); eight warps per block (no spill,
//   slower); dO reloaded per tile in K4a (no spill, slower). The kept
//   configuration is the fastest without spill.
//
// fp32: `flash_bwd_dq_kernel` and `flash_bwd_dkv_kernel`, the first
//   version, kept for fp32 inputs only (TF32 would drop 13 bits of each
//   operand; the fp32 tolerance is 1e-4). One 256-thread block per (64-row
//   tile, head, n); tiles in fp32 shared memory in the layout each product
//   reads with 16-byte loads, every thread a 4 x 4 patch of each 64 x 64
//   product, products as fp32 FMAs, di computed in the kernel, p kept in
//   fp32, ds rounded to the input dtype before its products.
//
// wgmma with TMA-fed rings and a producer warp is the next step for the
// bf16 kernels, as for K1/K3.
#include "common.cuh"
#include "mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// fp32: the FMA kernels
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels and the di pre-pass
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kStride = kD + 8;   // bf16 per shared row: 144 bytes, conflict-free ldmatrix
// Each warp owns 16 rows of the block's own tile (query rows in K4a, KV rows
// in K4b): with 32 the live accumulators (S, dP and dQ, or S, dP, dK and dV,
// for two m tiles) would not fit in 255 registers. The streamed tile is 64
// rows wide and the ring has two stages.
constexpr int kTcRows = kTcWarps * 16;   // rows a block owns
constexpr int kTcCols = 64;              // rows of each streamed tile
constexpr int kStages = 2;
constexpr int kTileElems = kTcCols * kStride;
constexpr int kOwnElems = kTcRows * kStride;
// K4a: K and V rings, then Q and dO. K4b: Q and dO rings, the ring of lse
// and di (fp32), then K and V.
constexpr int kDqTcSmemBytes = 2 * (2 * kStages * kTileElems + 2 * kOwnElems);
constexpr int kDkvTcSmemBytes =
    2 * (2 * kStages * kTileElems + 2 * kOwnElems) + 4 * 2 * kStages * kTcCols;

template <int kRows>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, size_t stride,
                                          int row0, int nvalid, int tid) {
  dct::cp_async_head_rows<kRows, kTcThreads, kStride>(dst, src, stride, row0, nvalid, tid);
}

// The fp32 C fragments of 8 column tiles, rounded to bf16 and packed as the A
// fragments of 4 k steps of 16: tiles 2 kk and 2 kk + 1 give k step kk.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&c)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = dct::pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = dct::pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = dct::pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = dct::pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// c[8][4] = a (16 x 64, A fragments) times the transpose of the 64-row tile
// `tile` ([row][d], stride kStride): 8 column tiles of 8 rows, 4 k steps of
// 16 dims. A tile stored [row][d] is already the column-major B operand, so
// its fragments come from plain ldmatrix: this lane supplies row lane & 7 and
// column 8 * (lane >> 3) of an 8 x 32 block.
__device__ __forceinline__ void mma_abt(float (&c)[8][4], const uint32_t (&a)[4][4],
                                        const bf16* tile, int lane) {
  const int brow = lane & 7, bcol = (lane >> 3) * 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t b[4];   // k steps 2 * half and 2 * half + 1 of column tile j
      dct::ldmatrix_x4(b, tile + (j * 8 + brow) * kStride + half * 32 + bcol);
      dct::mma_bf16(c[j], a[2 * half], b[0], b[1]);
      dct::mma_bf16(c[j], a[2 * half + 1], b[2], b[3]);
    }
  }
}

// acc[8][4] += a (16 x 64 over the tile's rows, A fragments) times the 64-row
// tile `tile` ([row][d]): 4 k steps of 16 rows, 8 column tiles of 8 dims. The
// contraction runs over the tile's rows, so B comes from ldmatrix.trans: this
// lane supplies row (lane & 7) + 8 * bit 3 and column 8 * bit 4 of a 16 x 16
// block, and receives dims 16 jp .. + 7 in b[0], b[1] and + 8 .. + 15 in
// b[2], b[3].
__device__ __forceinline__ void mma_ab(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                       const bf16* tile, int lane) {
  const int frow = (lane & 7) + ((lane >> 3) & 1) * 8, fcol = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t b[4];
      dct::ldmatrix_x4_trans(b, tile + (kk * 16 + frow) * kStride + jp * 16 + fcol);
      dct::mma_bf16(acc[2 * jp], a[kk], b[0], b[1]);
      dct::mma_bf16(acc[2 * jp + 1], a[kk], b[2], b[3]);
    }
  }
}

// A fragments of the 16 x 64 block at row r0 of a [row][d] tile: 4 k steps
// of 16 dims; this lane supplies row (lane & 7) + 8 * bit 3 and column
// 8 * bit 4 of each 16 x 16 block.
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const bf16* tile, int r0,
                                       int lane) {
  const int frow = (lane & 7) + ((lane >> 3) & 1) * 8, fcol = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    dct::ldmatrix_x4(a[kk], tile + (r0 + frow) * kStride + kk * 16 + fcol);
}

// Rows g and g + 8 (g = lane / 4) of a warp's 16 x 64 fp32 accumulators, as
// bf16, into rows row0 + g and row0 + g + 8 of `out` (row stride hd), only
// those < nvalid.
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[8][4], int row0,
                                           int nvalid, size_t hd, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= nvalid) continue;
    bf16* orow = out + (size_t)row * hd + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(acc[j][2 * r], acc[j][2 * r + 1]);
  }
}

__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const float* __restrict__ lse,
                       const float* __restrict__ di, const bf16* __restrict__ dout,
                       bf16* __restrict__ dq, int lq, int lk, int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);   // [kStages][kTcCols][kStride]
  bf16* sv = sk + kStages * kTileElems;           // [kStages][kTcCols][kStride]
  bf16* sq = sv + kStages * kTileElems;           // [kTcRows][kStride]
  bf16* sdo = sq + kOwnElems;                     // [kTcRows][kStride]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * kTcRows;
  const int h = blockIdx.y;
  const size_t n = blockIdx.z;
  const size_t hd = (size_t)heads * kD;
  const size_t qoff = n * lq * hd + h * kD;
  const bf16* kb = k + n * lk * hd + h * kD;
  const bf16* vb = v + n * lk * hd + h * kD;
  const int num_kv = (lk + kTcCols - 1) / kTcCols;

  // groups in flight: Q and dO, then KV tiles 0 .. kStages - 2 (empty
  // groups past the last tile keep the count that cp_async_wait relies on)
  load_rows<kTcRows>(sq, q + qoff, hd, q0, lq, tid);
  load_rows<kTcRows>(sdo, dout + qoff, hd, q0, lq, tid);
  dct::cp_async_commit();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < num_kv) {
      load_rows<kTcCols>(sk + s * kTileElems, kb, hd, s * kTcCols, lk, tid);
      load_rows<kTcCols>(sv + s * kTileElems, vb, hd, s * kTcCols, lk, tid);
    }
    dct::cp_async_commit();
  }
  dct::cp_async_wait<kStages - 1>();
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;   // the mma fragment row and column pair
  const int r0 = warp * 16;
  uint32_t qf[4][4], dof[4][4];   // Q and dO as A fragments, for the whole KV loop
  load_a(qf, sq, r0, lane);
  load_a(dof, sdo, r0, lane);

  // per row half (row g, row g + 8): -lse * log2(e) and di; rows >= lq
  // (zero Q and dO) get 0 and are not stored
  float nlse[2], dir[2];
  const float* lseb = lse + (n * heads + h) * lq;
  const float* dib = di + (n * heads + h) * lq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    nlse[r] = row < lq ? -lseb[row] * kLog2e : 0.f;
    dir[r] = row < lq ? dib[row] : 0.f;
  }

  const float scale_log2 = scale * kLog2e;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  int slot = 0, fill = kStages - 1;
  for (int kv = 0; kv < num_kv; ++kv) {
    // tile kv has landed for every thread, and every warp is done with tile
    // kv - 1, whose slot (`fill`) the next load overwrites
    dct::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kv + kStages - 1;
    if (next < num_kv) {
      load_rows<kTcCols>(sk + fill * kTileElems, kb, hd, next * kTcCols, lk, tid);
      load_rows<kTcCols>(sv + fill * kTileElems, vb, hd, next * kTcCols, lk, tid);
    }
    dct::cp_async_commit();
    const bf16* skt = sk + slot * kTileElems;
    const bf16* svt = sv + slot * kTileElems;
    slot = slot + 1 == kStages ? 0 : slot + 1;
    fill = fill + 1 == kStages ? 0 : fill + 1;

    float s[8][4], dp[8][4];
    mma_abt(s, qf, skt, lane);    // S = Q K^T
    mma_abt(dp, dof, svt, lane);  // dP = dO V^T
    // p = exp(s * scale - lse), keys >= lk get p = 0; ds = p (dp - di) scale
    const int k0 = kv * kTcCols;
    const bool ragged = k0 + kTcCols > lk;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[j][e], scale_log2, nlse[e >> 1]));
        if (ragged && k0 + j * 8 + 2 * t + (e & 1) >= lk) p = 0.f;
        s[j][e] = p * (dp[j][e] - dir[e >> 1]) * scale;
      }
    uint32_t dsf[4][4];   // ds rounded to bf16: the A fragments of dQ += dS K
    pack_a(dsf, s);
    mma_ab(acc, dsf, skt, lane);
  }
  dct::cp_async_wait<0>();   // only empty groups remain; leave none behind
  store_rows(dq + qoff, acc, q0 + r0, lq, hd, lane);
}

__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const float* __restrict__ lse,
                        const float* __restrict__ di, const bf16* __restrict__ dout,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int lq, int lk,
                        int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);   // [kStages][kTcCols][kStride]
  bf16* sdo = sq + kStages * kTileElems;          // [kStages][kTcCols][kStride]
  bf16* sk = sdo + kStages * kTileElems;          // [kTcRows][kStride]
  bf16* sv = sk + kOwnElems;                      // [kTcRows][kStride]
  float* slse = reinterpret_cast<float*>(sv + kOwnElems);   // [kStages][kTcCols]
  float* sdi = slse + kStages * kTcCols;                     // [kStages][kTcCols]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * kTcRows;
  const int h = blockIdx.y;
  const size_t n = blockIdx.z;
  const size_t hd = (size_t)heads * kD;
  const size_t koff = n * lk * hd + h * kD;
  const bf16* qb = q + n * lq * hd + h * kD;
  const bf16* dob = dout + n * lq * hd + h * kD;
  const float* lseb = lse + (n * heads + h) * lq;
  const float* dib = di + (n * heads + h) * lq;
  const int num_q = (lq + kTcCols - 1) / kTcCols;

  // one q tile: Q and dO rows, and lse and di (4 bytes a thread), zero past lq
  auto load_q_tile = [&](int tile, int to) {
    const int row0 = tile * kTcCols;
    load_rows<kTcCols>(sq + to * kTileElems, qb, hd, row0, lq, tid);
    load_rows<kTcCols>(sdo + to * kTileElems, dob, hd, row0, lq, tid);
    static_assert(kTcThreads >= 2 * kTcCols, "one lse or di value a thread");
    if (tid < 2 * kTcCols) {
      const int i = tid % kTcCols, row = row0 + i;
      const float* src = tid < kTcCols ? lseb : dib;
      float* dst = tid < kTcCols ? slse : sdi;
      dct::cp_async4_zfill(dst + to * kTcCols + i, src + (row < lq ? row : 0), row < lq);
    }
  };

  load_rows<kTcRows>(sk, k + koff, hd, k0, lk, tid);
  load_rows<kTcRows>(sv, v + koff, hd, k0, lk, tid);
  dct::cp_async_commit();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < num_q) load_q_tile(s, s);
    dct::cp_async_commit();
  }
  dct::cp_async_wait<kStages - 1>();
  __syncthreads();

  const int t = lane & 3;
  const int r0 = warp * 16;

  const float scale_log2 = scale * kLog2e;
  float dka[8][4], dva[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  int slot = 0, fill = kStages - 1;
  for (int qi = 0; qi < num_q; ++qi) {
    dct::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = qi + kStages - 1;
    if (next < num_q) load_q_tile(next, fill);
    dct::cp_async_commit();
    const bf16* sqt = sq + slot * kTileElems;
    const bf16* sdot = sdo + slot * kTileElems;
    const float* lset = slse + slot * kTcCols;
    const float* dit = sdi + slot * kTcCols;
    slot = slot + 1 == kStages ? 0 : slot + 1;
    fill = fill + 1 == kStages ? 0 : fill + 1;

    // K and V as A fragments are taken from shared memory again for every
    // q tile: held in registers beside dK and dV they would spill
    float s[8][4], dp[8][4];
    uint32_t af[4][4];
    load_a(af, sv, r0, lane);
    mma_abt(dp, af, sdot, lane);   // dP^T = V dO^T
    load_a(af, sk, r0, lane);
    mma_abt(s, af, sqt, lane);     // S^T = K Q^T
    // column i of a fragment is query row q0 + i: p^T = exp(s * scale -
    // lse_i), rows >= lq get p = 0; ds^T = p^T (dp^T - di_i) scale
    const int q0 = qi * kTcCols;
    const bool ragged = q0 + kTcCols > lq;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = j * 8 + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(lset + i);
      const float2 d2 = *reinterpret_cast<const float2*>(dit + i);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool odd = e & 1;
        float p = exp2f(fmaf(s[j][e], scale_log2, -(odd ? l2.y : l2.x) * kLog2e));
        if (ragged && q0 + i + odd >= lq) p = 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - (odd ? d2.y : d2.x)) * scale;
      }
    }
    // p^T rounded to bf16 for dV (the one rounding the Pallas kernel does
    // not make: see the head comment), ds^T rounded as in Pallas
    uint32_t pf[4][4], dsf[4][4];
    pack_a(pf, s);
    pack_a(dsf, dp);
    mma_ab(dva, pf, sdot, lane);   // dV += P^T dO
    mma_ab(dka, dsf, sqt, lane);   // dK += dS^T Q
  }
  dct::cp_async_wait<0>();
  store_rows(dk + koff, dka, k0 + r0, lk, hd, lane);
  store_rows(dv + koff, dva, k0 + r0, lk, hd, lane);
}

// di = rowsum(dO * o) of every (n, row, head), (N, H, Lq) fp32: one group of
// 64 / kVec lanes per head row, each lane a 16-byte load of o and of dO.
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_di_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                    float* __restrict__ di, long long rows, int lq, int heads) {
  using V = dct::Vec16<T>;
  constexpr int kLanes = kD / V::kVec;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long grp = idx / kLanes;   // row * heads + head
  const int c = idx % kLanes;
  const bool valid = grp < rows * heads;
  float sum = 0.f;
  if (valid) {
    float a[V::kVec], b[V::kVec];
    V::load(o + grp * kD + c * V::kVec, a);
    V::load(dout + grp * kD + c * V::kVec, b);
#pragma unroll
    for (int e = 0; e < V::kVec; ++e) sum = fmaf(a[e], b[e], sum);
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (valid && c == 0) {
    const long long row = grp / heads;
    const int hh = grp % heads;
    di[(row / lq * heads + hh) * lq + row % lq] = sum;
  }
}

cudaError_t launch_dq_tc(const void* q, const void* k, const void* v, const float* lse,
                         const float* di, const void* dout, void* dq, int n, int lq, int lk,
                         int heads, float scale, cudaStream_t stream) {
  if (di == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqTcSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + kTcRows - 1) / kTcRows, heads, n);
  flash_bwd_dq_tc_kernel<<<grid, kTcThreads, kDqTcSmemBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      lse, di, static_cast<const bf16*>(dout), static_cast<bf16*>(dq), lq, lk, heads, scale);
  return cudaGetLastError();
}

cudaError_t launch_dkv_tc(const void* q, const void* k, const void* v, const float* lse,
                          const float* di, const void* dout, void* dk, void* dv, int n,
                          int lq, int lk, int heads, float scale, cudaStream_t stream) {
  if (di == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvTcSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_tc_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((lk + kTcRows - 1) / kTcRows, heads, n);
  flash_bwd_dkv_tc_kernel<<<grid, kTcThreads, kDkvTcSmemBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      lse, di, static_cast<const bf16*>(dout), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      lq, lk, heads, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_di(const void* o, const void* dout, float* di, int n, int lq, int heads,
                      cudaStream_t stream) {
  constexpr int kThreadsDi = 256;
  const long long rows = (long long)n * lq;
  const long long threads = rows * heads * (kD / dct::Vec16<T>::kVec);
  const long long blocks = (threads + kThreadsDi - 1) / kThreadsDi;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_di_kernel<T><<<(unsigned)blocks, kThreadsDi, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), di, rows, lq, heads);
  return cudaGetLastError();
}


}  // namespace

// dq: bf16 runs the tensor-core kernel and reads di (the pre-pass's output,
// required); fp32 runs the FMA kernel, which computes di itself and ignores
// the pointer.
extern "C" int dct_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                const void* lse, const void* di, const void* dout, void* dq,
                                int dtype, int n, int lq, int lk, int heads, float scale,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  if (dtype == dct::kBFloat16)
    return launch_dq_tc(q, k, v, l, static_cast<const float*>(di), dout, dq, n, lq, lk, heads,
                        scale, s);
  if (dtype == dct::kFloat32)
    return launch_dq<float>(q, k, v, o, l, dout, dq, n, lq, lk, heads, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int dct_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* o,
                                 const void* lse, const void* di, const void* dout, void* dk,
                                 void* dv, int dtype, int n, int lq, int lk, int heads,
                                 float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  if (dtype == dct::kBFloat16)
    return launch_dkv_tc(q, k, v, l, static_cast<const float*>(di), dout, dk, dv, n, lq, lk,
                         heads, scale, s);
  if (dtype == dct::kFloat32)
    return launch_dkv<float>(q, k, v, o, l, dout, dk, dv, n, lq, lk, heads, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int dct_flash_bwd_di(const void* o, const void* dout, void* di, int dtype, int n,
                                int lq, int heads, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* d = static_cast<float*>(di);
  if (dtype == dct::kBFloat16) return launch_di<__nv_bfloat16>(o, dout, d, n, lq, heads, s);
  if (dtype == dct::kFloat32) return launch_di<float>(o, dout, d, n, lq, heads, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
