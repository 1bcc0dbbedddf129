// K2 and K5: self-attention over a short token axis T <= 32, for Hopper
// (sm_90a). Both compute, for one head of one group of T tokens, softmax
// over T of the T x T logits q k^T * scale (fp32), times v; they differ in
// the memory layout they read in place, and so in how a block gathers its
// rows. bf16 with head dim 64 runs both products on the tensor cores in
// both (one warp loop, `small_t_tc_groups`); fp32, and bf16 with another
// head dim, take the SIMT kernels, which share the per-row arithmetic
// (`attend_row`).
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
// G = 2560, H*D = 320: 0.0626 ms at 3.35 TB/s) for only 4*B*G*H*T^2*D =
// 1.7 GFLOP: ~8 FLOP per byte, far below the ~295 FLOP/byte ridge. It is
// bound by bytes. The input type and the head width choose the kernel
// (`dct_small_t_fwd`), and nothing else does:
//
// bf16 with D = 64 (every temporal attention of the shipped configs):
//   `small_t_tc_kernel<kMTiles>`, both products on the tensor cores, so the
//   kernel is the streaming copy its bound says it is. One warp takes one
//   (b, g, head) group at a time: its T rows of Q, K and V (128 contiguous
//   bytes each, row t at ((b*T + t)*G + g)*H*64 + h*64) as an m16 tile
//   (kMTiles = 1, T <= 16) or two (17 <= T <= 32). S = Q K^T on mma.sync
//   m16n8k16 with fp32 accumulators (Q as ldmatrix A fragments, K's B
//   fragments from plain ldmatrix), times the scale (any sign), keys >= T
//   set to -inf; the softmax over the whole row of T keys in the C
//   fragments (a row on the 4 lanes of a quad: two shuffles for its max and
//   two for its sum, no online rescale), normalised, then rounded to bf16 as
//   `att.astype(v.dtype)` rounds it, as the A fragments of O = P V (V's B
//   fragments through ldmatrix.trans), accumulated in fp32.
//   Data movement: each warp stages its groups in a ring of kSlots slots of
//   its own in shared memory (Q, K, V; rows padded to 72 elements, so the 8
//   row addresses of an ldmatrix phase fall on disjoint banks), by 16-byte
//   cp.async, rows t >= T zero-filled by the src-size operand; the next
//   group's loads are in flight while the current one is computed. Warps
//   run independently: __syncwarp, no block-wide barrier. The grid is
//   persistent (as many 4-warp blocks as are resident on the card, from the
//   occupancy query) and each warp strides over the groups, so that every
//   warp keeps loads in flight from its first group to its last and the
//   prologue and epilogue of a block are paid once per warp, not once per
//   group; consecutive warps take consecutive heads of one (b, g), whose
//   rows are contiguous. The output goes back through the group's Q slot
//   (Q is in registers by then) and leaves as 16-byte stores, 8 lanes to a
//   128-byte row. Rows t >= T are neither read nor written, nor is any
//   column outside the group's head.
//   Shared memory: 2 slots x 3 tensors x 16 rows x 144 B a warp, 55 KB a
//   4-warp block, so four blocks (16 warps) fit an SM, each warp with one
//   group (6 KB) in flight: ~96 KB of loads in flight per SM, above the
//   ~25 KB that 3.35 TB/s x ~1 us of latency over 132 SMs asks for. Three
//   slots (two blocks an SM, two groups in flight a warp) timed within
//   1.5 % of two at every shape in the bring-up probe (PERF.md §6), so the
//   smaller ring stays. Registers 77 (one m16 tile) and 146 (two), no
//   spill. Card times (that probe, NVIDIA H100 80GB HBM3 at 700 W, in turn
//   with the first version): 0.0799 ms at (2, 16, 2560, 5*64), 78 % of the
//   bound (first version 0.272); 0.141 at (1, 16, 9216, 5*64), 80 %
//   (0.448); 0.243 at (16, 16, 1024, 5*64), 82 % (0.760); 0.007-0.042 ms at
//   the shapes with G <= 640 (55-87 %, launch-bound below G = 160).
//
// fp32, and bf16 with another D: `small_t_kernel<T>`, the first version.
//   One block per (tile of GT positions g, head, b), GT*T threads, one
//   thread per query row. The block reads its T x GT x D slices of q, k and
//   v into shared memory with coalesced 16-byte loads, forms its row of T
//   fp32 logits, takes the softmax in registers, writes the output row over
//   its own (now dead) q row in shared memory, and the block stores the
//   result with coalesced 16-byte writes. Rows are padded by 16 bytes so
//   the per-thread row reads hit distinct banks. p stays in fp32 (the
//   normalisation is applied to the accumulated row); for fp32 inputs that
//   is the reference's rounding, for bf16 it is one rounding fewer.
#include <climits>

#include "common.cuh"
#include "mma.cuh"

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
// K2, bf16 with D = 64: the tensor-core kernel
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcD = 64;               // head dim
constexpr int kTcStride = kTcD + 8;    // bf16 per staged row: 144 bytes
constexpr int kTcWarps = 4;            // warps a block (each on its own)
constexpr int kSlots = 2;              // groups a warp stages at once

// kMTiles m16 tiles of query (and key) rows: 16 * kMTiles >= T
template <int kMTiles>
struct SmallTcTile {
  static constexpr int kRows = 16 * kMTiles;
  static constexpr int kTensorElems = kRows * kTcStride;   // one of Q, K, V
  static constexpr int kSlotElems = 3 * kTensorElems;
  static constexpr int kWarpElems = kSlots * kSlotElems;
  static constexpr int kSmemBytes = kTcWarps * kWarpElems * 2;
  // blocks resident on an SM: shared memory allows 4 (kMTiles = 1) or 2;
  // the register cap makes sure registers do too
  static constexpr int kMinBlocks = kMTiles == 1 ? 4 : 2;
};

// The warp loop of the tensor-core kernels: each warp takes groups first,
// first + step, ... of `groups` = B * G * heads. Group gi = (b * G + g) *
// heads + h has its T rows at ((b * T + t) * G + g) * heads * 64 + h * 64,
// t = 0 .. T - 1: K2's time-major layout; with G = 1 (a literal in K5's
// kernel, so the divisions by G fold away) b is K5's position-major row.
template <int kMTiles>
__device__ __forceinline__ void small_t_tc_groups(const bf16* __restrict__ q,
                                                  const bf16* __restrict__ k,
                                                  const bf16* __restrict__ v,
                                                  bf16* __restrict__ o, int tlen, int g,
                                                  int heads, int groups, float scale) {
  using Tile = SmallTcTile<kMTiles>;
  constexpr int kRows = Tile::kRows, kTE = Tile::kTensorElems;
  constexpr int kChunks = kRows * 8 / 32;   // 16-byte chunks a lane moves per tensor
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bf16* ring = reinterpret_cast<bf16*>(smem_raw) + warp * Tile::kWarpElems;
  const size_t hd = (size_t)heads * kTcD;
  const size_t tstride = (size_t)g * hd;   // from frame t to frame t + 1
  const int first = blockIdx.x * kTcWarps + warp, step = gridDim.x * kTcWarps;

  // element offset of row t = 0 of group gi = (b * G + g) * H + h
  const auto group_base = [&](int gi) {
    const int h = gi % heads, bg = gi / heads;
    return ((size_t)(bg / g) * tlen * g + bg % g) * hd + (size_t)h * kTcD;
  };
  // cp.async of group gi's Q, K and V rows into ring slot `slot` (rows
  // >= T zero-filled); one commit group, empty past the last group
  const auto stage = [&](int gi, int slot) {
    if (gi < groups) {
      const size_t base = group_base(gi);
      bf16* dst = ring + slot * Tile::kSlotElems;
#pragma unroll
      for (int it = 0; it < kChunks; ++it) {
        const int i = lane + 32 * it, r = i / 8, c = (i % 8) * 8;
        const bool valid = r < tlen;
        const size_t off = base + (size_t)(valid ? r : 0) * tstride + c;
        dct::cp_async16_zfill(dst + r * kTcStride + c, q + off, valid);
        dct::cp_async16_zfill(dst + kTE + r * kTcStride + c, k + off, valid);
        dct::cp_async16_zfill(dst + 2 * kTE + r * kTcStride + c, v + off, valid);
      }
    }
    dct::cp_async_commit();
  };

  // ldmatrix roles of this lane, as in flash_tc.cuh: A fragments and V's
  // transposed B fragments take row (lane & 7) + 8 * bit 3 and column
  // 8 * bit 4 of a 16 x 16 block; K's B fragments take row lane & 7 and
  // column 8 * (lane >> 3) of an 8 x 32 block
  const int frow = (lane & 7) + ((lane >> 3) & 1) * 8, fcol = (lane >> 4) * 8;
  const int krow = lane & 7, kcol = (lane >> 3) * 8;
  const int gr = lane >> 2, tc = lane & 3;   // the mma fragment row and column pair

#pragma unroll
  for (int s = 0; s < kSlots - 1; ++s) stage(first + s * step, s);
  int slot = 0;
  for (int gi = first; gi < groups; gi += step) {
    // this group has landed for every lane, and the slot of the group
    // before it is read out: the group kSlots - 1 ahead may fill it
    dct::cp_async_wait<kSlots - 2>();
    __syncwarp();
    stage(gi + (kSlots - 1) * step, (slot + kSlots - 1) % kSlots);
    bf16* sq = ring + slot * Tile::kSlotElems;
    const bf16* sk = sq + kTE;
    const bf16* sv = sk + kTE;

    // S = Q K^T: kMTiles x 2*kMTiles tiles of 16 x 8, 4 k steps of 16 dims
    uint32_t qf[kMTiles][4][4];
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        dct::ldmatrix_x4(qf[mt][kk], sq + (mt * 16 + frow) * kTcStride + kk * 16 + fcol);
    float s[kMTiles][2 * kMTiles][4];
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int j = 0; j < 2 * kMTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 2 * kMTiles; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t b[4];   // k steps 2 * half and 2 * half + 1 of key tile j
        dct::ldmatrix_x4(b, sk + (j * 8 + krow) * kTcStride + half * 32 + kcol);
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) {
          dct::mma_bf16(s[mt][j], qf[mt][2 * half], b[0], b[1]);
          dct::mma_bf16(s[mt][j], qf[mt][2 * half + 1], b[2], b[3]);
        }
      }
    }

    // softmax over the T keys of each row (row g on the quad's 4 lanes),
    // normalised, then rounded to bf16 as the A fragments of P V
    uint32_t pf[kMTiles][kMTiles][4];   // [m tile][k step of 16 keys]
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < 2 * kMTiles; ++j)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const bool key = j * 8 + 2 * tc + (e & 1) < tlen;
            s[mt][j][e] = key ? s[mt][j][e] * scale : -CUDART_INF_F;
            mx = fmaxf(mx, s[mt][j][e]);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 2 * kMTiles; ++j)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            s[mt][j][e] = __expf(s[mt][j][e] - mx);
            sum += s[mt][j][e];
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float inv = 1.f / sum;
#pragma unroll
        for (int j = 0; j < 2 * kMTiles; ++j) {
          s[mt][j][2 * r] *= inv;
          s[mt][j][2 * r + 1] *= inv;
        }
      }
#pragma unroll
      for (int kk = 0; kk < kMTiles; ++kk) {
        pf[mt][kk][0] = dct::pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        pf[mt][kk][1] = dct::pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        pf[mt][kk][2] = dct::pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        pf[mt][kk][3] = dct::pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
    }

    // O = P V: kMTiles k steps of 16 keys, 8 column tiles of 8 dims (in pairs)
    float acc[kMTiles][8][4];
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kMTiles; ++kk) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b[4];   // dims 16 * jp .. + 7 (b[0], b[1]) and + 8 .. + 15 (b[2], b[3])
        dct::ldmatrix_x4_trans(b, sv + (kk * 16 + frow) * kTcStride + jp * 16 + fcol);
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) {
          dct::mma_bf16(acc[mt][2 * jp], pf[mt][kk], b[0], b[1]);
          dct::mma_bf16(acc[mt][2 * jp + 1], pf[mt][kk], b[2], b[3]);
        }
      }
    }

    // the output through the Q slot (Q is in registers), then 16-byte
    // stores of rows t < T, 8 lanes to a 128-byte row
    __syncwarp();
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(sq + (mt * 16 + gr + 8 * r) * kTcStride + j * 8 +
                                             2 * tc) =
              __floats2bfloat162_rn(acc[mt][j][2 * r], acc[mt][j][2 * r + 1]);
    __syncwarp();
    const size_t base = group_base(gi);
#pragma unroll
    for (int it = 0; it < kChunks; ++it) {
      const int i = lane + 32 * it, r = i / 8, c = (i % 8) * 8;
      if (r < tlen)
        *reinterpret_cast<uint4*>(o + base + (size_t)r * tstride + c) =
            *reinterpret_cast<const uint4*>(sq + r * kTcStride + c);
    }
    slot = slot + 1 == kSlots ? 0 : slot + 1;
  }
  dct::cp_async_wait<0>();   // only empty groups remain; leave none behind
}

// K2: time-major (B, T, G, H*64)
template <int kMTiles>
__global__ void __launch_bounds__(kTcWarps * 32, SmallTcTile<kMTiles>::kMinBlocks)
small_t_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int tlen, int g,
                  int heads, int groups, float scale) {
  small_t_tc_groups<kMTiles>(q, k, v, o, tlen, g, heads, groups, scale);
}

// K5: position-major (G, T, H*64), K2's kernel at G = 1 under a name of its
// own (see K5's comment further down)
template <int kMTiles>
__global__ void __launch_bounds__(kTcWarps * 32, SmallTcTile<kMTiles>::kMinBlocks)
small_t_posmajor_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o, int tlen,
                           int heads, int groups, float scale) {
  small_t_tc_groups<kMTiles>(q, k, v, o, tlen, 1, heads, groups, scale);
}

// The persistent grid of a tensor-core kernel over `groups` groups: every
// block resident at once, none idle. Sets the kernel's shared memory first.
template <int kMTiles, typename Kernel>
cudaError_t tc_grid(Kernel kernel, long long groups, int* blocks) {
  using Tile = SmallTcTile<kMTiles>;
  if (groups < 1 || groups > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Tile::kSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTcWarps * 32,
                                                           Tile::kSmemBytes)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long wanted = (groups + kTcWarps - 1) / kTcWarps;
  *blocks = (int)(wanted < (long long)sms * per_sm ? wanted : (long long)sms * per_sm);
  return cudaSuccess;
}

template <int kMTiles>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, int b, int tlen,
                      int g, int heads, float scale, cudaStream_t stream) {
  const long long groups = (long long)b * g * heads;
  int blocks = 0;
  const cudaError_t err = tc_grid<kMTiles>(small_t_tc_kernel<kMTiles>, groups, &blocks);
  if (err != cudaSuccess) return err;
  small_t_tc_kernel<kMTiles><<<blocks, kTcWarps * 32, SmallTcTile<kMTiles>::kSmemBytes,
                               stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), tlen, g, heads, (int)groups, scale);
  return cudaGetLastError();
}

template <int kMTiles>
cudaError_t launch_posmajor_tc(const void* q, const void* k, const void* v, void* o, int g,
                               int tlen, int heads, float scale, cudaStream_t stream) {
  const long long groups = (long long)g * heads;
  int blocks = 0;
  const cudaError_t err =
      tc_grid<kMTiles>(small_t_posmajor_tc_kernel<kMTiles>, groups, &blocks);
  if (err != cudaSuccess) return err;
  small_t_posmajor_tc_kernel<kMTiles><<<blocks, kTcWarps * 32,
                                        SmallTcTile<kMTiles>::kSmemBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), tlen, heads, (int)groups, scale);
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
// D = 64, bf16) that is 42 MB, about 12.5 us at 3.35 TB/s. The input type
// and the head width choose the kernel (`dct_small_t_fwd_posmajor`):
//
// bf16 with D = 64 (both of the model's K5 attentions):
//   `small_t_posmajor_tc_kernel<kMTiles>`, K2's tensor-core warp loop
//   (`small_t_tc_groups`, above) with G = 1: a (g, head) group is T rows of
//   128 contiguous bytes, row t at (g*T + t)*H*64 + h*64, which is K2's
//   address map with its B the G here. One warp a group, both products on
//   mma.sync, p normalised and rounded to bf16, a two-slot cp.async ring
//   per warp, a persistent grid; the group count G*H needs only fit an int,
//   so H has no grid limit. It is a kernel of its own, not a call of K2's,
//   so that a profile tells the two apart; its output equals K2's kernel on
//   the same memory viewed as (G, T, 1, H*64) bit for bit. Card time
//   (chip_smoke.py phase 10, NVIDIA H100 80GB HBM3 at 700 W): 0.0139-0.0143
//   ms at (256, 16, 20*64) as CUDA-graph replays, 87-90 % of the bound (its
//   42 MB stay in the 50 MB L2 between calls), against 0.0710-0.0716 ms for
//   the SIMT kernel in the same call; a wrapper call takes the host longer
//   than that (0.02-0.05 ms back to back). 0.245 ms at G = 4096 back to
//   back, 82 % of the bound.
//
// fp32, and bf16 with another D: `small_t_posmajor_kernel<T>`, the first
//   version. One block per (tile of GT rows g, head), GT*T threads, one
//   thread per query token. A tile's GT*T tokens are consecutive rows of the
//   (G*T, H*D) matrix, so the block copies rows g0*T .. of its head's D-wide
//   column slice into shared memory with 16-byte loads, runs `attend_row`,
//   and copies the result back the same way. The last tile is ragged when
//   GT does not divide G; the head is the grid's y, at most 65535.
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

// K2. bf16 with D = 64 runs the tensor-core kernel (one m16 tile of rows
// for T <= 16, two for T <= 32); fp32, and bf16 with another D, the first
// version.
extern "C" int dct_small_t_fwd(const void* q, const void* k, const void* v, void* o,
                               int dtype, int b, int tlen, int g, int heads, int d,
                               float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dct::kBFloat16 && d == kTcD) {
    if (tlen < 1 || tlen > kMaxT) return static_cast<int>(cudaErrorInvalidValue);
    return tlen <= 16 ? launch_tc<1>(q, k, v, o, b, tlen, g, heads, scale, s)
                      : launch_tc<2>(q, k, v, o, b, tlen, g, heads, scale, s);
  }
  if (dtype == dct::kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, o, b, tlen, g, heads, d, scale, s);
  if (dtype == dct::kFloat32)
    return launch<float>(q, k, v, o, b, tlen, g, heads, d, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K5. bf16 with D = 64 runs the tensor-core kernel (one m16 tile of rows
// for T <= 16, two for T <= 32); fp32, and bf16 with another D, the SIMT
// kernel.
extern "C" int dct_small_t_fwd_posmajor(const void* q, const void* k, const void* v,
                                        void* o, int dtype, int g, int tlen, int heads,
                                        int d, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dct::kBFloat16 && d == kTcD) {
    if (tlen < 1 || tlen > kMaxT) return static_cast<int>(cudaErrorInvalidValue);
    return tlen <= 16 ? launch_posmajor_tc<1>(q, k, v, o, g, tlen, heads, scale, s)
                      : launch_posmajor_tc<2>(q, k, v, o, g, tlen, heads, scale, s);
  }
  if (dtype == dct::kBFloat16)
    return launch_posmajor<__nv_bfloat16>(q, k, v, o, g, tlen, heads, d, scale, s);
  if (dtype == dct::kFloat32)
    return launch_posmajor<float>(q, k, v, o, g, tlen, heads, d, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
