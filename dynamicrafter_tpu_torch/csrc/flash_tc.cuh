// The tensor-core flash-forward main loop for blocks that serve several heads
// from one staged row (sm_90a). `flash_fwd_tc_block` is the loop for any
// `FlashTcTile` (heads a block, warps a head, rows a warp, ring slots);
// `flash_fwd_tc_pairs` and `launch_flash_tc_pairs` map blocks to head pairs
// for the bf16 paths of K6 (flash_packed.cu) and K9 (flash_pairs.cu), which
// share that tile and grid: bring-up timing chose the pair for both. The
// bf16 K10 (flash_variants.cu) runs the loop on K1's tile and grid, one head
// a block, in each of its softmax modes.
//
// The function is K1's (flash_attention.cu): softmax(Q K^T * scale) V per
// head on (N, L, H*64) row-major bf16 operands, fp32 online softmax, KV
// positions >= Lk masked, l == 0 guarded, p rounded to bf16 before the PV
// product as in the Pallas kernels, only rows < Lq stored. The arithmetic is
// K1's tensor-core main loop, line for line, so the outputs are K1's bit
// for bit: Q held as ldmatrix A fragments for the whole KV sweep, S = Q K^T
// on mma.sync m16n8k16 with fp32 accumulators, the online softmax on the C
// fragments (a row on the 4 lanes of a quad), p repacked in registers as
// the A operand of O += P V, V's B fragments through ldmatrix.trans.
//
// What differs from K1 is the unit of data movement. A block serves kHeads
// adjacent heads and stages, for every Q, K and V row, the heads'
// contiguous kHeads*64 columns (256 bytes for a pair) with 16-byte
// cp.async, neighbouring threads on neighbouring chunks of a row. A warp
// serves its head from that staging at column offset head * 64: in an
// ldmatrix row address that is only a column offset plus the row stride.
// Rows are padded by 8 elements to kHeads*64 + 8, an odd number of 16-byte
// chunks, so the 8 row addresses of an ldmatrix phase fall on disjoint
// banks. K and V tiles of 64 rows move through a ring of kStages slots
// (slot = K tile then V tile); rows at or past Lk (or Lq) are zero-filled by
// cp.async's src-size operand. The Q tile is staged in the ring's last
// slot: it is moved into registers before the first barrier of the KV loop,
// and that slot is first refilled after it.
//
// Who copies and who waits: each head's warps copy their own head's
// columns of the staged rows and meet at a named barrier of their own
// (bar.sync 1 + head), so that no head waits for another. One
// __syncthreads per KV tile for all heads of the block made every head wait
// for the slowest warp and ran 8-34 % slower in the bring-up timing
// (flash_pairs.cu and flash_packed.cu give the numbers).
//
// Heads past the last (the second head of an odd H's last pair): their
// warps return at once, and their columns are neither read nor written. No
// address at or past column H*64 of a row is touched.
//
// Any scale: softmax(scale * q.k) = softmax(|scale| * (sign(scale) q).k),
// and negating a bf16 value is exact, so the Q fragments are negated once
// (sign bits flipped) for a negative scale and the loop runs K1's
// arithmetic with |scale|: the running max of the raw logits, scaled after,
// is then exact. A zero scale is q = 0 with scale 1 (every logit 0). This
// costs nothing per logit; K1's kernel refuses scale <= 0 instead. In every
// softmax mode below S * |scale| with Q's sign flipped is the same number
// as S * scale, so the rule holds in all three.
//
// Softmax modes (dct::SoftmaxMode, flash_tile.cuh; a template parameter of
// flash_fwd_tc_block, only the softmax step differs). kSoftmaxExp2, the
// default and K1's step: the multiplier is scale * log2(e), the running max
// and p are in the log2 domain, exponentials by exp2f; K6 and K9 take it, so
// their code is K1's. kSoftmaxExp (K10 exp): the multiplier is the scale,
// max and p in the natural-log domain, exponentials by __expf, as the
// Pallas body scales the logits before their max. kNoSoftmax (K10
// nosoftmax, not attention): p = clamp(S * scale, -1, 1) with no max, no
// rescale and l = 1 (the epilogue's 1/l is 1); keys at or past Lk get p = 0.
//
// Determinism: each block owns its output tile and sums in a fixed order;
// there are no atomics, so two runs agree bit for bit.
#pragma once

#include <type_traits>

#include "flash_tile.cuh"
#include "mma.cuh"

namespace dct {

// One block: kHeads heads side by side, kWarpsPerHead warps on each head,
// each warp kMTiles m16 tiles (16 * kMTiles query rows); KV tiles of 64 rows
// in a ring of kStages slots.
template <int kHeads_, int kWarpsPerHead_, int kMTiles_, int kStages_>
struct FlashTcTile {
  static constexpr int kHeads = kHeads_;
  static constexpr int kWarpsPerHead = kWarpsPerHead_;
  static constexpr int kMTiles = kMTiles_;
  static constexpr int kStages = kStages_;
  static constexpr int kD = 64;                           // head dim
  static constexpr int kBK = 64;                          // KV rows per tile
  static constexpr int kHeadThreads = kWarpsPerHead * 32; // a head's threads
  static constexpr int kThreads = kHeads * kHeadThreads;
  static constexpr int kBQ = kWarpsPerHead * 16 * kMTiles;  // query rows per block
  static constexpr int kStride = kHeads * kD + 8;         // elements per staged row
  static constexpr int kSlotElems = 2 * kBK * kStride;    // K tile, then V tile
  static constexpr int kSmemBytes = kStages * kSlotElems * 2;
  static_assert(kStages >= 2, "a ring needs two slots");
  static_assert(kBQ <= 2 * kBK, "the Q tile is staged in one ring slot");
  static_assert(kSmemBytes <= 232448, "more shared memory than a block may have");
};

// The tile of the bf16 K6 and K9: a head pair, 4 warps a head, 32 query rows
// a warp (two m16 tiles: every K and V fragment taken from shared memory
// feeds two MMAs), a ring of three K/V slots. At 255 registers a thread the
// 8-warp block holds an SM's register file, the same 8 warps per SM as K1's
// two 4-warp blocks; shared memory is 3 x 2 x 64 x 136 x 2 B = 102 KB.
using FlashTcPairTile = FlashTcTile<2, 4, 2, 3>;

// One block's work: query rows q0 .. q0 + kBQ - 1 of `nheads` (<= kHeads)
// adjacent heads. qb, kb, vb and ob point at row 0, column 0 of the block's
// first head in its sequence; `hd` is the row stride (H*64); `mult` is the
// logits' multiplier of the mode, of any sign: scale * log2(e) in
// kSoftmaxExp2, the scale in kSoftmaxExp and kNoSoftmax.
template <class Tile, int kMode = kSoftmaxExp2>
__device__ __forceinline__ void flash_fwd_tc_block(
    const __nv_bfloat16* __restrict__ qb, const __nv_bfloat16* __restrict__ kb,
    const __nv_bfloat16* __restrict__ vb, __nv_bfloat16* __restrict__ ob, size_t hd, int q0,
    int lq, int lk, int nheads, float mult, __nv_bfloat16* smem) {
  using bf16 = __nv_bfloat16;
  constexpr int kMT = Tile::kMTiles, kStages = Tile::kStages, kStride = Tile::kStride;
  constexpr int kBK = Tile::kBK, kSlot = Tile::kSlotElems;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int head = warp / Tile::kWarpsPerHead;
  if (head >= nheads) return;   // no such head: nothing to read, write or wait for
  const int wrow = (warp % Tile::kWarpsPerHead) * 16 * kMT;   // warp's first row in the tile
  const int wcol = head * Tile::kD;                           // its head's staged columns
  const int htid = tid % Tile::kHeadThreads;                  // thread within its head
  const int num_kv = (lk + kBK - 1) / kBK;
  bf16* sq = smem + (kStages - 1) * kSlot;

  // this head's columns of rows row0 .. row0 + kRows - 1 (mma.cuh's
  // cp_async_head_rows), by the head's threads; they meet at the head's own
  // barrier
  const auto copy_rows = [&](bf16* dst, const bf16* src, int row0, int nvalid, auto rows) {
    cp_async_head_rows<decltype(rows)::value, Tile::kHeadThreads, kStride>(
        dst + wcol, src + wcol, hd, row0, nvalid, htid);
  };
  using KVRows = std::integral_constant<int, kBK>;
  const auto sync = [&]() {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + head), "n"(Tile::kHeadThreads) : "memory");
  };

  // groups in flight: Q, then KV tiles 0 .. kStages - 2 (empty groups past
  // the last tile keep the count that cp_async_wait relies on)
  copy_rows(sq, qb, q0, lq, std::integral_constant<int, Tile::kBQ>());
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < num_kv) {
      copy_rows(smem + s * kSlot, kb, s * kBK, lk, KVRows());
      copy_rows(smem + s * kSlot + kBK * kStride, vb, s * kBK, lk, KVRows());
    }
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();
  sync();

  // ldmatrix roles of this lane, as in K1: A fragments and V's transposed B
  // fragments take row (lane & 7) + 8 * bit 3 and column 8 * bit 4 of a
  // 16 x 16 block; K's B fragments take row lane & 7 and column
  // 8 * (lane >> 3) of an 8 x 32 block
  const int frow = (lane & 7) + ((lane >> 3) & 1) * 8, fcol = (lane >> 4) * 8;
  const int krow = lane & 7, kcol = (lane >> 3) * 8;
  const int g = lane >> 2, t = lane & 3;   // the mma fragment row and column pair

  // the sign of the scale moves into Q (exact); a zero scale is q = 0
  const uint32_t qflip = mult < 0.f ? 0x80008000u : 0u;
  const uint32_t qkeep = mult == 0.f ? 0u : 0xffffffffu;
  const float sl2 = mult == 0.f ? 1.f : fabsf(mult);

  uint32_t qf[kMT][4][4];   // Q as A fragments: [m tile][k step of 16 dims]
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      ldmatrix_x4(qf[mt][kk], sq + (wrow + mt * 16 + frow) * kStride + wcol + kk * 16 + fcol);
#pragma unroll
      for (int e = 0; e < 4; ++e) qf[mt][kk][e] = (qf[mt][kk][e] ^ qflip) & qkeep;
    }

  // per m tile and row half (row g, row g + 8): running max (log2 domain,
  // scaled), this lane's partial row sum, and the output accumulators
  float m[kMT][2], l[kMT][2], acc[kMT][8][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
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
    // tile kv has landed for every thread of the head, and each of its warps
    // is done with tile kv - 1 (on the first pass: with the Q tile), whose slot the next load
    // overwrites
    cp_async_wait<kStages - 2>();
    sync();
    const int next = kv + kStages - 1;
    if (next < num_kv) {
      copy_rows(smem + fill * kSlot, kb, next * kBK, lk, KVRows());
      copy_rows(smem + fill * kSlot + kBK * kStride, vb, next * kBK, lk, KVRows());
    }
    cp_async_commit();
    const bf16* skt = smem + slot * kSlot + wcol;
    const bf16* svt = skt + kBK * kStride;
    slot = slot + 1 == kStages ? 0 : slot + 1;
    fill = fill + 1 == kStages ? 0 : fill + 1;

    // S = Q K^T: 8 column tiles of 8 keys, 4 k steps of 16 dims
    float s[kMT][8][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t b[4];   // k steps 2 * half and 2 * half + 1 of column tile j
        ldmatrix_x4(b, skt + (j * 8 + krow) * kStride + half * 32 + kcol);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(s[mt][j], qf[mt][2 * half], b[0], b[1]);
          mma_bf16(s[mt][j], qf[mt][2 * half + 1], b[2], b[3]);
        }
      }
    }
    const int k0 = kv * kBK;
    // the last tile is ragged: keys >= lk get p = 0 (-inf before the
    // exponential; 0 in kNoSoftmax, where p = clamp(s) takes no exponential)
    if (k0 + kBK > lk) {
      const float masked = kMode == kNoSoftmax ? 0.f : -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (k0 + j * 8 + 2 * t + (e & 1) < lk) continue;
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) s[mt][j][e] = masked;
        }
    }

    // the softmax step on the accumulators. Online softmax: every KV tile
    // holds >= 1 valid key, so the running max is finite after the first
    // tile
    uint32_t pf[kMT][4][4];   // p as A fragments: [m tile][k step of 16 keys]
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      if constexpr (kMode == kNoSoftmax) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][j][e] = fminf(fmaxf(s[mt][j][e] * sl2, -1.f), 1.f);
      } else {
        const auto ex = [](float x) { return kMode == kSoftmaxExp ? __expf(x) : exp2f(x); };
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = -CUDART_INF_F;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            mx = fmaxf(mx, fmaxf(s[mt][j][2 * r], s[mt][j][2 * r + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[mt][r], mx * sl2);
          const float alpha = ex(m[mt][r] - m_new);
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 2 * r; e < 2 * r + 2; ++e) {
              s[mt][j][e] = ex(fmaf(s[mt][j][e], sl2, -m_new));
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
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pf[mt][kk][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        pf[mt][kk][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        pf[mt][kk][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        pf[mt][kk][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
    }

    // O += P V: 4 k steps of 16 keys, 8 column tiles of 8 dims (in pairs)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b[4];   // dims 16 * jp .. + 7 (b[0], b[1]) and + 8 .. + 15 (b[2], b[3])
        ldmatrix_x4_trans(b, svt + (kk * 16 + frow) * kStride + jp * 16 + fcol);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(acc[mt][2 * jp], pf[mt][kk], b[0], b[1]);
          mma_bf16(acc[mt][2 * jp + 1], pf[mt][kk], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();   // only empty groups remain; leave none behind

#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[mt][r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int row = q0 + wrow + mt * 16 + g + 8 * r;
      if (row >= lq) continue;
      const float inv = kMode == kNoSoftmax || sum == 0.f ? 1.f : 1.f / sum;
      bf16* orow = ob + (size_t)row * hd + wcol + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
            __floats2bfloat162_rn(acc[mt][j][2 * r] * inv, acc[mt][j][2 * r + 1] * inv);
    }
  }
}

// The bf16 K6 and K9: one FlashTcPairTile block per (128-row query tile,
// head pair, n) of (N, L, H*64) operands, the block's heads 2p and 2p + 1
// (only 2p in an odd H's last pair). A kernel's body; smem is its dynamic
// shared memory.
__device__ __forceinline__ void flash_fwd_tc_pairs(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int lq, int lk,
    int heads, float scale_log2, __nv_bfloat16* smem) {
  using Tile = FlashTcPairTile;
  const int h0 = blockIdx.y * 2;
  const size_t n = blockIdx.z;
  const size_t hd = (size_t)heads * Tile::kD;
  flash_fwd_tc_block<Tile>(q + n * lq * hd + h0 * Tile::kD, k + n * lk * hd + h0 * Tile::kD,
                           v + n * lk * hd + h0 * Tile::kD, o + n * lq * hd + h0 * Tile::kD, hd,
                           blockIdx.x * Tile::kBQ, lq, lk, min(2, heads - h0), scale_log2, smem);
}

using FlashTcPairKernel = void (*)(const __nv_bfloat16*, const __nv_bfloat16*,
                                   const __nv_bfloat16*, __nv_bfloat16*, int, int, int, float);

// Launches a kernel whose body is flash_fwd_tc_pairs on n sequences of lq
// query and lk key rows of `heads` heads.
inline cudaError_t launch_flash_tc_pairs(FlashTcPairKernel kernel, const void* q, const void* k,
                                         const void* v, void* o, int n, int lq, int lk,
                                         int heads, float scale_log2, cudaStream_t stream) {
  using Tile = FlashTcPairTile;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Tile::kSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + Tile::kBQ - 1) / Tile::kBQ, (heads + 1) / 2, n);
  kernel<<<grid, Tile::kThreads, Tile::kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lq, lk, heads,
      scale_log2);
  return cudaGetLastError();
}

}  // namespace dct
