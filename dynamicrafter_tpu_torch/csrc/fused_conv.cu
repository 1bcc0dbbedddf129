// K7 and K8: fused [add-emb] -> GroupNorm -> SiLU -> 3x3 same conv + bias on
// (N, H, W, C) activations with an HWIO (3, 3, C, Co) kernel, for Hopper
// (sm_90a).
//
// K7 `fused_gn_silu_conv_kernel` replaces the Pallas kernel
// experiments/fused_conv/fused_conv.py::_kernel: the GroupNorm statistics
// (fp32, E[x^2] - mean^2 over H*W*(C/groups) values of x + emb, the sum
// never rounded) are computed inside the launch, from raw x.
// K8 `fused_conv_tiled_kernel` replaces
// experiments/fused_conv/fused_conv_tiled.py::_kernel: it is handed the
// per-(n, c) scale and bias of a statistics pre-pass (plain PyTorch, as it
// is plain XLA there) and x + emb already rounded to the input type, and
// tiles the image in rows of `tile_h` with a one-row halo.
//
// Both then compute, per output pixel, sum over the 9 taps and C input
// channels of act * w with act = silu(v * scale + bias) rounded to the
// input type and ZERO outside the image: the padding ring is zeroed after
// SiLU, not before (silu(0 * scale + bias) != 0). Products accumulate in
// fp32, the conv bias is added in fp32, and the result is rounded once at
// the store.
//
// What bounds it: 2*N*H*W*C*Co*9 operations on (N*H*W*(C + Co) + 9*C*Co)
// elements, 1440 FLOP per byte at C = Co = 320 in bf16: operations. bf16
// inputs run the nine products on the tensor cores with mma.sync
// (m16n8k16, fp32 accumulators): the activation is rounded to bf16 before
// the products anyway, so this is the same arithmetic in another order of
// sums. fp32 inputs keep fp32 FMAs on the CUDA cores (TF32 would drop 13
// bits of each operand). wgmma and TMA are the later step.
//
// Design. The TPU kernel's one program per sample cannot be carried over: a
// level-0 sample (42*66*320 bf16 = 1.77 MB) is eight times an SM's shared
// memory. A block owns one output tile of th x tw pixels (th*tw <= 128) and
// 64 output channels of one sample; the grid is (row tiles * column tiles,
// Co tiles, N). The reduction over C runs in chunks of 16 channels through
// a two-stage ring: cp.async brings the raw (th+2) x (tw+2) halo tile of x
// and the 9 x 16 x 64 slab of the kernel for chunk i+1 into shared memory
// while chunk i is multiplied. Between arrival and use, one pass turns the
// raw tile into the activation tile (normalize, SiLU, round to the input
// type, zero outside the image and past C). x is read in place with bounds
// checks: no padded copy exists in device memory.
//   fp32: the 256 threads are 16 pixel groups x 16 channel groups; a thread
// accumulates up to 8 pixels x 4 output channels; the activation tile is
// fp32 [channel][halo pixel].
//   bf16: each of the 8 warps owns 16 pixels x all 64 output channels (8
// accumulator tiles of 16 x 8); the activation tile is bf16 [halo pixel]
// [channel], so a tap's A fragment is one ldmatrix whose 16 row addresses
// are the tap's 16 halo pixels (the im2col gather costs nothing), and a B
// fragment is an ldmatrix.trans of the slab's [channel][Co] rows. Rows are
// padded (24 and 72 elements) so that both reads are free of bank conflicts.
//
// K7's statistics: every block first reduces its own sample's 2*groups
// sums from global memory (L2 serves the repeats: the blocks of a sample
// read the same H*W*C elements). Threads own fixed 16-byte channel vectors
// and stride over pixels; per-lane partial sums meet in shared memory in a
// fixed order, so the result does not change from run to run. This costs
// one extra pass over the sample per block; a cooperative launch that
// reduces once and grid-syncs is the later, faster cut.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCoTile = 64;                          // output channels per block
constexpr int kCoPerThread = 4;
constexpr int kCoGroups = kCoTile / kCoPerThread;    // 16
constexpr int kPixGroups = kThreads / kCoGroups;     // 16
constexpr int kMaxPix = 128;                         // pixels per block tile
constexpr int kPixPerThread = kMaxPix / kPixGroups;  // 8
constexpr int kChunk = 16;                           // input channels per stage: one mma's depth
constexpr int kWStride = kCoTile + 8;                // slab row stride (conflict-free ldmatrix)
constexpr int kActStride = kChunk + 8;               // bf16 activation row stride (the same)
constexpr int kMaxSmem = 227 * 1024;
// the 8 x 4 accumulators serve both layouts, and 8 warps cover the pixel tile
static_assert(kPixPerThread == kCoTile / 8 && kCoPerThread == 4 && kThreads / 32 * 16 == kMaxPix,
              "accumulator layouts");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Four 8 x 8 b16 matrices: lane l supplies the 16-byte row l % 8 of matrix
// l / 8 and receives elements (l / 4, 2 * (l % 4) + {0, 1}) of each, or with
// .trans elements (2 * (l % 4) + {0, 1}, l / 4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
// c (16 x 8, fp32) += a (16 x 16, bf16, row-major) * b (16 x 8, bf16, column-major)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Geometry of one block's tile, the same for every block of a launch.
struct Tile {
  int th, tw;   // output pixels: rows, columns
  int hw;       // halo columns, tw + 2
  int hp;       // halo pixels, (th + 2) * (tw + 2)
  int hps;      // odd row stride of the activation tile (conflict-free fill)
};

__host__ __device__ inline Tile make_tile(int th, int tw) {
  Tile t;
  t.th = th;
  t.tw = tw;
  t.hw = tw + 2;
  t.hp = (th + 2) * (tw + 2);
  t.hps = t.hp | 1;
  return t;
}

// Dynamic shared memory, in this order (every part 16-byte aligned):
//   T     x_raw[2][hp][kChunk]        raw halo tile, channel innermost
//   T     w[2][9][kChunk][kWStride]   kernel slab
//   act                               activation tile: fp32 [kChunk][hps], or
//                                     bf16 [hp][kActStride]
//   float scale[c_pad], bias[c_pad]   per-channel normalisation of this sample
//   float stat[2 * groups]            K7: group mean and inverse deviation
template <typename T>
struct Smem {
  T* x_raw;
  T* w;
  float* act;
  float* scale;
  float* bias;
  float* stat;
  static constexpr int kWElems = 9 * kChunk * kWStride;
  static constexpr bool kMma = sizeof(T) == 2;   // bf16: tensor-core products

  // floats the activation tile takes, a multiple of 4
  __host__ __device__ static int act_floats(const Tile& t) {
    return ((kMma ? t.hp * kActStride / 2 : kChunk * t.hps) + 3) & ~3;
  }
  __host__ __device__ static size_t bytes(const Tile& t, int c, int groups) {
    const int c_pad = (c + 3) & ~3;
    return sizeof(T) * (2 * (size_t)t.hp * kChunk + 2 * kWElems) +
           sizeof(float) * ((size_t)act_floats(t) + 2 * c_pad + 2 * groups);
  }
  __device__ Smem(unsigned char* raw, const Tile& t, int c) {
    const int c_pad = (c + 3) & ~3;
    x_raw = reinterpret_cast<T*>(raw);
    w = x_raw + 2 * t.hp * kChunk;
    act = reinterpret_cast<float*>(w + 2 * kWElems);
    scale = act + act_floats(t);
    bias = scale + c_pad;
    stat = bias + c_pad;
  }
};

// The shared main loop: the block's th x tw x 64 output tile of sample n at
// (y0, x0, co0), from x, the kernel and the per-channel scale and bias in
// shared memory. `emb_row` (K7) is added to x in fp32 before normalising;
// nullptr for none.
template <typename T>
__device__ __forceinline__ void conv_tile(const T* __restrict__ x, const T* __restrict__ w,
                                          const T* __restrict__ bias,
                                          const T* __restrict__ emb_row, T* __restrict__ out,
                                          const Smem<T>& sm, const Tile& t, int n, int h,
                                          int wd, int c, int co, int y0, int x0, int co0) {
  using V = dct::Vec16<T>;
  constexpr int kVec = V::kVec;
  constexpr int kWElems = Smem<T>::kWElems;
  constexpr bool kMma = Smem<T>::kMma;
  const int tid = threadIdx.x;
  const int npix = t.th * t.tw;
  // fp32: this thread's 4 output channels cg and its pixels pg, pg + 16, ...
  const int cg = tid % kCoGroups;
  const int pg = tid / kCoGroups;
  const int nj = (npix + kPixGroups - 1) / kPixGroups;
  // bf16: the warp's pixels 16 * warp .. + 15; this lane's ldmatrix row in
  // the activation tile (pixel frow, channels 0-7 or 8-15) and in a tap's
  // slab (channel frow, output channels 0-7 or 8-15 of a pair of tiles)
  const int warp = tid / 32, lane = tid % 32;
  const int frow = (lane & 7) + ((lane >> 3) & 1) * 8, fcol = (lane >> 4) * 8;
  const int a_pix = warp * 16 + frow;
  const int a_off = (a_pix < npix ? (a_pix / t.tw) * t.hw + a_pix % t.tw : 0) * kActStride + fcol;
  const int b_off = frow * kWStride + fcol;

  int off[kPixPerThread];           // fp32: halo-tile offset of each pixel's top-left tap
#pragma unroll
  for (int j = 0; j < kPixPerThread; ++j) {
    const int p = pg + kPixGroups * j;
    off[j] = p < npix ? (p / t.tw) * t.hw + p % t.tw : 0;
  }
  // fp32: [pixel][output channel]; bf16: [tile of 8 output channels][c0..c3]
  float acc[kPixPerThread][kCoPerThread];
#pragma unroll
  for (int j = 0; j < kPixPerThread; ++j)
#pragma unroll
    for (int e = 0; e < kCoPerThread; ++e) acc[j][e] = 0.f;

  // cp.async of chunk c0 into ring slot `buf`; what lies outside the image,
  // past C or past Co is not read (the kernel slab is zero-filled there, the
  // activation pass writes zeros for the rest)
  auto stage = [&](int c0, int buf) {
    T* sx = sm.x_raw + buf * t.hp * kChunk;
    T* sw = sm.w + buf * kWElems;
    constexpr int kVecPerPix = kChunk / kVec;
    for (int i = tid; i < t.hp * kVecPerPix; i += kThreads) {
      const int pix = i / kVecPerPix, v = i % kVecPerPix;
      const int y = y0 + pix / t.hw - 1, xx = x0 + pix % t.hw - 1;
      const int ch = c0 + v * kVec;
      if (y >= 0 && y < h && xx >= 0 && xx < wd && ch < c)
        cp_async16(sx + pix * kChunk + v * kVec,
                   x + (((size_t)n * h + y) * wd + xx) * c + ch);
    }
    constexpr int kVecPerRow = kCoTile / kVec;
    for (int i = tid; i < 9 * kChunk * kVecPerRow; i += kThreads) {
      const int row = i / kVecPerRow, v = i % kVecPerRow;   // row = tap * kChunk + k
      const int ch = c0 + row % kChunk, oc = co0 + v * kVec;
      T* dst = sw + row * kWStride + v * kVec;
      if (ch < c && oc < co)
        cp_async16(dst, w + ((size_t)(row / kChunk) * c + ch) * co + oc);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    cp_async_commit();
  };

  const int nchunks = (c + kChunk - 1) / kChunk;
  stage(0, 0);
  for (int ci = 0; ci < nchunks; ++ci) {
    const int buf = ci & 1, c0 = ci * kChunk;
    if (ci + 1 < nchunks) {
      stage(c0 + kChunk, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // raw tile -> activation tile
    const T* sx = sm.x_raw + buf * t.hp * kChunk;
    __nv_bfloat16* act16 = reinterpret_cast<__nv_bfloat16*>(sm.act);
    for (int i = tid; i < t.hp * kChunk; i += kThreads) {
      const int pix = i / kChunk, k = i % kChunk;
      const int y = y0 + pix / t.hw - 1, xx = x0 + pix % t.hw - 1;
      const int ch = c0 + k;
      float a = 0.f;
      if (y >= 0 && y < h && xx >= 0 && xx < wd && ch < c) {
        float v = to_float(sx[pix * kChunk + k]);
        if (emb_row != nullptr) v += to_float(emb_row[ch]);
        a = v * sm.scale[ch] + sm.bias[ch];
        a = a / (1.f + expf(-a));
        a = dct::round_to<T>(a);
      }
      if constexpr (kMma)
        act16[pix * kActStride + k] = __float2bfloat16(a);
      else
        sm.act[k * t.hps + pix] = a;
    }
    __syncthreads();

    if constexpr (kMma) {
      if (warp * 16 < npix) {
        const T* sw = sm.w + buf * kWElems + b_off;
        for (int tap = 0; tap < 9; ++tap) {
          uint32_t a[4];
          ldmatrix_x4(a, act16 + a_off + ((tap / 3) * t.hw + tap % 3) * kActStride);
          const T* wt = sw + tap * kChunk * kWStride;
#pragma unroll
          for (int j = 0; j < kCoTile / 16; ++j) {
            uint32_t b[4];   // two tiles of 8 output channels
            ldmatrix_x4_trans(b, wt + 16 * j);
            mma_bf16(acc[2 * j], a, b[0], b[1]);
            mma_bf16(acc[2 * j + 1], a, b[2], b[3]);
          }
        }
      }
    } else {
      const T* sw = sm.w + buf * kWElems + cg * kCoPerThread;
      for (int tap = 0; tap < 9; ++tap) {
        const float* arow = sm.act + (tap / 3) * t.hw + tap % 3;
        const T* wrow = sw + tap * kChunk * kWStride;
#pragma unroll 4
        for (int k = 0; k < kChunk; ++k) {
          float wv[kCoPerThread];
          dct::load4(wrow + k * kWStride, wv);
          const float* ak = arow + k * t.hps;
#pragma unroll
          for (int j = 0; j < kPixPerThread; ++j) {
            if (j < nj) {
              const float a = ak[off[j]];
#pragma unroll
              for (int e = 0; e < kCoPerThread; ++e) acc[j][e] = fmaf(a, wv[e], acc[j][e]);
            }
          }
        }
      }
    }
    __syncthreads();   // the next stage overwrites this slot's neighbour and act
  }

  if constexpr (kMma) {
    // an accumulator tile holds rows lane / 4 and lane / 4 + 8 of the warp's
    // pixels, columns 2 * (lane % 4) + {0, 1} of its 8 output channels
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = warp * 16 + lane / 4 + 8 * half;
      const int y = y0 + p / t.tw, xx = x0 + p % t.tw;
      if (p >= npix || y >= h || xx >= wd) continue;
      T* row = out + (((size_t)n * h + y) * wd + xx) * co;
#pragma unroll
      for (int j = 0; j < kCoTile / 8; ++j) {
        const int oc = co0 + 8 * j + 2 * (lane % 4);
        if (oc >= co) break;
        const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + oc));
        *reinterpret_cast<__nv_bfloat162*>(row + oc) =
            __floats2bfloat162_rn(acc[j][2 * half] + b.x, acc[j][2 * half + 1] + b.y);
      }
    }
  } else {
    const int oc = co0 + cg * kCoPerThread;
    if (oc >= co) return;
    float b[kCoPerThread];
    dct::load4(bias + oc, b);
#pragma unroll
    for (int j = 0; j < kPixPerThread; ++j) {
      const int p = pg + kPixGroups * j;
      const int y = y0 + p / t.tw, xx = x0 + p % t.tw;
      if (p < npix && y < h && xx < wd)
        dct::store4(out + (((size_t)n * h + y) * wd + xx) * co + oc, acc[j][0] + b[0],
                    acc[j][1] + b[1], acc[j][2] + b[2], acc[j][3] + b[3]);
    }
  }
}

// K7: statistics of the block's sample, then the conv tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_gn_silu_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                          const T* __restrict__ bias, const float* __restrict__ gn_scale,
                          const float* __restrict__ gn_bias, const T* __restrict__ emb,
                          T* __restrict__ out, int h, int wd, int c, int co, int groups,
                          float eps, int th, int tw, int tiles_x) {
  using V = dct::Vec16<T>;
  constexpr int kVec = V::kVec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Tile t = make_tile(th, tw);
  const Smem<T> sm(smem_raw, t, c);
  const int tid = threadIdx.x;
  const int n = blockIdx.z;
  const T* emb_row = emb != nullptr ? emb + (size_t)n * c : nullptr;

  // per-channel sums of v = x + emb and v^2 over the sample's pixels: a
  // thread keeps one 16-byte channel vector and strides over pixels
  const int nvec = c / kVec;
  const int vec_lanes = nvec < kThreads ? nvec : kThreads;
  const int lanes = kThreads / vec_lanes;
  const int lane = tid / vec_lanes;
  float* part1 = reinterpret_cast<float*>(sm.w);   // [lanes][c], free until the ring starts
  float* part2 = part1 + lanes * c;
  if (lane < lanes) {
    const T* xs = x + (size_t)n * h * wd * c;
    for (int cv = tid % vec_lanes; cv < nvec; cv += vec_lanes) {
      float s1[kVec], s2[kVec], e[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) s1[i] = s2[i] = e[i] = 0.f;
      if (emb_row != nullptr) V::load(emb_row + cv * kVec, e);
      for (int p = lane; p < h * wd; p += lanes) {
        float f[kVec];
        V::load(xs + (size_t)p * c + cv * kVec, f);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float v = f[i] + e[i];
          s1[i] += v;
          s2[i] = fmaf(v, v, s2[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        part1[lane * c + cv * kVec + i] = s1[i];
        part2[lane * c + cv * kVec + i] = s2[i];
      }
    }
  }
  __syncthreads();
  const int cpg = c / groups;
  const float n_el = (float)h * (float)wd * (float)cpg;
  for (int g = tid; g < groups; g += kThreads) {
    float t1 = 0.f, t2 = 0.f;
    for (int l = 0; l < lanes; ++l)
      for (int i = 0; i < cpg; ++i) {
        t1 += part1[l * c + g * cpg + i];
        t2 += part2[l * c + g * cpg + i];
      }
    const float mean = t1 / n_el;
    const float var = t2 / n_el - mean * mean;
    sm.stat[g] = mean;
    sm.stat[groups + g] = rsqrtf(var + eps);
  }
  __syncthreads();
  for (int ch = tid; ch < c; ch += kThreads) {
    const int g = ch / cpg;
    const float sc = gn_scale[ch] * sm.stat[groups + g];
    sm.scale[ch] = sc;
    sm.bias[ch] = gn_bias[ch] - sm.stat[g] * sc;
  }
  __syncthreads();

  conv_tile<T>(x, w, bias, emb_row, out, sm, t, n, h, wd, c, co,
               (blockIdx.x / tiles_x) * th, (blockIdx.x % tiles_x) * tw,
               blockIdx.y * kCoTile);
}

// K8: scale and bias per (n, c) are given; x already holds x + emb.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_conv_tiled_kernel(const T* __restrict__ x, const float* __restrict__ scale_nc,
                        const float* __restrict__ bias_nc, const T* __restrict__ w,
                        const T* __restrict__ bias, T* __restrict__ out, int h, int wd,
                        int c, int co, int th, int tw, int tiles_x) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Tile t = make_tile(th, tw);
  const Smem<T> sm(smem_raw, t, c);
  const int n = blockIdx.z;
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    sm.scale[ch] = scale_nc[(size_t)n * c + ch];
    sm.bias[ch] = bias_nc[(size_t)n * c + ch];
  }
  __syncthreads();
  conv_tile<T>(x, w, bias, nullptr, out, sm, t, n, h, wd, c, co,
               (blockIdx.x / tiles_x) * th, (blockIdx.x % tiles_x) * tw,
               blockIdx.y * kCoTile);
}

// What both launches require; the grid on success.
template <typename T>
cudaError_t plan(int n, int h, int wd, int c, int co, int groups, int th, int tw,
                 dim3* grid, size_t* smem) {
  constexpr int kVec = dct::Vec16<T>::kVec;
  if (n < 1 || n > 65535 || h < 1 || wd < 1 || c < kVec || co < kVec || c % kVec != 0 ||
      co % kVec != 0 || groups < 1 || c % groups != 0 || th < 1 || tw < 1 ||
      th * tw > kMaxPix)
    return cudaErrorInvalidValue;
  const int tiles_y = (h + th - 1) / th, tiles_x = (wd + tw - 1) / tw;
  const int tiles_co = (co + kCoTile - 1) / kCoTile;
  if (tiles_co > 65535) return cudaErrorInvalidValue;
  *smem = Smem<T>::bytes(make_tile(th, tw), c, groups);
  if (*smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  *grid = dim3(tiles_y * tiles_x, tiles_co, n);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_fused(const void* x, const void* w, const void* bias,
                         const void* gn_scale, const void* gn_bias, const void* emb,
                         void* out, int n, int h, int wd, int c, int co, int groups,
                         float eps, int th, int tw, cudaStream_t stream) {
  constexpr int kVec = dct::Vec16<T>::kVec;
  dim3 grid;
  size_t smem;
  cudaError_t err = plan<T>(n, h, wd, c, co, groups, th, tw, &grid, &smem);
  if (err != cudaSuccess) return err;
  // the per-lane partial sums borrow the kernel-slab ring
  const int nvec = c / kVec;
  const int lanes = kThreads / (nvec < kThreads ? nvec : kThreads);
  if (sizeof(float) * 2 * (size_t)lanes * c > sizeof(T) * 2 * Smem<T>::kWElems)
    return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(fused_gn_silu_conv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fused_gn_silu_conv_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<const float*>(gn_scale), static_cast<const float*>(gn_bias),
      static_cast<const T*>(emb), static_cast<T*>(out), h, wd, c, co, groups, eps, th, tw,
      (wd + tw - 1) / tw);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tiled(const void* x, const void* scale_nc, const void* bias_nc,
                         const void* w, const void* bias, void* out, int n, int h, int wd,
                         int c, int co, int th, int tw, cudaStream_t stream) {
  dim3 grid;
  size_t smem;
  cudaError_t err = plan<T>(n, h, wd, c, co, 1, th, tw, &grid, &smem);
  if (err != cudaSuccess) return err;
  if (h % th != 0) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(fused_conv_tiled_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fused_conv_tiled_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale_nc),
      static_cast<const float*>(bias_nc), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<T*>(out), h, wd, c, co, th, tw,
      (wd + tw - 1) / tw);
  return cudaGetLastError();
}

}  // namespace

// x (N, H, W, C), w (3, 3, C, Co), bias (Co,), emb (N, C) or null, out
// (N, H, W, Co) of `dtype`; gn_scale, gn_bias (C,) fp32. th x tw is the
// block's pixel tile (th * tw <= 128).
extern "C" int dct_fused_gn_silu_conv(const void* x, const void* w, const void* bias,
                                      const void* gn_scale, const void* gn_bias,
                                      const void* emb, void* out, int dtype, int n, int h,
                                      int wd, int c, int co, int groups, float eps, int th,
                                      int tw, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dct::kBFloat16)
    return launch_fused<__nv_bfloat16>(x, w, bias, gn_scale, gn_bias, emb, out, n, h, wd, c,
                                       co, groups, eps, th, tw, s);
  if (dtype == dct::kFloat32)
    return launch_fused<float>(x, w, bias, gn_scale, gn_bias, emb, out, n, h, wd, c, co,
                               groups, eps, th, tw, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x (N, H, W, C) holding x + emb, scale_nc and bias_nc (N, C) fp32; th is
// the entry's tile_h and divides H.
extern "C" int dct_fused_gn_silu_conv_tiled(const void* x, const void* scale_nc,
                                            const void* bias_nc, const void* w,
                                            const void* bias, void* out, int dtype, int n,
                                            int h, int wd, int c, int co, int th, int tw,
                                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dct::kBFloat16)
    return launch_tiled<__nv_bfloat16>(x, scale_nc, bias_nc, w, bias, out, n, h, wd, c, co,
                                       th, tw, s);
  if (dtype == dct::kFloat32)
    return launch_tiled<float>(x, scale_nc, bias_nc, w, bias, out, n, h, wd, c, co, th, tw,
                               s);
  return static_cast<int>(cudaErrorInvalidValue);
}
