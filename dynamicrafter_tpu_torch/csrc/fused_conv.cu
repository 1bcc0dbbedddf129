// K7 and K8: fused [add-emb] -> GroupNorm -> SiLU -> 3x3 same conv + bias on
// (N, H, W, C) activations with an HWIO (3, 3, C, Co) kernel, for Hopper
// (sm_90a).
//
// K7 replaces the Pallas kernel experiments/fused_conv/fused_conv.py::_kernel
// (GroupNorm statistics E[v^2] - mean^2 in fp32 over H*W*(C/groups) values
// of v = x + emb, the sum never rounded); K8 replaces
// experiments/fused_conv/fused_conv_tiled.py::_kernel (two-pass variance
// mean((v - mean)^2) from a pre-pass, and x + emb ROUNDED to the input
// type before it is normalised). Both then compute, per output pixel, the
// sum over the 9 taps and C input channels of act * w with act = silu(v *
// scale + bias) rounded to the input type and ZERO outside the image: the
// padding ring is zeroed after SiLU, not before (silu(0 * scale + bias) !=
// 0). Products accumulate in fp32, the conv bias is added in fp32, and the
// result is rounded once at the store.
//
// What bounds it: 2*N*H*W*C*Co*9 operations on (N*H*W*(C + Co) + 9*C*Co)
// elements, 1440 FLOP per byte at C = Co = 320 in bf16: operations, 0.153 ms
// at (32, 40, 64, 320 -> 320) on the 989 TFLOP/s bf16 peak.
//
// The route is chosen here, in each C entry, by dtype:
//   bf16 -> gn_stats_kernel + gn_stats_finish_kernel (dct_gn_stats, called
// by the wrappers first: statistics read once per sample, K7 in moments,
// K8 in two-pass mode), then fused_conv_tc_kernel: wgmma on the tensor
// cores fed by TMA through an mbarrier ring (design below). K7 is two
// launches of hand-written kernels, as K4 is with its di pre-pass; K8 adds
// and rounds emb inside the conv, so x + emb is never written to memory.
//   fp32 -> the first kernels, unchanged: fused_gn_silu_conv_kernel<float>
// (statistics per block, from raw x) and fused_conv_tiled_kernel<float>
// (plain pre-pass, x + emb given), fp32 FMAs on the CUDA cores (TF32 would
// drop 13 bits of each operand against the 1e-5 fp32 tolerance). A block
// owns th x tw <= 128 pixels (pick_tile) and 64 output channels of one
// sample; a two-stage cp.async ring brings the raw halo tile and the 9 x 16
// x 64 kernel slab of 16-channel chunks; one pass makes the fp32 activation
// tile [channel][halo pixel] (zero outside the image and past C); each of
// the 256 threads accumulates up to 8 pixels x 4 output channels.
//
// The bf16 conv, fused_conv_tc_kernel (its own comment has the pipeline):
// implicit GEMM over the N*H x W image that stacks the samples, blocks of
// 128 output pixels (pick_tile_tc: 8 x 16 at every ResBlock shape) and 160
// output channels (every UNet width, 320 k, is whole blocks; other Co are
// masked); 64-channel chunks; a ring of 96 KB (4 slots of one tap's 64 x
// 160 weights). The bring-up probe (`git show 664e858:dynamicrafter_tpu_
// torch/experiments/fused_conv/probe_tc_variants.py`, removed after it
// ran) timed the kernel beside edited copies of it (NVIDIA H100 80GB HBM3,
// 700 W, the
// conv alone, (32, 40, 64, 320 -> 320)): a 144 KB ring 1.011x its time (the
// loads are not what it waits for); silu through an IEEE reciprocal 1.367x
// (__expf and the approximate divide kept); silu through tanh.approx 0.932x
// at 3x the error against plain (not kept). Diagnostics: without the
// activation pass after the first chunk 0.745x, without weight loads once
// the ring is full 0.981x, with a quarter of the products 0.763x: the
// activation pass between the chunks' products and the products' own rate
// hold it back, about equally. Tried in bring-up and not kept: the pass
// overlapped with the products (two activation tiles, a part of the pass
// after each tap's products; slower, with and without spills), and three
// warps of their own filling two activation tiles a chunk ahead (a few per
// cent, for a third role); setmaxnreg (producer at 40 registers, consumers
// at 232) made a 288-thread block trap at launch.

#include "hopper.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCoTile = 64;                          // output channels per block
constexpr int kCoPerThread = 4;
constexpr int kCoGroups = kCoTile / kCoPerThread;    // 16
constexpr int kPixGroups = kThreads / kCoGroups;     // 16
constexpr int kMaxPix = 128;                         // pixels per block tile
constexpr int kPixPerThread = kMaxPix / kPixGroups;  // 8
constexpr int kChunk = 16;                           // input channels per stage: one mma's depth
constexpr int kWStride = kCoTile + 8;                // slab row stride
constexpr int kMaxSmem = 227 * 1024;
static_assert(kPixGroups * kPixPerThread == kMaxPix, "the pixel groups cover the tile");

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
//   float act[kChunk][hps]            activation tile
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

  // floats the activation tile takes, a multiple of 4
  __host__ __device__ static int act_floats(const Tile& t) { return (kChunk * t.hps + 3) & ~3; }
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
  const int tid = threadIdx.x;
  const int npix = t.th * t.tw;
  // this thread's 4 output channels cg and its pixels pg, pg + 16, ...
  const int cg = tid % kCoGroups;
  const int pg = tid / kCoGroups;
  const int nj = (npix + kPixGroups - 1) / kPixGroups;

  int off[kPixPerThread];           // halo-tile offset of each pixel's top-left tap
#pragma unroll
  for (int j = 0; j < kPixPerThread; ++j) {
    const int p = pg + kPixGroups * j;
    off[j] = p < npix ? (p / t.tw) * t.hw + p % t.tw : 0;
  }
  // [pixel][output channel]
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
        dct::cp_async16(sx + pix * kChunk + v * kVec,
                   x + (((size_t)n * h + y) * wd + xx) * c + ch);
    }
    constexpr int kVecPerRow = kCoTile / kVec;
    for (int i = tid; i < 9 * kChunk * kVecPerRow; i += kThreads) {
      const int row = i / kVecPerRow, v = i % kVecPerRow;   // row = tap * kChunk + k
      const int ch = c0 + row % kChunk, oc = co0 + v * kVec;
      T* dst = sw + row * kWStride + v * kVec;
      if (ch < c && oc < co)
        dct::cp_async16(dst, w + ((size_t)(row / kChunk) * c + ch) * co + oc);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    dct::cp_async_commit();
  };

  const int nchunks = (c + kChunk - 1) / kChunk;
  stage(0, 0);
  for (int ci = 0; ci < nchunks; ++ci) {
    const int buf = ci & 1, c0 = ci * kChunk;
    if (ci + 1 < nchunks) {
      stage(c0 + kChunk, buf ^ 1);
      dct::cp_async_wait<1>();
    } else {
      dct::cp_async_wait<0>();
    }
    __syncthreads();

    // raw tile -> activation tile
    const T* sx = sm.x_raw + buf * t.hp * kChunk;
    for (int i = tid; i < t.hp * kChunk; i += kThreads) {
      const int pix = i / kChunk, k = i % kChunk;
      const int y = y0 + pix / t.hw - 1, xx = x0 + pix % t.hw - 1;
      const int ch = c0 + k;
      float a = 0.f;
      if (y >= 0 && y < h && xx >= 0 && xx < wd && ch < c) {
        float v = sx[pix * kChunk + k];
        if (emb_row != nullptr) v += emb_row[ch];
        a = v * sm.scale[ch] + sm.bias[ch];
        a = a / (1.f + expf(-a));
        a = dct::round_to<T>(a);
      }
      sm.act[k * t.hps + pix] = a;
    }
    __syncthreads();

    {
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

  {
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


// -- GroupNorm statistics once per sample (the bf16 route of both entries) ------
//
// gn_stats_kernel: block (split s, sample n) reduces pixels [s * split_px,
// (s + 1) * split_px) of sample n. Threads own 16-byte channel vectors and
// stride over the split's pixels (four loads in flight a thread, summed in
// pixel order); per-lane partial sums meet in shared memory and are summed
// per group in a fixed order. moments: (sum v, sum v^2) per group. two-pass:
// the block's group mean first, then sum (v - block mean)^2 over the same
// pixels (read again, mostly from L1): (block mean, M2) per group.
// gn_stats_finish_kernel: one block a sample merges the splits in order,
// moments as var = sum v^2 / n - mean^2 (K7's arithmetic), two-pass by
// Chan's formula (K8's var = mean((v - mean)^2)), and writes the per-(n, c)
// scale = gn_scale * rsqrt(var + eps) and bias = gn_bias - mean * scale.
// No atomics: the same input gives the same bits.
constexpr int kStatThreads = 256;

struct StatLanes {
  int vec_lanes;   // threads per pixel lane (one channel vector each)
  int lanes;       // pixel lanes
};
template <typename T>
__host__ __device__ inline StatLanes stat_lanes(int c) {
  const int nvec = c / dct::Vec16<T>::kVec;
  const int vl = nvec < kStatThreads ? nvec : kStatThreads;
  return {vl, kStatThreads / vl};
}

// Sums over this thread's pixels of its channel vectors into s1 (and s2):
// kMode 0: v and v^2; 1: v; 2: (v - mean of v's group)^2, means in `mean`.
template <typename T, int kMode>
__device__ __forceinline__ void stat_pass(const T* __restrict__ xs, const T* __restrict__ er,
                                          const float* mean, float* s1, float* s2,
                                          const StatLanes& sl, int p0, int p1, int c,
                                          int cpg) {
  using V = dct::Vec16<T>;
  constexpr int kVec = V::kVec;
  const int tid = threadIdx.x;
  const int lane = tid / sl.vec_lanes;
  if (lane < sl.lanes) {
    const int nvec = c / kVec, step = sl.lanes;
    for (int cv = tid % sl.vec_lanes; cv < nvec; cv += sl.vec_lanes) {
      float a1[kVec], a2[kVec], e[kVec], m[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) a1[i] = a2[i] = e[i] = m[i] = 0.f;
      if (er != nullptr) V::load(er + cv * kVec, e);
      if (kMode == 2) {
#pragma unroll
        for (int i = 0; i < kVec; ++i) m[i] = mean[(cv * kVec + i) / cpg];
      }
      auto add = [&](const float* f) {
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float v = f[i] + e[i];
          if (kMode == 0) {
            a1[i] += v;
            a2[i] = fmaf(v, v, a2[i]);
          } else if (kMode == 1) {
            a1[i] += v;
          } else {
            const float d = v - m[i];
            a1[i] = fmaf(d, d, a1[i]);
          }
        }
      };
      const T* src = xs + cv * kVec;
      int p = p0 + lane;
      for (; p + 3 * step < p1; p += 4 * step) {
        float f[4][kVec];
#pragma unroll
        for (int u = 0; u < 4; ++u) V::load(src + (size_t)(p + u * step) * c, f[u]);
#pragma unroll
        for (int u = 0; u < 4; ++u) add(f[u]);
      }
      for (; p < p1; p += step) {
        float f[kVec];
        V::load(src + (size_t)p * c, f);
        add(f);
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        s1[lane * c + cv * kVec + i] = a1[i];
        if (kMode == 0) s2[lane * c + cv * kVec + i] = a2[i];
      }
    }
  }
  __syncthreads();
}

// The per-lane sums of `part` ([lanes][c]) for group g, in a fixed order.
__device__ __forceinline__ float group_total(const float* part, int lanes, int c, int cpg, int g) {
  float t = 0.f;
  for (int l = 0; l < lanes; ++l)
    for (int i = 0; i < cpg; ++i) t += part[l * c + g * cpg + i];
  return t;
}

template <typename T, bool kTwoPass>
__global__ void __launch_bounds__(kStatThreads)
gn_stats_kernel(const T* __restrict__ x, const T* __restrict__ emb, float* __restrict__ part,
                int hw, int c, int groups, int split_px) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const StatLanes sl = stat_lanes<T>(c);
  float* s1 = reinterpret_cast<float*>(smem_raw);   // [lanes][c]
  float* s2 = s1 + sl.lanes * c;                    // [lanes][c]
  float* mean = s2 + sl.lanes * c;                  // [groups]
  const int tid = threadIdx.x, s = blockIdx.x, n = blockIdx.y;
  const int p0 = s * split_px, p1 = min(hw, p0 + split_px), cpg = c / groups;
  const T* xs = x + (size_t)n * hw * c;
  const T* er = emb != nullptr ? emb + (size_t)n * c : nullptr;
  float* out = part + ((size_t)n * gridDim.x + s) * groups * 2;
  if (!kTwoPass) {
    stat_pass<T, 0>(xs, er, nullptr, s1, s2, sl, p0, p1, c, cpg);
    for (int g = tid; g < groups; g += kStatThreads) {
      out[2 * g] = group_total(s1, sl.lanes, c, cpg, g);
      out[2 * g + 1] = group_total(s2, sl.lanes, c, cpg, g);
    }
  } else {
    const float cnt = (float)(p1 - p0) * (float)cpg;
    stat_pass<T, 1>(xs, er, nullptr, s1, nullptr, sl, p0, p1, c, cpg);
    for (int g = tid; g < groups; g += kStatThreads)
      mean[g] = group_total(s1, sl.lanes, c, cpg, g) / cnt;
    __syncthreads();
    stat_pass<T, 2>(xs, er, mean, s1, nullptr, sl, p0, p1, c, cpg);
    for (int g = tid; g < groups; g += kStatThreads) {
      out[2 * g] = mean[g];
      out[2 * g + 1] = group_total(s1, sl.lanes, c, cpg, g);
    }
  }
}

template <bool kTwoPass>
__global__ void __launch_bounds__(kStatThreads)
gn_stats_finish_kernel(const float* __restrict__ part, const float* __restrict__ gn_scale,
                       const float* __restrict__ gn_bias, float* __restrict__ scale_nc,
                       float* __restrict__ bias_nc, int hw, int c, int groups, int splits,
                       int split_px, float eps) {
  extern __shared__ float stat[];   // [groups] mean, [groups] inverse deviation
  const int n = blockIdx.x, cpg = c / groups;
  const float n_el = (float)hw * (float)cpg;
  for (int g = threadIdx.x; g < groups; g += kStatThreads) {
    const float* pg = part + (size_t)n * splits * groups * 2 + 2 * g;
    float mean, var;
    if (!kTwoPass) {
      float t1 = 0.f, t2 = 0.f;
      for (int s = 0; s < splits; ++s) {
        t1 += pg[(size_t)s * groups * 2];
        t2 += pg[(size_t)s * groups * 2 + 1];
      }
      mean = t1 / n_el;
      var = t2 / n_el - mean * mean;
    } else {
      float na = 0.f, m2 = 0.f;
      mean = 0.f;
      for (int s = 0; s < splits; ++s) {
        const float nb = (float)(min(hw, (s + 1) * split_px) - s * split_px) * (float)cpg;
        const float mb = pg[(size_t)s * groups * 2], m2b = pg[(size_t)s * groups * 2 + 1];
        const float nt = na + nb, d = mb - mean;
        mean += d * (nb / nt);
        m2 += m2b + d * d * (na * nb / nt);
        na = nt;
      }
      var = m2 / n_el;
    }
    stat[g] = mean;
    stat[groups + g] = rsqrtf(var + eps);
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += kStatThreads) {
    const int g = ch / cpg;
    const float sc = gn_scale[ch] * stat[groups + g];
    scale_nc[(size_t)n * c + ch] = sc;
    bias_nc[(size_t)n * c + ch] = gn_bias[ch] - stat[g] * sc;
  }
}

template <typename T, bool kTwoPass>
cudaError_t launch_stats(const void* x, const void* gn_scale, const void* gn_bias,
                         const void* emb, void* part, void* scale_nc, void* bias_nc, int n,
                         int hw, int c, int groups, float eps, int splits,
                         cudaStream_t stream) {
  constexpr int kVec = dct::Vec16<T>::kVec;
  if (n < 1 || n > 65535 || hw < 1 || c < kVec || c % kVec != 0 || groups < 1 ||
      c % groups != 0 || splits < 1 || splits > 65535)
    return cudaErrorInvalidValue;
  const int split_px = (hw + splits - 1) / splits;
  if ((splits - 1) * split_px >= hw) return cudaErrorInvalidValue;   // an empty split
  const StatLanes sl = stat_lanes<T>(c);
  const size_t smem = sizeof(float) * (2 * (size_t)sl.lanes * c + groups);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gn_stats_kernel<T, kTwoPass>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  gn_stats_kernel<T, kTwoPass><<<dim3(splits, n), kStatThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(emb), static_cast<float*>(part), hw, c,
      groups, split_px);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_stats_finish_kernel<kTwoPass><<<n, kStatThreads, sizeof(float) * 2 * groups, stream>>>(
      static_cast<const float*>(part), static_cast<const float*>(gn_scale),
      static_cast<const float*>(gn_bias), static_cast<float*>(scale_nc),
      static_cast<float*>(bias_nc), hw, c, groups, splits, split_px, eps);
  return cudaGetLastError();
}

// -- The bf16 main loop on wgmma + TMA: fused_conv_tc_kernel (K7 and K8) ---------
//
// M = output pixels, N = output channels, K = 9 taps x C. x is seen as one
// tall image of N*H rows, a 3-D tensor map (C, W, N*H), so that a tile may
// straddle two samples (at 10 x 16, 32 samples are 40 whole 8 x 16 tiles):
// a tap that falls outside its pixel's own sample or image reads the zero
// row of the activation tile instead, chosen per lane. A block owns th x tw
// <= 128 output pixels (tall rows r0.., columns x0..) and kBN output
// channels from co0; blocks of one pixel tile are neighbours in the grid,
// so its x is read from L2 for the second Co tile. Warp 8 is the producer;
// warps 0-7 are two consumer warpgroups, warp w owning tile pixels 16w ..
// 16w + 15.
//
// Per chunk of kKc = 64 input channels, the producer's lane 0 loads by TMA
// the raw (th + 2) x (tw + 2) x 64 halo box of x (negative and past-the-end
// coordinates read as zero) into one of two raw slots, and, per tap, the
// 64 x kBN weight slab (64-wide boxes of the (Co, C, 9) view, 128-byte
// swizzle, channels past C and columns past Co read as zero; the third
// box's last 32 columns are loaded and not used; B is MN-major, Co
// contiguous, so wgmma reads it transposed) into a ring of kSlots slots
// with full / empty mbarriers. The consumers turn the raw box into the bf16
// activation tile once per chunk (v = x [+ emb], K8 rounding v to bf16;
// silu(v * scale + bias) rounded to bf16; scale and bias 0 past C), then per
// tap load each warp's 16 x 64 A rows with ldmatrix at the tap's shifted
// addresses (two register sets, so the next tap's loads never touch
// registers an in-flight wgmma reads) and issue 4 wgmma m64 x kBN x 16 on
// the slot. The slot goes back to the producer once its group is complete.
// The epilogue adds the bias in fp32, rounds once, and stores whole 16-byte
// rows through shared memory, masked at the image edge and at Co.
namespace tc {

constexpr int kKc = 64;                      // input channels per chunk
constexpr int kConsumers = 256;              // two warpgroups
constexpr int kThreads = kConsumers + 32;    // and one producer warp
constexpr int kActStride = kKc + 8;          // bf16 activation row (144 B: conflict-free ldmatrix)
constexpr int kRawRow = kKc * 2;             // bytes of a raw halo pixel
constexpr int kAtomBytes = kKc * 64 * 2;     // one 64 x 64 weight box, 128-byte swizzled
constexpr int kRingBytes = 96 * 1024;
constexpr int kMaxPixels = 128;

constexpr int kBN = 160;                     // output channels per block: UNet widths are 320 k
constexpr int kAtoms = (kBN + 63) / 64;      // 64-wide weight boxes a slot
constexpr int kSlotBytes = kAtoms * kAtomBytes;
constexpr int kSlots = kRingBytes / kSlotBytes;
constexpr int kOutStride = kBN + 8;          // staged output row (conflict-free stores)
static_assert(kSlots >= 2, "a ring");
static_assert(kMaxPixels * kOutStride * 2 <= kRingBytes, "the output is staged in the ring");

__host__ __device__ constexpr int align_up(int v, int a) { return (v + a - 1) / a * a; }

// Byte offsets from the 1024-byte aligned base: ring, raw[2], act (hp + 1
// rows, the last one zero), 2 * kSlots + 4 mbarriers, then the sample of
// each of the th + 2 halo rows (ints).
struct Layout {
  int raw[2], act, bars, rows, bytes;
};
__host__ __device__ inline Layout layout(int hp) {
  Layout l;
  const int raw = align_up(hp * kRawRow, 1024);
  l.raw[0] = kRingBytes;
  l.raw[1] = l.raw[0] + raw;
  l.act = l.raw[1] + raw;
  l.bars = l.act + align_up((hp + 1) * kActStride * 2, 1024);
  l.rows = l.bars + 64 * 8;
  l.bytes = l.rows + (kMaxPixels + 2) * 4 + 1024;   // and slack to align the base
  return l;
}

// 288 threads put three warps on one of the SM's four register files (16 K
// registers each), so ptxas holds the kernel to 168 registers a thread; it
// fits them with no spill only while the loop keeps few values besides the
// 80 accumulators and two sets of A fragments.
template <bool kRoundEmb>
__global__ void __launch_bounds__(kThreads, 1)
fused_conv_tc_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_w,
                     const float* __restrict__ scale_nc, const float* __restrict__ bias_nc,
                     const __nv_bfloat16* __restrict__ emb, const __nv_bfloat16* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int n, int h, int wd, int c, int co, int th,
                     int tw, int tiles_x, int co_tiles) {
  namespace hp_ = dct::hopper;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw_base = hp_::smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (align_up((int)raw_base, 1024) - (int)raw_base);
  const int hw = tw + 2, hp = (th + 2) * hw;
  const Layout L = layout(hp);
  uint64_t* w_full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* w_empty = w_full + kSlots;
  uint64_t* raw_full = w_empty + kSlots;
  uint64_t* raw_empty = raw_full + 2;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int co_t = blockIdx.x % co_tiles, pix_t = blockIdx.x / co_tiles;
  const int r0 = (pix_t / tiles_x) * th, x0 = (pix_t % tiles_x) * tw, co0 = co_t * kBN;
  const int rows = n * h, nchunks = (c + kKc - 1) / kKc;
  if (tid == 0) {
    for (int s = 0; s < kSlots; ++s) {
      hp_::mbar_init(&w_full[s], 1);
      hp_::mbar_init(&w_empty[s], kConsumers / 32);
    }
    for (int s = 0; s < 2; ++s) {
      hp_::mbar_init(&raw_full[s], 1);
      hp_::mbar_init(&raw_empty[s], kConsumers / 32);
    }
    hp_::mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // -- producer ------------------------------------------------------------
    if (lane == 0) {
      hp_::tma_prefetch_map(&map_x);
      hp_::tma_prefetch_map(&map_w);
      const uint32_t raw_bytes = (uint32_t)(hp * kRawRow);
      auto load_raw = [&](int ci) {
        const int s = ci & 1;
        if (ci >= 2) hp_::mbar_wait(&raw_empty[s], ((ci >> 1) - 1) & 1);
        hp_::mbar_arrive_expect_tx(&raw_full[s], raw_bytes);
        hp_::tma_load_3d(smem + L.raw[s], &map_x, &raw_full[s], ci * kKc, x0 - 1,
                         r0 - 1);
      };
      load_raw(0);
      int slot = 0;
      uint32_t phase = 0;
      for (int ci = 0; ci < nchunks; ++ci) {
        if (ci + 1 < nchunks) load_raw(ci + 1);
        for (int tap = 0; tap < 9; ++tap) {
          hp_::mbar_wait(&w_empty[slot], phase ^ 1);
          hp_::mbar_arrive_expect_tx(&w_full[slot], kSlotBytes);
          for (int a = 0; a < kAtoms; ++a)
            hp_::tma_load_3d(smem + slot * kSlotBytes + a * kAtomBytes, &map_w,
                             &w_full[slot], co0 + 64 * a, ci * kKc, tap);
          if (++slot == kSlots) {
            slot = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // -- consumers -----------------------------------------------------------
    __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(smem + L.act);
    if (tid < kActStride / 8)   // the zero row
      *reinterpret_cast<uint4*>(act + hp * kActStride + 8 * tid) = make_uint4(0, 0, 0, 0);

    // this lane's ldmatrix row: tile pixel p, channels fcol .. fcol + 7 of a
    // 16-channel step; per tap its element offset in act, or the zero row
    const int frow = (lane & 7) + ((lane >> 3) & 1) * 8, fcol = (lane >> 4) * 8;
    const int p = warp * 16 + frow, py = p / tw, px = p % tw;
    const int y = (r0 + py) % h, xx = x0 + px;
    const bool pvalid = p < th * tw && r0 + py < rows && xx < wd;
    int a_off[9];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      const bool ok = pvalid && y + dy >= 0 && y + dy < h && xx + dx >= 0 && xx + dx < wd;
      a_off[tap] = (ok ? (py + 1 + dy) * hw + px + 1 + dx : hp) * kActStride + fcol;
    }
    const uint32_t ring = hp_::smem_u32(smem);

    float acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;

    // the sample of each halo row (rows outside the tall image: the nearest)
    int* row_n = reinterpret_cast<int*>(smem + L.rows);
    for (int i = tid; i < th + 2; i += kConsumers) row_n[i] = min(max(r0 - 1 + i, 0) / h, n - 1);

    // the activation pass: thread (pl, v) owns channels 8v .. 8v + 7 of the
    // chunk and halo pixels pl, pl + 32, ...
    const int v = tid & 7, pl = tid >> 3;
    int slot = 0;
    uint32_t phase = 0;
    for (int ci = 0; ci < nchunks; ++ci) {
      const int s = ci & 1, ch = ci * kKc + 8 * v;
      hp_::named_bar_sync(1, kConsumers);   // every warp is done reading act
      hp_::mbar_wait(&raw_full[s], (ci >> 1) & 1);
      const __nv_bfloat16* raw = reinterpret_cast<const __nv_bfloat16*>(smem + L.raw[s]);
      int cur = -1;
      float sc[8], bs[8], em[8];
      int hr = pl / hw, hc = pl % hw;   // the halo row and column of pixel q
#pragma unroll 2
      for (int q = pl; q < hp; q += kConsumers / 8) {
        // the scale, bias and emb of the halo pixel's sample; zeros past C,
        // so that the activation is 0 there
        const int nn = row_n[hr];
        for (hc += kConsumers / 8; hc >= hw; hc -= hw) ++hr;
        if (nn != cur) {
          cur = nn;
#pragma unroll
          for (int i = 0; i < 8; ++i) sc[i] = bs[i] = em[i] = 0.f;
          if (ch < c) {
            const size_t nc = (size_t)nn * c + ch;
            dct::Vec16<float>::load(scale_nc + nc, sc);
            dct::Vec16<float>::load(scale_nc + nc + 4, sc + 4);
            dct::Vec16<float>::load(bias_nc + nc, bs);
            dct::Vec16<float>::load(bias_nc + nc + 4, bs + 4);
            if (emb != nullptr) dct::Vec16<__nv_bfloat16>::load(emb + nc, em);
          }
        }
        float f[8];
        dct::Vec16<__nv_bfloat16>::load(raw + q * kKc + 8 * v, f);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float a = f[i] + em[i];
          if (kRoundEmb) a = dct::round_to<__nv_bfloat16>(a);
          a = a * sc[i] + bs[i];
          f[i] = __fdividef(a, 1.f + __expf(-a));
        }
        dct::Vec16<__nv_bfloat16>::store(act + q * kActStride + 8 * v, f);
      }
      __syncwarp();
      if (lane == 0) hp_::mbar_arrive(&raw_empty[s]);
      hp_::named_bar_sync(1, kConsumers);   // act is whole

      uint32_t afrag[2][4][4];
      int prev = 0;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          dct::ldmatrix_x4(afrag[tap & 1][kk], act + a_off[tap] + 16 * kk);
        hp_::mbar_wait(&w_full[slot], phase);
        hp_::wgmma_fence();
        const uint32_t b = ring + slot * kSlotBytes;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hp_::WgmmaRS<kBN>::run(acc, afrag[tap & 1][kk],
                                 hp_::desc_b128(b + kk * 16 * 128, kAtomBytes, 8 * 128));
        hp_::wgmma_commit();
        if (tap > 0) {
          hp_::wgmma_wait<1>();
          if (lane == 0) hp_::mbar_arrive(&w_empty[prev]);
        }
        prev = slot;
        if (++slot == kSlots) {
          slot = 0;
          phase ^= 1;
        }
      }
      hp_::wgmma_wait<0>();
      if (lane == 0) hp_::mbar_arrive(&w_empty[prev]);
    }

    // epilogue: bias in fp32, one rounding, staged in the (now idle) ring
    hp_::named_bar_sync(1, kConsumers);
    __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(smem);
    const int row = warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4), oc = (blockIdx.x % co_tiles) * kBN + col;
      float2 bv = make_float2(0.f, 0.f);
      if (oc < co) bv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + oc));
      *reinterpret_cast<__nv_bfloat162*>(stage + row * kOutStride + col) =
          __floats2bfloat162_rn(acc[4 * j] + bv.x, acc[4 * j + 1] + bv.y);
      *reinterpret_cast<__nv_bfloat162*>(stage + (row + 8) * kOutStride + col) =
          __floats2bfloat162_rn(acc[4 * j + 2] + bv.x, acc[4 * j + 3] + bv.y);
    }
    hp_::named_bar_sync(1, kConsumers);
    // the tile's origin again, recomputed rather than held through the loop
    const int e_co0 = (blockIdx.x % co_tiles) * kBN, e_pix = blockIdx.x / co_tiles;
    const int e_r0 = (e_pix / tiles_x) * th, e_x0 = (e_pix % tiles_x) * tw;
    const int nv = min(kBN, co - e_co0) / 8, npix = th * tw;
    for (int i = tid; i < npix * nv; i += kConsumers) {
      const int q = i / nv, vv = i % nv;
      const int rr = e_r0 + q / tw, xq = e_x0 + q % tw;
      if (rr < n * h && xq < wd)
        *reinterpret_cast<uint4*>(out + ((size_t)rr * wd + xq) * co + e_co0 + 8 * vv) =
            *reinterpret_cast<const uint4*>(stage + q * kOutStride + 8 * vv);
    }
  }
}

template <bool kRoundEmb>
cudaError_t launch(const void* x, const void* w, const void* bias, const void* scale_nc,
                   const void* bias_nc, const void* emb, void* out, int n, int h, int wd, int c,
                   int co, int th, int tw, cudaStream_t stream) {
  if (n < 1 || h < 1 || wd < 1 || c < 8 || c % 8 != 0 || co < 8 || co % 8 != 0 || th < 1 ||
      tw < 1 || th * tw > kMaxPixels || tw + 2 > 256 || th + 2 > 256 || scale_nc == nullptr ||
      bias_nc == nullptr)
    return cudaErrorInvalidValue;
  const long long rows = (long long)n * h;
  const long long tiles_x = (wd + tw - 1) / tw, tiles_y = (rows + th - 1) / th;
  const long long co_tiles = (co + kBN - 1) / kBN;
  if (tiles_x * tiles_y * co_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = layout((th + 2) * (tw + 2)).bytes;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  CUtensorMap map_x, map_w;
  // x as (C, W, N*H): a raw halo box a load; the kernel as (Co, C, 9)
  const uint64_t xd[3] = {(uint64_t)c, (uint64_t)wd, (uint64_t)rows};
  const uint64_t xs[2] = {(uint64_t)c * 2, (uint64_t)wd * c * 2};
  const uint32_t xb[3] = {(uint32_t)kKc, (uint32_t)tw + 2, (uint32_t)th + 2};
  const uint64_t wdim[3] = {(uint64_t)co, (uint64_t)c, 9};
  const uint64_t ws[2] = {(uint64_t)co * 2, (uint64_t)c * co * 2};
  const uint32_t wb[3] = {64, (uint32_t)kKc, 1};
  cudaError_t err = dct::hopper::make_map_3d_bf16(&map_x, x, xd, xs, xb, false);
  if (err != cudaSuccess) return err;
  err = dct::hopper::make_map_3d_bf16(&map_w, w, wdim, ws, wb, true);
  if (err != cudaSuccess) return err;
  auto kernel = fused_conv_tc_kernel<kRoundEmb>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)(tiles_x * tiles_y * co_tiles), kThreads, smem, stream>>>(
      map_x, map_w, static_cast<const float*>(scale_nc), static_cast<const float*>(bias_nc),
      static_cast<const __nv_bfloat16*>(emb), static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), n, h, wd, c, co, th, tw, (int)tiles_x, (int)co_tiles);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace

// K7. x (N, H, W, C), w (3, 3, C, Co), bias (Co,), emb (N, C) or null, out
// (N, H, W, Co) of `dtype`; gn_scale, gn_bias (C,) fp32. bf16:
// fused_conv_tc_kernel on the per-(n, c) scale_nc and bias_nc (N, C) fp32
// that dct_gn_stats wrote (moments), emb added in fp32 and never rounded;
// th x tw <= 128 is the tile of the N*H x W tall image. fp32:
// fused_gn_silu_conv_kernel<float>, statistics in the launch; scale_nc and
// bias_nc are not read, th x tw <= 128 tiles one sample.
extern "C" int dct_fused_gn_silu_conv(const void* x, const void* w, const void* bias,
                                      const void* gn_scale, const void* gn_bias,
                                      const void* emb, void* out, int dtype, int n, int h,
                                      int wd, int c, int co, int groups, float eps, int th,
                                      int tw, const void* scale_nc, const void* bias_nc,
                                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dct::kBFloat16)
    return tc::launch<false>(x, w, bias, scale_nc, bias_nc, emb, out, n, h, wd, c, co, th, tw,
                             s);
  if (dtype == dct::kFloat32)
    return launch_fused<float>(x, w, bias, gn_scale, gn_bias, emb, out, n, h, wd, c, co,
                               groups, eps, th, tw, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K8. scale_nc and bias_nc (N, C) fp32. bf16: x is raw x and emb (N, C) or
// null is added and rounded to bf16 inside fused_conv_tc_kernel (scale and
// bias from dct_gn_stats, two-pass); th x tw as for K7. fp32:
// fused_conv_tiled_kernel<float> on x holding x + emb (emb must be null),
// th the entry's tile_h, dividing H.
extern "C" int dct_fused_gn_silu_conv_tiled(const void* x, const void* scale_nc,
                                            const void* bias_nc, const void* w,
                                            const void* bias, void* out, int dtype, int n,
                                            int h, int wd, int c, int co, int th, int tw,
                                            const void* emb, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dct::kBFloat16)
    return tc::launch<true>(x, w, bias, scale_nc, bias_nc, emb, out, n, h, wd, c, co, th, tw, s);
  if (dtype == dct::kFloat32 && emb == nullptr)
    return launch_tiled<float>(x, scale_nc, bias_nc, w, bias, out, n, h, wd, c, co, th, tw, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// GroupNorm statistics of bf16 x (N, H*W = hw, C) [+ emb (N, C), in fp32] in
// `groups` groups: scale_nc and bias_nc (N, C) fp32 with groupnorm(v) = v *
// scale + bias, from gn_scale and gn_bias (C,) fp32. `part` is fp32 scratch
// of N * splits * groups * 2; splits divides the pixels into nonempty runs
// of ceil(hw / splits). two_pass 0: var = E[v^2] - mean^2 (K7); 1: var =
// mean((v - mean)^2) (K8).
extern "C" int dct_gn_stats(const void* x, const void* gn_scale, const void* gn_bias,
                            const void* emb, void* part, void* scale_nc, void* bias_nc,
                            int dtype, int n, int hw, int c, int groups, float eps, int splits,
                            int two_pass, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != dct::kBFloat16) return static_cast<int>(cudaErrorInvalidValue);
  return two_pass ? launch_stats<__nv_bfloat16, true>(x, gn_scale, gn_bias, emb, part, scale_nc,
                                                      bias_nc, n, hw, c, groups, eps, splits, s)
                  : launch_stats<__nv_bfloat16, false>(x, gn_scale, gn_bias, emb, part,
                                                       scale_nc, bias_nc, n, hw, c, groups, eps,
                                                       splits, s);
}
