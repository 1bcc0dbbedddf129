// GroupNorm (with an optional per-(n, c) add before it and SiLU after it)
// and LayerNorm on bf16 or fp32 activations: the input read in place,
// statistics and affine in fp32, the output written once in the input's
// dtype (LayerNorm: or fp32).
//
// These replace no TPU kernel: the JAX package's norms are XLA fusions. On
// the card the port ran them as fp32 islands (x.float(), the library norm
// in fp32, a cast back, then SiLU and the emb add as passes of their own):
// about 28 bytes an element for GN + SiLU and 20 for LN, where this reads
// bf16 once or twice and writes it once (4-6 bytes). Both kernels are bound
// by bytes; the design keeps the reads to one wherever the data fits on
// chip, and the arithmetic per 16-byte vector small (index math by
// multiply-high division, no 64-bit division, SiLU through __expf).
//
// An element's value is v = x + add[n, c] rounded to the input dtype (the
// caller's `x + emb_out`), y = v * scale_c + bias_c with scale_c = w_c *
// rsqrt(var + eps), bias_c = b_c - mean * scale_c, then optionally SiLU in
// fp32, rounded once. Statistics: each thread sums its values less the
// first one it saw, and reads them out as (count, mean, M2); threads,
// warps and blocks merge those by Chan's formula in a fixed order
// (shuffle-down trees, then by rank), so the same input gives the same
// bits, with no atomics on the data and no E[v^2] - mean^2 over a group.
//
// GroupNorm reads x in one of two layouts and writes the output in it:
//   per-channel: x viewed as (N, C, R, HW), HW contiguous, any strides for
//     N, C and R (R = 1 for a per-frame call; R = T for a clip's view (B, C,
//     T, HW), read without a copy); the output contiguous. A unit is a group
//     (n, g): cpg = C / groups channels x R x HW elements, E of them.
//   channels-last: each sample a contiguous (P, C) matrix, P pixels (the
//     UNet's and the VAE's activations: their convs keep the layout of the
//     permuted input; a clip's views of them too); the output in the same
//     layout. A unit is a sample, all its groups: a group's channels are
//     interleaved with the others' at every pixel.
// A unit is cut into chunks of at most ~48 KB (per-channel: E / splits
// elements; channels-last: rows), fixed by the unit's shape alone, never by
// how many units the call has, so a sample's bits do not depend on its
// batch. Each block (256 threads; channels-last: a multiple of C / 8 and of
// 32 near 256, each thread keeping one vector column, so its channels and
// their affine are fixed) stages its chunk in shared memory by cp.async
// (every copy in flight at once, folded batch by batch as it lands), learns
// the unit's moments and writes the chunk from shared memory, so x is read
// once. A unit of one chunk takes one block; a larger one is split over
// blocks that are resident together (a cooperative launch, persistent
// blocks, as many units a round as the card holds, the rounds balanced):
// each block publishes its chunk's moments to scratch and a per-unit count
// (zeroed by a memset before the launch), waits for the unit's other
// blocks only (a wait of ~10 s traps rather than hang the card), then
// merges the unit's chunks in order. A channels-last sample over what the
// card holds at once (a clip's at 576x1024, the VAE's 512x512 tiles) takes
// three launches in the same chunks: stats (moments a chunk and group),
// finish (a warp a group merges them once), apply (x read again, the grid
// in reverse so that its first blocks read what the stats pass read last,
// while it may still be in L2). A per-channel group over what the card
// holds is refused. Tried against the rounds kept (0.098 ms; bf16, NVIDIA
// H100 80GB HBM3, a clip of 16 x 320 x 72 x 128 read per channel): clusters
// of 16 blocks (the non-portable size) in chunks of ~184 KB, one block an SM
// (0.169 ms); stats + apply from scratch (0.133); two stages a block, the
// next round's chunk in flight, at two blocks an SM (0.114); 512-thread
// blocks with 96 KB chunks (0.100); per-frame groups in clusters of <= 8
// blocks meeting in distributed shared memory (within 10 % of the rounds).
//
// LayerNorm, layer_norm_kernel: one warp a row of C contiguous elements,
// C / 8 (bf16) or C / 4 (fp32) vectors <= 32 * 10, held in registers:
// mean and M2 by warp sums (xor butterflies, the same value in every lane),
// exact two-pass, one write.
//
// Kernel names carry `group_norm` / `layer_norm` (and no `conv`, `copy`,
// `reduce` or `elementwise`), so the breakdowns charge them to
// "GroupNorm + LayerNorm".

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;
constexpr int kBatch = 4;                       // staged vectors a cp.async group
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;                      // loads in flight a thread
constexpr long long kTargetChunkBytes = 48 * 1024;   // four blocks an SM
constexpr int kMaxSmem = 227 * 1024;
constexpr int kRowThreads = 512;                // the most threads of a channels-last block
constexpr long long kRowChunkBytes = 40 * 1024; // its chunk, beside <= 12 KB of moments
constexpr int kRowLoads = 4;                    // its loads in flight a thread

// n / d for n < 2^31 by a multiply-high (PyTorch's IntDivider).
struct FastDiv {
  unsigned d, m, s;
  FastDiv() : d(1), m(1), s(0) {}
  explicit FastDiv(unsigned div) : d(div) {
    for (s = 0; s < 32; ++s)
      if ((1u << s) >= d) break;
    const unsigned long long one = 1;
    m = static_cast<unsigned>(((one << 32) * ((one << s) - d)) / d + 1);
  }
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return (__umulhi(n, m) + n) >> s;
  }
};

// kV elements of T: one 16-byte load kept raw (so that many can be in
// flight in few registers), unpacked to fp32 when used; or one element
// (kV == 1).
template <typename T, int kV>
struct VecIO {
  using Raw = uint4;
  __device__ __forceinline__ static Raw load_raw(const T* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ static void unpack(const Raw& u, float* f) {
    if constexpr (sizeof(T) == 2) {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 t = __bfloat1622float2(h[i]);
        f[2 * i] = t.x;
        f[2 * i + 1] = t.y;
      }
    } else {
      f[0] = __uint_as_float(u.x);
      f[1] = __uint_as_float(u.y);
      f[2] = __uint_as_float(u.z);
      f[3] = __uint_as_float(u.w);
    }
  }
  __device__ __forceinline__ static void store(T* p, const float* f) {
    dct::Vec16<T>::store(p, f);
  }
  // x + a rounded once to T, on the raw vector (a is a value of T)
  __device__ __forceinline__ static void add(Raw& u, float a) {
    if constexpr (sizeof(T) == 2) {
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
      const __nv_bfloat162 a2 = __float2bfloat162_rn(a);
#pragma unroll
      for (int i = 0; i < 4; ++i) h[i] = __hadd2(h[i], a2);
    } else {
      u.x = __float_as_uint(__uint_as_float(u.x) + a);
      u.y = __float_as_uint(__uint_as_float(u.y) + a);
      u.z = __float_as_uint(__uint_as_float(u.z) + a);
      u.w = __float_as_uint(__uint_as_float(u.w) + a);
    }
  }
  // x + a element by element, rounded once to T (a: kV values of T)
  __device__ __forceinline__ static void add_vec(Raw& u, const Raw& a) {
    if constexpr (sizeof(T) == 2) {
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
      const __nv_bfloat162* g = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
      for (int i = 0; i < 4; ++i) h[i] = __hadd2(h[i], g[i]);
    } else {
      u.x = __float_as_uint(__uint_as_float(u.x) + __uint_as_float(a.x));
      u.y = __float_as_uint(__uint_as_float(u.y) + __uint_as_float(a.y));
      u.z = __float_as_uint(__uint_as_float(u.z) + __uint_as_float(a.z));
      u.w = __float_as_uint(__uint_as_float(u.w) + __uint_as_float(a.w));
    }
  }
  __device__ __forceinline__ static void store_raw(T* p, const Raw& u) {
    *reinterpret_cast<uint4*>(p) = u;
  }
};
template <typename T>
struct VecIO<T, 1> {
  using Raw = T;
  __device__ __forceinline__ static Raw load_raw(const T* p) { return *p; }
  __device__ __forceinline__ static void unpack(const Raw& u, float* f) {
    f[0] = static_cast<float>(u);
  }
  __device__ __forceinline__ static void store(T* p, const float* f) { *p = static_cast<T>(f[0]); }
  __device__ __forceinline__ static void add(Raw& u, float a) { u = u + a; }
  __device__ __forceinline__ static void store_raw(T* p, const Raw& u) { *p = u; }
};
template <>
struct VecIO<__nv_bfloat16, 1> {
  using Raw = __nv_bfloat16;
  __device__ __forceinline__ static Raw load_raw(const __nv_bfloat16* p) { return *p; }
  __device__ __forceinline__ static void unpack(const Raw& u, float* f) {
    f[0] = __bfloat162float(u);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float* f) {
    *p = __float2bfloat16(f[0]);
  }
  __device__ __forceinline__ static void add(Raw& u, float a) { u = __hadd(u, __float2bfloat16(a)); }
  __device__ __forceinline__ static void store_raw(__nv_bfloat16* p, const Raw& u) { *p = u; }
};

struct Moments {
  float n, mean, m2;
};

__device__ __forceinline__ Moments merge(Moments a, Moments b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n, d = b.mean - a.mean, f = __fdividef(b.n, n);
  return {n, fmaf(d, f, a.mean), a.m2 + b.m2 + d * d * a.n * f};
}

// Lane 0 ends with the warp's moments, merged in a fixed tree.
__device__ __forceinline__ Moments warp_merge(Moments m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Moments o;
    o.n = __shfl_down_sync(0xffffffffu, m.n, off);
    o.mean = __shfl_down_sync(0xffffffffu, m.mean, off);
    o.m2 = __shfl_down_sync(0xffffffffu, m.m2, off);
    m = merge(m, o);
  }
  return m;
}

// A thread's sums of its values less the first one it saw (k): the count,
// sum and sum of squares of v - k, read out as (count, mean, M2) for the
// fixed-order merges. k is near the thread's values, so s2 - s1^2 / n does
// not cancel as E[v^2] - mean^2 would.
struct Acc {
  float k = 0.f, s1 = 0.f, s2 = 0.f;
  int n = 0;
  template <int kV>
  __device__ __forceinline__ void add(const float* f) {
    if (n == 0) k = f[0];
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const float d = f[i] - k;
      s1 += d;
      s2 = fmaf(d, d, s2);
    }
    n += kV;
  }
  __device__ __forceinline__ Moments moments() const {
    if (n == 0) return {0.f, 0.f, 0.f};
    const float fn = (float)n, d = s1 / fn;
    return {fn, k + d, fmaxf(fmaf(-s1, d, s2), 0.f)};
  }
};

// How a block learns its unit's moments: from its own chunk alone or from
// scratch written by the blocks of its round in this launch (on chip), or,
// channels-last over what the card holds, from scratch written by earlier
// launches (stats, finish, apply).
enum Mode { kOnChip = 0, kStats = 1, kApply = 2 };

constexpr long long kSpinCycles = 1LL << 34;   // ~10 s: a wait that long is a fault

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Thread 0 of a block that has published its part of unit u: waits until
// all `splits` blocks of the unit have (they are resident: a cooperative
// launch, and they wait on nothing else).
__device__ __forceinline__ void wait_for_unit(unsigned* count, int u, int splits) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count + u, 1u);
    const long long t0 = clock64();
    while (ld_acquire(count + u) < (unsigned)splits) {
      __nanosleep(100);
      if (clock64() - t0 > kSpinCycles) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// Wait until at most n of this thread's cp.async groups are in flight (n
// over 3 waits for 3).
__device__ __forceinline__ void cp_async_wait_for(int n) {
  switch (n) {
    case 0: dct::cp_async_wait<0>(); break;
    case 1: dct::cp_async_wait<1>(); break;
    case 2: dct::cp_async_wait<2>(); break;
    default: dct::cp_async_wait<3>(); break;
  }
}

__device__ __forceinline__ float silu_or_not(float y, bool silu) {
  return silu ? __fdividef(y, 1.f + __expf(-y)) : y;
}

// ---- GroupNorm, per-channel layout: a unit is a group ------------------------

struct GnParams {
  const void* x;
  const void* add;       // (N, C) in x's dtype, or null
  const float* w;
  const float* b;
  void* out;
  float* part;           // splits > 1: (N * groups, splits, 2) chunk (mean, M2)
  unsigned* count;       // splits > 1: (N * groups) chunks published, zeroed before the launch
  long long sn, sc, sr;  // element strides of x's N, C, R
  long long rhw;         // R * HW: a channel's elements in the output
  int c, groups, cpg;
  int ng;                // N * groups
  unsigned e;            // elements a group, cpg * R * HW
  unsigned chunk;        // elements a block's chunk, a multiple of 8
  int splits;            // blocks a group
  int per_round;         // groups a round
  FastDiv hw, r, rhw_div;   // by HW, by R, by R * HW
  float eps;
  int silu;
};

// Warp 0 merges the `splits` chunk moments of group ng from scratch, in
// order (lane l takes chunks l, l + 32, ...); lane 0 writes them to grp.
__device__ __forceinline__ void merge_chunks(const GnParams& p, int ng, float* grp) {
  const int lane = threadIdx.x & 31;
  Moments t = {0.f, 0.f, 0.f};
  const float* pg = p.part + (size_t)ng * p.splits * 2;
  for (int j = lane; j < p.splits; j += 32) {
    const unsigned a = (unsigned)j * p.chunk;
    const float nb = (float)(min(p.e, a + p.chunk) - a);
    t = merge(t, {nb, __ldcg(pg + 2 * j), __ldcg(pg + 2 * j + 1)});
  }
  t = warp_merge(t);
  if (lane == 0) {
    grp[0] = t.n;
    grp[1] = t.mean;
    grp[2] = t.m2;
  }
}

// Group ng of x: an element's address and its channel in the group.
template <typename T>
struct GroupIn {
  const T* xg;
  __device__ __forceinline__ GroupIn(const GnParams& p, int ng)
      : xg(static_cast<const T*>(p.x) + (long long)(ng / p.groups) * p.sn +
           (long long)((ng % p.groups) * p.cpg) * p.sc) {}
  __device__ __forceinline__ const T* at(const GnParams& p, unsigned e, int& cl) const {
    const unsigned row = p.hw.div(e), col = e - row * p.hw.d;
    unsigned ch = row, rr = 0;
    if (p.r.d != 1) {
      ch = p.r.div(row);
      rr = row - ch * p.r.d;
    }
    cl = (int)ch;
    return xg + (long long)ch * p.sc + (long long)rr * p.sr + col;
  }
};

// One block's chunk s of group ng, staged in `stage`; `tab` holds the
// per-channel tables and the block's scratch.
template <typename T, int kV>
__device__ __forceinline__ void gn_chunk(const GnParams& p, int ng, int s, T* stage, float* tab) {
  // tab: [ad, sc, bi: cpg floats each][warp moments][group]
  float* ad = tab;
  float* scl = ad + p.cpg;
  float* bia = scl + p.cpg;
  float* wm = bia + p.cpg;          // [kWarps][3]
  float* grp = wm + 3 * kWarps;     // [3]: this block's, then the group's moments

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = ng / p.groups, g = ng % p.groups, c0 = g * p.cpg;
  const unsigned e0 = (unsigned)s * p.chunk;
  const unsigned e1 = min(p.e, e0 + p.chunk);
  const int nv = e0 < e1 ? (int)((e1 - e0) / kV) : 0;
  const GroupIn<T> in(p, ng);
  T* og = static_cast<T*>(p.out) + ((long long)n * p.c + c0) * p.rhw;
  const T* addp = static_cast<const T*>(p.add);

  for (int cl = tid; cl < p.cpg; cl += kThreads)
    ad[cl] = addp != nullptr ? static_cast<float>(addp[(long long)n * p.c + c0 + cl]) : 0.f;
  __syncthreads();

  const bool has_add = addp != nullptr;
  auto locate = [&](unsigned e, int& cl) { return in.at(p, e, cl); };
  using Raw = typename VecIO<T, kV>::Raw;

  Acc acc;
  if (kV > 1) {
    // the chunk staged with every copy in flight at once, in cp.async
    // groups of kBatch vectors a thread, each folded once it has landed;
    // the stage keeps v
    int j = 0;
    for (int lv = tid; lv < nv; lv += kThreads, ++j) {
      int cl;
      dct::cp_async16(stage + (size_t)lv * kV, locate(e0 + (unsigned)lv * kV, cl));
      if (j % kBatch == kBatch - 1) dct::cp_async_commit();
    }
    if (j % kBatch) dct::cp_async_commit();
    const int batches = (j + kBatch - 1) / kBatch;
    j = 0;
    for (int lv = tid; lv < nv; lv += kThreads, ++j) {
      if (j % kBatch == 0) cp_async_wait_for(batches - 1 - j / kBatch);
      T* st = stage + (size_t)lv * kV;
      Raw u = VecIO<T, kV>::load_raw(st);
      if (has_add) {
        VecIO<T, kV>::add(u, ad[p.rhw_div.div(e0 + (unsigned)lv * kV)]);
        VecIO<T, kV>::store_raw(st, u);
      }
      float f[kV];
      VecIO<T, kV>::unpack(u, f);
      acc.add<kV>(f);
    }
  } else {
    for (int base = 0; base < nv; base += kUnroll * kThreads) {
      Raw raw[kUnroll];
      int cls[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int lv = base + u * kThreads + tid;
        if (lv < nv) raw[u] = VecIO<T, kV>::load_raw(locate(e0 + (unsigned)lv * kV, cls[u]));
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int lv = base + u * kThreads + tid;
        if (lv < nv) {
          if (has_add) VecIO<T, kV>::add(raw[u], ad[cls[u]]);
          VecIO<T, kV>::store_raw(stage + (size_t)lv * kV, raw[u]);
          float f[kV];
          VecIO<T, kV>::unpack(raw[u], f);
          acc.add<kV>(f);
        }
      }
    }
  }
  Moments m = warp_merge(acc.moments());
  if (lane == 0) {
    wm[3 * warp] = m.n;
    wm[3 * warp + 1] = m.mean;
    wm[3 * warp + 2] = m.m2;
  }
  __syncthreads();
  if (warp == 0) {
    Moments t = {0.f, 0.f, 0.f};
    if (lane < kWarps) t = {wm[3 * lane], wm[3 * lane + 1], wm[3 * lane + 2]};
    t = warp_merge(t);
    if (lane == 0) {
      if (p.splits == 1) {
        grp[0] = t.n;
        grp[1] = t.mean;
        grp[2] = t.m2;
      } else {
        float* out = p.part + ((size_t)ng * p.splits + s) * 2;
        out[0] = t.mean;
        out[1] = t.m2;
      }
    }
  }
  if (p.splits > 1) {
    // publish this chunk's moments, wait for the group's other chunks,
    // then merge them all in order
    wait_for_unit(p.count, ng, p.splits);
    if (warp == 0) merge_chunks(p, ng, grp);
  }
  __syncthreads();

  const float mean = grp[1], rstd = rsqrtf(grp[2] / grp[0] + p.eps);
  for (int cl = tid; cl < p.cpg; cl += kThreads) {
    const float sc = p.w[c0 + cl] * rstd;
    scl[cl] = sc;
    bia[cl] = fmaf(-mean, sc, p.b[c0 + cl]);
  }
  __syncthreads();

  // v from the stage, the affine, SiLU
  const bool silu = p.silu != 0;
  for (int base = 0; base < nv; base += 2 * kThreads) {
    Raw raw[2];
    int cls[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int lv = base + u * kThreads + tid;
      if (lv < nv) {
        raw[u] = VecIO<T, kV>::load_raw(stage + (size_t)lv * kV);
        cls[u] = (int)p.rhw_div.div(e0 + (unsigned)lv * kV);
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int lv = base + u * kThreads + tid;
      if (lv < nv) {
        float f[kV];
        VecIO<T, kV>::unpack(raw[u], f);
        const float sc = scl[cls[u]], bi = bia[cls[u]];
#pragma unroll
        for (int i = 0; i < kV; ++i) f[i] = silu_or_not(fmaf(f[i], sc, bi), silu);
        VecIO<T, kV>::store(og + e0 + (unsigned)lv * kV, f);
      }
    }
  }
}

extern __shared__ __align__(16) unsigned char smem_raw[];

// Persistent: block b takes chunk b % splits of group r * per_round + b /
// splits in round r (one round, a block a group, where splits is 1).
template <typename T, int kV>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) group_norm_act_kernel(const GnParams p) {
  // [stage: chunk T][tables]
  T* stage = reinterpret_cast<T*>(smem_raw);
  float* tab = reinterpret_cast<float*>(stage + p.chunk);
  for (int ng = blockIdx.x / p.splits; ng < p.ng; ng += p.per_round) {
    gn_chunk<T, kV>(p, ng, blockIdx.x % p.splits, stage, tab);
    __syncthreads();   // the stage and tables are the next round's
  }
}

// ---- GroupNorm, channels-last: a unit is a sample ----------------------------

struct RowParams {
  const void* x;
  const void* add;       // (N, C) in x's dtype, or null
  const float* w;
  const float* b;
  void* out;             // (N, P, C)
  float* part;           // splits > 1: (N, splits, groups, 2) chunk (mean, M2)
  float* fin;            // stats/apply: (N, groups, 2) (mean, rstd)
  unsigned* count;       // on chip, splits > 1: (N) chunks published, zeroed first
  long long sn;          // x's element stride between samples
  unsigned p;            // pixels a sample: the rows of its (P, C) matrix
  unsigned rows;         // rows a chunk
  int c, groups, cpg;
  int v;                 // 16-byte vectors a row
  int k;                 // rows a block steps over: its threads / v
  int units, splits, per_round;
  float eps;
  int silu;
};

// A warp: group g of unit u over its `splits` chunks from scratch, in order
// (lane l takes chunks l, l + 32, ...); lane 0 returns (mean, rstd).
__device__ __forceinline__ float2 merge_row_chunks(const RowParams& p, int u, int g) {
  const int lane = threadIdx.x & 31;
  Moments t = {0.f, 0.f, 0.f};
  for (int s = lane; s < p.splits; s += 32) {
    const unsigned r0 = (unsigned)s * p.rows;
    const float nb = (float)((min(p.p, r0 + p.rows) - r0) * (unsigned)p.cpg);
    const float* q = p.part + (((size_t)u * p.splits + s) * p.groups + g) * 2;
    t = merge(t, {nb, __ldcg(q), __ldcg(q + 1)});
  }
  t = warp_merge(t);
  return make_float2(t.mean, rsqrtf(t.m2 / t.n + p.eps));
}

// One block's chunk s of sample u: rows [s * rows, (s + 1) * rows) of its
// (P, C) matrix, one contiguous run. Thread t keeps the vector column
// t % v (channels c0 .. c0 + kV - 1, within two groups: ga below `split`,
// gb from it) over rows t / v, t / v + k, ...; `stage` (on chip) holds the
// chunk, `tab` the threads' moments and the groups' (mean, rstd).
template <typename T, int kMode>
__device__ __forceinline__ void rows_chunk(const RowParams& p, int u, int s, T* stage,
                                           float* tab) {
  constexpr int kV = dct::Vec16<T>::kVec;
  using IO = VecIO<T, kV>;
  using Raw = typename IO::Raw;
  constexpr int kLoads = kMode == kOnChip ? 2 : kRowLoads;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int nw = nt >> 5;
  const int c0 = (tid % p.v) * kV;
  const int ga = c0 / p.cpg, split = min(kV, (ga + 1) * p.cpg - c0);
  const int gb = split < kV ? ga + 1 : ga;
  const unsigned r0 = (unsigned)s * p.rows;
  const int nv = (int)((min(p.p, r0 + p.rows) - r0) * (unsigned)p.v);
  const long long off = (long long)r0 * p.c;
  const T* xc = static_cast<const T*>(p.x) + (long long)u * p.sn + off;
  T* oc = static_cast<T*>(p.out) + (long long)u * p.p * p.c + off;
  const bool has_add = p.add != nullptr;
  Raw addv = {};
  if (has_add) addv = IO::load_raw(static_cast<const T*>(p.add) + (long long)u * p.c + c0);
  float* mom = tab;                 // [nt][2][3]: each thread's (n, mean, M2) of ga, gb
  float* grp = tab + 6 * nt;        // [groups][2]: (mean, rstd)

  if (kMode != kApply) {
    Acc a, b;
    auto fold = [&](const Raw& r) {
      float f[kV];
      IO::unpack(r, f);
      if (a.n == 0) a.k = f[0];
      if (b.n == 0) b.k = f[kV - 1];
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        if (i < split) {
          const float d = f[i] - a.k;
          a.s1 += d;
          a.s2 = fmaf(d, d, a.s2);
        } else {
          const float d = f[i] - b.k;
          b.s1 += d;
          b.s2 = fmaf(d, d, b.s2);
        }
      }
      a.n += split;
      b.n += kV - split;
    };
    if (kMode == kOnChip) {
      int j = 0;
      for (int lv = tid; lv < nv; lv += nt, ++j) {
        dct::cp_async16(stage + (size_t)lv * kV, xc + (size_t)lv * kV);
        if (j % kBatch == kBatch - 1) dct::cp_async_commit();
      }
      if (j % kBatch) dct::cp_async_commit();
      const int batches = (j + kBatch - 1) / kBatch;
      j = 0;
      for (int lv = tid; lv < nv; lv += nt, ++j) {
        if (j % kBatch == 0) cp_async_wait_for(batches - 1 - j / kBatch);
        T* st = stage + (size_t)lv * kV;
        Raw r = IO::load_raw(st);
        if (has_add) {
          IO::add_vec(r, addv);
          IO::store_raw(st, r);
        }
        fold(r);
      }
    } else {
      for (int base = 0; base < nv; base += kLoads * nt) {
        Raw raw[kLoads];
#pragma unroll
        for (int i = 0; i < kLoads; ++i) {
          const int lv = base + i * nt + tid;
          if (lv < nv) raw[i] = IO::load_raw(xc + (size_t)lv * kV);
        }
#pragma unroll
        for (int i = 0; i < kLoads; ++i) {
          const int lv = base + i * nt + tid;
          if (lv < nv) {
            if (has_add) IO::add_vec(raw[i], addv);
            fold(raw[i]);
          }
        }
      }
    }
    const Moments ma = a.moments(), mb = b.moments();
    float* m = mom + 6 * tid;
    m[0] = ma.n;
    m[1] = ma.mean;
    m[2] = ma.m2;
    m[3] = mb.n;
    m[4] = mb.mean;
    m[5] = mb.m2;
    __syncthreads();
    // group g's parts in order of (row, column): warp w takes groups w, w + nw, ...
    for (int g = warp; g < p.groups; g += nw) {
      const int jlo = g * p.cpg / kV, ncol = ((g + 1) * p.cpg - 1) / kV - jlo + 1;
      Moments t = {0.f, 0.f, 0.f};
      for (int it = lane; it < ncol * p.k; it += 32) {
        const int rr = it / ncol, j = jlo + it % ncol;
        const float* q = mom + 6 * (rr * p.v + j) + (j * kV / p.cpg == g ? 0 : 3);
        t = merge(t, {q[0], q[1], q[2]});
      }
      t = warp_merge(t);
      if (lane == 0) {
        if (kMode == kOnChip && p.splits == 1) {
          grp[2 * g] = t.mean;
          grp[2 * g + 1] = rsqrtf(t.m2 / t.n + p.eps);
        } else {
          float* q = p.part + (((size_t)u * p.splits + s) * p.groups + g) * 2;
          q[0] = t.mean;
          q[1] = t.m2;
        }
      }
    }
    if (kMode == kStats) return;
    if (p.splits > 1) {
      wait_for_unit(p.count, u, p.splits);
      for (int g = warp; g < p.groups; g += nw) {
        const float2 mr = merge_row_chunks(p, u, g);
        if (lane == 0) {
          grp[2 * g] = mr.x;
          grp[2 * g + 1] = mr.y;
        }
      }
    }
    __syncthreads();
  }

  // the affine of the thread's kV channels, in registers
  float sc[kV], bi[kV];
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const int g = i < split ? ga : gb;
    float mean, rstd;
    if (kMode == kApply) {
      const float* q = p.fin + ((size_t)u * p.groups + g) * 2;
      mean = __ldcg(q);
      rstd = __ldcg(q + 1);
    } else {
      mean = grp[2 * g];
      rstd = grp[2 * g + 1];
    }
    sc[i] = p.w[c0 + i] * rstd;
    bi[i] = fmaf(-mean, sc[i], p.b[c0 + i]);
  }
  const bool silu = p.silu != 0;
  for (int base = 0; base < nv; base += kLoads * nt) {
    Raw raw[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int lv = base + i * nt + tid;
      if (lv < nv) raw[i] = IO::load_raw((kMode == kOnChip ? stage : xc) + (size_t)lv * kV);
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int lv = base + i * nt + tid;
      if (lv < nv) {
        if (kMode == kApply && has_add) IO::add_vec(raw[i], addv);
        float f[kV];
        IO::unpack(raw[i], f);
#pragma unroll
        for (int q = 0; q < kV; ++q) f[q] = silu_or_not(fmaf(f[q], sc[q], bi[q]), silu);
        IO::store(oc + (size_t)lv * kV, f);
      }
    }
  }
}

// Persistent, as group_norm_act_kernel, over samples.
template <typename T>
__global__ void __launch_bounds__(kRowThreads, 2) group_norm_rows_kernel(const RowParams p) {
  // [stage: rows x C T][moments][groups' (mean, rstd)]
  T* stage = reinterpret_cast<T*>(smem_raw);
  float* tab = reinterpret_cast<float*>(stage + (size_t)p.rows * p.c);
  for (int u = blockIdx.x / p.splits; u < p.units; u += p.per_round) {
    rows_chunk<T, kOnChip>(p, u, blockIdx.x % p.splits, stage, tab);
    __syncthreads();
  }
}
template <typename T>
__global__ void __launch_bounds__(kRowThreads, 2) group_norm_rows_stats_kernel(const RowParams p) {
  rows_chunk<T, kStats>(p, blockIdx.x / p.splits, blockIdx.x % p.splits, nullptr,
                        reinterpret_cast<float*>(smem_raw));
}
// A warp a (sample, group): its chunks' moments merged once, as (mean, rstd).
__global__ void __launch_bounds__(256) group_norm_rows_finish_kernel(const RowParams p) {
  const int w = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (w >= p.units * p.groups) return;   // a whole warp returns
  const float2 mr = merge_row_chunks(p, w / p.groups, w % p.groups);
  if ((threadIdx.x & 31) == 0) {
    p.fin[2 * w] = mr.x;
    p.fin[2 * w + 1] = mr.y;
  }
}
template <typename T>
__global__ void __launch_bounds__(kRowThreads, 2) group_norm_rows_apply_kernel(const RowParams p) {
  const unsigned blk = gridDim.x - 1 - blockIdx.x;   // the stats pass's last chunks first
  rows_chunk<T, kApply>(p, blk / p.splits, blk % p.splits, nullptr, nullptr);
}

// ---- plans ----------------------------------------------------------------------

int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

// Blocks of `kern` with `threads` threads and `smem` bytes that can be
// resident at once (0 where the query fails); sets the kernel's
// shared-memory attribute first.
template <typename K>
int resident(K kern, int threads, size_t smem) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, size_t>, int> seen;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(reinterpret_cast<const void*>(kern), threads, smem);
  auto it = seen.find(key);
  if (it != seen.end()) return it->second;
  int per_sm = 0;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem) != cudaSuccess)
    per_sm = 0;
  cudaGetLastError();   // a refused query leaves no error behind
  return seen[key] = per_sm * num_sms();
}

struct Plan {
  bool ok = false;
  bool two_pass = false;   // channels-last: stats, finish, apply
  int splits = 1;          // blocks a unit
  unsigned chunk = 0;      // per-channel: elements a block; channels-last: rows a block
  int threads = kThreads;
  size_t smem = 0;         // on chip: a block's dynamic shared memory
  int per_round = 0;       // on chip: units a round
  long long scratch = 0;   // floats of scratch (with the counters' words)
};

unsigned round8(unsigned long long v) { return (unsigned)((v + 7) / 8 * 8); }

// As many units a round as stay resident, the rounds balanced.
void rounds(Plan& pl, long long units, int slots) {
  const long long most = slots / pl.splits, n = (units + most - 1) / most;
  pl.per_round = (int)((units + n - 1) / n);
}

size_t table_bytes(int cpg) { return (size_t)(3 * cpg + 3 * kWarps + 3) * sizeof(float); }

// A unit's chunks, and so the order of its sums and its result, follow
// from the unit's shape alone, never from how many units the call has: a
// sample normalises to the same bits whatever batch it comes in (CFG's two
// passes batched or apart, a dp rank's share of the rows).
template <typename T, int kV>
Plan plan_groups(long long ng, unsigned e, int cpg) {
  Plan pl;
  const long long max_chunk = kTargetChunkBytes / (long long)sizeof(T) / 8 * 8;
  pl.splits = (int)(((long long)e + max_chunk - 1) / max_chunk);
  pl.chunk = round8(((unsigned long long)e + pl.splits - 1) / pl.splits);
  pl.smem = (size_t)pl.chunk * sizeof(T) + table_bytes(cpg);
  const int slots = resident(group_norm_act_kernel<T, kV>, kThreads, pl.smem);
  if (pl.splits > slots) return pl;   // a group over what the card holds
  pl.ok = true;
  if (pl.splits == 1) {
    pl.per_round = (int)ng;
  } else {
    rounds(pl, ng, slots);
    pl.scratch = ng * pl.splits * 2 + ng;
  }
  return pl;
}

int lcm32(int v) {
  int a = v, b = 32;
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return v / a * 32;
}

template <typename T>
Plan plan_rows(long long units, long long pixels, int c, int groups) {
  constexpr int kV = dct::Vec16<T>::kVec;
  Plan pl;
  const int cpg = c / groups;
  if (c % kV) return pl;
  const int v = c / kV;
  for (int j = 0; j < v; ++j)   // each vector within two groups
    if ((j * kV + kV - 1) / cpg - j * kV / cpg > 1) return pl;
  const int base = lcm32(v);
  if (base > kRowThreads) return pl;
  pl.threads = base * std::max(1, (kThreads + base / 2) / base);
  if (pl.threads > kRowThreads) pl.threads = base;
  const long long row_bytes = (long long)c * sizeof(T);
  pl.chunk = (unsigned)std::min<long long>(pixels, std::max(1LL, kRowChunkBytes / row_bytes));
  const long long splits = (pixels + pl.chunk - 1) / pl.chunk;
  if (units * splits >= 0x7fffffffLL) return pl;
  pl.splits = (int)splits;
  pl.smem = (size_t)pl.chunk * row_bytes + (size_t)(6 * pl.threads + 2 * groups) * sizeof(float);
  const int slots = resident(group_norm_rows_kernel<T>, pl.threads, pl.smem);
  if (slots == 0) return pl;
  pl.ok = true;
  const long long parts = units * splits * groups * 2;
  if (splits <= slots) {
    if (splits == 1) {
      pl.per_round = (int)units;
    } else {
      rounds(pl, units, slots);
      pl.scratch = parts + units;
    }
  } else {
    pl.two_pass = true;
    pl.scratch = parts + units * groups * 2;
  }
  return pl;
}

template <typename T>
Plan plan(bool rows_layout, long long n, int c, long long r, long long hw, int groups, bool vec) {
  if (rows_layout) return plan_rows<T>(n, r * hw, c, groups);
  const unsigned e = (unsigned)((long long)(c / groups) * r * hw);
  return vec ? plan_groups<T, dct::Vec16<T>::kVec>(n * groups, e, c / groups)
             : plan_groups<T, 1>(n * groups, e, c / groups);
}

template <typename T>
bool vec_ok(const void* x, long long hw, long long sn, long long sc, long long sr) {
  constexpr int v = dct::Vec16<T>::kVec;
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 && hw % v == 0 && sn % v == 0 &&
         sc % v == 0 && sr % v == 0;
}

// splits == 1: a plain launch, a block a unit; else a cooperative one, the
// units' counters zeroed first.
template <typename K, typename P>
int launch_on_chip(K kern, const P& p, const Plan& pl, unsigned* count, long long units,
                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.blockDim = dim3(pl.threads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  if (pl.splits == 1) {
    cfg.gridDim = dim3((unsigned)units);
  } else {
    cudaError_t err = cudaMemsetAsync(count, 0, (size_t)units * sizeof(unsigned), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.gridDim = dim3((unsigned)(pl.per_round * pl.splits));
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kern, p));
}

template <typename T, int kV>
int launch_groups(GnParams p, const Plan& pl, cudaStream_t stream) {
  p.splits = pl.splits;
  p.chunk = pl.chunk;
  p.per_round = pl.per_round;
  if (pl.splits > 1) p.count = reinterpret_cast<unsigned*>(p.part + (size_t)p.ng * pl.splits * 2);
  return launch_on_chip(group_norm_act_kernel<T, kV>, p, pl, p.count, p.ng, stream);
}

template <typename T>
int launch_rows(RowParams p, const Plan& pl, cudaStream_t stream) {
  p.rows = pl.chunk;
  p.splits = pl.splits;
  p.per_round = pl.per_round;
  p.k = pl.threads / p.v;
  const size_t parts = (size_t)p.units * pl.splits * p.groups * 2;
  if (!pl.two_pass) {
    if (pl.splits > 1) p.count = reinterpret_cast<unsigned*>(p.part + parts);
    return launch_on_chip(group_norm_rows_kernel<T>, p, pl, p.count, p.units, stream);
  }
  p.fin = p.part + parts;
  const unsigned blocks = (unsigned)((long long)p.units * pl.splits);
  group_norm_rows_stats_kernel<T>
      <<<blocks, pl.threads, (size_t)6 * pl.threads * sizeof(float), stream>>>(p);
  group_norm_rows_finish_kernel<<<(unsigned)((p.units * p.groups + 7) / 8), 256, 0, stream>>>(p);
  group_norm_rows_apply_kernel<T><<<blocks, pl.threads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_gn(const GnParams& g, const RowParams& rp, bool rows_layout, long long n, long long r,
                long long hw, size_t scratch_floats, cudaStream_t stream) {
  constexpr int kV = dct::Vec16<T>::kVec;
  const bool vec = rows_layout || vec_ok<T>(g.x, hw, g.sn, g.sc, g.sr);
  const Plan pl = plan<T>(rows_layout, n, g.c, r, hw, g.groups, vec);
  if (!pl.ok) return static_cast<int>(cudaErrorInvalidValue);
  if ((size_t)pl.scratch > scratch_floats || (pl.scratch > 0 && g.part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows_layout) return launch_rows<T>(rp, pl, stream);
  return vec ? launch_groups<T, kV>(g, pl, stream) : launch_groups<T, 1>(g, pl, stream);
}

// ---- LayerNorm ------------------------------------------------------------

constexpr int kLnThreads = 256;
constexpr int kLnRows = kLnThreads / 32;   // rows a block
constexpr int kLnMaxPer = 10;               // vectors a lane

template <typename T, typename TO, int kPer>
__global__ void __launch_bounds__(kLnThreads) layer_norm_kernel(
    const T* __restrict__ x, const float* __restrict__ w, const float* __restrict__ b,
    TO* __restrict__ out, long long rows, int c, float eps) {
  constexpr int kV = dct::Vec16<T>::kVec;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kLnRows + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int nvec = c / kV;
  const T* xr = x + row * c;
  float f[kPer][kV];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int j = lane + 32 * i;
    if (j < nvec) {
      dct::Vec16<T>::load(xr + j * kV, f[i]);
#pragma unroll
      for (int k = 0; k < kV; ++k) sum += f[i][k];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  const float mean = sum / (float)c;
  float m2 = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int j = lane + 32 * i;
    if (j < nvec) {
#pragma unroll
      for (int k = 0; k < kV; ++k) {
        const float d = f[i][k] - mean;
        m2 = fmaf(d, d, m2);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m2 += __shfl_xor_sync(0xffffffffu, m2, off);
  const float rstd = rsqrtf(m2 / (float)c + eps);
  TO* orow = out + row * c;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int j = lane + 32 * i;
    if (j < nvec) {
      float wv[kV], bv[kV], y[kV];
#pragma unroll
      for (int k = 0; k < kV; k += 4) {
        dct::load4(w + j * kV + k, wv + k);
        dct::load4(b + j * kV + k, bv + k);
      }
#pragma unroll
      for (int k = 0; k < kV; ++k) y[k] = fmaf((f[i][k] - mean) * rstd, wv[k], bv[k]);
#pragma unroll
      for (int k = 0; k < kV; k += 4) dct::store4(orow + j * kV + k, y[k], y[k + 1], y[k + 2], y[k + 3]);
    }
  }
}

template <typename T, typename TO>
int launch_ln(const void* x, const float* w, const float* b, void* out, long long rows, int c,
              float eps, cudaStream_t stream) {
  constexpr int kV = dct::Vec16<T>::kVec;
  const int per = (c / kV + 31) / 32;
  const long long blocks = (rows + kLnRows - 1) / kLnRows;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const T* xt = static_cast<const T*>(x);
  TO* o = static_cast<TO*>(out);
  const dim3 grid((unsigned)blocks);
  switch (per) {
#define DCT_LN_CASE(P) \
  case P:              \
    layer_norm_kernel<T, TO, P><<<grid, kLnThreads, 0, stream>>>(xt, w, b, o, rows, c, eps); \
    break;
    DCT_LN_CASE(1) DCT_LN_CASE(2) DCT_LN_CASE(3) DCT_LN_CASE(4) DCT_LN_CASE(5)
    DCT_LN_CASE(6) DCT_LN_CASE(7) DCT_LN_CASE(8) DCT_LN_CASE(9) DCT_LN_CASE(10)
#undef DCT_LN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of scratch the GroupNorm plan needs for this shape (0: none), or
// -1 for a shape the kernels do not take. channels_last: each of the n
// samples a contiguous (r * hw, c) matrix (16-byte aligned); else x viewed
// as (n, c, r, hw) with hw contiguous.
extern "C" long long dct_group_norm_scratch(int dtype, int channels_last, long long n, int c,
                                            long long r, long long hw, int groups) {
  if (groups <= 0 || c % groups || n <= 0 || r <= 0 || hw <= 0) return -1;
  const long long e = (long long)(c / groups) * r * hw;
  if (e >= 0x7fffffffLL || n * groups >= 0x7fffffffLL || r * hw >= 0x7fffffffLL ||
      (long long)c * r * hw >= 0x7fffffffLL)
    return -1;
  Plan pl;
  if (dtype == dct::kBFloat16)
    pl = plan<__nv_bfloat16>(channels_last != 0, n, c, r, hw, groups, true);
  else if (dtype == dct::kFloat32)
    pl = plan<float>(channels_last != 0, n, c, r, hw, groups, true);
  else
    return -1;
  return pl.ok ? pl.scratch : -1;
}

// y = [silu](groupnorm(x [+ add])): per channel, x viewed as (N, C, R, HW)
// (element strides sn, sc, sr; HW contiguous) and out contiguous (N, C, R,
// HW); channels_last, each sample of x a contiguous (R * HW, C) matrix
// sn elements apart and out (N, R * HW, C) contiguous. out in x's dtype;
// add (N, C) contiguous in x's dtype or null; w, b (C) fp32; scratch as
// dct_group_norm_scratch asked (null when it asked 0).
extern "C" int dct_group_norm_act(const void* x, const void* add, const void* w, const void* b,
                                  void* out, void* scratch, long long scratch_floats, int dtype,
                                  int channels_last, long long n, int c, long long r,
                                  long long hw, long long sn, long long sc, long long sr,
                                  int groups, float eps, int silu, void* stream) {
  if (groups <= 0 || c % groups || n <= 0 || r <= 0 || hw <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cpg = c / groups;
  const long long e = (long long)cpg * r * hw;
  if (e >= 0x7fffffffLL || n * groups >= 0x7fffffffLL || (long long)c * r * hw >= 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool rows_layout = channels_last != 0;
  if (rows_layout) {
    const long long v = dtype == dct::kBFloat16 ? 8 : 4;
    if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(add) % 16 ||
        reinterpret_cast<uintptr_t>(out) % 16 || sn % v)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  GnParams p = {};
  p.x = x;
  p.add = add;
  p.w = static_cast<const float*>(w);
  p.b = static_cast<const float*>(b);
  p.out = out;
  p.part = static_cast<float*>(scratch);
  p.sn = sn;
  p.sc = sc;
  p.sr = sr;
  p.rhw = r * hw;
  p.c = c;
  p.groups = groups;
  p.cpg = cpg;
  p.e = (unsigned)e;
  p.hw = FastDiv((unsigned)hw);
  p.r = FastDiv((unsigned)r);
  p.rhw_div = FastDiv((unsigned)(r * hw));
  p.eps = eps;
  p.silu = silu;
  p.ng = (int)(n * groups);
  RowParams q = {};
  q.x = x;
  q.add = add;
  q.w = p.w;
  q.b = p.b;
  q.out = out;
  q.part = p.part;
  q.sn = sn;
  q.p = (unsigned)(r * hw);
  q.c = c;
  q.groups = groups;
  q.cpg = cpg;
  q.v = c / (dtype == dct::kBFloat16 ? 8 : 4);
  q.units = (int)n;
  q.eps = eps;
  q.silu = silu;
  const size_t cap = scratch_floats > 0 ? (size_t)scratch_floats : 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dct::kBFloat16)
    return dispatch_gn<__nv_bfloat16>(p, q, rows_layout, n, r, hw, cap, s);
  if (dtype == dct::kFloat32) return dispatch_gn<float>(p, q, rows_layout, n, r, hw, cap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// LayerNorm over the last axis of contiguous (rows, c) x: w, b (c) fp32;
// out (rows, c) in x's dtype, or fp32 with out_fp32. c a multiple of 8
// (bf16) or 4 (fp32), at most 320 vectors.
extern "C" int dct_layer_norm(const void* x, const void* w, const void* b, void* out, int dtype,
                              int out_fp32, long long rows, int c, float eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  if (rows <= 0 || c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == dct::kBFloat16) {
    if (c % 8 || c / 8 > 32 * kLnMaxPer) return static_cast<int>(cudaErrorInvalidValue);
    return out_fp32 ? launch_ln<__nv_bfloat16, float>(x, wf, bf, out, rows, c, eps, s)
                    : launch_ln<__nv_bfloat16, __nv_bfloat16>(x, wf, bf, out, rows, c, eps, s);
  }
  if (dtype == dct::kFloat32) {
    if (c % 4 || c / 4 > 32 * kLnMaxPer) return static_cast<int>(cudaErrorInvalidValue);
    return launch_ln<float, float>(x, wf, bf, out, rows, c, eps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
