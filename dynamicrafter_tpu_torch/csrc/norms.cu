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
// fp32, rounded once. Statistics: each thread sums its values less a shift
// (per channel: the first value it saw, read out as (count, mean, M2) and
// merged by Chan's formula over threads and warps; channels-last: a value
// of the group common to the block, the sums added over its threads), and
// blocks merge theirs by Chan's formula, all in a fixed order
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
// Per channel, a unit is cut into chunks of at most ~48 KB (E / splits
// elements), fixed by the unit's shape alone, never by how many units the
// call has, so a sample's bits do not depend on its batch. Each block (256
// threads) stages its chunk in shared memory by cp.async (every copy in
// flight at once, folded batch by batch as it lands), learns the unit's
// moments and writes the chunk from shared memory, so x is read once. A
// unit of one chunk takes one block; a larger one is split over blocks that
// are resident together (a cooperative launch, persistent blocks, as many
// units a round as the card holds, the rounds balanced): each block
// publishes its chunk's moments to scratch and a per-unit count (zeroed by
// a memset before the launch), waits for the unit's other blocks only (a
// wait of ~10 s traps rather than hang the card), then merges the unit's
// chunks in order. A group over what the card holds is refused. Tried
// against the rounds kept (0.098 ms; bf16, NVIDIA H100 80GB HBM3, a clip of
// 16 x 320 x 72 x 128 read per channel): clusters of 16 blocks (the
// non-portable size) in chunks of ~184 KB, one block an SM (0.169 ms);
// stats + apply from scratch (0.133); two stages a block, the next round's
// chunk in flight, at two blocks an SM (0.114); 512-thread blocks with 96 KB
// chunks (0.100); per-frame groups in clusters of <= 8 blocks meeting in
// distributed shared memory (within 10 % of the rounds).
//
// Channels-last, group_norm_rows_kernel: one cooperative launch of
// persistent blocks, one an SM, each with a ring of eight 24 KB slots
// filled by bulk copies (cp.async.bulk, one thread issuing, an mbarrier a
// slot): a chunk is the whole rows one slot holds, a part a run of a
// sample's chunks, a block's: at most a ring's where the card's rings hold
// the sample, else as many parts as blocks. Each thread keeps one 16-byte
// vector column (the block a multiple of C / 8 and of 32 threads, near
// 512), so its channels, its one or two groups and their affine are fixed
// and the statistics are column sums in registers (less a shift a group:
// no E[v^2] - mean^2). A sample's parts publish their moments to scratch
// and a per-sample count (zeroed by a memset before the launch); the last
// to publish merges them, in order, once (a warp's lanes over the groups,
// twelve loads in flight), and the others take its result. As a part's
// output frees its slots, the block's next part loads into them and is
// summed as it lands: a sample the rings hold (a frame at 576x1024: 5.9 MB
// in 31 parts) is read from device memory once, its writes overlapping the
// next part's reads. A larger sample (a clip at 576x1024, the VAE's tiles,
// SVD's decoder clip) streams through the rings, each keeping its last 192
// KB, and what they do not keep (all but 25 MB) is read again, latest
// first, from L2 where it still is: the chunks read for the last time, and
// the output of those the rings kept, leave L2 first. Tried against the
// design kept (ms at 16 x 320 x 72 x 128 with emb and SiLU, and the clip of
// 16 frames; bf16, NVIDIA H100 80GB HBM3): two blocks an SM with four
// 24 KB slots (0.161 / 0.134, the merge then a lane's serial loads); three
// parts of four 16 KB chunks deep in a ring of twelve (0.181 / 0.117); two
// parts in the ring, the next summed while the last is written (spilled,
// 0.194 / 0.129); the next part asked into L2 ahead of its loads, and the
// rest of a streamed part read again through registers first (no gain;
// spills); 16 KB, 32 KB and 48 KB slots (within 5 % either way).
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

#include "hopper.cuh"
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
constexpr int kSlots = 8;                       // its ring of bulk copies: slots,
constexpr int kSlotBytes = 24 * 1024;           // whole rows each; one block an SM
constexpr int kMergeLoads = 12;                 // loads in flight a lane merging a sample's parts
constexpr int kLag = 2;                         // loads in flight ahead of the next part's sum

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
  // f rounded to T, as store writes it
  __device__ __forceinline__ static Raw pack(const float* f) {
    Raw u;
    if constexpr (sizeof(T) == 2) {
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    } else {
      u = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                     __float_as_uint(f[3]));
    }
    return u;
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

constexpr long long kSpinCycles = 1LL << 34;   // ~10 s: a wait that long is a fault

// A block's thread 0, after a __syncthreads that follows the block's
// writes: publishes them and counts the block in (release), and sees what
// the blocks counted before it published (acquire). Returns the count
// before.
__device__ __forceinline__ unsigned arrive(unsigned* count) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(count)
               : "memory");
  return old;
}

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

// A 16-byte store marked first to leave L2 (policy from createpolicy).
__device__ __forceinline__ void store_l2_hint(void* p, const uint4& v, uint64_t policy) {
  asm volatile("st.global.L2::cache_hint.v4.b32 [%0], {%1, %2, %3, %4}, %5;\n" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "l"(policy)
               : "memory");
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
  float* part;           // parts > 1: (N, parts, groups, 2) part (mean, M2)
  float* fin;            // parts > 1: (N, groups, 2) (mean, rstd)
  unsigned* count;       // parts > 1: (N) parts published (+ 1: fin written), zeroed first
  long long sn;          // x's element stride between samples
  unsigned p;            // pixels a sample: the rows of its (P, C) matrix
  unsigned rows;         // rows a chunk (a ring slot's)
  int chunks;            // chunks a sample
  int parts;             // blocks a sample
  int c, groups, cpg;
  int v;                 // 16-byte vectors a row
  int units;
  float eps;
  int silu;
};

// The ring's loads: thread 0 issues them, every thread counts them, so a
// load's slot (its index mod kSlots) and the parity of its slot's phase
// (its index / kSlots) are known to all. A chunk read for the last time
// (the ring keeps it, or it is read again) leaves L2 first.
struct Ring {
  unsigned char* slots;  // kSlots x kSlotBytes
  uint64_t* full;        // kSlots mbarriers: a phase a load
  unsigned issued = 0, used = 0;
  template <typename T>
  __device__ __forceinline__ void issue(const RowParams& p, const T* xu, int s, bool once) {
    const unsigned r0 = (unsigned)s * p.rows;
    const unsigned bytes = min(p.rows, p.p - r0) * (unsigned)p.c * (unsigned)sizeof(T);
    const int slot = issued % kSlots;
    if (threadIdx.x == 0) {
      dct::hopper::mbar_arrive_expect_tx(&full[slot], bytes);
      dct::hopper::bulk_load(slots + (size_t)slot * kSlotBytes, xu + (long long)r0 * p.c, bytes,
                             &full[slot], once);
    }
    ++issued;
  }
  // Waits for the next load in order; returns its slot.
  template <typename T>
  __device__ __forceinline__ T* next() {
    const int slot = used % kSlots;
    dct::hopper::mbar_wait(&full[slot], (used / kSlots) & 1);
    ++used;
    return at<T>(used - 1);
  }
  // The slot of load number `load`.
  template <typename T>
  __device__ __forceinline__ T* at(unsigned load) const {
    return reinterpret_cast<T*>(slots + (size_t)(load % kSlots) * kSlotBytes);
  }
};

// Persistent, one block an SM: block b takes parts b, b + grid, ... of the
// list of every sample's parts (sample-major). A part is a run of the
// sample's chunks: at most kSlots where the card's rings hold the sample,
// else one part a block. Each thread sums its vector column's values, less
// a shift common to the block (each group's value in the part's first
// row), into the sums of its one or two groups; the block adds them a
// group, in a fixed order. A sample of one part has its moments in the
// block; a larger one's blocks publish their parts' to scratch, the last to
// publish merges them all, in order, once, and the others take its result.
// A part streams through the ring kSlots loads ahead and its last kSlots
// chunks stay there; the block's next part starts loading into any slot
// this one leaves free, then into each slot whose chunk is written out.
// The rest of a larger part is read again through the ring, the latest
// read first (it may still be in L2). A sample's parts are resident
// together (cooperative launch, parts <= grid), a block holds at most one
// part of a sample, and it counts a part in having waited only on earlier
// samples: no block waits forever.
template <typename T>
__global__ void __launch_bounds__(kRowThreads, 1) group_norm_rows_kernel(const RowParams p) {
  constexpr int kV = dct::Vec16<T>::kVec;
  using IO = VecIO<T, kV>;
  using Raw = typename IO::Raw;
  // [ring: kSlots x kSlotBytes][mbarriers][sums: 4 floats a thread][groups' (mean, rstd)]
  // [groups' shifts][flag]
  Ring ring;
  ring.slots = smem_raw;
  ring.full = reinterpret_cast<uint64_t*>(smem_raw + kSlots * kSlotBytes);
  float* mom = reinterpret_cast<float*>(ring.full + kSlots);
  float* grp = mom + 4 * blockDim.x;
  float* shift = grp + 2 * p.groups;
  int* last = reinterpret_cast<int*>(shift + p.groups);
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int nw = nt >> 5;
  const int c0 = (tid % p.v) * kV;   // the thread's vector column: nt is a multiple of v
  const int ga = c0 / p.cpg, split = min(kV, (ga + 1) * p.cpg - c0);
  const int gb = split < kV ? ga + 1 : ga;
  const bool has_add = p.add != nullptr, silu = p.silu != 0;
  if (tid == 0) {
    for (int i = 0; i < kSlots; ++i) dct::hopper::mbar_init(&ring.full[i], 1);
    dct::hopper::mbar_fence_init();
  }
  __syncthreads();

  // part j of a sample: chunks [first(j), first(j + 1))
  auto first = [&](int j) { return (int)((unsigned)j * (unsigned)p.chunks / (unsigned)p.parts); };
  auto unit_x = [&](int u) { return static_cast<const T*>(p.x) + (long long)u * p.sn; };
  auto vectors = [&](int s) { return (int)(min(p.rows, p.p - (unsigned)s * p.rows) * p.v); };

  // The item being summed: its chunks [lo, hi) and unit u, its emb add,
  // and a vector element's shift and sums (an element's group is fixed: no
  // branch a value).
  int sum_u = 0, sum_lo = 0, sum_hi = 0;
  const T* sum_addu = nullptr;
  Raw sum_addv = {};
  float sh[kV] = {}, s1[kV] = {}, s2[kV] = {};
  auto begin_sum = [&](int it) {
    const int part = it % p.parts;
    sum_u = it / p.parts;
    sum_lo = first(part);
    sum_hi = first(part + 1);
    if (has_add) {
      sum_addu = static_cast<const T*>(p.add) + (long long)sum_u * p.c;
      sum_addv = IO::load_raw(sum_addu + c0);
    }
#pragma unroll
    for (int i = 0; i < kV; ++i) s1[i] = s2[i] = 0.f;
  };
  // Sums chunk s of the item being summed, the ring's next load (a part of
  // more than kSlots chunks refills the slot once every thread has summed
  // it), keeping v in the part's last kSlots.
  auto sum_chunk = [&](int s) {
    T* st = ring.next<T>();
    if (s == sum_lo) {   // the shifts from the first row, before any thread writes v there
      for (int g = tid; g < p.groups; g += nt)
        shift[g] = static_cast<float>(st[g * p.cpg]) +
                   (has_add ? static_cast<float>(sum_addu[g * p.cpg]) : 0.f);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kV; ++i) sh[i] = shift[i < split ? ga : gb];
    }
    const bool keep = has_add && s >= sum_hi - kSlots;
    const int nv = vectors(s);
    for (int lv = tid; lv < nv; lv += nt) {
      Raw r = IO::load_raw(st + (size_t)lv * kV);
      if (has_add) {
        IO::add_vec(r, sum_addv);
        if (keep) IO::store_raw(st + (size_t)lv * kV, r);
      }
      float f[kV];
      IO::unpack(r, f);
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        const float d = f[i] - sh[i];
        s1[i] += d;
        s2[i] = fmaf(d, d, s2[i]);
      }
    }
    if (s + kSlots < sum_hi) {
      __syncthreads();
      ring.issue(p, unit_x(sum_u), s + kSlots, s + 2 * kSlots >= sum_hi);
    }
  };
  // The summed item's part's moments a group, added in order of (row,
  // column): warp w takes groups w, w + nw, ...; written to scratch, or, a
  // sample of one part, the sample's to grp. Returns the ring's loads used.
  auto end_sum = [&](int it) {
    const int part = it % p.parts;
    float a1 = 0.f, a2 = 0.f, b1 = 0.f, b2 = 0.f;
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const bool a = i < split;
      a1 += a ? s1[i] : 0.f;
      a2 += a ? s2[i] : 0.f;
      b1 += a ? 0.f : s1[i];
      b2 += a ? 0.f : s2[i];
    }
    float* m = mom + 4 * tid;
    m[0] = a1;
    m[1] = a2;
    m[2] = b1;
    m[3] = b2;
    __syncthreads();
    const int k = nt / p.v;
    const float part_n = (float)((min(p.p, (unsigned)sum_hi * p.rows) - (unsigned)sum_lo * p.rows) *
                                 (unsigned)p.cpg);
    for (int g = warp; g < p.groups; g += nw) {
      const int jlo = g * p.cpg / kV, ncol = ((g + 1) * p.cpg - 1) / kV - jlo + 1;
      float t1 = 0.f, t2 = 0.f;
      for (int i = lane; i < ncol * k; i += 32) {
        const int rr = i / ncol, j = jlo + i % ncol;
        const float* q = mom + 4 * (rr * p.v + j) + (j * kV / p.cpg == g ? 0 : 2);
        t1 += q[0];
        t2 += q[1];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        t1 += __shfl_down_sync(0xffffffffu, t1, off);
        t2 += __shfl_down_sync(0xffffffffu, t2, off);
      }
      if (lane == 0) {
        const float d = t1 / part_n, mean = shift[g] + d, m2 = fmaxf(fmaf(-t1, d, t2), 0.f);
        if (p.parts == 1) {
          grp[2 * g] = mean;
          grp[2 * g + 1] = rsqrtf(m2 / part_n + p.eps);
        } else {
          float* q = p.part + (((size_t)sum_u * p.parts + part) * p.groups + g) * 2;
          q[0] = mean;
          q[1] = m2;
        }
      }
    }
    __syncthreads();
    return ring.used;
  };

  // Thread 0 waits until item it's sample has its moments in fin.
  auto wait_moments = [&](int it) {
    const long long t0 = clock64();
    while (ld_acquire(p.count + it / p.parts) <= (unsigned)p.parts) {
      __nanosleep(32);
      if (clock64() - t0 > kSpinCycles) __trap();
    }
  };

  // A sample of several parts: thread 0 counts item it's part in; the
  // last of its sample's parts to arrive merges them all: warp w takes
  // parts w, w + nw, ... (lane l group l, twelve loads in flight), then warp
  // 0 merges the warps' sums in order, into fin, and counts the sample's
  // moments in.
  auto publish = [&](int it) {
    const int u = it / p.parts;
    unsigned* count = p.count + u;
    if (tid == 0) *last = arrive(count) == (unsigned)p.parts - 1;
    __syncthreads();
    if (!*last) return;
    const float* pu = p.part + (size_t)u * p.parts * p.groups * 2;
    for (int g0 = 0; g0 < p.groups; g0 += 32) {
      const int g = g0 + lane;
      Moments t = {0.f, 0.f, 0.f};
      if (g < p.groups) {
        for (int j0 = warp; j0 < p.parts; j0 += kMergeLoads * nw) {
          float2 q[kMergeLoads];
#pragma unroll
          for (int i = 0; i < kMergeLoads; ++i) {
            const int j = j0 + i * nw;
            if (j < p.parts)
              q[i] = __ldcg(reinterpret_cast<const float2*>(pu + ((size_t)j * p.groups + g) * 2));
          }
#pragma unroll
          for (int i = 0; i < kMergeLoads; ++i) {
            const int j = j0 + i * nw;
            if (j < p.parts) {
              const unsigned rows =
                  min(p.p, (unsigned)first(j + 1) * p.rows) - (unsigned)first(j) * p.rows;
              t = merge(t, {(float)(rows * (unsigned)p.cpg), q[i].x, q[i].y});
            }
          }
        }
      }
      float* mt = mom + 3 * tid;
      mt[0] = t.n;
      mt[1] = t.mean;
      mt[2] = t.m2;
      __syncthreads();
      if (warp == 0 && g < p.groups) {
        Moments s = {0.f, 0.f, 0.f};
        for (int w = 0; w < nw; ++w) {
          const float* q = mom + 3 * (w * 32 + lane);
          s = merge(s, {q[0], q[1], q[2]});
        }
        p.fin[((size_t)u * p.groups + g) * 2] = s.mean;
        p.fin[((size_t)u * p.groups + g) * 2 + 1] = rsqrtf(s.m2 / s.n + p.eps);
      }
      __syncthreads();
    }
    if (tid == 0) arrive(count);
  };

  // Each item: its chunks not yet issued (the first kSlots); its sums (of
  // the chunks not summed during the item before) and moments; its output,
  // with the sample's moments (in grp for a sample of one part, else from
  // fin once thread 0 has seen them published): the chunks the ring holds
  // (loads end - held .. end - 1), each slot then taking a chunk of the
  // block's next item, summed kLag loads later, where the ring holds that
  // item's part whole; then the others read again through the ring, latest
  // first.
  const int items = p.units * p.parts, step = gridDim.x;
  int have = 0, summed = 0;   // the item's chunks issued and summed during the one before
  for (int it = blockIdx.x; it < items; it += step) {
    const int u = it / p.parts, part = it % p.parts, lo = first(part), hi = first(part + 1);
    const int held = min(kSlots, hi - lo), again = hi - held - lo;
    if (summed == 0) begin_sum(it);
    for (int s = lo + have; s < lo + held; ++s) ring.issue(p, unit_x(u), s, s >= hi - kSlots);
    const int next = it + step, nlo = first(next % p.parts), nhi = first(next % p.parts + 1);
    const int want = next < items && again == 0 && nhi - nlo <= kSlots ? nhi - nlo : 0;
    const T* xn = unit_x(next / p.parts);
    int ahead = 0;
    for (; ahead < min(want, kSlots - held); ++ahead) ring.issue(p, xn, nlo + ahead, true);
    for (int s = lo + summed; s < hi; ++s) sum_chunk(s);
    const unsigned end = end_sum(it);
    if (p.parts > 1) {
      publish(it);
      if (tid == 0) wait_moments(it);
      __syncthreads();
      const float* fu = p.fin + (size_t)u * p.groups * 2;
      for (int i = tid; i < 2 * p.groups; i += nt) grp[i] = __ldcg(fu + i);
      __syncthreads();
    }
    float sc[kV], bi[kV];
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const int g = i < split ? ga : gb;
      sc[i] = p.w[c0 + i] * grp[2 * g + 1];
      bi[i] = fmaf(-grp[2 * g], sc[i], p.b[c0 + i]);
    }
    T* ou = static_cast<T*>(p.out) + (long long)u * p.p * p.c;
    Raw addv = {};
    if (has_add) addv = IO::load_raw(static_cast<const T*>(p.add) + (long long)u * p.c + c0);
    // a part the ring does not hold whole: its held chunks' output leaves
    // L2 first, so that the rest read again finds more of itself there
    uint64_t evict_first = 0;
    if (again > 0)
      asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(evict_first));
    auto out = [&](const T* st, int s, bool reread) {
      T* oc = ou + (long long)s * p.rows * p.c;
      const int nv = vectors(s);
      for (int lv = tid; lv < nv; lv += nt) {
        Raw r = IO::load_raw(st + (size_t)lv * kV);
        if (reread && has_add) IO::add_vec(r, addv);
        float f[kV];
        IO::unpack(r, f);
#pragma unroll
        for (int q = 0; q < kV; ++q) f[q] = silu_or_not(fmaf(f[q], sc[q], bi[q]), silu);
        if (again > 0 && !reread)
          store_l2_hint(oc + (size_t)lv * kV, IO::pack(f), evict_first);
        else
          IO::store(oc + (size_t)lv * kV, f);
      }
    };
    int nsum = 0;   // the next item's chunks summed here
    for (int s = hi - held; s < hi; ++s) {
      out(ring.at<T>(end - (unsigned)(hi - s)), s, false);
      if (ahead < want) {   // the slot's next load comes after every thread's use of it
        dct::hopper::fence_proxy_async();
        __syncthreads();
        ring.issue(p, xn, nlo + ahead++, true);
        if (ahead - nsum > kLag) {
          if (nsum == 0) begin_sum(next);
          sum_chunk(nlo + nsum++);
        }
      }
    }
    have = ahead;
    summed = nsum;
    if (again > 0) {
      dct::hopper::fence_proxy_async();
      __syncthreads();
      for (int j = 0; j < min(kSlots, again); ++j)
        ring.issue(p, unit_x(u), hi - held - 1 - j, true);
      for (int j = 0; j < again; ++j) {
        const int s = hi - held - 1 - j;
        out(ring.next<T>(), s, true);
        if (j + kSlots < again) {
          __syncthreads();
          ring.issue(p, unit_x(u), s - kSlots, true);
        }
      }
    }
    // the ring's next loads into these slots come after every thread's
    // reads and writes of them
    dct::hopper::fence_proxy_async();
    __syncthreads();
  }
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

// The plans by name (ops/norms.py's GN_PLANS, in this order): per channel,
// a block a group or cooperative rounds of them; channels-last, a block a
// sample, a sample's parts held on chip, or streamed past what the card
// holds and partly read again.
enum PlanKind { kChannel = 0, kChannelRounds, kRowsBlock, kRowsHeld, kRowsStreamed };

struct Plan {
  bool ok = false;
  int kind = kChannel;
  int splits = 1;          // blocks a unit (channels-last: parts a sample)
  unsigned chunk = 0;      // per-channel: elements a block; channels-last: rows a ring slot
  int threads = kThreads;
  size_t smem = 0;         // a block's dynamic shared memory
  int per_round = 0;       // per-channel: units a round
  int grid = 0;            // blocks launched
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
    pl.kind = kChannelRounds;
    rounds(pl, ng, slots);
    pl.scratch = ng * pl.splits * 2 + ng;
  }
  pl.grid = pl.per_round * pl.splits;
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

// A sample's chunks (whole rows, a ring slot each) and parts (runs of at
// most kSlots chunks, or as many parts as blocks are resident where that
// is fewer) follow from its shape and the card alone.
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
  pl.threads = base * std::max(1, (kRowThreads + base / 2) / base);
  if (pl.threads > kRowThreads) pl.threads = base;
  const long long row_bytes = (long long)c * sizeof(T);
  if (row_bytes > kSlotBytes) return pl;
  pl.chunk = (unsigned)std::min<long long>(pixels, kSlotBytes / row_bytes);
  const long long chunks = (pixels + pl.chunk - 1) / pl.chunk;
  pl.smem = (size_t)kSlots * kSlotBytes + kSlots * sizeof(uint64_t) +
            (size_t)(4 * pl.threads + 3 * groups + 1) * sizeof(float);
  const int slots = resident(group_norm_rows_kernel<T>, pl.threads, pl.smem);
  if (slots == 0) return pl;
  const long long parts = std::min<long long>(slots, (chunks + kSlots - 1) / kSlots);
  if (units * parts >= 0x7fffffffLL) return pl;
  pl.ok = true;
  pl.splits = (int)parts;
  pl.grid = (int)std::min<long long>(units * parts, slots);
  if (parts == 1) {
    pl.kind = kRowsBlock;
  } else {
    pl.kind = chunks <= parts * kSlots ? kRowsHeld : kRowsStreamed;
    pl.scratch = units * parts * groups * 2 + units * groups * 2 + units;
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

// splits == 1: a plain launch; else a cooperative one, the units' counters
// zeroed first.
template <typename K, typename P>
int launch_on_chip(K kern, const P& p, const Plan& pl, unsigned* count, long long units,
                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.blockDim = dim3(pl.threads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cfg.gridDim = dim3((unsigned)pl.grid);
  if (pl.splits > 1) {
    cudaError_t err = cudaMemsetAsync(count, 0, (size_t)units * sizeof(unsigned), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
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
  p.chunks = (int)((p.p + pl.chunk - 1) / pl.chunk);
  p.parts = pl.splits;
  if (pl.splits > 1) {
    p.fin = p.part + (size_t)p.units * pl.splits * p.groups * 2;
    p.count = reinterpret_cast<unsigned*>(p.fin + (size_t)p.units * p.groups * 2);
  }
  return launch_on_chip(group_norm_rows_kernel<T>, p, pl, p.count, p.units, stream);
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

// The GroupNorm plan for a shape (not ok for one the kernels do not take).
Plan plan_of(int dtype, int channels_last, long long n, int c, long long r, long long hw,
             int groups) {
  if (groups <= 0 || c % groups || n <= 0 || r <= 0 || hw <= 0) return Plan();
  const long long e = (long long)(c / groups) * r * hw;
  if (e >= 0x7fffffffLL || n * groups >= 0x7fffffffLL || r * hw >= 0x7fffffffLL ||
      (long long)c * r * hw >= 0x7fffffffLL)
    return Plan();
  if (dtype == dct::kBFloat16)
    return plan<__nv_bfloat16>(channels_last != 0, n, c, r, hw, groups, true);
  if (dtype == dct::kFloat32) return plan<float>(channels_last != 0, n, c, r, hw, groups, true);
  return Plan();
}

}  // namespace

// Floats of scratch the GroupNorm plan needs for this shape (0: none), or
// -1 for a shape the kernels do not take. channels_last: each of the n
// samples a contiguous (r * hw, c) matrix (16-byte aligned); else x viewed
// as (n, c, r, hw) with hw contiguous.
extern "C" long long dct_group_norm_scratch(int dtype, int channels_last, long long n, int c,
                                            long long r, long long hw, int groups) {
  const Plan pl = plan_of(dtype, channels_last, n, c, r, hw, groups);
  return pl.ok ? pl.scratch : -1;
}

// The GroupNorm plan for this shape, as PlanKind numbers it, or -1 for a
// shape the kernels do not take; arguments as dct_group_norm_scratch.
extern "C" int dct_group_norm_plan(int dtype, int channels_last, long long n, int c, long long r,
                                   long long hw, int groups) {
  const Plan pl = plan_of(dtype, channels_last, n, c, r, hw, groups);
  return pl.ok ? pl.kind : -1;
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
