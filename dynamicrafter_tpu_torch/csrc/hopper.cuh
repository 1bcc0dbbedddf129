// Hopper-only building blocks (sm_90a): mbarriers, TMA tensor loads and
// their host-side tensor maps, bulk copies of contiguous bytes, wgmma with
// A in registers and B read from shared memory through a descriptor, named
// barriers. First used by the bf16 route of fused_conv.cu (K7, K8:
// `fused_conv_tc_kernel`); the later wgmma + TMA steps of K1/K3 and K4 are
// meant to share them. norms.cu's channels-last GroupNorm streams its rows
// through bulk copies.
//
// Every device helper is issued by the threads its contract names and
// touches only shared memory addresses of the calling block (no clusters).
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace dct {
namespace hopper {

// The 32-bit shared-window address of a pointer into shared memory.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarrier -----------------------------------------------------------------
// An mbarrier is 8 bytes of shared memory, 8-byte aligned. Its phase
// completes when `count` arrivals (set once by `mbar_init`) and every byte
// announced by `mbar_arrive_expect_tx` have landed; the next phase starts
// at once. Phases are told apart by their parity, 0 for the first.

// One thread initialises; then `mbar_fence_init` and a block-wide barrier
// before any other thread touches the mbarrier.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// Makes the initialisation visible to the asynchronous proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival (release semantics: this thread's earlier shared-memory
// reads and writes happen before the phase completes).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// One arrival that also announces `bytes` more bytes of transactions (the
// TMA loads that complete on this barrier) for the current phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Block until the phase of parity `parity` has completed (acquire: what was
// written before it completed, TMA bytes included, is visible after). A
// phase of parity 1 counts as complete before the first phase ends, so a
// producer that waits for parity (uses ^ 1) passes its first round. A wait
// that spins for 2^35 clocks (about 18 s) traps: a pipeline fault ends the
// launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done;
  do {
    if (clock64() - start > (1ll << 35)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// -- TMA ----------------------------------------------------------------------
// One thread copies the box of `map` at element coordinates (c0, c1, c2)
// (innermost first; they may be negative or past the tensor, where the
// box is zero-filled) into shared memory at `dst` (128-byte aligned;
// 1024-byte aligned under a 128-byte swizzle) and completes the box's
// bytes on `bar`, which must have announced them. `map` is a
// __grid_constant__ kernel parameter.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// One thread copies `bytes` (a multiple of 16; both addresses 16-byte
// aligned) of contiguous global memory into shared memory at `dst` and
// completes them on `bar`, which must have announced them. `evict_first`
// marks the bytes first to leave L2: they will not be read again.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar, bool evict_first) {
  if (evict_first) {
    uint64_t policy;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
        " [%0], [%1], %2, [%3], %4;\n"
        ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
  }
}
// Orders the calling thread's earlier shared-memory accesses (generic
// proxy) before later TMA copies into the same bytes (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Fetch a tensor map into the TMA unit's cache ahead of its first use.
__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// -- barriers ---------------------------------------------------------------------
// A barrier over `threads` threads (a multiple of 32) of the block, id 1-15
// (0 is __syncthreads); every warp that takes part calls it.
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// -- wgmma ----------------------------------------------------------------------
// A shared-memory matrix descriptor for a 128-byte-swizzled operand as TMA
// writes it with CU_TENSOR_MAP_SWIZZLE_128B: `addr` is the operand's first
// byte (1024-byte aligned, or the swizzle's base offset would be needed),
// `lbo` the bytes between 64-element-wide column blocks along M or N and
// `sbo` the bytes between groups of 8 rows along K (MN-major operand).
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// Before the first wgmma of a batch, and whenever its A registers or
// accumulators were written by other instructions since the last one.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
// Close the wgmma issued since the last commit into one group.
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most kPending groups are in flight: the accumulators, A
// registers and shared memory of the older ones are free again.
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// d (64 x N, fp32) += a (64 x 16, bf16, registers) * b (16 x N, bf16,
// shared memory, MN-major: N contiguous, `desc_b` from desc_b128), issued
// by all 128 threads of a warpgroup. Warp w of the warpgroup supplies rows
// 16w .. 16w + 15 of a in the layout of mma.sync m16n8k16's A fragment
// (mma.cuh: ldmatrix_x4 of a 16 x 16 block gives it) and receives d
// element (16w + lane / 4 + 8 * ((i / 2) % 2), 8 * (i / 4) + 2 * (lane % 4)
// + i % 2) in d[i]. Asynchronous: between issue and wgmma_wait neither d
// nor a may be touched.
template <int N>
struct WgmmaRS;

template <>
struct WgmmaRS<160> {
  __device__ __forceinline__ static void run(float (&d)[80], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
        "{%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

// -- host: tensor maps --------------------------------------------------------------
// cuTensorMapEncodeTiled, looked up in libcuda at run time (the library is
// linked without -lcuda), or nullptr where libcuda lacks it.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A 3-D bf16 tensor map: `dims` elements innermost first, `strides` the
// bytes between steps of dims 1 and 2 (multiples of 16), `box` the
// elements one load copies (each <= 256; box[0] * 2 bytes a multiple of
// 16, at most 128 under the 128-byte swizzle). Out-of-range elements read
// as zero. cudaErrorInvalidValue if the encoding is refused.
inline cudaError_t make_map_3d_bf16(CUtensorMap* map, const void* base, const uint64_t dims[3],
                                    const uint64_t strides[2], const uint32_t box[3],
                                    bool swizzle128) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t d[3] = {dims[0], dims[1], dims[2]};
  const cuuint64_t s[2] = {strides[0], strides[1]};
  const cuuint32_t b[3] = {box[0], box[1], box[2]};
  const cuuint32_t e[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), d,
                            s, b, e, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzle128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
}  // namespace dct
