// Hopper (sm_90a) building blocks shared by the kernels of this package
// (maxsim.cu, dense_topk.cu, scatter_score.cu, attention.cu), as raw PTX: no
// CUTLASS/CuTe, so each source builds in seconds.
//
//   * mbarriers: init, arrive, arrive with an expected transaction count,
//     and a parity wait;
//   * TMA tile loads (cp.async.bulk.tensor, 2-D, 3-D and 4-D) completing on
//     an mbarrier, 4-D TMA tile stores (bulk groups), and the host-side
//     encoding of their CUtensorMap, reached through cudaGetDriverEntryPoint
//     so a library links the runtime only; and 1-D bulk copies
//     (cp.async.bulk), which need no tensor map;
//   * wgmma shared-memory descriptors under the 128-byte swizzle for K-major
//     tiles and for MN-major B tiles, wgmma fence / commit / wait, and the
//     product shapes the kernels issue (m64n128k16 and m64n64k16 from shared
//     memory, m64n64k16 with A from registers, with B K-major or MN-major);
//   * setmaxnreg, to hand the producer's registers to the consumers;
//   * on the host, the shared-memory limit raised once per kernel and device.
//
// Tile layout every descriptor here assumes: a TMA box whose inner extent is
// 128 bytes (64 bf16 or 128 int8), written by TMA under
// CU_TENSOR_MAP_SWIZZLE_128B into shared memory aligned to 1,024 bytes, so
// row r of the box is the 128 bytes at r * 128 with its 16-byte chunk c at
// chunk c ^ (r % 8).  For such a "swizzle atom" of 8-row groups, the
// descriptor's stride byte offset (between 8-row groups) is 1,024 and its
// leading byte offset is unused; a k16 step of bf16 (32 bytes) inside the
// atom advances the start address by 32 bytes, and the hardware applies the
// swizzle to the advanced address.
//
// The same tile read as an MN-major B operand (desc_mn_sw128: the 64 bf16 of
// a 128-byte row are 64 consecutive N, the rows run along K): a k16 step is
// 16 rows, so it advances the start address by 2,048 bytes (two whole 8-row
// groups), the stride byte offset (between 8-row groups along K) is again
// 1,024, and the leading byte offset would step to the next 64 N (unused at
// N = 64).  This is how the attention kernels multiply by a [keys, 64] tile
// whose keys are the reduction dim (P.V, dS.K, P^T.dO, dS^T.Q).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace hopper {

constexpr int kAtomAlign = 1024;  // 8 rows x 128 bytes: one swizzle period

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival that also expects `bytes` of TMA transactions on this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// returns once the phase of the barrier with parity `parity` has completed.
// A wait of more than 2^34 clocks (seconds) can only be a pipeline fault: it
// traps, so the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0)
      t0 = clock64();
    else if (clock64() - t0 > (1ll << 34))
      __trap();
  }
}

// --------------------------------------------------------------------- TMA
// box at coordinates (c0, c1[, c2]) (innermost first, in elements) of the
// tensor map `map` into shared memory at `dst`, completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// the box at (c0, c1, c2, c3) of `map` from shared `src` (written by this
// CTA's threads: fence_proxy_async first) to global memory; elements past a
// dim are not written.  One bulk group per call of bulk_commit; the source
// must stay untouched until bulk_wait_read<0> returns.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// returns once at most N of this thread's committed bulk groups still read
// their shared-memory source
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned, as one 1-D bulk copy completing on `bar`: no tensor map
__device__ __forceinline__ void bulk_load_1d(void* dst, const void* src, uint32_t bytes,
                                             uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 16 bytes, or one f32, from shared memory (an explicit ld.shared: a generic
// load of a shared address costs an address-space check, and the compiler
// keeps it in order with the wgmma instructions around it)
__device__ __forceinline__ uint4 lds128(const void* p) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(smem_u32(p))
               : "memory");
  return v;
}

__device__ __forceinline__ float lds_f32(const void* p) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(smem_u32(p)) : "memory");
  return v;
}

// generic-proxy writes to shared memory made visible to wgmma / TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barrier over `threads` threads (id 0 is __syncthreads)
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ------------------------------------------------------------------- wgmma
// descriptor of a K-major tile under the 128-byte swizzle starting at `p`
// (p is a swizzle atom's base plus k * 32 bytes inside its 128-byte rows)
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4)       // start address, 16-byte units
         | (1ull << 16)                // leading byte offset (unused here)
         | (uint64_t(1024 >> 4) << 32)  // stride byte offset: 8 rows of 128 bytes
         | (1ull << 62);               // layout: 128-byte swizzle
}

// descriptor of an MN-major B tile under the 128-byte swizzle starting at
// `p` (p is a swizzle atom's base plus a whole number of 8-row groups: k16
// step k of a [K, 64] tile is p = base + k * 2,048)
__device__ __forceinline__ uint64_t desc_mn_sw128(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4)        // start address, 16-byte units
         | (uint64_t(8192 >> 4) << 16)  // leading byte offset: the next 64 N (unused at N = 64)
         | (uint64_t(1024 >> 4) << 32)  // stride byte offset: 8 rows (of K) of 128 bytes
         | (1ull << 62);                // layout: 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pins a register value in program order against the volatile wgmma
// instructions: reads of an accumulator stay below a wgmma_wait, writes
// above a wgmma_fence
__device__ __forceinline__ void fence_regs(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_regs(uint4& r) {
  asm volatile("" : "+r"(r.x), "+r"(r.y), "+r"(r.z), "+r"(r.w)::"memory");
}

// -------------------------------------------------------------- setmaxnreg
template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// d[0:64] (+)= A * B^T over one k16 step: m64n128k16, A and B from shared
// memory (K-major, 128-byte swizzle), f32 accumulators; scale_d 0 starts
// from zero.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float* d, uint64_t desc_a, uint64_t desc_b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[0:32] (+)= A * B^T over one k16 step: m64n64k16, A from registers
// (a[0:4], the mma.m16n8k16 fragment of this warp's 16 rows), B from shared
// memory (K-major, 128-byte swizzle), f32 accumulators.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float* d, const uint32_t* a, uint64_t desc_b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

#define HOPPER_WGMMA_D32                                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),          \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),  \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),            \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),            \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d[0:32] (+)= A * B^T over one k16 step: m64n64k16, A and B from shared
// memory, both K-major (128-byte swizzle), f32 accumulators.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float* d, uint64_t desc_a, uint64_t desc_b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_WGMMA_D32
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[0:32] (+)= A * B over one k16 step: m64n64k16, A from registers (as
// wgmma_m64n64k16_rs), B from shared memory MN-major (desc_mn_sw128: the
// transpose-B immediate set), f32 accumulators.
__device__ __forceinline__ void wgmma_m64n64k16_rs_mn(float* d, const uint32_t* a, uint64_t desc_b,
                                                     int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HOPPER_WGMMA_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

#undef HOPPER_WGMMA_D32

// -------------------------------------------------------------------- host
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, looked up once through the runtime
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// cudaFuncSetAttribute(kernel, MaxDynamicSharedMemorySize, smem), unless
// this process has already raised the kernel's limit that far on the
// current device: the call costs host time on every launch otherwise.
template <typename Kernel>
inline cudaError_t raise_smem_limit(Kernel kernel, size_t smem) {
  static std::mutex lock;
  static std::map<std::pair<const void*, int>, size_t> raised;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(lock);
  size_t& done = raised[{reinterpret_cast<const void*>(kernel), dev}];
  if (done >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) done = smem;
  return err;
}

// A tiled tensor map, under the 128-byte swizzle unless `swizzle` says
// otherwise: `rank` dims (innermost first, in elements), the byte strides of
// dims 1.. and the box extents.  Elements past a dim are read as zeros.
// Returns cudaSuccess, or cudaErrorInvalidValue where cuTensorMapEncodeTiled
// refuses the map.
inline cudaError_t encode_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
                              const void* base, const cuuint64_t* dims, const cuuint64_t* strides,
                              const cuuint32_t* box,
                              CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, type, (cuuint32_t)rank, const_cast<void*>(base), dims, strides, box,
                        unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
