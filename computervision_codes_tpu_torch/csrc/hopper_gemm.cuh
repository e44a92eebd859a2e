// Hopper (sm_90a) building blocks for a GEMM main loop fed by an
// asynchronous shared-memory ring: mbarriers, TMA tile loads and the
// driver's tensor-map encoder, 16-byte cp.async with zero fill, the proxy
// fence, and wgmma over operands in the 128-byte swizzle: int8 (m64nNk32,
// s8 x s8 -> s32, both K-major) and bf16 (m64nNk16, bf16 x bf16 -> f32:
// A K-major with B MN-major or K-major; A from registers with B MN-major),
// setmaxnreg for warp-specialised kernels, and the cluster primitives
// (rank, mapa, remote arrivals, the cluster barrier, a multicast TMA load,
// a bulk copy between CTAs).
//
// The layout every operand tile uses: rows of 128 bytes of K, 8 rows to a
// 1024-byte swizzle atom, the 16-byte chunk c of row r stored at chunk
// c ^ (r % 8). TMA's CU_TENSOR_MAP_SWIZZLE_128B writes exactly that (the
// tile's base must be 1024-byte aligned), and a cp.async producer writes
// it by hand (swizzled_chunk). The wgmma descriptor (smem_desc_sw128)
// names the same mode, with 1024 bytes between 8-row groups; a 32-byte K
// step inside the 128-byte row is a start address 32 bytes further on.
//
// Where this goes wrong silently:
// - Proxy fence. wgmma reads shared memory through the async proxy. Data
//   written by cp.async (a generic-proxy write) must be followed, in each
//   writing thread, by cp.async.wait_group and fence.proxy.async.shared::cta
//   before the mbarrier arrive (after __syncwarp, one arrival per warp)
//   that hands the stage to the consumers; without it wgmma may read stale
//   bytes. TMA writes through the async proxy and completes on the
//   mbarrier itself, so it needs no fence.
// - Wait discipline. wgmma_fence() before the first wgmma of a stage (the
//   accumulators were written by other instructions), wgmma_commit() after
//   the stage's wgmmas, and wgmma_wait<N>() before the stage they read is
//   released to the producer.
// - Alignment and size. The swizzle mode of the descriptor must be the
//   tensor map's, a 128B-swizzled tile needs a 1024-byte aligned base, and
//   dynamic shared memory beyond 48 KB needs cudaFuncSetAttribute.
// - Tensor maps. cuTensorMapEncodeTiled is a driver API: it is taken
//   through the runtime's driver entry point (no -lcuda), and the map is
//   passed to the kernel as a const __grid_constant__ CUtensorMap. Maps
//   are cached by (base, shape, box), which is all a map holds.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// one arrival that also expects `bytes` of TMA transactions this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// waits until the phase of parity `parity` has completed (a fresh barrier
// is in phase 0: waiting on parity 1 returns at once)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- copies ---------------------------------------------------------------

// 2-D TMA load of one box at (c0 innermost, c1) into shared memory,
// completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// 4-D TMA load of one box at (c0 innermost, c1, c2, c3), completing on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// 3-D TMA load of one box at (c0 innermost, c1, c2) into the same offset of
// the shared memory of every CTA of the cluster in `mask`, each completing
// on its own mbarrier at `bar`'s offset
__device__ __forceinline__ void tma_load_3d_multicast(void* dst,
                                                      const CUtensorMap* map,
                                                      int c0, int c1, int c2,
                                                      uint64_t* bar,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "h"(mask)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// 16 bytes global -> shared; src_bytes 0 writes 16 zero bytes (and reads
// nothing)
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N of this thread's cp.async groups are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// orders this thread's generic-proxy shared-memory writes before later
// async-proxy reads (wgmma) of the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// byte offset of chunk c (16 bytes) of row r in a 128B-swizzled tile
__device__ __forceinline__ uint32_t swizzled_chunk(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

// ---- wgmma ------------------------------------------------------------------

// K-major operand in the 128-byte swizzle: start address >> 4 (bits 0-13),
// leading byte offset 1 (unused by this mode, bits 16-29), 1024 bytes
// between 8-row groups >> 4 (bits 32-45), layout 1 = SWIZZLE_128B (bits
// 62-63)
__device__ __forceinline__ uint64_t smem_desc_sw128(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) |
         (1ull << 62);
}

// MN-major operand (the N dimension contiguous: a row-major (K, N) bf16
// weight read in place) in the 128-byte swizzle, as TMA writes boxes of 64
// N x ROWS K: row k of a box holds 128 bytes of N, 8 rows make a 1024-byte
// swizzle atom, and the next 64 N start one box (ROWS * 128 bytes) on. For
// this layout the two offsets mean (CUTLASS cute/atom/
// mma_traits_sm90_gmma.hpp, make_gmma_desc<Major::MN>, SW128: the layout
// ((8 x 8 elements, m), (8, k)) : ((1, LBO), (128 B, SBO))): the leading
// byte offset is the stride between 64-element blocks of N (`mn_stride`,
// one box), the stride byte offset the stride between 8-row groups of K
// (1024). A K step of 16 rows is a start address 2048 bytes further on.
__device__ __forceinline__ uint64_t smem_desc_sw128_mn(const void* p,
                                                       uint32_t mn_stride) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(mn_stride >> 4) << 16) |
         ((1024ull >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// an empty asm that reads and writes r: other instructions on an
// accumulator cannot move across it into a run of wgmmas (which would make
// ptxas serialize them, C7515)
__device__ __forceinline__ void fence_operand(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}

__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D (64 x N, int32) += A (64 x 32, s8, K-major) * B (N x 32, s8, K-major)^T.
// Fragment of D in thread t of the warpgroup: d[4j + 2h + c] is row
// 16 (t / 32) + (t % 32) / 4 + 8h, column 8j + 2 (t % 4) + c.
template <int N> struct WgmmaS8;

template <> struct WgmmaS8<64> {
  static __device__ __forceinline__ void run(int (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <> struct WgmmaS8<128> {
  static __device__ __forceinline__ void run(int (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
          "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
          "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
          "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <> struct WgmmaS8<192> {
  static __device__ __forceinline__ void run(int (&d)[96], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
          "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
          "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
          "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
          "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
          "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
          "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
          "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
          "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
          "+r"(d[95])
        : "l"(da), "l"(db), "r"(1));
  }
};

// D (64 x N, float32) += A (64 x 16, bf16, K-major) * B (16 x N, bf16,
// MN-major: imm-trans-b 1) with A's descriptor from smem_desc_sw128 and
// B's from smem_desc_sw128_mn. The fragment of D is WgmmaS8's.
template <int N> struct WgmmaBF16T;

template <> struct WgmmaBF16T<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <> struct WgmmaBF16T<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <> struct WgmmaBF16T<192> {
  static __device__ __forceinline__ void run(float (&d)[96], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95])
        : "l"(da), "l"(db), "r"(1));
  }
};

// D (64 x N, float32) = A (64 x 16, bf16, K-major) * B (N x 16, bf16,
// K-major)^T, plus D when scale_d is nonzero: both descriptors from
// smem_desc_sw128 (B's rows are its N rows, 128 bytes of K each, as the s8
// form reads them). The fragment of D is WgmmaS8's.
template <int N> struct WgmmaBF16;

template <> struct WgmmaBF16<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// D (64 x N, float32) += A (64 x 16, bf16, from registers) * B (16 x N,
// bf16, MN-major: imm-trans-b 1, smem_desc_sw128_mn), plus D when scale_d
// is nonzero. A's fragment in warp w of the warpgroup is mma.sync
// m16n8k16's for rows 16 w .. 16 w + 15: a[0] (row g, columns 2 q, 2 q + 1),
// a[1] (row g + 8, the same), a[2] (row g, columns 2 q + 8, 2 q + 9), a[3]
// (row g + 8, the same), g = lane / 4, q = lane % 4, two bf16 a register
// (the lower column in the low half). So the accumulator d of a 64 x 16
// product (WgmmaS8's fragment: d[4j + 2h + c] at row g + 8h, column
// 8j + 2q + c) packs into it as a[0] = (d[0], d[1]), a[1] = (d[2], d[3]),
// a[2] = (d[4], d[5]), a[3] = (d[6], d[7]).
template <int N> struct WgmmaBF16RS;

template <> struct WgmmaBF16RS<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <> struct WgmmaBF16RS<128> {
  static __device__ __forceinline__ void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

// ---- thread-block clusters ------------------------------------------------

// this CTA's rank in its cluster
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// the shared::cluster address of the variable at `addr` (a shared::cta
// address) in the CTA of rank `rank`
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// one arrival on an mbarrier of any CTA of the cluster (a mapa address),
// with the default release at CTA scope: enough to hand a stage back once
// the wgmmas that read it have completed (a cluster-scope release is a
// fence that costs about a microsecond a stage)
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t remote_bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(
                   remote_bar)
               : "memory");
}

// every thread of every CTA of the cluster arrives (releasing its writes)
// and waits (acquiring the others'); all threads of a warp together
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// bulk copy of `bytes` (a multiple of 16) of this CTA's shared memory to
// another CTA of the cluster (dst, a mapa address), completing on that
// CTA's mbarrier (bar, a mapa address); the source is read through the
// async proxy (fence_proxy_async after writing it)
__device__ __forceinline__ void bulk_copy_to_cta(uint32_t dst,
                                                 const void* src,
                                                 uint32_t bytes,
                                                 uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx"
      "::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(smem_u32(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// register budgets of warp-specialised kernels: the producer warpgroup
// gives registers up, the consumers take them (all four warps of a
// warpgroup execute it; the counts are multiples of 8 in [24, 256])
template <int R> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---- host: tensor maps ----------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, looked up
// once; null if the driver does not offer it
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A row-major (rows, cols) byte matrix as boxes of (box_rows, 128 bytes) in
// the 128-byte swizzle; reads outside the matrix fill zeros. cols * 1 byte
// must be a multiple of 16 and base 16-byte aligned. Returns 0 on success.
inline int encode_u8_sw128(CUtensorMap* map, const void* base,
                           long long rows, long long cols, int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {128u, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1u, 1u};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// encode_u8_sw128 through a per-thread cache. A map holds only the base,
// the shape and the box, never the bytes, so a cached map of the same four
// is the map the encoder would write: a weight's (and an activation
// buffer's that the allocator hands out again) is encoded once.
inline int encode_u8_sw128_cached(CUtensorMap* map, const void* base,
                                  long long rows, long long cols,
                                  int box_rows) {
  struct Entry {
    const void* base;
    long long rows, cols;
    int box_rows;
    CUtensorMap map;
  };
  constexpr int SLOTS = 128;  // beyond the 45 of the int8 student + teacher
  thread_local Entry cache[SLOTS] = {};
  thread_local int next = 0;
  for (const Entry& e : cache)
    if (e.base == base && e.rows == rows && e.cols == cols &&
        e.box_rows == box_rows) {
      *map = e.map;
      return 0;
    }
  const int err = encode_u8_sw128(map, base, rows, cols, box_rows);
  if (err == 0) {
    cache[next] = Entry{base, rows, cols, box_rows, *map};
    next = (next + 1) % SLOTS;
  }
  return err;
}

// A row-major (rows, cols) byte matrix as unswizzled boxes of (box_rows,
// box_cols bytes): row r of a box at r * box_cols in shared memory; reads
// outside the matrix fill zeros. cols and box_cols must be multiples of 16,
// base 16-byte aligned. Through a per-thread cache, as
// encode_u8_sw128_cached. Returns 0 on success.
inline int encode_u8_plain_cached(CUtensorMap* map, const void* base,
                                  long long rows, long long cols,
                                  int box_rows, int box_cols) {
  struct Entry {
    const void* base;
    long long rows, cols;
    int box_rows, box_cols;
    CUtensorMap map;
  };
  constexpr int SLOTS = 32;
  thread_local Entry cache[SLOTS] = {};
  thread_local int next = 0;
  for (const Entry& e : cache)
    if (e.base == base && e.rows == rows && e.cols == cols &&
        e.box_rows == box_rows && e.box_cols == box_cols) {
      *map = e.map;
      return 0;
    }
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1u, 1u};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  cache[next] = Entry{base, rows, cols, box_rows, box_cols, *map};
  next = (next + 1) % SLOTS;
  return 0;
}

// A (planes, rows, cols) byte array, planes and rows dense, as boxes of
// (1, box_rows, 128 bytes) in the 128-byte swizzle; reads outside it (a
// negative row included) fill zeros. cols must be a multiple of 16 and base
// 16-byte aligned. Through a per-thread cache, as encode_u8_sw128_cached.
// Returns 0 on success.
inline int encode_u8_sw128_3d_cached(CUtensorMap* map, const void* base,
                                     long long planes, long long rows,
                                     long long cols, int box_rows) {
  struct Entry {
    const void* base;
    long long planes, rows, cols;
    int box_rows;
    CUtensorMap map;
  };
  constexpr int SLOTS = 64;
  thread_local Entry cache[SLOTS] = {};
  thread_local int next = 0;
  for (const Entry& e : cache)
    if (e.base == base && e.planes == planes && e.rows == rows &&
        e.cols == cols && e.box_rows == box_rows) {
      *map = e.map;
      return 0;
    }
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)cols,
                                 (cuuint64_t)(cols * rows)};
  const cuuint32_t box[3] = {128u, (cuuint32_t)box_rows, 1u};
  const cuuint32_t elem[3] = {1u, 1u, 1u};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  cache[next] = Entry{base, planes, rows, cols, box_rows, *map};
  next = (next + 1) % SLOTS;
  return 0;
}

}  // namespace hopper
