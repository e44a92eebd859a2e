// mma.sync and cp.async helpers shared by the kernels that feed tensor
// cores from registers (Ampere-style, per warp): the window-attention phase
// (window_attn.cuh), P2's group attention (swin_pack_probe.cu) and the
// previous design of K7 and K8 (attention_prev.cuh). cp.async copies of 16,
// 8 or 4 bytes with zero fill (2 bytes, one bf16, a plain load and store);
// ldmatrix of four 8 x 8 bf16 tiles, plain and transposed; mma.sync
// m16n8k16 bf16 x bf16 -> f32; a pair of floats rounded to a bf16 pair
// (pack_bf16 also adds the rounded pair to a sum).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy one chunk of ``vb`` bytes global -> shared, or zeros when !valid.
template <typename T>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src, bool valid,
                                           int vb) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? vb : 0;
  if (vb == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  } else if (vb == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  } else if (vb == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  } else {  // 2 bytes: one bf16, a plain load
    *reinterpret_cast<uint16_t*>(dst) =
        valid ? *reinterpret_cast<const uint16_t*>(src) : uint16_t(0);
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi,
                                              float* sum) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  *sum += __low2float(p) + __high2float(p);
  return *reinterpret_cast<const uint32_t*>(&p);
}

}  // namespace attn
