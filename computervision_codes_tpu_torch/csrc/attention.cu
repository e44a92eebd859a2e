// K7: full multi-head attention over (B, H, T, D), written by hand for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// computervision_codes_tpu/ops/attention.py::attention_pallas (its
// _attn_kernel), which MS-TCT reaches through multi_head_attention in each
// of its 8 global relational blocks. The design, the numerics and what
// bounds it are in attention_common.cuh; this file is the C entry point
// that ops/attention.py loads with ctypes. attention_prev_launch runs the
// previous design (attention_prev.cuh), the parent that chip_smoke.py
// times against; no model calls it.
//
// Constraints, checked here: 1 <= D <= 128, Tq, Tk >= 1, vb in
// {16, 8, 4, 2} (2 for bf16 only), and every row of q, k and v starts at an
// address aligned to vb with the head dim contiguous (the wrapper picks vb
// from the pointers and strides it passes); the plan's rows, chunk and
// splits as attention.cuh's forward checks them.

#include "attention_common.cuh"
#include "attention_prev.cuh"

namespace {

cudaError_t prev_forward(const attn_prev::Problem& p, int dtype,
                         cudaStream_t s) {
  if ((p.Tq + attn_prev::BM - 1) / attn_prev::BM > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid(p.B * p.H, (p.Tq + attn_prev::BM - 1) / attn_prev::BM);
  const int k16 = (p.D + 15) / 16;
  auto go = [&](auto kernel, size_t smem) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    kernel<<<grid, attn_prev::THREADS, smem, s>>>(p);
    return cudaGetLastError();
  };
  using namespace attn_prev;
  switch (dtype * 8 + k16) {
    case 1: return go(attn_f32_kernel<1>, F32Tiles<1>::smem());
    case 2: return go(attn_f32_kernel<2>, F32Tiles<2>::smem());
    case 3: return go(attn_f32_kernel<3>, F32Tiles<3>::smem());
    case 4: return go(attn_f32_kernel<4>, F32Tiles<4>::smem());
    case 5: return go(attn_f32_kernel<5>, F32Tiles<5>::smem());
    case 6: return go(attn_f32_kernel<6>, F32Tiles<6>::smem());
    case 7: return go(attn_f32_kernel<7>, F32Tiles<7>::smem());
    case 8: return go(attn_f32_kernel<8>, F32Tiles<8>::smem());
    case 9: return go(attn_bf16_kernel<1>, Bf16Tiles<1>::smem());
    case 10: return go(attn_bf16_kernel<2>, Bf16Tiles<2>::smem());
    case 11: return go(attn_bf16_kernel<3>, Bf16Tiles<3>::smem());
    case 12: return go(attn_bf16_kernel<4>, Bf16Tiles<4>::smem());
    case 13: return go(attn_bf16_kernel<5>, Bf16Tiles<5>::smem());
    case 14: return go(attn_bf16_kernel<6>, Bf16Tiles<6>::smem());
    case 15: return go(attn_bf16_kernel<7>, Bf16Tiles<7>::smem());
    case 16: return go(attn_bf16_kernel<8>, Bf16Tiles<8>::smem());
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, H, Tq, D), k and v (B, H, Tk, D) and the output o (B, H, Tq, D),
// each given by its (b, h, t) element strides; dtype 0 float32, 1 bf16;
// rows, chunk and splits from ops/attention.py::attention_plan, and with
// splits > 1 the float32 scratch part_o (splits, B * H, Tq, D) and
// part_lse (splits, B * H, Tq).
extern "C" int attention_launch(const void* q, const void* k, const void* v,
                                void* o, int B, int H, int Tq, int Tk, int D,
                                long long sqb, long long sqh, long long sqt,
                                long long skb, long long skh, long long skt,
                                long long svb, long long svh, long long svt,
                                long long sob, long long soh, long long sot,
                                int vb, int dtype, int rows, int chunk,
                                int splits, float* part_o, float* part_lse,
                                void* stream) {
  if (!attn::valid_rows(B, H, Tq, Tk, D, vb, dtype))
    return (int)cudaErrorInvalidValue;
  attn::Problem p{q, k, v, o, B, H, Tq, Tk, D,
                  {sqb, sqh, sqt}, {skb, skh, skt}, {svb, svh, svt},
                  {sob, soh, sot}, vb, (float)pow((double)D, -0.5),
                  nullptr, chunk, splits, part_o, part_lse};
  return (int)attn::forward(p, rows, dtype, static_cast<cudaStream_t>(stream));
}

// attention_launch in the previous design (the parent, for timings): one
// block of 64 query rows per (batch, head), no split
extern "C" int attention_prev_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Tq, int Tk, int D, long long sqb, long long sqh, long long sqt,
    long long skb, long long skh, long long skt, long long svb, long long svh,
    long long svt, long long sob, long long soh, long long sot, int vb,
    int dtype, void* stream) {
  if (!attn::valid_rows(B, H, Tq, Tk, D, vb, dtype))
    return (int)cudaErrorInvalidValue;
  attn_prev::Problem p{q, k, v, o, B, H, Tq, Tk, D,
                       {sqb, sqh, sqt}, {skb, skh, skt}, {svb, svh, svt},
                       {sob, soh, sot}, vb, (float)pow((double)D, -0.5)};
  const cudaError_t e =
      prev_forward(p, dtype, static_cast<cudaStream_t>(stream));
  if (e == cudaSuccess) ++attn::launch_counts[1][attn::K_FWD];
  return (int)e;
}
