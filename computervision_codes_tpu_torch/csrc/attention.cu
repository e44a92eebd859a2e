// K7: full multi-head attention over (B, H, T, D), written by hand for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// computervision_codes_tpu/ops/attention.py::attention_pallas (its
// _attn_kernel), which MS-TCT reaches through multi_head_attention in each
// of its 8 global relational blocks. The design, the numerics and what
// bounds it are in attention_common.cuh; this file is the C entry point
// that ops/attention.py loads with ctypes.
//
// Constraints, checked here: 1 <= D <= 128, Tq, Tk >= 1, at most 65,535
// query tiles of 64 (grid.y), vb in {16, 8, 4, 2} (2 for bf16 only), and
// every row of q, k and v starts at an address aligned to vb with the head
// dim contiguous (the wrapper picks vb from the pointers and strides it
// passes).

#include "attention_common.cuh"

namespace {

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, const attn::Problem& p,
                   cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(p.B * p.H, (p.Tq + attn::BM - 1) / attn::BM);
  kernel<<<grid, attn::THREADS, smem, s>>>(p);
  return cudaGetLastError();
}

template <int DK>
cudaError_t run_bf16(const attn::Problem& p, cudaStream_t s) {
  return launch(attn::attn_bf16_kernel<DK>, attn::Bf16Tiles<DK>::smem(), p,
                s);
}

template <int NJ>
cudaError_t run_f32(const attn::Problem& p, cudaStream_t s) {
  return launch(attn::attn_f32_kernel<NJ>, attn::F32Tiles<NJ>::smem(), p, s);
}

cudaError_t dispatch_bf16(int k16, const attn::Problem& p, cudaStream_t s) {
  switch (k16) {
    case 1: return run_bf16<1>(p, s);
    case 2: return run_bf16<2>(p, s);
    case 3: return run_bf16<3>(p, s);
    case 4: return run_bf16<4>(p, s);
    case 5: return run_bf16<5>(p, s);
    case 6: return run_bf16<6>(p, s);
    case 7: return run_bf16<7>(p, s);
    case 8: return run_bf16<8>(p, s);
  }
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_f32(int k16, const attn::Problem& p, cudaStream_t s) {
  switch (k16) {
    case 1: return run_f32<1>(p, s);
    case 2: return run_f32<2>(p, s);
    case 3: return run_f32<3>(p, s);
    case 4: return run_f32<4>(p, s);
    case 5: return run_f32<5>(p, s);
    case 6: return run_f32<6>(p, s);
    case 7: return run_f32<7>(p, s);
    case 8: return run_f32<8>(p, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, H, Tq, D), k and v (B, H, Tk, D) and the output o (B, H, Tq, D),
// each given by its (b, h, t) element strides; dtype 0 float32, 1 bf16.
extern "C" int attention_launch(const void* q, const void* k, const void* v,
                                void* o, int B, int H, int Tq, int Tk, int D,
                                long long sqb, long long sqh, long long sqt,
                                long long skb, long long skh, long long skt,
                                long long svb, long long svh, long long svt,
                                long long sob, long long soh, long long sot,
                                int vb, int dtype, void* stream) {
  const int es = dtype == 1 ? 2 : 4;
  if (D < 1 || D > attn::D_MAX || Tq < 1 || Tk < 1 || B < 1 || H < 1 ||
      (long long)B * H > 0x7fffffffLL ||
      (Tq + attn::BM - 1) / attn::BM > 65535 || (dtype != 0 && dtype != 1) ||
      !(vb == 16 || vb == 8 || vb == 4 || (vb == 2 && dtype == 1)) ||
      D % (vb / es) != 0)
    return (int)cudaErrorInvalidValue;
  attn::Problem p{q, k, v, o, B, H, Tq, Tk, D,
                  {sqb, sqh, sqt}, {skb, skh, skt}, {svb, svh, svt},
                  {sob, soh, sot}, vb, (float)pow((double)D, -0.5)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k16 = (D + 15) / 16;
  return (int)(dtype == 1 ? dispatch_bf16(k16, p, s)
                          : dispatch_f32(k16, p, s));
}
