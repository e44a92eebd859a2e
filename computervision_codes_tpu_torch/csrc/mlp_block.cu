// K4: the transformer MLP half-block, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// computervision_codes_tpu/ops/mlp_block.py::mlp_block_fused (its _kernel),
// float path. Over x (M tokens, C):
//
//   y = x + W2 gelu_erf(W1 LayerNorm(x) + b1) + b2
//
// LN in float32, the GELU output rounded to x's dtype before the second
// product, and the second product, its bias and the residual summed in
// float32 and rounded once, as the TPU kernel's hidden-chunked path does.
//
// What bounds it on the card: 4 M C hidden FLOP (87 GFLOP at the SwinL-384
// stage-2 shape, 9216 x 768, hidden 3072) against about 38 MB of device
// traffic: tensor-core bound, 0.088 ms at 989 TFLOP/s. What the design
// does: the TPU kernel carries the output row across hidden chunks in VMEM
// scratch from one grid step to the next, which blocks on Hopper cannot do.
// So the half-block runs as three phases on one stream (swin_common.cuh):
// LN statistics; the LN-on-load GEMM1 + bias + GELU into a hidden scratch
// in x's dtype (the TPU kernel rounds h to that dtype too); GEMM2 + bias +
// residual. The hidden scratch costs 4 M hidden bytes of bf16 traffic
// (0.07 ms at stage 2), the price of not keeping h on chip; a kernel that
// keeps it (one block per token tile looping over hidden chunks) is later
// work.
//
// Interface: plain C, loaded with ctypes. Launches go on the caller's
// stream, never synchronise and allocate nothing; the return value is the
// first CUDA error of the phases' launches (0 on success).

#include "swin_common.cuh"

namespace {

template <typename T>
int run(const void* x, const void* gamma, const void* beta, const void* w1,
        const void* b1, const void* w2, const void* b2, void* h, void* stats,
        void* y, int M, int C, int hidden, cudaStream_t s) {
  return (int)swin::mlp_half<T>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(h),
      static_cast<float2*>(stats), static_cast<T*>(y), M, C, hidden, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x, y (M, C); gamma, beta (C,) float32;
// w1 (C, hidden), b1 (hidden,), w2 (hidden, C), b2 (C,) in dtype. Scratch:
// h (M, hidden) in dtype, stats (M,) float2.
extern "C" int mlp_block_launch(const void* x, const void* gamma,
                                const void* beta, const void* w1,
                                const void* b1, const void* w2,
                                const void* b2, void* h, void* stats, void* y,
                                int M, int C, int hidden, int dtype,
                                void* stream) {
  if (M <= 0 || C <= 0 || C % 64 || hidden <= 0 || hidden % 64)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(x, gamma, beta, w1, b1, w2, b2, h, stats, y, M, C,
                      hidden, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, gamma, beta, w1, b1, w2, b2, h, stats, y, M,
                              C, hidden, s);
  return (int)cudaErrorInvalidValue;
}
