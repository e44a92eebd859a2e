// K4: the transformer MLP half-block, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// computervision_codes_tpu/ops/mlp_block.py::mlp_block_fused (its _kernel),
// float path and int8 branch. Over x (M tokens, C):
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
// The int8 branch (mlp_block_q8_launch; quant=True there, one hidden chunk):
// both products on the int8 tensor cores (swin_common.cuh gemm_q8_kernel),
// one activation absmax per block of blk tokens for each product: LN
// statistics with the normed rows' block absmax; GEMM1 with LN and the
// quantizer on load, then bias and the A-S GELU into a float32 h scratch
// (the TPU kernel keeps h in float32 too; 113 MB at the stage-2 shape) with
// h's block absmax; GEMM2 quantizing h on load, then y = x + T(o + b2). Its
// bound: 4 M C hidden int8 operations, 0.044 ms at stage 2 at 1,979
// TOP/s, against x, y and the int8 weights (about 21 MB, 0.006 ms).
//
// K6's MLP branch (computervision_codes_tpu/ops/swin_train.py::
// make_mlp_branch: mlp_block_fused at res_add=False) is the float entry
// point with res_add = 0: GEMM2 takes the bias-only epilogue, y = T(W2 h +
// b2) rounded once from the float32 sum, which is what the TPU kernel's
// float32 accumulator holds at res_add=False; its backward is autograd of
// the plain version (ops/swin_train.py).
//
// Interface: plain C, loaded with ctypes. Launches go on the caller's
// stream, never synchronise and allocate nothing; the return value is the
// first CUDA error of the phases' launches (0 on success).

#include "swin_common.cuh"

namespace {

template <typename T, int EPI>
int run_epi(const void* x, const void* gamma, const void* beta,
            const void* w1, const void* b1, const void* w2, const void* b2,
            void* h, void* stats, void* y, int M, int C, int hidden,
            cudaStream_t s) {
  return (int)swin::mlp_half<T, EPI>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(h),
      static_cast<float2*>(stats), static_cast<T*>(y), M, C, hidden, s);
}

template <typename T>
int run(const void* x, const void* gamma, const void* beta, const void* w1,
        const void* b1, const void* w2, const void* b2, void* h, void* stats,
        void* y, int M, int C, int hidden, bool res_add, cudaStream_t s) {
  return res_add ? run_epi<T, swin::EPI_RES_F32>(x, gamma, beta, w1, b1, w2,
                                                 b2, h, stats, y, M, C,
                                                 hidden, s)
                 : run_epi<T, swin::EPI_BIAS>(x, gamma, beta, w1, b1, w2, b2,
                                              h, stats, y, M, C, hidden, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x, y (M, C); gamma, beta (C,) float32;
// w1 (C, hidden), b1 (hidden,), w2 (hidden, C), b2 (C,) in dtype. Scratch:
// h (M, hidden) in dtype, stats (M,) float2. res_add: 1 adds the residual
// x (K4), 0 returns the branch alone (K6).
extern "C" int mlp_block_launch(const void* x, const void* gamma,
                                const void* beta, const void* w1,
                                const void* b1, const void* w2,
                                const void* b2, void* h, void* stats, void* y,
                                int M, int C, int hidden, int res_add,
                                int dtype, void* stream) {
  if (M <= 0 || C <= 0 || C % 64 || hidden <= 0 || hidden % 64)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(x, gamma, beta, w1, b1, w2, b2, h, stats, y, M, C,
                      hidden, res_add != 0, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, gamma, beta, w1, b1, w2, b2, h, stats, y, M,
                              C, hidden, res_add != 0, s);
  return (int)cudaErrorInvalidValue;
}

// The int8 branch. x, y (M, C) in dtype; gamma, beta (C,) float32; w1
// (hidden, C) and w2 (C, hidden) int8 codes, one output channel per row;
// s1 (hidden,), s2 (C,) float32 weight scales; b1, b2 in dtype; blk the
// token block of the activation scales. Scratch: h (M, hidden) float32,
// stats (M,) float2, amax (2 * ceil(M / blk)) int32.
extern "C" int mlp_block_q8_launch(const void* x, const void* gamma,
                                   const void* beta, const void* w1,
                                   const void* s1, const void* b1,
                                   const void* w2, const void* s2,
                                   const void* b2, void* h, void* stats,
                                   void* amax, void* y, int M, int C,
                                   int hidden, int blk, int dtype,
                                   void* stream) {
  if (M <= 0 || C <= 0 || C % 64 || hidden <= 0 || hidden % 64 || blk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run_q8 = [&](auto zero) {
    using T = decltype(zero);
    return (int)swin::mlp_half_q8<T>(
        static_cast<const T*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<const int8_t*>(w1),
        static_cast<const float*>(s1), static_cast<const T*>(b1),
        static_cast<const int8_t*>(w2), static_cast<const float*>(s2),
        static_cast<const T*>(b2), static_cast<float*>(h),
        static_cast<float2*>(stats), static_cast<int*>(amax),
        static_cast<T*>(y), M, C, hidden, blk, false, s);
  };
  if (dtype == 0) return run_q8(0.0f);
  if (dtype == 1) return run_q8(__nv_bfloat16());
  return (int)cudaErrorInvalidValue;
}
