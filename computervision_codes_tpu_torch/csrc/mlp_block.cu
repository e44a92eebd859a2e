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
// So the half-block runs as phases on one stream (swin_gemm.cuh): in bf16,
// LN(x) into a normed scratch, then the TMA-fed wgmma GEMM1 + bias + GELU
// into a hidden scratch in x's dtype (the TPU kernel rounds h to that dtype
// too), then GEMM2 + bias + residual (float32: LN statistics and the FMA
// loop applying LN on load). The hidden scratch costs 4 M hidden bytes of
// bf16 traffic (0.07 ms at stage 2), the price of not keeping h on chip; a
// kernel that keeps it (one block per token tile looping over hidden
// chunks) is later work.
//
// The int8 branch (mlp_block_q8_launch; quant=True there, one hidden chunk):
// both products on the int8 tensor cores (swin_gemm.cuh: a quantize pass
// into a codes scratch, then the s8 wgmma GEMM), one activation absmax per
// block of blk tokens for each product: LN statistics with the normed rows'
// block absmax; LN(x) quantized, GEMM1, then bias and the A-S GELU into a
// float32 h scratch (the TPU kernel keeps h in float32 too; 113 MB at the
// stage-2 shape) with h's block absmax; h quantized (read once), GEMM2,
// then y = x + T(o + b2). Its bound: 4 M C hidden int8 operations, 0.044
// ms at stage 2 at 1,979 TOP/s, against x, y and the int8 weights (about
// 21 MB, 0.006 ms).
//
// K6's MLP branch (computervision_codes_tpu/ops/swin_train.py::
// make_mlp_branch: mlp_block_fused at res_add=False) is the float entry
// point with res_add = 0: GEMM2 takes the bias-only epilogue, y = T(W2 h +
// b2) rounded once from the float32 sum, which is what the TPU kernel's
// float32 accumulator holds at res_add=False; its backward is autograd of
// the plain version (ops/swin_train.py).
//
// The "_loop" entry points run both products on swin_common.cuh's loops
// (WMMA / mma.sync), the parent that chip_smoke.py compares against; no
// main path calls them.
//
// Interface: plain C, loaded with ctypes. Launches go on the caller's
// stream, never synchronise and allocate nothing; the return value is the
// first CUDA error of the phases' launches (0 on success).

#include "swin_gemm.cuh"

namespace {

template <typename T, int EPI, bool LOOP>
int run_epi(const void* x, const void* gamma, const void* beta,
            const void* w1, const void* b1, const void* w2, const void* b2,
            void* h, void* stats, void* normed, void* y, int M, int C,
            int hidden, cudaStream_t s) {
  return (int)swin::mlp_half<T, EPI, LOOP>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(h),
      static_cast<float2*>(stats), static_cast<T*>(normed),
      static_cast<T*>(y), M, C, hidden, s);
}

template <typename T, bool LOOP>
int run(const void* x, const void* gamma, const void* beta, const void* w1,
        const void* b1, const void* w2, const void* b2, void* h, void* stats,
        void* normed, void* y, int M, int C, int hidden, bool res_add,
        cudaStream_t s) {
  return res_add
             ? run_epi<T, swin::EPI_RES_F32, LOOP>(x, gamma, beta, w1, b1, w2,
                                                   b2, h, stats, normed, y, M,
                                                   C, hidden, s)
             : run_epi<T, swin::EPI_BIAS, LOOP>(x, gamma, beta, w1, b1, w2,
                                                b2, h, stats, normed, y, M, C,
                                                hidden, s);
}

template <bool LOOP>
int launch(const void* x, const void* gamma, const void* beta, const void* w1,
           const void* b1, const void* w2, const void* b2, void* h,
           void* stats, void* normed, void* y, int M, int C, int hidden,
           int res_add, int dtype, void* stream) {
  if (M <= 0 || C <= 0 || C % 64 || hidden <= 0 || hidden % 64)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float, LOOP>(x, gamma, beta, w1, b1, w2, b2, h, stats, normed,
                            y, M, C, hidden, res_add != 0, s);
  if (dtype == 1)
    return run<__nv_bfloat16, LOOP>(x, gamma, beta, w1, b1, w2, b2, h, stats,
                                    normed, y, M, C, hidden, res_add != 0, s);
  return (int)cudaErrorInvalidValue;
}

template <bool LOOP>
int launch_q8(const void* x, const void* gamma, const void* beta,
              const void* w1, const void* s1, const void* b1, const void* w2,
              const void* s2, const void* b2, void* h, void* stats,
              void* amax, void* codes, void* y, int M, int C, int hidden,
              int blk, int dtype, void* stream) {
  if (M <= 0 || C <= 0 || C % 64 || hidden <= 0 || hidden % 64 || blk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run_q8 = [&](auto zero) {
    using T = decltype(zero);
    return (int)swin::mlp_half_q8<T, LOOP>(
        static_cast<const T*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<const int8_t*>(w1),
        static_cast<const float*>(s1), static_cast<const T*>(b1),
        static_cast<const int8_t*>(w2), static_cast<const float*>(s2),
        static_cast<const T*>(b2), static_cast<float*>(h),
        static_cast<float2*>(stats), static_cast<int*>(amax),
        static_cast<int8_t*>(codes), static_cast<T*>(y), M, C, hidden, blk,
        false, s);
  };
  if (dtype == 0) return run_q8(0.0f);
  if (dtype == 1) return run_q8(__nv_bfloat16());
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x, y (M, C); gamma, beta (C,) float32;
// w1 (C, hidden), b1 (hidden,), w2 (hidden, C), b2 (C,) in dtype. Scratch:
// h (M, hidden) in dtype, stats (M,) float2, normed (M, C) in dtype (LN(x)
// for the wgmma path; bf16 only, may be null for float32). res_add: 1 adds
// the residual x (K4), 0 returns the branch alone (K6).
extern "C" int mlp_block_launch(const void* x, const void* gamma,
                                const void* beta, const void* w1,
                                const void* b1, const void* w2,
                                const void* b2, void* h, void* stats,
                                void* normed, void* y, int M, int C,
                                int hidden, int res_add, int dtype,
                                void* stream) {
  return launch<false>(x, gamma, beta, w1, b1, w2, b2, h, stats, normed, y,
                       M, C, hidden, res_add, dtype, stream);
}

// mlp_block_launch with both products on the loop of swin_common.cuh
extern "C" int mlp_block_loop_launch(const void* x, const void* gamma,
                                     const void* beta, const void* w1,
                                     const void* b1, const void* w2,
                                     const void* b2, void* h, void* stats,
                                     void* normed, void* y, int M, int C,
                                     int hidden, int res_add, int dtype,
                                     void* stream) {
  return launch<true>(x, gamma, beta, w1, b1, w2, b2, h, stats, normed, y, M,
                      C, hidden, res_add, dtype, stream);
}

// The int8 branch. x, y (M, C) in dtype; gamma, beta (C,) float32; w1
// (hidden, C) and w2 (C, hidden) int8 codes, one output channel per row;
// s1 (hidden,), s2 (C,) float32 weight scales; b1, b2 in dtype; blk the
// token block of the activation scales. Scratch: h (M, hidden) float32,
// stats (M,) float2, amax (2 * ceil(M / blk)) int32, codes (M, max(C,
// hidden)) int8.
extern "C" int mlp_block_q8_launch(const void* x, const void* gamma,
                                   const void* beta, const void* w1,
                                   const void* s1, const void* b1,
                                   const void* w2, const void* s2,
                                   const void* b2, void* h, void* stats,
                                   void* amax, void* codes, void* y, int M,
                                   int C, int hidden, int blk, int dtype,
                                   void* stream) {
  return launch_q8<false>(x, gamma, beta, w1, s1, b1, w2, s2, b2, h, stats,
                          amax, codes, y, M, C, hidden, blk, dtype, stream);
}

// mlp_block_q8_launch with both products on the mma.sync loop
extern "C" int mlp_block_q8_loop_launch(const void* x, const void* gamma,
                                        const void* beta, const void* w1,
                                        const void* s1, const void* b1,
                                        const void* w2, const void* s2,
                                        const void* b2, void* h, void* stats,
                                        void* amax, void* codes, void* y,
                                        int M, int C, int hidden, int blk,
                                        int dtype, void* stream) {
  return launch_q8<true>(x, gamma, beta, w1, s1, b1, w2, s2, b2, h, stats,
                         amax, codes, y, M, C, hidden, blk, dtype, stream);
}
