// K3: the Swin window-attention half-block, written by hand for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// computervision_codes_tpu/ops/window_mhsa.py::window_mhsa_fused (its
// _kernel and packed_window_attention), float path and int8 branch. Over
// x (B, Hp, Wp, C),
// already rolled by the caller when the block is shifted:
//
//   y = x + proj(window_MHSA(LayerNorm(x)))
//
// with a relative-position bias (H, N, N) and an optional additive shift
// mask (nW, N, N), N = w*w, head_dim 32.
//
// What bounds it on the card: at the SwinL-384 stage-2 shape (B = 16,
// 24x24, C = 768, 24 heads, w = 12) the two projections are 43.5 GFLOP and
// the attention core 4.1 GFLOP against about 33 MB of device traffic, so by
// arithmetic intensity it is tensor-core bound (0.048 ms at 989 TFLOP/s).
// What the design does: the TPU kernel keeps a whole row of windows in VMEM,
// but on Hopper one window's LN tile alone (144 x 768 bf16, 221 KB) nearly
// fills a block's 227 KB of shared memory. So the half-block runs as
// phases on one stream (swin_gemm.cuh): in bf16, LN(x) into the attn
// scratch, then the TMA-fed wgmma QKV GEMM into a qkv scratch (float32: LN
// statistics, then the FMA loop applying LN on load); attention with one
// block per (window, head), each warp holding its 16-query strips' scores
// in registers (window_attn.cuh); the proj GEMM with bias and residual.
// The scratch round trip costs 4 bytes x 4C per token of traffic, well
// under the GEMMs' time. Odd windows (N = 49) are masked at their real
// size; no (w+1)^2 padding. The TPU kernel's head-group packing is an MXU
// device and has no counterpart here.
//
// The int8 branch (window_mhsa_q8_launch; quant=True there): the QKV and
// proj products on the int8 tensor cores (swin_gemm.cuh: a quantize pass
// into a codes scratch, then the s8 wgmma GEMM): LN statistics with one
// absmax per window-row strip (w x Wp tokens); LN(x) quantized, the QKV
// product, + bqkv, rounded; the attention phase unchanged but for each
// window's absmax of its output (with the padded query of an odd window,
// which the TPU's (w+1)^2 geometry computes); the attention output
// quantized with its window's scale, the proj product, then y = x + T(o +
// bproj). Its bound at stage 2: 43.5 G int8
// operations (0.022 ms at 1,979 TOP/s) and the attention core's 4.1 GFLOP
// of bf16 (0.004 ms at 989 TFLOP/s).
//
// K6's attention branch (computervision_codes_tpu/ops/swin_train.py::
// make_attn_branch: the training forward, window_mhsa_fused at
// res_add=False) is the float entry point with res_add = 0: the proj GEMM
// takes the bias-only epilogue, y = T(proj(o) + bproj) with no residual,
// so the module can put DropPath between the branch and the residual. Its
// backward is autograd of the plain version (ops/swin_train.py), as the TPU
// package's is autodiff of its XLA reference. At Swin-L-384's training
// shapes (batch 8, stages 0-2: 73,728, 18,432 and 4,608 tokens) the grid
// holds 3,072, 1,536 and 768 (window, head) blocks of the attention phase
// and up to 576 row tiles of the GEMMs, far inside the grid limits.
//
// The "_loop" entry points run every product on swin_common.cuh's loops
// (WMMA / mma.sync), the parent that chip_smoke.py compares against; no
// main path calls them. window_attn_phase_launch runs the attention phase
// alone on a packed qkv, which chip_smoke.py checks and times; no main path
// calls it either.
//
// Interface: plain C, loaded with ctypes. Launches go on the caller's
// stream, never synchronise and allocate nothing; the return value is the
// first CUDA error of the phases' launches (0 on success).

#include "swin_gemm.cuh"

namespace {

template <typename T, bool LOOP>
int run(const void* x, const void* gamma, const void* beta, const void* wqkv,
        const void* bqkv, const void* wproj, const void* bproj,
        const void* bias, const void* mask, void* qkv, void* attn,
        void* stats, void* y, int B, int Hp, int Wp, int C, int heads,
        int window, float scale, bool res_add, cudaStream_t s) {
  return (int)swin::attention_half<T, LOOP>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const T*>(wqkv),
      static_cast<const T*>(bqkv), static_cast<const T*>(wproj),
      static_cast<const T*>(bproj), static_cast<const T*>(bias),
      static_cast<const T*>(mask), static_cast<T*>(qkv),
      static_cast<T*>(attn), static_cast<float2*>(stats), static_cast<T*>(y),
      B, Hp, Wp, C, heads, window, scale, s, res_add);
}

template <bool LOOP>
int launch(const void* x, const void* gamma, const void* beta,
           const void* wqkv, const void* bqkv, const void* wproj,
           const void* bproj, const void* bias, const void* mask, void* qkv,
           void* attn, void* stats, void* y, int B, int Hp, int Wp, int C,
           int heads, int window, float scale, int res_add, int dtype,
           void* stream) {
  if (!swin::block_shape_ok(B, Hp, Wp, C, heads, window))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float, LOOP>(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                            mask, qkv, attn, stats, y, B, Hp, Wp, C, heads,
                            window, scale, res_add != 0, s);
  if (dtype == 1)
    return run<__nv_bfloat16, LOOP>(x, gamma, beta, wqkv, bqkv, wproj, bproj,
                                    bias, mask, qkv, attn, stats, y, B, Hp,
                                    Wp, C, heads, window, scale, res_add != 0,
                                    s);
  return (int)cudaErrorInvalidValue;
}

template <bool LOOP>
int launch_q8(const void* x, const void* gamma, const void* beta,
              const void* wqkv, const void* sqkv, const void* bqkv,
              const void* wproj, const void* sproj, const void* bproj,
              const void* bias, const void* mask, void* qkv, void* attn,
              void* stats, void* amax, void* codes, void* y, int B, int Hp,
              int Wp, int C, int heads, int window, float scale, int dtype,
              void* stream) {
  if (!swin::block_shape_ok(B, Hp, Wp, C, heads, window, 64))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run_q8 = [&](auto zero) {
    using T = decltype(zero);
    return (int)swin::attention_half_q8<T, LOOP>(
        static_cast<const T*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<const int8_t*>(wqkv),
        static_cast<const float*>(sqkv), static_cast<const T*>(bqkv),
        static_cast<const int8_t*>(wproj), static_cast<const float*>(sproj),
        static_cast<const T*>(bproj), static_cast<const T*>(bias),
        static_cast<const T*>(mask), static_cast<T*>(qkv),
        static_cast<T*>(attn), static_cast<float2*>(stats),
        static_cast<int*>(amax), static_cast<int8_t*>(codes),
        static_cast<T*>(y), B, Hp, Wp, C, heads, window, scale, false, s);
  };
  if (dtype == 0) return run_q8(0.0f);
  if (dtype == 1) return run_q8(__nv_bfloat16());
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x, y (B, Hp, Wp, C); gamma, beta (C,)
// float32; wqkv (C, 3C), bqkv (3C,), wproj (C, C), bproj (C,), bias
// (heads, N, N) and mask (nW, N, N, or null) in dtype. Scratch: qkv
// (B*Hp*Wp, 3C) and attn (B*Hp*Wp, C) in dtype, stats (B*Hp*Wp,) float2.
// res_add: 1 adds the residual x (K3), 0 returns the branch alone (K6).
extern "C" int window_mhsa_launch(const void* x, const void* gamma,
                                  const void* beta, const void* wqkv,
                                  const void* bqkv, const void* wproj,
                                  const void* bproj, const void* bias,
                                  const void* mask, void* qkv, void* attn,
                                  void* stats, void* y, int B, int Hp, int Wp,
                                  int C, int heads, int window, float scale,
                                  int res_add, int dtype, void* stream) {
  return launch<false>(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, mask,
                       qkv, attn, stats, y, B, Hp, Wp, C, heads, window,
                       scale, res_add, dtype, stream);
}

// window_mhsa_launch with every product on the loop of swin_common.cuh
extern "C" int window_mhsa_loop_launch(
    const void* x, const void* gamma, const void* beta, const void* wqkv,
    const void* bqkv, const void* wproj, const void* bproj, const void* bias,
    const void* mask, void* qkv, void* attn, void* stats, void* y, int B,
    int Hp, int Wp, int C, int heads, int window, float scale, int res_add,
    int dtype, void* stream) {
  return launch<true>(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, mask,
                      qkv, attn, stats, y, B, Hp, Wp, C, heads, window, scale,
                      res_add, dtype, stream);
}

// The int8 branch. As window_mhsa_launch, but wqkv (3C, C) and wproj (C, C)
// int8 codes, one output channel per row, with float32 scales sqkv (3C,)
// and sproj (C,); amax scratch of B * Hp / window + B * nW int32 and codes
// scratch of B*Hp*Wp x C int8.
extern "C" int window_mhsa_q8_launch(
    const void* x, const void* gamma, const void* beta, const void* wqkv,
    const void* sqkv, const void* bqkv, const void* wproj, const void* sproj,
    const void* bproj, const void* bias, const void* mask, void* qkv,
    void* attn, void* stats, void* amax, void* codes, void* y, int B, int Hp,
    int Wp, int C, int heads, int window, float scale, int dtype,
    void* stream) {
  return launch_q8<false>(x, gamma, beta, wqkv, sqkv, bqkv, wproj, sproj,
                          bproj, bias, mask, qkv, attn, stats, amax, codes, y,
                          B, Hp, Wp, C, heads, window, scale, dtype, stream);
}

// window_mhsa_q8_launch with both products on the mma.sync loop
extern "C" int window_mhsa_q8_loop_launch(
    const void* x, const void* gamma, const void* beta, const void* wqkv,
    const void* sqkv, const void* bqkv, const void* wproj, const void* sproj,
    const void* bproj, const void* bias, const void* mask, void* qkv,
    void* attn, void* stats, void* amax, void* codes, void* y, int B, int Hp,
    int Wp, int C, int heads, int window, float scale, int dtype,
    void* stream) {
  return launch_q8<true>(x, gamma, beta, wqkv, sqkv, bqkv, wproj, sproj,
                         bproj, bias, mask, qkv, attn, stats, amax, codes, y,
                         B, Hp, Wp, C, heads, window, scale, dtype, stream);
}

// The attention phase alone: qkv (B*Hp*Wp, 3C) as the QKV product writes it
// -> out (B*Hp*Wp, C), in dtype; bias (heads, N, N) and mask (nW, N, N, or
// null) in dtype; wamax (B * nW int32, or null) receives each window's
// max |out| as float bits (zeroed here first), with the padded query of an
// odd window.
extern "C" int window_attn_phase_launch(const void* qkv, const void* bias,
                                        const void* mask, void* out,
                                        void* wamax, int B, int Hp, int Wp,
                                        int C, int heads, int window,
                                        float scale, int dtype,
                                        void* stream) {
  if (!swin::block_shape_ok(B, Hp, Wp, C, heads, window))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* amax = static_cast<int*>(wamax);
  if (amax) {
    const cudaError_t err = cudaMemsetAsync(
        amax, 0, sizeof(int) * B * (Hp / window) * (Wp / window), s);
    if (err != cudaSuccess) return (int)err;
  }
  auto run = [&](auto zero) {
    using T = decltype(zero);
    const T* q = static_cast<const T*>(qkv);
    const T* b = static_cast<const T*>(bias);
    const T* m = static_cast<const T*>(mask);
    T* o = static_cast<T*>(out);
    return (int)swin::window_attention(q, b, m, o, B, Hp, Wp, C, heads,
                                       window, scale, s, amax);
  };
  if (dtype == 0) return run(0.0f);
  if (dtype == 1) return run(__nv_bfloat16());
  return (int)cudaErrorInvalidValue;
}
