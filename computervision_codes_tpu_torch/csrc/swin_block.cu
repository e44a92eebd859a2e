// K5: a whole Swin block (attention half, then MLP half), written by hand
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// computervision_codes_tpu/ops/swin_block.py::swin_block_fused (its
// _kernel), float path and int8 branch. Over x (B, Hp, Wp, C), rolled by
// the caller when the block is shifted:
//
//   y = x + proj(window_MHSA(LN1(x)));  out = y + T(W2 gelu(W1 LN2(y) + b1)
//                                                   + b2)
//
// with the merged TPU kernel's own rounding (swin_block.py:121-124 there,
// one hidden chunk as at every native width): W2 h + b2 is rounded to T
// before y is added, where K4 sums them in float32 and rounds once.
//
// What bounds it on the card: at the SwinL-384 stage-0 shape (B = 16,
// 96x96, C = 192, 6 heads, w = 12) 147 GFLOP against about 0.2 GB of
// device traffic: tensor-core bound, 0.148 ms at 989 TFLOP/s. What the
// design does, for now: the TPU kernel keeps y in VMEM between the halves,
// but at C = 384 a window's y (110 KB) and its float32 MLP accumulator
// (221 KB) do not fit together in a block's 227 KB of shared memory. So
// this entry point runs K3's device phases and then K4's on one stream
// (swin_gemm.cuh: in bf16 each product a LayerNorm pass or none, then the
// TMA-fed wgmma GEMM), with y in a device scratch: one call from the host
// and y's round trip through device memory (2 x 9.4 MB at stage 1). It computes the chain of K3 and K4 but for that last rounding.
// A block that keeps y on chip is later work; whether it pays is measured
// against this one.
//
// The int8 branch (swin_block_q8_launch; quant=True there) runs K3's and
// K4's int8 phases with the merged kernel's scales: LN1(x) and LN2(y)
// rounded to T before they are quantized, and one activation scale per
// window-row strip (w x Wp tokens) for the QKV product and both MLP
// products. The TPU kernel's per-chunk MLP scales would differ only if its
// VMEM model (swin_block.py:155-163) chose a hidden chunk below the hidden
// width; at the native Swin sizes it does not (about 7 MB at stage 0 and
// 10 MB at stage 1 against its 13 MB), so no chunk loop is ported.
//
// The "_loop" entry points run every product on swin_common.cuh's loops
// (WMMA / mma.sync), the parent that chip_smoke.py compares against; no
// main path calls them.
//
// Interface: plain C, loaded with ctypes. Launches go on the caller's
// stream, never synchronise and allocate nothing; the return value is the
// first CUDA error of the phases' launches (0 on success).

#include "swin_gemm.cuh"

namespace {

// attn holds LN1(x) for the QKV product, the attention output, then LN2(y)
// for GEMM1 (the proj product has read it by then)
template <typename T, bool LOOP>
int run(const void* x, const void* g1, const void* be1, const void* wqkv,
        const void* bqkv, const void* wproj, const void* bproj,
        const void* bias, const void* mask, const void* g2, const void* be2,
        const void* w1, const void* b1, const void* w2, const void* b2,
        void* qkv, void* attn, void* ybuf, void* h, void* stats, void* out,
        int B, int Hp, int Wp, int C, int heads, int window, int hidden,
        float scale, cudaStream_t s) {
  cudaError_t err = swin::attention_half<T, LOOP>(
      static_cast<const T*>(x), static_cast<const float*>(g1),
      static_cast<const float*>(be1), static_cast<const T*>(wqkv),
      static_cast<const T*>(bqkv), static_cast<const T*>(wproj),
      static_cast<const T*>(bproj), static_cast<const T*>(bias),
      static_cast<const T*>(mask), static_cast<T*>(qkv),
      static_cast<T*>(attn), static_cast<float2*>(stats),
      static_cast<T*>(ybuf), B, Hp, Wp, C, heads, window, scale, s);
  if (err != cudaSuccess) return (int)err;
  return (int)swin::mlp_half<T, swin::EPI_ROUND_RES, LOOP>(
      static_cast<const T*>(ybuf), static_cast<const float*>(g2),
      static_cast<const float*>(be2), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(h),
      static_cast<float2*>(stats), static_cast<T*>(attn),
      static_cast<T*>(out), B * Hp * Wp, C, hidden, s);
}

template <bool LOOP>
int launch(const void* x, const void* g1, const void* be1, const void* wqkv,
           const void* bqkv, const void* wproj, const void* bproj,
           const void* bias, const void* mask, const void* g2,
           const void* be2, const void* w1, const void* b1, const void* w2,
           const void* b2, void* qkv, void* attn, void* ybuf, void* h,
           void* stats, void* out, int B, int Hp, int Wp, int C, int heads,
           int window, int hidden, float scale, int dtype, void* stream) {
  if (!swin::block_shape_ok(B, Hp, Wp, C, heads, window) || hidden <= 0 ||
      hidden % 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float, LOOP>(x, g1, be1, wqkv, bqkv, wproj, bproj, bias, mask,
                            g2, be2, w1, b1, w2, b2, qkv, attn, ybuf, h,
                            stats, out, B, Hp, Wp, C, heads, window, hidden,
                            scale, s);
  if (dtype == 1)
    return run<__nv_bfloat16, LOOP>(x, g1, be1, wqkv, bqkv, wproj, bproj,
                                    bias, mask, g2, be2, w1, b1, w2, b2, qkv,
                                    attn, ybuf, h, stats, out, B, Hp, Wp, C,
                                    heads, window, hidden, scale, s);
  return (int)cudaErrorInvalidValue;
}

template <bool LOOP>
int launch_q8(const void* x, const void* g1, const void* be1,
              const void* wqkv, const void* sqkv, const void* bqkv,
              const void* wproj, const void* sproj, const void* bproj,
              const void* bias, const void* mask, const void* g2,
              const void* be2, const void* w1, const void* s1,
              const void* b1, const void* w2, const void* s2, const void* b2,
              void* qkv, void* attn, void* ybuf, void* h, void* stats,
              void* amax, void* codes, void* out, int B, int Hp, int Wp,
              int C, int heads, int window, int hidden, float scale,
              int dtype, void* stream) {
  if (!swin::block_shape_ok(B, Hp, Wp, C, heads, window, 64) ||
      hidden <= 0 || hidden % 64)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int strips = B * (Hp / window);
  auto run_q8 = [&](auto zero) {
    using T = decltype(zero);
    cudaError_t err = swin::attention_half_q8<T, LOOP>(
        static_cast<const T*>(x), static_cast<const float*>(g1),
        static_cast<const float*>(be1), static_cast<const int8_t*>(wqkv),
        static_cast<const float*>(sqkv), static_cast<const T*>(bqkv),
        static_cast<const int8_t*>(wproj), static_cast<const float*>(sproj),
        static_cast<const T*>(bproj), static_cast<const T*>(bias),
        static_cast<const T*>(mask), static_cast<T*>(qkv),
        static_cast<T*>(attn), static_cast<float2*>(stats),
        static_cast<int*>(amax), static_cast<int8_t*>(codes),
        static_cast<T*>(ybuf), B, Hp, Wp, C, heads, window, scale, true, s);
    if (err != cudaSuccess) return (int)err;
    // the MLP's two block absmaxes follow the attention half's
    return (int)swin::mlp_half_q8<T, LOOP>(
        static_cast<const T*>(ybuf), static_cast<const float*>(g2),
        static_cast<const float*>(be2), static_cast<const int8_t*>(w1),
        static_cast<const float*>(s1), static_cast<const T*>(b1),
        static_cast<const int8_t*>(w2), static_cast<const float*>(s2),
        static_cast<const T*>(b2), static_cast<float*>(h),
        static_cast<float2*>(stats),
        static_cast<int*>(amax) + strips * (1 + Wp / window),
        static_cast<int8_t*>(codes), static_cast<T*>(out), B * Hp * Wp, C,
        hidden, window * Wp, true, s);
  };
  if (dtype == 0) return run_q8(0.0f);
  if (dtype == 1) return run_q8(__nv_bfloat16());
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x, out (B, Hp, Wp, C); g1, be1, g2, be2
// (C,) float32; wqkv (C, 3C), bqkv (3C,), wproj (C, C), bproj (C,), bias
// (heads, N, N), mask (nW, N, N, or null), w1 (C, hidden), b1 (hidden,),
// w2 (hidden, C), b2 (C,) in dtype. Scratch, M = B*Hp*Wp: qkv (M, 3C),
// attn and ybuf (M, C), h (M, hidden) in dtype, stats (M,) float2.
extern "C" int swin_block_launch(
    const void* x, const void* g1, const void* be1, const void* wqkv,
    const void* bqkv, const void* wproj, const void* bproj, const void* bias,
    const void* mask, const void* g2, const void* be2, const void* w1,
    const void* b1, const void* w2, const void* b2, void* qkv, void* attn,
    void* ybuf, void* h, void* stats, void* out, int B, int Hp, int Wp, int C,
    int heads, int window, int hidden, float scale, int dtype, void* stream) {
  return launch<false>(x, g1, be1, wqkv, bqkv, wproj, bproj, bias, mask, g2,
                       be2, w1, b1, w2, b2, qkv, attn, ybuf, h, stats, out, B,
                       Hp, Wp, C, heads, window, hidden, scale, dtype, stream);
}

// swin_block_launch with every product on the loop of swin_common.cuh
extern "C" int swin_block_loop_launch(
    const void* x, const void* g1, const void* be1, const void* wqkv,
    const void* bqkv, const void* wproj, const void* bproj, const void* bias,
    const void* mask, const void* g2, const void* be2, const void* w1,
    const void* b1, const void* w2, const void* b2, void* qkv, void* attn,
    void* ybuf, void* h, void* stats, void* out, int B, int Hp, int Wp, int C,
    int heads, int window, int hidden, float scale, int dtype, void* stream) {
  return launch<true>(x, g1, be1, wqkv, bqkv, wproj, bproj, bias, mask, g2,
                      be2, w1, b1, w2, b2, qkv, attn, ybuf, h, stats, out, B,
                      Hp, Wp, C, heads, window, hidden, scale, dtype, stream);
}

// The int8 branch. As swin_block_launch, but wqkv (3C, C), wproj (C, C), w1
// (hidden, C) and w2 (C, hidden) int8 codes, one output channel per row,
// with float32 scales sqkv, sproj, s1, s2; h (M, hidden) float32; amax
// scratch of B * Hp / window * (3 + Wp / window) int32; codes scratch of
// M x max(C, hidden) int8.
extern "C" int swin_block_q8_launch(
    const void* x, const void* g1, const void* be1, const void* wqkv,
    const void* sqkv, const void* bqkv, const void* wproj, const void* sproj,
    const void* bproj, const void* bias, const void* mask, const void* g2,
    const void* be2, const void* w1, const void* s1, const void* b1,
    const void* w2, const void* s2, const void* b2, void* qkv, void* attn,
    void* ybuf, void* h, void* stats, void* amax, void* codes, void* out,
    int B, int Hp, int Wp, int C, int heads, int window, int hidden,
    float scale, int dtype, void* stream) {
  return launch_q8<false>(x, g1, be1, wqkv, sqkv, bqkv, wproj, sproj, bproj,
                          bias, mask, g2, be2, w1, s1, b1, w2, s2, b2, qkv,
                          attn, ybuf, h, stats, amax, codes, out, B, Hp, Wp,
                          C, heads, window, hidden, scale, dtype, stream);
}

// swin_block_q8_launch with every product on the mma.sync loop
extern "C" int swin_block_q8_loop_launch(
    const void* x, const void* g1, const void* be1, const void* wqkv,
    const void* sqkv, const void* bqkv, const void* wproj, const void* sproj,
    const void* bproj, const void* bias, const void* mask, const void* g2,
    const void* be2, const void* w1, const void* s1, const void* b1,
    const void* w2, const void* s2, const void* b2, void* qkv, void* attn,
    void* ybuf, void* h, void* stats, void* amax, void* codes, void* out,
    int B, int Hp, int Wp, int C, int heads, int window, int hidden,
    float scale, int dtype, void* stream) {
  return launch_q8<true>(x, g1, be1, wqkv, sqkv, bqkv, wproj, sproj, bproj,
                         bias, mask, g2, be2, w1, s1, b1, w2, s2, b2, qkv,
                         attn, ybuf, h, stats, amax, codes, out, B, Hp, Wp, C,
                         heads, window, hidden, scale, dtype, stream);
}
