// K5: a whole Swin block (attention half, then MLP half), written by hand
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// computervision_codes_tpu/ops/swin_block.py::swin_block_fused (its
// _kernel), float path. Over x (B, Hp, Wp, C), rolled by the caller when
// the block is shifted:
//
//   y = x + proj(window_MHSA(LN1(x)));  out = y + W2 gelu(W1 LN2(y) + b1) + b2
//
// What bounds it on the card: at the SwinL-384 stage-0 shape (B = 16,
// 96x96, C = 192, 6 heads, w = 12) 147 GFLOP against about 0.2 GB of
// device traffic: tensor-core bound, 0.148 ms at 989 TFLOP/s. What the
// design does, for now: the TPU kernel keeps y in VMEM between the halves,
// but at C = 384 a window's y (110 KB) and its float32 MLP accumulator
// (221 KB) do not fit together in a block's 227 KB of shared memory. So
// this entry point runs K3's device phases and then K4's on one stream
// (swin_common.cuh), with y in a device scratch: one call from the host,
// seven launches, and y's round trip through device memory (2 x 9.4 MB at
// stage 1). It computes exactly the chain of K3 and K4. A block that keeps
// y on chip is later work; whether it pays is measured against this one.
//
// Interface: plain C, loaded with ctypes. Launches go on the caller's
// stream, never synchronise and allocate nothing; the return value is the
// first CUDA error of the phases' launches (0 on success).

#include "swin_common.cuh"

namespace {

template <typename T>
int run(const void* x, const void* g1, const void* be1, const void* wqkv,
        const void* bqkv, const void* wproj, const void* bproj,
        const void* bias, const void* mask, const void* g2, const void* be2,
        const void* w1, const void* b1, const void* w2, const void* b2,
        void* qkv, void* attn, void* ybuf, void* h, void* stats, void* out,
        int B, int Hp, int Wp, int C, int heads, int window, int hidden,
        float scale, cudaStream_t s) {
  cudaError_t err = swin::attention_half<T>(
      static_cast<const T*>(x), static_cast<const float*>(g1),
      static_cast<const float*>(be1), static_cast<const T*>(wqkv),
      static_cast<const T*>(bqkv), static_cast<const T*>(wproj),
      static_cast<const T*>(bproj), static_cast<const T*>(bias),
      static_cast<const T*>(mask), static_cast<T*>(qkv),
      static_cast<T*>(attn), static_cast<float2*>(stats),
      static_cast<T*>(ybuf), B, Hp, Wp, C, heads, window, scale, s);
  if (err != cudaSuccess) return (int)err;
  return (int)swin::mlp_half<T>(
      static_cast<const T*>(ybuf), static_cast<const float*>(g2),
      static_cast<const float*>(be2), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(h),
      static_cast<float2*>(stats), static_cast<T*>(out), B * Hp * Wp, C,
      hidden, s);
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
  if (!swin::block_shape_ok(B, Hp, Wp, C, heads, window) || hidden <= 0 ||
      hidden % 64)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(x, g1, be1, wqkv, bqkv, wproj, bproj, bias, mask, g2,
                      be2, w1, b1, w2, b2, qkv, attn, ybuf, h, stats, out, B,
                      Hp, Wp, C, heads, window, hidden, scale, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, g1, be1, wqkv, bqkv, wproj, bproj, bias,
                              mask, g2, be2, w1, b1, w2, b2, qkv, attn, ybuf,
                              h, stats, out, B, Hp, Wp, C, heads, window,
                              hidden, scale, s);
  return (int)cudaErrorInvalidValue;
}
