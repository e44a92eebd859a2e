// The window-attention phase's other way of reading the relative-position
// bias, for scripts/window_attn_bias_probe.py: a block walks WPB windows of
// one head with the head's (N, N) bias staged once in its shared memory
// (cp.async), beside q, k and v, and reads the bias there; the mask is
// read from device memory as in the kept design. The rest is
// computervision_codes_tpu_torch/csrc/window_attn.cuh's body unchanged
// (swin::wa::attend), so the outputs must equal window_attn_phase_cuda's
// bit for bit. bf16, N = 144 (16-query strips: 9), head_dim 32; no model
// calls it.
//
// Interface: plain C, loaded with ctypes; the launch goes on the caller's
// stream; returns the CUDA error of the launch (0 on success).

#include "../computervision_codes_tpu_torch/csrc/swin_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int NT = 9, N = 144;
constexpr int THREADS = 32 * swin::wa::warps_of(NT);
constexpr size_t SMEM =
    swin::wa::smem_of<bf16>(NT) + (size_t)N * N * sizeof(bf16);

template <int WPB>
__global__ void __launch_bounds__(THREADS, 3)
walk_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ bias,
            const bf16* __restrict__ mask, bf16* __restrict__ out, int B,
            int Hp, int Wp, int C, int w, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sm = reinterpret_cast<bf16*>(smem);
  bf16* bs = sm + swin::wa::smem_of<bf16>(NT) / sizeof(bf16);
  const int n = w * w, nww = Wp / w, nw = (Hp / w) * nww, h = blockIdx.y;
  const bf16* bh = bias + (size_t)h * n * n;
  for (int i = threadIdx.x; i < n * n / 8; i += THREADS)
    attn::copy_chunk(bs + i * 8, bh + i * 8, true, 16);
  attn::cp_async_commit();  // complete once attend waits for q and k
  for (int k = 0; k < WPB; ++k) {
    const int win = blockIdx.x * WPB + k;
    if (win >= B * nw) break;
    __syncthreads();  // every warp is done with the last window's tiles
    const int b = win / nw, wi = win % nw, wr = wi / nww, wc = wi % nww;
    auto token = [&](int r) {
      return ((size_t)b * Hp + wr * w + r / w) * Wp + wc * w + r % w;
    };
    auto src = [&](int which, int r) {
      return qkv + h * swin::HD + token(r) * 3 * C + which * C;
    };
    auto store = [&](int r, int d, float v0, float v1) {
      swin::wa::store_pair(out + token(r) * C + h * swin::HD + d, v0, v1);
    };
    swin::wa::attend<bf16, NT>(sm, src, 16, bs,
                               mask ? mask + (size_t)wi * n * n : nullptr, n,
                               scale, store);
  }
}

template <int WPB>
int launch(const void* qkv, const void* bias, const void* mask, void* out,
           int B, int Hp, int Wp, int C, int heads, int w, float scale,
           cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      walk_kernel<WPB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  const int windows = B * (Hp / w) * (Wp / w);
  walk_kernel<WPB><<<dim3((windows + WPB - 1) / WPB, heads), THREADS, SMEM,
                     s>>>(static_cast<const bf16*>(qkv),
                          static_cast<const bf16*>(bias),
                          static_cast<const bf16*>(mask),
                          static_cast<bf16*>(out), B, Hp, Wp, C, w, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// qkv (B*Hp*Wp, 3C), out (B*Hp*Wp, C), bias (heads, 144, 144), mask (nW,
// 144, 144, or null), bf16; w = 12; wpb: windows a block walks (4 or 16)
extern "C" int window_attn_walk_launch(const void* qkv, const void* bias,
                                       const void* mask, void* out, int B,
                                       int Hp, int Wp, int C, int heads,
                                       int w, float scale, int wpb,
                                       void* stream) {
  if (w * w != N || Hp % w || Wp % w || C != heads * swin::HD)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wpb == 4)
    return launch<4>(qkv, bias, mask, out, B, Hp, Wp, C, heads, w, scale, s);
  if (wpb == 16)
    return launch<16>(qkv, bias, mask, out, B, Hp, Wp, C, heads, w, scale,
                      s);
  return (int)cudaErrorInvalidValue;
}
