// P1's weight-only int8 product as two launches, for timing only: a widen
// pass that writes the (K, N) int8 codes as bf16 into a scratch in device
// memory, then the Swin GEMM core's bf16 product with the scale epilogue
// (swin::gemm_wgmma<EPI_SCALE>) over it. scripts/int8w_split_probe.py
// times it in turns against the one-launch kernel, which widens the codes
// in each block's shared memory (Int8wOp, swin_gemm.cuh), and holds the two
// equal bit for bit: the same bf16 values through the same wgmma sums and
// epilogue. No entry point of the port calls it.
//
// What bounds it on the card: the widen pass moves 3 bytes a code (0.007
// ms for 768 x 3072 codes at 3.35 TB/s); the product is P1's bf16 product.
//
// Interface: plain C, loaded with ctypes; launches on the caller's stream,
// returns the first CUDA error (0 on success).

#include "swin_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;

// 16 codes a thread: out[16 i ..] = bf16(w[16 i ..])
__global__ void __launch_bounds__(256)
widen_kernel(const uint4* __restrict__ w, uint4* __restrict__ out,
             long long vecs) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < vecs; i += stride) {
    const uint4 v = w[i];
    const uint2 a = swin::widen4(v.x), b = swin::widen4(v.y),
                c = swin::widen4(v.z), d = swin::widen4(v.w);
    out[2 * i] = make_uint4(a.x, a.y, b.x, b.y);
    out[2 * i + 1] = make_uint4(c.x, c.y, d.x, d.y);
  }
}

}  // namespace

// w (count,) int8 codes, out (count,) bf16; count % 16 == 0, both 16-byte
// aligned
extern "C" int int8w_widen_launch(const void* w, void* out, long long count,
                                  void* stream) {
  if (count <= 0 || count % 16) return (int)cudaErrorInvalidValue;
  const long long vecs = count / 16;
  const long long blocks = (vecs + 255) / 256;
  widen_kernel<<<(int)(blocks < 132 * 16 ? blocks : 132 * 16), 256, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(w), static_cast<uint4*>(out), vecs);
  return (int)cudaGetLastError();
}

// x (M, K) bf16, w (K, N) bf16, s (N,) float32, out (M, N) bf16 =
// bf16((x w) * s); K % 8 == 0, N % 64 == 0
extern "C" int int8w_gemm_scale_launch(const void* x, const void* w,
                                       const void* s, void* out, int M, int N,
                                       int K, void* stream) {
  return (int)swin::gemm_wgmma<swin::EPI_SCALE>(
      {static_cast<const bf16*>(x), nullptr, nullptr, nullptr,
       static_cast<const bf16*>(w), nullptr, nullptr, static_cast<bf16*>(out),
       M, N, K, static_cast<const float*>(s)},
      static_cast<cudaStream_t>(stream));
}
