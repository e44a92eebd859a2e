// P1: the in-kernel GEMM probe, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of scripts/int8_kernel_probe.py::run
// (pallas_call at :78, :80 and :83; bodies _bf16_kernel :33,
// _int8w_kernel :39, _int8_kernel :46). Over x (M, K) bf16:
//
//   bf16   out = bf16(x w), w (K, N) bf16, float32 sums;
//   int8w  out = bf16((x w) * s[n]), w (K, N) int8 codes widened to bf16 on
//          load (bf16 holds every integer in [-127, 127] exactly: half the
//          weight bytes of bf16, the same products), s (N,) float32;
//   int8   per block of blk rows: amax = max|x_blk| + 1e-6, q =
//          rint(x * (127 / amax)) int8, acc = q w (int8 x int8 -> int32),
//          out = bf16(acc * ((amax * (1/127)) * s[n])), w as (N, K) codes
//          (one output channel's K run contiguous: the caller transposes the
//          probe's (K, N) codes once, outside any timed call).
//
// The probe exists to time the GEMM core that the port's Swin kernels ship,
// so each variant launches swin_gemm.cuh's own products, not a copy:
//
//   bf16   swin::gemm_any<bf16, EPI_BIAS> with a zero bias (the product
//          K6's proj runs; acc + 0 rounds as acc does): the TMA-fed wgmma
//          GEMM, A read in place, w (K, N) as the MN-major operand;
//   int8w  swin::gemm_int8w_any: the same TMA-fed wgmma GEMM and bf16
//          consumers as bf16, with the bias-free scale epilogue; wgmma
//          cannot widen int8 operands, so the kernel does: the producer
//          loads each stage's codes by TMA beside its A, and seven warps
//          widen them to bf16 in the slot's B, laid out as bf16's TMA box
//          (Int8wOp in swin_gemm.cuh); one launch, the weight never widened
//          in device memory;
//   int8   swin::gemm_q8_any<bf16, Q8_T, Q8E_SCALE>: the quantize pass
//          into a codes scratch, then the s8 wgmma GEMM with the bias-free
//          epilogue in the JAX order.
//
// The "_loop" entry points run each variant on swin_common.cuh's loops
// (WMMA, int8w's widening its int8 codes on load, and mma.sync quantizing A
// on load): the parent that chip_smoke.py compares against. The entry
// points take N a multiple of 64 and K of 32 (the loops' tiles); M may be
// anything. The int8 variant's scale needs a
// whole row block before any of its products, so a reduction pass runs
// first (probe_amax_kernel, the only kernel of this file: one warp per row,
// atomicMax of the float bits into its block's slot; non-negative floats
// order like their bits as integers), after a memset of the slots. The
// arithmetic follows the JAX kernel body as XLA runs it: 127 / amax
// divided and rounded, q = rintf (half to even, as jnp.round), then
// (amax / 127) * s, which XLA's simplifier turns into amax * float32(1/127)
// (a division by a constant becomes a multiply by its reciprocal). The _rn
// intrinsics keep nvcc from contracting any of it into an FMA, so the
// output equals the plain version bit for bit.
//
// What bounds it on the card: at the stage-3 MLP shape (9216 x 768 x 3072)
// 43.5 G operations, 0.044 ms at 989 TFLOP/s in bf16 and 0.022 ms at 1,979
// TOP/s in int8, against 73-76 MB of traffic (0.022 ms at 3.35 TB/s); at
// the stage-1 and stage-2 QKV shapes the bytes bound it. int8w's widening
// adds no device-memory traffic: per stage of a 128 x 128 tile its warps
// read 8 KB and write 16 KB of shared memory and run 8 integer and bf16
// operations per 4 codes, beside the stage's 0.28 us of wgmma at peak.
//
// Interface: plain C, loaded with ctypes. Launches go on the caller's
// stream, never synchronise and allocate nothing; the return value is the
// first CUDA error of the launches (0 on success).

#include "swin_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;
using swin::THREADS;

// int8's reduction pass: amax[row / blk] = max over the block of |x|, as
// float bits (the slots zeroed first).
__global__ void __launch_bounds__(THREADS)
probe_amax_kernel(const bf16* __restrict__ x, int* __restrict__ amax, int M,
                  int K, int blk) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (row >= M) return;
  const bf16* xr = x + (size_t)row * K;
  float m = 0.0f;
  for (int c = lane * 8; c < K; c += 32 * 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(xr + c);
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(swin::to_f(e[j])));
  }
  m = swin::warp_max(m);
  if (lane == 0) atomicMax(amax + row / blk, __float_as_int(m));
}


bool shape_ok(int M, int N, int K) {
  return M > 0 && K > 0 && K % swin::BK == 0 && N > 0 && N % swin::BN == 0;
}

template <bool LOOP>
int launch_bf16(const void* x, const void* w, const void* zero, void* out,
                int M, int N, int K, void* stream) {
  if (!shape_ok(M, N, K)) return (int)cudaErrorInvalidValue;
  return (int)swin::gemm_any<bf16, swin::EPI_BIAS>(
      {static_cast<const bf16*>(x), nullptr, nullptr, nullptr,
       static_cast<const bf16*>(w), static_cast<const bf16*>(zero), nullptr,
       static_cast<bf16*>(out), M, N, K},
      false, nullptr, nullptr, LOOP, static_cast<cudaStream_t>(stream));
}

template <bool LOOP>
int launch_int8w(const void* x, const void* w, const void* s, void* out,
                 int M, int N, int K, void* stream) {
  if (!shape_ok(M, N, K)) return (int)cudaErrorInvalidValue;
  return (int)swin::gemm_int8w_any(
      {static_cast<const bf16*>(x), nullptr, nullptr, nullptr,
       static_cast<const int8_t*>(w), nullptr, nullptr,
       static_cast<bf16*>(out), M, N, K, static_cast<const float*>(s)},
      LOOP, static_cast<cudaStream_t>(stream));
}

template <bool LOOP>
int launch_int8(const void* x, const void* w, const void* s, void* amax,
                void* codes, void* out, int M, int N, int K, int blk,
                void* stream) {
  if (!shape_ok(M, N, K) || blk <= 0 || M % blk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(int) * (M / blk), st);
  if (err != cudaSuccess) return (int)err;
  const int rows = THREADS / 32;
  probe_amax_kernel<<<(M + rows - 1) / rows, THREADS, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<int*>(amax), M, K, blk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  swin::Q8Args<bf16> q{};
  q.a = x;
  q.a_amax = static_cast<const int*>(amax);
  q.a_map = {blk, 0, 0, 0};
  q.w = static_cast<const int8_t*>(w);
  q.wscale = static_cast<const float*>(s);
  q.out = out;
  q.M = M, q.N = N, q.K = K;
  return (int)swin::gemm_q8_any<bf16, swin::Q8_T, swin::Q8E_SCALE>(
      q, static_cast<int8_t*>(codes), LOOP, st);
}

}  // namespace

// x (M, K), w (K, N), zero (N,), out (M, N), all bf16; K % 32 == 0,
// N % 64 == 0.
extern "C" int probe_gemm_bf16_launch(const void* x, const void* w,
                                      const void* zero, void* out, int M,
                                      int N, int K, void* stream) {
  return launch_bf16<false>(x, w, zero, out, M, N, K, stream);
}

// probe_gemm_bf16_launch on the WMMA loop
extern "C" int probe_gemm_bf16_loop_launch(const void* x, const void* w,
                                           const void* zero, void* out, int M,
                                           int N, int K, void* stream) {
  return launch_bf16<true>(x, w, zero, out, M, N, K, stream);
}

// x (M, K) bf16, w (K, N) int8 codes, s (N,) float32, out (M, N) bf16.
extern "C" int probe_gemm_int8w_launch(const void* x, const void* w,
                                       const void* s, void* out, int M, int N,
                                       int K, void* stream) {
  return launch_int8w<false>(x, w, s, out, M, N, K, stream);
}

// probe_gemm_int8w_launch on the WMMA loop
extern "C" int probe_gemm_int8w_loop_launch(const void* x, const void* w,
                                            const void* s, void* out, int M,
                                            int N, int K, void* stream) {
  return launch_int8w<true>(x, w, s, out, M, N, K, stream);
}

// x (M, K) bf16, w (N, K) int8 codes, s (N,) float32, amax scratch of
// M / blk int32, codes scratch of M x K int8, out (M, N) bf16; M % blk == 0.
extern "C" int probe_gemm_int8_launch(const void* x, const void* w,
                                      const void* s, void* amax, void* codes,
                                      void* out, int M, int N, int K, int blk,
                                      void* stream) {
  return launch_int8<false>(x, w, s, amax, codes, out, M, N, K, blk, stream);
}

// probe_gemm_int8_launch on the mma.sync loop (codes unused)
extern "C" int probe_gemm_int8_loop_launch(const void* x, const void* w,
                                           const void* s, void* amax,
                                           void* codes, void* out, int M,
                                           int N, int K, int blk,
                                           void* stream) {
  return launch_int8<true>(x, w, s, amax, codes, out, M, N, K, blk, stream);
}
