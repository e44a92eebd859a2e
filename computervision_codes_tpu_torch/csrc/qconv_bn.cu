// Q1: the int8 convolution with the fused dequant + BatchNorm + activation
// epilogue, written by hand for Hopper (sm_90a), in two paths.
//
// Stands in for computervision_codes_tpu/ops/quant.py::conv_i8 (an XLA
// int8 convolution on the TPU, not a Pallas kernel) together with the
// epilogue of quantized_conv_bn. Over NHWC activations x (N, H, W, Cin) in
// float32 or bf16, int8 weights wq (Cout, kh, kw, Cin), the per-channel
// float32 multiplier mult and bias (Cout), and the activation scale s (one
// float32 on the device):
//
//   xq  = clamp(rint(x / s), -127, 127)                (int8)
//   acc = sum_{ky, kx, ci} xq[n, ho*st + ky - pt, wo*st + kx - pl, ci]
//                          * wq[o, ky, kx, ci]         (int32, exact)
//   y   = act((float)acc * (s * mult[o]) + bias[o])    (rounded to y's dtype)
//
// with act none, ReLU or leaky ReLU, and input outside the frame read as
// code 0 (the conv's zero padding). Division, products and sums use the
// _rn intrinsics and rintf (round half to even), so no FMA contraction
// happens and the result equals the plain PyTorch version bit for bit.
// Reading s from device memory lets the static (calibrated) and dynamic
// (absmax on the device) modes share the kernels without a host sync.
//
// What bounds it on the card: as a GEMM, M = N * Ho * Wo output pixels,
// N = Cout, K = kh * kw * Cin. ResNet18's 19 convolutions at 256x448 are
// bound by their bytes (bf16 in and out), the teacher's Dense layers by
// the int8 tensor cores (1,979 TOP/s). PyTorch has no CUDA int8
// convolution, and im2col + an int8 GEMM would write kh * kw times the
// activation bytes.
//
// The wgmma path (Cin % 16 == 0; every main-path shape), two kernels:
//
// 1. quantize_kernel: x -> int8 NHWC codes, 16-byte vector loads, each
//    element divided once (the loop below divides it once per 64-channel
//    N block and per tap). Bandwidth-bound; folding it into the previous
//    layer's epilogue is later work.
// 2. qconv_wgmma_kernel: output tiles of 64 CW rows by BN columns (128 x 64
//    for Cout <= 64, 256 x 128 above).
//    Warpgroup 0 produces; each of the CW consumer warpgroups runs wgmma
//    m64nBNk32 s8 over its 64 rows with the int32 sums in registers. The
//    operands pass through a ring of 4 shared-memory stages of 128
//    bytes of K each (128-byte swizzle), handed back and forth by
//    full/empty mbarriers, so the consumers do not wait on device memory
//    while later stages load. The block is persistent (one or two an SM,
//    walking the tiles), so the next tile's stages load during this
//    tile's epilogue. B (the weights, (Cout, K) K-major as stored) always
//    comes by TMA. A comes by one of two producers:
//    - FORM_GEMM (1x1, stride 1, unpadded: every Dense call): TMA of the
//      (M, K) code matrix; rows beyond M and K beyond K are zero-filled.
//    - FORM_CONV (3x3 at stride 1 and 2, 1x1 at stride 2): an implicit
//      GEMM. Each 16-byte run of K lies inside one tap (Cin % 16 == 0), so
//      the 128 producer threads each cp.async 16-byte runs straight into
//      the swizzled layout, with src-size 0 for padding taps, rows beyond
//      M and K beyond K. cp.async rather than TMA's im2col mode: im2col
//      boxes walk one tap's pixels, while a 128-byte K slice here spans
//      two taps at Cin = 64; TMA im2col is later work. A producer thread
//      hands a stage over one stage after issuing it, after
//      cp.async.wait_group and fence.proxy.async (hopper_gemm.cuh says
//      why), one mbarrier arrival per warp.
//    The epilogue maps the wgmma fragment to (row, column), masks the M
//    and N tails, and runs the same _rn sequence as the loop. At N = 64
//    each code is read from L2 once per tap (nine times for a 3x3), which
//    bounds the 64-channel stage; reusing input rows across taps is later
//    work.
//
// The loop path (qconv_loop_kernel: Cin % 16 != 0, as the 3-channel 7x7
// stem with float_stem=False and odd channel counts): quantize on load,
// mma.sync m16n8k32 s8 on a 128 x 64 tile, one shared-memory stage. The
// wrapper (ops/quant.py) chooses the path from the shapes alone.
//
// Interface: plain C, loaded with ctypes. Each launch goes on the caller's
// stream, never synchronises and allocates nothing; the return value is
// cudaGetLastError() after the launch (or the error found before it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

struct Params {
  int N, H, W, Cin, Ho, Wo, Cout, kh, kw, stride, pad_t, pad_l;
  int M, K;
  int act;  // 0 none, 1 ReLU, 2 leaky ReLU
  float slope;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// clamp(rint(v / s), -127, 127) as a byte
__device__ __forceinline__ uint32_t quant(float v, float s) {
  float q = rintf(__fdiv_rn(v, s));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return (uint32_t)(uint8_t)(int8_t)(int)q;
}

// eight consecutive input elements -> eight int8 codes packed in a uint2
template <typename T> struct Load8;
template <> struct Load8<float> {
  static __device__ __forceinline__ uint2 run(const float* p, float s) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    uint2 r;
    r.x = quant(a.x, s) | quant(a.y, s) << 8 | quant(a.z, s) << 16 |
          quant(a.w, s) << 24;
    r.y = quant(b.x, s) | quant(b.y, s) << 8 | quant(b.z, s) << 16 |
          quant(b.w, s) << 24;
    return r;
  }
};
template <> struct Load8<__nv_bfloat16> {
  static __device__ __forceinline__ uint2 run(const __nv_bfloat16* p,
                                              float s) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
    uint2 r;
    r.x = quant(to_f(e[0]), s) | quant(to_f(e[1]), s) << 8 |
          quant(to_f(e[2]), s) << 16 | quant(to_f(e[3]), s) << 24;
    r.y = quant(to_f(e[4]), s) | quant(to_f(e[5]), s) << 8 |
          quant(to_f(e[6]), s) << 16 | quant(to_f(e[7]), s) << 24;
    return r;
  }
};

// (float)acc * (s * mult) + bias, then the activation, in float32 with
// no contraction
__device__ __forceinline__ float dequant(int acc, float sm, float bo,
                                         const Params& p) {
  float v = __fadd_rn(__fmul_rn(__int2float_rn(acc), sm), bo);
  if (p.act == 1) {
    v = fmaxf(v, 0.0f);
  } else if (p.act == 2) {
    v = v >= 0.0f ? v : __fmul_rn(p.slope, v);
  }
  return v;
}

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, __nv_bfloat16 a,
                                       __nv_bfloat16 b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __halves2bfloat162(a, b);
}

// ---- the quantize pass ------------------------------------------------

template <typename TI> struct Vec;  // 16 bytes of input -> packed codes
template <> struct Vec<float> {
  static constexpr int n = 4;
  static __device__ __forceinline__ void run(const float* x, int8_t* q,
                                             float s) {
    const float4 a = *reinterpret_cast<const float4*>(x);
    *reinterpret_cast<uint32_t*>(q) = quant(a.x, s) | quant(a.y, s) << 8 |
                                      quant(a.z, s) << 16 |
                                      quant(a.w, s) << 24;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  static __device__ __forceinline__ void run(const __nv_bfloat16* x,
                                             int8_t* q, float s) {
    *reinterpret_cast<uint2*>(q) = Load8<__nv_bfloat16>::run(x, s);
  }
};

// x (n elements, 16-byte aligned) -> q (int8, 8-byte aligned)
template <typename TI>
__global__ void __launch_bounds__(256)
quantize_kernel(const TI* __restrict__ x, const float* __restrict__ s_act,
                int8_t* __restrict__ q, long long n) {
  const float s = *s_act;
  constexpr int V = Vec<TI>::n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long vecs = n / V;
  for (long long i = first; i < vecs; i += stride)
    Vec<TI>::run(x + i * V, q + i * V, s);
  for (long long i = vecs * V + first; i < n; i += stride)
    q[i] = (int8_t)(uint8_t)quant(to_f(x[i]), s);
}

// ---- the wgmma path ----------------------------------------------------

constexpr int WG_BK = 128;  // bytes of K per stage: one swizzled row
constexpr int FORM_GEMM = 0, FORM_CONV = 1;

// A tile of 64 CW rows (CW consumer warpgroups of 64) by BN columns
template <int BN, int CW> struct WgTile {
  static constexpr int BM = 64 * CW;
  static constexpr int THREADS = 128 * (CW + 1);  // + the producer
  // (BN, CW) = (64, 2): 4 x 24 KB, two blocks an SM; (128, 4): 4 x 48 KB
  static constexpr int STAGES = 4;
  static constexpr int MIN_BLOCKS = BN == 64 ? 2 : 1;
  static constexpr int A_BYTES = BM * WG_BK, B_BYTES = BN * WG_BK;
  // 1024 for aligning the ring by hand, then the ring, then 2 x STAGES
  // mbarriers
  static constexpr int SMEM =
      1024 + STAGES * (A_BYTES + B_BYTES) + 2 * STAGES * 8;
};

// Persistent: block b takes tiles b, b + gridDim.x, ... in N-fastest order
// (the blocks in flight share their A rows in L2). The ring's stage and
// phase run on across tiles, so the producer fills the next tile's stages
// while the consumers run the epilogue of this one.
template <int BN, int CW, int FORM, typename TO>
__global__ void __launch_bounds__(WgTile<BN, CW>::THREADS,
                                  WgTile<BN, CW>::MIN_BLOCKS)
qconv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                   const __grid_constant__ CUtensorMap tm_b,
                   const int8_t* __restrict__ xq,
                   const float* __restrict__ s_act,
                   const float* __restrict__ mult,
                   const float* __restrict__ bias, TO* __restrict__ y,
                   Params p) {
  using T = WgTile<BN, CW>;
  constexpr int ST = T::STAGES, BM = T::BM;
  extern __shared__ uint8_t smem_raw[];
  int8_t* ring = reinterpret_cast<int8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  int8_t* sa = ring;                    // ST x (BM x 128)
  int8_t* sb = ring + ST * T::A_BYTES;  // ST x (BN x 128)
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + ST * T::B_BYTES);
  uint64_t* empty = full + ST;

  const int n_tiles = (p.Cout + BN - 1) / BN;
  const int tiles = ((p.M + BM - 1) / BM) * n_tiles;
  const int nk = (p.K + WG_BK - 1) / WG_BK;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      // FORM_CONV: the TMA arrival of B plus one from each producer warp
      hopper::mbar_init(&full[s], FORM == FORM_GEMM ? 1 : 5);
      hopper::mbar_init(&empty[s], 4 * CW);  // lane 0 of each consumer warp
    }
    hopper::mbar_fence_init();
    if (FORM == FORM_GEMM) hopper::tma_prefetch_map(&tm_a);
    hopper::tma_prefetch_map(&tm_b);
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer --------------------------------------------------------
    if (FORM == FORM_GEMM) {
      if (t != 0) return;
      int it = 0;  // stages filled so far, over all tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m_block = (tile / n_tiles) * BM;
        const int n_block = (tile % n_tiles) * BN;
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = it % ST;
          hopper::mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(&full[s], T::A_BYTES + T::B_BYTES);
          hopper::tma_load_2d(sa + s * T::A_BYTES, &tm_a, kb * WG_BK, m_block,
                              &full[s]);
          hopper::tma_load_2d(sb + s * T::B_BYTES, &tm_b, kb * WG_BK, n_block,
                              &full[s]);
        }
      }
      return;
    }
    // FORM_CONV: thread t copies chunk c = t % 8 of rows t / 8 + 16 i
    // a stage's copies are waited for one stage later: a quick handover
    // measured faster than a deeper queue (LAG may go up to ST - 2)
    constexpr int LAG = 1;
    constexpr int ROWS = BM / 16;
    const int c = t % 8, r0 = t / 8;
    const uint32_t dst0 = hopper::smem_u32(sa) + hopper::swizzled_chunk(r0, c);
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m_block = (tile / n_tiles) * BM;
      const int n_block = (tile % n_tiles) * BN;
      int nh[ROWS], hi0[ROWS], wi0[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int m = m_block + r0 + 16 * i;
        const int wo = m % p.Wo, tt = m / p.Wo;
        nh[i] = (tt / p.Ho) * p.H;
        // a row beyond M reads nothing: its hi stays below 0 for every tap
        hi0[i] = m < p.M ? (tt % p.Ho) * p.stride - p.pad_t : -(1 << 30);
        wi0[i] = wo * p.stride - p.pad_l;
      }
      // the tap (ky, kx) and channel ci of this thread's 16 bytes of K
      int ci = 16 * c, kx = 0, ky = 0;
      while (ci >= p.Cin) {
        ci -= p.Cin;
        if (++kx == p.kw) kx = 0, ++ky;
      }
      for (int kb = 0; kb < nk; ++kb, ++it) {
        const int s = it % ST;
        hopper::mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
        if (t == 0) {
          hopper::mbar_arrive_expect_tx(&full[s], T::B_BYTES);
          hopper::tma_load_2d(sb + s * T::B_BYTES, &tm_b, kb * WG_BK, n_block,
                              &full[s]);
        }
        const bool k_ok = ky < p.kh;
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const int hi = hi0[i] + ky, wi = wi0[i] + kx;
          const bool ok = k_ok && hi >= 0 && hi < p.H && wi >= 0 && wi < p.W;
          const int8_t* src =
              ok ? xq + ((size_t)(nh[i] + hi) * p.W + wi) * p.Cin + ci : xq;
          hopper::cp_async_16(dst0 + s * T::A_BYTES + i * 16 * WG_BK, src,
                              ok ? 16u : 0u);
        }
        hopper::cp_async_commit();
        ci += WG_BK;
        while (ci >= p.Cin) {
          ci -= p.Cin;
          if (++kx == p.kw) kx = 0, ++ky;
        }
        if (it >= LAG) {
          hopper::cp_async_wait<LAG>();  // stage it - LAG has landed
          hopper::fence_proxy_async();
          __syncwarp();
          if (t % 32 == 0) hopper::mbar_arrive(&full[(it - LAG) % ST]);
        }
      }
    }
    hopper::cp_async_wait<0>();
    hopper::fence_proxy_async();
    __syncwarp();
    if (t % 32 == 0)
      for (int j = it > LAG ? it - LAG : 0; j < it; ++j)
        hopper::mbar_arrive(&full[j % ST]);
    return;
  }

  // ---- consumers: warpgroup wg - 1 owns rows 64 (wg - 1) .. + 63 --------
  const int cw = wg - 1;
  const float s_in = *s_act;
  const int lane = t % 32, g = lane / 4, tq = lane % 4;
  const bool pairs = p.Cout % 2 == 0;
  int it = 0;  // stages consumed so far, over all tiles
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m_block = (tile / n_tiles) * BM;
    const int n_block = (tile % n_tiles) * BN;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int kb = 0; kb < nk; ++kb, ++it) {
      const int s = it % ST;
      hopper::mbar_wait(&full[s], (it / ST) & 1);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) hopper::fence_operand(acc[i]);
      hopper::wgmma_fence();
      const int8_t* a = sa + s * T::A_BYTES + cw * 64 * WG_BK;
      const int8_t* b = sb + s * T::B_BYTES;
#pragma unroll
      for (int kk = 0; kk < WG_BK / 32; ++kk)
        hopper::WgmmaS8<BN>::run(acc, hopper::smem_desc_sw128(a + 32 * kk),
                                 hopper::smem_desc_sw128(b + 32 * kk));
      hopper::wgmma_commit();
      // the previous stage's wgmmas are done: hand it back to the producer
      hopper::wgmma_wait<1>();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) hopper::fence_operand(acc[i]);
      if (kb > 0 && lane == 0) hopper::mbar_arrive(&empty[(it - 1) % ST]);
    }
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) hopper::fence_operand(acc[i]);
    if (lane == 0) hopper::mbar_arrive(&empty[(it - 1) % ST]);

    // epilogue: d[4j + 2h + cc] is row g + 8h, column 8j + 2 tq + cc
    const int row0 = m_block + cw * 64 + (t / 32) * 16 + g;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int o = n_block + 8 * j + 2 * tq;
      if (o >= p.Cout) continue;
      const bool two = o + 1 < p.Cout;
      const float sm0 = __fmul_rn(s_in, mult[o]), b0 = bias[o];
      const float sm1 = two ? __fmul_rn(s_in, mult[o + 1]) : 0.0f;
      const float b1 = two ? bias[o + 1] : 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = row0 + 8 * h;
        if (m >= p.M) continue;
        const TO v0 = from_f<TO>(dequant(acc[4 * j + 2 * h], sm0, b0, p));
        const TO v1 =
            from_f<TO>(dequant(acc[4 * j + 2 * h + 1], sm1, b1, p));
        TO* dst = y + (size_t)m * p.Cout + o;
        if (pairs) {
          store2(dst, v0, v1);
        } else {
          dst[0] = v0;
          if (two) dst[1] = v1;
        }
      }
    }
  }
}

template <int BN, int CW, int FORM, typename TO>
int launch_wgmma(const void* xq, const void* s_act, const void* wq,
                 const void* mult, const void* bias, void* y, const Params& p,
                 cudaStream_t stream) {
  using T = WgTile<BN, CW>;
  CUtensorMap tm_a, tm_b;
  int err = hopper::encode_u8_sw128_cached(&tm_b, wq, p.Cout, p.K, BN);
  if (err != 0) return err;
  if (FORM == FORM_GEMM) {
    err = hopper::encode_u8_sw128_cached(&tm_a, xq, p.M, p.K, T::BM);
    if (err != 0) return err;
  } else {
    tm_a = tm_b;  // unused
  }
  auto kernel = qconv_wgmma_kernel<BN, CW, FORM, TO>;
  // per device, once: the shared memory beyond 48 KB and the number of
  // blocks that fit on the card at once
  static int resident[32] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  int blocks = dev < 32 ? resident[dev] : 0;
  if (blocks == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    int sms = 0, per_sm = 0;
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        T::THREADS, T::SMEM);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
    blocks = sms * per_sm;
    if (dev < 32) resident[dev] = blocks;
  }
  const long long tiles = (long long)((p.M + T::BM - 1) / T::BM) *
                          ((p.Cout + BN - 1) / BN);
  const int grid = (int)(tiles < blocks ? tiles : blocks);
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(
      tm_a, tm_b, static_cast<const int8_t*>(xq),
      static_cast<const float*>(s_act), static_cast<const float*>(mult),
      static_cast<const float*>(bias), static_cast<TO*>(y), p);
  return (int)cudaGetLastError();
}

template <int BN, int CW, int FORM>
int launch_wgmma_out(int out_dtype, const void* xq, const void* s_act,
                     const void* wq, const void* mult, const void* bias,
                     void* y, const Params& p, cudaStream_t stream) {
  if (out_dtype == 0)
    return launch_wgmma<BN, CW, FORM, float>(xq, s_act, wq, mult, bias, y, p,
                                             stream);
  return launch_wgmma<BN, CW, FORM, __nv_bfloat16>(xq, s_act, wq, mult, bias,
                                                   y, p, stream);
}

// ---- the loop path -----------------------------------------------------

namespace loop {

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int LDS = BK + 16;  // 48-byte rows: conflict-free fragment reads
constexpr int THREADS = 256;

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename TI, typename TO>
__global__ void __launch_bounds__(THREADS)
qconv_loop_kernel(const TI* __restrict__ x, const float* __restrict__ s_act,
                  const int8_t* __restrict__ wq,
                  const float* __restrict__ mult,
                  const float* __restrict__ bias, TO* __restrict__ y,
                  Params p) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];
  const float s = *s_act;
  const int tid = threadIdx.x;
  const int m_block = blockIdx.x * BM, n_block = blockIdx.y * BN;
  const bool vec = p.Cin % 8 == 0;

  // the two A rows this thread fills: output pixels m_block + tid / 4 and
  // + 64, each at k offset 8 * (tid % 4) of every K slice
  const int kc = (tid % 4) * 8;
  int arow[2], img[2], hi0[2], wi0[2];
  bool rvalid[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    arow[j] = tid / 4 + 64 * j;
    const int m = m_block + arow[j];
    rvalid[j] = m < p.M;
    const int mm = rvalid[j] ? m : 0;
    const int wo = mm % p.Wo, t = mm / p.Wo;
    img[j] = t / p.Ho;
    hi0[j] = (t % p.Ho) * p.stride - p.pad_t;
    wi0[j] = wo * p.stride - p.pad_l;
  }

  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp % 4, wn = warp / 4;
  const int g = lane / 4, tig = lane % 4;
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < p.K; k0 += BK) {
    // A: quantize on load
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint2 codes = make_uint2(0u, 0u);
      const int k = k0 + kc;
      if (vec) {
        if (rvalid[j] && k < p.K) {
          const int tap = k / p.Cin, ci = k % p.Cin;
          const int hi = hi0[j] + tap / p.kw, wi = wi0[j] + tap % p.kw;
          if (hi >= 0 && hi < p.H && wi >= 0 && wi < p.W)
            codes = Load8<TI>::run(
                x + (((size_t)img[j] * p.H + hi) * p.W + wi) * p.Cin + ci,
                s);
        }
      } else {
        uint32_t word[2] = {0u, 0u};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int kk = k + e;
          if (!rvalid[j] || kk >= p.K) continue;
          const int tap = kk / p.Cin, ci = kk % p.Cin;
          const int hi = hi0[j] + tap / p.kw, wi = wi0[j] + tap % p.kw;
          if (hi < 0 || hi >= p.H || wi < 0 || wi >= p.W) continue;
          const float v = to_f(
              x[(((size_t)img[j] * p.H + hi) * p.W + wi) * p.Cin + ci]);
          word[e / 4] |= quant(v, s) << (8 * (e % 4));
        }
        codes = make_uint2(word[0], word[1]);
      }
      *reinterpret_cast<uint2*>(As + arow[j] * LDS + kc) = codes;
    }
    // B: 64 output channels x 32 bytes of K
    if (tid < 128) {
      const int row = tid / 2, kb = (tid % 2) * 16;
      const int o = n_block + row, k = k0 + kb;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (o < p.Cout) {
        const int8_t* src = wq + (size_t)o * p.K + k;
        if (p.K % 16 == 0) {
          if (k < p.K) v = *reinterpret_cast<const uint4*>(src);
        } else {
          uint32_t word[4] = {0u, 0u, 0u, 0u};
          for (int e = 0; e < 16 && k + e < p.K; ++e)
            word[e / 4] |= (uint32_t)(uint8_t)src[e] << (8 * (e % 4));
          v = make_uint4(word[0], word[1], word[2], word[3]);
        }
      }
      *reinterpret_cast<uint4*>(Bs + row * LDS + kb) = v;
    }
    __syncthreads();

    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int8_t* base = As + (wm * 32 + i * 16 + g) * LDS + tig * 4;
      a[i][0] = *reinterpret_cast<const uint32_t*>(base);
      a[i][1] = *reinterpret_cast<const uint32_t*>(base + 8 * LDS);
      a[i][2] = *reinterpret_cast<const uint32_t*>(base + 16);
      a[i][3] = *reinterpret_cast<const uint32_t*>(base + 8 * LDS + 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int8_t* base = Bs + (wn * 32 + j * 8 + g) * LDS + tig * 4;
      b[j][0] = *reinterpret_cast<const uint32_t*>(base);
      b[j][1] = *reinterpret_cast<const uint32_t*>(base + 16);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    __syncthreads();
  }

  // epilogue
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int o = n_block + wn * 32 + j * 8 + tig * 2 + cc;
      if (o >= p.Cout) continue;
      const float sm = __fmul_rn(s, mult[o]);
      const float bo = bias[o];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m_block + wm * 32 + i * 16 + g + 8 * h;
          if (m >= p.M) continue;
          const float v = dequant(acc[i][j][2 * h + cc], sm, bo, p);
          y[(size_t)m * p.Cout + o] = from_f<TO>(v);
        }
      }
    }
  }
}

template <typename TI, typename TO>
int launch(const void* x, const void* s_act, const void* wq, const void* mult,
           const void* bias, void* y, const Params& p, cudaStream_t stream) {
  const dim3 grid((p.M + BM - 1) / BM, (p.Cout + BN - 1) / BN);
  qconv_loop_kernel<TI, TO><<<grid, THREADS, 0, stream>>>(
      static_cast<const TI*>(x), static_cast<const float*>(s_act),
      static_cast<const int8_t*>(wq), static_cast<const float*>(mult),
      static_cast<const float*>(bias), static_cast<TO*>(y), p);
  return (int)cudaGetLastError();
}

}  // namespace loop

}  // namespace

// Shared arguments of the convolution entry points: contiguous device
// buffers wq (Cout, kh, kw, Cin) int8, mult and bias (Cout) float32, s_act
// (1 float32), y (N, Ho, Wo, Cout) in out_dtype (0 = float32, 1 =
// bfloat16). pad_t and pad_l are the zero rows above and columns left of
// the frame; Ho and Wo fix the padding below and to the right. act: 0
// none, 1 ReLU, 2 leaky ReLU with slope. Each returns a cudaError_t value
// (0 on success).

static int make_params(Params* p, int N, int H, int W, int Cin, int Ho,
                       int Wo, int Cout, int kh, int kw, int stride,
                       int pad_t, int pad_l, int act, float slope) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Ho <= 0 || Wo <= 0 ||
      Cout <= 0 || kh <= 0 || kw <= 0 || stride <= 0 || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)N * Ho * Wo;
  const long long K = (long long)kh * kw * Cin;
  if (M >= (1LL << 31) - 256 || K >= (1LL << 31) - 256)
    return (int)cudaErrorInvalidValue;
  *p = Params{N, H, W, Cin, Ho, Wo, Cout, kh, kw, stride, pad_t, pad_l,
              (int)M, (int)K, act, slope};
  return 0;
}

// The quantize pass: x (n elements, in_dtype 0 = float32, 1 = bfloat16,
// 16-byte aligned) -> q (n int8 codes, 8-byte aligned).
extern "C" int qconv_quantize_launch(const void* x, const void* s_act,
                                     void* q, long long n, int in_dtype,
                                     void* stream) {
  if (n <= 0 || in_dtype < 0 || in_dtype > 1)
    return (int)cudaErrorInvalidValue;
  const long long vecs = n / (in_dtype == 0 ? 4 : 8) + 1;
  const long long blocks = (vecs + 255) / 256;
  const unsigned grid = (unsigned)(blocks < 132 * 16 ? blocks : 132 * 16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0)
    quantize_kernel<float><<<grid, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(s_act),
        static_cast<int8_t*>(q), n);
  else
    quantize_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const float*>(s_act), static_cast<int8_t*>(q), n);
  return (int)cudaGetLastError();
}

// The wgmma path over int8 codes xq (N, H, W, Cin), Cin % 16 == 0, all
// buffers 16-byte aligned. form 0: 1x1, stride 1, no padding (TMA
// producer); form 1: any other kernel size, stride and padding (cp.async
// producer).
extern "C" int qconv_wgmma_launch(const void* xq, const void* s_act,
                                  const void* wq, const void* mult,
                                  const void* bias, void* y, int N, int H,
                                  int W, int Cin, int Ho, int Wo, int Cout,
                                  int kh, int kw, int stride, int pad_t,
                                  int pad_l, int act, float slope,
                                  int out_dtype, int form, void* stream) {
  Params p;
  const int err = make_params(&p, N, H, W, Cin, Ho, Wo, Cout, kh, kw, stride,
                              pad_t, pad_l, act, slope);
  if (err != 0) return err;
  if (Cin % 16 != 0 || out_dtype < 0 || out_dtype > 1 || form < 0 ||
      form > 1)
    return (int)cudaErrorInvalidValue;
  if (form == FORM_GEMM &&
      (kh != 1 || kw != 1 || stride != 1 || pad_t != 0 || pad_l != 0 ||
       Ho != H || Wo != W))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // tiles: 128 x 64 for Cout <= 64; else 256 x 128 (three quarters of
  // the operand bytes per product of 128 x 128)
  if (Cout <= 64)
    return form == FORM_GEMM
               ? launch_wgmma_out<64, 2, FORM_GEMM>(out_dtype, xq, s_act, wq,
                                                    mult, bias, y, p, s)
               : launch_wgmma_out<64, 2, FORM_CONV>(out_dtype, xq, s_act, wq,
                                                    mult, bias, y, p, s);
  return form == FORM_GEMM
             ? launch_wgmma_out<128, 4, FORM_GEMM>(out_dtype, xq, s_act, wq,
                                                   mult, bias, y, p, s)
             : launch_wgmma_out<128, 4, FORM_CONV>(out_dtype, xq, s_act, wq,
                                                   mult, bias, y, p, s);
}

// The loop path over x (N, H, W, Cin) in in_dtype, quantized on load; any
// Cin.
extern "C" int qconv_loop_launch(const void* x, const void* s_act,
                                 const void* wq, const void* mult,
                                 const void* bias, void* y, int N, int H,
                                 int W, int Cin, int Ho, int Wo, int Cout,
                                 int kh, int kw, int stride, int pad_t,
                                 int pad_l, int act, float slope,
                                 int in_dtype, int out_dtype, void* stream) {
  Params p;
  const int err = make_params(&p, N, H, W, Cin, Ho, Wo, Cout, kh, kw, stride,
                              pad_t, pad_l, act, slope);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    return loop::launch<float, float>(x, s_act, wq, mult, bias, y, p, s);
  if (in_dtype == 0 && out_dtype == 1)
    return loop::launch<float, __nv_bfloat16>(x, s_act, wq, mult, bias, y, p,
                                              s);
  if (in_dtype == 1 && out_dtype == 0)
    return loop::launch<__nv_bfloat16, float>(x, s_act, wq, mult, bias, y, p,
                                              s);
  if (in_dtype == 1 && out_dtype == 1)
    return loop::launch<__nv_bfloat16, __nv_bfloat16>(x, s_act, wq, mult,
                                                      bias, y, p, s);
  return (int)cudaErrorInvalidValue;
}
