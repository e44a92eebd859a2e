// Int8 convolution with the fused dequant + BatchNorm + activation
// epilogue, written by hand for Hopper (sm_90a).
//
// Stands in for computervision_codes_tpu/ops/quant.py::conv_i8 (an XLA
// int8 convolution on the TPU, not a Pallas kernel) together with the
// epilogue of quantized_conv_bn. Over NHWC activations x (N, H, W, Cin) in
// float32 or bf16, int8 weights wq (Cout, kh, kw, Cin), the per-channel
// float32 multiplier mult and bias (Cout), and the activation scale s (one
// float32 on the device):
//
//   xq  = clamp(rint(x / s), -127, 127)                (int8, on load)
//   acc = sum_{ky, kx, ci} xq[n, ho*st + ky - pt, wo*st + kx - pl, ci]
//                          * wq[o, ky, kx, ci]         (int32, exact)
//   y   = act((float)acc * (s * mult[o]) + bias[o])    (rounded to y's dtype)
//
// with act none, ReLU or leaky ReLU, and input outside the frame read as
// code 0 (the conv's zero padding). Division, products and sums use the
// _rn intrinsics and rintf (round half to even), so no FMA contraction
// happens and the result equals the plain PyTorch version bit for bit.
// Reading s from device memory lets the static (calibrated) and dynamic
// (absmax on the device) modes share the kernel without a host sync.
//
// What bounds it on the card: as an implicit GEMM, M = N * Ho * Wo output
// pixels, N = Cout, K = kh * kw * Cin; at ResNet18's shapes (K = 576 to
// 4608) it is bound by the int8 tensor cores' rate if its tiles are fed.
// PyTorch has no CUDA int8 convolution, and im2col + an int8 GEMM would
// write kh * kw times the activation bytes (9x for a 3x3 conv). What the
// design does: the im2col tile is built in shared memory only, the input
// is quantized while it is loaded (x is read once per tap, in its own
// dtype), the int32 accumulators stay in registers through the epilogue,
// and only y is written. Products run on the tensor cores through
// mma.sync m16n8k32 s8 x s8 -> s32.
//
// Schedule: one block of 256 threads (8 warps, 4 x 2) per 128 x 64 output
// tile; each warp owns 32 x 32 (2 x 4 MMA tiles). The K loop walks 32-deep
// slices: every thread quantizes two 8-element runs of the A tile (one
// 16- or 32-byte vector load when Cin % 8 == 0, element by element
// otherwise, as for the 3-channel stem), 128 threads copy the 64 x 32 B
// tile, then each warp issues 8 MMAs. No software pipelining yet: cp.async
// or TMA staging and wgmma are later work.
//
// Interface: plain C, loaded with ctypes. The launch goes on the caller's
// stream, never synchronises and allocates nothing; the return value is
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int LDS = BK + 16;  // 48-byte rows: conflict-free fragment reads
constexpr int THREADS = 256;

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
qconv_bn_kernel(const TI* __restrict__ x, const float* __restrict__ s_act,
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

  // epilogue: (float)acc * (s * mult) + bias, activation, rounding
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
          float v = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h + cc]),
                                        sm),
                              bo);
          if (p.act == 1) {
            v = fmaxf(v, 0.0f);
          } else if (p.act == 2) {
            v = v >= 0.0f ? v : __fmul_rn(p.slope, v);
          }
          y[(size_t)m * p.Cout + o] = from_f<TO>(v);
        }
      }
    }
  }
}

template <typename TI, typename TO>
int launch(const void* x, const void* s_act, const void* wq,
           const void* mult, const void* bias, void* y, const Params& p,
           cudaStream_t stream) {
  const dim3 grid((p.M + BM - 1) / BM, (p.Cout + BN - 1) / BN);
  qconv_bn_kernel<TI, TO><<<grid, THREADS, 0, stream>>>(
      static_cast<const TI*>(x), static_cast<const float*>(s_act),
      static_cast<const int8_t*>(wq), static_cast<const float*>(mult),
      static_cast<const float*>(bias), static_cast<TO*>(y), p);
  return (int)cudaGetLastError();
}

}  // namespace

// in_dtype / out_dtype: 0 = float32, 1 = bfloat16. Contiguous device
// buffers: x (N, H, W, Cin), s_act (1 float32), wq (Cout, kh, kw, Cin)
// int8, mult and bias (Cout) float32, y (N, Ho, Wo, Cout). pad_t and pad_l
// are the zero rows above and columns left of the frame; Ho and Wo fix
// the padding below and to the right. act: 0 none, 1 ReLU, 2 leaky ReLU
// with slope. Returns a cudaError_t value (0 on success).
extern "C" int qconv_bn_launch(const void* x, const void* s_act,
                               const void* wq, const void* mult,
                               const void* bias, void* y, int N, int H,
                               int W, int Cin, int Ho, int Wo, int Cout,
                               int kh, int kw, int stride, int pad_t,
                               int pad_l, int act, float slope, int in_dtype,
                               int out_dtype, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Ho <= 0 || Wo <= 0 ||
      Cout <= 0 || kh <= 0 || kw <= 0 || stride <= 0 || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)N * Ho * Wo;
  const long long K = (long long)kh * kw * Cin;
  if (M >= (1LL << 31) - BM || K >= (1LL << 31) - BK)
    return (int)cudaErrorInvalidValue;
  Params p{N, H, W, Cin, Ho, Wo, Cout, kh, kw, stride, pad_t, pad_l,
           (int)M, (int)K, act, slope};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    return launch<float, float>(x, s_act, wq, mult, bias, y, p, s);
  if (in_dtype == 0 && out_dtype == 1)
    return launch<float, __nv_bfloat16>(x, s_act, wq, mult, bias, y, p, s);
  if (in_dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float>(x, s_act, wq, mult, bias, y, p, s);
  if (in_dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, s_act, wq, mult, bias, y,
                                                p, s);
  return (int)cudaErrorInvalidValue;
}
