// Device phases shared by the Swin kernels, written by hand for Hopper
// (sm_90a). swin_gemm.cuh builds on this header: its wgmma GEMM runs every
// bf16 and int8 product of K3 window_mhsa.cu, K4 mlp_block.cu, K5
// swin_block.cu (and K6, the training branches: K3's and K4's float entry
// points without the residual), P1 int8_kernel_probe.cu and P2
// swin_pack_probe.cu, and it chains their phases; those sources include it.
// Here are the float32 path (the FMA loop below), the loops that the bf16
// and int8 products ran before (kept for the shapes the path rule sends
// them, P1's weight-only int8, and as the parent that chip_smoke.py times
// and compares against through the "_loop" entry points), the LayerNorm
// and absmax passes. The attention phase, with each strip's scores in
// registers, is window_attn.cuh, included at the end: K3's window_attention
// below runs it, and K10 window_attention.cu runs its body over q, k and v
// it reads through their strides.
//
// Phases, all over row-major token matrices of one dtype T (float or bf16):
//
//   ln_stats_kernel   per-row LayerNorm statistics (mean, 1/sqrt(var+eps))
//                     in float32, one warp per row, two passes over the row;
//   gemm_kernel       out = epilogue(A W + b): A is either a token matrix or,
//                     with LN, LayerNorm(x) applied while the A tile is
//                     loaded (float32 math, rounded to T: the operand the
//                     TPU kernel feeds its MXU); W is (K, N) row-major, the
//                     flax kernel layout, or (K, N) int8 codes widened to
//                     bf16 on load (P1's weight-only int8); the float32 sum
//                     goes through one of five epilogues (bias; bias +
//                     exact-erf GELU; bias, rounded, + a residual in T;
//                     bias + residual summed in float32; a float32 scale
//                     per column and no bias), rounded to T once.
//
// In the loop, bf16 products run on tensor cores through WMMA (mma.sync
// underneath) with float32 accumulation; float32 products use plain FMA so
// float32 stays float32. It keeps one tile in flight: the next A/B tile is
// read into registers while the current one is multiplied. The LayerNorm
// applied on load is ln_row_stats' statistics and ln_affine, which
// swin_gemm.cuh's LayerNorm pass shares, so both paths feed the same bf16
// operand.
//
// The int8 branch (the TPU kernels' ``quant``) adds, after the float
// phases below:
//
//   ln_stats_amax_kernel LayerNorm statistics as above, then a third pass
//                     over the row for max |LN(x)| (float32, or rounded to
//                     T first when ln_round), reduced per activation-scale
//                     block with atomicMax on the float bits (non-negative
//                     floats order like their bits as integers);
//   gemm_q8_kernel    out = epilogue(dequant(q(A) W8) + b): the A tile is
//                     quantized on load, q = rint(a * (127 / amax)) with
//                     amax = max|block| + 1e-6 of the row's block; A is
//                     LayerNorm(x) applied on load, a float32 matrix, or a
//                     T matrix; W8 is (N, K) int8 with float32 scales (N,);
//                     products on the tensor cores through mma.sync
//                     m16n8k32 s8 x s8 -> s32; the int32 sum is dequantized
//                     as (float)acc * ((amax / 127) * scale[n]), the bias
//                     added, then T(v), or gelu_as(v) into a float32 matrix
//                     with its per-block absmax, or T(res + T(v)); or (P1)
//                     as (float)acc * ((amax * float32(1/127)) * scale[n])
//                     with no bias, rounded to T;
//   the attention phase (window_attn.cuh) with a window absmax: max |output|
//                     of each window (all heads), and for an odd window the
//                     output of a padded query of the TPU kernel's (w+1)^2
//                     geometry (uniform attention over the w^2 keys), which
//                     enters that absmax on the TPU.

// The int8 epilogues and quantizers use the _rn intrinsics and rintf (no
// FMA contraction), in the JAX code's order of operations.
//
// Constraints, checked by the C entry points: K % 32 == 0 and N % 64 == 0
// for the loops (C % 64 == 0 for the blocks); head_dim 32; window <= 12
// (window_attn.cuh instantiates its strips for N <= 144).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace swin {

constexpr float LN_EPS = 1e-5f;
constexpr int HD = 32;            // head_dim of every Swin variant
constexpr int MAX_WINDOW = 12;
constexpr int THREADS = 256;      // 8 warps, every kernel
constexpr int BM = 128, BN = 64, BK = 32;  // GEMM block tile
constexpr int LDC = BN + 4;       // row stride of the float32 staging tile

namespace {
// this library's attention-phase launches, read by swin_attn_launches
long long attn_launch_count = 0;
}  // namespace

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
  return __float2bfloat16(v);
}
// round to T and back: the value a T-typed intermediate holds
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__host__ __device__ constexpr size_t round128(size_t n) {
  return (n + 127) / 128 * 128;
}

// 16-byte vectors of V elements; every row offset used below is a multiple
// of V and the wrappers pass 16-byte-aligned base pointers
template <typename T> struct Vec {
  static constexpr int V = 16 / sizeof(T);
  static constexpr int PAD = V;  // shared-memory row padding, elements
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// LayerNorm statistics: stats[r] = (mean, rsqrt(var + eps)) of row r of the
// (M, C) matrix x, in float32, the variance from a second pass.

// (mean, rsqrt(var + eps)) of one row xr of C values, reduced over the 32
// lanes of a warp (each lane takes columns lane, lane + 32, ...): the
// bf16 GEMM's LayerNorm, shared by the loop's statistics pass and the
// wgmma path's LayerNorm pass so that both normalise with the same bits
template <typename T>
__device__ __forceinline__ float2 ln_row_stats(const T* xr, int C, int lane) {
  float s = 0.0f;
  for (int c = lane; c < C; c += 32) s += to_f(xr[c]);
  const float mu = warp_sum(s) / C;
  float q = 0.0f;
  for (int c = lane; c < C; c += 32) {
    const float d = to_f(xr[c]) - mu;
    q = fmaf(d, d, q);
  }
  return make_float2(mu, rsqrtf(warp_sum(q) / C + LN_EPS));
}

// LayerNorm of one value with its row's statistics: (v - mu) * rstd, then
// the affine as one FMA (the contraction nvcc makes of nv * g + b)
__device__ __forceinline__ float ln_affine(float v, float2 st, float g,
                                           float b) {
  return fmaf(__fmul_rn(__fsub_rn(v, st.x), st.y), g, b);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ln_stats_kernel(const T* __restrict__ x, float2* __restrict__ stats, int M,
                int C) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (row >= M) return;
  const float2 st = ln_row_stats(x + (size_t)row * C, C, lane);
  if (lane == 0) stats[row] = st;
}

// ---------------------------------------------------------------------------
// GEMM with an optional LayerNorm prologue and a fused epilogue.

enum Epilogue {
  EPI_BIAS = 0,        // out = T(acc + b)
  EPI_BIAS_GELU = 1,   // out = T(gelu_erf(acc + b))
  EPI_ROUND_RES = 2,   // out = T(res + T(acc + b)): K3's proj + residual
  EPI_RES_F32 = 3,     // out = T(acc + b + res): K4's float32 sum
  EPI_SCALE = 4,       // out = T(acc * scale[n]), no bias: P1's int8w
};

// W: the weight's element type, T or (T = bf16 only) int8_t codes
template <typename T, typename W = T> struct GemmArgs {
  const T* a;          // (M, K)
  const float2* stats; // (M,) LayerNorm statistics of a, or null
  const float* gamma;  // (K,) LayerNorm scale, float32
  const float* beta;   // (K,) LayerNorm shift, float32
  const W* w;          // (K, N)
  const T* bias;       // (N,), or null (EPI_SCALE)
  const T* res;        // (M, N) residual, or null
  T* out;              // (M, N)
  int M, N, K;
  const float* scale;  // (N,) float32, EPI_SCALE only
};

// (BM x BN) float32 accumulators of As (BM x BK, stride lda) times
// Bs (BK x BN, stride ldb), both in shared memory.
// bf16: warp w owns rows 32 (w % 4) .. +32 and columns 32 (w / 4) .. +32.
struct MmaBF16 {
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>
      c[2][2];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(c[i][j], 0.0f);
  }
  __device__ void mma(const __nv_bfloat16* As, int lda,
                      const __nv_bfloat16* Bs, int ldb) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32, wm = warp % 4, wn = warp / 4;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + 16 * i) * lda + kk, lda);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * ldb + wn * 32 + 16 * j, ldb);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
    }
  }
  __device__ void store(float* Cs) {
    const int warp = threadIdx.x / 32, wm = warp % 4, wn = warp / 4;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        nvcuda::wmma::store_matrix_sync(
            Cs + (wm * 32 + 16 * i) * LDC + wn * 32 + 16 * j, c[i][j], LDC,
            nvcuda::wmma::mem_row_major);
  }
};

// float32: thread (ty, tx) = (tid / 16, tid % 16) owns rows 8 ty .. +8 and
// columns tx + 16 j, j < 4.
struct MmaF32 {
  float c[8][4];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = 0.0f;
  }
  __device__ void mma(const float* As, int lda, const float* Bs, int ldb) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[(8 * ty + i) * lda + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk * ldb + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
    }
  }
  __device__ void store(float* Cs) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Cs[(8 * ty + i) * LDC + tx + 16 * j] = c[i][j];
  }
};

template <typename T> struct MmaFor;
template <> struct MmaFor<float> { using type = MmaF32; };
template <> struct MmaFor<__nv_bfloat16> { using type = MmaBF16; };

template <typename T> struct GemmTile {
  static constexpr int V = Vec<T>::V;
  static constexpr int LDA = BK + Vec<T>::PAD;
  static constexpr int LDB = BN + Vec<T>::PAD;
  static constexpr int NA = BM * BK / V / THREADS;  // A vectors per thread
  static constexpr int NB = BK * BN / V / THREADS;  // B vectors per thread
  static constexpr size_t A_BYTES = round128(sizeof(T) * BM * LDA);
  static constexpr size_t AB_BYTES = A_BYTES + round128(sizeof(T) * BK * LDB);
  static constexpr size_t C_BYTES = sizeof(float) * BM * LDC;
  // the float32 staging tile reuses the A/B tiles once the K loop is done
  static constexpr size_t SMEM = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;
};

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.7071067811865476f));
}

template <typename T, bool LN, int EPI, typename W = T>
__global__ void __launch_bounds__(THREADS) gemm_kernel(GemmArgs<T, W> p) {
  using Tile = GemmTile<T>;
  using Mma = typename MmaFor<T>::type;
  constexpr int V = Tile::V;
  // int8 weight codes: 16 a vector, read by the first BK * BN / 16 threads
  // and widened to bf16 (exact for |code| <= 256) when stashed
  constexpr bool W8 = sizeof(W) == 1;
  constexpr int W8_VECS = BK * BN / 16;
  static_assert(!W8 || (sizeof(T) == 2 && Tile::NB == 1),
                "int8 weights are widened to bf16 only");
  __shared__ __align__(128) unsigned char smem[Tile::SMEM];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + Tile::A_BYTES);
  float* Cs = reinterpret_cast<float*>(smem);

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  uint4 ra[Tile::NA], rb[Tile::NB];

  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < Tile::NA; ++i) {
      const int v = tid + i * THREADS;
      const int r = v / (BK / V), c = (v % (BK / V)) * V;
      ra[i] = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < p.M)
        ra[i] = *reinterpret_cast<const uint4*>(
            p.a + (size_t)(m0 + r) * p.K + k0 + c);
    }
    if constexpr (W8) {
      const int r = tid / (BN / 16), c = (tid % (BN / 16)) * 16;
      if (tid < W8_VECS)
        rb[0] = *reinterpret_cast<const uint4*>(
            p.w + (size_t)(k0 + r) * p.N + n0 + c);
    } else {
#pragma unroll
      for (int i = 0; i < Tile::NB; ++i) {
        const int v = tid + i * THREADS;
        const int r = v / (BN / V), c = (v % (BN / V)) * V;
        rb[i] = *reinterpret_cast<const uint4*>(
            p.w + (size_t)(k0 + r) * p.N + n0 + c);
      }
    }
  };
  auto stash = [&](int k0) {
#pragma unroll
    for (int i = 0; i < Tile::NA; ++i) {
      const int v = tid + i * THREADS;
      const int r = v / (BK / V), c = (v % (BK / V)) * V;
      T* dst = As + r * Tile::LDA + c;
      if (LN) {
        // LayerNorm on load, float32, rounded to T; rows past M stay zero
        const T* e = reinterpret_cast<const T*>(&ra[i]);
        float2 st = make_float2(0.0f, 0.0f);
        if (m0 + r < p.M) st = p.stats[m0 + r];
#pragma unroll
        for (int j = 0; j < V; ++j)
          dst[j] = from_f<T>(m0 + r < p.M ? ln_affine(to_f(e[j]), st,
                                                      p.gamma[k0 + c + j],
                                                      p.beta[k0 + c + j])
                                          : 0.0f);
      } else {
        *reinterpret_cast<uint4*>(dst) = ra[i];
      }
    }
    if constexpr (W8) {
      if (tid < W8_VECS) {
        const int r = tid / (BN / 16), c = (tid % (BN / 16)) * 16;
        const int8_t* e = reinterpret_cast<const int8_t*>(&rb[0]);
        uint32_t wide[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const __nv_bfloat162 two =
              __floats2bfloat162_rn((float)e[2 * j], (float)e[2 * j + 1]);
          wide[j] = *reinterpret_cast<const uint32_t*>(&two);
        }
        uint4* dst = reinterpret_cast<uint4*>(Bs + r * Tile::LDB + c);
        dst[0] = make_uint4(wide[0], wide[1], wide[2], wide[3]);
        dst[1] = make_uint4(wide[4], wide[5], wide[6], wide[7]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < Tile::NB; ++i) {
        const int v = tid + i * THREADS;
        const int r = v / (BN / V), c = (v % (BN / V)) * V;
        *reinterpret_cast<uint4*>(Bs + r * Tile::LDB + c) = rb[i];
      }
    }
  };

  Mma acc;
  acc.zero();
  load(0);
  for (int k0 = 0; k0 < p.K; k0 += BK) {
    stash(k0);
    __syncthreads();
    if (k0 + BK < p.K) load(k0 + BK);  // next tile in flight meanwhile
    acc.mma(As, Tile::LDA, Bs, Tile::LDB);
    __syncthreads();
  }
  acc.store(Cs);
  __syncthreads();

  for (int i = tid; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    if (m0 + r >= p.M) continue;
    const size_t o = (size_t)(m0 + r) * p.N + n0 + c;
    if constexpr (EPI == EPI_SCALE) {
      p.out[o] = from_f<T>(__fmul_rn(Cs[r * LDC + c], p.scale[n0 + c]));
      continue;
    }
    const float v = Cs[r * LDC + c] + to_f(p.bias[n0 + c]);
    float out;
    if (EPI == EPI_BIAS) {
      out = v;
    } else if (EPI == EPI_BIAS_GELU) {
      out = gelu_erf(v);
    } else if (EPI == EPI_ROUND_RES) {
      out = to_f(p.res[o]) + round_to<T>(v);
    } else {
      out = v + to_f(p.res[o]);
    }
    p.out[o] = from_f<T>(out);
  }
}

// ---------------------------------------------------------------------------
// Host side: the phases launched in order on one stream. Each returns the
// first CUDA error (cudaSuccess when every launch was accepted).

template <typename T>
cudaError_t ln_stats(const T* x, float2* stats, int M, int C,
                     cudaStream_t s) {
  const int rows = THREADS / 32;
  ln_stats_kernel<T><<<(M + rows - 1) / rows, THREADS, 0, s>>>(x, stats, M,
                                                                C);
  return cudaGetLastError();
}

template <typename T, bool LN, int EPI, typename W = T>
cudaError_t gemm(const GemmArgs<T, W>& p, cudaStream_t s) {
  if (p.M <= 0 || p.K % BK || p.N % BN || (p.M + BM - 1) / BM > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid(p.N / BN, (p.M + BM - 1) / BM);
  gemm_kernel<T, LN, EPI, W><<<grid, THREADS, 0, s>>>(p);
  return cudaGetLastError();
}

inline bool block_shape_ok(int B, int Hp, int Wp, int C, int heads, int w) {
  return B > 0 && w > 0 && w <= MAX_WINDOW && Hp % w == 0 && Wp % w == 0 &&
         Hp > 0 && Wp > 0 && C % 64 == 0 && heads > 0 && C == heads * HD &&
         (long long)B * (Hp / w) * (Wp / w) <= 2147483647LL && heads <= 65535;
}

// ---------------------------------------------------------------------------
// The int8 branch.

// which activation-scale block token row m belongs to: contiguous blocks of
// blk rows (w == 0), or the windows of a (B, Hp, Wp) map (w > 0), numbered
// as the attention phase's blocks are
struct ScaleMap {
  int blk, Hp, Wp, w;
  __device__ __forceinline__ int operator()(int m) const {
    if (w == 0) return m / blk;
    const int per = Hp * Wp, r = m % per;
    return ((m / per) * (Hp / w) + (r / Wp) / w) * (Wp / w) + (r % Wp) / w;
  }
};

// amax = max|block| + 1e-6 from the block's stored float bits
__device__ __forceinline__ float block_amax(const int* amax, int id) {
  return __fadd_rn(__int_as_float(amax[id]), 1e-6f);
}

__device__ __forceinline__ float ln_apply(float v, float2 st, float g,
                                          float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, st.x), st.y), g), b);
}

// the JAX _gelu_exact: x Phi(x) with the Abramowitz-Stegun 7.1.26 erf
__device__ __forceinline__ float gelu_as(float x) {
  const float z = __fmul_rn(x, 0.7071067811865476f);
  const float sg = z > 0.0f ? 1.0f : (z < 0.0f ? -1.0f : 0.0f);
  const float a = fabsf(z);
  const float t =
      __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(0.3275911f, a)));
  float p = __fadd_rn(-1.453152027f, __fmul_rn(t, 1.061405429f));
  p = __fadd_rn(1.421413741f, __fmul_rn(t, p));
  p = __fadd_rn(-0.284496736f, __fmul_rn(t, p));
  p = __fmul_rn(t, __fadd_rn(0.254829592f, __fmul_rn(t, p)));
  const float erf =
      __fmul_rn(sg, __fsub_rn(1.0f, __fmul_rn(p, expf(__fmul_rn(-a, a)))));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, erf));
}

// LayerNorm statistics (as ln_stats_kernel, without FMA contraction) and
// the per-block absmax of the normed rows.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ln_stats_amax_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, float2* __restrict__ stats,
                     int* __restrict__ amax, int M, int C, int blk,
                     bool ln_round) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (row >= M) return;
  const T* xr = x + (size_t)row * C;
  float s = 0.0f;
  for (int c = lane; c < C; c += 32) s = __fadd_rn(s, to_f(xr[c]));
  const float mu = __fdiv_rn(warp_sum(s), (float)C);
  float q = 0.0f;
  for (int c = lane; c < C; c += 32) {
    const float d = __fsub_rn(to_f(xr[c]), mu);
    q = __fadd_rn(q, __fmul_rn(d, d));
  }
  const float2 st = make_float2(
      mu, __frsqrt_rn(__fadd_rn(__fdiv_rn(warp_sum(q), (float)C), LN_EPS)));
  float m = 0.0f;
  for (int c = lane; c < C; c += 32) {
    float v = ln_apply(to_f(xr[c]), st, gamma[c], beta[c]);
    if (ln_round) v = round_to<T>(v);
    m = fmaxf(m, fabsf(v));
  }
  m = warp_max(m);
  if (lane == 0) {
    stats[row] = st;
    atomicMax(amax + row / blk, __float_as_int(m));
  }
}

enum Q8Source {
  Q8_LN = 0,   // A = LayerNorm(x) applied on load, x in T
  Q8_F32 = 1,  // A is a float32 matrix
  Q8_T = 2,    // A is a T matrix
};
enum Q8Epilogue {
  Q8E_BIAS = 0,       // out = T(v)
  Q8E_GELU_AMAX = 1,  // out = gelu_as(v) in float32, and its block absmax
  Q8E_ROUND_RES = 2,  // out = T(res + T(v))
  Q8E_SCALE = 3,      // out = T(acc * ((amax * float32(1/127)) * scale)),
                      // no bias: P1's int8 (XLA's order for amax / 127)
};

template <typename T> struct Q8Args {
  const void* a;        // (M, K), T or float32
  const float2* stats;  // Q8_LN: LayerNorm statistics of a
  const float* gamma;   // Q8_LN: (K,) float32
  const float* beta;
  const int* a_amax;    // per-block max |A| (float bits)
  ScaleMap a_map;
  const int8_t* w;      // (N, K) int8 codes
  const float* wscale;  // (N,) float32
  const T* bias;        // (N,), or null (Q8E_SCALE)
  const T* res;         // (M, N), Q8E_ROUND_RES
  void* out;            // (M, N): float32 for Q8E_GELU_AMAX, else T
  int* out_amax;        // Q8E_GELU_AMAX: per-block max |out|, contiguous
  int out_blk;          // blocks of out_blk rows
  int M, N, K;
  bool ln_round;        // Q8_LN: LN rounded to T before it is quantized
};

constexpr int Q8_LDS = BK + 16;  // 48-byte rows: conflict-free fragments
constexpr float Q8_INV127 = 0.007874015718698502f;  // float32(1 / 127)

__device__ __forceinline__ uint32_t q8_code(float v, float inv) {
  float q = rintf(__fmul_rn(v, inv));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return (uint32_t)(uint8_t)(int8_t)(int)q;
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// eight consecutive A values of row r at column k, as float32
template <typename T, int SRC>
__device__ __forceinline__ void load8(const Q8Args<T>& p, int r, int k,
                                      float* v) {
  if (SRC == Q8_F32) {
    const float* a = static_cast<const float*>(p.a) + (size_t)r * p.K + k;
    const float4 u = *reinterpret_cast<const float4*>(a);
    const float4 t = *reinterpret_cast<const float4*>(a + 4);
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
    v[4] = t.x, v[5] = t.y, v[6] = t.z, v[7] = t.w;
  } else {
    const T* a = static_cast<const T*>(p.a) + (size_t)r * p.K + k;
#pragma unroll
    for (int h = 0; h < 8; h += Vec<T>::V) {
      const uint4 u = *reinterpret_cast<const uint4*>(a + h);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < Vec<T>::V; ++j) v[h + j] = to_f(e[j]);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* dst, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* dst,
                                                      float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// One block of 256 threads (8 warps, 4 x 2) per 128 x 64 output tile; each
// warp owns 32 x 32 (2 x 4 MMA tiles); 32-deep K slices, no pipelining.
template <typename T, int SRC, int EPI>
__global__ void __launch_bounds__(THREADS) gemm_q8_kernel(Q8Args<T> p) {
  __shared__ __align__(16) int8_t As[BM * Q8_LDS];
  __shared__ __align__(16) int8_t Bs[BN * Q8_LDS];
  __shared__ int smax[BM];  // Q8E_GELU_AMAX: the tile's block absmaxes
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (EPI == Q8E_GELU_AMAX && tid < BM) smax[tid] = 0;

  // the two A rows this thread fills, at k offset 8 (tid % 4) of a slice
  const int kc = (tid % 4) * 8;
  int arow[2];
  bool valid[2];
  float inv[2];
  float2 st[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    arow[j] = tid / 4 + 64 * j;
    const int m = m0 + arow[j];
    valid[j] = m < p.M;
    inv[j] = 0.0f;
    st[j] = make_float2(0.0f, 0.0f);
    if (valid[j]) {
      inv[j] = __fdiv_rn(127.0f, block_amax(p.a_amax, p.a_map(m)));
      if (SRC == Q8_LN) st[j] = p.stats[m];
    }
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
    const int k = k0 + kc;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint2 codes = make_uint2(0u, 0u);
      if (valid[j]) {
        float v[8];
        load8<T, SRC>(p, m0 + arow[j], k, v);
        uint32_t word[2] = {0u, 0u};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float a = v[e];
          if (SRC == Q8_LN) {
            a = ln_apply(a, st[j], p.gamma[k + e], p.beta[k + e]);
            if (p.ln_round) a = round_to<T>(a);
          }
          word[e / 4] |= q8_code(a, inv[j]) << (8 * (e % 4));
        }
        codes = make_uint2(word[0], word[1]);
      }
      *reinterpret_cast<uint2*>(As + arow[j] * Q8_LDS + kc) = codes;
    }
    if (tid < 128) {  // B: 64 output channels x 32 bytes of K
      const int row = tid / 2, kb = (tid % 2) * 16;
      *reinterpret_cast<uint4*>(Bs + row * Q8_LDS + kb) =
          *reinterpret_cast<const uint4*>(p.w + (size_t)(n0 + row) * p.K +
                                          k0 + kb);
    }
    __syncthreads();

    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int8_t* base = As + (wm * 32 + i * 16 + g) * Q8_LDS + tig * 4;
      a[i][0] = *reinterpret_cast<const uint32_t*>(base);
      a[i][1] = *reinterpret_cast<const uint32_t*>(base + 8 * Q8_LDS);
      a[i][2] = *reinterpret_cast<const uint32_t*>(base + 16);
      a[i][3] = *reinterpret_cast<const uint32_t*>(base + 8 * Q8_LDS + 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int8_t* base = Bs + (wn * 32 + j * 8 + g) * Q8_LDS + tig * 4;
      b[j][0] = *reinterpret_cast<const uint32_t*>(base);
      b[j][1] = *reinterpret_cast<const uint32_t*>(base + 16);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    __syncthreads();
  }

  // epilogue, from the registers: rows (i, h), columns (j, cc)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 32 + i * 16 + g + 8 * h;
      float rmax = 0.0f;
      if (m < p.M) {
        const float amax = block_amax(p.a_amax, p.a_map(m));
        const float as = EPI == Q8E_SCALE ? __fmul_rn(amax, Q8_INV127)
                                          : __fdiv_rn(amax, 127.0f);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + wn * 32 + j * 8 + tig * 2;
          const size_t o = (size_t)m * p.N + n;
          float v[2];
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            v[cc] = __fmul_rn(__int2float_rn(acc[i][j][2 * h + cc]),
                              __fmul_rn(as, p.wscale[n + cc]));
            if (EPI != Q8E_SCALE)
              v[cc] = __fadd_rn(v[cc], to_f(p.bias[n + cc]));
            if (EPI == Q8E_GELU_AMAX) {
              v[cc] = gelu_as(v[cc]);
              rmax = fmaxf(rmax, fabsf(v[cc]));
            } else if (EPI == Q8E_ROUND_RES) {
              v[cc] = __fadd_rn(to_f(p.res[o + cc]), round_to<T>(v[cc]));
            }
          }
          if (EPI == Q8E_GELU_AMAX)
            store2<float>(static_cast<float*>(p.out) + o, v[0], v[1]);
          else
            store2<T>(static_cast<T*>(p.out) + o, v[0], v[1]);
        }
      }
      if (EPI == Q8E_GELU_AMAX) {
        // the row's max over this warp's 32 columns, then the tile's
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 2));
        if (tig == 0 && m < p.M)
          atomicMax(smax + (m / p.out_blk - m0 / p.out_blk),
                    __float_as_int(rmax));
      }
    }
  }
  if (EPI == Q8E_GELU_AMAX) {
    __syncthreads();
    const int last = min(m0 + BM, p.M) - 1;
    if (tid <= last / p.out_blk - m0 / p.out_blk && smax[tid] > 0)
      atomicMax(p.out_amax + m0 / p.out_blk + tid, smax[tid]);
  }
}

template <typename T>
cudaError_t ln_stats_amax(const T* x, const float* gamma, const float* beta,
                          float2* stats, int* amax, int M, int C, int blk,
                          bool ln_round, cudaStream_t s) {
  const int rows = THREADS / 32;
  ln_stats_amax_kernel<T><<<(M + rows - 1) / rows, THREADS, 0, s>>>(
      x, gamma, beta, stats, amax, M, C, blk, ln_round);
  return cudaGetLastError();
}

template <typename T, int SRC, int EPI>
cudaError_t gemm_q8(const Q8Args<T>& p, cudaStream_t s) {
  if (p.M <= 0 || p.K % BK || p.N % BN || (p.M + BM - 1) / BM > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid(p.N / BN, (p.M + BM - 1) / BM);
  gemm_q8_kernel<T, SRC, EPI><<<grid, THREADS, 0, s>>>(p);
  return cudaGetLastError();
}

}  // namespace swin

#include "window_attn.cuh"
