// The previous design of K1 (PR 1's port), kept for timings only: the
// current design is csrc/dilated_residual.cu. Only the
// dilated_residual_prev_launch entry point launches it in bf16; the current
// entry point still runs its float32 kernel (FMA, so float32 stays
// float32).
//
// One block of 256 threads (8 warps) per (b, tile of BT = 32 rows). Phase 1
// walks the hidden columns in chunks of NC = 128; for each chunk it
// accumulates 3 taps x C/KC depth chunks of (BT x KC) x (KC x NC) products,
// then adds b1, applies relu and stores the chunk in the compute dtype into
// the shared hidden tile Hs (BT x C). Phase 2 walks the output columns in
// the same chunks: Hs x W2, then + b2 + x, stored to y. bf16 products use
// WMMA with float32 accumulation; float32 products plain FMA. Each tap is
// its own masked tile load, so dilations at or beyond T need no padding.
//
// Constraint: C % 128 == 0 and C <= 1024 (dynamic shared memory: Hs is
// BT x (C + 8) elements, 65 KB at C = 512 in f32; 127 KB in all).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace k1prev {
namespace {  // internal linkage: smem_once's flags are this library's

constexpr int BT = 32;        // rows (time steps) per block
constexpr int NC = 128;       // output-column chunk
constexpr int KC = 64;        // reduction-depth chunk
constexpr int THREADS = 256;  // 8 warps
constexpr int PAD = 8;        // shared-memory row padding, in elements
constexpr int LDO = NC + 4;   // row stride of the float32 staging tile

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

// (BT x NC) float32 accumulator of A (BT x KC, row stride lda) times
// B (KC x NC, row stride ldb), both in shared memory.
// bf16: warp w owns output columns [16w, 16w + 16) of both 16-row tiles.
struct AccBF16 {
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> c[2];

  __device__ void zero() {
    nvcuda::wmma::fill_fragment(c[0], 0.0f);
    nvcuda::wmma::fill_fragment(c[1], 0.0f);
  }
  __device__ void mma(const __nv_bfloat16* A, int lda,
                      const __nv_bfloat16* B, int ldb) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int ks = 0; ks < KC; ks += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b;
      wmma::load_matrix_sync(b, B + ks * ldb + warp * 16, ldb);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::load_matrix_sync(a, A + i * 16 * lda + ks, lda);
        wmma::mma_sync(c[i], a, b, c[i]);
      }
    }
  }
  __device__ void store(float* O) {
    const int warp = threadIdx.x / 32;
    for (int i = 0; i < 2; ++i)
      nvcuda::wmma::store_matrix_sync(O + i * 16 * LDO + warp * 16, c[i],
                                      LDO, nvcuda::wmma::mem_row_major);
  }
};

// float32: thread (ty, tx) owns rows 4ty..4ty+3 and columns tx + 32j.
// The rows are the same across a warp, so A reads are broadcasts.
struct AccF32 {
  float c[4][4];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = 0.0f;
  }
  __device__ void mma(const float* A, int lda, const float* B, int ldb) {
    const int ty = threadIdx.x / 32, tx = threadIdx.x % 32;
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = A[(4 * ty + i) * lda + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = B[kk * ldb + tx + 32 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
    }
  }
  __device__ void store(float* O) {
    const int ty = threadIdx.x / 32, tx = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) O[(4 * ty + i) * LDO + tx + 32 * j] = c[i][j];
  }
};

template <typename T> struct AccFor;
template <> struct AccFor<float> { using type = AccF32; };
template <> struct AccFor<__nv_bfloat16> { using type = AccBF16; };

__host__ __device__ constexpr size_t round128(size_t n) {
  return (n + 127) / 128 * 128;
}

// Shared-memory carve-up: Hs (BT x C+PAD, T), Xs (BT x KC+PAD, T),
// Ws (KC x NC+PAD, T), Os (BT x LDO, float). Each region starts on a
// 128-byte boundary; WMMA needs 32.
template <typename T> __host__ __device__ size_t smem_bytes(int C) {
  return round128(sizeof(T) * BT * (C + PAD)) +
         round128(sizeof(T) * BT * (KC + PAD)) +
         round128(sizeof(T) * KC * (NC + PAD)) +
         round128(sizeof(float) * BT * LDO);
}

// Tiles move in 16-byte vectors of V elements. Every row offset is a
// multiple of V (C % 128 == 0, PAD % V == 0) and the wrapper passes
// 16-byte-aligned base pointers.
template <typename T> struct Vec { static constexpr int V = 16 / sizeof(T); };

// Ws[r][c] = W[k0 + r][n0 + c] for a (KC x NC) tile of a (C x C) matrix.
template <typename T>
__device__ __forceinline__ void load_w_tile(T* Ws, const T* __restrict__ W,
                                            int C, int k0, int n0) {
  constexpr int V = Vec<T>::V;
  for (int i = threadIdx.x; i < KC * NC / V; i += THREADS) {
    const int r = i / (NC / V), c = (i % (NC / V)) * V;
    *reinterpret_cast<uint4*>(Ws + r * (NC + PAD) + c) =
        *reinterpret_cast<const uint4*>(W + (size_t)(k0 + r) * C + n0 + c);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dilated_residual_kernel(const T* __restrict__ x, const T* __restrict__ w_taps,
                        const T* __restrict__ b1, const T* __restrict__ w2,
                        const T* __restrict__ b2, T* __restrict__ y, int T_len,
                        int C, int dilation, int causal) {
  using Acc = typename AccFor<T>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldh = C + PAD, ldx = KC + PAD, ldw = NC + PAD;
  T* Hs = reinterpret_cast<T*>(smem);
  T* Xs = reinterpret_cast<T*>(smem + round128(sizeof(T) * BT * ldh));
  T* Ws = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(Xs) +
                               round128(sizeof(T) * BT * ldx));
  float* Os = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(Ws) +
                                       round128(sizeof(T) * KC * ldw));

  const int t0 = blockIdx.x * BT;
  const size_t base = (size_t)blockIdx.y * T_len * C;
  const T* xb = x + base;
  T* yb = y + base;
  int off[3];
  if (causal) {
    off[0] = -2 * dilation; off[1] = -dilation; off[2] = 0;
  } else {
    off[0] = -dilation; off[1] = 0; off[2] = dilation;
  }

  // Phase 1: Hs = relu(sum_k shift_k(x) W_k + b1), in the compute dtype.
  for (int n0 = 0; n0 < C; n0 += NC) {
    Acc acc;
    acc.zero();
    for (int k = 0; k < 3; ++k) {
      const T* wk = w_taps + (size_t)k * C * C;
      for (int k0 = 0; k0 < C; k0 += KC) {
        // shifted rows of x; rows outside [0, T) are the zero padding
        constexpr int V = Vec<T>::V;
        for (int i = threadIdx.x; i < BT * KC / V; i += THREADS) {
          const int r = i / (KC / V), c = (i % (KC / V)) * V;
          const int src = t0 + r + off[k];
          uint4 v = make_uint4(0u, 0u, 0u, 0u);  // all-zero bits: 0.0
          if (t0 + r < T_len && src >= 0 && src < T_len)
            v = *reinterpret_cast<const uint4*>(xb + (size_t)src * C + k0 + c);
          *reinterpret_cast<uint4*>(Xs + r * ldx + c) = v;
        }
        load_w_tile(Ws, wk, C, k0, n0);
        __syncthreads();
        acc.mma(Xs, ldx, Ws, ldw);
        __syncthreads();
      }
    }
    acc.store(Os);
    __syncthreads();
    for (int i = threadIdx.x; i < BT * NC; i += THREADS) {
      const int r = i / NC, c = i % NC;
      const float h = Os[r * LDO + c] + to_f(b1[n0 + c]);
      Hs[r * ldh + n0 + c] = from_f<T>(h > 0.0f ? h : 0.0f);
    }
    __syncthreads();
  }

  // Phase 2: y = x + Hs W2 + b2.
  for (int n0 = 0; n0 < C; n0 += NC) {
    Acc acc;
    acc.zero();
    for (int k0 = 0; k0 < C; k0 += KC) {
      load_w_tile(Ws, w2, C, k0, n0);
      __syncthreads();
      acc.mma(Hs + k0, ldh, Ws, ldw);
      __syncthreads();
    }
    acc.store(Os);
    __syncthreads();
    for (int i = threadIdx.x; i < BT * NC; i += THREADS) {
      const int r = i / NC, c = i % NC;
      if (t0 + r < T_len) {
        const size_t idx = (size_t)(t0 + r) * C + n0 + c;
        yb[idx] = from_f<T>(to_f(xb[idx]) + Os[r * LDO + c] +
                            to_f(b2[n0 + c]));
      }
    }
    __syncthreads();
  }
}

// The shared-memory attribute of the kernel for T, set once per device.
template <typename T>
cudaError_t smem_once(size_t bytes) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(dilated_residual_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess && dev < 64) done[dev] = true;
  return e;
}

template <typename T>
int launch(const void* x, const void* w_taps, const void* b1, const void* w2,
           const void* b2, void* y, int B, int T_len, int C, int dilation,
           int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(C);
  // the attribute for the largest C the kernel takes, once
  const cudaError_t err = smem_once<T>(smem_bytes<T>(1024));
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T_len + BT - 1) / BT, B);
  dilated_residual_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_taps),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(y), T_len, C, dilation,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace k1prev
