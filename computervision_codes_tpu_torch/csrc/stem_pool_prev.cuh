// The previous design of K2 (PR 2's port), kept for timings only: the
// current design is csrc/stem_pool.cu. Only the stem_pool_prev_launch entry
// point launches it in bf16; the current entry point still runs its
// float32 kernel (FMA, so float32 stays float32).
//
// One block of 256 threads per (frame, tile of PR x PC pooled outputs). The
// tile needs CR x CC = (2 PR + 1) x (2 PC + 1) conv outputs (the pool
// windows overlap by one row and column) and an input halo of
// (4 PR + 7) x (4 PC + 7) pixels. The block stages the halo, builds the
// im2col tile A (M = CR * CC rows padded to 160, K = 147 padded to 160)
// and the weight tile B (160 x 64), multiplies them into a float32 tile
// C (WMMA in bf16, FMA in float32), applies bias, ReLU and rounding, zeroes
// the pool's top and left padding, and writes the pooled maxima.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace k2prev {
namespace {  // internal linkage: smem_once's flags are this library's

constexpr int PR = 4;               // pooled rows per block
constexpr int PC = 8;               // pooled columns per block
constexpr int CR = 2 * PR + 1;      // conv rows per block
constexpr int CC = 2 * PC + 1;      // conv columns per block
constexpr int IR = 4 * PR + 7;      // input halo rows
constexpr int IC = 4 * PC + 7;      // input halo columns
constexpr int CIN = 3;
constexpr int COUT = 64;
constexpr int M = CR * CC;          // 153 conv outputs per block
constexpr int MP = 160;             // M padded to the 16-row MMA tile
constexpr int K = 49 * CIN;         // 147
constexpr int KP = 160;             // K padded to the 16-deep MMA step
constexpr int THREADS = 256;
constexpr int LDC = COUT + 4;       // row stride of the float32 C tile

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

template <typename T> struct Layout;
template <> struct Layout<__nv_bfloat16> {
  static constexpr int LDA = KP + 8;    // multiple of 8 elements for WMMA
  static constexpr int LDB = COUT + 8;
};
template <> struct Layout<float> {
  static constexpr int LDA = KP + 4;
  static constexpr int LDB = COUT + 4;  // float4 rows stay 16-byte aligned
};

__host__ __device__ constexpr size_t round128(size_t n) {
  return (n + 127) / 128 * 128;
}

// Shared memory: A (MP x LDA, T) whose bytes C (MP x LDC, float) reuses
// once the product is done, B (KP x LDB, T), the input halo Xs (IR x IC x 3,
// T). Each region starts on a 128-byte boundary; WMMA needs 32.
template <typename T> __host__ __device__ size_t a_bytes() {
  const size_t a = sizeof(T) * MP * Layout<T>::LDA;
  const size_t c = sizeof(float) * MP * LDC;
  return round128(a > c ? a : c);
}
template <typename T> __host__ __device__ size_t smem_bytes() {
  return a_bytes<T>() + round128(sizeof(T) * KP * Layout<T>::LDB) +
         round128(sizeof(T) * IR * IC * CIN);
}

// C = A x B for bf16: 10 x 4 tiles of 16 x 16; warp w owns column tile
// w % 4 and row tiles w / 4 + 2 t, t = 0..4.
__device__ void conv_product(const __nv_bfloat16* A, const __nv_bfloat16* B,
                             float* C) {
  using namespace nvcuda;
  constexpr int LDA = Layout<__nv_bfloat16>::LDA;
  constexpr int LDB = Layout<__nv_bfloat16>::LDB;
  const int warp = threadIdx.x / 32;
  const int nt = warp % 4;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[5];
#pragma unroll
  for (int t = 0; t < 5; ++t) wmma::fill_fragment(acc[t], 0.0f);
#pragma unroll 2
  for (int k0 = 0; k0 < KP; k0 += 16) {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                   wmma::row_major> b;
    wmma::load_matrix_sync(b, B + k0 * LDB + nt * 16, LDB);
#pragma unroll
    for (int t = 0; t < 5; ++t) {
      const int mt = warp / 4 + 2 * t;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::load_matrix_sync(a, A + mt * 16 * LDA + k0, LDA);
      wmma::mma_sync(acc[t], a, b, acc[t]);
    }
  }
  __syncthreads();  // C reuses A's bytes: every warp has finished reading A
#pragma unroll
  for (int t = 0; t < 5; ++t) {
    const int mt = warp / 4 + 2 * t;
    wmma::store_matrix_sync(C + mt * 16 * LDC + nt * 16, acc[t], LDC,
                            wmma::mem_row_major);
  }
}

// C = A x B for float32 with FMA: thread t owns output channels
// 4 (t % 16) .. + 3 and rows 10 (t / 16) .. + 9.
__device__ void conv_product(const float* A, const float* B, float* C) {
  constexpr int LDA = Layout<float>::LDA;
  constexpr int LDB = Layout<float>::LDB;
  const int cg = threadIdx.x % 16, mg = threadIdx.x / 16;
  float acc[10][4];
#pragma unroll
  for (int i = 0; i < 10; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 3
  for (int k = 0; k < K; ++k) {
    const float4 b = *reinterpret_cast<const float4*>(B + k * LDB + 4 * cg);
#pragma unroll
    for (int i = 0; i < 10; ++i) {
      const float a = A[(10 * mg + i) * LDA + k];
      acc[i][0] = fmaf(a, b.x, acc[i][0]);
      acc[i][1] = fmaf(a, b.y, acc[i][1]);
      acc[i][2] = fmaf(a, b.z, acc[i][2]);
      acc[i][3] = fmaf(a, b.w, acc[i][3]);
    }
  }
  __syncthreads();  // C reuses A's bytes
#pragma unroll
  for (int i = 0; i < 10; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) C[(10 * mg + i) * LDC + 4 * cg + j] = acc[i][j];
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
stem_pool_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const float* __restrict__ bias, T* __restrict__ y, int H,
                 int W) {
  constexpr int LDA = Layout<T>::LDA;
  constexpr int LDB = Layout<T>::LDB;
  extern __shared__ __align__(128) unsigned char smem[];
  T* A = reinterpret_cast<T*>(smem);
  float* C = reinterpret_cast<float*>(smem);
  T* B = reinterpret_cast<T*>(smem + a_bytes<T>());
  T* Xs = reinterpret_cast<T*>(smem + a_bytes<T>() +
                               round128(sizeof(T) * KP * LDB));

  const int PH = H / 4, PW = W / 4;
  const int p0 = blockIdx.y * PR, q0 = blockIdx.x * PC;
  const T* xf = x + (size_t)blockIdx.z * H * W * CIN;
  T* yf = y + (size_t)blockIdx.z * PH * PW * COUT;
  const T zero = from_f<T>(0.0f);

  // input halo: rows 4 p0 - 5 .., columns 4 q0 - 5 ..; outside the frame
  // is the conv's zero padding
  const int r0 = 4 * p0 - 5, c0 = 4 * q0 - 5;
  for (int i = threadIdx.x; i < IR * IC * CIN; i += THREADS) {
    const int r = i / (IC * CIN), rem = i % (IC * CIN);
    const int gr = r0 + r, gc = c0 + rem / CIN;
    Xs[i] = (gr >= 0 && gr < H && gc >= 0 && gc < W)
                ? xf[((size_t)gr * W + gc) * CIN + rem % CIN]
                : zero;
  }
  // weights: B[k][o] = w[k][o], k = (dy * 7 + dx) * 3 + ch; rows K.. zero
  for (int i = threadIdx.x; i < KP * COUT; i += THREADS) {
    const int k = i / COUT, o = i % COUT;
    B[k * LDB + o] = k < K ? w[i] : zero;
  }
  __syncthreads();
  // im2col: A[m][k] for conv output m = (i, j) of the tile
  for (int e = threadIdx.x; e < MP * KP; e += THREADS) {
    const int m = e / KP, k = e % KP;
    T v = zero;
    if (m < M && k < K) {
      const int i = m / CC, j = m % CC;
      const int tap = k / CIN, ch = k % CIN;
      const int dy = tap / 7, dx = tap % 7;
      v = Xs[((2 * i + dy) * IC + 2 * j + dx) * CIN + ch];
    }
    A[m * LDA + k] = v;
  }
  __syncthreads();

  conv_product(A, B, C);
  __syncthreads();

  // bias, ReLU, rounding to T; conv row or column -1 is the pool's zero pad
  for (int e = threadIdx.x; e < M * COUT; e += THREADS) {
    const int m = e / COUT, o = e % COUT;
    const int i = m / CC, j = m % CC;
    float v = 0.0f;
    if (2 * p0 - 1 + i >= 0 && 2 * q0 - 1 + j >= 0) {
      v = fmaxf(C[m * LDC + o] + bias[o], 0.0f);
      v = to_f(from_f<T>(v));
    }
    C[m * LDC + o] = v;
  }
  __syncthreads();

  // 3x3 / stride 2 max over the tile's conv cells
  for (int e = threadIdx.x; e < PR * PC * COUT; e += THREADS) {
    const int pi = e / (PC * COUT), rem = e % (PC * COUT);
    const int pj = rem / COUT, o = rem % COUT;
    const int p = p0 + pi, q = q0 + pj;
    if (p >= PH || q >= PW) continue;
    float v = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b)
        v = fmaxf(v, C[((2 * pi + a) * CC + 2 * pj + b) * LDC + o]);
    yf[((size_t)p * PW + q) * COUT + o] = from_f<T>(v);
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
  e = cudaFuncSetAttribute(stem_pool_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess && dev < 64) done[dev] = true;
  return e;
}

template <typename T>
int launch(const void* x, const void* w, const void* bias, void* y, int N,
           int H, int W, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>();
  cudaError_t err = smem_once<T>(smem);
  if (err != cudaSuccess) return (int)err;
  const int PH = H / 4, PW = W / 4;
  // grid.z is at most 65535: launch the frames in groups of that many
  for (int n0 = 0; n0 < N; n0 += 65535) {
    const int n = N - n0 < 65535 ? N - n0 : 65535;
    const dim3 grid((PW + PC - 1) / PC, (PH + PR - 1) / PR, n);
    stem_pool_kernel<T><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(x) + (size_t)n0 * H * W * CIN,
        static_cast<const T*>(w), static_cast<const float*>(bias),
        static_cast<T*>(y) + (size_t)n0 * PH * PW * COUT, H, W);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace
}  // namespace k2prev
