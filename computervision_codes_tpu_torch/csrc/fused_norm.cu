// K9: fused scale-bias-activation, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// computervision_codes_tpu/ops/fused_norm.py::fused_scale_bias_act (its
// _fsba_kernel), the eval form of TResNet's InPlaceABN. Over x (M, C), the
// rows of a tensor whose channel axis is innermost in memory (TResNet's
// channels_last maps):
//
//   y = leaky_relu(x * scale + bias, slope)
//
// with scale and bias (C,) in x's dtype (the BatchNorm constants folded in
// float32 and rounded by the caller, as the JAX module does). As the TPU
// kernel, the affine and the comparison run in float32 and the result is
// rounded once to x's dtype; the product and the sum round separately
// (__fmul_rn, __fadd_rn: no FMA contraction), as PyTorch's two elementwise
// passes of the plain version do in float32.
//
// What bounds it on the card: one read and one write of x, nothing else
// (at TResNet-L-448, B = 16, bf16, the largest launch moves 122 MB: 0.036 ms
// at 3.35 TB/s). What the design does about it: TResNet-L's channel counts
// (76, 152, 304, 608) are not tile widths, and a 76-channel bf16 row is 152
// bytes, so rows are 8- but not 16-byte aligned. Each thread owns one
// vector of V channels of a row, V the widest load (16, 8, 4 or 2 bytes)
// that the base address and C allow, so its V scales and biases sit in
// registers for the whole launch; a block holds whole rows (C / V threads
// each) and walks U row groups, so neighbouring threads read neighbouring
// vectors and U loads are in flight per thread before the first store.
//
// Interface: plain C, loaded with ctypes. The launch goes on the caller's
// stream, never synchronises and allocates nothing; the return value is the
// CUDA error of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TARGET_THREADS = 256;
constexpr int MAX_THREADS = 1024;
constexpr int U = 4;  // row groups per block, loaded before any store

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

// an unsigned integer of B bytes: one load or store of a vector
template <int B> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = uint32_t; };
template <> struct Raw<2> { using type = uint16_t; };

template <typename T, int V>
__global__ void __launch_bounds__(MAX_THREADS)
fsba_kernel(const T* __restrict__ x, const T* __restrict__ scale,
            const T* __restrict__ bias, T* __restrict__ y, long long rows,
            int C, int rows_per_block, float slope) {
  using R = typename Raw<sizeof(T) * V>::type;
  const int vr = C / V;  // vectors per row
  const int col = threadIdx.x % vr, r0 = threadIdx.x / vr;
  if (r0 >= rows_per_block) return;
  float s[V], b[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    s[i] = to_f(scale[col * V + i]);
    b[i] = to_f(bias[col * V + i]);
  }
  const long long first = (long long)blockIdx.x * U * rows_per_block + r0;
  R in[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long r = first + (long long)u * rows_per_block;
    if (r < rows)
      in[u] = *reinterpret_cast<const R*>(x + r * C + col * V);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long r = first + (long long)u * rows_per_block;
    if (r >= rows) break;
    const T* e = reinterpret_cast<const T*>(&in[u]);
    R out;
    T* o = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float v = __fadd_rn(__fmul_rn(to_f(e[i]), s[i]), b[i]);
      o[i] = from_f<T>(v >= 0.0f ? v : __fmul_rn(v, slope));
    }
    *reinterpret_cast<R*>(y + r * C + col * V) = out;
  }
}

template <typename T, int V>
cudaError_t launch(const void* x, const void* scale, const void* bias,
                   void* y, long long rows, int C, float slope,
                   cudaStream_t s) {
  const int vr = C / V;
  const int rows_per_block = vr >= TARGET_THREADS ? 1 : TARGET_THREADS / vr;
  const long long per_block = (long long)U * rows_per_block;
  const long long blocks = (rows + per_block - 1) / per_block;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  fsba_kernel<T, V><<<(unsigned)blocks, vr * rows_per_block, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<const T*>(bias), static_cast<T*>(y), rows, C,
      rows_per_block, slope);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int v, const void* x, const void* scale,
                     const void* bias, void* y, long long rows, int C,
                     float slope, cudaStream_t s) {
  switch (v) {
    case 1: return launch<T, 1>(x, scale, bias, y, rows, C, slope, s);
    case 2: return launch<T, 2>(x, scale, bias, y, rows, C, slope, s);
    case 4: return launch<T, 4>(x, scale, bias, y, rows, C, slope, s);
    case 8:
      if constexpr (sizeof(T) == 2)
        return launch<T, 8>(x, scale, bias, y, rows, C, slope, s);
      break;
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x and y (rows, C) row-major in dtype (0 float32, 1 bf16), scale and bias
// (C,) in dtype; v elements per load (1, 2, 4, or 8 for bf16), with C % v
// == 0, x and y aligned to v elements and C / v <= 1024.
extern "C" int fused_scale_bias_act_launch(const void* x, const void* scale,
                                           const void* bias, void* y,
                                           long long rows, int C, int v,
                                           float slope, int dtype,
                                           void* stream) {
  if (rows < 1 || C < 1 || v < 1 || C % v != 0 || C / v > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(v, x, scale, bias, y, rows, C, slope, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(v, x, scale, bias, y, rows, C, slope,
                                        s);
  return (int)cudaErrorInvalidValue;
}
