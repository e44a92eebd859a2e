// The previous design of K7's and K8's streaming forward, kept as
// the parent that chip_smoke.py times the current design against
// (attention_prev_launch, flash_attention_fwd_prev_launch); no model or op
// path calls it. The current design is attention_common.cuh.
//
// One block of 4 warps takes BM = 64 query rows of one (batch, head) and
// streams K and V through shared memory in tiles of BN = 64 keys with an
// online softmax, (batch, head) on grid.x and query tiles on grid.y.
// bf16 (attn_bf16_kernel): each warp 16 query rows, QK^T and PV on
// mma.sync m16n8k16 fed by ldmatrix, K and V double-buffered through
// cp.async; P rounded to bf16 before PV, the row sum adding the rounded
// weights. float32 (attn_f32_kernel): FMA, each thread a 4 x 8 score tile,
// the weights through a block-wide shared tile, K and V single-buffered,
// expf. Rows are read through their strides in the widest copy every row
// allows (16, 8, 4 bytes through cp.async; bf16 rows of odd length element
// by element); D is zero-padded to a multiple of 16 in shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace attn_prev {

using attn::copy_chunk;
using attn::cp_async_commit;
using attn::cp_async_wait;
using attn::ldmatrix_x4;
using attn::ldmatrix_x4_trans;
using attn::mma_bf16;
using attn::pack_bf16;

constexpr int BM = 64;        // query rows per block
constexpr int BN = 64;        // keys per tile
constexpr int THREADS = 128;  // 4 warps
constexpr int D_MAX = 128;

struct Strides {
  long long b, h, t;  // element strides; the head dim is contiguous
};

struct Problem {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, Tq, Tk, D;
  Strides sq, sk, sv, so;
  int vb;       // bytes per copy: 16, 8, 4, or 2 (bf16 element by element)
  float scale;  // D^-1/2
  // K8 only: the row logsumexp of the scaled scores, float32 (B * H, Tq),
  // or null
  float* lse = nullptr;
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
  return __float2bfloat16(v);
}

// Rows [row0, row0 + 64) of a (rows_total, D) matrix with row stride
// ``stride`` into shared memory at row stride ``ld``; rows past rows_total
// are zero. Columns [D, ld) are not touched.
template <typename T>
__device__ __forceinline__ void load_tile(T* smem, int ld, const T* base,
                                          long long stride, int row0,
                                          int rows_total, int D, int vb) {
  const int ve = vb / (int)sizeof(T);  // elements per chunk
  const int cpr = D / ve;              // chunks per row
  for (int i = threadIdx.x; i < BN * cpr; i += THREADS) {
    const int r = i / cpr;
    const int c = (i - r * cpr) * ve;
    const int row = row0 + r;
    const bool valid = row < rows_total;
    copy_chunk(smem + r * ld + c, base + (valid ? row : 0) * stride + c,
               valid, vb);
  }
}

// Zero columns [D, dp) of ``rows`` rows at row stride ``ld``.
template <typename T>
__device__ __forceinline__ void zero_pad(T* smem, int ld, int rows, int D,
                                         int dp) {
  const int w = dp - D;
  for (int i = threadIdx.x; i < rows * w; i += THREADS)
    smem[(i / w) * ld + D + i % w] = from_f<T>(0.0f);
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16, DK = Dpad / 16 k-steps of the head dim.

template <int DK>
struct Bf16Tiles {
  static constexpr int DP = 16 * DK;
  static constexpr int LD = DP + 8;  // 16-byte pad: conflict-free ldmatrix
  static constexpr size_t smem() {   // Q, then (K, V) twice
    return (size_t)(BM + 4 * BN) * LD * sizeof(__nv_bfloat16);
  }
};

template <int DK>
__global__ void __launch_bounds__(THREADS) attn_bf16_kernel(Problem p) {
  using T = __nv_bfloat16;
  using Tiles = Bf16Tiles<DK>;
  constexpr int LD = Tiles::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  auto Ks = [&](int s) { return Qs + BM * LD + s * 2 * BN * LD; };
  auto Vs = [&](int s) { return Ks(s) + BN * LD; };

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.y * BM;
  const T* qg = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* kg = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h;
  const T* vg = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h;
  T* og = static_cast<T*>(p.o) + b * p.so.b + h * p.so.h;
  const int ntiles = (p.Tk + BN - 1) / BN;

  zero_pad(Qs, LD, BM + 4 * BN, p.D, Tiles::DP);
  load_tile(Qs, LD, qg, p.sq.t, q0, p.Tq, p.D, p.vb);
  load_tile(Ks(0), LD, kg, p.sk.t, 0, p.Tk, p.D, p.vb);
  load_tile(Vs(0), LD, vg, p.sv.t, 0, p.Tk, p.D, p.vb);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const float sl2 = p.scale * 1.4426950408889634f;  // exp(x) = exp2(x log2e)
  uint32_t qa[DK][4];
  float o[2 * DK][4];
#pragma unroll
  for (int n = 0; n < 2 * DK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  for (int j = 0; j < ntiles; ++j) {
    const int cur = j & 1;
    if (j + 1 < ntiles) {  // prefetch the next tile into the other buffer
      load_tile(Ks(cur ^ 1), LD, kg, p.sk.t, (j + 1) * BN, p.Tk, p.D, p.vb);
      load_tile(Vs(cur ^ 1), LD, vg, p.sv.t, (j + 1) * BN, p.Tk, p.D, p.vb);
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but the prefetch has landed
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
        ldmatrix_x4(qa[kk], Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                                (lane >> 4) * 8);
    }

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    const T* Kt = Ks(cur);
#pragma unroll
    for (int kk = 0; kk < DK; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, Kt + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qa[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qa[kk], bk[2], bk[3]);
      }

    // scale (log2 domain), mask keys past Tk, online softmax
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * BN + n * 8 + 2 * t4 + (e & 1);
        s[n][e] = col < p.Tk ? s[n][e] * sl2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);  // finite: the tile has a key
      alpha[r] = exp2f(m[r] - mn);
      m[r] = mn;
    }
    // P = exp2(s - m) rounded to bf16, straight into A fragments of 16 keys
    uint32_t pa[4][4];
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const uint32_t lo = pack_bf16(exp2f(s[n][0] - m[0]),
                                    exp2f(s[n][1] - m[0]), &rs[0]);
      const uint32_t hi = pack_bf16(exp2f(s[n][2] - m[1]),
                                    exp2f(s[n][3] - m[1]), &rs[1]);
      pa[n >> 1][(n & 1) * 2] = lo;
      pa[n >> 1][(n & 1) * 2 + 1] = hi;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int n = 0; n < 2 * DK; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    // O += P V
    const T* Vt = Vs(cur);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int dp = 0; dp < DK; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, Vt + (kc * 16 + ((lane >> 3) & 1) * 8 +
                                    (lane & 7)) * LD +
                                  dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], pa[kc], bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], pa[kc], bv[2], bv[3]);
      }
    __syncthreads();  // the buffer is refilled by the next prefetch
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {  // row sums over the 4 threads of a row
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + warp * 16 + g + 8 * r;
    if (p.lse != nullptr && t4 == 0 && row < p.Tq)  // m is in log2 units
      p.lse[(long long)bh * p.Tq + row] =
          (m[r] + log2f(l[r])) * 0.6931471805599453f;
  }
#pragma unroll
  for (int n = 0; n < 2 * DK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = q0 + warp * 16 + g + 8 * (e >> 1);
      const int col = n * 8 + 2 * t4 + (e & 1);
      if (row < p.Tq && col < p.D)
        og[row * p.so.t + col] = from_f<T>(o[n][e] / l[e >> 1]);
    }
}

// ---------------------------------------------------------------------------
// float32: FMA. NJ = Dpad / 16; thread (ty, tx) = (tid / 8, tid % 8) owns
// query rows ty + 16 i (i < 4), score columns tx + 8 j (j < 8) and output
// columns 2 tx + 16 jj + {0, 1} (jj < NJ).

template <int NJ>
struct F32Tiles {
  static constexpr int DP = 16 * NJ;
  static constexpr int LD = DP + 4;   // LD / 4 odd: conflict-free float4 rows
  static constexpr int LDP = BN + 4;  // the weight tile
  static constexpr size_t smem() {    // Q, K, V, P
    return ((size_t)(BM + 2 * BN) * LD + (size_t)BM * LDP) * sizeof(float);
  }
};

template <int NJ>
__global__ void __launch_bounds__(THREADS) attn_f32_kernel(Problem p) {
  using Tiles = F32Tiles<NJ>;
  constexpr int LD = Tiles::LD, LDP = Tiles::LDP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + BM * LD;
  float* Vs = Ks + BN * LD;
  float* Ps = Vs + BN * LD;

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.y * BM;
  const float* qg = static_cast<const float*>(p.q) + b * p.sq.b + h * p.sq.h;
  const float* kg = static_cast<const float*>(p.k) + b * p.sk.b + h * p.sk.h;
  const float* vg = static_cast<const float*>(p.v) + b * p.sv.b + h * p.sv.h;
  float* og = static_cast<float*>(p.o) + b * p.so.b + h * p.so.h;
  const int ntiles = (p.Tk + BN - 1) / BN;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;

  zero_pad(Qs, LD, BM + 2 * BN, p.D, Tiles::DP);
  load_tile(Qs, LD, qg, p.sq.t, q0, p.Tq, p.D, p.vb);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int i = threadIdx.x; i < BM * p.D; i += THREADS)
    Qs[(i / p.D) * LD + i % p.D] *= p.scale;  // q * scale in float32

  float o[4][NJ][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) o[i][jj][0] = o[i][jj][1] = 0.0f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
  }

  for (int j = 0; j < ntiles; ++j) {
    load_tile(Ks, LD, kg, p.sk.t, j * BN, p.Tk, p.D, p.vb);
    load_tile(Vs, LD, vg, p.sv.t, j * BN, p.Tk, p.D, p.vb);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[i][c] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < Tiles::DP; d += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float4 kv =
            *reinterpret_cast<const float4*>(Ks + (tx + 8 * c) * LD + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][c] = fmaf(qv[i].x, kv.x, s[i][c]);
          s[i][c] = fmaf(qv[i].y, kv.y, s[i][c]);
          s[i][c] = fmaf(qv[i].z, kv.z, s[i][c]);
          s[i][c] = fmaf(qv[i].w, kv.w, s[i][c]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        if (j * BN + tx + 8 * c >= p.Tk) s[i][c] = -INFINITY;
        mx = fmaxf(mx, s[i][c]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float mn = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mn);
      m[i] = mn;
      float rs = 0.0f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float e = expf(s[i][c] - mn);
        Ps[(ty + 16 * i) * LDP + tx + 8 * c] = e;
        rs += e;
      }
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        o[i][jj][0] *= alpha;
        o[i][jj][1] *= alpha;
      }
    }
    __syncthreads();

    // O += P V (keys past Tk have weight 0 and zero rows of V)
#pragma unroll 1
    for (int kk = 0; kk < BN; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * LDP +
                                                 kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const float2 vv = *reinterpret_cast<const float2*>(
              Vs + (kk + u) * LD + 2 * tx + 16 * jj);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pw = u == 0 ? pv[i].x : u == 1 ? pv[i].y
                           : u == 2 ? pv[i].z : pv[i].w;
            o[i][jj][0] = fmaf(pw, vv.x, o[i][jj][0]);
            o[i][jj][1] = fmaf(pw, vv.y, o[i][jj][1]);
          }
        }
      }
    }
    __syncthreads();  // K, V and P are refilled next tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 4);
    const int row = q0 + ty + 16 * i;
    if (row >= p.Tq) continue;
    if (p.lse != nullptr && tx == 0)
      p.lse[(long long)bh * p.Tq + row] = m[i] + logf(l[i]);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 2 * tx + 16 * jj + e;
        if (col < p.D) og[row * p.so.t + col] = o[i][jj][e] / l[i];
      }
  }
}

}  // namespace attn_prev
