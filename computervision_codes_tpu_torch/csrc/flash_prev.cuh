// The previous design of K8's backward kernels, kept as the parent
// that chip_smoke.py times the current design against
// (flash_attention_bwd_prev_launch); no model or op path calls them. The
// current design is in flash_attention.cu.
//
// dq_*_kernel: one block of 4 warps per ((batch, head), 64 queries) holds
// its Q and dO tiles, streams K and V, accumulates dQ; dkv_*_kernel: one
// block per ((batch, head), 64 keys) holds K and V, streams Q, dO, lse and
// dvec, accumulates dK and dV. bf16: every product on mma.sync m16n8k16
// fed by ldmatrix, P and dS rounded to bf16 before their products. float32:
// FMA, each thread a 4 x 8 score tile, the score tiles through a
// block-wide shared tile. Every streamed tile single-buffered (loaded,
// waited on, then computed).

#pragma once

#include "attention_prev.cuh"

namespace flash_prev {

using namespace attn_prev;
using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;

struct Bwd {
  const void* q;
  const void* k;
  const void* v;
  const void* g;      // dO
  const float* lse;   // (B * H, Tq), natural log
  const float* dvec;  // (B * H, Tq), rowsum(dO * O)
  void* dq;
  void* dk;
  void* dv;
  int B, H, Tq, Tk, D;
  Strides sq, sk, sv, sg, sdq, sdk, sdv;
  int vb;
  float scale;
};

// ---------------------------------------------------------------------------
// bf16 fragments (mma.sync m16n8k16, row.col)

// A (16 rows x 16 of the contracted dim) from a row-major tile
__device__ __forceinline__ void frag_a(uint32_t r[4], const bf16* X, int ld,
                                       int row0, int k0, int lane) {
  ldmatrix_x4(r, X + (row0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}
// B of the n-tiles n0 (r[0], r[1]) and n0 + 8 (r[2], r[3]) from a tile
// stored n-major: rows n, columns the contracted dim
__device__ __forceinline__ void frag_b_nk(uint32_t r[4], const bf16* Y, int ld,
                                          int n0, int k0, int lane) {
  ldmatrix_x4(r, Y + (n0 + (lane >> 4) * 8 + (lane & 7)) * ld + k0 +
                     ((lane >> 3) & 1) * 8);
}
// the same from a tile stored k-major: rows the contracted dim, columns n
__device__ __forceinline__ void frag_b_kn(uint32_t r[4], const bf16* Y, int ld,
                                          int k0, int n0, int lane) {
  ldmatrix_x4_trans(r, Y + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld +
                           n0 + (lane >> 4) * 8);
}

// acc (16 x 64) = X[row0:row0+16] Y[0:64]^T over DK 16-wide steps of D
template <int DK>
__device__ __forceinline__ void rows_by_rows(float acc[8][4], const bf16* X,
                                             const bf16* Y, int ld, int row0,
                                             int lane) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < DK; ++kk) {
    uint32_t a[4];
    frag_a(a, X, ld, row0, kk * 16, lane);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      frag_b_nk(b, Y, ld, np * 16, kk * 16, lane);
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// out (16 x 16 DK) += W (16 x 64, as A fragments) Y[0:64]
template <int DK>
__device__ __forceinline__ void weights_by_rows(float out[2 * DK][4],
                                                const uint32_t wa[4][4],
                                                const bf16* Y, int ld,
                                                int lane) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int dp = 0; dp < DK; ++dp) {
      uint32_t b[4];
      frag_b_kn(b, Y, ld, kc * 16, dp * 16, lane);
      mma_bf16(out[2 * dp], wa[kc], b[0], b[1]);
      mma_bf16(out[2 * dp + 1], wa[kc], b[2], b[3]);
    }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// 16 x 64 float32 accumulators, rounded to bf16, as A fragments over the 64
// columns
__device__ __forceinline__ void to_a(uint32_t wa[4][4], const float x[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    wa[n >> 1][(n & 1) * 2] = pack2(x[n][0], x[n][1]);
    wa[n >> 1][(n & 1) * 2 + 1] = pack2(x[n][2], x[n][3]);
  }
}

template <typename T>
__device__ __forceinline__ const T* head(const void* base, const Strides& s,
                                         int b, int h) {
  return static_cast<const T*>(base) + b * s.b + h * s.h;
}
template <typename T>
__device__ __forceinline__ T* head_out(void* base, const Strides& s, int b,
                                       int h) {
  return static_cast<T*>(base) + b * s.b + h * s.h;
}

// 16 x 16 DK accumulators of rows row0 + {g, g + 8} into rows < rows_total
template <int DK>
__device__ __forceinline__ void store_bf16(bf16* out, long long stride,
                                           const float acc[2 * DK][4],
                                           int row0, int rows_total, int D,
                                           int g, int t4) {
#pragma unroll
  for (int n = 0; n < 2 * DK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + g + 8 * (e >> 1);
      const int col = n * 8 + 2 * t4 + (e & 1);
      if (row < rows_total && col < D)
        out[row * stride + col] = __float2bfloat16(acc[n][e]);
    }
}

template <int DK>
struct Bf16Bwd {
  static constexpr int DP = 16 * DK;
  static constexpr int LD = DP + 8;  // 16-byte pad: conflict-free ldmatrix
  static constexpr size_t smem() {   // four 64-row tiles, two 64-float rows
    return (size_t)4 * BM * LD * sizeof(bf16) + 2 * BM * sizeof(float);
  }
};

template <int DK>
__global__ void __launch_bounds__(THREADS) dq_bf16_kernel(Bwd p) {
  constexpr int LD = Bf16Bwd<DK>::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Gs = Qs + BM * LD;
  bf16* Ks = Gs + BM * LD;
  bf16* Vs = Ks + BN * LD;

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.y * BM;
  const bf16* qg = head<bf16>(p.q, p.sq, b, h);
  const bf16* gg = head<bf16>(p.g, p.sg, b, h);
  const bf16* kg = head<bf16>(p.k, p.sk, b, h);
  const bf16* vg = head<bf16>(p.v, p.sv, b, h);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;

  zero_pad(Qs, LD, 2 * BM + 2 * BN, p.D, Bf16Bwd<DK>::DP);
  load_tile(Qs, LD, qg, p.sq.t, q0, p.Tq, p.D, p.vb);
  load_tile(Gs, LD, gg, p.sg.t, q0, p.Tq, p.D, p.vb);
  float lse2[2], dvec[2];  // rows past Tq: P = exp2(-inf) = 0
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    const bool valid = row < p.Tq;
    lse2[r] = valid ? p.lse[(long long)bh * p.Tq + row] * LOG2E : INFINITY;
    dvec[r] = valid ? p.dvec[(long long)bh * p.Tq + row] : 0.0f;
  }
  const float sl2 = p.scale * LOG2E;
  float acc[2 * DK][4];
#pragma unroll
  for (int n = 0; n < 2 * DK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  const int ntiles = (p.Tk + BN - 1) / BN;
  for (int j = 0; j < ntiles; ++j) {
    load_tile(Ks, LD, kg, p.sk.t, j * BN, p.Tk, p.D, p.vb);
    load_tile(Vs, LD, vg, p.sv.t, j * BN, p.Tk, p.D, p.vb);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float s[8][4], dp[8][4];
    rows_by_rows<DK>(s, Qs, Ks, LD, warp * 16, lane);   // S = Q K^T
    rows_by_rows<DK>(dp, Gs, Vs, LD, warp * 16, lane);  // dP = dO V^T
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * BN + n * 8 + 2 * t4 + (e & 1);
        const int r = e >> 1;
        const float pw = col < p.Tk ? exp2f(s[n][e] * sl2 - lse2[r]) : 0.0f;
        s[n][e] = pw * (dp[n][e] - dvec[r]) * p.scale;  // dS
      }
    uint32_t da[4][4];
    to_a(da, s);
    weights_by_rows<DK>(acc, da, Ks, LD, lane);  // dQ += dS K
    __syncthreads();  // K and V are refilled next tile
  }
  store_bf16<DK>(head_out<bf16>(p.dq, p.sdq, b, h), p.sdq.t, acc,
                 q0 + warp * 16, p.Tq, p.D, g, t4);
}

template <int DK>
__global__ void __launch_bounds__(THREADS) dkv_bf16_kernel(Bwd p) {
  constexpr int LD = Bf16Bwd<DK>::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BN * LD;
  bf16* Qs = Vs + BN * LD;
  bf16* Gs = Qs + BM * LD;
  float* Ls = reinterpret_cast<float*>(Gs + BM * LD);  // lse * log2(e)
  float* Ds = Ls + BM;                                 // dvec

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.y * BN;
  const bf16* qg = head<bf16>(p.q, p.sq, b, h);
  const bf16* gg = head<bf16>(p.g, p.sg, b, h);
  const bf16* kg = head<bf16>(p.k, p.sk, b, h);
  const bf16* vg = head<bf16>(p.v, p.sv, b, h);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;

  zero_pad(Ks, LD, 2 * BN + 2 * BM, p.D, Bf16Bwd<DK>::DP);
  load_tile(Ks, LD, kg, p.sk.t, k0, p.Tk, p.D, p.vb);
  load_tile(Vs, LD, vg, p.sv.t, k0, p.Tk, p.D, p.vb);
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) key_ok[r] = k0 + warp * 16 + g + 8 * r < p.Tk;
  const float sl2 = p.scale * LOG2E;
  float dk[2 * DK][4], dv[2 * DK][4];
#pragma unroll
  for (int n = 0; n < 2 * DK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;

  const int ntiles = (p.Tq + BM - 1) / BM;
  for (int i = 0; i < ntiles; ++i) {
    load_tile(Qs, LD, qg, p.sq.t, i * BM, p.Tq, p.D, p.vb);
    load_tile(Gs, LD, gg, p.sg.t, i * BM, p.Tq, p.D, p.vb);
    for (int t = threadIdx.x; t < BM; t += THREADS) {
      const int row = i * BM + t;
      const bool valid = row < p.Tq;
      Ls[t] = valid ? p.lse[(long long)bh * p.Tq + row] * LOG2E : 0.0f;
      Ds[t] = valid ? p.dvec[(long long)bh * p.Tq + row] : 0.0f;
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // rows: this warp's 16 keys; columns: the tile's 64 queries
    float st[8][4];
    rows_by_rows<DK>(st, Ks, Qs, LD, warp * 16, lane);  // S^T = K Q^T
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = n * 8 + 2 * t4 + (e & 1);
        st[n][e] = (i * BM + qc < p.Tq && key_ok[e >> 1])
                       ? exp2f(st[n][e] * sl2 - Ls[qc])
                       : 0.0f;  // P^T
      }
    uint32_t wa[4][4];
    to_a(wa, st);
    weights_by_rows<DK>(dv, wa, Gs, LD, lane);  // dV += P^T dO
    float dpt[8][4];
    rows_by_rows<DK>(dpt, Vs, Gs, LD, warp * 16, lane);  // dP^T = V dO^T
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = n * 8 + 2 * t4 + (e & 1);
        dpt[n][e] = st[n][e] * (dpt[n][e] - Ds[qc]) * p.scale;  // dS^T
      }
    to_a(wa, dpt);
    weights_by_rows<DK>(dk, wa, Qs, LD, lane);  // dK += dS^T Q
    __syncthreads();  // Q, dO, lse and dvec are refilled next tile
  }
  const int row0 = k0 + warp * 16;
  store_bf16<DK>(head_out<bf16>(p.dk, p.sdk, b, h), p.sdk.t, dk, row0, p.Tk,
                 p.D, g, t4);
  store_bf16<DK>(head_out<bf16>(p.dv, p.sdv, b, h), p.sdv.t, dv, row0, p.Tk,
                 p.D, g, t4);
}

// ---------------------------------------------------------------------------
// float32: FMA. NJ = Dpad / 16; thread (ty, tx) = (tid / 8, tid % 8) owns
// rows ty + 16 i (i < 4) of its 64, score columns tx + 8 c (c < 8) and
// output columns 2 tx + 16 jj + {0, 1} (jj < NJ).

template <int NJ>
struct F32Bwd {
  static constexpr int DP = 16 * NJ;
  static constexpr int LD = DP + 4;   // LD / 4 odd: conflict-free float4 rows
  static constexpr int LDP = BN + 4;  // the score tile
  static constexpr size_t smem() {    // four tiles, the score tile, 2 rows
    return ((size_t)4 * BM * LD + (size_t)BM * LDP + 2 * BM) * sizeof(float);
  }
};

// s[i][c] += X[ty + 16 i] . Y[tx + 8 c] over the padded head dim
template <int NJ>
__device__ __forceinline__ void rows_dot_f32(float s[4][8], const float* X,
                                             const float* Y, int ty, int tx) {
  constexpr int LD = F32Bwd<NJ>::LD;
#pragma unroll 2
  for (int d = 0; d < F32Bwd<NJ>::DP; d += 4) {
    float4 xv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      xv[i] = *reinterpret_cast<const float4*>(X + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float4 yv =
          *reinterpret_cast<const float4*>(Y + (tx + 8 * c) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][c] = fmaf(xv[i].x, yv.x, s[i][c]);
        s[i][c] = fmaf(xv[i].y, yv.y, s[i][c]);
        s[i][c] = fmaf(xv[i].z, yv.z, s[i][c]);
        s[i][c] = fmaf(xv[i].w, yv.w, s[i][c]);
      }
    }
  }
}

// out[i][jj] += W[ty + 16 i, :] Y[:, 2 tx + 16 jj + {0, 1}] over 64 rows of
// Y, W the score tile in shared memory
template <int NJ>
__device__ __forceinline__ void weights_by_rows_f32(float out[4][NJ][2],
                                                    const float* W,
                                                    const float* Y, int ty,
                                                    int tx) {
  constexpr int LD = F32Bwd<NJ>::LD, LDP = F32Bwd<NJ>::LDP;
#pragma unroll 1
  for (int kk = 0; kk < BN; kk += 4) {
    float4 wv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wv[i] = *reinterpret_cast<const float4*>(W + (ty + 16 * i) * LDP + kk);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float2 yv = *reinterpret_cast<const float2*>(
            Y + (kk + u) * LD + 2 * tx + 16 * jj);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float w = u == 0 ? wv[i].x : u == 1 ? wv[i].y
                        : u == 2 ? wv[i].z : wv[i].w;
          out[i][jj][0] = fmaf(w, yv.x, out[i][jj][0]);
          out[i][jj][1] = fmaf(w, yv.y, out[i][jj][1]);
        }
      }
    }
  }
}

template <int NJ>
__device__ __forceinline__ void store_f32(float* out, long long stride,
                                          const float acc[4][NJ][2], int row0,
                                          int rows_total, int D, int ty,
                                          int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= rows_total) continue;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 2 * tx + 16 * jj + e;
        if (col < D) out[row * stride + col] = acc[i][jj][e];
      }
  }
}

template <int NJ>
__device__ __forceinline__ void zero_acc(float a[4][NJ][2]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) a[i][jj][0] = a[i][jj][1] = 0.0f;
}

template <int NJ>
__global__ void __launch_bounds__(THREADS) dq_f32_kernel(Bwd p) {
  constexpr int LD = F32Bwd<NJ>::LD, LDP = F32Bwd<NJ>::LDP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Gs = Qs + BM * LD;
  float* Ks = Gs + BM * LD;
  float* Vs = Ks + BN * LD;
  float* Ps = Vs + BN * LD;

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.y * BM;
  const float* qg = head<float>(p.q, p.sq, b, h);
  const float* gg = head<float>(p.g, p.sg, b, h);
  const float* kg = head<float>(p.k, p.sk, b, h);
  const float* vg = head<float>(p.v, p.sv, b, h);
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;

  zero_pad(Qs, LD, 2 * BM + 2 * BN, p.D, F32Bwd<NJ>::DP);
  load_tile(Qs, LD, qg, p.sq.t, q0, p.Tq, p.D, p.vb);
  load_tile(Gs, LD, gg, p.sg.t, q0, p.Tq, p.D, p.vb);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int i = threadIdx.x; i < BM * p.D; i += THREADS)
    Qs[(i / p.D) * LD + i % p.D] *= p.scale;  // q * scale in float32

  float lse[4], dvec[4];  // rows past Tq: P = exp(-inf) = 0
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const bool valid = row < p.Tq;
    lse[i] = valid ? p.lse[(long long)bh * p.Tq + row] : INFINITY;
    dvec[i] = valid ? p.dvec[(long long)bh * p.Tq + row] : 0.0f;
  }
  float acc[4][NJ][2];
  zero_acc<NJ>(acc);

  const int ntiles = (p.Tk + BN - 1) / BN;
  for (int j = 0; j < ntiles; ++j) {
    load_tile(Ks, LD, kg, p.sk.t, j * BN, p.Tk, p.D, p.vb);
    load_tile(Vs, LD, vg, p.sv.t, j * BN, p.Tk, p.D, p.vb);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[i][c] = dp[i][c] = 0.0f;
    rows_dot_f32<NJ>(s, Qs, Ks, ty, tx);   // S = (q * scale) K^T
    rows_dot_f32<NJ>(dp, Gs, Vs, ty, tx);  // dP = dO V^T
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float pw =
            j * BN + tx + 8 * c < p.Tk ? expf(s[i][c] - lse[i]) : 0.0f;
        Ps[(ty + 16 * i) * LDP + tx + 8 * c] =
            pw * (dp[i][c] - dvec[i]) * p.scale;  // dS
      }
    __syncthreads();
    weights_by_rows_f32<NJ>(acc, Ps, Ks, ty, tx);  // dQ += dS K
    __syncthreads();  // K, V and dS are refilled next tile
  }
  store_f32<NJ>(head_out<float>(p.dq, p.sdq, b, h), p.sdq.t, acc, q0, p.Tq,
                p.D, ty, tx);
}

template <int NJ>
__global__ void __launch_bounds__(THREADS) dkv_f32_kernel(Bwd p) {
  constexpr int LD = F32Bwd<NJ>::LD, LDP = F32Bwd<NJ>::LDP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + BN * LD;
  float* Qs = Vs + BN * LD;
  float* Gs = Qs + BM * LD;
  float* Ps = Gs + BM * LD;
  float* Ls = Ps + BN * LDP;  // lse
  float* Ds = Ls + BM;        // dvec

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.y * BN;
  const float* qg = head<float>(p.q, p.sq, b, h);
  const float* gg = head<float>(p.g, p.sg, b, h);
  const float* kg = head<float>(p.k, p.sk, b, h);
  const float* vg = head<float>(p.v, p.sv, b, h);
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;

  zero_pad(Ks, LD, 2 * BN + 2 * BM, p.D, F32Bwd<NJ>::DP);
  load_tile(Ks, LD, kg, p.sk.t, k0, p.Tk, p.D, p.vb);
  load_tile(Vs, LD, vg, p.sv.t, k0, p.Tk, p.D, p.vb);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // S^T = (k * scale) q^T: the TPU kernel scales q; the two differ by
  // float32 rounding only
  for (int i = threadIdx.x; i < BN * p.D; i += THREADS)
    Ks[(i / p.D) * LD + i % p.D] *= p.scale;
  bool key_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) key_ok[i] = k0 + ty + 16 * i < p.Tk;
  float dk[4][NJ][2], dv[4][NJ][2];
  zero_acc<NJ>(dk);
  zero_acc<NJ>(dv);

  const int ntiles = (p.Tq + BM - 1) / BM;
  for (int it = 0; it < ntiles; ++it) {
    load_tile(Qs, LD, qg, p.sq.t, it * BM, p.Tq, p.D, p.vb);
    load_tile(Gs, LD, gg, p.sg.t, it * BM, p.Tq, p.D, p.vb);
    for (int t = threadIdx.x; t < BM; t += THREADS) {
      const int row = it * BM + t;
      const bool valid = row < p.Tq;
      Ls[t] = valid ? p.lse[(long long)bh * p.Tq + row] : 0.0f;
      Ds[t] = valid ? p.dvec[(long long)bh * p.Tq + row] : 0.0f;
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // rows: keys ty + 16 i; columns: queries tx + 8 c
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[i][c] = 0.0f;
    rows_dot_f32<NJ>(s, Ks, Qs, ty, tx);  // S^T
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int qc = tx + 8 * c;
        s[i][c] = (it * BM + qc < p.Tq && key_ok[i]) ? expf(s[i][c] - Ls[qc])
                                                     : 0.0f;  // P^T
        Ps[(ty + 16 * i) * LDP + qc] = s[i][c];
      }
    __syncthreads();
    weights_by_rows_f32<NJ>(dv, Ps, Gs, ty, tx);  // dV += P^T dO
    float dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) dp[i][c] = 0.0f;
    rows_dot_f32<NJ>(dp, Vs, Gs, ty, tx);  // dP^T = V dO^T
    __syncthreads();  // every thread is done reading P^T
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int qc = tx + 8 * c;
        Ps[(ty + 16 * i) * LDP + qc] =
            s[i][c] * (dp[i][c] - Ds[qc]) * p.scale;  // dS^T
      }
    __syncthreads();
    weights_by_rows_f32<NJ>(dk, Ps, Qs, ty, tx);  // dK += dS^T Q
    __syncthreads();  // Q, dO, the scores, lse and dvec are refilled next
  }
  store_f32<NJ>(head_out<float>(p.dk, p.sdk, b, h), p.sdk.t, dk, k0, p.Tk,
                p.D, ty, tx);
  store_f32<NJ>(head_out<float>(p.dv, p.sdv, b, h), p.sdv.t, dv, k0, p.Tk,
                p.D, ty, tx);
}

}  // namespace flash_prev
