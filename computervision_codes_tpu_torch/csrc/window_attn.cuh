// Window attention with each strip's scores in registers, written by hand
// for Hopper (sm_90a): the attention phase of K3 window_mhsa.cu (and so of
// K5 swin_block.cu and K6's attention branch, which run K3's phases) and
// the body of K10 window_attention.cu. swin_common.cuh includes it.
//
// Replaces, on the card, the attention of the Pallas TPU kernels
// computervision_codes_tpu/ops/window_mhsa.py::window_mhsa_fused (its
// _kernel and packed_window_attention) and
// computervision_codes_tpu/ops/window_attention.py::window_attention_pallas
// and ::window_attention_pallas_multi (_kernel, _kernel_multi). Per
// (window, head), over q, k, v (N x 32, N = w*w <= 144 tokens), the head's
// relative-position bias (N, N) and the window's shift mask (N, N, or none):
//
//   o = T(P v),  P = T(softmax(q k^T * scale + bias (+ mask)))
//
// with the scores, the softmax and the PV sums in float32, the denominator
// floored at 1e-30 and P rounded to T before the PV product.
//
// What bounds it on the card: bytes and latency. At Swin-L-384 stage 0
// (B = 16, 1024 windows, 6 heads, N = 144, bf16) q, k, v and o are 226 MB
// (0.068 ms at 3.35 TB/s) against 16.3 G operations of products (0.016 ms
// at 989 TFLOP/s). A float32 N x N score tile and a P tile in shared memory
// (the design this one replaced: 163 KB a block at N = 144) let one block
// of 8 warps fill an SM, its gather, three barrier-separated phases and the
// store running one after another with nothing to hide their latency.
//
// What this design does (from P2's group_attn_kernel, swin_pack_probe.cu):
// - one block per (window, head), warps_of(NT) warps (NT = N / 16 padded:
//   3 warps of 3 strips at N = 144, 4 of one at N = 64), each warp taking
//   16-query strips in rounds, so every warp of a block gets the same
//   number of strips where NT allows;
// - q, k and v of the task staged in shared memory with cp.async (16-byte
//   copies, narrower where K10's views need them) in two groups, q and k
//   first, so the scores start while v is still in flight; rows padded to
//   80 bytes (bf16) or 144 bytes (float32), so ldmatrix and the float4
//   reads touch each bank once. 34,560 bytes a block in bf16 and 62,208 in
//   float32 at N = 144: 6 and 3 blocks fit an SM's shared memory;
// - a warp keeps its strip's scores in registers: in bf16 S = q k^T as
//   mma.sync m16n8k16 fragments (N / 8 of them, 72 floats a thread at
//   N = 144), in float32 the same fragment layout filled by FMAs over
//   float4 reads of q and k (each score summed over d in order); scale, bias and mask are applied in registers
//   in the order s * scale + bias (+ mask), the bias and mask read in the
//   accumulator's layout as pairs; each row's max and sum come from the
//   four threads that hold the row (quad shuffles); padded keys get -inf
//   and padded query rows are never written;
// - bf16: P is rounded straight into the A fragments of P v (the C
//   fragments of two n8 key blocks are the A fragment of one k16 step);
//   float32: each thread sums P v over its own keys for one half of the
//   head dim at a time and the quad reduce-scatters the partial rows, so
//   no P tile goes through shared memory either;
// - no score or weight tile lives in shared memory, so blocks are small
//   and several share an SM: one block's loads overlap another's products.
//
#pragma once

#include "mma_sync.cuh"

namespace swin {
namespace wa {

// row stride of the q, k and v tiles (elements): 80-byte bf16 rows for
// ldmatrix, 144-byte float32 rows for the float4 reads of four keys two
// rows apart and of eight queries one row apart
template <typename T> struct Tile {
  static constexpr int LD = sizeof(T) == 2 ? HD + 8 : HD + 4;
};

// the 16-query strips of NT are taken in rounds_of(NT) rounds by
// warps_of(NT) warps: every warp takes the same number where NT allows
__host__ __device__ constexpr int rounds_of(int nt) { return (nt + 3) / 4; }
__host__ __device__ constexpr int warps_of(int nt) {
  return (nt + rounds_of(nt) - 1) / rounds_of(nt);
}
// blocks an SM should hold at the register cap of __launch_bounds__: in
// bf16 12 warps (170 registers a thread); in float32 9 (227 registers),
// since its q, k and v tiles let only 3 blocks of 3 warps share an SM at
// N = 144 and its strip needs more registers
template <typename T>
__host__ __device__ constexpr int min_blocks_of(int nt) {
  return (sizeof(T) == 2 ? 12 : 9) / warps_of(nt);  // warps_of <= 4
}
template <typename T> __host__ __device__ constexpr size_t smem_of(int nt) {
  return (size_t)3 * 16 * nt * Tile<T>::LD * sizeof(T);
}

// two consecutive T values as float2 (8- or 4-byte aligned)
__device__ __forceinline__ float2 pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Stage rows [0, 16 NT) of q, k and v (rows >= n zero) with cp.async of vb
// bytes: q and k in one group, v in the next. src(which, r) is row r of q
// (0), k (1) or v (2).
template <typename T, int NT, typename Src>
__device__ __forceinline__ void stage(T* sm, const Src& src, int n, int vb) {
  constexpr int NP = 16 * NT, LD = Tile<T>::LD, NTH = 32 * warps_of(NT);
  const int ve = vb / (int)sizeof(T), per = HD / ve;  // copies a row
#pragma unroll 1
  for (int which = 0; which < 3; ++which) {
    T* dst = sm + which * NP * LD;
    for (int i = threadIdx.x; i < NP * per; i += NTH) {
      const int r = i / per, c = (i - r * per) * ve;
      const bool valid = r < n;
      attn::copy_chunk(dst + r * LD + c, src(which, valid ? r : 0) + c,
                       valid, vb);
    }
    if (which == 1) attn::cp_async_commit();
  }
  attn::cp_async_commit();
}

// The strip's scores q k^T in the m16n8k16 C layout: s[j][e] is query row
// 16 st + g + 8 (e >> 1), key 8 j + 2 t4 + (e & 1) (g = lane / 4,
// t4 = lane % 4).
template <int NT>
__device__ __forceinline__ void scores(float (&s)[2 * NT][4],
                                       const __nv_bfloat16* Qs,
                                       const __nv_bfloat16* Ks, int st) {
  constexpr int LD = Tile<__nv_bfloat16>::LD;
  const int lane = threadIdx.x & 31;
  uint32_t qa[2][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    attn::ldmatrix_x4(qa[kk], Qs + (st * 16 + (lane & 15)) * LD + kk * 16 +
                                  (lane >> 4) * 8);
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t bk[4];
      attn::ldmatrix_x4(bk, Ks + (j * 16 + (lane >> 4) * 8 + (lane & 7)) *
                                     LD +
                                 kk * 16 + ((lane >> 3) & 1) * 8);
      attn::mma_bf16(s[2 * j], qa[kk], bk[0], bk[1]);
      attn::mma_bf16(s[2 * j + 1], qa[kk], bk[2], bk[3]);
    }
}
template <int NT>
__device__ __forceinline__ void scores(float (&s)[2 * NT][4],
                                       const float* Qs, const float* Ks,
                                       int st) {
  constexpr int LD = Tile<float>::LD;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const float* q0 = Qs + (st * 16 + g) * LD;
  const float* q1 = q0 + 8 * LD;
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
    const float4 a = *reinterpret_cast<const float4*>(q0 + d);
    const float4 b = *reinterpret_cast<const float4*>(q1 + d);
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 k =
            *reinterpret_cast<const float4*>(Ks + (j * 8 + 2 * t4 + e) * LD +
                                             d);
        s[j][e] = fmaf(a.w, k.w,
                       fmaf(a.z, k.z, fmaf(a.y, k.y, fmaf(a.x, k.x,
                                                          s[j][e]))));
        s[j][2 + e] =
            fmaf(b.w, k.w,
                 fmaf(b.z, k.z, fmaf(b.y, k.y, fmaf(b.x, k.x, s[j][2 + e]))));
      }
  }
}

// s -> s * scale + bias (+ mask) over the strip's rows, -inf past the n
// real keys; padded query rows (r >= n) take no bias. EVEN: n is even, so
// every even column's pair of bias (and mask) values is one aligned load.
// Every load is in bounds (row and column clamped) and unconditional, so
// the compiler issues them all ahead of their use: a branch around them
// serialises their latency.
template <bool EVEN, bool MASKED, typename T, int NT>
__device__ __forceinline__ void add_bias(float (&s)[2 * NT][4], int st,
                                         const T* bias_h, const T* mask_w,
                                         int n, float scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = st * 16 + g + 8 * rr;
    const bool real = r < n;
    const T* br = bias_h + (size_t)(real ? r : n - 1) * n;
    const T* mr = mask_w + (size_t)(real ? r : n - 1) * n;
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) {
      const int col = j * 8 + 2 * t4;
      float2 b, m = make_float2(0.0f, 0.0f);
      if constexpr (EVEN) {
        const int c = min(col, n - 2);
        b = pair(br + c);
        if constexpr (MASKED) m = pair(mr + c);
      } else {
        const int c0 = min(col, n - 1), c1 = min(col + 1, n - 1);
        b = make_float2(to_f(br[c0]), to_f(br[c1]));
        if constexpr (MASKED) m = make_float2(to_f(mr[c0]), to_f(mr[c1]));
      }
      // a padded row adds zeros: fma(s, scale, 0) rounds as s * scale
      if (!real) b = m = make_float2(0.0f, 0.0f);
      float v0 = s[j][2 * rr] * scale + b.x;
      float v1 = s[j][2 * rr + 1] * scale + b.y;
      if constexpr (MASKED) {
        v0 += m.x;
        v1 += m.y;
      }
      s[j][2 * rr] = col < n ? v0 : -INFINITY;
      s[j][2 * rr + 1] = col + 1 < n ? v1 : -INFINITY;
    }
  }
}

// s -> exp(s * scale + bias (+ mask) - row max), 0 past the n real keys;
// inv[rr] = 1 / max(row sum, 1e-30) for rows g and g + 8. bias_h and
// mask_w (or null): the head's and the window's (n, n) in T.
template <typename T, int NT>
__device__ __forceinline__ void softmax(float (&s)[2 * NT][4], float (&inv)[2],
                                        int st, const T* bias_h,
                                        const T* mask_w, int n, float scale) {
  const bool even = (n & 1) == 0;
  if (mask_w && even)
    add_bias<true, true, T, NT>(s, st, bias_h, mask_w, n, scale);
  else if (mask_w)
    add_bias<false, true, T, NT>(s, st, bias_h, mask_w, n, scale);
  else if (even)
    add_bias<true, false, T, NT>(s, st, bias_h, bias_h, n, scale);
  else
    add_bias<false, false, T, NT>(s, st, bias_h, bias_h, n, scale);
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
  }
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = expf(s[j][e] - mx[e >> 1]);
      sum[e >> 1] += s[j][e];
    }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], 1);
    sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], 2);
    inv[rr] = 1.0f / fmaxf(sum[rr], 1e-30f);
  }
}

// O = T(P) v for the strip, P = T(s * inv); store(r, d, o_d, o_d+1) for
// the real rows r < n, d even
template <int NT, typename Store>
__device__ __forceinline__ void pv(const float (&s)[2 * NT][4],
                                   const float (&inv)[2],
                                   const __nv_bfloat16* Vs, int st, int n,
                                   Store& store) {
  constexpr int LD = Tile<__nv_bfloat16>::LD;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  auto pack = [](float lo, float hi) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&p);
  };
  float o[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
#pragma unroll
  for (int kc = 0; kc < NT; ++kc) {
    // the C fragments of key blocks 2 kc and 2 kc + 1 are the A fragment
    // of keys 16 kc .. 16 kc + 15: a0 (row g, keys 2 t4..), a1 (row g + 8),
    // a2 (row g, keys 8 + 2 t4..), a3 (row g + 8)
    const uint32_t pa[4] = {
        pack(s[2 * kc][0] * inv[0], s[2 * kc][1] * inv[0]),
        pack(s[2 * kc][2] * inv[1], s[2 * kc][3] * inv[1]),
        pack(s[2 * kc + 1][0] * inv[0], s[2 * kc + 1][1] * inv[0]),
        pack(s[2 * kc + 1][2] * inv[1], s[2 * kc + 1][3] * inv[1])};
#pragma unroll
    for (int dp = 0; dp < 2; ++dp) {
      uint32_t bv[4];
      attn::ldmatrix_x4_trans(
          bv, Vs + (kc * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                  dp * 16 + (lane >> 4) * 8);
      attn::mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
      attn::mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
    }
  }
  const int r0 = st * 16 + g;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (r0 < n) store(r0, j * 8 + 2 * t4, o[j][0], o[j][1]);
    if (r0 + 8 < n) store(r0 + 8, j * 8 + 2 * t4, o[j][2], o[j][3]);
  }
}
template <int NT, typename Store>
__device__ __forceinline__ void pv(const float (&s)[2 * NT][4],
                                   const float (&inv)[2], const float* Vs,
                                   int st, int n, Store& store) {
  constexpr int LD = Tile<float>::LD;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const bool hi = t4 & 2, lo = t4 & 1;
  const int r0 = st * 16 + g;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    // o[rr][i]: this thread's keys' share of row g + 8 rr, d = 16 half + i
    float o[2][16];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int i = 0; i < 16; ++i) o[rr][i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p0 = s[j][e] * inv[0], p1 = s[j][2 + e] * inv[1];
        const float* vr = Vs + (j * 8 + 2 * t4 + e) * LD + 16 * half;
#pragma unroll
        for (int i = 0; i < 16; i += 4) {
          const float4 v = *reinterpret_cast<const float4*>(vr + i);
          o[0][i] = fmaf(p0, v.x, o[0][i]);
          o[0][i + 1] = fmaf(p0, v.y, o[0][i + 1]);
          o[0][i + 2] = fmaf(p0, v.z, o[0][i + 2]);
          o[0][i + 3] = fmaf(p0, v.w, o[0][i + 3]);
          o[1][i] = fmaf(p1, v.x, o[1][i]);
          o[1][i + 1] = fmaf(p1, v.y, o[1][i + 1]);
          o[1][i + 2] = fmaf(p1, v.z, o[1][i + 2]);
          o[1][i + 3] = fmaf(p1, v.w, o[1][i + 3]);
        }
      }
    // reduce-scatter over the quad: the threads t4 ^ 2 split the 16
    // columns into halves (hi keeps 8..15), then t4 ^ 1 split those
    // (lo keeps the upper 4); each thread ends with 4 whole sums a row
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float give = hi ? o[rr][i] : o[rr][8 + i];
        const float keep = hi ? o[rr][8 + i] : o[rr][i];
        o[rr][i] = keep + __shfl_xor_sync(0xffffffffu, give, 2);
      }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float give = lo ? o[rr][i] : o[rr][4 + i];
        const float keep = lo ? o[rr][4 + i] : o[rr][i];
        o[rr][i] = keep + __shfl_xor_sync(0xffffffffu, give, 1);
      }
    const int d = 16 * half + 8 * hi + 4 * lo;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      if (r0 + 8 * rr < n) {
        store(r0 + 8 * rr, d, o[rr][0], o[rr][1]);
        store(r0 + 8 * rr, d + 2, o[rr][2], o[rr][3]);
      }
  }
}

// One (window, head): stage q, k, v, then each warp's strips in rounds.
// Every warp runs every round (a warp without a strip idles in it), so the
// barrier that waits for v in round 0 is reached by all.
template <typename T, int NT, typename Src, typename Store>
__device__ __forceinline__ void attend(T* sm, const Src& src, int vb,
                                       const T* bias_h, const T* mask_w,
                                       int n, float scale, Store& store) {
  constexpr int NP = 16 * NT, LD = Tile<T>::LD, W = warps_of(NT);
  stage<T, NT>(sm, src, n, vb);
  const T* Qs = sm;
  const T* Ks = sm + NP * LD;
  const T* Vs = sm + 2 * NP * LD;
  attn::cp_async_wait<1>();
  __syncthreads();
  const int warp = threadIdx.x >> 5;
#pragma unroll 1
  for (int round = 0; round < rounds_of(NT); ++round) {
    const int st = round * W + warp;
    const bool active = st < NT;
    float s[2 * NT][4], inv[2];
    if (active) {
      scores<NT>(s, Qs, Ks, st);
      softmax<T, NT>(s, inv, st, bias_h, mask_w, n, scale);
    }
    if (round == 0) {
      attn::cp_async_wait<0>();
      __syncthreads();
    }
    if (active) pv<NT>(s, inv, Vs, st, n, store);
  }
}

// qkv (B, Hp, Wp, 3C) holds q | k | v per token; bias (H, N, N) and mask
// (nW, N, N, or null) in T; out (B, Hp, Wp, C). Block (window, head), the
// window row-major over the (Hp/w, Wp/w) grid of its image, as the shift
// mask is. wamax (B * nW window absmaxes, float bits, or null): the int8
// branch's proj scales, max |out| over the window's tokens and heads, with
// the padded query of an odd window when pad_query.
template <typename T, int NT>
__global__ void __launch_bounds__(32 * warps_of(NT), min_blocks_of<T>(NT))
window_attn_regs_kernel(const T* __restrict__ qkv, const T* __restrict__ bias,
                        const T* __restrict__ mask, T* __restrict__ out,
                        int* __restrict__ wamax, int Hp, int Wp, int C, int w,
                        float scale, bool pad_query) {
  constexpr int W = warps_of(NT), LD = Tile<T>::LD, NP = 16 * NT;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sm = reinterpret_cast<T*>(smem);
  const int n = w * w, nww = Wp / w, nw = (Hp / w) * nww;
  const int b = blockIdx.x / nw, wi = blockIdx.x % nw;
  const int wr = wi / nww, wc = wi % nww, h = blockIdx.y;
  auto token = [&](int r) {  // row of token r of this window in (B*Hp*Wp)
    return ((size_t)b * Hp + wr * w + r / w) * Wp + wc * w + r % w;
  };
  const T* base = qkv + h * HD;
  auto src = [&](int which, int r) {
    return base + token(r) * 3 * C + which * C;
  };
  const bool amax = wamax != nullptr;
  float omax = 0.0f;
  auto store = [&](int r, int d, float v0, float v1) {
    store_pair(out + token(r) * C + h * HD + d, v0, v1);
    if (amax)
      omax = fmaxf(omax, fmaxf(fabsf(round_to<T>(v0)),
                               fabsf(round_to<T>(v1))));
  };
  attend<T, NT>(sm, src, 16, bias + (size_t)h * n * n,
                mask ? mask + (size_t)wi * n * n : nullptr, n, scale, store);
  if (!amax) return;
  if (pad_query && threadIdx.x < HD) {
    // p = T(1 / n) on every real key: the padded query's row of P
    const T* Vs = sm + 2 * NP * LD;
    const float p = round_to<T>(__fdiv_rn(1.0f, (float)n));
    float o = 0.0f;
    for (int j = 0; j < n; ++j)
      o = __fadd_rn(o, __fmul_rn(p, to_f(Vs[j * LD + threadIdx.x])));
    omax = fmaxf(omax, fabsf(round_to<T>(o)));
  }
  __shared__ float red[W];
  omax = warp_max(omax);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = omax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = red[0];
    for (int i = 1; i < W; ++i) m = fmaxf(m, red[i]);
    atomicMax(wamax + blockIdx.x, __float_as_int(m));
  }
}

}  // namespace wa

namespace {

// Let ``kernel`` take ``bytes`` of dynamic shared memory on the current
// device, once per device in this library: ``done`` is the caller's flag
// word, a static of a function in this unnamed namespace (a static in a
// function with external linkage is one object across every library
// loaded, a GNU unique symbol, and another library's flag would skip this
// one's attribute)
template <typename K>
cudaError_t allow_smem(K* kernel, size_t bytes, unsigned& done) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) done |= bit;
  return err;
}

template <typename T, int NT>
cudaError_t launch_attn_regs(const T* qkv, const T* bias, const T* mask,
                             T* out, int* wamax, int B, int Hp, int Wp, int C,
                             int heads, int w, float scale, cudaStream_t s) {
  static unsigned done = 0;
  const size_t smem = wa::smem_of<T>(NT);
  cudaError_t err = allow_smem(wa::window_attn_regs_kernel<T, NT>, smem,
                               done);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * (Hp / w) * (Wp / w), heads);
  wa::window_attn_regs_kernel<T, NT>
      <<<grid, 32 * wa::warps_of(NT), smem, s>>>(
          qkv, bias, mask, out, wamax, Hp, Wp, C, w, scale, w % 2 == 1);
  return cudaGetLastError();
}

}  // namespace

// The attention phase of K3 (and K5, K6): qkv (B*Hp*Wp, 3C) -> out
// (B*Hp*Wp, C) with the scores in registers; wamax as the kernel's. Counts
// one launch in attn_launch_count.
template <typename T>
cudaError_t window_attention(const T* qkv, const T* bias, const T* mask,
                             T* out, int B, int Hp, int Wp, int C, int heads,
                             int w, float scale, cudaStream_t s,
                             int* wamax = nullptr) {
  cudaError_t err = cudaErrorInvalidValue;
  switch ((w * w + 15) / 16) {
#define CASE(NT)                                                          \
  case NT:                                                                \
    err = launch_attn_regs<T, NT>(qkv, bias, mask, out, wamax, B, Hp, Wp, \
                                  C, heads, w, scale, s);                 \
    break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) CASE(9)
#undef CASE
  }
  if (err == cudaSuccess) ++attn_launch_count;
  return err;
}

}  // namespace swin

// This library's attention-phase launches since it was loaded (or last
// reset).
extern "C" long long swin_attn_launches() { return swin::attn_launch_count; }

extern "C" void swin_attn_reset() { swin::attn_launch_count = 0; }
