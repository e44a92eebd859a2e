// P2: window-MHSA head grouping, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of scripts/swin_pack_probe.py: mhsa_pack
// (:177, _pack_kernel :68: heads in block-diagonal groups of g per
// program) and mhsa_batched (:198, _batched_kernel :106: every head of a
// window in one program). Both compute K3's function unshifted, with no
// mask: over x (B, Hp, Wp, C) bf16, head_dim 32, N = w*w,
//
//   y = x + proj(window_MHSA(LayerNorm(x)))
//
// with K3's numerics (window_mhsa.cu, ops/window_mhsa.py): LayerNorm in
// float32 rounded to bf16 on load, qkv summed in float32 and rounded,
// scores f32(q.k) * hd^-0.5 + bias, a float32 softmax with the denominator
// floored at 1e-30 and P rounded to bf16, P v in float32 rounded, proj +
// bias rounded, then the residual added in bf16.
//
// The probe asks how much of a window's attention one program should own:
// one head (K3's "loop"), a group of g heads (pack<g>), or every head
// (batched). Only the attention phase differs between those, so this runs
// K3's products from swin_gemm.cuh unchanged (LN(x), the QKV GEMM, the
// proj GEMM with bias and residual; the "_loop" entry point runs them on
// swin_common.cuh's WMMA loop, the parent) around a new attention phase,
// group_attn_kernel: one block per (window, group of g heads), 8 warps;
// batched is the same kernel with g = heads. The block stages q, k and v of
// its heads for the window in shared memory once (3 x N x 32 bf16 a head,
// rows padded to 80 bytes so that ldmatrix reads them without bank
// conflicts: 34,560 bytes a head at N = 144), then its warps take
// (head, 16-query strip) tasks in turn. A warp keeps its strip's scores in
// registers: S = q k^T as mma.sync m16n8k16 fragments (N / 8 of them, 72
// floats a thread at N = 144), scale and bias, row max and sum across the
// four threads of a row, P = exp(s - max) / sum rounded to bf16 straight
// into A fragments, O = P v, rounded to bf16 and written at the tokens'
// rows. No score tile lives in shared memory, so a block's shared memory
// grows with g alone. That was chosen over running the group's heads in
// turn over one shared float32 S (81 KB a head), which leaves room for
// only two heads' q, k and v beside it. Its cost is registers: a thread
// holds its strip's whole score rows (72 floats), the output (16) and q
// (8), and a strip computes all N / 8 key blocks before its softmax.
//
// The TPU kernel's block-diagonal masked K/V tiles, ones-matmul
// denominators and packed bias (:84-100 there) spend g-fold redundant
// operations to fill the 128-wide MXU. mma.sync takes 16 x 8 x 16 tiles, so
// here each head's softmax is its own, and a group buys only the shared
// staging and fewer, larger blocks.
//
// A block may use 227 KB of shared memory: 6 heads at N = 144. A group of
// more heads (stage 3's pack8, its batched 24) is staged in chunks, the
// largest divisor of g that fits the card's limit (swin_pack_chunk: 4 for
// g = 8, 6 for g = 24), one chunk after another in the same block.
//
// Ragged windows: N is padded to a multiple of 16 (w = 7: 49 -> 64) with
// zero q, k and v rows; padded keys get -inf scores and so no weight, and
// padded query rows are not written: masked at the real size, as K3 does.
//
// What bounds it on the card: at SwinL-384 stage 1 (B = 16, 96 x 96, C =
// 192, 6 heads, w = 12) 59.8 G operations (16.3 G of them the attention
// phase), 0.060 ms at 989 TFLOP/s, against 113 MB (0.034 ms at 3.35 TB/s):
// operations. At stage 3 (24 x 24, C = 768, 24 heads) 47.6 G operations
// (4.1 G attention), 0.048 ms. Stage 3 has 64 windows, so batched launches
// 64 blocks for the card's 132 SMs.
//
// With res_add 0 the proj phase writes proj + bias rounded, without the
// residual (K3's EPI_BIAS epilogue, as its res_add=False branch): the
// attention half alone, which the checks compare where the residual would
// hide it.
//
// Interface: plain C, loaded with ctypes. Launches go on the caller's
// stream, never synchronise and allocate nothing; the return value is the
// first CUDA error of the phases' launches (0 on success).

#include "mma_sync.cuh"
#include "swin_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int HD = swin::HD;    // 32
constexpr int LDQ = HD + 8;     // 80-byte rows: conflict-free ldmatrix
constexpr int WARPS = swin::THREADS / 32;

__host__ __device__ constexpr size_t head_bytes(int np) {
  return (size_t)3 * np * LDQ * sizeof(bf16);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// qkv (B*Hp*Wp, 3C) holds q | k | v per token; bias (heads, N, N); out
// (B*Hp*Wp, C). grid (B * nW, heads / group): block (window, G) owns heads
// G * group .. + group, staged ``chunk`` at a time. Windows are row-major
// over the (Hp/w, Wp/w) grid of each image, as K3's.
template <int NT>  // 16-row tiles of the padded window: np = 16 NT
__global__ void __launch_bounds__(swin::THREADS)
group_attn_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ bias,
                  bf16* __restrict__ out, int Hp, int Wp, int C, int w,
                  int group, int chunk, float scale) {
  constexpr int NP = 16 * NT, VPH = HD / 8;  // 16-byte vectors a head row
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sm = reinterpret_cast<bf16*>(smem);

  const int n = w * w, nww = Wp / w, nw = (Hp / w) * nww;
  const int b = blockIdx.x / nw, wi = blockIdx.x % nw;
  const int wr = wi / nww, wc = wi % nww;
  auto token = [&](int r) {  // row of token r of this window in (B*Hp*Wp)
    return ((size_t)b * Hp + wr * w + r / w) * Wp + wc * w + r % w;
  };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;

  for (int c0 = 0; c0 < group; c0 += chunk) {
    const int h0 = blockIdx.y * group + c0;
    // stage q, k, v of heads h0 .. h0 + chunk (padded rows zero); a token's
    // chunk of q (then k, then v) is one contiguous run of its qkv row
    const int per_row = 3 * chunk * VPH;
    for (int i = threadIdx.x; i < NP * per_row; i += swin::THREADS) {
      const int r = i / per_row, rem = i % per_row;
      const int which = rem / (chunk * VPH), hv = rem % (chunk * VPH);
      const int hh = hv / VPH, cv = (hv % VPH) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < n)
        v = *reinterpret_cast<const uint4*>(qkv + token(r) * 3 * C +
                                            which * C + (h0 + hh) * HD + cv);
      *reinterpret_cast<uint4*>(
          sm + ((size_t)(hh * 3 + which) * NP + r) * LDQ + cv) = v;
    }
    __syncthreads();

    for (int t = warp; t < chunk * NT; t += WARPS) {
      const int hh = t / NT, st = t % NT, h = h0 + hh;
      const bf16* Qs = sm + (size_t)hh * 3 * NP * LDQ;
      const bf16* Ks = Qs + NP * LDQ;
      const bf16* Vs = Ks + NP * LDQ;

      uint32_t qa[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        attn::ldmatrix_x4(qa[kk], Qs + (st * 16 + (lane & 15)) * LDQ +
                                      kk * 16 + (lane >> 4) * 8);
      // S = q k^T for the strip's 16 rows and every key
      float s[2 * NT][4];
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
                                         LDQ +
                                     kk * 16 + ((lane >> 3) & 1) * 8);
          attn::mma_bf16(s[2 * j], qa[kk], bk[0], bk[1]);
          attn::mma_bf16(s[2 * j + 1], qa[kk], bk[2], bk[3]);
        }

      // s * scale + bias over the real keys, -inf past them; the rows'
      // max and sum over the four threads that hold each row
      const int row[2] = {st * 16 + g, st * 16 + g + 8};
      const bf16* bh = bias + (size_t)h * n * n;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row[e >> 1], col = j * 8 + 2 * t4 + (e & 1);
          float v = -INFINITY;
          if (col < n)
            v = r < n ? s[j][e] * scale + swin::to_f(bh[r * n + col])
                      : s[j][e] * scale;
          s[j][e] = v;
          mx[e >> 1] = fmaxf(mx[e >> 1], v);
        }
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - mx[e >> 1]);
          sum[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        inv[r] = 1.0f / fmaxf(sum[r], 1e-30f);
      }

      // O = P v, P rounded to bf16 into the A fragments of 16 keys
      float o[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
#pragma unroll
      for (int kc = 0; kc < NT; ++kc) {
        const uint32_t pa[4] = {
            pack2(s[2 * kc][0] * inv[0], s[2 * kc][1] * inv[0]),
            pack2(s[2 * kc][2] * inv[1], s[2 * kc][3] * inv[1]),
            pack2(s[2 * kc + 1][0] * inv[0], s[2 * kc + 1][1] * inv[0]),
            pack2(s[2 * kc + 1][2] * inv[1], s[2 * kc + 1][3] * inv[1])};
#pragma unroll
        for (int dp = 0; dp < 2; ++dp) {
          uint32_t bv[4];
          attn::ldmatrix_x4_trans(
              bv, Vs + (kc * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LDQ +
                      dp * 16 + (lane >> 4) * 8);
          attn::mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
          attn::mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (row[r] < n)
            *reinterpret_cast<__nv_bfloat162*>(
                out + token(row[r]) * C + h * HD + j * 8 + 2 * t4) =
                __floats2bfloat162_rn(o[j][2 * r], o[j][2 * r + 1]);
    }
    __syncthreads();  // the next chunk is staged over this one
  }
}

template <int NT>
cudaError_t launch_group(const bf16* qkv, const bf16* bias, bf16* out, int B,
                         int Hp, int Wp, int C, int heads, int w, int group,
                         int chunk, float scale, cudaStream_t s) {
  const size_t smem = chunk * head_bytes(16 * NT);
  cudaError_t err = cudaFuncSetAttribute(
      group_attn_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * (Hp / w) * (Wp / w), heads / group);
  group_attn_kernel<NT><<<grid, swin::THREADS, smem, s>>>(
      qkv, bias, out, Hp, Wp, C, w, group, chunk, scale);
  return cudaGetLastError();
}

cudaError_t group_attention(const bf16* qkv, const bf16* bias, bf16* out,
                            int B, int Hp, int Wp, int C, int heads, int w,
                            int group, int chunk, float scale,
                            cudaStream_t s) {
  switch ((w * w + 15) / 16) {
#define CASE(NT)                                                           \
  case NT:                                                                 \
    return launch_group<NT>(qkv, bias, out, B, Hp, Wp, C, heads, w, group, \
                            chunk, scale, s);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) CASE(9)
#undef CASE
  }
  return cudaErrorInvalidValue;
}

// the heads a block of ``group`` heads stages at once: the largest divisor
// of group whose q, k and v fit the current device's shared memory per
// block; 0 if not even one head fits, or a negative CUDA error
int chunk_of(int group, int window) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return -(int)err;
  const size_t per_head = head_bytes((window * window + 15) / 16 * 16);
  for (int d = group; d > 0; --d)
    if (group % d == 0 && d * per_head <= (size_t)limit) return d;
  return 0;
}

template <bool LOOP>
int launch(const void* x, const void* gamma, const void* beta,
           const void* wqkv, const void* bqkv, const void* wproj,
           const void* bproj, const void* bias, void* qkv, void* attn,
           void* stats, void* y, int B, int Hp, int Wp, int C, int heads,
           int window, int group, float scale, int res_add, void* stream) {
  if (!swin::block_shape_ok(B, Hp, Wp, C, heads, window, 64) || group <= 0 ||
      heads % group)
    return (int)cudaErrorInvalidValue;
  const int chunk = chunk_of(group, window);
  if (chunk < 0) return -chunk;
  if (chunk == 0) return (int)cudaErrorInvalidValue;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xt = static_cast<const bf16*>(x);
  bf16* qkvt = static_cast<bf16*>(qkv);
  bf16* attnt = static_cast<bf16*>(attn);
  const int M = B * Hp * Wp;
  // attn holds LN(x) for the wgmma QKV product before the attention writes
  cudaError_t err = swin::gemm_any<bf16, swin::EPI_BIAS>(
      {xt, nullptr, static_cast<const float*>(gamma),
       static_cast<const float*>(beta), static_cast<const bf16*>(wqkv),
       static_cast<const bf16*>(bqkv), nullptr, qkvt, M, 3 * C, C},
      true, static_cast<float2*>(stats), attnt, LOOP, s);
  if (err != cudaSuccess) return (int)err;
  err = group_attention(qkvt, static_cast<const bf16*>(bias), attnt, B, Hp,
                        Wp, C, heads, window, group, chunk, scale, s);
  if (err != cudaSuccess) return (int)err;
  const swin::GemmArgs<bf16> proj{
      attnt, nullptr, nullptr, nullptr, static_cast<const bf16*>(wproj),
      static_cast<const bf16*>(bproj), xt, static_cast<bf16*>(y), M, C, C};
  return (int)(res_add ? swin::gemm_any<bf16, swin::EPI_ROUND_RES>(
                             proj, false, nullptr, nullptr, LOOP, s)
                       : swin::gemm_any<bf16, swin::EPI_BIAS>(
                             proj, false, nullptr, nullptr, LOOP, s));
}

}  // namespace

// The heads a block of ``group`` heads stages at once at this window on the
// current device (what swin_pack_launch uses); 0 if none fits, negative: a
// CUDA error.
extern "C" int swin_pack_chunk(int group, int window) {
  if (group <= 0 || window <= 0 || window > swin::MAX_WINDOW)
    return -(int)cudaErrorInvalidValue;
  return chunk_of(group, window);
}

// x, y (B, Hp, Wp, C) bf16; gamma, beta (C,) float32; wqkv (C, 3C), bqkv
// (3C,), wproj (C, C), bproj (C,), bias (heads, N, N) bf16. Scratch: qkv
// (B*Hp*Wp, 3C) and attn (B*Hp*Wp, C) bf16, stats (B*Hp*Wp,) float2.
// group divides heads (group = heads: batched). res_add 0: y = T(proj +
// bias), no residual.
extern "C" int swin_pack_launch(const void* x, const void* gamma,
                                const void* beta, const void* wqkv,
                                const void* bqkv, const void* wproj,
                                const void* bproj, const void* bias,
                                void* qkv, void* attn, void* stats, void* y,
                                int B, int Hp, int Wp, int C, int heads,
                                int window, int group, float scale,
                                int res_add, void* stream) {
  return launch<false>(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, qkv,
                       attn, stats, y, B, Hp, Wp, C, heads, window, group,
                       scale, res_add, stream);
}

// swin_pack_launch with the QKV and proj products on the WMMA loop
extern "C" int swin_pack_loop_launch(const void* x, const void* gamma,
                                     const void* beta, const void* wqkv,
                                     const void* bqkv, const void* wproj,
                                     const void* bproj, const void* bias,
                                     void* qkv, void* attn, void* stats,
                                     void* y, int B, int Hp, int Wp, int C,
                                     int heads, int window, int group,
                                     float scale, int res_add, void* stream) {
  return launch<true>(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, qkv,
                      attn, stats, y, B, Hp, Wp, C, heads, window, group,
                      scale, res_add, stream);
}
