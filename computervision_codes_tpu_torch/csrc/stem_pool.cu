// Fused ResNet stem (conv7x7/s2/p3 + bias + ReLU + maxpool3x3/s2/p1),
// written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// computervision_codes_tpu/ops/stem_pool.py::stem_pool_fused (its
// _kernel_single and _kernel_grid bodies). Over NHWC frames x (N, H, W, 3),
// H and W divisible by 4, with the BatchNorm-folded kernel w (7, 7, 3, 64)
// HWIO and the folded float32 bias b (64):
//
//   conv[r, s, o] = sum_{dy, dx, c} x[2r + dy - 3, 2s + dx - 3, c] w[dy, dx, c, o]
//   a = round_to_T(relu(conv + b))                       (float32 sum)
//   y[p, q, o] = max over a[2p - 1 .. 2p + 1, 2q - 1 .. 2q + 1, o]
//
// Input outside the frame reads as zero (the conv's padding). The pool's
// padding is zero too: every pool window holds at least one real cell and
// a >= 0 after the ReLU, so a zero pad gives what a -inf pad gives.
// Rounding is monotone, so the max of the rounded cells is the rounding of
// the float32 max bit for bit: where the cells are rounded does not change
// a bit of the output.
//
// What bounds it on the card: 2 x 147 x 64 FLOP per conv cell against
// 6 bytes read per input pixel and 128 bytes written per pooled output, so
// it is bound by the tensor cores (0.559 ms at 1,024 frames of 256x448 in
// bf16), and at C_in = 3 the reduction is short.
//
// The bf16 design (stem_pool_launch): a persistent implicit GEMM. About
// one block per SM (plan_of: the grid, and the work items it walks). Each
// block
//   1. loads the weight once, as the wgmma B operand (160 x 64 bf16, MN-major
//      in the 128-byte swizzle, 20 KB), gathering each row's tap from the
//      (7, 7, 3, 64) kernel (ops/stem_pool.py::stem_pair_weight is the same
//      matrix in PyTorch);
//   2. walks work items (frame, band of pooled rows, chunk of at most 127
//      pooled columns). Pooled row p needs conv rows 2p - 1, 2p and 2p + 1;
//      the walk goes down the band and keeps conv row 2p + 1's cells (after
//      bias and ReLU, rounded, in registers) as the next row's 2p - 1, so
//      each conv
//      cell of a band is computed once (a band's first row once more; at
//      the top of the frame row -1 is the pool's zero pad);
//   3. stages the raw input rows, not an im2col tile: padded input row rho
//      (input row rho - 3, zeros outside the frame) is copied by cp.async in
//      16-byte pieces (8 where W % 8 != 0), zero-filled past the frame's
//      edges, into a ring of 16 row slots (slots 0-4 mirrored at 16-20, so
//      the 7 rows of a conv row are always contiguous); the 4 rows of the
//      next pooled row are in flight while this one's products run;
//   4. builds A in registers: two consumer warpgroups each take m64 tiles of
//      64 conv cells along the conv row (M, 2 x 127 + 1 at most, in 4
//      tiles; a tile's rows in the order of tile_column, so the loads are
//      free of bank conflicts) and run wgmma m64n64k16 with A from
//      registers. The depth K is
//      the 7 kernel rows x 11 element pairs of the input row: the pair
//      (6s - 10 + 2u, 6s - 9 + 2u) of the row's (pixel, channel) elements,
//      u = 0..10, covers the 21 taps (dx, c) of conv column s (the low half of
//      pair 0 belongs to no tap: its weight is zero and its bits are
//      masked), so every A register is one aligned 32-bit shared load
//      straight from the staged row, and K = 154 rounds to 160 (10 k16
//      steps; the last 3 pairs are zero registers);
//   5. epilogue: bias and ReLU in float32 in registers, each cell rounded
//      once to bf16 (two to a register), the max over the three conv rows
//      in registers (a warpgroup runs both conv rows of a tile back to
//      back), then the 3 x 3 / 2 max through shared memory (column
//      neighbours sit in other threads' rows), and the pooled (W/4, 64) row
//      stored with 16-byte stores.
// The K = 192 space-to-depth form of the JAX kernel is the same products;
// this one stages the input as it lies in memory (a space-to-depth row
// interleaves 12-byte pieces that no 16-byte copy can move) and runs 10 k16
// steps where that form runs 12.
//
// float32 keeps the previous design's kernel (FMA, so float32 stays
// float32), with the shared-memory attribute set once per device.
// stem_pool_prev_launch runs the previous design (csrc/stem_pool_prev.cuh)
// in both dtypes, for timings only.
//
// Interface: plain C, loaded with ctypes. A launch goes on the caller's
// stream, never synchronises and allocates nothing; the return value is
// the CUDA error of the launch (0 on success). Each entry point counts its
// successful launches per design (stem_pool_launches).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"
#include "stem_pool_prev.cuh"

namespace k2 {
namespace {  // internal linkage: the flags are this library's

using bf16 = __nv_bfloat16;

constexpr int COUT = 64;
constexpr int PAIRS = 77;          // 7 kernel rows x 11 element pairs
constexpr int KP = 160;            // 2 x PAIRS rounded to the k16 step
constexpr int KSTEPS = KP / 16;
constexpr int W_BYTES = KP * 128;  // the B operand, 128 bytes a row
constexpr int THREADS = 256;       // two consumer warpgroups
constexpr int MTILES = 4;          // m64 tiles of a chunk's conv row
constexpr int QW_MAX = 127;        // pooled columns a chunk: 2 QW + 1 <= 256
constexpr int SLOTS = 16;          // the ring of staged rows
constexpr int MIRROR = 5;          // slots 0..4 mirrored at 16..20
// the row-max tile's row stride in bf16 pairs (4-byte words): odd, so the
// rows of tile_column's order store to 32 different banks
constexpr int LDR = COUT / 2 + 1;

// the plan (mirrored by ops/stem_pool.py::stem_pool_plan): pooled rows a
// band, column chunks and pooled columns a chunk, work items, the grid
// (blocks), bytes of a staged row
struct Plan {
  int band, chunks, qw;
  long long items;
  int grid, rb;
};

inline Plan plan_of(int N, int H, int W, int sms) {
  const int PH = H / 4, QW = W / 4;
  const int chunks = (QW + QW_MAX - 1) / QW_MAX;
  const int qw = (QW + chunks - 1) / chunks;
  // the band that finishes first: rounds of items over the blocks times the
  // conv rows of an item (2 a pooled row, one more where a band does not
  // start the frame); ties keep the longer band
  int band = PH;
  long long best = -1;
  for (int L = PH; L >= 1; --L) {
    const long long bands = (PH + L - 1) / L;
    const long long items = (long long)N * bands * chunks;
    const long long cost =
        (items + sms - 1) / sms * (2 * L + (bands > 1 ? 1 : 0));
    if (best < 0 || cost < best) {
      best = cost;
      band = L;
    }
  }
  const long long items = (long long)N * ((PH + band - 1) / band) * chunks;
  const int grid = (int)(items < sms ? items : sms);
  const int rb = (2 * (12 * qw + 40) + 15) / 16 * 16;
  return {band, chunks, qw, items, grid, rb};
}

inline size_t smem_bytes(int rb) {
  // 1024 to align by hand, the weight, the ring, the row-max tile (bf16
  // pairs), the bias
  return 1024 + W_BYTES + (size_t)(SLOTS + MIRROR) * rb +
         (size_t)MTILES * 64 * LDR * 4 + COUT * 4;
}

__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         uint32_t src_bytes, int vec) {
  if (vec == 16)
    hopper::cp_async_16(dst, src, src_bytes);
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes)
                 : "memory");
}

// stages padded rows [r0, r1) of frame xf: elements [es0, es0 + rb / 2) of
// input row rho - 3, zeros outside the frame, into slot rho % 16 (and its
// mirror)
__device__ __forceinline__ void stage_rows(uint8_t* ring, int rb,
                                           const bf16* xf, int H, int W,
                                           int es0, int r0, int r1, int vec) {
  const int units = rb / vec, per = vec / 2, row_el = 3 * W;
  for (int i = threadIdx.x; i < (r1 - r0) * units; i += THREADS) {
    const int rho = r0 + i / units, u = i % units;
    const int rr = rho - 3, e = es0 + u * per;
    const bool ok = rr >= 0 && rr < H && e >= 0 && e < row_el;
    const bf16* src = ok ? xf + (size_t)rr * row_el + e : xf;
    const int slot = rho & (SLOTS - 1);
    const uint32_t dst = hopper::smem_u32(ring + slot * rb + u * vec);
    cp_async(dst, src, ok ? vec : 0, vec);
    if (slot < MIRROR)
      cp_async(dst + SLOTS * rb, src, ok ? vec : 0, vec);
  }
}

// Per thread: the byte offset in the staged rows of the pair of k16 step t,
// half i (20 of them), which pairs are the zero pad (k >= 154) and which
// have their low half masked (u = 0).
struct Pairs {
  int off[2 * KSTEPS];
  uint32_t zero_all, zero_low;
  __device__ Pairs(int q, int rb) : zero_all(0u), zero_low(0u) {
#pragma unroll
    for (int idx = 0; idx < 2 * KSTEPS; ++idx) {
      const int P = 8 * (idx / 2) + 4 * (idx % 2) + q;
      const int dy = P / 11, u = P % 11;
      off[idx] = P < PAIRS ? dy * rb + 4 * u : 0;
      if (P >= PAIRS) zero_all |= 1u << idx;
      if (P < PAIRS && u == 0) zero_low |= 1u << idx;
    }
  }
};

// acc = the m64 tile whose rows sit at byte columns colb_lo / colb_hi of the
// staged rows from rowbase on, times the weight
__device__ __forceinline__ void conv_tile(float (&acc)[32],
                                          const uint8_t* rowbase,
                                          const uint8_t* wsm, int colb_lo,
                                          int colb_hi, const Pairs& pr) {
  uint32_t a[KSTEPS][4];
#pragma unroll
  for (int idx = 0; idx < 2 * KSTEPS; ++idx) {
    const uint8_t* p = rowbase + pr.off[idx];
    uint32_t lo = *reinterpret_cast<const uint32_t*>(p + colb_lo);
    uint32_t hi = *reinterpret_cast<const uint32_t*>(p + colb_hi);
    const uint32_t keep = (pr.zero_all >> idx) & 1u ? 0u
                          : (pr.zero_low >> idx) & 1u ? 0xFFFF0000u
                                                      : 0xFFFFFFFFu;
    a[idx / 2][2 * (idx % 2)] = lo & keep;
    a[idx / 2][2 * (idx % 2) + 1] = hi & keep;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) hopper::fence_operand(acc[i]);
  hopper::wgmma_fence();
#pragma unroll
  for (int t = 0; t < KSTEPS; ++t)
    hopper::WgmmaBF16RS<64>::run(
        acc, a[t], hopper::smem_desc_sw128_mn(wsm + t * 2048, W_BYTES),
        t > 0 ? 1 : 0);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 32; ++i) hopper::fence_operand(acc[i]);
}

// The conv column that accumulator row 16 w + g + 8 h of an m64 tile
// holds, from the tile's first: 32 h + (12 g + w) % 32. Over a warp (w, h
// fixed) the rows' 12-byte pixels then sit 4 g words apart modulo the 32
// banks, so the A loads of its 8 rows x 4 pairs hit 32 different banks
// (consecutive columns, 3 g words apart, collide 2-way).
__device__ __forceinline__ int tile_column(int w, int g, int h) {
  return 32 * h + ((12 * g + w) & 31);
}

// What a thread of warpgroup wg keeps of one chunk: the geometry of its
// rows.
struct Rows {
  int wg, w, g, q;
  int sc0, mtiles;
  int colb[2][2];  // byte column of rows g, g + 8 of each of its two tiles
};

// v = round(relu(acc + bias)) in bf16 pairs, zero in conv column -1 (the
// pool's pad); acc's fragment: acc[4 j + 2 h + c] is tile row
// 16 w + g + 8 h, channel 8 j + 2 q + c; v[2 j + h] holds c = 0, 1
__device__ __forceinline__ void bias_relu(__nv_bfloat162 (&v)[16],
                                          const float (&acc)[32],
                                          const float* bias_s, int tau,
                                          const Rows& rw) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 bb =
        *reinterpret_cast<const float2*>(bias_s + 8 * j + 2 * rw.q);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool pad =
          rw.sc0 + 64 * tau + tile_column(rw.w, rw.g, h) < 0;
      const int e = 4 * j + 2 * h;
      v[2 * j + h] = __floats2bfloat162_rn(
          pad ? 0.0f : fmaxf(acc[e] + bb.x, 0.0f),
          pad ? 0.0f : fmaxf(acc[e + 1] + bb.y, 0.0f));
    }
  }
}

// The carry (conv row 2 p0 - 1 of each of this warpgroup's tiles).
__device__ __forceinline__ void carry_row(int r,
                                          __nv_bfloat162 (&carry)[2][16],
                                          const uint8_t* ring, int rb,
                                          const uint8_t* wsm,
                                          const float* bias_s,
                                          const Rows& rw, const Pairs& pr) {
  const uint8_t* rowbase = ring + ((2 * r) & (SLOTS - 1)) * rb;
#pragma unroll
  for (int ti = 0; ti < 2; ++ti) {
    const int tau = rw.wg + 2 * ti;
    if (tau >= rw.mtiles) continue;  // uniform over the warpgroup
    float acc[32] = {};
    conv_tile(acc, rowbase, wsm, rw.colb[ti][0], rw.colb[ti][1], pr);
    bias_relu(carry[ti], acc, bias_s, tau, rw);
  }
}

// Pooled row p's conv rows 2p and 2p + 1 of each of this warpgroup's
// tiles: the max over them and the carry (row 2p - 1) into the row-max tile
// rms (bf16 pairs), at the cells' conv columns; row 2p + 1 becomes the
// carry.
__device__ __forceinline__ void pooled_rows(int p,
                                            __nv_bfloat162 (&carry)[2][16],
                                            const uint8_t* ring, int rb,
                                            const uint8_t* wsm,
                                            __nv_bfloat162* rms,
                                            const float* bias_s,
                                            const Rows& rw,
                                            const Pairs& pr) {
  const uint8_t* base0 = ring + ((4 * p) & (SLOTS - 1)) * rb;
  const uint8_t* base1 = ring + ((4 * p + 2) & (SLOTS - 1)) * rb;
#pragma unroll
  for (int ti = 0; ti < 2; ++ti) {
    const int tau = rw.wg + 2 * ti;
    if (tau >= rw.mtiles) continue;  // uniform over the warpgroup
    float acc[32] = {};
    __nv_bfloat162 top[16];
    conv_tile(acc, base0, wsm, rw.colb[ti][0], rw.colb[ti][1], pr);
    bias_relu(top, acc, bias_s, tau, rw);
#pragma unroll
    for (int i = 0; i < 16; ++i) top[i] = __hmax2(top[i], carry[ti][i]);
    conv_tile(acc, base1, wsm, rw.colb[ti][0], rw.colb[ti][1], pr);
    bias_relu(carry[ti], acc, bias_s, tau, rw);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      __nv_bfloat162* row =
          rms + (64 * tau + tile_column(rw.w, rw.g, h)) * LDR;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        row[4 * j + rw.q] = __hmax2(top[2 * j + h], carry[ti][2 * j + h]);
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(THREADS, 1)
stem_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wk,
                  const float* __restrict__ bias, bf16* __restrict__ y,
                  int H, int W, int band, int chunks, int qw,
                  long long items, int rb) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* wsm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = wsm + W_BYTES;
  __nv_bfloat162* rms =
      reinterpret_cast<__nv_bfloat162*>(ring + (SLOTS + MIRROR) * rb);
  float* bias_s = reinterpret_cast<float*>(rms + MTILES * 64 * LDR);

  // the weight once, gathered from the (7, 7, 3, 64) kernel: row k holds
  // the tap of element e = k % 2 of pair P = k / 2 = 11 dy + u, i.e.
  // (dx, c) = divmod(2u - 1 + e, 3), or zeros (no tap, or k >= 154); each
  // row to 128 swizzled bytes
  for (int i = threadIdx.x; i < KP * 8; i += THREADS) {
    const int k = i / 8, c = i % 8;
    const int P = k / 2, u = P % 11, tap = 2 * u - 1 + k % 2;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (P < PAIRS && tap >= 0)
      v = *reinterpret_cast<const uint4*>(
          wk + ((P / 11 * 7 + tap / 3) * 3 + tap % 3) * COUT + 8 * c);
    *reinterpret_cast<uint4*>(wsm + hopper::swizzled_chunk(k, c)) = v;
  }
  if (threadIdx.x < COUT) bias_s[threadIdx.x] = bias[threadIdx.x];
  hopper::fence_proxy_async();  // the weight is read by wgmma
  __syncthreads();

  Rows rw;
  rw.wg = threadIdx.x / 128;
  rw.w = (threadIdx.x % 128) / 32;
  rw.g = (threadIdx.x % 32) / 4;
  rw.q = threadIdx.x % 4;
  const Pairs pr(rw.q, rb);
  const int PH = H / 4, QWt = W / 4;
  const int bands = (PH + band - 1) / band;

  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const int chunk = (int)(item % chunks);
    const long long rest = item / chunks;
    const int bnd = (int)(rest % bands);
    const long long n = rest / bands;
    const int p0 = bnd * band, p1 = min(p0 + band, PH);
    const int q0 = chunk * qw, qwc = min(qw, QWt - q0);
    const int es0 = (12 * q0 - 16) & ~7;  // rounded down to 16 bytes
    const int mc = 2 * qwc + 1;           // the chunk's conv columns
    rw.sc0 = 2 * q0 - 1;                  // the first of them
    rw.mtiles = (mc + 63) / 64;
    const bf16* xf = x + (size_t)n * H * W * 3;
    bf16* yf = y + (size_t)n * PH * QWt * COUT;

    // the byte column of each of this thread's rows in a staged row: conv
    // column s reads elements from 6 s - 10 on; rows past the chunk read its
    // last column (their results are never pooled)
#pragma unroll
    for (int ti = 0; ti < 2; ++ti)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 64 * (rw.wg + 2 * ti) + tile_column(rw.w, rw.g, h);
        rw.colb[ti][h] = 12 * (rw.sc0 + min(m, mc - 1)) - 20 - 2 * es0;
      }

    __nv_bfloat162 carry[2][16];
    // the rows of the band's first conv row and of its first pooled row
    const int rf = p0 > 0 ? 2 * p0 - 1 : 0;
    stage_rows(ring, rb, xf, H, W, es0, 2 * rf, 4 * p0 + 9, VEC);
    hopper::cp_async_commit();
    hopper::cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int ti = 0; ti < 2; ++ti)
#pragma unroll
      for (int i = 0; i < 16; ++i)  // conv row -1: the pool's zero pad
        carry[ti][i] = __floats2bfloat162_rn(0.0f, 0.0f);
    if (p0 > 0)
      carry_row(2 * p0 - 1, carry, ring, rb, wsm, bias_s, rw, pr);

    for (int p = p0; p < p1; ++p) {
      if (p + 1 < p1) {  // the next pooled row's 4 new input rows
        stage_rows(ring, rb, xf, H, W, es0, 4 * p + 9, 4 * p + 13, VEC);
        hopper::cp_async_commit();
      }
      pooled_rows(p, carry, ring, rb, wsm, rms, bias_s, rw, pr);
      __syncthreads();
      // the 3 x 3 / 2 max over the row maxima; 8 channels a thread
      for (int e = threadIdx.x; e < qwc * 8; e += THREADS) {
        const int ql = e / 8, cg = e % 8;
        const __nv_bfloat162* r0 = rms + 2 * ql * LDR + 4 * cg;
        uint32_t v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const __nv_bfloat162 m = __hmax2(
              __hmax2(r0[i], r0[LDR + i]), r0[2 * LDR + i]);
          v[i] = *reinterpret_cast<const uint32_t*>(&m);
        }
        *reinterpret_cast<uint4*>(
            yf + ((size_t)p * QWt + q0 + ql) * COUT + 8 * cg) =
            make_uint4(v[0], v[1], v[2], v[3]);
      }
      hopper::cp_async_wait<0>();
      __syncthreads();
    }
  }
}

int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && counts[dev] > 0) return counts[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (dev < 64) counts[dev] = n;
  return n;
}

template <int VEC>
cudaError_t smem_once() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && done[dev]) return cudaSuccess;
  // the largest staged row: a chunk of QW_MAX pooled columns
  e = cudaFuncSetAttribute(stem_wgmma_kernel<VEC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_bytes((2 * (12 * QW_MAX + 40) + 15) /
                                           16 * 16));
  if (e == cudaSuccess && dev < 64) done[dev] = true;
  return e;
}

template <int VEC>
int launch(const void* x, const void* wk, const void* bias, void* y, int N,
           int H, int W, cudaStream_t stream) {
  cudaError_t e = smem_once<VEC>();
  if (e != cudaSuccess) return (int)e;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const Plan p = plan_of(N, H, W, sms);
  stem_wgmma_kernel<VEC><<<p.grid, THREADS, smem_bytes(p.rb), stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wk),
      static_cast<const float*>(bias), static_cast<bf16*>(y), H, W, p.band,
      p.chunks, p.qw, p.items, p.rb);
  return (int)cudaGetLastError();
}

// successful launches per design: 0 the current one, 1 the previous
long long launch_counts[2] = {0, 0};

bool valid(int N, int H, int W) {
  return N > 0 && H > 0 && W > 0 && H % 4 == 0 && W % 4 == 0;
}

}  // namespace
}  // namespace k2

// dtype: 0 = float32, 1 = bfloat16, for x, w and y; bias is float32. All
// pointers are contiguous device buffers, 16-byte aligned: x (N, H, W, 3),
// w (7, 7, 3, 64), bias (64), y (N, H / 4, W / 4, 64). bf16 runs the
// persistent wgmma design, float32 the FMA kernel. Returns a cudaError_t
// value (0 on success).
extern "C" int stem_pool_launch(const void* x, const void* w,
                                const void* bias, void* y, int N, int H,
                                int W, int dtype, void* stream) {
  if (!k2::valid(N, H, W)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0)
    err = k2prev::launch<float>(x, w, bias, y, N, H, W, s);
  else if (dtype == 1)
    err = W % 8 == 0 ? k2::launch<16>(x, w, bias, y, N, H, W, s)
                     : k2::launch<8>(x, w, bias, y, N, H, W, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err == 0) ++k2::launch_counts[0];
  return err;
}

// The previous design (csrc/stem_pool_prev.cuh) in either dtype, for
// timings only; arguments as stem_pool_launch.
extern "C" int stem_pool_prev_launch(const void* x, const void* w,
                                     const void* bias, void* y, int N, int H,
                                     int W, int dtype, void* stream) {
  if (!k2::valid(N, H, W)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0)
    err = k2prev::launch<float>(x, w, bias, y, N, H, W, s);
  else if (dtype == 1)
    err = k2prev::launch<__nv_bfloat16>(x, w, bias, y, N, H, W, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err == 0) ++k2::launch_counts[1];
  return err;
}

// The launches since the library was loaded or reset: out[0] the current
// design's, out[1] the previous design's.
extern "C" void stem_pool_launches(long long* out) {
  out[0] = k2::launch_counts[0];
  out[1] = k2::launch_counts[1];
}

extern "C" void stem_pool_reset() {
  k2::launch_counts[0] = k2::launch_counts[1] = 0;
}

// The bf16 plan as the kernel takes it for sms SMs: out = {band, chunks,
// qw, items, grid, row bytes}; 0, or cudaErrorInvalidValue.
extern "C" int stem_pool_plan(int N, int H, int W, int sms, long long* out) {
  if (!k2::valid(N, H, W) || sms <= 0) return (int)cudaErrorInvalidValue;
  const k2::Plan p = k2::plan_of(N, H, W, sms);
  out[0] = p.band;
  out[1] = p.chunks;
  out[2] = p.qw;
  out[3] = p.items;
  out[4] = p.grid;
  out[5] = p.rb;
  return 0;
}
