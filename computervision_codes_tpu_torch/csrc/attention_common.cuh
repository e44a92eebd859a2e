// Streaming full attention over (B, H, T, D), written by hand for Hopper
// (sm_90a). K7 (attention.cu) exports its forward; so does K8's
// (flash_attention.cu), the same kernels with the row logsumexp written
// out. K8's backward kernels are in flash_attention.cu on the same
// machinery (the producer, the tile layout, the wgmma forms).
//
// Replaces the TPU kernel computervision_codes_tpu/ops/attention.py
// ``attention_pallas`` (``_attn_kernel``): out = softmax((q * D^-1/2) k^T) v
// with the scores, the softmax and the PV sum in float32 and one rounding to
// the input dtype at the output; keys at or past Tk are masked. The TPU
// kernel holds a head's whole K and V in VMEM; here one head's K at
// T = 8192, D = 108 is 1.7 MB of bf16, far above a block's 227 KB of shared
// memory, so K and V stream through shared memory with an online softmax
// (running row max and sum in float32) and no T x T buffer exists.
//
// What bounds it on the H100: at D = 32 and 48 the exponentials (one per
// score, H * Tq * Tk of them, on the SFUs), at larger D in bf16 the tensor
// cores (4 * Tq * Tk * D operations per head), in float32 the FMA pipes.
// The bytes (q, k, v read once, the output written once) are far below
// either.
//
// The grid: (batch, head) on x, blocks of query rows on y and key splits on
// z. ops/attention.py::attention_plan chooses the rows per block and the
// splits so that a short video still puts a block on every SM: with
// splits > 1 each block takes `chunk` keys and writes its rows' O / l and
// logsumexp in float32, and merge_kernel combines the splits through the
// logsumexp (flash-decoding's merge), rounding once.
//
// bf16 (attn_wgmma_kernel<KS, NC, FIX>): warp-specialised. Warpgroup 0
// produces the Q tile (once) and the K and V tiles of 64 keys into a ring
// of ST stages (full/empty mbarriers) in the 128-byte swizzle of
// hopper_gemm.cuh:
//   - by TMA, one thread, where run_wgmma finds a 4-D view (columns, T,
//     heads, B) of q, k and v with 16-byte aligned strides (tma_view), so
//     that a box of one (b, h) reads zeros past its T rows. MS-TCT's
//     (B, T, H, D) views, heads side by side in a row, take the row's
//     columns at D = 32, 48 (whole 128-byte rows; S reads only the head's
//     D columns) and D = 108 (head h at h * 216 bytes: a box starts on the
//     16 bytes before the head, which lands e columns into its tiles);
//     other views whose head stride is a whole 16 bytes (a contiguous
//     (B, H, T, D) with 16-byte rows, MS-TCT's at D = 72) take the head's
//     D columns, zeros past them. Where a Q or K tile holds other heads'
//     columns inside S's k16 steps (D = 108), its boxes land on a third
//     mbarrier and warp 1 of the producer zeroes those columns (Q's once)
//     before it releases the stage, so each head's scores see its own
//     columns only (V's other columns reach only O's, which are not
//     stored). That is an instantiation of its own (FIX), built for
//     D = 97-112; such views at other head dims take cp.async;
//   - else by cp.async from all 128 threads, each a fixed VB-byte chunk of
//     every row, zeros past the rows, the padding columns [D, DP) written
//     once; each thread's copies arrive on the stage's mbarrier when they
//     land (cp.async.mbarrier.arrive), so the producer never waits for its
//     own copies, and a consumer fences the proxy after its wait (wgmma
//     reads through the async proxy). A producer that waited for its own
//     copies a stage later left the consumers waiting for the copies most
//     of the time.
// Warpgroups 1..NC consume, 64 query rows each:
//   S = Q K^T      wgmma m64n64k16, Q (K-major A) and K (K-major B) from
//                  shared memory, KS = ceil(D / 16) steps;
//   softmax        the row max over the quad's shuffles, P = exp2(s * scale
//                  * log2 e - m) rounded to bf16 (as FlashAttention does;
//                  the TPU kernel keeps P float32); the mask only on a tile
//                  that crosses the split's last key; O rescaled only in a
//                  warp where a row's max moved;
//   O += P V       wgmma m64nDPk16 with A = P from registers (the
//                  accumulator of S is the A fragment of P V, packed in
//                  pairs) and V the MN-major B operand; O stays in
//                  registers in float32 across the tiles.
// DP, the padded head dim, is 64 (D <= 64) or 128: one or two 64-column
// swizzle blocks; D = 108 reads 7 k16 steps for S and produces 128 columns
// of O, of which the first 108 are stored. With NC = 2 the consumers hold
// 128 query rows and their softmax and products interleave on the SM's
// schedulers; setmaxnreg moves registers from the producer to them.
//
// float32 (attn_f32_kernel): FMA, so float32 stays float32 (no TF32). One
// block of 4 warps takes 64 query rows; thread (ty, tx) = (tid / 8, tid % 8)
// owns rows ty + 16 i (i < 4), keys tx + 8 c (c < 4) of each 32-key tile
// and output columns 2 tx + 16 jj + {0, 1}. K and V are double-buffered
// through cp.async; q is scaled in float32 as the TPU kernel does; the
// weights exp2(s log2 e - m) pass from the scores to the PV product through
// the warp's own rows of a shared tile with __syncwarp (a warp owns its
// rows), not through a block-wide barrier.
//
// Loads read rows through their strides (the head dim contiguous) in the
// widest copy that every base address and row stride allows (16, 8 or 4
// bytes through cp.async with zero fill; bf16 rows of odd length element
// by element).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace attn {

using bf16 = __nv_bfloat16;

constexpr int D_MAX = 128;
constexpr int PRODUCERS = 128;  // threads of the producer warpgroup
constexpr int SMEM_BLOCK_MAX = 232448;  // the shared memory an H100 block
                                        // can opt into (227 KB)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

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
  float* lse;   // K8: the row logsumexp, float32 (B * H, Tq), or null
  // keys per split (a multiple of the key tile) and the splits; with
  // splits > 1 the forward writes part_o (splits, B * H, Tq, D) = O / l and
  // part_lse (splits, B * H, Tq) in float32, and merge_kernel the output
  int chunk, splits;
  float* part_o;
  float* part_lse;
  // bf16 forward: q, k and v through TMA (tma_view found a view of each),
  // else cp.async. ch: 0 where a view's columns are one head's D (head h
  // is its coordinate 2), else the head stride (head h starts at column
  // h ch of its row; coordinate 2 is 0)
  int tma;
  int chq, chk, chv;
};

// ---- launch counts ---------------------------------------------------------

// per design (0 the current, 1 the previous) and kernel (forward, merge, dQ,
// dK/dV) of this library since it was loaded or reset
enum Counted { K_FWD = 0, K_MERGE = 1, K_DQ = 2, K_DKV = 3 };
namespace {
long long launch_counts[2][4] = {};
}  // namespace

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// ---- copies ------------------------------------------------------------------

// VB bytes global -> shared at `dst`, or VB zero bytes when !ok (src is then
// not read). 16/8/4 bytes through cp.async (a commit group); 2 bytes (one
// bf16) a plain load and store
template <int VB>
__device__ __forceinline__ void copy_chunk(uint32_t dst, const void* src,
                                           bool ok) {
  if constexpr (VB == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  } else if constexpr (VB == 8 || VB == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(VB), "r"(ok ? VB : 0)
                 : "memory");
  } else {
    const unsigned short v =
        ok ? *reinterpret_cast<const unsigned short*>(src) : 0;
    asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(dst), "h"(v) : "memory");
  }
}

// Rows [row0, row0 + R) of a (rows_total, D) bf16 matrix with row stride
// `stride` into a tile of R rows x DP columns in the 128-byte swizzle
// ([DP / 64][R][128 bytes], 1024-byte aligned base), zeros past rows_total.
// Only the columns below D: zero_outside wrote the padding columns once.
// Thread t of the PRODUCERS copies chunk t % CPR of each padded row (its
// column and destination chunk fixed) for rows t / CPR + i * STEP.
template <int R, int DP, int VB>
__device__ __forceinline__ void load_sw_vb(uint32_t tile, const bf16* base,
                                           long long stride, int row0,
                                           int rows_total, int D, int t) {
  constexpr int CPR = DP * 2 / VB;  // chunks per padded row, <= PRODUCERS
  constexpr int STEP = PRODUCERS / CPR;
  const int c = t % CPR, col = c * (VB / 2), byte = c * VB;
  if (col >= D) return;  // D is a whole number of chunks
  const uint32_t off = (byte >> 7) * (R * 128) + (byte & 15);
  const uint32_t chunk = (byte & 127) >> 4;
#pragma unroll 4
  for (int r = t / CPR; r < R; r += STEP) {
    const int row = row0 + r;
    const bool ok = row < rows_total;
    const bf16* src = ok ? base + (long long)row * stride + col : base;
    copy_chunk<VB>(tile + off + r * 128 + ((chunk ^ (r & 7)) << 4), src, ok);
  }
}

template <int R, int DP>
__device__ __forceinline__ void load_sw(uint32_t tile, const bf16* base,
                                        long long stride, int row0,
                                        int rows_total, int D, int vb, int t) {
  switch (vb) {
    case 16: load_sw_vb<R, DP, 16>(tile, base, stride, row0, rows_total, D, t);
      break;
    case 8: load_sw_vb<R, DP, 8>(tile, base, stride, row0, rows_total, D, t);
      break;
    case 4: load_sw_vb<R, DP, 4>(tile, base, stride, row0, rows_total, D, t);
      break;
    default: load_sw_vb<R, DP, 2>(tile, base, stride, row0, rows_total, D, t);
  }
}

// Columns outside [lo, hi) of rows [r0, r0 + rows) of an R-row swizzled
// tile to zero, by the nt threads t: the padding columns before a ring
// starts (the producer never writes them)
template <int R, int DP>
__device__ __forceinline__ void zero_outside(uint8_t* tile, int r0, int rows,
                                             int lo, int hi, int t, int nt) {
  const int w = DP - hi + lo;
  for (int i = t; i < rows * w; i += nt) {
    const int r = r0 + i / w, c = i % w, col = c < lo ? c : hi + c - lo;
    const int inner = (col & 63) * 2;
    *reinterpret_cast<bf16*>(
        tile + (col >> 6) * (R * 128) + r * 128 +
        ((((inner >> 4) ^ (r & 7)) << 4) | (inner & 15))) =
        __float2bfloat16(0.0f);
  }
}

// Columns [0, e) and [e + D, end) of an R-row swizzled tile to zero, rows
// lane, lane + 32, ...: the columns of Q and K that a TMA box took from the
// neighbouring heads, inside S's k16 steps (end - D < 16 columns a row)
template <int R>
__device__ __forceinline__ void zero_foreign(uint8_t* tile, int e, int D,
                                             int end, int lane) {
  const auto zero = [tile](int r, int col) {
    const int inner = (col & 63) * 2;
    *reinterpret_cast<bf16*>(tile + (col >> 6) * (R * 128) + r * 128 +
                             ((((inner >> 4) ^ (r & 7)) << 4) |
                              (inner & 15))) = __float2bfloat16(0.0f);
  };
  for (int r = lane; r < R; r += 32) {
    for (int col = 0; col < e; ++col) zero(r, col);
    for (int col = e + D; col < end; ++col) zero(r, col);
  }
}

// This producer thread's share of a stage is issued: its arrival on `full`
// once its copies have landed. cp.async tracks them on the mbarrier itself
// (the thread goes on to the next stage at once; `full` counts the
// PRODUCERS' arrivals); the 2-byte path stored synchronously, so it fences
// the proxy and arrives (after any cp.async of the stage have landed).
__device__ __forceinline__ void stage_issued(uint64_t* full, int vb) {
  if (vb == 2) {
    hopper::cp_async_commit();  // wait_group waits for committed groups only
    hopper::cp_async_wait<0>();
    hopper::fence_proxy_async();
    hopper::mbar_arrive(full);
  } else {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                     "r"(hopper::smem_u32(full))
                 : "memory");
  }
}

// A consumer has seen `full` complete: the stage's bytes, written through
// the generic proxy (cp.async), are ordered before its wgmma reads of them
// (the async proxy)
__device__ __forceinline__ void stage_landed(uint64_t* full, uint32_t parity) {
  hopper::mbar_wait(full, parity);
  hopper::fence_proxy_async();
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// ---- bf16 fragments ------------------------------------------------------------

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}
// the same, adding the two rounded values to *sum
__device__ __forceinline__ uint32_t pack2_sum(float lo, float hi,
                                              float* sum) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  *sum += __low2float(p) + __high2float(p);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// 2^x on the SFU (ex2.approx.ftz: relative error about 2^-22, far below
// the bf16 rounding of P), one instruction where exp2f adds a range fix
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A 64 x 64 accumulator (d[4j + 2h + c]: row g + 8h, column 8j + 2q + c)
// as the bf16 A fragments of four k16 steps (WgmmaBF16RS)
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a[j >> 1][(j & 1) * 2] = pack2(d[4 * j], d[4 * j + 1]);
    a[j >> 1][(j & 1) * 2 + 1] = pack2(d[4 * j + 2], d[4 * j + 3]);
  }
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) hopper::fence_operand(d[i]);
}

// the same for the A fragments of a register-A wgmma: no instruction that
// writes them moves past the wgmma.fence before their product
__device__ __forceinline__ void fence_frag(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[k][e])::"memory");
}

// X (the 64-row slice at `x`, a tile of `rows` rows) times Y^T (a 64-row
// tile at `y`) over KS k16 steps of the head dim: both K-major
template <int KS>
__device__ __forceinline__ void rows_by_rows(float (&acc)[32], const uint8_t* x,
                                             int rows, const uint8_t* y) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    hopper::WgmmaBF16<64>::run(
        acc, hopper::smem_desc_sw128(x + (kk >> 2) * rows * 128 + (kk & 3) * 32),
        hopper::smem_desc_sw128(y + (kk >> 2) * 64 * 128 + (kk & 3) * 32),
        kk > 0);
}

// acc (64 x DP) += W (64 x 64, A fragments) Y (a 64-row tile, MN-major)
template <int DP>
__device__ __forceinline__ void weights_by_rows(float (&acc)[DP / 2],
                                                const uint32_t (&w)[4][4],
                                                const uint8_t* y) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hopper::WgmmaBF16RS<DP>::run(
        acc, w[kk], hopper::smem_desc_sw128_mn(y + kk * 16 * 128, 64 * 128), 1);
}

// The online softmax of one 64-key tile of scores (the accumulator of
// S = Q K^T, this thread's rows g and g + 8): keys at or past kend masked
// where the tile crosses it, the row max over the quad, alpha = exp2(m_old
// - m_new) (m in log2 units), P = exp2(s sl2 - m) rounded to bf16 into the A
// fragments of P V, l = l alpha + this thread's share of the rounded
// weights
__device__ __forceinline__ void softmax_tile(float (&sc)[32], int kb,
                                             int kend, int tq, float sl2,
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2],
                                             uint32_t (&pa)[4][4]) {
  if (kb + 64 > kend) {  // the tile that crosses the split's last key
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (kb + 8 * (i >> 2) + 2 * tq + (i & 1) >= kend) sc[i] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r] * sl2);  // finite: a key is real
    alpha[r] = ex2(m[r] - mn);
    m[r] = mn;
  }
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    pa[jj >> 1][(jj & 1) * 2] = pack2(ex2(fmaf(sc[4 * jj], sl2, -m[0])),
                                      ex2(fmaf(sc[4 * jj + 1], sl2, -m[0])));
    pa[jj >> 1][(jj & 1) * 2 + 1] =
        pack2(ex2(fmaf(sc[4 * jj + 2], sl2, -m[1])),
              ex2(fmaf(sc[4 * jj + 3], sl2, -m[1])));
  }
  float rs[2] = {0.0f, 0.0f};
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 p =
          *reinterpret_cast<const __nv_bfloat162*>(&pa[kk][e]);
      rs[e & 1] += __low2float(p) + __high2float(p);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
}

// ---- the bf16 forward ----------------------------------------------------------

template <int KS, int NC>
struct FwdCfg {
  static constexpr int DP = KS <= 4 ? 64 : 128;  // padded head dim
  static constexpr int BM = 64 * NC;             // query rows per block
  // ring stages of K and V, each stage's copies tracked on its mbarrier (the
  // producer never waits for its own copies): one block of 128 rows an SM,
  // or two of 64
  static constexpr int ST = NC == 2 ? 5 : (DP == 64 ? 4 : 2);
  static constexpr int THREADS = 128 * (1 + NC);
  static constexpr int MIN_BLOCKS = NC == 2 ? 1 : 2;
  // the registers at launch (65,536 / THREADS / MIN_BLOCKS, rounded down to
  // 8) split as producer + NC consumers
  static constexpr int PRODUCER_REGS = 56;
  static constexpr int CONSUMER_REGS = NC == 2 ? 224 : 200;
  static constexpr int Q_BYTES = BM * DP * 2;
  static constexpr int KV_BYTES = 64 * DP * 2;  // one K or V tile
  // the tiles and three mbarriers a stage (full, empty, landed)
  static constexpr int SMEM = 1024 + Q_BYTES + ST * 2 * KV_BYTES + 3 * ST * 8;
};

// FIX: the TMA boxes of Q and K hold other heads' columns inside S's k16
// steps (run_wgmma decides): they land on `landed`, and warp 1 of the
// producer zeroes those columns before it releases the stage on `full`
// (the consumers wait on `full` either way)
template <int KS, int NC, bool FIX>
__global__ void __launch_bounds__(FwdCfg<KS, NC>::THREADS,
                                  FwdCfg<KS, NC>::MIN_BLOCKS)
attn_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, const Problem p) {
  using C = FwdCfg<KS, NC>;
  constexpr int DP = C::DP, ST = C::ST, KV = C::KV_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = align1024(smem_raw);
  uint8_t* skv = sq + C::Q_BYTES;  // stage s: K at 2 s KV, V at (2 s + 1) KV
  uint64_t* full = reinterpret_cast<uint64_t*>(skv + ST * 2 * KV);
  uint64_t* empty = full + ST;
  uint64_t* landed = empty + ST;

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.y * C::BM;
  const int key0 = blockIdx.z * p.chunk;
  const int kend = min(p.Tk, key0 + p.chunk);
  const int ntiles = (kend - key0 + 63) / 64;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = t % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      // TMA: the producer's expect_tx, or lane 0 of the fixing warp;
      // cp.async: each producer thread
      hopper::mbar_init(&full[s], p.tma ? 1 : PRODUCERS);
      hopper::mbar_init(&empty[s], 4 * NC);  // lane 0 of each consumer warp
      if (FIX) hopper::mbar_init(&landed[s], 1);  // the producer's expect_tx
    }
    hopper::mbar_fence_init();
    if (p.tma) {
      hopper::tma_prefetch_map(&tm_q);
      hopper::tma_prefetch_map(&tm_k);
      hopper::tma_prefetch_map(&tm_v);
    }
  }
  if (!p.tma && p.D < DP) {  // the padding columns, once
    const int nt = C::THREADS;
    zero_outside<C::BM, DP>(sq, 0, C::BM, 0, p.D, threadIdx.x, nt);
    for (int i = 0; i < 2 * ST; ++i)
      zero_outside<64, DP>(skv + i * KV, 0, 64, 0, p.D, threadIdx.x, nt);
    hopper::fence_proxy_async();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: every stage's copies in flight, none waited for -------
    hopper::setmaxnreg_dec<C::PRODUCER_REGS>();
    uint64_t* arrive = FIX ? landed : full;  // where the TMA boxes land
    const bf16* qg = static_cast<const bf16*>(p.q) + b * p.sq.b + h * p.sq.h;
    const bf16* kg = static_cast<const bf16*>(p.k) + b * p.sk.b + h * p.sk.h;
    const bf16* vg = static_cast<const bf16*>(p.v) + b * p.sv.b + h * p.sv.h;
    const uint32_t q32 = hopper::smem_u32(sq), kv32 = hopper::smem_u32(skv);
    if (FIX && t / 32 == 1) {
      // warp 1: the other heads' columns of Q (once) and K inside S's KS
      // k16 steps to zero, then the stage to the consumers
      const int e = (h * p.chq) & 7;
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % ST;
        hopper::mbar_wait(&landed[s], (j / ST) & 1);
        if (j == 0) zero_foreign<C::BM>(sq, e, p.D, 16 * KS, lane);
        zero_foreign<64>(skv + 2 * s * KV, e, p.D, 16 * KS, lane);
        hopper::fence_proxy_async();
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&full[s]);
      }
      return;
    }
    if (p.tma) {  // one thread: DP / 64 boxes of 64 columns a tile
      if (t != 0) return;
      // coordinates (column, t, head, b); a view with ch != 0 holds the
      // heads side by side and a box starts on the 16 bytes before the
      // head's first column, which lands e columns into the tile
      // (run_wgmma gives q, k and v the same e)
      const int qc = h * p.chq & ~7, qh = p.chq ? 0 : h;
      const int kc = h * p.chk & ~7, kh = p.chk ? 0 : h;
      const int vc = h * p.chv & ~7, vh = p.chv ? 0 : h;
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % ST;
        hopper::mbar_wait(&empty[s], ((j / ST) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(
            &arrive[s], 2 * KV + (j == 0 ? C::Q_BYTES : 0));
#pragma unroll
        for (int cb = 0; cb < DP / 64; ++cb) {
          if (j == 0)
            hopper::tma_load_4d(sq + cb * C::BM * 128, &tm_q, qc + 64 * cb,
                                q0, qh, b, &arrive[s]);
          hopper::tma_load_4d(skv + 2 * s * KV + cb * 64 * 128, &tm_k,
                              kc + 64 * cb, key0 + 64 * j, kh, b,
                              &arrive[s]);
          hopper::tma_load_4d(skv + (2 * s + 1) * KV + cb * 64 * 128, &tm_v,
                              vc + 64 * cb, key0 + 64 * j, vh, b,
                              &arrive[s]);
        }
      }
      return;
    }
    for (int j = 0; j < ntiles; ++j) {
      const int s = j % ST;
      hopper::mbar_wait(&empty[s], ((j / ST) & 1) ^ 1);
      if (j == 0)  // Q travels with the first stage
        load_sw<C::BM, DP>(q32, qg, p.sq.t, q0, p.Tq, p.D, p.vb, t);
      const int k0 = key0 + 64 * j;
      load_sw<64, DP>(kv32 + 2 * s * KV, kg, p.sk.t, k0, kend, p.D, p.vb, t);
      load_sw<64, DP>(kv32 + (2 * s + 1) * KV, vg, p.sv.t, k0, kend, p.D,
                      p.vb, t);
      stage_issued(&full[s], p.vb);
    }
  } else {
    // ---- consumers: warpgroup cw + 1 owns query rows 64 cw .. + 63 ---------
    hopper::setmaxnreg_inc<C::CONSUMER_REGS>();
    const int cw = wg - 1, warp = t / 32, g = lane / 4, tq = lane % 4;
    const float sl2 = p.scale * LOG2E;  // exp(x) = exp2(x log2 e)
    const uint8_t* qs = sq + cw * 64 * 128;
    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

    float sc[32], alpha[2];
    uint32_t pa[4][4];
    // TMA: the head's columns are [e, e + D) of the tiles
    const int e = p.tma ? (h * p.chq) & 7 : 0;
    for (int j = 0; j < ntiles; ++j) {
      const int s = j % ST;
      const uint8_t* kt = skv + 2 * s * KV;
      stage_landed(&full[s], (j / ST) & 1);
      hopper::wgmma_fence();
      rows_by_rows<KS>(sc, qs, C::BM, kt);  // S = Q K^T
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      fence_acc(sc);
      softmax_tile(sc, key0 + 64 * j, kend, tq, sl2, m, l, alpha, pa);
      // a warp whose rows kept their max (most tiles once the max has
      // settled) would multiply by 1: skip it
      if (__any_sync(0xffffffffu, alpha[0] != 1.0f || alpha[1] != 1.0f)) {
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      }
      fence_acc(o);
      fence_frag(pa);
      hopper::wgmma_fence();
      weights_by_rows<DP>(o, pa, kt + KV);  // O += P V
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      fence_acc(o);
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }

    const int row0 = q0 + cw * 64 + warp * 16 + g;
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // row sums over the 4 threads of a row
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = row0 + 8 * r;
      if (row >= p.Tq) continue;
      const long long at = (long long)bh * p.Tq + row;
      const float lse = (m[r] + log2f(l[r])) * LN2;  // m is in log2 units
      if (p.splits > 1) {
        float* po = p.part_o + ((long long)blockIdx.z * p.B * p.H * p.Tq + at) *
                                   p.D;
#pragma unroll
        for (int jj = 0; jj < DP / 8; ++jj)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = 8 * jj + 2 * tq + c - e;
            if (col >= 0 && col < p.D) po[col] = o[4 * jj + 2 * r + c] / l[r];
          }
        if (tq == 0)
          p.part_lse[(long long)blockIdx.z * p.B * p.H * p.Tq + at] = lse;
      } else {
        bf16* og = static_cast<bf16*>(p.o) + b * p.so.b + h * p.so.h +
                   row * p.so.t;
#pragma unroll
        for (int jj = 0; jj < DP / 8; ++jj)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = 8 * jj + 2 * tq + c - e;
            if (col >= 0 && col < p.D)
              og[col] = __float2bfloat16(o[4 * jj + 2 * r + c] / l[r]);
          }
        if (p.lse != nullptr && tq == 0) p.lse[at] = lse;
      }
    }
  }
}

// ---- float32: FMA ----------------------------------------------------------------

// Rows [row0, row0 + rows) of a (rows_total, D) float32 matrix into shared
// memory at row stride `ld` floats, zeros past rows_total; columns [D, ld)
// untouched. All THREADS threads copy.
template <int THREADS, int VB>
__device__ __forceinline__ void load_rows_vb(float* smem, int ld,
                                             const float* base,
                                             long long stride, int row0,
                                             int rows, int rows_total, int D) {
  constexpr int VE = VB / 4;
  const int cpr = D / VE;
  for (int i = threadIdx.x; i < rows * cpr; i += THREADS) {
    const int r = i / cpr, c = (i - r * cpr) * VE;
    const int row = row0 + r;
    const bool ok = row < rows_total;
    copy_chunk<VB>(static_cast<uint32_t>(__cvta_generic_to_shared(
                       smem + r * ld + c)),
                   ok ? base + (long long)row * stride + c : base, ok);
  }
}

template <int THREADS>
__device__ __forceinline__ void load_rows(float* smem, int ld,
                                          const float* base, long long stride,
                                          int row0, int rows, int rows_total,
                                          int D, int vb) {
  if (vb == 16)
    load_rows_vb<THREADS, 16>(smem, ld, base, stride, row0, rows, rows_total,
                              D);
  else if (vb == 8)
    load_rows_vb<THREADS, 8>(smem, ld, base, stride, row0, rows, rows_total,
                             D);
  else
    load_rows_vb<THREADS, 4>(smem, ld, base, stride, row0, rows, rows_total,
                             D);
}

// zero columns [D, dp) of `rows` rows at row stride `ld`
template <int THREADS>
__device__ __forceinline__ void zero_cols(float* smem, int ld, int rows, int D,
                                          int dp) {
  const int w = dp - D;
  for (int i = threadIdx.x; i < rows * w; i += THREADS)
    smem[(i / w) * ld + D + i % w] = 0.0f;
}

constexpr int F_BM = 64;       // query (or key) rows a block owns
constexpr int F_BN = 32;       // rows of a streamed tile
constexpr int F_THREADS = 128;

template <int NJ>
struct F32Tiles {
  static constexpr int DP = 16 * NJ;
  static constexpr int LD = DP + 4;     // LD / 4 odd: conflict-free float4 rows
  static constexpr int LDP = F_BN + 4;  // the warps' weight rows
  static constexpr size_t smem() {      // Q, (K, V) twice, P
    return ((size_t)(F_BM + 4 * F_BN) * LD + (size_t)F_BM * LDP) *
           sizeof(float);
  }
};

// s[i][c] = X[ty + 16 i] . Y[tx + 8 c] over the padded head dim (X rows at
// stride LD, Y a streamed tile)
template <int NJ, int C>
__device__ __forceinline__ void rows_dot(float (&s)[4][C], const float* X,
                                         const float* Y, int ty, int tx) {
  constexpr int LD = F32Tiles<NJ>::LD;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) s[i][c] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < F32Tiles<NJ>::DP; d += 4) {
    float4 xv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      xv[i] = *reinterpret_cast<const float4*>(X + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int c = 0; c < C; ++c) {
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

// out[i][jj] += W[ty + 16 i, :F_BN] Y[:F_BN, 2 tx + 16 jj + {0, 1}], W the
// warp's own rows of the weight tile (row stride LDP), Y a streamed tile
template <int NJ>
__device__ __forceinline__ void weights_by_rows_f32(float (&out)[4][NJ][2],
                                                    const float* W,
                                                    const float* Y, int ty,
                                                    int tx) {
  constexpr int LD = F32Tiles<NJ>::LD, LDP = F32Tiles<NJ>::LDP;
#pragma unroll 2
  for (int kk = 0; kk < F_BN; kk += 4) {
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
__global__ void __launch_bounds__(F_THREADS) attn_f32_kernel(const Problem p) {
  using Tiles = F32Tiles<NJ>;
  constexpr int LD = Tiles::LD, LDP = Tiles::LDP, DP = Tiles::DP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  auto Ks = [&](int s) { return Qs + F_BM * LD + s * 2 * F_BN * LD; };
  auto Vs = [&](int s) { return Ks(s) + F_BN * LD; };
  float* Ps = Qs + (F_BM + 4 * F_BN) * LD;

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.y * F_BM;
  const int key0 = blockIdx.z * p.chunk;
  const int kend = min(p.Tk, key0 + p.chunk);
  const int ntiles = (kend - key0 + F_BN - 1) / F_BN;
  const float* qg = static_cast<const float*>(p.q) + b * p.sq.b + h * p.sq.h;
  const float* kg = static_cast<const float*>(p.k) + b * p.sk.b + h * p.sk.h;
  const float* vg = static_cast<const float*>(p.v) + b * p.sv.b + h * p.sv.h;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;

  zero_cols<F_THREADS>(Qs, LD, F_BM + 4 * F_BN, p.D, DP);
  load_rows<F_THREADS>(Qs, LD, qg, p.sq.t, q0, F_BM, p.Tq, p.D, p.vb);
  load_rows<F_THREADS>(Ks(0), LD, kg, p.sk.t, key0, F_BN, kend, p.D, p.vb);
  load_rows<F_THREADS>(Vs(0), LD, vg, p.sv.t, key0, F_BN, kend, p.D, p.vb);
  hopper::cp_async_commit();

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
    const int cur = j & 1;
    if (j + 1 < ntiles) {  // prefetch the next tile into the other buffer
      const int k0 = key0 + (j + 1) * F_BN;
      load_rows<F_THREADS>(Ks(cur ^ 1), LD, kg, p.sk.t, k0, F_BN, kend, p.D,
                           p.vb);
      load_rows<F_THREADS>(Vs(cur ^ 1), LD, vg, p.sv.t, k0, F_BN, kend, p.D,
                           p.vb);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();  // everything but the prefetch has landed
    __syncthreads();
    if (j == 0) {
      for (int i = threadIdx.x; i < F_BM * p.D; i += F_THREADS)
        Qs[(i / p.D) * LD + i % p.D] *= p.scale;  // q * scale in float32
      __syncthreads();
    }

    float s[4][4];
    rows_dot<NJ, 4>(s, Qs, Ks(cur), ty, tx);
    const int kb = key0 + j * F_BN;
    if (kb + F_BN > kend) {  // the tile that crosses the split's last key
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (kb + tx + 8 * c >= kend) s[i][c] = -INFINITY;
    }
    float* Pw = Ps;  // this thread's rows are its warp's own
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) mx = fmaxf(mx, s[i][c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float mn = fmaxf(m[i], mx * LOG2E);
      const float alpha = exp2f(m[i] - mn);
      m[i] = mn;
      float rs = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float e = exp2f(fmaf(s[i][c], LOG2E, -mn));
        Pw[(ty + 16 * i) * LDP + tx + 8 * c] = e;
        rs += e;
      }
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        o[i][jj][0] *= alpha;
        o[i][jj][1] *= alpha;
      }
    }
    __syncwarp();
    // O += P V (keys past the split have weight 0 and zero rows of V)
    weights_by_rows_f32<NJ>(o, Pw, Vs(cur), ty, tx);
    __syncthreads();  // the other buffer is refilled next tile
  }

  const long long rows_all = (long long)p.B * p.H * p.Tq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 4);
    const int row = q0 + ty + 16 * i;
    if (row >= p.Tq) continue;
    const long long at = (long long)bh * p.Tq + row;
    const float lse = (m[i] + log2f(l[i])) * LN2;
    float* out = p.splits > 1
                     ? p.part_o + (blockIdx.z * rows_all + at) * p.D
                     : static_cast<float*>(p.o) + b * p.so.b + h * p.so.h +
                           row * p.so.t;
    if (tx == 0) {
      if (p.splits > 1)
        p.part_lse[blockIdx.z * rows_all + at] = lse;
      else if (p.lse != nullptr)
        p.lse[at] = lse;
    }
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 2 * tx + 16 * jj + e;
        if (col < p.D) out[col] = o[i][jj][e] / l[i];
      }
  }
}

// ---- the split merge ------------------------------------------------------------

// One warp per (batch, head, query row): lse = log sum_s exp(lse_s), out =
// sum_s exp(lse_s - lse) O_s rounded once to T, the lse written if asked
template <typename T>
__global__ void __launch_bounds__(128) merge_kernel(const Problem p) {
  const long long rows_all = (long long)p.B * p.H * p.Tq;
  const long long at = (long long)blockIdx.x * 4 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (at >= rows_all) return;
  const int bh = (int)(at / p.Tq), row = (int)(at % p.Tq);
  const int b = bh / p.H, h = bh % p.H;
  float mx = -INFINITY;
  for (int s = 0; s < p.splits; ++s)
    mx = fmaxf(mx, p.part_lse[s * rows_all + at]);
  float sum = 0.0f;
  for (int s = 0; s < p.splits; ++s)
    sum += expf(p.part_lse[s * rows_all + at] - mx);
  const float lse = mx + logf(sum);
  T* og = static_cast<T*>(p.o) + b * p.so.b + h * p.so.h + row * p.so.t;
  for (int col = lane; col < p.D; col += 32) {
    float acc = 0.0f;
    for (int s = 0; s < p.splits; ++s)
      acc += expf(p.part_lse[s * rows_all + at] - lse) *
             p.part_o[(s * rows_all + at) * p.D + col];
    og[col] = from_f<T>(acc);
  }
  if (p.lse != nullptr && lane == 0) p.lse[at] = lse;
}

// ---- launches ------------------------------------------------------------------

namespace {

// The shared-memory attribute of `Kernel`, set once per device. Internal
// linkage: a function-local static of a template shared by several
// libraries would be one object in the process (a GNU unique symbol), and
// each library must set the attribute of its own kernel.
template <auto Kernel>
cudaError_t smem_once(int bytes) {
  static bool done[64] = {};
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess && dev < 64) done[dev] = true;
  return e;
}

template <auto Kernel>
cudaError_t launch_smem(dim3 grid, int threads, int smem, const Problem& p,
                        cudaStream_t s) {
  const cudaError_t e = smem_once<Kernel>(smem);
  if (e != cudaSuccess) return e;
  Kernel<<<grid, threads, smem, s>>>(p);
  return cudaGetLastError();
}

// A 4-D bf16 view (cols, T, heads, B) with element strides (1, st, sh, sb)
// as boxes of 64 columns x box_rows rows of one (head, b) in the 128-byte
// swizzle, zeros outside it; through a per-thread cache (a map holds only
// these numbers).
int encode_bf16(CUtensorMap* map, const void* base, long long cols, int T,
                int heads, int B, long long st, long long sh, long long sb,
                int box_rows) {
  struct Entry {
    const void* base;
    long long cols, st, sh, sb;
    int T, heads, B, box_rows;
    CUtensorMap map;
  };
  constexpr int SLOTS = 64;
  thread_local Entry cache[SLOTS] = {};
  thread_local int next = 0;
  for (const Entry& e : cache)
    if (e.base == base && e.cols == cols && e.st == st && e.sh == sh &&
        e.sb == sb && e.T == T && e.heads == heads && e.B == B &&
        e.box_rows == box_rows) {
      *map = e.map;
      return 0;
    }
  hopper::EncodeTiledFn fn = hopper::encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)T,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64u, (cuuint32_t)box_rows, 1u, 1u};
  const cuuint32_t elem[4] = {1u, 1u, 1u, 1u};
  if (fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  cache[next] = Entry{base, cols, st, sh, sb, T, heads, B, box_rows, *map};
  next = (next + 1) % SLOTS;
  return 0;
}

// A TMA view of a (B, H, T, D) bf16 tensor with element strides (sb, sh,
// st, 1), as a 4-D map whose boxes read zeros past the T rows of their
// (b, h). TMA needs a 16-byte aligned base and strides. Where the heads
// sit side by side in a row (MS-TCT's (B, T, H, D) projections) and D is
// a whole number of k16 steps, or sh is not a whole 16 bytes (D = 108),
// the columns are the row's (H - 1) sh + D, one head, and *ch = sh: head h
// starts at column h sh, and the kernel's box at that column rounded down
// to 8, so a box reads whole 128-byte rows and other heads' columns (the
// kernel zeroes those inside S's k16 steps; V's reach only columns of O
// that are not stored). Else, where sh is a whole 16 bytes, the columns
// are the head's D (zeros past them) and *ch = 0. A stride of a dimension
// of size 1 is not read. False if there is none.
bool tma_view(const void* base, const Strides& s, int B, int H, int T, int D,
              int box_rows, int* ch, CUtensorMap* map) {
  const long long st = s.t, sh = H == 1 ? st : s.h, sb = B == 1 ? st : s.b;
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || st % 8 != 0 ||
      sb % 8 != 0 || st < D)
    return false;
  const bool in_row = sh >= D && (long long)(H - 1) * sh + D <= st &&
                      sh <= 0x7fffffffLL;
  if (in_row && (sh % 8 != 0 || D % 16 == 0)) {
    *ch = (int)sh;
    return encode_bf16(map, base, (H - 1) * sh + D, T, 1, B, st, st, sb,
                       box_rows) == 0;
  }
  if (sh % 8 != 0) return false;
  *ch = 0;
  return encode_bf16(map, base, D, T, H, B, st, sh, sb, box_rows) == 0;
}

template <int KS, int NC, bool FIX>
cudaError_t launch_wgmma(dim3 grid, const CUtensorMap& tq,
                         const CUtensorMap& tk, const CUtensorMap& tv,
                         const Problem& p, cudaStream_t s) {
  using C = FwdCfg<KS, NC>;
  const cudaError_t e = smem_once<attn_wgmma_kernel<KS, NC, FIX>>(C::SMEM);
  if (e != cudaSuccess) return e;
  attn_wgmma_kernel<KS, NC, FIX><<<grid, C::THREADS, C::SMEM, s>>>(tq, tk,
                                                                   tv, p);
  return cudaGetLastError();
}

// The bf16 forward: TMA where q, k and v have views with one offset e per
// head and D + e within the KS k16 steps, else cp.async. A view whose boxes
// take other heads' columns into S (a head stride that is not a whole 16
// bytes, MS-TCT's D = 108) launches the FIX kernel, which is built for
// D = 97-112 (KS = 7) only: at other head dims such views take cp.async.
template <int KS, int NC>
cudaError_t run_wgmma(dim3 grid, Problem p, cudaStream_t s) {
  using C = FwdCfg<KS, NC>;
  static_assert(C::SMEM <= SMEM_BLOCK_MAX, "the forward's tiles and ring");
  CUtensorMap tq{}, tk{}, tv{};
  p.tma = tma_view(p.q, p.sq, p.B, p.H, p.Tq, p.D, C::BM, &p.chq, &tq) &&
          tma_view(p.k, p.sk, p.B, p.H, p.Tk, p.D, 64, &p.chk, &tk) &&
          tma_view(p.v, p.sv, p.B, p.H, p.Tk, p.D, 64, &p.chv, &tv);
  int emax = 0;
  if (p.tma) {
    // a box starts on 16 bytes, so head h's columns sit (h ch) % 8 columns
    // into its tile: the same offset in q, k and v, and D plus it within
    // the KS k16 steps of Q K^T
    for (int h = 0; h < p.H && h < 8; ++h)
      emax = max(emax, (h * p.chq) & 7);
    p.tma = p.chq % 8 == p.chk % 8 && p.chq % 8 == p.chv % 8 &&
            p.D + emax <= 16 * KS;
  }
  // other heads' columns inside S: a view of the row's columns (ch != 0)
  // whose heads do not fill the k16 steps exactly
  if (p.tma && (p.chq | p.chk) != 0 && (emax > 0 || p.D < 16 * KS)) {
    if constexpr (KS == 7)
      return launch_wgmma<KS, NC, true>(grid, tq, tk, tv, p, s);
    p.tma = 0;
  }
  return launch_wgmma<KS, NC, false>(grid, tq, tk, tv, p, s);
}

template <int KS>
cudaError_t run_bf16(int rows, dim3 grid, const Problem& p, cudaStream_t s) {
  return rows == 128 ? run_wgmma<KS, 2>(grid, p, s)
                     : run_wgmma<KS, 1>(grid, p, s);
}

template <int NJ>
cudaError_t run_f32(dim3 grid, const Problem& p, cudaStream_t s) {
  static_assert(F32Tiles<NJ>::smem() <= SMEM_BLOCK_MAX, "the float32 tiles");
  return launch_smem<attn_f32_kernel<NJ>>(grid, F_THREADS,
                                          (int)F32Tiles<NJ>::smem(), p, s);
}

// The forward in the current design: rows (query rows per block: 128 or 64
// in bf16, 64 in float32), p.chunk and p.splits as attention_plan chose
// them; with p.splits > 1 the partials, then the merge. dtype 0 float32,
// 1 bf16. Counts its launches.
cudaError_t forward(const Problem& p, int rows, int dtype,
                           cudaStream_t s) {
  const int tile = dtype == 1 ? 64 : F_BN;
  if (p.chunk < tile || p.chunk % tile != 0 || p.splits < 1 ||
      (long long)(p.splits - 1) * p.chunk >= p.Tk ||
      (long long)p.splits * p.chunk < p.Tk || p.splits > 65535 ||
      (dtype == 1 ? (rows != 64 && rows != 128) : rows != F_BM) ||
      (p.Tq + rows - 1) / rows > 65535 ||
      (p.splits > 1 && (p.part_o == nullptr || p.part_lse == nullptr)))
    return cudaErrorInvalidValue;
  const dim3 grid(p.B * p.H, (p.Tq + rows - 1) / rows, p.splits);
  const int k16 = (p.D + 15) / 16;
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 1) {
    switch (k16) {
      case 1: e = run_bf16<1>(rows, grid, p, s); break;
      case 2: e = run_bf16<2>(rows, grid, p, s); break;
      case 3: e = run_bf16<3>(rows, grid, p, s); break;
      case 4: e = run_bf16<4>(rows, grid, p, s); break;
      case 5: e = run_bf16<5>(rows, grid, p, s); break;
      case 6: e = run_bf16<6>(rows, grid, p, s); break;
      case 7: e = run_bf16<7>(rows, grid, p, s); break;
      case 8: e = run_bf16<8>(rows, grid, p, s); break;
    }
  } else {
    switch (k16) {
      case 1: e = run_f32<1>(grid, p, s); break;
      case 2: e = run_f32<2>(grid, p, s); break;
      case 3: e = run_f32<3>(grid, p, s); break;
      case 4: e = run_f32<4>(grid, p, s); break;
      case 5: e = run_f32<5>(grid, p, s); break;
      case 6: e = run_f32<6>(grid, p, s); break;
      case 7: e = run_f32<7>(grid, p, s); break;
      case 8: e = run_f32<8>(grid, p, s); break;
    }
  }
  if (e != cudaSuccess) return e;
  ++launch_counts[0][K_FWD];
  if (p.splits == 1) return cudaSuccess;
  const long long rows_all = (long long)p.B * p.H * p.Tq;
  const unsigned blocks = (unsigned)((rows_all + 3) / 4);
  if (dtype == 1)
    merge_kernel<bf16><<<blocks, 128, 0, s>>>(p);
  else
    merge_kernel<float><<<blocks, 128, 0, s>>>(p);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++launch_counts[0][K_MERGE];
  return e;
}

bool valid_rows(int B, int H, int Tq, int Tk, int D, int vb,
                       int dtype) {
  const int es = dtype == 1 ? 2 : 4;
  return D >= 1 && D <= D_MAX && Tq >= 1 && Tk >= 1 && B >= 1 && H >= 1 &&
         (long long)B * H <= 0x7fffffffLL && (dtype == 0 || dtype == 1) &&
         (vb == 16 || vb == 8 || vb == 4 || (vb == 2 && dtype == 1)) &&
         D % (vb / es) == 0;
}

}  // namespace

}  // namespace attn

// This library's launches since it was loaded (or last reset): out[4 d + k]
// for design d (0 the current, 1 the previous) and kernel k (0 the forward,
// 1 the split merge, 2 dQ, 3 dK/dV).
extern "C" void attention_launches(long long* out) {
  for (int d = 0; d < 2; ++d)
    for (int k = 0; k < 4; ++k) out[4 * d + k] = attn::launch_counts[d][k];
}

extern "C" void attention_reset() {
  for (auto& row : attn::launch_counts)
    for (long long& n : row) n = 0;
}
