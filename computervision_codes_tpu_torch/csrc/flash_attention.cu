// K8: streaming flash attention over (B, H, T, D), forward and backward,
// written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of
// computervision_codes_tpu/ops/attention.py: ``flash_attention_pallas``
// (``_flash_kernel``) and ``flash_attention``'s ``_flash_fwd_kernel``
// (forward, the second also writing the row logsumexp), ``_flash_dq_kernel``
// (dQ over query blocks) and ``_flash_dkv_kernel`` (dK and dV over key
// blocks). With s = (q * D^-1/2) k^T, lse = logsumexp_j s, P = exp(s - lse),
// dvec = rowsum(dO * O) (computed outside, in float32, as JAX does in XLA):
//
//   dS = P * (dO V^T - dvec) * D^-1/2,  dQ = dS K,  dV = P^T dO,  dK = dS^T Q
//
// - forward: attention_common.cuh's (K7's) with the float32 lse written
//   (the TPU's two forward kernels are one kernel here, the lse pointer null
//   for ``flash_attention_pallas``), split over keys where the plan says;
// - dQ: one block per ((batch, head), 64 queries) holds its Q and dO tiles
//   and their lse and dvec, streams K and V, and accumulates dQ;
// - dK/dV: one block per ((batch, head), 64 keys) holds its K and V tiles,
//   streams Q, dO, lse and dvec, and accumulates dK and dV.
//
// Each tile of dQ, dK and dV has one owner block: no atomics, and the
// gradients are deterministic. Streamed rows past T are zero (q, k, v and
// dO zero-filled, lse and dvec 0), so a padded query or key adds nothing to
// a real row; the keys of dQ's last tile are masked all the same (exp of
// 0 - lse may overflow where every score is very negative).
//
// What bounds it on the H100: the products, 4 Tq Tk D operations per head
// forward and 10 backward (dQ: S, dP, dS K; dK/dV: S^T, dP^T, P^T dO,
// dS^T Q, so S and dP are computed twice, once in each kernel: 14 in the
// two backward kernels), on the tensor cores in bf16 and on the FMA pipes
// in float32; at small D the exponentials too (one per score per kernel).
// The bytes (each tensor read once, the outputs written once) are far
// below either.
//
// bf16: the forward's machinery (attention_common.cuh). Warpgroup 0
// produces: cp.async of the stationary tiles (Q and dO, or K and V) once
// and of the streamed 64-row tiles (K and V, or Q, dO, lse and dvec) into a
// 2-stage ring in the 128-byte swizzle, full/empty mbarriers, each
// thread's copies arriving on the stage's mbarrier as they land. Warpgroup 1
// consumes, 64 rows: every product on wgmma m64nNk16 - the scores (S, dP or
// S^T, dP^T) with both operands K-major from shared memory, the gradient
// products with the weights (dS, or P^T and dS^T) from registers (the
// scores' accumulators packed into A fragments) and the streamed tile as
// the MN-major B operand, the gradients in float32 registers across the
// tiles. P and dS are rounded to bf16 before their products (as K7 rounds
// P; the TPU kernels keep them float32), their float32 values feed dS.
//
// float32: FMA (no TF32). Thread (ty, tx) = (tid / 8, tid % 8) owns rows
// ty + 16 i (i < 4) of its 64, score columns tx + 8 c (c < 4) of each
// 32-row streamed tile and output columns 2 tx + 16 jj + {0, 1}; the
// streamed tiles double-buffered through cp.async; the weights pass to
// their product through the warp's own rows of a shared tile (__syncwarp);
// exp2 of log2-scaled scores.
//
// flash_attention_fwd_prev_launch and flash_attention_bwd_prev_launch run
// the previous design (attention_prev.cuh, flash_prev.cuh), the parent that
// chip_smoke.py times against; no model or op path calls them.

#include <type_traits>

#include "attention_common.cuh"
#include "flash_prev.cuh"

namespace flash {

using namespace attn;

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

// a 64 x DP accumulator of rows row0 + 16 warp + g + 8 h into rows below
// rows_total, columns below D, rounded to bf16
template <int DP>
__device__ __forceinline__ void store_acc(bf16* out, long long stride,
                                          const float (&acc)[DP / 2], int row0,
                                          int rows_total, int D, int tq) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= rows_total) continue;
#pragma unroll
    for (int jj = 0; jj < DP / 8; ++jj)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * jj + 2 * tq + c;
        if (col < D)
          out[row * stride + col] = __float2bfloat16(acc[4 * jj + 2 * r + c]);
      }
  }
}

// ---- bf16: dQ --------------------------------------------------------------

template <int KS>
struct DqCfg {
  static constexpr int DP = KS <= 4 ? 64 : 128;
  static constexpr int ST = 2;
  static constexpr int THREADS = 256;
  static constexpr int MIN_BLOCKS = 2;
  static constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 200;
  static constexpr int TILE = 64 * DP * 2;  // one 64-row tile
  static constexpr int SMEM = 1024 + 2 * TILE + ST * 2 * TILE + 2 * ST * 8;
};

template <int KS>
__global__ void __launch_bounds__(DqCfg<KS>::THREADS, DqCfg<KS>::MIN_BLOCKS)
dq_wgmma_kernel(const Bwd p) {
  using C = DqCfg<KS>;
  constexpr int DP = C::DP, ST = C::ST, T = C::TILE;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = align1024(smem_raw);
  uint8_t* sg = sq + T;
  uint8_t* skv = sg + T;  // stage s: K at 2 s T, V at (2 s + 1) T
  uint64_t* full = reinterpret_cast<uint64_t*>(skv + ST * 2 * T);
  uint64_t* empty = full + ST;

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.y * 64;
  const int ntiles = (p.Tk + 63) / 64;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = t % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], PRODUCERS);
      hopper::mbar_init(&empty[s], 4);
    }
    hopper::mbar_fence_init();
  }
  if (p.D < DP) {  // the padding columns, once
    for (int i = 0; i < 2 + 2 * ST; ++i)
      zero_outside<64, DP>(sq + i * T, 0, 64, 0, p.D, threadIdx.x,
                           C::THREADS);
    hopper::fence_proxy_async();
  }
  __syncthreads();

  if (wg == 0) {
    hopper::setmaxnreg_dec<C::PRODUCER_REGS>();
    const bf16* qg = head<bf16>(p.q, p.sq, b, h);
    const bf16* gg = head<bf16>(p.g, p.sg, b, h);
    const bf16* kg = head<bf16>(p.k, p.sk, b, h);
    const bf16* vg = head<bf16>(p.v, p.sv, b, h);
    const uint32_t q32 = hopper::smem_u32(sq), kv32 = hopper::smem_u32(skv);
    for (int j = 0; j < ntiles; ++j) {
      const int s = j % ST;
      hopper::mbar_wait(&empty[s], ((j / ST) & 1) ^ 1);
      if (j == 0) {
        load_sw<64, DP>(q32, qg, p.sq.t, q0, p.Tq, p.D, p.vb, t);
        load_sw<64, DP>(q32 + T, gg, p.sg.t, q0, p.Tq, p.D, p.vb, t);
      }
      load_sw<64, DP>(kv32 + 2 * s * T, kg, p.sk.t, 64 * j, p.Tk, p.D, p.vb,
                      t);
      load_sw<64, DP>(kv32 + (2 * s + 1) * T, vg, p.sv.t, 64 * j, p.Tk, p.D,
                      p.vb, t);
      stage_issued(&full[s], p.vb);
    }
  } else {
    hopper::setmaxnreg_inc<C::CONSUMER_REGS>();
    const int warp = t / 32, g = lane / 4, tq = lane % 4;
    const float sl2 = p.scale * LOG2E;
    const int row0 = q0 + warp * 16 + g;
    float lse2[2], dvec[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const bool ok = row < p.Tq;
      lse2[r] = ok ? p.lse[(long long)bh * p.Tq + row] * LOG2E : 0.0f;
      dvec[r] = ok ? p.dvec[(long long)bh * p.Tq + row] : 0.0f;
    }
    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;

    for (int j = 0; j < ntiles; ++j) {
      const int s = j % ST;
      const uint8_t* kt = skv + 2 * s * T;
      stage_landed(&full[s], (j / ST) & 1);
      float sc[32], dp[32];
      hopper::wgmma_fence();
      rows_by_rows<KS>(sc, sq, 64, kt);      // S = Q K^T
      rows_by_rows<KS>(dp, sg, 64, kt + T);  // dP = dO V^T
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      fence_acc(sc);
      fence_acc(dp);
      const int kb = 64 * j;
      const bool edge = kb + 64 > p.Tk;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        float pw = ex2(fmaf(sc[i], sl2, -lse2[r]));
        if (edge && kb + 8 * (i >> 2) + 2 * tq + (i & 1) >= p.Tk) pw = 0.0f;
        sc[i] = pw * (dp[i] - dvec[r]) * p.scale;  // dS
      }
      uint32_t da[4][4];
      to_a(da, sc);
      fence_acc(acc);
      fence_frag(da);
      hopper::wgmma_fence();
      weights_by_rows<DP>(acc, da, kt);  // dQ += dS K
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }
    store_acc<DP>(head_out<bf16>(p.dq, p.sdq, b, h), p.sdq.t, acc, row0, p.Tq,
                  p.D, tq);
  }
}

// ---- bf16: dK and dV ---------------------------------------------------------

template <int KS>
struct DkvCfg {
  static constexpr int DP = KS <= 4 ? 64 : 128;
  static constexpr int ST = 2;
  static constexpr int THREADS = 256;
  // at DP = 64 two blocks share an SM, the producer's registers moved to
  // the consumers; at 128 the consumers' dK, dV, S^T and dP^T need ~240
  static constexpr int MIN_BLOCKS = DP == 64 ? 2 : 1;
  static constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 200;
  static constexpr int TILE = 64 * DP * 2;
  // K and V, ST x (Q, dO), ST x 64 lse and dvec, the barriers
  static constexpr int SMEM =
      1024 + 2 * TILE + ST * 2 * TILE + ST * 2 * 64 * 4 + 2 * ST * 8;
};

template <int KS>
__global__ void __launch_bounds__(DkvCfg<KS>::THREADS, DkvCfg<KS>::MIN_BLOCKS)
dkv_wgmma_kernel(const Bwd p) {
  using C = DkvCfg<KS>;
  constexpr int DP = C::DP, ST = C::ST, T = C::TILE;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sk = align1024(smem_raw);
  uint8_t* sv = sk + T;
  uint8_t* sqg = sv + T;  // stage s: Q at 2 s T, dO at (2 s + 1) T
  float* ls = reinterpret_cast<float*>(sqg + ST * 2 * T);  // ST x 64 lse
  float* ds = ls + ST * 64;                                // ST x 64 dvec
  uint64_t* full = reinterpret_cast<uint64_t*>(ds + ST * 64);
  uint64_t* empty = full + ST;

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.y * 64;
  const int ntiles = (p.Tq + 63) / 64;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = t % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], PRODUCERS);
      hopper::mbar_init(&empty[s], 4);
    }
    hopper::mbar_fence_init();
  }
  if (p.D < DP) {  // the padding columns, once
    for (int i = 0; i < 2 + 2 * ST; ++i)
      zero_outside<64, DP>(sk + i * T, 0, 64, 0, p.D, threadIdx.x,
                           C::THREADS);
    hopper::fence_proxy_async();
  }
  __syncthreads();

  if (wg == 0) {
    if constexpr (C::MIN_BLOCKS == 2)
      hopper::setmaxnreg_dec<C::PRODUCER_REGS>();
    const bf16* qg = head<bf16>(p.q, p.sq, b, h);
    const bf16* gg = head<bf16>(p.g, p.sg, b, h);
    const bf16* kg = head<bf16>(p.k, p.sk, b, h);
    const bf16* vg = head<bf16>(p.v, p.sv, b, h);
    const uint32_t k32 = hopper::smem_u32(sk), qg32 = hopper::smem_u32(sqg);
    const float* vec = (t < 64 ? p.lse : p.dvec) + (long long)bh * p.Tq;
    const uint32_t vdst = hopper::smem_u32((t < 64 ? ls : ds) + t % 64);
    for (int j = 0; j < ntiles; ++j) {
      const int s = j % ST;
      hopper::mbar_wait(&empty[s], ((j / ST) & 1) ^ 1);
      if (j == 0) {
        load_sw<64, DP>(k32, kg, p.sk.t, k0, p.Tk, p.D, p.vb, t);
        load_sw<64, DP>(k32 + T, vg, p.sv.t, k0, p.Tk, p.D, p.vb, t);
      }
      const int i0 = 64 * j;
      load_sw<64, DP>(qg32 + 2 * s * T, qg, p.sq.t, i0, p.Tq, p.D, p.vb, t);
      load_sw<64, DP>(qg32 + (2 * s + 1) * T, gg, p.sg.t, i0, p.Tq, p.D,
                      p.vb, t);
      const bool ok = i0 + t % 64 < p.Tq;
      copy_chunk<4>(vdst + s * 64 * 4, ok ? vec + i0 + t % 64 : vec, ok);
      stage_issued(&full[s], p.vb);
    }
  } else {
    if constexpr (C::MIN_BLOCKS == 2)
      hopper::setmaxnreg_inc<C::CONSUMER_REGS>();
    const int warp = t / 32, g = lane / 4, tq = lane % 4;
    const float sl2 = p.scale * LOG2E;
    float dk[DP / 2], dv[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.0f;

    for (int j = 0; j < ntiles; ++j) {
      const int s = j % ST;
      const uint8_t* qt = sqg + 2 * s * T;
      const float* lj = ls + s * 64;
      const float* dj = ds + s * 64;
      stage_landed(&full[s], (j / ST) & 1);
      // rows: this warpgroup's 64 keys; columns: the tile's 64 queries
      float st[32], dpt[32];
      hopper::wgmma_fence();
      rows_by_rows<KS>(st, sk, 64, qt);       // S^T = K Q^T
      rows_by_rows<KS>(dpt, sv, 64, qt + T);  // dP^T = V dO^T
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      fence_acc(st);
      fence_acc(dpt);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i >> 2) + 2 * tq + (i & 1);
        st[i] = ex2(fmaf(st[i], sl2, -lj[col] * LOG2E));  // P^T
      }
      uint32_t pa[4][4], da[4][4];
      to_a(pa, st);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i >> 2) + 2 * tq + (i & 1);
        dpt[i] = st[i] * (dpt[i] - dj[col]) * p.scale;  // dS^T
      }
      to_a(da, dpt);
      fence_acc(dk);
      fence_acc(dv);
      fence_frag(pa);
      fence_frag(da);
      hopper::wgmma_fence();
      weights_by_rows<DP>(dv, pa, qt + T);  // dV += P^T dO
      weights_by_rows<DP>(dk, da, qt);      // dK += dS^T Q
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      fence_acc(dk);
      fence_acc(dv);
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }
    const int row0 = k0 + warp * 16 + g;
    store_acc<DP>(head_out<bf16>(p.dk, p.sdk, b, h), p.sdk.t, dk, row0, p.Tk,
                  p.D, tq);
    store_acc<DP>(head_out<bf16>(p.dv, p.sdv, b, h), p.sdv.t, dv, row0, p.Tk,
                  p.D, tq);
  }
}

// ---- float32: FMA --------------------------------------------------------------

template <int NJ>
struct F32Bwd {
  static constexpr int DP = 16 * NJ;
  static constexpr int LD = F32Tiles<NJ>::LD, LDP = F32Tiles<NJ>::LDP;
  // two stationary 64-row tiles, two stages of two 32-row tiles, the warps'
  // weight rows, two stages of 32 lse and dvec
  static constexpr size_t smem() {
    return ((size_t)(2 * F_BM + 4 * F_BN) * LD + (size_t)F_BM * LDP +
            4 * F_BN) * sizeof(float);
  }
};

template <int NJ>
__device__ __forceinline__ void zero_acc(float (&a)[4][NJ][2]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) a[i][jj][0] = a[i][jj][1] = 0.0f;
}

template <int NJ>
__device__ __forceinline__ void store_f32(float* out, long long stride,
                                          const float (&acc)[4][NJ][2],
                                          int row0, int rows_total, int D,
                                          int ty, int tx) {
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
__global__ void __launch_bounds__(F_THREADS) dq_f32_kernel(const Bwd p) {
  constexpr int LD = F32Bwd<NJ>::LD, LDP = F32Bwd<NJ>::LDP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Gs = Qs + F_BM * LD;
  auto Ks = [&](int s) { return Gs + F_BM * LD + s * 2 * F_BN * LD; };
  auto Vs = [&](int s) { return Ks(s) + F_BN * LD; };
  float* Ps = Qs + (2 * F_BM + 4 * F_BN) * LD;

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.y * F_BM;
  const float* qg = head<float>(p.q, p.sq, b, h);
  const float* gg = head<float>(p.g, p.sg, b, h);
  const float* kg = head<float>(p.k, p.sk, b, h);
  const float* vg = head<float>(p.v, p.sv, b, h);
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const int ntiles = (p.Tk + F_BN - 1) / F_BN;

  zero_cols<F_THREADS>(Qs, LD, 2 * F_BM + 4 * F_BN, p.D, F32Bwd<NJ>::DP);
  load_rows<F_THREADS>(Qs, LD, qg, p.sq.t, q0, F_BM, p.Tq, p.D, p.vb);
  load_rows<F_THREADS>(Gs, LD, gg, p.sg.t, q0, F_BM, p.Tq, p.D, p.vb);
  load_rows<F_THREADS>(Ks(0), LD, kg, p.sk.t, 0, F_BN, p.Tk, p.D, p.vb);
  load_rows<F_THREADS>(Vs(0), LD, vg, p.sv.t, 0, F_BN, p.Tk, p.D, p.vb);
  hopper::cp_async_commit();

  float lse2[4], dvec[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const bool ok = row < p.Tq;
    lse2[i] = ok ? p.lse[(long long)bh * p.Tq + row] * LOG2E : 0.0f;
    dvec[i] = ok ? p.dvec[(long long)bh * p.Tq + row] : 0.0f;
  }
  float acc[4][NJ][2];
  zero_acc<NJ>(acc);

  for (int j = 0; j < ntiles; ++j) {
    const int cur = j & 1;
    if (j + 1 < ntiles) {
      const int k0 = (j + 1) * F_BN;
      load_rows<F_THREADS>(Ks(cur ^ 1), LD, kg, p.sk.t, k0, F_BN, p.Tk, p.D,
                           p.vb);
      load_rows<F_THREADS>(Vs(cur ^ 1), LD, vg, p.sv.t, k0, F_BN, p.Tk, p.D,
                           p.vb);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    __syncthreads();
    if (j == 0) {
      for (int i = threadIdx.x; i < F_BM * p.D; i += F_THREADS)
        Qs[(i / p.D) * LD + i % p.D] *= p.scale;  // q * scale in float32
      __syncthreads();
    }
    float s[4][4], dp[4][4];
    rows_dot<NJ, 4>(s, Qs, Ks(cur), ty, tx);  // S = (q * scale) K^T
    rows_dot<NJ, 4>(dp, Gs, Vs(cur), ty, tx);  // dP = dO V^T
    const int kb = j * F_BN;
    const bool edge = kb + F_BN > p.Tk;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float pw = exp2f(fmaf(s[i][c], LOG2E, -lse2[i]));
        if (edge && kb + tx + 8 * c >= p.Tk) pw = 0.0f;
        Ps[(ty + 16 * i) * LDP + tx + 8 * c] =
            pw * (dp[i][c] - dvec[i]) * p.scale;  // dS
      }
    __syncwarp();
    weights_by_rows_f32<NJ>(acc, Ps, Ks(cur), ty, tx);  // dQ += dS K
    __syncthreads();  // the other buffer is refilled next tile
  }
  store_f32<NJ>(head_out<float>(p.dq, p.sdq, b, h), p.sdq.t, acc, q0, p.Tq,
                p.D, ty, tx);
}

template <int NJ>
__global__ void __launch_bounds__(F_THREADS) dkv_f32_kernel(const Bwd p) {
  constexpr int LD = F32Bwd<NJ>::LD, LDP = F32Bwd<NJ>::LDP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + F_BM * LD;
  auto Qs = [&](int s) { return Vs + F_BM * LD + s * 2 * F_BN * LD; };
  auto Gs = [&](int s) { return Qs(s) + F_BN * LD; };
  float* Ps = Ks + (2 * F_BM + 4 * F_BN) * LD;
  float* Ls = Ps + F_BM * LDP;  // 2 x 32 lse
  float* Ds = Ls + 2 * F_BN;    // 2 x 32 dvec

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.y * F_BM;
  const float* qg = head<float>(p.q, p.sq, b, h);
  const float* gg = head<float>(p.g, p.sg, b, h);
  const float* kg = head<float>(p.k, p.sk, b, h);
  const float* vg = head<float>(p.v, p.sv, b, h);
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const int ntiles = (p.Tq + F_BN - 1) / F_BN;
  // threads 0-31 copy a tile's lse, 32-63 its dvec
  const float* vec = (threadIdx.x < F_BN ? p.lse : p.dvec) +
                     (long long)bh * p.Tq;
  auto load_vec = [&](int s, int i0) {
    if (threadIdx.x < 2 * F_BN) {
      const int r = threadIdx.x % F_BN;
      const bool ok = i0 + r < p.Tq;
      copy_chunk<4>(static_cast<uint32_t>(__cvta_generic_to_shared(
                        (threadIdx.x < F_BN ? Ls : Ds) + s * F_BN + r)),
                    ok ? vec + i0 + r : vec, ok);
    }
  };

  zero_cols<F_THREADS>(Ks, LD, 2 * F_BM + 4 * F_BN, p.D, F32Bwd<NJ>::DP);
  load_rows<F_THREADS>(Ks, LD, kg, p.sk.t, k0, F_BM, p.Tk, p.D, p.vb);
  load_rows<F_THREADS>(Vs, LD, vg, p.sv.t, k0, F_BM, p.Tk, p.D, p.vb);
  load_rows<F_THREADS>(Qs(0), LD, qg, p.sq.t, 0, F_BN, p.Tq, p.D, p.vb);
  load_rows<F_THREADS>(Gs(0), LD, gg, p.sg.t, 0, F_BN, p.Tq, p.D, p.vb);
  load_vec(0, 0);
  hopper::cp_async_commit();
  float dk[4][NJ][2], dv[4][NJ][2];
  zero_acc<NJ>(dk);
  zero_acc<NJ>(dv);

  for (int it = 0; it < ntiles; ++it) {
    const int cur = it & 1;
    if (it + 1 < ntiles) {
      const int i0 = (it + 1) * F_BN;
      load_rows<F_THREADS>(Qs(cur ^ 1), LD, qg, p.sq.t, i0, F_BN, p.Tq, p.D,
                           p.vb);
      load_rows<F_THREADS>(Gs(cur ^ 1), LD, gg, p.sg.t, i0, F_BN, p.Tq, p.D,
                           p.vb);
      load_vec(cur ^ 1, i0);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
      // S^T = (k * scale) q^T: the TPU kernel scales q; the two differ by
      // float32 rounding only
      for (int i = threadIdx.x; i < F_BM * p.D; i += F_THREADS)
        Ks[(i / p.D) * LD + i % p.D] *= p.scale;
      __syncthreads();
    }
    const float* L = Ls + cur * F_BN;
    const float* Dv = Ds + cur * F_BN;
    // rows: keys ty + 16 i; columns: queries tx + 8 c
    float s[4][4];
    rows_dot<NJ, 4>(s, Ks, Qs(cur), ty, tx);  // S^T
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qc = tx + 8 * c;
        s[i][c] = exp2f(fmaf(s[i][c], LOG2E, -L[qc] * LOG2E));  // P^T
        Ps[(ty + 16 * i) * LDP + qc] = s[i][c];
      }
    __syncwarp();
    weights_by_rows_f32<NJ>(dv, Ps, Gs(cur), ty, tx);  // dV += P^T dO
    float dp[4][4];
    rows_dot<NJ, 4>(dp, Vs, Gs(cur), ty, tx);  // dP^T = V dO^T
    __syncwarp();  // the warp is done reading its P^T rows
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qc = tx + 8 * c;
        Ps[(ty + 16 * i) * LDP + qc] =
            s[i][c] * (dp[i][c] - Dv[qc]) * p.scale;  // dS^T
      }
    __syncwarp();
    weights_by_rows_f32<NJ>(dk, Ps, Qs(cur), ty, tx);  // dK += dS^T Q
    __syncthreads();  // the other buffers are refilled next tile
  }
  store_f32<NJ>(head_out<float>(p.dk, p.sdk, b, h), p.sdk.t, dk, k0, p.Tk,
                p.D, ty, tx);
  store_f32<NJ>(head_out<float>(p.dv, p.sdv, b, h), p.sdv.t, dv, k0, p.Tk,
                p.D, ty, tx);
}

// ---- launches ------------------------------------------------------------------

namespace {

template <auto Kernel>
cudaError_t go(dim3 grid, int threads, int smem, const Bwd& p,
               cudaStream_t s) {
  const cudaError_t e = smem_once<Kernel>(smem);
  if (e != cudaSuccess) return e;
  Kernel<<<grid, threads, smem, s>>>(p);
  return cudaGetLastError();
}

// f(std::integral_constant<int, K>) for K = ceil(D / 16) in 1..8
template <typename F>
cudaError_t by_k16(int k16, F f) {
  switch (k16) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
  }
  return cudaErrorInvalidValue;
}

// kind 0: dQ over blocks of 64 queries; 1: dK and dV over blocks of 64 keys
cudaError_t backward(int kind, const Bwd& p, int dtype, cudaStream_t s) {
  const int blocks = kind == 0 ? (p.Tq + 63) / 64 : (p.Tk + 63) / 64;
  if (blocks > 65535) return cudaErrorInvalidValue;
  const dim3 grid(p.B * p.H, blocks);
  const cudaError_t e = by_k16((p.D + 15) / 16, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    if (dtype == 1)
      return kind == 0
                 ? go<dq_wgmma_kernel<K>>(grid, DqCfg<K>::THREADS,
                                          DqCfg<K>::SMEM, p, s)
                 : go<dkv_wgmma_kernel<K>>(grid, DkvCfg<K>::THREADS,
                                           DkvCfg<K>::SMEM, p, s);
    return kind == 0 ? go<dq_f32_kernel<K>>(grid, F_THREADS,
                                            (int)F32Bwd<K>::smem(), p, s)
                     : go<dkv_f32_kernel<K>>(grid, F_THREADS,
                                             (int)F32Bwd<K>::smem(), p, s);
  });
  if (e == cudaSuccess) ++launch_counts[0][kind == 0 ? K_DQ : K_DKV];
  return e;
}

// the previous design's launches (flash_prev.cuh), the attribute set at
// every launch as it was
template <typename Kernel, typename Params>
cudaError_t prev_go(Kernel kernel, size_t smem, dim3 grid, const Params& p,
                    cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, attn_prev::THREADS, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

}  // namespace flash

// Forward. q (B, H, Tq, D), k and v (B, H, Tk, D), the output o (B, H, Tq,
// D), each given by its (b, h, t) element strides; lse float32 (B * H, Tq)
// contiguous, or null (``flash_attention_pallas``); dtype 0 float32, 1 bf16;
// rows, chunk, splits, part_o and part_lse as attention_launch's.
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* o, float* lse, int B,
    int H, int Tq, int Tk, int D, long long sqb, long long sqh, long long sqt,
    long long skb, long long skh, long long skt, long long svb, long long svh,
    long long svt, long long sob, long long soh, long long sot, int vb,
    int dtype, int rows, int chunk, int splits, float* part_o,
    float* part_lse, void* stream) {
  if (!attn::valid_rows(B, H, Tq, Tk, D, vb, dtype))
    return (int)cudaErrorInvalidValue;
  attn::Problem p{q, k, v, o, B, H, Tq, Tk, D,
                  {sqb, sqh, sqt}, {skb, skh, skt}, {svb, svh, svt},
                  {sob, soh, sot}, vb, (float)pow((double)D, -0.5),
                  lse, chunk, splits, part_o, part_lse};
  return (int)attn::forward(p, rows, dtype, static_cast<cudaStream_t>(stream));
}

// The forward in the previous design (the parent, for timings).
extern "C" int flash_attention_fwd_prev_launch(
    const void* q, const void* k, const void* v, void* o, float* lse, int B,
    int H, int Tq, int Tk, int D, long long sqb, long long sqh, long long sqt,
    long long skb, long long skh, long long skt, long long svb, long long svh,
    long long svt, long long sob, long long soh, long long sot, int vb,
    int dtype, void* stream) {
  if (!attn::valid_rows(B, H, Tq, Tk, D, vb, dtype) ||
      (Tq + attn_prev::BM - 1) / attn_prev::BM > 65535)
    return (int)cudaErrorInvalidValue;
  attn_prev::Problem p{q, k, v, o, B, H, Tq, Tk, D,
                       {sqb, sqh, sqt}, {skb, skh, skt}, {svb, svh, svt},
                       {sob, soh, sot}, vb, (float)pow((double)D, -0.5)};
  p.lse = lse;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(B * H, (Tq + attn_prev::BM - 1) / attn_prev::BM);
  const cudaError_t e = flash::by_k16((D + 15) / 16, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    return dtype == 1
               ? flash::prev_go(attn_prev::attn_bf16_kernel<K>,
                                attn_prev::Bf16Tiles<K>::smem(), grid, p, s)
               : flash::prev_go(attn_prev::attn_f32_kernel<K>,
                                attn_prev::F32Tiles<K>::smem(), grid, p, s);
  });
  if (e == cudaSuccess) ++attn::launch_counts[1][attn::K_FWD];
  return (int)e;
}

// Backward, one entry per kernel (kind 0: dQ, 1: dK and dV). q, k, v and g
// (dO, shaped as the output) as in the forward; lse and dvec float32 (B * H,
// Tq) contiguous; the gradients dq (as q), dk and dv (as k) given by their
// strides, in the inputs' dtype; prev 1: the previous design.
extern "C" int flash_attention_bwd_launch(
    int kind, const void* q, const void* k, const void* v, const void* g,
    const float* lse, const float* dvec, void* dq, void* dk, void* dv, int B,
    int H, int Tq, int Tk, int D, long long sqb, long long sqh, long long sqt,
    long long skb, long long skh, long long skt, long long svb, long long svh,
    long long svt, long long sgb, long long sgh, long long sgt, long long sdqb,
    long long sdqh, long long sdqt, long long sdkb, long long sdkh,
    long long sdkt, long long sdvb, long long sdvh, long long sdvt, int vb,
    int dtype, int prev, void* stream) {
  if (!attn::valid_rows(B, H, Tq, Tk, D, vb, dtype) ||
      (kind != 0 && kind != 1))
    return (int)cudaErrorInvalidValue;
  const float scale = (float)pow((double)D, -0.5);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!prev) {
    flash::Bwd p{q, k, v, g, lse, dvec, dq, dk, dv, B, H, Tq, Tk, D,
                 {sqb, sqh, sqt}, {skb, skh, skt}, {svb, svh, svt},
                 {sgb, sgh, sgt}, {sdqb, sdqh, sdqt}, {sdkb, sdkh, sdkt},
                 {sdvb, sdvh, sdvt}, vb, scale};
    return (int)flash::backward(kind, p, dtype, s);
  }
  flash_prev::Bwd p{q, k, v, g, lse, dvec, dq, dk, dv, B, H, Tq, Tk, D,
                    {sqb, sqh, sqt}, {skb, skh, skt}, {svb, svh, svt},
                    {sgb, sgh, sgt}, {sdqb, sdqh, sdqt}, {sdkb, sdkh, sdkt},
                    {sdvb, sdvh, sdvt}, vb, scale};
  const int blocks = kind == 0 ? (Tq + attn_prev::BM - 1) / attn_prev::BM
                               : (Tk + attn_prev::BN - 1) / attn_prev::BN;
  if (blocks > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(B * H, blocks);
  const cudaError_t e = flash::by_k16((D + 15) / 16, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    using namespace flash_prev;
    if (dtype == 1)
      return kind == 0 ? flash::prev_go(dq_bf16_kernel<K>,
                                        Bf16Bwd<K>::smem(), grid, p, s)
                       : flash::prev_go(dkv_bf16_kernel<K>,
                                        Bf16Bwd<K>::smem(), grid, p, s);
    return kind == 0 ? flash::prev_go(dq_f32_kernel<K>, F32Bwd<K>::smem(),
                                      grid, p, s)
                     : flash::prev_go(dkv_f32_kernel<K>, F32Bwd<K>::smem(),
                                      grid, p, s);
  });
  if (e == cudaSuccess)
    ++attn::launch_counts[1][kind == 0 ? attn::K_DQ : attn::K_DKV];
  return (int)e;
}
