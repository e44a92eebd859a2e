// The Swin GEMM core on Hopper (sm_90a): every product of K3, K4, K5 and
// K6, P1 and P2's phases, and the host-side phases that chain them.
//
// Replaces the loops of swin_common.cuh on the main path (gemm_kernel, WMMA
// bf16 with one tile in flight; gemm_q8_kernel, mma.sync s8) with one pass
// that writes the A operand, then a persistent wgmma GEMM fed by TMA:
//
//   layer_norm_kernel  bf16 with LayerNorm (QKV, fc1): LN(x) rounded to
//                      bf16 into an (M, C) scratch, with the statistics and
//                      the affine the loop applies on load (ln_row_stats,
//                      ln_affine), so the operand is the loop's bit for bit;
//                      bf16 without LayerNorm (proj, fc2, P1) reads A in
//                      place;
//   quantize_kernel    int8: the codes (M, K) of A, q8_code(a, 127 / amax)
//                      with the block absmaxes the existing passes wrote
//                      (ln_stats_amax_kernel, the window attention's window
//                      absmax, GEMM1's GELU epilogue, P1's amax pass), from
//                      the three sources of load8 (LN(x), a float32 matrix,
//                      a T matrix) and the same ScaleMap: each element is
//                      read and divided once, where the loop quantized A
//                      once per 64-column N tile;
//   wgmma_gemm_kernel  out = epilogue(A B + b): 128 x BN tiles, BN 128 where
//                      it divides N, else 192, else 64 (tile_n; every
//                      Swin-L N is a multiple of 192, P1's chunks are 1024).
//                      Warpgroup 0 produces: one thread issues the TMA loads
//                      of A and B into a ring of 4 stages of 128 bytes of K
//                      (128-byte swizzle), handed over by full/empty
//                      mbarriers. Warpgroups 1 and 2 each run wgmma on 64
//                      rows of the tile with the sums in registers:
//                      bf16 m64nBNk16 (A K-major; B the (K, N) row-major
//                      flax weight read in place as the MN-major operand,
//                      imm-trans-b 1, in boxes of 64 N x 64 K) or s8
//                      m64nBNk32 (A the codes; B the (N, K) Q8Weight codes,
//                      K-major). The block is persistent: it walks tiles
//                      N-fastest and carries the ring's stage and phase from
//                      one tile to the next, so the next tile loads during
//                      this tile's epilogue. TMA fills rows past M and K
//                      past K with zeros; the epilogue masks rows past M.
//                      The epilogue maps the wgmma fragment to (row, column)
//                      and runs the loop's epilogues in their order of
//                      operations: bf16 EPI_BIAS, EPI_BIAS_GELU,
//                      EPI_ROUND_RES, EPI_RES_F32; int8 Q8E_BIAS,
//                      Q8E_GELU_AMAX (the row's max over the 4 lanes that
//                      hold it, the tile's per block in shared memory, then
//                      one atomicMax a block), Q8E_ROUND_RES, Q8E_SCALE.
//                      int32 sums are exact, so the int8 outputs are the
//                      loop's bit for bit; bf16 sums are float32 in another
//                      order than WMMA's.
//
// Which path a product takes (gemm_path_bf16 / gemm_path_q8, the rule of
// ops/swin_gemm.py::gemm_path) follows from the operand type and the shape
// alone: float32 stays on the FMA loop (TF32 would change its numbers);
// bf16 takes wgmma when K % 8 == 0 (TMA's 16-byte row pitch) and
// N % 64 == 0 (the tiles), int8 when K % 16 == 0 and N % 64 == 0; anything
// else would take the loop, which needs K % 32 == 0 and N % 64 == 0 and so
// refuses those shapes too. P1's weight-only int8 (int8 codes widened to
// bf16 on load) stays on the WMMA loop. Every main-path product takes
// wgmma. The loop is kept for those shapes and, through each library's
// "_loop" entry points (a template flag here, never set by a main path), as
// the parent that chip_smoke.py times and compares against. Each library
// counts its products per path (swin_gemm_launches below).
//
// What bounds the products on the card: at Swin-L-384's shapes they are
// tensor-core bound from stage 1 on (MLP1 s3, 9216 x 768 x 3072, 0.044 ms
// in bf16 at 989 TFLOP/s) and byte bound at stage 0's narrow K (192); the
// LN and quantize passes are byte bound (stage 0's LN, 147,456 x 192 bf16,
// about 113 MB read and written, 0.034 ms at 3.35 TB/s).
//
// hopper_gemm.cuh lists the traps of this design; the one specific to here
// is the MN-major descriptor of B (smem_desc_sw128_mn).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_gemm.cuh"
#include "swin_common.cuh"

namespace swin {

using bf16 = __nv_bfloat16;

// ---- the path rule and the counts -----------------------------------------

enum GemmPath { PATH_WGMMA = 0, PATH_LOOP = 1, PATH_FMA = 2 };

inline int gemm_path_bf16(int K, int N) {
  return K % 8 == 0 && N % 64 == 0 ? PATH_WGMMA : PATH_LOOP;
}
inline int gemm_path_q8(int K, int N) {
  return K % 16 == 0 && N % 64 == 0 ? PATH_WGMMA : PATH_LOOP;
}

// the N tile of the wgmma path (N % 64 == 0)
inline int tile_n(int N) {
  return N % 128 == 0 ? 128 : N % 192 == 0 ? 192 : 64;
}

namespace {
// this library's products per GemmPath, read by swin_gemm_launches
long long gemm_launch_counts[3] = {0, 0, 0};
}  // namespace

// ---- the A passes -------------------------------------------------------------

// out = LN(x) rounded to T, one warp per row (bf16 only)
template <typename T>
__global__ void __launch_bounds__(THREADS)
layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, T* __restrict__ out, int M,
                  int C) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (row >= M) return;
  const T* xr = x + (size_t)row * C;
  const float2 st = ln_row_stats(xr, C, lane);
  T* orow = out + (size_t)row * C;
  for (int c = lane; c < C; c += 32)
    orow[c] = from_f<T>(ln_affine(to_f(xr[c]), st, gamma[c], beta[c]));
}

// codes (M, K) of A as gemm_q8_kernel quantizes it on load; eight elements
// a thread (K % 8 == 0)
template <typename T, int SRC>
__global__ void __launch_bounds__(THREADS)
quantize_kernel(const Q8Args<T> p, int8_t* __restrict__ codes) {
  const int per_row = p.K / 8;
  const long long n = (long long)p.M * per_row;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < n;
       v += stride) {
    const int r = (int)(v / per_row), k = (int)(v % per_row) * 8;
    const float inv = __fdiv_rn(127.0f, block_amax(p.a_amax, p.a_map(r)));
    const float2 st = SRC == Q8_LN ? p.stats[r] : make_float2(0.0f, 0.0f);
    float a[8];
    load8<T, SRC>(p, r, k, a);
    uint32_t word[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float x = a[e];
      if (SRC == Q8_LN) {
        x = ln_apply(x, st, p.gamma[k + e], p.beta[k + e]);
        if (p.ln_round) x = round_to<T>(x);
      }
      word[e / 4] |= q8_code(x, inv) << (8 * (e % 4));
    }
    *reinterpret_cast<uint2*>(codes + (size_t)r * p.K + k) =
        make_uint2(word[0], word[1]);
  }
}

// ---- the wgmma GEMM -------------------------------------------------------------

namespace wg {
constexpr int BM = 128;       // rows of a tile: two consumer warpgroups
constexpr int KB = 128;       // bytes of K a stage: one swizzled row
constexpr int STAGES = 4;
constexpr int THREADS = 384;  // the producer warpgroup, then the consumers
constexpr int A_BYTES = BM * KB;
constexpr int B_BOX = 64 * KB;  // bf16 B: one box of 64 N x 64 K rows
template <int BN> struct Smem {
  static constexpr int B_BYTES = BN * KB;
  // 1024 for aligning the ring by hand, the ring, 2 x STAGES mbarriers
  static constexpr int SIZE =
      1024 + STAGES * (A_BYTES + B_BYTES) + 2 * STAGES * 8;
};
}  // namespace wg

__device__ __forceinline__ void consumers_sync() {  // the 256 consumers
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// bf16 x bf16 -> float32: A (M, K) bf16, B (K, N) bf16 row-major
template <int EPI> struct Bf16Op {
  using Acc = float;
  using Args = GemmArgs<bf16>;
  static __host__ __device__ int k_bytes(int K) { return 2 * K; }

  // B's stage: BN / 64 boxes of 64 N x 64 K rows, one after another
  template <int BN>
  static __device__ void load_b(uint8_t* dst, const CUtensorMap* tm, int kb,
                                int n_block, uint64_t* bar) {
#pragma unroll
    for (int j = 0; j < BN / 64; ++j)
      hopper::tma_load_2d(dst + j * wg::B_BOX, tm, 2 * (n_block + 64 * j),
                          kb * (wg::KB / 2), bar);
  }
  // the stage's four k16 steps: A 32 bytes further on each, B 16 rows
  template <int BN>
  static __device__ void mma(float (&acc)[BN / 2], const uint8_t* a,
                             const uint8_t* b) {
#pragma unroll
    for (int kk = 0; kk < wg::KB / 32; ++kk)
      hopper::WgmmaBF16T<BN>::run(
          acc, hopper::smem_desc_sw128(a + 32 * kk),
          hopper::smem_desc_sw128_mn(b + 16 * wg::KB * kk, wg::B_BOX));
  }
  // d[4j + 2h + c] is row row0 + 8h, column n_block + 8j + 2 tq + c
  template <int BN>
  static __device__ void epilogue(const Args& p, float (&acc)[BN / 2],
                                  int row0, int n_block, int tq, int*) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row0 + 8 * h;
      if (m >= p.M) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n_block + 8 * j + 2 * tq;
        const size_t o = (size_t)m * p.N + n;
        float v[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float a = acc[4 * j + 2 * h + c];
          if constexpr (EPI == EPI_SCALE) {
            v[c] = __fmul_rn(a, p.scale[n + c]);
          } else {
            const float u = a + to_f(p.bias[n + c]);
            if (EPI == EPI_BIAS) {
              v[c] = u;
            } else if (EPI == EPI_BIAS_GELU) {
              v[c] = gelu_erf(u);
            } else if (EPI == EPI_ROUND_RES) {
              v[c] = to_f(p.res[o + c]) + round_to<bf16>(u);
            } else {
              v[c] = u + to_f(p.res[o + c]);
            }
          }
        }
        store2<bf16>(p.out + o, v[0], v[1]);
      }
    }
  }
};

// s8 x s8 -> int32: A the codes (M, K), B (N, K) codes; T the output's type
template <typename T, int EPI> struct S8Op {
  using Acc = int;
  using Args = Q8Args<T>;
  static __host__ __device__ int k_bytes(int K) { return K; }

  template <int BN>
  static __device__ void load_b(uint8_t* dst, const CUtensorMap* tm, int kb,
                                int n_block, uint64_t* bar) {
    hopper::tma_load_2d(dst, tm, kb * wg::KB, n_block, bar);
  }
  template <int BN>
  static __device__ void mma(int (&acc)[BN / 2], const uint8_t* a,
                             const uint8_t* b) {
#pragma unroll
    for (int kk = 0; kk < wg::KB / 32; ++kk)
      hopper::WgmmaS8<BN>::run(acc, hopper::smem_desc_sw128(a + 32 * kk),
                               hopper::smem_desc_sw128(b + 32 * kk));
  }
  // as gemm_q8_kernel's epilogue; smax: Q8E_GELU_AMAX's per-block maxima
  // of this tile
  template <int BN>
  static __device__ void epilogue(const Args& p, int (&acc)[BN / 2], int row0,
                                  int n_block, int tq, int* smax) {
    const int m_block = row0 - row0 % wg::BM;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row0 + 8 * h;
      float rmax = 0.0f;
      if (m < p.M) {
        const float amax = block_amax(p.a_amax, p.a_map(m));
        const float as = EPI == Q8E_SCALE ? __fmul_rn(amax, Q8_INV127)
                                          : __fdiv_rn(amax, 127.0f);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int n = n_block + 8 * j + 2 * tq;
          const size_t o = (size_t)m * p.N + n;
          float v[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            v[c] = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + c]),
                             __fmul_rn(as, p.wscale[n + c]));
            if (EPI != Q8E_SCALE) v[c] = __fadd_rn(v[c], to_f(p.bias[n + c]));
            if (EPI == Q8E_GELU_AMAX) {
              v[c] = gelu_as(v[c]);
              rmax = fmaxf(rmax, fabsf(v[c]));
            } else if (EPI == Q8E_ROUND_RES) {
              v[c] = __fadd_rn(to_f(p.res[o + c]), round_to<T>(v[c]));
            }
          }
          if (EPI == Q8E_GELU_AMAX)
            store2<float>(static_cast<float*>(p.out) + o, v[0], v[1]);
          else
            store2<T>(static_cast<T*>(p.out) + o, v[0], v[1]);
        }
      }
      if (EPI == Q8E_GELU_AMAX) {
        // the row's max over the 4 lanes that hold its columns
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 2));
        if (tq == 0 && m < p.M)
          atomicMax(smax + (m / p.out_blk - m_block / p.out_blk),
                    __float_as_int(rmax));
      }
    }
  }
};

template <class Op> struct IsGeluAmax : std::false_type {};
template <typename T> struct IsGeluAmax<S8Op<T, Q8E_GELU_AMAX>>
    : std::true_type {};

// Persistent: block b takes tiles b, b + gridDim.x, ... in N-fastest order
// (the blocks in flight share their A rows in L2). The ring's stage and
// phase run on across tiles.
template <class Op, int BN>
__global__ void __launch_bounds__(wg::THREADS, 1)
wgmma_gemm_kernel(const __grid_constant__ CUtensorMap tm_a,
                  const __grid_constant__ CUtensorMap tm_b,
                  const typename Op::Args p) {
  using S = wg::Smem<BN>;
  constexpr int ST = wg::STAGES, BM = wg::BM;
  constexpr bool AMAX = IsGeluAmax<Op>::value;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int smax[BM];  // AMAX: the tile's per-block maxima
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sa = ring;                     // ST x (BM x 128)
  uint8_t* sb = ring + ST * wg::A_BYTES;  // ST x (BN x 128)
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + ST * S::B_BYTES);
  uint64_t* empty = full + ST;

  const int n_tiles = p.N / BN;
  const int tiles = ((p.M + BM - 1) / BM) * n_tiles;
  const int nk = (Op::k_bytes(p.K) + wg::KB - 1) / wg::KB;
  const int warpgroup = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 1);   // the producer's expect_tx
      hopper::mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    hopper::mbar_fence_init();
    hopper::tma_prefetch_map(&tm_a);
    hopper::tma_prefetch_map(&tm_b);
  }
  __syncthreads();

  if (warpgroup == 0) {
    // ---- producer: one thread ------------------------------------------
    if (t != 0) return;
    int it = 0;  // stages filled so far, over all tiles
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m_block = (tile / n_tiles) * BM;
      const int n_block = (tile % n_tiles) * BN;
      for (int kb = 0; kb < nk; ++kb, ++it) {
        const int s = it % ST;
        hopper::mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], wg::A_BYTES + S::B_BYTES);
        hopper::tma_load_2d(sa + s * wg::A_BYTES, &tm_a, kb * wg::KB, m_block,
                            &full[s]);
        Op::template load_b<BN>(sb + s * S::B_BYTES, &tm_b, kb, n_block,
                                &full[s]);
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw + 1 owns rows 64 cw .. + 63 of a tile -----
  const int cw = warpgroup - 1, ct = threadIdx.x - 128;
  const int lane = t % 32;
  int it = 0;  // stages consumed so far, over all tiles
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m_block = (tile / n_tiles) * BM;
    const int n_block = (tile % n_tiles) * BN;
    typename Op::Acc acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int kb = 0; kb < nk; ++kb, ++it) {
      const int s = it % ST;
      hopper::mbar_wait(&full[s], (it / ST) & 1);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) hopper::fence_operand(acc[i]);
      hopper::wgmma_fence();
      Op::template mma<BN>(acc, sa + s * wg::A_BYTES + cw * 64 * wg::KB,
                           sb + s * S::B_BYTES);
      hopper::wgmma_commit();
      // the previous stage's wgmmas are done: hand it back to the producer
      hopper::wgmma_wait<1>();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) hopper::fence_operand(acc[i]);
      if (kb > 0 && lane == 0) hopper::mbar_arrive(&empty[(it - 1) % ST]);
    }
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) hopper::fence_operand(acc[i]);
    if (lane == 0) hopper::mbar_arrive(&empty[(it - 1) % ST]);

    if constexpr (AMAX) {  // the previous tile's maxima are flushed
      consumers_sync();
      if (ct < BM) smax[ct] = 0;
      consumers_sync();
    }
    Op::template epilogue<BN>(p, acc, m_block + cw * 64 + (t / 32) * 16 +
                                          lane / 4,
                              n_block, lane % 4, smax);
    if constexpr (AMAX) {
      consumers_sync();
      const int last = min(m_block + BM, p.M) - 1;
      if (ct <= last / p.out_blk - m_block / p.out_blk && smax[ct] > 0)
        atomicMax(p.out_amax + m_block / p.out_blk + ct, smax[ct]);
    }
  }
}

// the launch of one instantiation: shared memory beyond 48 KB and the
// blocks resident on the card found once per device, then a persistent
// grid of at most that many blocks. Internal linkage: a function-local
// static of a template shared by several libraries is one object in the
// process (a GNU unique symbol), and each library must set the shared
// memory attribute of its own kernel.
namespace {
template <class Op, int BN>
cudaError_t launch_wgmma(const CUtensorMap& tm_a, const CUtensorMap& tm_b,
                         const typename Op::Args& p, cudaStream_t s) {
  using S = wg::Smem<BN>;
  auto kernel = wgmma_gemm_kernel<Op, BN>;
  static int resident[32] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int blocks = dev < 32 ? resident[dev] : 0;
  if (blocks == 0) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             S::SIZE);
    int sms = 0, per_sm = 0;
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        wg::THREADS, S::SIZE);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    blocks = sms * per_sm;
    if (dev < 32) resident[dev] = blocks;
  }
  const long long tiles =
      (long long)((p.M + wg::BM - 1) / wg::BM) * (p.N / BN);
  const int grid = (int)(tiles < blocks ? tiles : blocks);
  kernel<<<grid, wg::THREADS, S::SIZE, s>>>(tm_a, tm_b, p);
  return cudaGetLastError();
}
}  // namespace

template <class Op>
cudaError_t launch_wgmma_tiled(const CUtensorMap& tm_a,
                               const CUtensorMap& tm_b,
                               const typename Op::Args& p, cudaStream_t s) {
  switch (tile_n(p.N)) {
    case 128: return launch_wgmma<Op, 128>(tm_a, tm_b, p, s);
    case 192: return launch_wgmma<Op, 192>(tm_a, tm_b, p, s);
    default: return launch_wgmma<Op, 64>(tm_a, tm_b, p, s);
  }
}

// bf16: A p.a (M, K), B p.w (K, N) row-major, both viewed as bytes
template <int EPI>
cudaError_t gemm_wgmma(const GemmArgs<bf16>& p, cudaStream_t s) {
  if (p.M <= 0 || gemm_path_bf16(p.K, p.N) != PATH_WGMMA)
    return cudaErrorInvalidValue;
  CUtensorMap tm_a, tm_b;
  int err = hopper::encode_u8_sw128_cached(&tm_a, p.a, p.M, 2LL * p.K,
                                           wg::BM);
  if (err == 0)
    err = hopper::encode_u8_sw128_cached(&tm_b, p.w, p.K, 2LL * p.N,
                                         wg::B_BOX / wg::KB);
  if (err != 0) return (cudaError_t)err;
  return launch_wgmma_tiled<Bf16Op<EPI>>(tm_a, tm_b, p, s);
}

// int8: A the codes p.a (M, K), B p.w (N, K)
template <typename T, int EPI>
cudaError_t gemm_wgmma_s8(const Q8Args<T>& p, cudaStream_t s) {
  if (p.M <= 0 || gemm_path_q8(p.K, p.N) != PATH_WGMMA)
    return cudaErrorInvalidValue;
  CUtensorMap tm_a, tm_b;
  int err = hopper::encode_u8_sw128_cached(&tm_a, p.a, p.M, p.K, wg::BM);
  if (err == 0)
    err = hopper::encode_u8_sw128_cached(&tm_b, p.w, p.N, p.K, tile_n(p.N));
  if (err != 0) return (cudaError_t)err;
  return launch_wgmma_tiled<S8Op<T, EPI>>(tm_a, tm_b, p, s);
}

template <typename T>
cudaError_t layer_norm(const T* x, const float* gamma, const float* beta,
                       T* out, int M, int C, cudaStream_t s) {
  const int rows = THREADS / 32;
  layer_norm_kernel<T><<<(M + rows - 1) / rows, THREADS, 0, s>>>(
      x, gamma, beta, out, M, C);
  return cudaGetLastError();
}

template <typename T, int SRC>
cudaError_t quantize(const Q8Args<T>& p, int8_t* codes, cudaStream_t s) {
  const long long vecs = (long long)p.M * (p.K / 8);
  const long long blocks = (vecs + THREADS - 1) / THREADS;
  const int grid = (int)(blocks < 132 * 16 ? blocks : 132 * 16);
  quantize_kernel<T, SRC><<<grid, THREADS, 0, s>>>(p, codes);
  return cudaGetLastError();
}

// ---- one product on its path --------------------------------------------------

// out = epilogue(A W + b) on the path the rule picks, or on the loop when
// `loop` (the "_loop" entry points). With ln, A is LayerNorm(p.a) with
// p.gamma and p.beta: the wgmma path writes it into `normed` (M, K) first,
// the loop computes `stats` and applies it on load.
template <typename T, int EPI>
cudaError_t gemm_any(GemmArgs<T> p, bool ln, float2* stats, T* normed,
                     bool loop, cudaStream_t s) {
  constexpr bool BF16 = std::is_same<T, bf16>::value;
  const int path = !BF16 ? PATH_FMA
                         : loop ? PATH_LOOP : gemm_path_bf16(p.K, p.N);
  cudaError_t err = cudaSuccess;
  if constexpr (BF16) {
    if (path == PATH_WGMMA) {
      if (ln) {
        err = layer_norm(p.a, p.gamma, p.beta, normed, p.M, p.K, s);
        if (err != cudaSuccess) return err;
        p.a = normed;
      }
      err = gemm_wgmma<EPI>(p, s);
      if (err == cudaSuccess) ++gemm_launch_counts[path];
      return err;
    }
  }
  if (ln) {
    err = ln_stats(p.a, stats, p.M, p.K, s);
    if (err != cudaSuccess) return err;
    p.stats = stats;
    err = gemm<T, true, EPI>(p, s);
  } else {
    err = gemm<T, false, EPI>(p, s);
  }
  if (err == cudaSuccess) ++gemm_launch_counts[path];
  return err;
}

// the int8 product: on the wgmma path the quantize pass writes A's codes
// into `codes` (M, K) first; the loop quantizes on load
template <typename T, int SRC, int EPI>
cudaError_t gemm_q8_any(Q8Args<T> p, int8_t* codes, bool loop,
                        cudaStream_t s) {
  const int path = loop ? PATH_LOOP : gemm_path_q8(p.K, p.N);
  cudaError_t err;
  if (path == PATH_WGMMA) {
    err = quantize<T, SRC>(p, codes, s);
    if (err != cudaSuccess) return err;
    p.a = codes;
    err = gemm_wgmma_s8<T, EPI>(p, s);
  } else {
    err = gemm_q8<T, SRC, EPI>(p, s);
  }
  if (err == cudaSuccess) ++gemm_launch_counts[path];
  return err;
}

// ---- the phases of K3, K4 and K5 (LOOP: every product on the loop) ---------

// K3's phases: y = x + proj(window attention(LN(x))), or with res_add
// false y = proj(window attention(LN(x))), T(acc + bproj) with no residual
// (EPI_BIAS: the training branch, K6). Scratch: qkv (M, 3C), attn (M, C),
// stats (M,) with M = B * Hp * Wp; attn holds LN(x) for the wgmma QKV
// product before the attention phase writes it.
template <typename T, bool LOOP = false>
cudaError_t attention_half(const T* x, const float* gamma, const float* beta,
                           const T* wqkv, const T* bqkv, const T* wproj,
                           const T* bproj, const T* bias, const T* mask,
                           T* qkv, T* attn, float2* stats, T* y, int B,
                           int Hp, int Wp, int C, int heads, int w,
                           float scale, cudaStream_t s, bool res_add = true) {
  const int M = B * Hp * Wp;
  cudaError_t err = gemm_any<T, EPI_BIAS>(
      {x, nullptr, gamma, beta, wqkv, bqkv, nullptr, qkv, M, 3 * C, C}, true,
      stats, attn, LOOP, s);
  if (err != cudaSuccess) return err;
  err = window_attention(qkv, bias, mask, attn, B, Hp, Wp, C, heads, w,
                         scale, s);
  if (err != cudaSuccess) return err;
  const GemmArgs<T> proj{attn, nullptr, nullptr, nullptr, wproj, bproj,
                         res_add ? x : nullptr, y, M, C, C};
  return res_add
             ? gemm_any<T, EPI_ROUND_RES>(proj, false, nullptr, nullptr,
                                          LOOP, s)
             : gemm_any<T, EPI_BIAS>(proj, false, nullptr, nullptr, LOOP, s);
}

// K4's phases: y = x + W2 gelu(W1 LN(x) + b1) + b2, the last sum in float32
// (EPI_RES_F32), or with W2 h + b2 rounded to T before the residual is
// added (EPI_ROUND_RES: K5's merged block), or y = T(W2 h + b2) with no
// residual (EPI_BIAS: the training branch, K6). Scratch: h (M, hidden),
// stats (M,), normed (M, C) for the wgmma path's LN(x).
template <typename T, int EPI = EPI_RES_F32, bool LOOP = false>
cudaError_t mlp_half(const T* x, const float* gamma, const float* beta,
                     const T* w1, const T* b1, const T* w2, const T* b2, T* h,
                     float2* stats, T* normed, T* y, int M, int C, int hidden,
                     cudaStream_t s) {
  cudaError_t err = gemm_any<T, EPI_BIAS_GELU>(
      {x, nullptr, gamma, beta, w1, b1, nullptr, h, M, hidden, C}, true,
      stats, normed, LOOP, s);
  if (err != cudaSuccess) return err;
  return gemm_any<T, EPI>(
      {h, nullptr, nullptr, nullptr, w2, b2, x, y, M, C, hidden}, false,
      nullptr, nullptr, LOOP, s);
}

// K3's int8 branch: y = x + T(q8(proj) + bproj) over the attention of
// T(q8(qkv) + bqkv). QKV scales per window-row strip (w * Wp tokens), proj
// scales per window. Scratch: qkv (M, 3C), attn (M, C), stats (M,), amax
// (B * Hp / w + B * nW ints), codes (M, C) int8, M = B * Hp * Wp.
template <typename T, bool LOOP = false>
cudaError_t attention_half_q8(const T* x, const float* gamma,
                              const float* beta, const int8_t* wqkv,
                              const float* sqkv, const T* bqkv,
                              const int8_t* wproj, const float* sproj,
                              const T* bproj, const T* bias, const T* mask,
                              T* qkv, T* attn, float2* stats, int* amax,
                              int8_t* codes, T* y, int B, int Hp, int Wp,
                              int C, int heads, int w, float scale,
                              bool ln_round, cudaStream_t s) {
  const int M = B * Hp * Wp, strips = B * (Hp / w);
  int* wamax = amax + strips;
  cudaError_t err = cudaMemsetAsync(
      amax, 0, sizeof(int) * (strips + strips * (Wp / w)), s);
  if (err != cudaSuccess) return err;
  err = ln_stats_amax(x, gamma, beta, stats, amax, M, C, w * Wp, ln_round,
                      s);
  if (err != cudaSuccess) return err;
  Q8Args<T> q{x, stats, gamma, beta, amax, {w * Wp, 0, 0, 0}, wqkv, sqkv,
              bqkv, nullptr, qkv, nullptr, 1, M, 3 * C, C, ln_round};
  err = gemm_q8_any<T, Q8_LN, Q8E_BIAS>(q, codes, LOOP, s);
  if (err != cudaSuccess) return err;
  err = window_attention(qkv, bias, mask, attn, B, Hp, Wp, C, heads, w,
                         scale, s, wamax);
  if (err != cudaSuccess) return err;
  Q8Args<T> pr{attn, nullptr, nullptr, nullptr, wamax, {1, Hp, Wp, w},
               wproj, sproj, bproj, x, y, nullptr, 1, M, C, C, false};
  return gemm_q8_any<T, Q8_T, Q8E_ROUND_RES>(pr, codes, LOOP, s);
}

// K4's int8 branch: y = x + T(q8(h) W2 + b2) with h = gelu_as(q8(LN(x)) W1
// + b1) in float32, both scales per block of blk tokens. Scratch: h (M,
// hidden) float32, stats (M,), amax (2 * ceil(M / blk) ints), codes
// (M, max(C, hidden)) int8.
template <typename T, bool LOOP = false>
cudaError_t mlp_half_q8(const T* x, const float* gamma, const float* beta,
                        const int8_t* w1, const float* s1, const T* b1,
                        const int8_t* w2, const float* s2, const T* b2,
                        float* h, float2* stats, int* amax, int8_t* codes,
                        T* y, int M, int C, int hidden, int blk,
                        bool ln_round, cudaStream_t s) {
  const int blocks = (M + blk - 1) / blk;
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(int) * 2 * blocks, s);
  if (err != cudaSuccess) return err;
  err = ln_stats_amax(x, gamma, beta, stats, amax, M, C, blk, ln_round, s);
  if (err != cudaSuccess) return err;
  Q8Args<T> g1{x, stats, gamma, beta, amax, {blk, 0, 0, 0}, w1, s1, b1,
               nullptr, h, amax + blocks, blk, M, hidden, C, ln_round};
  err = gemm_q8_any<T, Q8_LN, Q8E_GELU_AMAX>(g1, codes, LOOP, s);
  if (err != cudaSuccess) return err;
  Q8Args<T> g2{h, nullptr, nullptr, nullptr, amax + blocks, {blk, 0, 0, 0},
               w2, s2, b2, x, y, nullptr, 1, M, C, hidden, false};
  return gemm_q8_any<T, Q8_F32, Q8E_ROUND_RES>(g2, codes, LOOP, s);
}

}  // namespace swin

// This library's Swin GEMM products since it was loaded (or last reset),
// per path: out[0] wgmma, out[1] the loop, out[2] the float32 FMA loop.
extern "C" void swin_gemm_launches(long long* out) {
  for (int i = 0; i < 3; ++i) out[i] = swin::gemm_launch_counts[i];
}

extern "C" void swin_gemm_reset() {
  for (long long& n : swin::gemm_launch_counts) n = 0;
}
