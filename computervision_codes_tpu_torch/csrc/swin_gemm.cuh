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
//                      it divides N, else 192, else 64, else (bf16 only) 96,
//                      else 32 (tile_n; every Swin-L N is a multiple of 192,
//                      P1's chunks are 1024; Swin-T's stage 0 has N 288 and
//                      96, the nano's 96 and 32). A B stage is BN / 64 boxes
//                      of 64 columns, rounded up: at BN 32 and 96 its last
//                      box reads 32 columns past the tile (zeros past N, or
//                      the next tile's), which the product does not read.
//                      Warpgroup 0 produces: one thread issues the TMA loads
//                      of A and B into a ring of 4 stages of 128 bytes of K
//                      (128-byte swizzle), handed over by full/empty
//                      mbarriers. Warpgroups 1 and 2 each run wgmma on 64
//                      rows of the tile with the sums in registers:
//                      bf16 m64nBNk16 (A K-major; B the (K, N) row-major
//                      flax weight read in place as the MN-major operand,
//                      imm-trans-b 1, in boxes of 64 N x 64 K) or s8
//                      m64nBNk32 (A the codes; B the (N, K) Q8Weight codes,
//                      K-major). P1's weight-only int8 (Int8wOp) runs the
//                      bf16 consumers on a B that the kernel widens itself,
//                      in a block of 512 threads: the producer loads each
//                      stage's (K, N) int8 codes by TMA beside its A, on
//                      the same full barrier (unswizzled boxes of 64 N x 64
//                      K bytes), and seven warps (the producer warpgroup's
//                      warps 1-3 and a fourth warpgroup) widen them into the
//                      slot's B in the 128-byte swizzle TMA writes for a
//                      bf16 weight (16 codes read, two 16-byte chunks
//                      written a thread; both free of bank conflicts: a
//                      quarter-warp reads 128 contiguous bytes and writes
//                      the even chunks of one row and the odd ones of the
//                      next), fence the async proxy and arrive on the
//                      slot's own barrier, which the consumers wait on
//                      beside the full one. The codes' landing means the
//                      slot was handed back, so the widening needs no
//                      barrier of its own to wait on, and stays off the
//                      producer's and the consumers' loops. The block is
//                      persistent: it walks tiles
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
//                      order than WMMA's. int8w's stage holds the bf16 of
//                      each code exactly, so its sums are bf16's on the
//                      widened weight, in the same order.
//
// Which path a product takes (gemm_path_bf16 / gemm_path_q8 /
// gemm_path_int8w, the rule of ops/swin_gemm.py::gemm_path) follows from
// the operand type and the shape alone: float32 stays on the FMA loop (TF32
// would change its numbers); bf16 and int8w take wgmma when K % 8 == 0
// (TMA's 16-byte row pitch of A) and N % 32 == 0 (bf16; int8w N % 64 ==
// 0), int8 when K % 16 == 0 and N % 64 == 0; anything else would take the
// loop, which needs K % 32 == 0 and N % 32 (int8: 64) == 0 and so refuses
// those shapes too. Every main-path product takes wgmma. K need not be a
// multiple of a stage's 64: TMA fills the columns of A and the rows of B
// past K with zeros. The loop is kept for those shapes and,
// through each library's "_loop" entry points (a template flag here, never
// set by a main path), as the parent that chip_smoke.py times and compares
// against (P1's int8w on it: the WMMA loop widening on load). Each library
// counts its products per path (swin_gemm_launches below).
//
// What bounds the products on the card: at Swin-L-384's shapes they are
// tensor-core bound from stage 1 on (MLP1 s3, 9216 x 768 x 3072, 0.044 ms
// in bf16 at 989 TFLOP/s) and byte bound at stage 0's narrow K (192); the
// LN and quantize passes are byte bound (stage 0's LN, 147,456 x 192 bf16,
// about 113 MB read and written, 0.034 ms at 3.35 TB/s).
//
// hopper_gemm.cuh lists the traps of this design; the ones specific to here
// are the MN-major descriptor of B (smem_desc_sw128_mn) and, for int8w, the
// proxy fence after the widening stores (generic writes that wgmma reads
// through the async proxy) and the place of each widened chunk
// (ops/swin_gemm.py::widened_offset writes the same mapping in Python,
// where the CPU tests hold it to TMA's swizzle).

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
  return K % 8 == 0 && N % 32 == 0 ? PATH_WGMMA : PATH_LOOP;
}
inline int gemm_path_q8(int K, int N) {
  return K % 16 == 0 && N % 64 == 0 ? PATH_WGMMA : PATH_LOOP;
}
inline int gemm_path_int8w(int K, int N) {
  return K % 8 == 0 && N % 64 == 0 ? PATH_WGMMA : PATH_LOOP;
}

// the N tile of the wgmma path (N % 32 == 0; 96 and 32 for bf16 only)
inline int tile_n(int N) {
  return N % 128 == 0 ? 128 : N % 192 == 0 ? 192 : N % 64 == 0 ? 64
                                               : N % 96 == 0  ? 96
                                                              : 32;
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
constexpr int RAW_BOX = 64 * KB / 2;  // int8w codes: 64 N x 64 K bytes
// int8w: the warps that widen B (the producer warpgroup's warps 1-3 and a
// fourth warpgroup) and its block
constexpr int WIDEN_WARPS = 7;
constexpr int WIDEN_THREADS = 512;
// The ring: STAGES slots of A, of B and, with WIDEN (int8w), of B's codes
// (BN / 64 raw boxes), then the full and empty mbarriers of each slot and,
// with WIDEN, one a slot that its widened B is ready
// the 64-column boxes of a B stage at tile BN (32 and 96 round up)
template <int BN> constexpr int b_boxes = (BN + 63) / 64;
template <int BN, bool WIDEN = false> struct Smem {
  static constexpr int B_BYTES = b_boxes<BN> * B_BOX;
  static constexpr int RAW_BYTES = WIDEN ? BN / 64 * RAW_BOX : 0;
  // 1024 for aligning the ring by hand, the ring, the mbarriers
  static constexpr int SIZE =
      1024 + STAGES * (A_BYTES + B_BYTES + RAW_BYTES) +
      (WIDEN ? 3 : 2) * STAGES * 8;
};
}  // namespace wg

__device__ __forceinline__ void consumers_sync() {  // the 256 consumers
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// bf16 x bf16 -> float32: A (M, K) bf16, B (K, N) bf16 row-major (W:
// the type of Args' weight; Int8wOp's codes)
template <int EPI, typename W = bf16> struct Bf16Op {
  using Acc = float;
  using Args = GemmArgs<bf16, W>;
  static __host__ __device__ int k_bytes(int K) { return 2 * K; }

  // B's stage: BN / 64 (rounded up) boxes of 64 N x 64 K rows, one after
  // another
  template <int BN>
  static __device__ void load_b(uint8_t* dst, const CUtensorMap* tm, int kb,
                                int n_block, uint64_t* bar) {
#pragma unroll
    for (int j = 0; j < wg::b_boxes<BN>; ++j)
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

// two pairs of int8 codes widened to bf16 pairs (the first code in the low
// half): each code c's bf16 is (128 + (c & 127)) - (c < 0 ? 256 : 128),
// whose operands are the bf16 bit patterns 0x43 | (c & 0x7f) and
// 0x43 | (c & 0x80) (exponent 7, or 8 where the sign bit carries into it),
// and whose difference, an integer of at most 8 significant bits, is exact
__device__ __forceinline__ uint2 widen4(uint32_t codes) {
  uint32_t out[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // bytes c_2h, 0x43, c_2h+1, 0x43
    const uint32_t x = __byte_perm(codes, 0x43434343u, 0x4140 + 0x202 * h);
    asm("sub.rn.bf16x2 %0, %1, %2;\n"
        : "=r"(out[h])
        : "r"(x & 0xFF7FFF7Fu), "r"(x & 0xFF80FF80u));
  }
  return make_uint2(out[0], out[1]);
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// bf16 x int8 codes -> float32 (P1's int8w): A (M, K) bf16 and the
// consumers' products and epilogue as Bf16Op's (EPI_SCALE); B the (K, N)
// codes, loaded by TMA beside A and widened by seven warps into the slot's
// B, laid out as Bf16Op's TMA writes it
struct Int8wOp : Bf16Op<EPI_SCALE, int8_t> {
  // the codes of stage kb: BN / 64 unswizzled boxes of 64 N x 64 K bytes,
  // so code (k, n) lands at (n / 64) RAW_BOX + 64 k + n % 64
  template <int BN>
  static __device__ void load_raw(uint8_t* dst, const CUtensorMap* tm,
                                  int kb, int n_block, uint64_t* bar) {
#pragma unroll
    for (int j = 0; j < BN / 64; ++j)
      hopper::tma_load_2d(dst + j * wg::RAW_BOX, tm, n_block + 64 * j,
                          kb * (wg::KB / 2), bar);
  }
  // thread ct of THREADS widens the raw codes' 16-byte chunks ct,
  // ct + THREADS, ...: chunk c holds codes n = 16 (c % 4) .. + 15 of row
  // k = (c / 4) % 64 of box c / 256, whose bf16 are chunks 2 (c % 4) and
  // 2 (c % 4) + 1 of row k of B box c / 256, each at chunk ^ (k % 8) (the
  // 128-byte swizzle TMA writes). All its chunks are read before any is
  // written, so the reads overlap.
  template <int BN, int THREADS>
  static __device__ void widen(uint8_t* slot, const uint8_t* raw, int ct) {
    constexpr int CHUNKS = BN / 64 * wg::RAW_BOX / 16;
    constexpr int PER = (CHUNKS + THREADS - 1) / THREADS;
    const uint32_t src = hopper::smem_u32(raw), dst = hopper::smem_u32(slot);
    uint4 v[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = ct + THREADS * i;
      if (CHUNKS % THREADS == 0 || c < CHUNKS) v[i] = lds128(src + 16 * c);
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = ct + THREADS * i;
      if (CHUNKS % THREADS != 0 && c >= CHUNKS) break;
      const int k = (c >> 2) & 63, q = c & 3;
      const uint32_t row = dst + (c >> 8) * wg::B_BOX + k * wg::KB;
      const uint2 w0 = widen4(v[i].x), w1 = widen4(v[i].y),
                  w2 = widen4(v[i].z), w3 = widen4(v[i].w);
      sts128(row + (((2 * q) ^ (k & 7)) << 4),
             make_uint4(w0.x, w0.y, w1.x, w1.y));
      sts128(row + (((2 * q + 1) ^ (k & 7)) << 4),
             make_uint4(w2.x, w2.y, w3.x, w3.y));
    }
  }
};

template <class Op> struct IsGeluAmax : std::false_type {};
template <typename T> struct IsGeluAmax<S8Op<T, Q8E_GELU_AMAX>>
    : std::true_type {};
// the Op whose B seven warps widen (its codes loaded beside A, a fourth
// warpgroup)
template <class Op> struct Widens : std::false_type {};
template <> struct Widens<Int8wOp> : std::true_type {};
template <class Op>
constexpr int threads_of = Widens<Op>::value ? wg::WIDEN_THREADS : wg::THREADS;
// the Ops with N tiles of 96 and 32 (bf16 x bf16: WgmmaBF16T has them)
template <class Op> struct NarrowTiles : std::false_type {};
template <int EPI> struct NarrowTiles<Bf16Op<EPI>> : std::true_type {};

// Persistent: block b takes tiles b, b + gridDim.x, ... in N-fastest order
// (the blocks in flight share their A rows in L2). The ring's stage and
// phase run on across tiles.
template <class Op, int BN>
__global__ void __launch_bounds__(threads_of<Op>, 1)
wgmma_gemm_kernel(const __grid_constant__ CUtensorMap tm_a,
                  const __grid_constant__ CUtensorMap tm_b,
                  const typename Op::Args p) {
  constexpr bool WIDEN = Widens<Op>::value;
  using S = wg::Smem<BN, WIDEN>;
  constexpr int ST = wg::STAGES, BM = wg::BM;
  constexpr bool AMAX = IsGeluAmax<Op>::value;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int smax[BM];  // AMAX: the tile's per-block maxima
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sa = ring;                     // ST x (BM x 128)
  uint8_t* sb = ring + ST * wg::A_BYTES;  // ST x (BN x 128)
  uint8_t* raw = sb + ST * S::B_BYTES;    // WIDEN: ST x (BN x 64)
  uint64_t* full = reinterpret_cast<uint64_t*>(raw + ST * S::RAW_BYTES);
  uint64_t* empty = full + ST;
  uint64_t* widened = empty + ST;  // WIDEN

  const int n_tiles = p.N / BN;
  const int tiles = ((p.M + BM - 1) / BM) * n_tiles;
  const int nk = (Op::k_bytes(p.K) + wg::KB - 1) / wg::KB;
  const int warpgroup = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 1);   // the producer's expect_tx
      hopper::mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    if constexpr (WIDEN)
      for (int s = 0; s < ST; ++s)
        hopper::mbar_init(&widened[s], wg::WIDEN_WARPS);  // lane 0 each
    hopper::mbar_fence_init();
    hopper::tma_prefetch_map(&tm_a);
    hopper::tma_prefetch_map(&tm_b);
  }
  __syncthreads();

  if constexpr (WIDEN) {
    if (warpgroup == 3 || (warpgroup == 0 && t >= 32)) {
      // ---- widening: warps 1-3 and warpgroup 3 widen slot s's codes into
      // its B once they have landed (so the consumers have handed the slot
      // back), fence the async proxy and arrive on widened[s] -------------
      const int wt = warpgroup == 0 ? t - 32 : 96 + t;
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = it % ST;
          hopper::mbar_wait(&full[s], (it / ST) & 1);
          Op::template widen<BN, 32 * wg::WIDEN_WARPS>(
              sb + s * S::B_BYTES, raw + s * S::RAW_BYTES, wt);
          hopper::fence_proxy_async();  // the stores, before wgmma reads
          __syncwarp();
          if (t % 32 == 0) hopper::mbar_arrive(&widened[s]);
        }
      }
      return;
    }
  }

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
        hopper::mbar_arrive_expect_tx(
            &full[s], wg::A_BYTES + (WIDEN ? S::RAW_BYTES : S::B_BYTES));
        hopper::tma_load_2d(sa + s * wg::A_BYTES, &tm_a, kb * wg::KB, m_block,
                            &full[s]);
        if constexpr (WIDEN)
          Op::template load_raw<BN>(raw + s * S::RAW_BYTES, &tm_b, kb,
                                    n_block, &full[s]);
        else
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
      if constexpr (WIDEN) hopper::mbar_wait(&widened[s], (it / ST) & 1);
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
  using S = wg::Smem<BN, Widens<Op>::value>;
  constexpr int THREADS = threads_of<Op>;
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
                                                        THREADS, S::SIZE);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    blocks = sms * per_sm;
    if (dev < 32) resident[dev] = blocks;
  }
  const long long tiles =
      (long long)((p.M + wg::BM - 1) / wg::BM) * (p.N / BN);
  const int grid = (int)(tiles < blocks ? tiles : blocks);
  kernel<<<grid, THREADS, S::SIZE, s>>>(tm_a, tm_b, p);
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
    case 64: return launch_wgmma<Op, 64>(tm_a, tm_b, p, s);
  }
  if constexpr (NarrowTiles<Op>::value) {
    if (tile_n(p.N) == 96) return launch_wgmma<Op, 96>(tm_a, tm_b, p, s);
    return launch_wgmma<Op, 32>(tm_a, tm_b, p, s);
  }
  return cudaErrorInvalidValue;
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

// int8w: A p.a (M, K) bf16, B p.w (K, N) int8 codes as a byte matrix in
// unswizzled boxes of 64 N x 64 K (Int8wOp::load_raw)
inline cudaError_t gemm_wgmma_int8w(const GemmArgs<bf16, int8_t>& p,
                                    cudaStream_t s) {
  if (p.M <= 0 || gemm_path_int8w(p.K, p.N) != PATH_WGMMA)
    return cudaErrorInvalidValue;
  CUtensorMap tm_a, tm_b;
  int err = hopper::encode_u8_sw128_cached(&tm_a, p.a, p.M, 2LL * p.K,
                                           wg::BM);
  if (err == 0)
    err = hopper::encode_u8_plain_cached(&tm_b, p.w, p.K, p.N, wg::KB / 2,
                                         wg::RAW_BOX / (wg::KB / 2));
  if (err != 0) return (cudaError_t)err;
  return launch_wgmma_tiled<Int8wOp>(tm_a, tm_b, p, s);
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

// P1's int8w product on the path the rule picks, or on the WMMA loop (its
// int8 loader widening on load) when `loop` (the "_loop" entry point)
inline cudaError_t gemm_int8w_any(const GemmArgs<bf16, int8_t>& p, bool loop,
                                  cudaStream_t s) {
  const int path = loop ? PATH_LOOP : gemm_path_int8w(p.K, p.N);
  const cudaError_t err = path == PATH_WGMMA
                              ? gemm_wgmma_int8w(p, s)
                              : gemm<bf16, false, EPI_SCALE, int8_t>(p, s);
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
