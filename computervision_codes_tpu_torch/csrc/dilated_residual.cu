// One dilated residual TCN layer, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// computervision_codes_tpu/ops/dilated_conv.py::dilated_residual_pallas
// (its _kernel). Per layer, over x of shape (B, T, C):
//
//   y[b, t] = x[b, t] + relu(sum_k x[b, t + o_k] W_k + b1) W2 + b2
//
// with tap offsets o = (-d, 0, +d), or (-2d, -d, 0) when causal, and rows
// outside [0, T) read as zero (the convolution's zero padding).
// Accumulation is in float32; H is rounded to x's dtype before the second
// product, and the output is stored in x's dtype.
//
// What bounds it on the card: the layer is four (rows x C) x (C x C)
// products, 8 rows C^2 FLOP against 2 rows C + 4 C^2 elements of traffic,
// so by arithmetic intensity it is tensor-core bound (0.0022 ms at
// (4, 256, 512) in bf16). At the main path's sizes (C = 512; 1,024 rows
// offline, 256 to 4,096 when streaming) there are few rows, so what sets the
// pace is how many SMs share the 2 MB of weights and how many round trips
// stand between a block and its last product.
//
// The bf16 design (dilated_residual_launch): a thread-block cluster of S
// CTAs owns a tile of BM = 64 rows, and CTA r of the cluster owns the
// hidden and output columns [r SW, (r + 1) SW) (plan_of: SW = 64 up to
// C = 512 where the layer's clusters fit on the card at once, else 128;
// S = C / SW, 8 or 4 at C = 512). Each CTA
//   1. GEMM 1: multiplies [x(t + o0) | x(t + o1) | x(t + o2)] (64 x 3C) by
//      W_taps[:, :, slice] (3C x SW) on wgmma (m64nSWk16, float32 sums), then
//      adds b1, applies relu, rounds to bf16 and writes its 64 x SW slice of
//      H into its own shared memory, in the operand layout of GEMM 2's A;
//   2. exchanges H: one thread pushes the CTA's slice into every other CTA's
//      shared memory by bulk copy (distributed shared memory), completing on
//      the receiver's mbarrier, which expects the other S - 1 slices; so each
//      CTA holds the whole 64 x C tile once its barrier completes;
//   3. GEMM 2: multiplies H (64 x C) by W2[:, slice] (C x SW), adds b2 and
//      the residual in float32 (x's centre tap for its own columns, copied
//      out of the ring while it was resident) and stores bf16.
// Loads: one producer warp issues TMA into a ring of STAGES stages of
// 128 bytes of depth (64 channels), handed over by full/empty mbarriers; a
// stage goes back as soon as the wgmmas that read it have completed.
// x comes from a 3-D map over (B, T, C) in boxes of 8 rows, at row
// t0 + o_k; rows outside [0, T), negative ones included, come back as zeros,
// so d >= T and the causal taps need no masks. Every CTA of the cluster
// needs the same x stage, so each issues a share of its 8-row boxes as a
// multicast to all of them, and a stage is free again only when the
// consumers of every CTA have released it (each consumer warp arrives on
// the empty barrier of every CTA). The weight slices come by TMA as the
// MN-major B operand, read in place from the (C_in, C_out) layout. One
// consumer warpgroup runs the wgmmas. So each CTA reads its 1/S of the
// weights (256 or 512 KB at C = 512, where a block of the previous design
// read all 2 MB) and issues 1/S of x's taps, and the grid has
// S x ceil(T / 64) x B CTAs:
// at C = 512 an H100 holds 15 clusters of 8 at once, so streams 1 runs 4
// clusters of 8 (32 CTAs) and the offline shape and streams 16 take
// 128-column CTAs, 16 and 64 clusters of 4, rather than two or five waves.
//
// float32 keeps the previous design's kernel (FMA, so float32 stays
// float32), with the shared-memory attribute set once per device.
// dilated_residual_prev_launch runs the previous design
// (csrc/dilated_residual_prev.cuh) in both dtypes, for timings only.
//
// Constraint: C % 128 == 0 and C <= 1024.
//
// Interface: plain C, loaded with ctypes. A launch goes on the caller's
// stream, never synchronises and allocates nothing; the return value is
// the CUDA error of the launch (0 on success). Each entry point counts its
// successful launches per design (dilated_residual_launches).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dilated_residual_prev.cuh"
#include "hopper_gemm.cuh"

namespace k1 {
namespace {  // internal linkage: the flags and caches are this library's

using bf16 = __nv_bfloat16;

constexpr int BM = 64;            // rows a cluster owns
constexpr int TILE = BM * 128;    // a 64-row tile of 128 bytes (64 bf16)
constexpr int CONSUMERS = 128;    // one warpgroup
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr int X_BOX_ROWS = 8;     // x boxes: one swizzle atom of rows

// the plan (plan_of): the columns a CTA owns, the cluster size, the ring's
// stages
struct Plan {
  int sw, cluster, stages;
};

// SW columns a CTA, ST stages: as deep as shared memory allows at the
// largest C the instantiation serves (the ring's refill, about 2.5 us from
// a release to the bytes landing, sets the pace, and the bytes in flight
// are what hide it): (64, 9) and (128, 6) up to C = 512, (128, 3) above
template <int SW, int ST> struct Cfg {
  static constexpr int STAGES = ST;
  // a CTA's slice of H, of the residual, of a weight stage: SW / 64 tiles
  static constexpr int SLICE_BYTES = (SW / 64) * TILE;
  static constexpr int B_BYTES = SLICE_BYTES;
  static constexpr int STAGE = TILE + B_BYTES;      // x tile, then B
  // 1024 to align by hand, the ring, H (C / 64 tiles), the residual's
  // SW / 64 tiles, 2 STAGES + 1 mbarriers
  static size_t smem(int C) {
    return 1024 + (size_t)STAGES * STAGE + (size_t)(C / 64) * TILE +
           (size_t)SLICE_BYTES + (2 * STAGES + 1) * 8;
  }
};

// byte offset of bf16 column c (even) of row m in a 64-row swizzled tile
__device__ __forceinline__ uint32_t sw_offset(int m, int c) {
  return (uint32_t)(m * 128 + ((((c * 2) >> 4) ^ (m & 7)) << 4) +
                    ((c * 2) & 15));
}

// an mbarrier wait that traps instead of hanging when a phase never
// completes (a broken hand-over fails the launch, not the card)
__device__ __forceinline__ void wait_or_trap(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = hopper::smem_u32(bar);
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (n > (1u << 24)) __trap();
  }
}

// the consumers' hand-back of a stage: lane l < S of each warp arrives on
// the stage's empty barrier in CTA l (at CTA scope: the wgmmas that read
// the stage have completed, and nothing is published)
__device__ __forceinline__ void release(uint64_t* empty, int lane, int S) {
  if (lane < S) hopper::mbar_arrive_cluster(
      hopper::mapa(hopper::smem_u32(empty), (uint32_t)lane));
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

template <int SW, int ST_>
__global__ void __launch_bounds__(THREADS, 1)
k1_kernel(const __grid_constant__ CUtensorMap tm_x,
          const __grid_constant__ CUtensorMap tm_w,
          const __grid_constant__ CUtensorMap tm_w2,
          const bf16* __restrict__ b1, const bf16* __restrict__ b2,
          bf16* __restrict__ y, int T, int C, int dilation, int causal) {
  using G = Cfg<SW, ST_>;
  constexpr int ST = G::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int nkc = C / 64;             // 64-channel depth chunks
  uint8_t* hbuf = ring + ST * G::STAGE;  // H: nkc tiles
  uint8_t* rbuf = hbuf + nkc * TILE;     // x's centre tap, own columns
  uint64_t* full = reinterpret_cast<uint64_t*>(rbuf + G::SLICE_BYTES);
  uint64_t* empty = full + ST;
  uint64_t* hfull = empty + ST;

  const int S = C / SW;
  const int rank = (int)hopper::cluster_ctarank();
  const int t0 = (blockIdx.x / S) * BM;
  const int b = blockIdx.y;
  const int n0 = rank * SW;  // this CTA's first hidden / output column
  const int n1 = 3 * nkc, n_all = n1 + nkc;  // stages of GEMM 1, of both

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 1);      // the producer's expect_tx
      hopper::mbar_init(&empty[s], 4 * S);  // 4 consumer warps x S CTAs
    }
    // the other CTAs' slices of H: this arrival and their bytes
    hopper::mbar_init(hfull, 1);
    hopper::mbar_arrive_expect_tx(hfull, (S - 1) * G::SLICE_BYTES);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  // every CTA's barriers exist before any CTA arrives on them or multicasts
  hopper::cluster_sync();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer: one thread ---------------------------------------------
    if (threadIdx.x == CONSUMERS) {
      hopper::tma_prefetch_map(&tm_x);
      hopper::tma_prefetch_map(&tm_w);
      hopper::tma_prefetch_map(&tm_w2);
      const uint16_t mask = (uint16_t)((1u << S) - 1);
      const int off[3] = {causal ? -2 * dilation : -dilation,
                          causal ? -dilation : 0, causal ? 0 : dilation};
      for (int it = 0; it < n_all; ++it) {
        const int s = it % ST;
        wait_or_trap(&empty[s], ((it / ST) & 1) ^ 1);
        uint8_t* a = ring + s * G::STAGE;
        uint8_t* bs = a + TILE;
        if (it < n1) {
          const int k = it / nkc, kc = it % nkc;
          // the whole x tile arrives here, this CTA's share from itself
          hopper::mbar_arrive_expect_tx(&full[s], TILE + G::B_BYTES);
          for (int g = rank; g < BM / X_BOX_ROWS; g += S)
            hopper::tma_load_3d_multicast(
                a + g * X_BOX_ROWS * 128, &tm_x, kc * 128,
                t0 + off[k] + g * X_BOX_ROWS, b, &full[s], mask);
#pragma unroll
          for (int j = 0; j < SW / 64; ++j)
            hopper::tma_load_2d(bs + j * TILE, &tm_w, 2 * (n0 + 64 * j),
                                k * C + kc * 64, &full[s]);
        } else {
          const int kc = it - n1;
          hopper::mbar_arrive_expect_tx(&full[s], G::B_BYTES);
#pragma unroll
          for (int j = 0; j < SW / 64; ++j)
            hopper::tma_load_2d(bs + j * TILE, &tm_w2, 2 * (n0 + 64 * j),
                                kc * 64, &full[s]);
        }
      }
    }
    __syncwarp();
    hopper::cluster_sync();  // the consumers' closing barrier
    return;
  }

  // ---- consumers: one warpgroup, rows 16 w + g (+ 8) of the tile ------------
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int centre = causal ? 2 : 1;    // the tap at offset 0
  const int kc_own = n0 / 64;           // the centre tap's chunks we keep
  float acc[SW / 2];
#pragma unroll
  for (int i = 0; i < SW / 2; ++i) acc[i] = 0.0f;

  // GEMM 1: acc = [x taps] (64 x 3C) x W_taps[:, :, slice]
  for (int it = 0; it < n1; ++it) {
    const int s = it % ST;
    wait_or_trap(&full[s], (it / ST) & 1);
    const uint8_t* a = ring + s * G::STAGE;
    const uint8_t* bs = a + TILE;
#pragma unroll
    for (int i = 0; i < SW / 2; ++i) hopper::fence_operand(acc[i]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::WgmmaBF16T<SW>::run(
          acc, hopper::smem_desc_sw128(a + 32 * kk),
          hopper::smem_desc_sw128_mn(bs + 2048 * kk, TILE));
    hopper::wgmma_commit();
    const int k = it / nkc, kc = it % nkc;
    if (k == centre && kc >= kc_own && kc < kc_own + SW / 64) {
      // the residual of our columns, while the stage is held
      const uint4* src = reinterpret_cast<const uint4*>(a);
      uint4* dst = reinterpret_cast<uint4*>(rbuf + (kc - kc_own) * TILE);
#pragma unroll
      for (int i = 0; i < TILE / 16 / CONSUMERS; ++i)
        dst[threadIdx.x + i * CONSUMERS] = src[threadIdx.x + i * CONSUMERS];
    }
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < SW / 2; ++i) hopper::fence_operand(acc[i]);
    release(&empty[s], lane, S);
  }

  // H = bf16(relu(acc + b1)) into our slice's tiles of hbuf:
  // acc[4j + 2h + c] is row 16 w + g + 8 h, column n0 + 8 j + 2 q + c
#pragma unroll
  for (int j = 0; j < SW / 8; ++j) {
    const int n = n0 + 8 * j + 2 * q;
    const float bb0 = __bfloat162float(b1[n]);
    const float bb1 = __bfloat162float(b1[n + 1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 16 * w + g + 8 * h;
      const __nv_bfloat162 v = __floats2bfloat162_rn(
          fmaxf(acc[4 * j + 2 * h] + bb0, 0.0f),
          fmaxf(acc[4 * j + 2 * h + 1] + bb1, 0.0f));
      *reinterpret_cast<__nv_bfloat162*>(hbuf + (n / 64) * TILE +
                                         sw_offset(m, n % 64)) = v;
    }
  }
  // our slice is written: GEMM 2's wgmma here and the bulk copies to the
  // other CTAs read it through the async proxy
  hopper::fence_proxy_async();
  consumers_sync();
  if (threadIdx.x == 0) {
    const uint32_t off0 = (uint32_t)(rank * G::SLICE_BYTES);
    for (int l = 0; l < S; ++l)
      if (l != rank)
        hopper::bulk_copy_to_cta(
            hopper::mapa(hopper::smem_u32(hbuf + off0), (uint32_t)l),
            hbuf + off0, G::SLICE_BYTES,
            hopper::mapa(hopper::smem_u32(hfull), (uint32_t)l));
  }
  wait_or_trap(hfull, 0);  // the other S - 1 slices have landed

  // GEMM 2: acc = H (64 x C) x W2[:, slice]
#pragma unroll
  for (int i = 0; i < SW / 2; ++i) acc[i] = 0.0f;
  for (int it = n1; it < n_all; ++it) {
    const int s = it % ST;
    const int kc = it - n1;
    wait_or_trap(&full[s], (it / ST) & 1);
    const uint8_t* bs = ring + s * G::STAGE + TILE;
    const uint8_t* a = hbuf + kc * TILE;
#pragma unroll
    for (int i = 0; i < SW / 2; ++i) hopper::fence_operand(acc[i]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::WgmmaBF16T<SW>::run(
          acc, hopper::smem_desc_sw128(a + 32 * kk),
          hopper::smem_desc_sw128_mn(bs + 2048 * kk, TILE));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < SW / 2; ++i) hopper::fence_operand(acc[i]);
    release(&empty[s], lane, S);
  }

  // y = x + acc + b2 for rows inside [0, T)
#pragma unroll
  for (int j = 0; j < SW / 8; ++j) {
    const int nl = 8 * j + 2 * q;  // column within the slice
    const float bb0 = __bfloat162float(b2[n0 + nl]);
    const float bb1 = __bfloat162float(b2[n0 + nl + 1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 16 * w + g + 8 * h;
      if (t0 + m >= T) continue;
      const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(
          rbuf + (nl / 64) * TILE + sw_offset(m, nl % 64));
      const __nv_bfloat162 v = __floats2bfloat162_rn(
          __low2float(r) + acc[4 * j + 2 * h] + bb0,
          __high2float(r) + acc[4 * j + 2 * h + 1] + bb1);
      *reinterpret_cast<__nv_bfloat162*>(
          y + ((size_t)b * T + t0 + m) * C + n0 + nl) = v;
    }
  }
  // no CTA leaves while another may still copy from it or arrive on its
  // barriers
  hopper::cluster_sync();
}

template <int SW, int ST>
cudaError_t smem_once(size_t bytes) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(k1_kernel<SW, ST>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess && dev < 64) done[dev] = true;
  return e;
}

// the launch configuration of (B, T, C); attr must outlive cfg's use
template <int SW, int ST>
cudaLaunchConfig_t config(int B, int T, int C, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((C / SW) * ((T + BM - 1) / BM), B, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = Cfg<SW, ST>::smem(C);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C / SW;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the attribute of instantiation (SW, ST), for the largest C it serves
template <int SW, int ST>
cudaError_t smem_ready() {
  return smem_once<SW, ST>(Cfg<SW, ST>::smem(ST == 3 ? 1024 : 512));
}

// The clusters of 64-column CTAs (Cfg<64, 9>) at width C that the current
// card holds at once (15 at C = 512 on an H100: 8 SMs of one GPC a
// cluster), asked once per device and C; 0 on an error.
int resident_clusters(int C) {
  static int counts[64][5] = {};  // by device and C / 128 - 1 (C <= 512)
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || C > 512) return 0;
  int* slot = dev < 64 ? &counts[dev][C / 128 - 1] : nullptr;
  if (slot != nullptr && *slot > 0) return *slot;
  if (smem_ready<64, 9>() != cudaSuccess) return 0;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<64, 9>(1, BM, C, 0, attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, k1_kernel<64, 9>, &cfg) !=
      cudaSuccess)
    return 0;
  if (slot != nullptr) *slot = n;
  return n;
}

// The plan (mirrored by ops/dilated_conv.py::dilated_residual_plan): up to
// C = 512, CTAs of 64 columns (clusters of C / 64) where the layer's
// clusters fit on the card at once, else of 128 (half as many, twice the
// work each, but one wave instead of several); above 512, 128 columns
inline Plan plan_of(int B, int T, int C) {
  if (C > 512) return {128, C / 128, 3};
  const long long clusters = (long long)B * ((T + BM - 1) / BM);
  const int resident = resident_clusters(C);
  if (resident > 0 && clusters > resident) return {128, C / 128, 6};
  return {64, C / 64, 9};
}

template <int SW, int ST>
int launch(const void* x, const void* w_taps, const void* b1, const void* w2,
           const void* b2, void* y, int B, int T, int C, int dilation,
           int causal, cudaStream_t stream) {
  cudaError_t e = smem_ready<SW, ST>();
  if (e != cudaSuccess) return (int)e;
  CUtensorMap mx, mw, mw2;
  int err = hopper::encode_u8_sw128_3d_cached(&mx, x, B, T, 2LL * C,
                                              X_BOX_ROWS);
  if (err == 0)
    err = hopper::encode_u8_sw128_cached(&mw, w_taps, 3LL * C, 2LL * C, 64);
  if (err == 0)
    err = hopper::encode_u8_sw128_cached(&mw2, w2, C, 2LL * C, 64);
  if (err != 0) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<SW, ST>(B, T, C, stream, attr);
  e = cudaLaunchKernelEx(&cfg, k1_kernel<SW, ST>, mx, mw, mw2,
                         static_cast<const bf16*>(b1),
                         static_cast<const bf16*>(b2), static_cast<bf16*>(y),
                         T, C, dilation, causal);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the bf16 launch as the plan says
int launch_planned(const void* x, const void* w_taps, const void* b1,
                   const void* w2, const void* b2, void* y, int B, int T,
                   int C, int dilation, int causal, cudaStream_t s) {
  const Plan p = plan_of(B, T, C);
  if (p.sw == 64)
    return launch<64, 9>(x, w_taps, b1, w2, b2, y, B, T, C, dilation,
                         causal, s);
  if (p.stages == 6)
    return launch<128, 6>(x, w_taps, b1, w2, b2, y, B, T, C, dilation,
                          causal, s);
  return launch<128, 3>(x, w_taps, b1, w2, b2, y, B, T, C, dilation, causal,
                        s);
}

// successful launches per design: 0 the current one, 1 the previous
long long launch_counts[2] = {0, 0};

bool valid(int B, int T, int C, int dilation) {
  return B > 0 && T > 0 && C > 0 && C % 128 == 0 && C <= 1024 &&
         dilation >= 0 && B <= 65535;
}

}  // namespace
}  // namespace k1

// dtype: 0 = float32, 1 = bfloat16. All pointers are contiguous device
// buffers of that dtype, 16-byte aligned: x and y (B, T, C), w_taps
// (3, C, C), b1 (C), w2 (C, C), b2 (C). bf16 runs the cluster design,
// float32 the FMA kernel. Returns a cudaError_t value (0 on success).
extern "C" int dilated_residual_launch(const void* x, const void* w_taps,
                                       const void* b1, const void* w2,
                                       const void* b2, void* y, int B,
                                       int T_len, int C, int dilation,
                                       int causal, int dtype, void* stream) {
  if (!k1::valid(B, T_len, C, dilation)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0)
    err = k1prev::launch<float>(x, w_taps, b1, w2, b2, y, B, T_len, C,
                                dilation, causal, s);
  else if (dtype == 1)
    err = k1::launch_planned(x, w_taps, b1, w2, b2, y, B, T_len, C, dilation,
                             causal, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err == 0) ++k1::launch_counts[0];
  return err;
}

// The previous design (csrc/dilated_residual_prev.cuh) in either dtype, for
// timings only; arguments as dilated_residual_launch.
extern "C" int dilated_residual_prev_launch(const void* x, const void* w_taps,
                                            const void* b1, const void* w2,
                                            const void* b2, void* y, int B,
                                            int T_len, int C, int dilation,
                                            int causal, int dtype,
                                            void* stream) {
  if (!k1::valid(B, T_len, C, dilation)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0)
    err = k1prev::launch<float>(x, w_taps, b1, w2, b2, y, B, T_len, C,
                                dilation, causal, s);
  else if (dtype == 1)
    err = k1prev::launch<__nv_bfloat16>(x, w_taps, b1, w2, b2, y, B, T_len,
                                        C, dilation, causal, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err == 0) ++k1::launch_counts[1];
  return err;
}

// The launches since the library was loaded or reset: out[0] the current
// design's, out[1] the previous design's.
extern "C" void dilated_residual_launches(long long* out) {
  out[0] = k1::launch_counts[0];
  out[1] = k1::launch_counts[1];
}

extern "C" void dilated_residual_reset() {
  k1::launch_counts[0] = k1::launch_counts[1] = 0;
}

// The plan for (B, T, C) as the kernel takes it: out = {slice width,
// cluster size, ring stages, clusters of 64-column CTAs the current card
// holds at once (0 above C = 512)}; 0, or a CUDA error.
extern "C" int dilated_residual_plan(int B, int T, int C, int* out) {
  if (!k1::valid(B, T, C, 0)) return (int)cudaErrorInvalidValue;
  const k1::Plan p = k1::plan_of(B, T, C);
  out[0] = p.sw;
  out[1] = p.cluster;
  out[2] = p.stages;
  out[3] = k1::resident_clusters(C);
  return (int)cudaGetLastError();
}
