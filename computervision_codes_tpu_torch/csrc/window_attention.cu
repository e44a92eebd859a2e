// K10: fused window attention over pre-split q, k, v, written by hand for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
// computervision_codes_tpu/ops/window_attention.py::window_attention_pallas
// (its _kernel) and ::window_attention_pallas_multi (its _kernel_multi, G
// windows per grid step), which Swin reaches through use_fused_attn. Over
// q, k, v (BW, H, N, D) with BW = B * nW windows, a relative-position bias
// (H, N, N) and an optional additive mask (nW, N, N):
//
//   o[w, h] = softmax(q[w, h] k[w, h]^T * D^-0.5 + bias[h]
//                     + mask[w mod nW]) v[w, h]
//
// The TPU kernel scales q in float32 before the product; this one scales
// the float32 scores (the same value up to float32 rounding). bf16 products
// run on the tensor cores (mma.sync) with float32 sums, and P is rounded to
// bf16 before the PV product; float32 runs as FMA.
//
// What bounds it on the card: at Swin-L-384 (B = 16, bf16, D = 32, N = 144)
// the four tensors move 226 / 113 / 56.6 / 28.3 MB per launch at stages 0-3
// against 16.3 / 8.2 / 4.1 / 2.0 GFLOP of products: bytes (0.068 ms at
// stage 0 at 3.35 TB/s; the products 0.016 ms at 989 TFLOP/s). What the
// design does: it runs window_attn.cuh's body, K3's attention phase: one
// small block per (window, head), q, k and v staged in shared memory with
// cp.async, each warp's 16-query strips of scores held in registers
// (mma.sync in bf16, a register-tiled FMA strip in float32), the softmax
// across the four threads of each row, P fed to the PV product from
// registers, so no score or weight tile reaches shared or device memory.
// q, k and v are read through their strides, in the widest copy (16, 8, 4
// or 2 bytes) their rows allow, so the views that Swin's WindowAttention
// cuts from one qkv tensor need no copy; the output goes through its
// strides too, into the (BW, N, H, D) memory that the proj Dense reads
// next. The TPU kernels' window blocking (G windows per grid step)
// amortises grid-step overhead on the TPU and has no counterpart here:
// every (window, head) is a block.
//
// Interface: plain C, loaded with ctypes. The launch goes on the caller's
// stream, never synchronises and allocates nothing; the return value is the
// CUDA error of the launch (0 on success).

#include "swin_common.cuh"

namespace {

template <typename T> struct Args {
  const T *q, *k, *v, *bias, *mask;  // mask may be null
  T* o;
  int n, np, nw;
  long long sq[3], sk[3], sv[3], so[3];  // (window, head, token) strides
  int vb;                                // bytes per load of a q/k/v row
  float scale;
};

// window_attn.cuh's body over (window, head) blocks
template <typename T, int NT>
__global__ void __launch_bounds__(32 * swin::wa::warps_of(NT),
                                  swin::wa::min_blocks_of<T>(NT))
window_attention_kernel(const Args<T> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* sm = reinterpret_cast<T*>(smem);
  const int n = a.n;
  const long long wdw = blockIdx.x, h = blockIdx.y;
  auto src = [&](int which, int r) {
    const T* base = which == 0 ? a.q : which == 1 ? a.k : a.v;
    const long long* st = which == 0 ? a.sq : which == 1 ? a.sk : a.sv;
    return base + wdw * st[0] + h * st[1] + r * st[2];
  };
  T* o = a.o + wdw * a.so[0] + h * a.so[1];
  auto store = [&](int r, int d, float v0, float v1) {
    swin::wa::store_pair(o + r * a.so[2] + d, v0, v1);
  };
  swin::wa::attend<T, NT>(sm, src, a.vb, a.bias + h * n * n,
                          a.mask ? a.mask + (wdw % a.nw) * n * n : nullptr,
                          n, a.scale, store);
}

template <typename T, int NT>
cudaError_t launch_regs(const Args<T>& a, int BW, int H, cudaStream_t s) {
  static unsigned done = 0;  // internal linkage: this library's flag
  const size_t smem = swin::wa::smem_of<T>(NT);
  cudaError_t err =
      swin::allow_smem(window_attention_kernel<T, NT>, smem, done);
  if (err != cudaSuccess) return err;
  window_attention_kernel<T, NT>
      <<<dim3(BW, H), 32 * swin::wa::warps_of(NT), smem, s>>>(a);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++swin::attn_launch_count;
  return err;
}

template <typename T>
cudaError_t launch(const Args<T>& a, int BW, int H, cudaStream_t s) {
  switch (a.np / 16) {
#define CASE(NT) \
  case NT:       \
    return launch_regs<T, NT>(a, BW, H, s);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) CASE(9)
#undef CASE
  }
  return cudaErrorInvalidValue;
}

template <typename T>
int run(const void* q, const void* k, const void* v, const void* bias,
        const void* mask, void* o, int BW, int H, int N, int nw,
        const long long* strides, int vb, float scale, cudaStream_t s) {
  Args<T> a{static_cast<const T*>(q),    static_cast<const T*>(k),
            static_cast<const T*>(v),    static_cast<const T*>(bias),
            static_cast<const T*>(mask), static_cast<T*>(o),
            N, (N + 15) / 16 * 16, nw};
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[3 + i];
    a.sv[i] = strides[6 + i];
    a.so[i] = strides[9 + i];
  }
  a.vb = vb;
  a.scale = scale;
  return (int)launch(a, BW, H, s);
}

int entry(
    const void* q, const void* k, const void* v, const void* bias,
    const void* mask, void* o, int BW, int H, int N, int nw,
    long long sqw, long long sqh, long long sqn, long long skw,
    long long skh, long long skn, long long svw, long long svh,
    long long svn, long long sow, long long soh, long long son, int vb,
    float scale, int dtype, void* stream) {
  const int es = dtype == 1 ? 2 : 4;
  if (BW < 1 || H < 1 || H > 65535 || N < 1 ||
      N > swin::MAX_WINDOW * swin::MAX_WINDOW || nw < 1 ||
      (dtype != 0 && dtype != 1) ||
      !(vb == 16 || vb == 8 || vb == 4 || (vb == 2 && dtype == 1)) ||
      vb < es)
    return (int)cudaErrorInvalidValue;
  const long long strides[12] = {sqw, sqh, sqn, skw, skh, skn,
                                 svw, svh, svn, sow, soh, son};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(q, k, v, bias, mask, o, BW, H, N, nw, strides, vb,
                      scale, s);
  return run<__nv_bfloat16>(q, k, v, bias, mask, o, BW, H, N, nw, strides,
                            vb, scale, s);
}

}  // namespace

// q, k, v and the output o (BW, H, N, 32), each given by its (window, head,
// token) element strides (the head dim contiguous), in dtype (0 float32,
// 1 bf16); bias (H, N, N) and mask (nw, N, N, or null) contiguous in dtype.
// Window w takes mask[w % nw]. vb: bytes per load of a q, k or v row (16,
// 8, 4, or 2 for bf16), which every row's address must be aligned to;
// scale: the score scale, D^-0.5.
extern "C" int window_attention_launch(
    const void* q, const void* k, const void* v, const void* bias,
    const void* mask, void* o, int BW, int H, int N, int nw,
    long long sqw, long long sqh, long long sqn, long long skw,
    long long skh, long long skn, long long svw, long long svh,
    long long svn, long long sow, long long soh, long long son, int vb,
    float scale, int dtype, void* stream) {
  return entry(q, k, v, bias, mask, o, BW, H, N, nw, sqw, sqh, sqn, skw, skh,
               skn, svw, svh, svn, sow, soh, son, vb, scale, dtype, stream);
}
