"""Fused window attention (K10): hand-written CUDA kernel + plain version.

Counterpart of ``computervision_codes_tpu/ops/window_attention.py``. Over
q, k, v (B*nW, H, N, D), a relative-position bias (H, N, N) and an optional
additive mask (nW, N, N) that window w takes as ``mask[w % nW]``:

    out = softmax(q k^T * D**-0.5 + bias + mask) v      per window and head

``window_attention_reference`` is the plain version, the JAX reference op
for op: q scaled in q's dtype, the scores in q's dtype plus the bias and
mask cast to it, the softmax in float32, the weights cast to v's dtype.

``window_attention_cuda`` launches the kernel (``csrc/window_attention.cu``
over ``csrc/window_attn.cuh``: one small block per (window, head), each
warp holding its 16-query strips' scores in registers): float32 scores,
softmax and PV sums, P rounded to bf16 before the PV product in bf16, one
rounding at the output, as the TPU kernel but for that P. It reads q, k and
v through their strides and writes its (B*nW, H, N, D) output into
(B*nW, N, H, D) memory, so the merge of the heads before the ``proj`` Dense
is a view. ``window_attention_pallas`` and ``window_attention_pallas_multi``
are the TPU kernels' entry points over it, for API parity:
``block_windows`` (windows per TPU grid step) has no counterpart here.

The attention phase that K10 and K3 (``ops/window_mhsa.py``; K5 and K6
run K3's phases) share is counted per library in ``phase_launches`` by the
wrappers, and by each C library itself
(``library_phase_launches``); ``attn_plan`` is its launch geometry and
``window_attn_strips_reference`` a plain emulation of its strip algorithm.

``window_attention_fused`` is the differentiable op Swin's
``use_fused_attn`` calls: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel, anything else raises; its backward
differentiates the plain version, as the JAX ``custom_vjp`` does
(``ops/window_attention.py:181-190`` there).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import mlp_block
from .attention import vector_bytes

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 32  # every Swin variant's; the kernel's q, k, v tiles
MAX_TOKENS = 144  # a 12x12 window: the strips the kernels instantiate

# the libraries that run the attention phase (csrc/window_attn.cuh): K3
# (and K6's attention branch), K5 and K10
PHASE_LIBRARIES = ("window_mhsa", "swin_block", "window_attention")
# library -> attention-phase launches through its wrappers
phase_launches = dict.fromkeys(PHASE_LIBRARIES, 0)

# the H100: shared memory per SM and per block (bytes), the 1 KB the
# runtime reserves per block, threads per SM (the hopper-kernels guide)
SMEM_PER_SM, SMEM_PER_BLOCK, SMEM_RESERVED = 233_472, 232_448, 1024
THREADS_PER_SM, BLOCKS_PER_SM = 2048, 32


def attn_plan(n: int, dtype) -> dict:
    """The launch geometry of the attention phase at ``n`` tokens per
    window, as ``csrc/window_attn.cuh`` computes it: ``np`` (n padded to
    16-query strips), ``strips``, ``warps`` per block and ``rounds`` (each
    warp takes one strip a round), ``smem`` (q, k and v tiles, bytes) and
    ``blocks_per_sm`` (by shared memory and threads; registers, which
    ptxas reports, may hold fewer)."""
    if not 1 <= n <= MAX_TOKENS:
        raise ValueError(f"the attention phase takes 1 <= n <= {MAX_TOKENS} "
                         f"tokens, got {n}")
    es = {torch.bfloat16: 2, torch.float32: 4}[dtype]
    strips = -(-n // 16)
    rounds = -(-strips // 4)
    warps = -(-strips // rounds)
    ld = HEAD_DIM + (8 if es == 2 else 4)  # padded row, elements
    smem = 3 * 16 * strips * ld * es
    threads = 32 * warps
    per_sm = min(SMEM_PER_SM // (smem + SMEM_RESERVED),
                 THREADS_PER_SM // threads, BLOCKS_PER_SM)
    return {"np": 16 * strips, "strips": strips, "warps": warps,
            "rounds": rounds, "threads": threads, "smem": smem,
            "blocks_per_sm": per_sm}


def count_phase(library: str) -> None:
    """One attention-phase launch of ``library``."""
    phase_launches[library] += 1


def library_phase_launches(library: str) -> int:
    """The C library's own attention-phase launches since it was loaded or
    reset (``swin_attn_launches``; builds and loads it: the card only)."""
    from ._build import load_library

    fn = load_library(library).swin_attn_launches
    fn.argtypes, fn.restype = [], ctypes.c_longlong
    return fn()


def reset_phase_launches() -> None:
    """Every library's attention-phase counts to 0, here and in the C
    libraries already loaded in this process."""
    from ._build import loaded

    for library in PHASE_LIBRARIES:
        phase_launches[library] = 0
        lib = loaded(library)
        if lib is not None:
            reset = lib.swin_attn_reset
            reset.argtypes, reset.restype = [], None
            reset()


def window_attn_strips_reference(q, k, v, bias, mask=None, nw: int = 1):
    """The attention phase's algorithm in plain PyTorch, strip by strip, in
    q's dtype T: the window padded to whole 16-query strips (zero q, k, v
    rows), S = q k^T in float32, s * D**-0.5 + bias (+ mask) with bias and
    mask cast to T, -inf past the real keys, the row max, exp, the row sum
    as the kernel takes it (each of the four threads of a row adds its
    keys 8 j + 2 t + {0, 1} in order, then (t0 + t1) + (t2 + t3)), the
    denominator floored at 1e-30, P = T(e / sum), O = T(P v) with float32
    sums; padded query rows dropped. q, k, v (BW, H, N, D); bias (H, N,
    N); mask (nW, N, N) or None, window w taking mask[w % nW]."""
    bw, h, n, d = q.shape
    dtype = q.dtype
    np_ = -(-n // 16) * 16
    pad = (0, 0, 0, np_ - n)
    qp, kp, vp = (torch.nn.functional.pad(t.float(), pad) for t in (q, k, v))
    extra = bias.to(dtype).float()[None].expand(bw, h, n, n)
    if mask is not None:
        extra = extra + mask.to(dtype).float().repeat(bw // nw, 1, 1)[:, None]
    out = torch.empty(bw, h, np_, d, dtype=dtype)
    for st in range(np_ // 16):
        rows = slice(16 * st, 16 * st + 16)
        s = torch.matmul(qp[:, :, rows], kp.transpose(-1, -2)) * d ** -0.5
        real = min(16, n - 16 * st)  # the strip's real query rows
        add = torch.zeros(bw, h, 16, np_)
        add[:, :, :real, :n] = extra[:, :, 16 * st:16 * st + real]
        s = s + add
        s[..., n:] = float("-inf")
        e = torch.exp(s - s.amax(-1, keepdim=True))
        # keys 8 j + 2 t + f -> (t, j, f): thread t's terms in key order
        parts = e.reshape(bw, h, 16, np_ // 8, 4, 2).transpose(-3, -2)
        parts = parts.reshape(bw, h, 16, 4, -1)
        acc = torch.zeros(bw, h, 16, 4)
        for i in range(parts.shape[-1]):
            acc = acc + parts[..., i]
        total = (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])
        inv = 1.0 / torch.clamp(total, min=1e-30)
        p = (e * inv[..., None]).to(dtype)
        out[:, :, rows] = torch.matmul(p.float(), vp).to(dtype)
    return out[:, :, :n]


def window_attention_reference(q, k, v, bias, mask=None, nw: int = 1):
    """q, k, v (BW, H, N, D); bias (H, N, N); mask (nW, N, N) additive, or
    None."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("whnd,whmd->whnm", q * scale, k)
    s = s + bias[None].to(s.dtype)
    if mask is not None:
        bw = q.shape[0]
        s = s.reshape(bw // nw, nw, *s.shape[1:])
        s = s + mask[None, :, None].to(s.dtype)
        s = s.reshape(bw, *s.shape[2:])
    p = torch.softmax(s.float(), dim=-1).to(v.dtype)
    return torch.einsum("whnm,whmd->whnd", p, v)


@functools.cache
def _launch_fn():
    """The C entry point of ``csrc/window_attention.cu`` (built on first
    use), with its argument types declared."""
    from ._build import load_library

    fn = load_library("window_attention").window_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def launch_window_attention(q, k, v, bias, mask, nw: int, *, counter):
    """Launch the CUDA kernel on q's device and current stream; add one to
    ``counter.launches`` and to the phase's count.

    q, k, v (BW, H, N, 32), float32 or bfloat16, one dtype on one CUDA
    device, any strides with the head dim contiguous; N <= 144. bias
    (H, N, N) and mask (nw, N, N, or None) are cast to q's dtype, as the
    plain version casts them; BW must divide by nw. Returns (BW, H, N, 32)
    whose memory is (BW, N, H, 32).
    """
    mlp_block.on_card("window_attention_cuda", q)
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"window_attention kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    if q.ndim != 4:
        raise ValueError(f"q must be (BW, H, N, D), got {tuple(q.shape)}")
    bw, h, n, d = q.shape
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != tuple(q.shape):
            raise ValueError(f"{name} must be {tuple(q.shape)}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; q is "
                             f"{q.dtype} on {q.device}")
    if d != HEAD_DIM:
        raise ValueError(f"window_attention kernel takes head dim "
                         f"{HEAD_DIM}, got {d}")
    if not 1 <= n <= MAX_TOKENS:
        raise ValueError(f"window_attention kernel takes 1 <= N <= "
                         f"{MAX_TOKENS} tokens per window, got {n}")
    if tuple(bias.shape) != (h, n, n):
        raise ValueError(f"bias must be {(h, n, n)}, got "
                         f"{tuple(bias.shape)}")
    if mask is not None and (tuple(mask.shape) != (nw, n, n) or bw % nw):
        raise ValueError(f"mask must be (nw, N, N) = {(nw, n, n)} with BW = "
                         f"{bw} a multiple of nw, got {tuple(mask.shape)}")
    for name, t in (("bias", bias), ("mask", mask)):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name} is on {t.device}; q is on {q.device}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    bias = bias.to(q.dtype).contiguous()
    if mask is not None:
        mask = mask.to(q.dtype).contiguous()
    out = torch.empty(bw, n, h, d, dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if bw == 0:
        return out
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    err = mlp_block.run_entry(_launch_fn(), q.device, q, k, v, bias,
                              mask, out, bw, h, n,
                              1 if mask is None else nw, *strides,
                              vector_bytes((q, k, v), q.element_size()),
                              float(d ** -0.5), _DTYPE_CODES[q.dtype])
    if err != 0:
        raise RuntimeError(f"window_attention kernel launch failed: CUDA "
                           f"error {err}")
    counter.launches += 1
    count_phase("window_attention")
    return out


def window_attention_cuda(q, k, v, bias, mask=None, nw: int = 1):
    """Launch K10 (``launch_window_attention``) on q's device and current
    stream. ``launches`` counts the kernel launches made through this
    wrapper."""
    return launch_window_attention(q, k, v, bias, mask, nw,
                                   counter=window_attention_cuda)


window_attention_cuda.launches = 0


def window_attention_pallas(q, k, v, bias, mask=None, nw: int = 1):
    """The one-window TPU kernel's entry point (``window_attention.py:57``
    there): K10 on the card."""
    return window_attention_cuda(q, k, v, bias, mask, nw)


def window_attention_pallas_multi(q, k, v, bias, mask=None, nw: int = 1,
                                  block_windows: int = 8):
    """The multi-window TPU kernel's entry point (``window_attention.py:107``
    there): K10 on the card. ``block_windows`` is accepted for parity and
    does not change the launch."""
    if block_windows < 1:
        raise ValueError(f"block_windows must be >= 1, got {block_windows}")
    return window_attention_cuda(q, k, v, bias, mask, nw)


def _forward(q, k, v, bias, mask, nw, block_windows):
    if q.device.type == "cpu":
        return window_attention_reference(q, k, v, bias, mask, nw)
    if q.device.type == "cuda":
        if block_windows > 1:
            return window_attention_pallas_multi(q, k, v, bias, mask, nw,
                                                 block_windows)
        return window_attention_pallas(q, k, v, bias, mask, nw)
    raise ValueError(f"window_attention_fused runs on CPU (plain version) or "
                     f"CUDA (kernel) tensors, got {q.device}")


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, mask, nw, block_windows):
        ctx.save_for_backward(q, k, v, bias)
        ctx.mask, ctx.nw = mask, nw
        return _forward(q, k, v, bias, mask, nw, block_windows)

    @staticmethod
    def backward(ctx, g):
        inputs = [a.detach().requires_grad_() for a in ctx.saved_tensors]
        with torch.enable_grad():
            out = window_attention_reference(*inputs, ctx.mask, ctx.nw)
        return (*torch.autograd.grad(out, inputs, g), None, None, None)


def window_attention_fused(q, k, v, bias, mask=None, nw: int = 1,
                           block_windows: int = 8):
    """Differentiable window attention: kernel forward on CUDA (the multi
    entry point when ``block_windows`` > 1, as in JAX), plain forward on
    CPU, backward through the plain version (no gradient for the mask)."""
    return _WindowAttention.apply(q, k, v, bias, mask, nw, block_windows)
