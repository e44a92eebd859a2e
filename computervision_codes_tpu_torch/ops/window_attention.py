"""Fused window attention (K10): hand-written CUDA kernel + plain version.

Counterpart of ``computervision_codes_tpu/ops/window_attention.py``. Over
q, k, v (B*nW, H, N, D), a relative-position bias (H, N, N) and an optional
additive mask (nW, N, N) that window w takes as ``mask[w % nW]``:

    out = softmax(q k^T * D**-0.5 + bias + mask) v      per window and head

``window_attention_reference`` is the plain version, the JAX reference op
for op: q scaled in q's dtype, the scores in q's dtype plus the bias and
mask cast to it, the softmax in float32, the weights cast to v's dtype.

``window_attention_cuda`` launches the kernel (``csrc/window_attention.cu``,
one block per (window, head), the scores in shared memory): float32
scores, softmax and PV sums, P rounded to bf16 before the PV product in
bf16, one rounding at the output, as the TPU kernel but for that P. It reads
q, k and v through their strides and writes its (B*nW, H, N, D) output into
(B*nW, N, H, D) memory, so the merge of the heads before the ``proj`` Dense
is a view. ``window_attention_pallas`` and ``window_attention_pallas_multi``
are the TPU kernels' entry points over it, for API parity:
``block_windows`` (windows per TPU grid step) has no counterpart here.

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

from .attention import vector_bytes

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 32  # every Swin variant's; the kernel's q, k, v tiles
MAX_TOKENS = 144  # a 12x12 window: its float32 score tile is 85 KB


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


def window_attention_cuda(q, k, v, bias, mask=None, nw: int = 1):
    """Launch the CUDA kernel on q's device and current stream.

    q, k, v (BW, H, N, 32), float32 or bfloat16, one dtype on one CUDA
    device, any strides with the head dim contiguous; N <= 144. bias
    (H, N, N) and mask (nw, N, N, or None) are cast to q's dtype, as the
    plain version casts them; BW must divide by nw. Returns (BW, H, N, 32)
    whose memory is (BW, N, H, 32). ``launches`` counts the kernel launches
    made through this wrapper.
    """
    if q.device.type != "cuda":
        raise ValueError(f"window_attention_cuda needs CUDA tensors, got "
                         f"{q.device}")
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
    fn = _launch_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                 None if mask is None else mask.data_ptr(), out.data_ptr(),
                 bw, h, n, 1 if mask is None else nw, *strides,
                 vector_bytes((q, k, v), q.element_size()),
                 float(d ** -0.5), _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"window_attention kernel launch failed: CUDA "
                           f"error {err}")
    window_attention_cuda.launches += 1
    return out


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
