"""Full multi-head attention (K7): hand-written CUDA kernel + plain version.

Counterpart of ``computervision_codes_tpu/ops/attention.py``'s
``attention_reference``, ``attention_pallas`` (the TPU kernel) and
``multi_head_attention``. Over (B, H, T, D) query, key and value:

    out = softmax((q * D**-0.5) k^T) v

The kernel (``csrc/attention.cu``) computes what the TPU kernel computes:
q scaled in float32, the scores, the softmax and the PV sum in float32,
one rounding to q's dtype at the output; Tq may differ from Tk. It streams
K and V through shared memory in tiles with an online softmax, so no
T x T buffer exists; one launch covers every (batch, head). In bf16 the
products run on the tensor cores, and the softmax weights are rounded to
bf16 before the PV product (as FlashAttention does); in float32 they run
as FMA.

The kernel reads q, k and v through their strides (the head dim must be
contiguous), so MS-TCT passes its (B, T, H, D) projections as (B, H, T, D)
views without copies, and the kernel writes its (B, H, Tq, D) output into
(B, Tq, H, D) memory, so that the merge of the heads back to
(B, Tq, H * D) is a view.

``multi_head_attention`` dispatches on the device: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel, anything else raises.
Its backward differentiates the plain version, as the JAX ``_mha_bwd``
does (``ops/attention.py:475-480`` there).
"""

from __future__ import annotations

import ctypes
import functools

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_D_MAX = 128  # head dims up to 128 (MS-TCT's largest is 108)


def attention_reference(q, k, v):
    """Plain PyTorch version; mirrors the JAX ``attention_reference`` op for
    op in the input dtype: ``q * scale`` and the score product in q's dtype,
    the softmax in float32, the weights cast to v's dtype, the PV product."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q * scale, k)
    p = torch.softmax(s.float(), dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


@functools.cache
def _launch_fn():
    """The C entry point of ``csrc/attention.cu`` (built on first use),
    with its argument types declared."""
    from ._build import load_library

    fn = load_library("attention").attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 12 + [ctypes.c_int, ctypes.c_int,
                                                 ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def vector_bytes(tensors, es: int) -> int:
    """The widest load (16, 8, 4 or 2 bytes) that every row of every tensor
    allows: base addresses and row strides aligned, the row a whole number
    of vectors."""
    for vb in (16, 8, 4):
        n = vb // es
        if n == 0:
            continue
        if all(t.data_ptr() % vb == 0 and t.shape[-1] % n == 0
               and all(s % n == 0 for s in t.stride()[:-1])
               for t in tensors):
            return vb
    return es


def attention_cuda(q, k, v):
    """Launch the CUDA kernel on q's device and current stream.

    q (B, H, Tq, D), k and v (B, H, Tk, D), float32 or bfloat16, one dtype
    on one CUDA device, any strides with the last dim contiguous; D <= 128.
    Returns (B, H, Tq, D) whose memory is (B, Tq, H, D), so
    ``out.transpose(1, 2)`` is contiguous. ``launches`` counts the kernel
    launches made through this wrapper.
    """
    if q.device.type != "cuda":
        raise ValueError(f"attention_cuda needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"attention kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"q, k, v must be (B, H, T, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if tuple(k.shape) != (b, h, tk, d) or tuple(v.shape) != (b, h, tk, d):
        raise ValueError(f"k and v must be (B, H, Tk, D) = {(b, h, tk, d)}, "
                         f"got {tuple(k.shape)}, {tuple(v.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; q is "
                             f"{q.dtype} on {q.device}")
    if not 1 <= d <= _D_MAX or tq < 1 or tk < 1:
        raise ValueError(f"attention kernel needs 1 <= D <= {_D_MAX} and "
                         f"T >= 1, got D={d}, Tq={tq}, Tk={tk}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty(b, tq, h, d, dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    vb = vector_bytes((q, k, v), q.element_size())
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    fn = _launch_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, h, tq, tk, d, *strides, vb, _DTYPE_CODES[q.dtype],
                 stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error "
                           f"{err}")
    attention_cuda.launches += 1
    return out


attention_cuda.launches = 0


def _forward(q, k, v):
    if q.device.type == "cpu":
        return attention_reference(q, k, v)
    if q.device.type == "cuda":
        return attention_cuda(q, k, v)
    raise ValueError(f"multi_head_attention runs on CPU (plain version) or "
                     f"CUDA (kernel) tensors, got {q.device}")


class _MultiHeadAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v)

    @staticmethod
    def backward(ctx, g):
        inputs = [a.detach().requires_grad_() for a in ctx.saved_tensors]
        with torch.enable_grad():
            out = attention_reference(*inputs)
        return torch.autograd.grad(out, inputs, g)


def multi_head_attention(q, k, v):
    """Differentiable attention over (B, H, T, D): kernel forward on CUDA,
    plain forward on CPU, backward through the plain version."""
    return _MultiHeadAttention.apply(q, k, v)
