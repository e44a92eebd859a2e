"""Full multi-head attention (K7) and flash attention (K8): hand-written
CUDA kernels + plain versions.

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

K8 is the JAX package's streaming training op: ``flash_attention_pallas``
(the forward) and ``flash_attention`` (differentiable; the forward keeps
the float32 row logsumexp, and the backward runs one kernel over query
tiles for dQ and one over key tiles for dK and dV,
``ops/attention.py:102-454`` there). No model calls it, in either package.
The kernels (``csrc/flash_attention.cu``) compute what the TPU kernels
compute, with P and dS rounded to bf16 before their products in bf16 (the
TPU kernels keep them float32). The plain versions,
``flash_attention_reference_fwd`` and ``flash_attention_reference_bwd``,
compute the same formulas over whole matrices in float32; the CPU takes
them. ``block_q`` and ``block_k`` are the TPU kernels' tile sizes: both
entry points accept them and ignore them.
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


# ---------------------------------------------------------------------------
# K8: flash attention


def flash_attention_reference_fwd(q, k, v):
    """Plain version of the TPU forward (``_flash_fwd_kernel``): q, k and v
    in float32, s = (q * D**-0.5) k^T, the softmax and the PV sum in
    float32. Returns (out in q's dtype, lse float32 (B, H, Tq))."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float())
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", torch.exp(s - lse[..., None]),
                       v.float())
    return out.to(q.dtype), lse


def flash_attention_reference_bwd(q, k, v, out, lse, g):
    """Plain version of the TPU backward (``_flash_bwd``'s dvec and the
    formulas of ``_flash_dq_kernel`` and ``_flash_dkv_kernel``) over whole
    matrices in float32: dvec = rowsum(dO * O), P = exp(s - lse), dS = P *
    (dO V^T - dvec) * scale, dQ = dS K, dV = P^T dO, dK = dS^T Q. Returns
    (dq, dk, dv) in q's dtype."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    dvec = (gf * out.float()).sum(-1)
    p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", qf * scale, kf)
                  - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vf)
    ds = p * (dp - dvec[..., None]) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gf)
    return tuple(t.to(q.dtype) for t in (dq, dk, dv))


@functools.cache
def _flash_fns():
    """The C entry points of ``csrc/flash_attention.cu`` (built on first
    use), with their argument types declared."""
    from ._build import load_library

    lib = load_library("flash_attention")
    fwd = lib.flash_attention_fwd_launch
    fwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                    + [ctypes.c_longlong] * 12
                    + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    bwd = lib.flash_attention_bwd_launch
    bwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                    + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 21
                    + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _check_qkv(name, q, k, v, *more):
    """q (B, H, Tq, D), k and v (B, H, Tk, D), ``more`` shaped as q, one
    dtype (float32 or bf16) on one CUDA device; D <= 128. Returns the
    tensors with the head dim contiguous."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {q.dtype}")
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"q and k must be (B, H, T, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    shapes = [(b, h, tk, d)] * 2 + [(b, h, tq, d)] * len(more)
    for arg, t, want in zip(("k", "v", "g"), (k, v) + more, shapes):
        if tuple(t.shape) != want or t.dtype != q.dtype or \
                t.device != q.device:
            raise ValueError(f"{name}: {arg} is {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}, want {want} {q.dtype} on "
                             f"{q.device}")
    if not 1 <= d <= _D_MAX or tq < 1 or tk < 1:
        raise ValueError(f"{name} needs 1 <= D <= {_D_MAX} and T >= 1, got "
                         f"D={d}, Tq={tq}, Tk={tk}")
    return [t if t.stride(-1) == 1 else t.contiguous()
            for t in (q, k, v) + more]


def _strides(*tensors):
    return [s for t in tensors for s in t.stride()[:3]]


def flash_attention_fwd_cuda(q, k, v, with_lse: bool = True):
    """Launch K8's forward on q's device and current stream. q (B, H, Tq,
    D), k and v (B, H, Tk, D), float32 or bfloat16, any strides with the
    head dim contiguous. Returns (out (B, H, Tq, D) contiguous, lse float32
    (B, H, Tq) or None). ``launches`` counts the launches."""
    q, k, v = _check_qkv("flash_attention_fwd_cuda", q, k, v)
    b, h, tq, d = q.shape
    out = torch.empty(b, h, tq, d, dtype=q.dtype, device=q.device)
    lse = (torch.empty(b, h, tq, dtype=torch.float32, device=q.device)
           if with_lse else None)
    fwd, _ = _flash_fns()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  lse.data_ptr() if with_lse else None, b, h, tq,
                  k.shape[2], d, *_strides(q, k, v, out),
                  vector_bytes((q, k, v), q.element_size()),
                  _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash attention forward launch failed: CUDA "
                           f"error {err}")
    flash_attention_fwd_cuda.launches += 1
    return out, lse


def _flash_bwd_launch(kind: int, q, k, v, g, lse, dvec, dq, dk, dv):
    b, h, tq, d = q.shape
    if tuple(lse.shape) != (b, h, tq) or tuple(dvec.shape) != (b, h, tq) or \
            lse.dtype != torch.float32 or dvec.dtype != torch.float32 or \
            not (lse.is_contiguous() and dvec.is_contiguous()):
        raise ValueError(f"lse and dvec must be contiguous float32 "
                         f"{(b, h, tq)}")
    _, bwd = _flash_fns()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = bwd(kind, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  g.data_ptr(), lse.data_ptr(), dvec.data_ptr(),
                  *(t.data_ptr() if t is not None else None
                    for t in (dq, dk, dv)),
                  b, h, tq, k.shape[2], d,
                  *_strides(q, k, v, g),
                  *(s for t in (dq, dk, dv)
                    for s in (t.stride()[:3] if t is not None else (0,) * 3)),
                  vector_bytes((q, k, v, g), q.element_size()),
                  _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        which = "dQ" if kind == 0 else "dK/dV"
        raise RuntimeError(f"flash attention backward launch ({which}) "
                           f"failed: CUDA error {err}")


def flash_attention_dq_cuda(q, k, v, g, lse, dvec):
    """Launch K8's dQ kernel: g (dO) shaped as q, lse and dvec float32
    (B, H, Tq) contiguous. Returns dq (B, H, Tq, D) in q's dtype."""
    q, k, v, g = _check_qkv("flash_attention_dq_cuda", q, k, v, g)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _flash_bwd_launch(0, q, k, v, g, lse, dvec, dq, None, None)
    flash_attention_dq_cuda.launches += 1
    return dq


def flash_attention_dkv_cuda(q, k, v, g, lse, dvec):
    """Launch K8's dK/dV kernel (arguments as ``flash_attention_dq_cuda``).
    Returns (dk, dv), each (B, H, Tk, D) in q's dtype."""
    q, k, v, g = _check_qkv("flash_attention_dkv_cuda", q, k, v, g)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    _flash_bwd_launch(1, q, k, v, g, lse, dvec, None, dk, dv)
    flash_attention_dkv_cuda.launches += 1
    return dk, dv


flash_attention_fwd_cuda.launches = 0
flash_attention_dq_cuda.launches = 0
flash_attention_dkv_cuda.launches = 0


def _flash_device(q) -> str:
    if q.device.type in ("cpu", "cuda"):
        return q.device.type
    raise ValueError(f"flash attention runs on CPU (plain version) or CUDA "
                     f"(kernel) tensors, got {q.device}")


def flash_attention_pallas(q, k, v, block_q: int = 256, block_k: int = 512):
    """Streaming attention over (B, H, T, D), forward only: the plain
    version on the CPU, K8's forward (no lse) on CUDA."""
    if _flash_device(q) == "cpu":
        return flash_attention_reference_fwd(q, k, v)[0]
    return flash_attention_fwd_cuda(q, k, v, with_lse=False)[0]


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        if _flash_device(q) == "cpu":
            out, lse = flash_attention_reference_fwd(q, k, v)
        else:
            out, lse = flash_attention_fwd_cuda(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            return flash_attention_reference_bwd(q, k, v, out, lse, g)
        dvec = (g.float() * out.float()).sum(-1)  # rowsum(dO * O), as JAX
        dq = flash_attention_dq_cuda(q, k, v, g, lse, dvec)
        dk, dv = flash_attention_dkv_cuda(q, k, v, g, lse, dvec)
        return dq, dk, dv


def flash_attention(q, k, v, block_q: int = 256, block_k: int = 512):
    """Differentiable streaming attention over (B, H, T, D): on CUDA K8's
    forward (keeping the lse), then its dQ and dK/dV kernels backward; on
    the CPU the plain versions."""
    return _FlashAttention.apply(q, k, v)
