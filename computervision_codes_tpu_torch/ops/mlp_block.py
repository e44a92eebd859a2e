"""Transformer MLP half-block (K4): hand-written CUDA kernel + plain version.

Counterpart of ``computervision_codes_tpu/ops/mlp_block.py``. Over tokens
x (..., C),

    y = x + gelu(LN(x) @ w1 + b1) @ w2 + b2       (exact, erf GELU)

with the numerics of the TPU kernel's float path: LayerNorm in float32
(eps 1e-5) rounded to x's dtype, products accumulated in float32, the GELU
output rounded to x's dtype, and the second product, its bias and the
residual summed in float32 and rounded once (the hidden-chunked path,
``mlp_block.py:120-133`` there). ``gamma``/``beta`` may be float32 while x
is bf16, as the Swin modules pass them.

``mlp_block_fused`` dispatches on the tensor's device: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel (``csrc/mlp_block.cu``),
anything else raises. The int8 branch (``quant=True`` there) belongs to the
int8 teacher and is not ported yet.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
C_MULTIPLE = 64  # the kernels' GEMM tiles: C and the hidden width % 64


def layer_norm_f32(x, gamma, beta, eps: float = 1e-5):
    """LayerNorm over the last axis in float32, rounded to x's dtype: the
    operand the TPU kernels feed their matrix unit."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    normed = (xf - mu) * torch.rsqrt(var + eps)
    return (normed * gamma.float() + beta.float()).to(x.dtype)


def mm_f32(a, b):
    """a @ b with float32 accumulation of operands held in their dtype
    (products of bf16 values are exact in float32)."""
    return torch.matmul(a.float(), b.float())


def mlp_block_reference(x, gamma, beta, w1, b1, w2, b2):
    """Plain PyTorch version, with the kernel's rounding points; mirrors the
    JAX ``mlp_block_reference``."""
    normed = layer_norm_f32(x, gamma, beta)
    h = F.gelu(mm_f32(normed, w1) + b1.float()).to(x.dtype)  # erf
    return (x.float() + (mm_f32(h, w2) + b2.float())).to(x.dtype)


def aligned(*tensors):
    """Contiguous, 16-byte aligned tensors: the kernels move 16-byte vectors
    (a fresh allocation is aligned; a view at an odd offset is copied)."""
    return [a if a.is_contiguous() and a.data_ptr() % 16 == 0
            else a.clone(memory_format=torch.contiguous_format)
            for a in tensors]


def check_operands(what: str, x, named: dict, vectors: dict):
    """Device, dtype and shape checks shared by the Swin kernel wrappers.
    ``named``: name -> (tensor, shape) held in x's dtype; ``vectors``:
    LayerNorm parameters, any float dtype (passed on as float32). Returns
    the aligned matrices and the float32 vectors, in the given order."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{what} kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    for name, (arr, shape) in {**named, **vectors}.items():
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} must be {tuple(shape)}, got "
                             f"{tuple(arr.shape)}")
        if arr.device != x.device:
            raise ValueError(f"{what}: {name} is on {arr.device}; x is on "
                             f"{x.device}")
    for name, (arr, _) in named.items():
        if arr.dtype != x.dtype:
            raise ValueError(f"{what}: {name} is {arr.dtype}; x is {x.dtype}")
    mats = aligned(*(a for a, _ in named.values()))
    vecs = [a.float().contiguous() for a, _ in vectors.values()]
    return mats, vecs


def launch_checked(what: str, fn, *args) -> None:
    """Call a C entry point on the current stream of the first tensor's
    device; raise on the CUDA error it returns."""
    dev = next(a for a in args if isinstance(a, torch.Tensor)).device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]
        err = fn(*conv, stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


@functools.cache
def _launch_fn():
    """The C entry point of ``csrc/mlp_block.cu`` (built on first use),
    with its argument types declared."""
    from ._build import load_library

    fn = load_library("mlp_block").mlp_block_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def mlp_block_cuda(x, gamma, beta, w1, b1, w2, b2):
    """Launch K4 on x's device and current stream.

    x (..., C) float32 or bfloat16 with C % 64 == 0; w1 (C, hidden), b1,
    w2 (hidden, C), b2 in x's dtype, hidden % 64 == 0; gamma, beta (C,) in
    any float dtype. ``launches`` counts the kernel launches made through
    this wrapper.
    """
    c = x.shape[-1]
    hidden = w1.shape[-1]
    (xm, w1, b1, w2, b2), (gamma, beta) = check_operands(
        "mlp_block", x,
        {"x": (x, x.shape), "w1": (w1, (c, hidden)), "b1": (b1, (hidden,)),
         "w2": (w2, (hidden, c)), "b2": (b2, (c,))},
        {"gamma": (gamma, (c,)), "beta": (beta, (c,))})
    if c % C_MULTIPLE or hidden % C_MULTIPLE:
        raise ValueError(f"mlp_block kernel needs C and hidden % "
                         f"{C_MULTIPLE} == 0, got C={c}, hidden={hidden}")
    m = xm.numel() // c
    y = torch.empty_like(xm)
    if m == 0:
        return y
    h = torch.empty(m, hidden, dtype=x.dtype, device=x.device)
    stats = torch.empty(m, 2, dtype=torch.float32, device=x.device)
    launch_checked("mlp_block", _launch_fn(), xm, gamma, beta, w1, b1, w2,
                   b2, h, stats, y, m, c, hidden, DTYPE_CODES[x.dtype])
    mlp_block_cuda.launches += 1
    return y


mlp_block_cuda.launches = 0


def mlp_block_fused(x, gamma, beta, w1, b1, w2, b2):
    """K4 on CUDA tensors, its plain version on CPU tensors."""
    if x.device.type == "cpu":
        return mlp_block_reference(x, gamma, beta, w1, b1, w2, b2)
    if x.device.type == "cuda":
        return mlp_block_cuda(x, gamma, beta, w1, b1, w2, b2)
    raise ValueError(f"mlp_block_fused runs on CPU (plain version) or CUDA "
                     f"(kernel) tensors, got {x.device}")
