"""Fused dilated residual TCN layer: hand-written CUDA kernel + plain version.

Counterpart of ``computervision_codes_tpu/ops/dilated_conv.py``. One layer
over x (B, T, C) is

    y = x + relu(conv3_dilated(x; w_taps) + b1) @ w2 + b2

with ``w_taps`` (3, C, C) = [left, centre, right] in the JAX layout. The
kernel (``csrc/dilated_residual.cu``) fuses the three taps, bias, relu, the
1x1 projection and the residual into one pass, accumulating in float32.

``dilated_residual_fused`` dispatches on the tensor's device: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel, anything else
raises. Its backward differentiates the plain version, as the JAX
``custom_vjp`` does (``ops/dilated_conv.py:127-150`` there).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_C_MULTIPLE, _C_MAX = 128, 1024


def dilated_residual_reference(x, w_taps, b1, w2, b2, dilation: int,
                               causal: bool = False):
    """Plain PyTorch version; mirrors the JAX ``dilated_residual_reference``.

    ``causal``: taps at (t-2d, t-d, t), front-padded with 2d zeros;
    otherwise (t-d, t, t+d) with d zeros on each side. Every op runs in x's
    dtype.
    """
    d = dilation
    t = x.shape[1]
    pad = (2 * d, 0) if causal else (d, d)
    xp = F.pad(x, (0, 0) + pad)  # pads dim 1 (time)
    h = (xp[:, :t] @ w_taps[0] + xp[:, d:d + t] @ w_taps[1]
         + xp[:, 2 * d:2 * d + t] @ w_taps[2] + b1)
    return x + torch.relu(h) @ w2 + b2


@functools.cache
def _launch_fn():
    """The C entry point of ``csrc/dilated_residual.cu`` (built on first
    use), with its argument types declared."""
    from ._build import load_library

    fn = load_library("dilated_residual").dilated_residual_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def dilated_residual_cuda(x, w_taps, b1, w2, b2, dilation: int,
                          causal: bool = False):
    """Launch the CUDA kernel on x's device and current stream.

    Takes float32 or bfloat16, all six tensors in one dtype on one CUDA
    device, with C % 128 == 0 and C <= 1024. ``launches`` counts the
    kernel launches made through this wrapper.
    """
    if x.device.type != "cuda":
        raise ValueError(f"dilated_residual_cuda needs CUDA tensors, got "
                         f"{x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"dilated_residual kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if x.ndim != 3:
        raise ValueError(f"x must be (B, T, C), got {tuple(x.shape)}")
    b, t, c = x.shape
    want = {"w_taps": (3, c, c), "b1": (c,), "w2": (c, c), "b2": (c,)}
    for name, arr in zip(want, (w_taps, b1, w2, b2)):
        if tuple(arr.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(arr.shape)}")
        if arr.dtype != x.dtype or arr.device != x.device:
            raise ValueError(f"{name} is {arr.dtype} on {arr.device}; x is "
                             f"{x.dtype} on {x.device}")
    if c % _C_MULTIPLE or c > _C_MAX:
        raise ValueError(f"dilated_residual kernel needs C % {_C_MULTIPLE} "
                         f"== 0 and C <= {_C_MAX}, got C={c}")
    if dilation < 0:
        raise ValueError(f"dilation must be >= 0, got {dilation}")
    # contiguous, and 16-byte aligned: the kernel moves 16-byte vectors (a
    # fresh allocation is aligned; a view at an odd offset is copied)
    x, w_taps, b1, w2, b2 = (
        a if a.is_contiguous() and a.data_ptr() % 16 == 0
        else a.clone(memory_format=torch.contiguous_format)
        for a in (x, w_taps, b1, w2, b2))
    y = torch.empty_like(x)
    fn = _launch_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w_taps.data_ptr(), b1.data_ptr(),
                 w2.data_ptr(), b2.data_ptr(), y.data_ptr(), b, t, c,
                 dilation, int(causal), _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"dilated_residual kernel launch failed: CUDA "
                           f"error {err}")
    dilated_residual_cuda.launches += 1
    return y


dilated_residual_cuda.launches = 0


def _forward(x, w_taps, b1, w2, b2, dilation, causal):
    if x.device.type == "cpu":
        return dilated_residual_reference(x, w_taps, b1, w2, b2, dilation,
                                          causal)
    if x.device.type == "cuda":
        return dilated_residual_cuda(x, w_taps, b1, w2, b2, dilation, causal)
    raise ValueError(f"dilated_residual_fused runs on CPU (plain version) or "
                     f"CUDA (kernel) tensors, got {x.device}")


class _DilatedResidual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_taps, b1, w2, b2, dilation, causal):
        ctx.save_for_backward(x, w_taps, b1, w2, b2)
        ctx.dilation, ctx.causal = dilation, causal
        return _forward(x, w_taps, b1, w2, b2, dilation, causal)

    @staticmethod
    def backward(ctx, g):
        inputs = [a.detach().requires_grad_() for a in ctx.saved_tensors]
        with torch.enable_grad():
            y = dilated_residual_reference(*inputs, ctx.dilation, ctx.causal)
        grads = torch.autograd.grad(y, inputs, g)
        return (*grads, None, None)


def dilated_residual_fused(x, w_taps, b1, w2, b2, dilation: int,
                           causal: bool = False):
    """Differentiable fused layer: kernel forward on CUDA, plain forward on
    CPU, backward through the plain version."""
    return _DilatedResidual.apply(x, w_taps, b1, w2, b2, dilation, causal)
