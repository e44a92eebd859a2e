"""Fused scale-bias-activation (K9): hand-written CUDA kernel + plain version,
and TResNet's two fixed-filter helpers.

Counterpart of ``computervision_codes_tpu/ops/fused_norm.py``:

* ``fused_scale_bias_act(x, scale, bias, negative_slope)`` over (..., C):
  ``leaky_relu(x * scale + bias)`` per channel, the eval form of TResNet's
  InPlaceABN with the BatchNorm constants folded in. The TPU kernel (and
  the CUDA one, ``csrc/fused_norm.cu``) casts scale and bias to x's dtype,
  then computes the affine and the comparison in float32 and rounds once to
  x's dtype. The plain version is the JAX ``*_reference``: every op in x's
  dtype. It dispatches on the tensor's device: a CPU tensor takes the plain
  version, a CUDA tensor launches the kernel, anything else raises.
* ``space_to_depth`` (the 4x4 pixel-unshuffle stem) and ``blur_pool`` (the
  anti-aliased stride-2 downsample: reflect padding, then the fixed
  [1, 2, 1] x [1, 2, 1] / 16 depthwise filter). Both are XLA ops in the JAX
  package, so here they are plain torch. Both take and return NHWC, as
  there.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from .attention import vector_bytes

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# one thread per vector of a row, whole rows per block: at most 1024
# vectors (threads) in a row
_MAX_ROW_VECTORS = 1024


def fused_scale_bias_act_reference(x, scale, bias,
                                   negative_slope: float = 0.01):
    """Plain PyTorch version; mirrors the JAX reference op for op in the
    dtype the operands promote to (x's, when scale and bias are in it)."""
    y = x * scale + bias
    return torch.where(y >= 0, y, y * negative_slope)


@functools.cache
def _launch_fn():
    """The C entry point of ``csrc/fused_norm.cu`` (built on first use),
    with its argument types declared."""
    from ._build import load_library

    fn = load_library("fused_norm").fused_scale_bias_act_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int,
                                           ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def fused_scale_bias_act_cuda(x, scale, bias, negative_slope: float = 0.01):
    """Launch the CUDA kernel on x's device and current stream.

    x (..., C) float32 or bfloat16, dense with the channel axis innermost
    (a ``channels_last`` NCHW tensor viewed as NHWC is); other strides raise
    ``ValueError`` (no copy is made). scale and bias (C,), cast to x's dtype
    here, as the TPU kernel's caller does. Returns a tensor with x's shape
    and strides. ``launches`` counts the kernel launches made through this
    wrapper.
    """
    if x.device.type != "cuda":
        raise ValueError(f"fused_scale_bias_act_cuda needs CUDA tensors, got "
                         f"{x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_scale_bias_act kernel takes float32 or "
                        f"bfloat16, got {x.dtype}")
    if x.ndim < 1:
        raise ValueError("x must have a channel axis")
    c = x.shape[-1]
    for name, t in (("scale", scale), ("bias", bias)):
        if tuple(t.shape) != (c,):
            raise ValueError(f"{name} must be ({c},), got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}; x is on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"fused_scale_bias_act kernel reads (..., C) rows in "
                         f"memory order; x {tuple(x.shape)} has strides "
                         f"{x.stride()}")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    # elements per load: the widest that x's base address and C allow
    v = vector_bytes((x,), x.element_size()) // x.element_size()
    if c // v > _MAX_ROW_VECTORS:
        raise ValueError(f"fused_scale_bias_act kernel takes at most "
                         f"{_MAX_ROW_VECTORS} loads of {v} per row, got "
                         f"C={c}")
    scale = scale.to(x.dtype).contiguous()
    bias = bias.to(x.dtype).contiguous()
    fn = _launch_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                 y.data_ptr(), x.numel() // c, c, v, float(negative_slope),
                 _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"fused_scale_bias_act kernel launch failed: CUDA "
                           f"error {err}")
    fused_scale_bias_act_cuda.launches += 1
    return y


fused_scale_bias_act_cuda.launches = 0


def fused_scale_bias_act(x, scale, bias, negative_slope: float = 0.01):
    """``leaky_relu(x * scale + bias)`` over (..., C): the kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return fused_scale_bias_act_reference(x, scale, bias, negative_slope)
    if x.device.type == "cuda":
        return fused_scale_bias_act_cuda(x, scale, bias, negative_slope)
    raise ValueError(f"fused_scale_bias_act runs on CPU (plain version) or "
                     f"CUDA (kernel) tensors, got {x.device}")


def space_to_depth(x: torch.Tensor, block: int = 4) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/b, W/b, C*b*b) pixel unshuffle, channels
    ordered (row in block, column in block, c)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // block, w // block, c * block * block)


_BLUR = (np.array([1.0, 2.0, 1.0])[:, None]
         * np.array([1.0, 2.0, 1.0])[None, :]) / 16.0


def blur_pool(x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """(B, H, W, C) -> (B, H', W', C): reflect-pad by one, then the 3x3
    binomial filter per channel at ``stride``, in x's dtype. The result is
    an NHWC view of an NCHW tensor in whatever memory format the
    convolution chose."""
    c = x.shape[-1]
    kern = torch.as_tensor(_BLUR, dtype=x.dtype, device=x.device)
    kern = kern.expand(c, 1, 3, 3)
    xc = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    return F.conv2d(xc, kern, stride=stride, groups=c).permute(0, 2, 3, 1)
