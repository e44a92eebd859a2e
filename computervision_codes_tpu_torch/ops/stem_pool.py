"""Fused ResNet stem: hand-written CUDA kernel + plain version.

Counterpart of ``computervision_codes_tpu/ops/stem_pool.py``. Over NHWC
frames x (N, H, W, 3), with H and W divisible by 4,

    y = maxpool3x3/s2/p1(relu(conv7x7/s2/p3(x; w) + bias))

where ``w`` (7, 7, 3, 64) HWIO is the stem kernel with BatchNorm already
folded in and ``bias`` (64,) the folded float32 bias. The convolution
accumulates in float32; bias and ReLU are applied in float32 and the result
is rounded to x's dtype before the max-pool, as the JAX kernel does. The
kernel (``csrc/stem_pool.cu``) keeps the (H/2, W/2, 64) conv output in
shared memory and writes only the pooled (H/4, W/4, 64) map.

``stem_pool_fused`` dispatches on the tensor's device: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel, anything else raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
OUT_CHANNELS = 64


def _check_geometry(x: torch.Tensor) -> None:
    if x.ndim != 4 or x.shape[-1] != 3:
        raise ValueError(f"x must be (N, H, W, 3), got {tuple(x.shape)}")
    h, w = x.shape[1], x.shape[2]
    if h % 4 or w % 4:
        raise ValueError(f"fused stem needs H, W divisible by 4, got "
                         f"{(h, w)}")


def stem_pool_reference(x, w, bias):
    """Plain PyTorch version; mirrors the JAX ``stem_pool_reference``.

    The convolution runs in float32 on x and w as given in x's dtype (a
    bf16 product is exact in float32), plus the float32 bias, then ReLU,
    rounding to x's dtype and a 3x3/s2 max-pool padded with -inf.
    """
    _check_geometry(x)
    xc = x.permute(0, 3, 1, 2).float()
    wc = w.to(x.dtype).permute(3, 2, 0, 1).float()
    # the bias is added to the finished float32 sum, as in the kernel
    y = F.conv2d(xc, wc, None, stride=2, padding=3)
    y = torch.relu(y + bias.float().view(1, -1, 1, 1)).to(x.dtype)
    return F.max_pool2d(y, 3, 2, 1).permute(0, 2, 3, 1).contiguous()


@functools.cache
def _launch_fn():
    """The C entry point of ``csrc/stem_pool.cu`` (built on first use),
    with its argument types declared."""
    from ._build import load_library

    fn = load_library("stem_pool").stem_pool_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def stem_pool_cuda(x, w, bias):
    """Launch the CUDA kernel on x's device and current stream.

    x (N, H, W, 3) float32 or bfloat16 with H, W % 4 == 0; w (7, 7, 3, 64)
    (cast to x's dtype here); bias (64,) (float32). ``launches`` counts the
    kernel launches made through this wrapper.
    """
    if x.device.type != "cuda":
        raise ValueError(f"stem_pool_cuda needs CUDA tensors, got "
                         f"{x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"stem_pool kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    _check_geometry(x)
    if tuple(w.shape) != (7, 7, 3, OUT_CHANNELS):
        raise ValueError(f"w must be (7, 7, 3, {OUT_CHANNELS}), got "
                         f"{tuple(w.shape)}")
    if tuple(bias.shape) != (OUT_CHANNELS,):
        raise ValueError(f"bias must be ({OUT_CHANNELS},), got "
                         f"{tuple(bias.shape)}")
    if w.device != x.device or bias.device != x.device:
        raise ValueError(f"w on {w.device} and bias on {bias.device}; x is "
                         f"on {x.device}")
    n, h, wd, _ = x.shape
    x = x.contiguous()
    w = w.to(x.dtype).contiguous()
    bias = bias.float().contiguous()
    y = torch.empty(n, h // 4, wd // 4, OUT_CHANNELS, dtype=x.dtype,
                    device=x.device)
    if n == 0:
        return y
    fn = _launch_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), bias.data_ptr(), y.data_ptr(),
                 n, h, wd, _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"stem_pool kernel launch failed: CUDA error "
                           f"{err}")
    stem_pool_cuda.launches += 1
    return y


stem_pool_cuda.launches = 0


def stem_pool_fused(x, w, bias):
    """Fused stem: kernel on CUDA tensors, plain version on CPU tensors.
    Raises ``ValueError`` when H or W is not divisible by 4."""
    if x.device.type == "cpu":
        return stem_pool_reference(x, w, bias)
    if x.device.type == "cuda":
        return stem_pool_cuda(x, w, bias)
    raise ValueError(f"stem_pool_fused runs on CPU (plain version) or CUDA "
                     f"(kernel) tensors, got {x.device}")
