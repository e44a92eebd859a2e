"""A whole Swin block (K5): hand-written CUDA kernel + plain version.

Counterpart of ``computervision_codes_tpu/ops/swin_block.py``: over x
(B, Hp, Wp, C), rolled by the caller when the block is shifted,

    y = x + proj(window_MHSA(LN1(x)));  out = y + mlp(LN2(y))

with K3's numerics for the attention half and K4's for the MLP half. The
CUDA entry point (``csrc/swin_block.cu``) runs both halves' device phases
from one call, with y in a device scratch; its plain version is the chain
of theirs, which is what the JAX ``swin_block_reference`` is.

``swin_block_fused`` dispatches on the tensor's device: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel, anything else raises.
The int8 branch (``quant=True`` there) belongs to the int8 teacher and is
not ported yet.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .mlp_block import (C_MULTIPLE, DTYPE_CODES, check_operands,
                        launch_checked, mlp_block_reference)
from .window_mhsa import HEAD_DIM, attention_operands, window_mhsa_reference


def swin_block_reference(x, g1, be1, wqkv, bqkv, wproj, bproj, bias, mask,
                         g2, be2, w1, b1, w2, b2, *, window: int,
                         num_heads: int):
    """Plain PyTorch version: the two halves' plain versions chained."""
    y = window_mhsa_reference(x, g1, be1, wqkv, bqkv, wproj, bproj, bias,
                              mask, window=window, num_heads=num_heads)
    return mlp_block_reference(y, g2, be2, w1, b1, w2, b2)


@functools.cache
def _launch_fn():
    """The C entry point of ``csrc/swin_block.cu`` (built on first use),
    with its argument types declared."""
    from ._build import load_library

    fn = load_library("swin_block").swin_block_launch
    fn.argtypes = ([ctypes.c_void_p] * 21 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def swin_block_cuda(x, g1, be1, wqkv, bqkv, wproj, bproj, bias, mask, g2,
                    be2, w1, b1, w2, b2, *, window: int, num_heads: int):
    """Launch K5 on x's device and current stream. Takes what
    ``window_mhsa_cuda`` and ``mlp_block_cuda`` take together.
    ``launches`` counts the kernel launches made through this wrapper."""
    (x, wqkv, bqkv, wproj, bproj, bias), mask, (g1, be1) = \
        attention_operands("swin_block", x, g1, be1, wqkv, bqkv, wproj,
                           bproj, bias, mask, window, num_heads)
    b, hp, wp, c = x.shape
    hidden = w1.shape[-1]
    (w1, b1, w2, b2), (g2, be2) = check_operands(
        "swin_block", x,
        {"w1": (w1, (c, hidden)), "b1": (b1, (hidden,)),
         "w2": (w2, (hidden, c)), "b2": (b2, (c,))},
        {"g2": (g2, (c,)), "be2": (be2, (c,))})
    if hidden % C_MULTIPLE:
        raise ValueError(f"swin_block kernel needs hidden % {C_MULTIPLE} == "
                         f"0, got {hidden}")
    m = b * hp * wp
    out = torch.empty_like(x)
    if m == 0:
        return out
    new = functools.partial(torch.empty, dtype=x.dtype, device=x.device)
    qkv, attn, ybuf, h = new(m, 3 * c), new(m, c), new(m, c), new(m, hidden)
    stats = torch.empty(m, 2, dtype=torch.float32, device=x.device)
    launch_checked("swin_block", _launch_fn(), x, g1, be1, wqkv, bqkv, wproj,
                   bproj, bias, mask, g2, be2, w1, b1, w2, b2, qkv, attn,
                   ybuf, h, stats, out, b, hp, wp, c, num_heads, window,
                   hidden, HEAD_DIM ** -0.5, DTYPE_CODES[x.dtype])
    swin_block_cuda.launches += 1
    return out


swin_block_cuda.launches = 0


def swin_block_fused(x, g1, be1, wqkv, bqkv, wproj, bproj, bias, mask, g2,
                     be2, w1, b1, w2, b2, *, window: int, num_heads: int):
    """K5 on CUDA tensors, its plain version on CPU tensors."""
    args = (x, g1, be1, wqkv, bqkv, wproj, bproj, bias, mask, g2, be2, w1,
            b1, w2, b2)
    if x.device.type == "cpu":
        return swin_block_reference(*args, window=window,
                                    num_heads=num_heads)
    if x.device.type == "cuda":
        return swin_block_cuda(*args, window=window, num_heads=num_heads)
    raise ValueError(f"swin_block_fused runs on CPU (plain version) or CUDA "
                     f"(kernel) tensors, got {x.device}")
