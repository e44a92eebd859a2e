"""A whole Swin block (K5): hand-written CUDA kernel + plain version.

Counterpart of ``computervision_codes_tpu/ops/swin_block.py``: over x
(B, Hp, Wp, C), rolled by the caller when the block is shifted,

    y = x + proj(window_MHSA(LN1(x)));  out = y + mlp(LN2(y))

with K3's numerics for the attention half and K4's for the MLP half. The
CUDA entry point (``csrc/swin_block.cu``) runs both halves' device phases
from one call (the four products on the Swin GEMM core,
``ops/swin_gemm.py``), with y in a device scratch; its plain version is
the chain of theirs, which is what the JAX ``swin_block_reference`` is, but
for the last rounding below.

The merged TPU kernel rounds ``o + b2`` to x's dtype before it adds y
(``swin_block.py:121-124`` there, one hidden chunk, as at every native
width), where K4 sums them in float32 and rounds once; both the plain
version and the CUDA kernel here round as the merged kernel does.

The int8 branch (``quant=True``, ``swin_block.py:76-128`` there; the four
weights as ``Q8Weight``s) is K3's then K4's int8 branch with the merged
kernel's numerics: LN1(x) and LN2(y) are rounded to x's dtype before they
are quantized, and the QKV product and both MLP products take one
activation scale per window-row strip (w x Wp tokens). The TPU kernel's
MLP scales are per hidden chunk, which differs only when its VMEM model
(``swin_block.py:155-163``) picks a chunk below the hidden width; at the
native sizes it does not (about 7 MB at stage 0 and 10 MB at stage 1
against its 13 MB), so the chunk loop is not ported.

``swin_block_fused`` dispatches on the tensor's device: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel, anything else raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import swin_gemm
from .mlp_block import (C_MULTIPLE, DTYPE_CODES, Q8Weight, check_operands,
                        check_q8, launch_checked, mlp_block_reference,
                        mlp_products, mlp_q8_reference)
from .window_attention import count_phase
from .window_mhsa import (HEAD_DIM, attention_operands, attn_products,
                          window_mhsa_q8_reference, window_mhsa_reference)


def swin_block_reference(x, g1, be1, wqkv, bqkv, wproj, bproj, bias, mask,
                         g2, be2, w1, b1, w2, b2, *, window: int,
                         num_heads: int, quant: bool = False):
    """Plain PyTorch version: the two halves' plain versions chained, with
    the merged block's own rounding points (``swin_block.py:105-124``
    there): ``o + b2`` rounded before the residual, and in the int8 branch
    LN1(x) and LN2(y) rounded to x's dtype before they are quantized and
    one activation scale per window-row strip for both MLP products."""
    if quant:
        y = window_mhsa_q8_reference(x, g1, be1, wqkv, bqkv, wproj, bproj,
                                     bias, mask, window=window,
                                     num_heads=num_heads, ln_round=True)
        strip = window * x.shape[2]
        return mlp_q8_reference(y, g2, be2, w1, b1, w2, b2, strip,
                                ln_round=True)
    y = window_mhsa_reference(x, g1, be1, wqkv, bqkv, wproj, bproj, bias,
                              mask, window=window, num_heads=num_heads)
    return mlp_block_reference(y, g2, be2, w1, b1, w2, b2, res_round=True)


@functools.cache
def _launch_fn(loop: bool = False):
    """The C entry point of ``csrc/swin_block.cu`` (built on first use),
    with its argument types declared; ``loop``: its ``_loop`` twin."""
    from ._build import load_library

    lib = load_library("swin_block")
    fn = lib.swin_block_loop_launch if loop else lib.swin_block_launch
    fn.argtypes = ([ctypes.c_void_p] * 21 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def block_products(c: int, hidden: int) -> list:
    """(K, N) of a block's four products: QKV, proj, fc1, fc2."""
    return attn_products(c) + mlp_products(c, hidden)


def launch_swin_block(x, g1, be1, wqkv, bqkv, wproj, bproj, bias, mask, g2,
                      be2, w1, b1, w2, b2, *, window: int, num_heads: int,
                      counter, loop: bool = False):
    """Launch K5's float path (``loop``: every product on the loop) on x's
    device and current stream; add one to ``counter.launches`` and the four
    products to ``swin_gemm.launches``. In bf16 the attn scratch holds
    LN1(x), the attention output, then LN2(y)."""
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
    launch_checked("swin_block", _launch_fn(loop), x, g1, be1, wqkv, bqkv,
                   wproj, bproj, bias, mask, g2, be2, w1, b1, w2, b2, qkv,
                   attn, ybuf, h, stats, out, b, hp, wp, c, num_heads, window,
                   hidden, HEAD_DIM ** -0.5, DTYPE_CODES[x.dtype])
    counter.launches += 1
    count_phase("swin_block")
    swin_gemm.count("swin_block", swin_gemm.operand_kind(x.dtype),
                    block_products(c, hidden), loop)
    return out


def swin_block_cuda(x, g1, be1, wqkv, bqkv, wproj, bproj, bias, mask, g2,
                    be2, w1, b1, w2, b2, *, window: int, num_heads: int):
    """Launch K5 on x's device and current stream. Takes what
    ``window_mhsa_cuda`` and ``mlp_block_cuda`` take together.
    ``launches`` counts the kernel launches made through this wrapper."""
    return launch_swin_block(x, g1, be1, wqkv, bqkv, wproj, bproj, bias,
                             mask, g2, be2, w1, b1, w2, b2, window=window,
                             num_heads=num_heads, counter=swin_block_cuda)


swin_block_cuda.launches = 0


def swin_block_loop_cuda(x, g1, be1, wqkv, bqkv, wproj, bproj, bias, mask,
                         g2, be2, w1, b1, w2, b2, *, window: int,
                         num_heads: int):
    """K5 with every product on the loop: the parent that
    ``chip_smoke.py`` compares against."""
    return launch_swin_block(x, g1, be1, wqkv, bqkv, wproj, bproj, bias,
                             mask, g2, be2, w1, b1, w2, b2, window=window,
                             num_heads=num_heads,
                             counter=swin_block_loop_cuda, loop=True)


swin_block_loop_cuda.launches = 0


@functools.cache
def _launch_q8_fn(loop: bool = False):
    """The int8 branch's C entry point in ``csrc/swin_block.cu`` (``loop``:
    its ``_loop`` twin)."""
    from ._build import load_library

    lib = load_library("swin_block")
    fn = lib.swin_block_q8_loop_launch if loop else lib.swin_block_q8_launch
    fn.argtypes = ([ctypes.c_void_p] * 27 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def launch_swin_block_q8(x, g1, be1, wqkv: Q8Weight, bqkv, wproj: Q8Weight,
                         bproj, bias, mask, g2, be2, w1: Q8Weight, b1,
                         w2: Q8Weight, b2, *, window: int, num_heads: int,
                         counter, loop: bool = False):
    """Launch K5's int8 branch (``loop``: on the ``mma.sync`` loop); add one
    to ``counter.launches`` and the four products to
    ``swin_gemm.launches``. The A codes scratch is (M, max(C, hidden))
    int8, shared by the four products in turn."""
    mats, mask, (g1, be1) = attention_operands(
        "swin_block", x, g1, be1, wqkv, bqkv, wproj, bproj, bias, mask,
        window, num_heads, quant=True)
    x, wq, sq, bqkv, wpc, sp, bproj, bias = mats
    b, hp, wp, c = x.shape
    hidden = w1.codes.shape[0]
    (b1, b2), (g2, be2) = check_operands(
        "swin_block", x, {"b1": (b1, (hidden,)), "b2": (b2, (c,))},
        {"g2": (g2, (c,)), "be2": (be2, (c,))})
    w1c, s1, w2c, s2 = check_q8("swin_block", x, {"w1": (w1, (hidden, c)),
                                                  "w2": (w2, (c, hidden))})
    if hidden % C_MULTIPLE:
        raise ValueError(f"swin_block kernel needs hidden % {C_MULTIPLE} == "
                         f"0, got {hidden}")
    m = b * hp * wp
    out = torch.empty_like(x)
    if m == 0:
        return out
    new = functools.partial(torch.empty, dtype=x.dtype, device=x.device)
    qkv, attn, ybuf = new(m, 3 * c), new(m, c), new(m, c)
    h = torch.empty(m, hidden, dtype=torch.float32, device=x.device)
    stats = torch.empty(m, 2, dtype=torch.float32, device=x.device)
    strips = b * (hp // window)
    amax = torch.empty(strips * (3 + wp // window), dtype=torch.int32,
                       device=x.device)
    codes = torch.empty(m, max(c, hidden), dtype=torch.int8, device=x.device)
    launch_checked("swin_block", _launch_q8_fn(loop), x, g1, be1, wq, sq,
                   bqkv, wpc, sp, bproj, bias, mask, g2, be2, w1c, s1, b1,
                   w2c, s2, b2, qkv, attn, ybuf, h, stats, amax, codes, out,
                   b, hp, wp, c, num_heads, window, hidden, HEAD_DIM ** -0.5,
                   DTYPE_CODES[x.dtype])
    counter.launches += 1
    count_phase("swin_block")
    swin_gemm.count("swin_block", "int8", block_products(c, hidden), loop)
    return out


def swin_block_q8_cuda(x, g1, be1, wqkv: Q8Weight, bqkv, wproj: Q8Weight,
                       bproj, bias, mask, g2, be2, w1: Q8Weight, b1,
                       w2: Q8Weight, b2, *, window: int, num_heads: int):
    """Launch K5's int8 branch on x's device and current stream: as
    ``swin_block_cuda``, with the four weights as ``Q8Weight``s.
    ``launches`` counts the launches made through this wrapper."""
    return launch_swin_block_q8(x, g1, be1, wqkv, bqkv, wproj, bproj, bias,
                                mask, g2, be2, w1, b1, w2, b2, window=window,
                                num_heads=num_heads,
                                counter=swin_block_q8_cuda)


swin_block_q8_cuda.launches = 0


def swin_block_q8_loop_cuda(x, g1, be1, wqkv: Q8Weight, bqkv,
                            wproj: Q8Weight, bproj, bias, mask, g2, be2,
                            w1: Q8Weight, b1, w2: Q8Weight, b2, *,
                            window: int, num_heads: int):
    """K5's int8 branch on the ``mma.sync`` loop: the parent."""
    return launch_swin_block_q8(x, g1, be1, wqkv, bqkv, wproj, bproj, bias,
                                mask, g2, be2, w1, b1, w2, b2, window=window,
                                num_heads=num_heads,
                                counter=swin_block_q8_loop_cuda, loop=True)


swin_block_q8_loop_cuda.launches = 0


def swin_block_fused(x, g1, be1, wqkv, bqkv, wproj, bproj, bias, mask, g2,
                     be2, w1, b1, w2, b2, *, window: int, num_heads: int,
                     quant: bool = False):
    """K5 on CUDA tensors, its plain version on CPU tensors. ``quant``: the
    int8 branch, the four weights as ``Q8Weight``s."""
    args = (x, g1, be1, wqkv, bqkv, wproj, bproj, bias, mask, g2, be2, w1,
            b1, w2, b2)
    if x.device.type == "cpu":
        return swin_block_reference(*args, window=window,
                                    num_heads=num_heads, quant=quant)
    if x.device.type == "cuda":
        fn = swin_block_q8_cuda if quant else swin_block_cuda
        return fn(*args, window=window, num_heads=num_heads)
    raise ValueError(f"swin_block_fused runs on CPU (plain version) or CUDA "
                     f"(kernel) tensors, got {x.device}")
