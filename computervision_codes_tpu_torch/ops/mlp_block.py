"""Transformer MLP half-block (K4): hand-written CUDA kernel + plain version.

Counterpart of ``computervision_codes_tpu/ops/mlp_block.py``. Over tokens
x (..., C),

    y = x + gelu(LN(x) @ w1 + b1) @ w2 + b2       (exact, erf GELU)

(or, with ``res_add=False`` on the float path, the branch alone,
T(gelu(...) @ w2 + b2) rounded once, as K6's training forward runs it), with
the numerics of the TPU kernel's float path: LayerNorm in float32
(eps 1e-5) rounded to x's dtype, products accumulated in float32, the GELU
output rounded to x's dtype, and the second product, its bias and the
residual summed in float32 and rounded once (the hidden-chunked path,
``mlp_block.py:120-133`` there). ``gamma``/``beta`` may be float32 while x
is bf16, as the Swin modules pass them.

The int8 branch (``quant=True``, ``_kernel`` at ``mlp_block.py:85-102``
there, one hidden chunk): both products run as ``q8_dot``, int8 weights
with per-output-channel scales (``q8_weight``, made once by the caller)
times int8 activations with one dynamic absmax scale per token block, the
largest power of two <= 512 that divides the token count
(``mlp_block.py:164-175``). The LayerNorm output and the GELU output stay
float32 (the A-S erf GELU of ``_gelu_exact``, not ``F.gelu``), and
``(o + b2)`` is rounded to x's dtype before the residual is added in x's
dtype.

``mlp_block_fused`` dispatches on the tensor's device: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel (``csrc/mlp_block.cu``;
its two products on the Swin GEMM core, ``ops/swin_gemm.py``), anything
else raises.
"""

from __future__ import annotations

import ctypes
import functools

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import swin_gemm
from .quant import quantize_weight

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the kernels' GEMM tiles: C and the hidden width % 32 on the float paths
# (every Swin width), % 64 on the int8 branch
C_MULTIPLE, Q8_C_MULTIPLE = 32, 64
Q8_BLOCK_TOKENS = 512  # the int8 branch's largest token block


def layer_norm_float32(x, gamma, beta, eps: float = 1e-5):
    """LayerNorm over the last axis, in float32 and left in float32."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    normed = (xf - mu) * torch.rsqrt(var + eps)
    return normed * gamma.float() + beta.float()


def layer_norm_f32(x, gamma, beta, eps: float = 1e-5):
    """LayerNorm over the last axis in float32, rounded to x's dtype: the
    operand the TPU kernels feed their matrix unit."""
    return layer_norm_float32(x, gamma, beta, eps).to(x.dtype)


def gelu_as(x):
    """x Phi(x) with the Abramowitz-Stegun 7.1.26 erf (max error 1.5e-7),
    in the JAX ``_gelu_exact``'s order of operations."""
    z = x * 0.7071067811865476
    s, a = torch.sign(z), z.abs()
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return 0.5 * x * (1.0 + s * (1.0 - poly * torch.exp(-a * a)))


class Q8Weight(NamedTuple):
    """A (k, n) GEMM weight in int8: ``codes`` (n, k), one output channel's
    k run contiguous (the kernels' layout; ``codes.T`` is the JAX
    ``q8_weight`` codes), ``scale`` float32 (1, n)."""

    codes: torch.Tensor
    scale: torch.Tensor


def q8_weight(w) -> Q8Weight:
    """Per-output-channel symmetric int8 of a (k, n) weight, through
    ``ops.quant.quantize_weight`` (the JAX ``q8_weight``)."""
    wq, scale = quantize_weight(w.float(), axis=-1)
    return Q8Weight(wq.t().contiguous(), scale.float().reshape(1, -1))


def block_absmax(x):
    """max |x| over the last two axes, kept as (..., 1, 1)."""
    return x.abs().amax(dim=(-2, -1), keepdim=True)


def q8_dot(x, w: Q8Weight, amax=None):
    """The JAX ``q8_dot`` over blocks: x float32 (..., m, k), one block per
    leading index, quantized with ``amax = max|block| + 1e-6`` (or the
    given (..., 1, 1) absmax) as round(x * (127 / amax)), no clip; the
    int8 sums exact (float64 products of the codes), then
    ``acc * ((amax / 127) * scale)`` in float32. Returns (..., m, n)."""
    amax = (block_absmax(x) if amax is None else amax) + 1e-6
    q = torch.round(x * (127.0 / amax))
    acc = torch.matmul(q.double(), w.codes.t().double()).float()
    return acc * ((amax / 127.0) * w.scale)


def token_block(t: int) -> int:
    """The largest power of two <= ``Q8_BLOCK_TOKENS`` that divides ``t``:
    the int8 branch's token block (``mlp_block.py:164-175`` there)."""
    blk = Q8_BLOCK_TOKENS
    while t % blk:
        blk //= 2
    return blk


def mm_f32(a, b):
    """a @ b with float32 accumulation of operands held in their dtype
    (products of bf16 values are exact in float32)."""
    return torch.matmul(a.float(), b.float())


def mlp_q8_reference(x, gamma, beta, w1: Q8Weight, b1, w2: Q8Weight, b2,
                     blk: int, ln_round: bool = False):
    """The int8 branch over contiguous blocks of ``blk`` tokens, one
    activation scale per block and product. ``ln_round``: the LayerNorm
    output is rounded to x's dtype before it is quantized (K5's branch)."""
    c = x.shape[-1]
    xb = x.reshape(-1, blk, c)
    normed = layer_norm_float32(xb, gamma, beta)
    if ln_round:
        normed = normed.to(x.dtype).float()
    h = gelu_as(q8_dot(normed, w1) + b1.float())
    o = (q8_dot(h, w2) + b2.float()).to(x.dtype)
    return (xb + o).reshape(x.shape)


def check_res_add(res_add: bool) -> None:
    """The int8 branches keep the residual: JAX trains in float only."""
    if not res_add:
        raise ValueError("the int8 branch takes res_add=True only (the "
                         "training branches run the float path)")


def mlp_block_reference(x, gamma, beta, w1, b1, w2, b2, *,
                        quant: bool = False, res_round: bool = False,
                        res_add: bool = True):
    """Plain PyTorch version, with the kernel's rounding points; mirrors the
    JAX ``mlp_block_reference`` (float, with its ``res_add``) and
    ``_kernel`` (``quant``: w1 and w2 are ``Q8Weight``s, one activation
    scale per ``token_block(T)`` tokens, with the residual only).
    ``res_round`` rounds the float path's ``o + b2`` to x's dtype before
    the residual is added, as the merged block (K5) does."""
    if quant:
        check_res_add(res_add)
        blk = token_block(x.numel() // x.shape[-1])
        return mlp_q8_reference(x, gamma, beta, w1, b1, w2, b2, blk)
    normed = layer_norm_f32(x, gamma, beta)
    h = F.gelu(mm_f32(normed, w1) + b1.float()).to(x.dtype)  # erf
    o = mm_f32(h, w2) + b2.float()
    if not res_add:
        return o.to(x.dtype)
    if res_round:
        return x + o.to(x.dtype)
    return (x.float() + o).to(x.dtype)


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
    on_card(what, x)
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


def on_card(what: str, x) -> None:
    """The kernels take CUDA tensors only; raises ValueError."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {x.device}")


def run_entry(fn, device, *args) -> int:
    """Call a C entry point with each tensor as its pointer and the current
    stream of ``device`` last, with that device current (switched only when
    it is not: the switch costs the host microseconds a call); returns its
    CUDA error code."""
    stream = torch.cuda.current_stream(device).cuda_stream
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    if device.index is None or device.index == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(device):
        return fn(*args, stream)


def launch_checked(what: str, fn, *args) -> None:
    """Call a C entry point on the current stream of the first tensor's
    device; raise on the CUDA error it returns."""
    dev = next(a for a in args if isinstance(a, torch.Tensor)).device
    err = run_entry(fn, dev, *args)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


@functools.cache
def _launch_fn(loop: bool = False):
    """The C entry point of ``csrc/mlp_block.cu`` (built on first use),
    with its argument types declared; ``loop``: its ``_loop`` twin."""
    from ._build import load_library

    lib = load_library("mlp_block")
    fn = lib.mlp_block_loop_launch if loop else lib.mlp_block_launch
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def mlp_products(c: int, hidden: int) -> list:
    """(K, N) of the MLP half's two products: fc1 and fc2."""
    return [(c, hidden), (hidden, c)]


def launch_mlp_block(x, gamma, beta, w1, b1, w2, b2, *, res_add: bool,
                     counter, loop: bool = False):
    """Launch the float path of ``csrc/mlp_block.cu`` on x's device and
    current stream, with or without the residual, and add one to
    ``counter.launches`` (K4's or K6's wrapper) when the kernel launches,
    and its two products to ``swin_gemm.launches`` by path. ``loop``: both
    products on the loop (the parent's entry point).

    x (..., C) float32 or bfloat16 with C % 32 == 0; w1 (C, hidden), b1,
    w2 (hidden, C), b2 in x's dtype, hidden % 32 == 0; gamma, beta (C,) in
    any float dtype. In bf16 a normed scratch (M, C) takes LN(x).
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
    normed = (torch.empty(m, c, dtype=x.dtype, device=x.device)
              if x.dtype == torch.bfloat16 else None)
    launch_checked("mlp_block", _launch_fn(loop), xm, gamma, beta, w1, b1,
                   w2, b2, h, stats, normed, y, m, c, hidden, int(res_add),
                   DTYPE_CODES[x.dtype])
    counter.launches += 1
    swin_gemm.count("mlp_block", swin_gemm.operand_kind(x.dtype),
                    mlp_products(c, hidden), loop)
    return y


def mlp_block_cuda(x, gamma, beta, w1, b1, w2, b2, *, res_add: bool = True):
    """Launch K4 (``launch_mlp_block``) on x's device and current stream.
    ``launches`` counts the kernel launches made through this wrapper."""
    return launch_mlp_block(x, gamma, beta, w1, b1, w2, b2, res_add=res_add,
                            counter=mlp_block_cuda)


mlp_block_cuda.launches = 0


def mlp_block_loop_cuda(x, gamma, beta, w1, b1, w2, b2, *,
                        res_add: bool = True):
    """K4 (or, with ``res_add=False``, K6's branch) with both products on
    the loop: the parent that ``chip_smoke.py`` compares against."""
    return launch_mlp_block(x, gamma, beta, w1, b1, w2, b2, res_add=res_add,
                            counter=mlp_block_loop_cuda, loop=True)


mlp_block_loop_cuda.launches = 0


def check_q8(what: str, x, weights: dict) -> list:
    """Checks of the int8 branch's ``Q8Weight``s: name -> (weight, (n, k))
    codes shape. Returns codes and scales, contiguous, in the given order."""
    out = []
    for name, (w, shape) in weights.items():
        if not isinstance(w, Q8Weight):
            raise TypeError(f"{what}: the int8 branch takes {name} as a "
                            f"Q8Weight (q8_weight(w)), got {type(w).__name__}")
        if (w.codes.dtype != torch.int8 or tuple(w.codes.shape) != shape
                or tuple(w.scale.shape) != (1, shape[0])
                or w.scale.dtype != torch.float32):
            raise ValueError(f"{what}: {name} must be int8 {shape} codes with "
                             f"float32 (1, {shape[0]}) scales, got "
                             f"{w.codes.dtype} {tuple(w.codes.shape)} and "
                             f"{w.scale.dtype} {tuple(w.scale.shape)}")
        if w.codes.device != x.device or w.scale.device != x.device:
            raise ValueError(f"{what}: {name} is not on {x.device}")
        out += aligned(w.codes, w.scale)
    return out


@functools.cache
def _launch_q8_fn(loop: bool = False):
    """The int8 branch's C entry point in ``csrc/mlp_block.cu`` (``loop``:
    its ``_loop`` twin)."""
    from ._build import load_library

    lib = load_library("mlp_block")
    fn = lib.mlp_block_q8_loop_launch if loop else lib.mlp_block_q8_launch
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch_mlp_block_q8(x, gamma, beta, w1: Q8Weight, b1, w2: Q8Weight, b2,
                        *, counter, loop: bool = False):
    """Launch K4's int8 branch (``loop``: on the ``mma.sync`` loop) on x's
    device and current stream; add one to ``counter.launches`` and the two
    products to ``swin_gemm.launches``. Scratch: h (M, hidden) float32, the
    block absmaxes and the A codes (M, max(C, hidden)) int8."""
    c = x.shape[-1]
    hidden = w1.codes.shape[0]
    (xm, b1, b2), (gamma, beta) = check_operands(
        "mlp_block", x,
        {"x": (x, x.shape), "b1": (b1, (hidden,)), "b2": (b2, (c,))},
        {"gamma": (gamma, (c,)), "beta": (beta, (c,))})
    w1c, s1, w2c, s2 = check_q8("mlp_block", x, {"w1": (w1, (hidden, c)),
                                                 "w2": (w2, (c, hidden))})
    if c % Q8_C_MULTIPLE or hidden % Q8_C_MULTIPLE:
        raise ValueError(f"mlp_block int8 kernel needs C and hidden % "
                         f"{Q8_C_MULTIPLE} == 0, got C={c}, hidden={hidden}")
    m = xm.numel() // c
    y = torch.empty_like(xm)
    if m == 0:
        return y
    blk = token_block(m)
    h = torch.empty(m, hidden, dtype=torch.float32, device=x.device)
    stats = torch.empty(m, 2, dtype=torch.float32, device=x.device)
    amax = torch.empty(2 * (m // blk), dtype=torch.int32, device=x.device)
    codes = torch.empty(m, max(c, hidden), dtype=torch.int8, device=x.device)
    launch_checked("mlp_block", _launch_q8_fn(loop), xm, gamma, beta, w1c, s1,
                   b1, w2c, s2, b2, h, stats, amax, codes, y, m, c, hidden,
                   blk, DTYPE_CODES[x.dtype])
    counter.launches += 1
    swin_gemm.count("mlp_block", "int8", mlp_products(c, hidden), loop)
    return y


def mlp_block_q8_cuda(x, gamma, beta, w1: Q8Weight, b1, w2: Q8Weight, b2):
    """Launch K4's int8 branch on x's device and current stream: as
    ``mlp_block_cuda``, with w1 and w2 as ``Q8Weight``s and one activation
    scale per ``token_block(T)`` tokens. ``launches`` counts the launches
    made through this wrapper."""
    return launch_mlp_block_q8(x, gamma, beta, w1, b1, w2, b2,
                               counter=mlp_block_q8_cuda)


mlp_block_q8_cuda.launches = 0


def mlp_block_q8_loop_cuda(x, gamma, beta, w1: Q8Weight, b1, w2: Q8Weight,
                           b2):
    """K4's int8 branch on the ``mma.sync`` loop: the parent."""
    return launch_mlp_block_q8(x, gamma, beta, w1, b1, w2, b2,
                               counter=mlp_block_q8_loop_cuda, loop=True)


mlp_block_q8_loop_cuda.launches = 0


def mlp_block_fused(x, gamma, beta, w1, b1, w2, b2, *, quant: bool = False,
                    res_add: bool = True):
    """K4 on CUDA tensors, its plain version on CPU tensors. ``quant``: the
    int8 branch, w1 and w2 as ``Q8Weight``s (with the residual only).
    ``res_add=False`` returns the branch without the residual."""
    if x.device.type == "cpu":
        return mlp_block_reference(x, gamma, beta, w1, b1, w2, b2,
                                   quant=quant, res_add=res_add)
    if x.device.type == "cuda":
        if quant:
            check_res_add(res_add)
            return mlp_block_q8_cuda(x, gamma, beta, w1, b1, w2, b2)
        return mlp_block_cuda(x, gamma, beta, w1, b1, w2, b2,
                              res_add=res_add)
    raise ValueError(f"mlp_block_fused runs on CPU (plain version) or CUDA "
                     f"(kernel) tensors, got {x.device}")
