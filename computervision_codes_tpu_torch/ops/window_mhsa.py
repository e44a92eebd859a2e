"""Swin window-attention half-block (K3): hand-written CUDA kernel + plain
version.

Counterpart of ``computervision_codes_tpu/ops/window_mhsa.py``. Over x
(B, Hp, Wp, C), with Hp and Wp multiples of the window w, N = w*w,

    y = x + proj(window_MHSA(LN(x)))

(or, with ``res_add=False`` on the float path, the branch alone, as K6's
training forward runs it), where ``bias`` (H, N, N) is the
relative-position bias and ``mask`` (nW, N, N) the additive shift mask
(0 / -100) or None; the caller rolls x
for a shifted block, as the JAX module does. Numerics of the TPU kernel's
float path: LayerNorm in float32 rounded to x's dtype; qkv = LN(x) wqkv +
bqkv summed in float32 and rounded; scores f32(q.k) * hd^-0.5 + bias
(+ mask), with bias and mask as held in x's dtype; float32 softmax with the
denominator floored at 1e-30 and p rounded to x's dtype; p v in float32,
rounded; proj + bias rounded, then the residual added in x's dtype
(``res_add=False``: proj + bias rounded, no residual).

The int8 branch (``quant=True``, ``window_mhsa.py:158-203`` there, one
window row per grid step as the module runs it): ``wqkv`` and ``wproj``
come as ``Q8Weight``s. The QKV activation scale is one absmax per
window-row strip (w x Wp tokens of LN(x), float32, unrounded), then
``(q8_dot + bqkv)`` rounded to x's dtype; the attention core is the float
path's; the proj scale is one absmax per window over its attention output
(x's dtype, read as float32), then ``(q8_dot + bproj)`` rounded and added
to x in x's dtype. For an odd window the TPU kernel computes the padded
query rows of its (w+1)^2 geometry and they enter the window's proj
absmax: a padded query (q = 0, zero bias, padded keys at -1e9) attends
uniformly to the w^2 valid keys, so its output is each head's
``p @ v`` with p = 1/w^2 rounded to x's dtype. Both the plain version and
the kernel include that row.

``window_mhsa_fused`` dispatches on the tensor's device: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel
(``csrc/window_mhsa.cu``; its QKV and proj products on the Swin GEMM core,
``ops/swin_gemm.py``; its attention phase ``csrc/window_attn.cuh``, the
scores in registers, counted in ``ops.window_attention.phase_launches``),
anything else raises.

``window_attn_phase_cuda`` runs the attention phase alone on a packed qkv
(B, Hp, Wp, 3C) and ``window_attn_phase_reference`` is its plain version,
which ``chip_smoke.py`` checks and times; no model calls them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import swin_gemm
from .mlp_block import (C_MULTIPLE, DTYPE_CODES, Q8_C_MULTIPLE, Q8Weight,
                        block_absmax, check_operands, check_q8, check_res_add,
                        launch_checked, layer_norm_f32, layer_norm_float32,
                        mm_f32, q8_dot)
from .window_attention import count_phase

HEAD_DIM = 32  # every Swin variant; the kernel's q/k/v tiles
MAX_WINDOW = 12  # a 144-token window's float32 score tile is 85 KB


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, w*w, C), windows row-major per image."""
    b, h, wd, c = x.shape
    x = x.reshape(b, h // w, w, wd // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, c)


def window_reverse(windows: torch.Tensor, w: int, h: int, wd: int
                   ) -> torch.Tensor:
    """(B*nW, w*w, C) -> (B, H, W, C)."""
    c = windows.shape[-1]
    b = windows.shape[0] // ((h // w) * (wd // w))
    x = windows.reshape(b, h // w, wd // w, w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, wd, c)


def window_attention_core(qkv, bias, mask, num_heads: int, dtype):
    """Attention of each window: qkv (B, nW, N, 3C) in ``dtype`` ->
    (B, nW, N, C), with the kernel's rounding points."""
    b, nw, n, c3 = qkv.shape
    c = c3 // 3
    hd = c // num_heads
    q, k, v = (qkv[..., i * c:(i + 1) * c].reshape(b, nw, n, num_heads, hd)
               .transpose(2, 3) for i in range(3))  # (B, nW, H, N, hd)
    s = mm_f32(q, k.transpose(-1, -2)) * (hd ** -0.5)
    s = s + bias.to(dtype).float()
    if mask is not None:
        s = s + mask.to(dtype).float()[None, :, None]
    s = s - s.amax(-1, keepdim=True)
    e = torch.exp(s)
    denom = torch.clamp(e.sum(-1, keepdim=True), min=1e-30)
    p = (e * (1.0 / denom)).to(dtype)
    o = mm_f32(p, v).to(dtype)  # (B, nW, H, N, hd)
    return o.transpose(2, 3).reshape(b, nw, n, c)


def padded_query_absmax(qkv, num_heads: int, dtype):
    """max |output| of an odd window's padded query rows, per window:
    qkv (B, nW, N, 3C) -> (B, nW, 1, 1) float32."""
    b, nw, n, c3 = qkv.shape
    c = c3 // 3
    v = qkv[..., 2 * c:].reshape(b, nw, n, num_heads, c // num_heads)
    one = torch.ones((), dtype=torch.float32, device=qkv.device)
    p = (one / float(n)).to(dtype).expand(1, n)  # 1 / w^2, rounded
    o = mm_f32(p, v.transpose(2, 3)).to(dtype)  # (B, nW, H, 1, hd)
    return o.float().abs().amax(dim=(2, 3, 4))[..., None, None]


def window_mhsa_q8_reference(x, gamma, beta, wqkv: Q8Weight, bqkv,
                             wproj: Q8Weight, bproj, bias, mask, *,
                             window: int, num_heads: int,
                             ln_round: bool = False):
    """The int8 branch. ``ln_round``: LN(x) is rounded to x's dtype before
    it is quantized (K5's branch)."""
    b, hp, wp, c = x.shape
    w, n = window, window * window
    normed = layer_norm_float32(x, gamma, beta)
    if ln_round:
        normed = normed.to(x.dtype).float()
    strips = normed.reshape(b, hp // w, w * wp, c)
    qkv = (q8_dot(strips, wqkv) + bqkv.float()).to(x.dtype)
    qkv = window_partition(qkv.reshape(b, hp, wp, 3 * c), w)
    qkv = qkv.reshape(b, -1, n, 3 * c)
    o = window_attention_core(qkv, bias, mask, num_heads, x.dtype)
    of = o.float()  # (B, nW, N, C)
    amax = block_absmax(of)
    if w % 2:
        amax = torch.maximum(amax, padded_query_absmax(qkv, num_heads,
                                                       x.dtype))
    o = (q8_dot(of, wproj, amax) + bproj.float()).to(x.dtype)
    return x + window_reverse(o.flatten(0, 1), w, hp, wp)


def window_mhsa_reference(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                          mask, *, window: int, num_heads: int,
                          quant: bool = False, res_add: bool = True):
    """Plain PyTorch version, with the kernel's rounding points; mirrors the
    JAX ``window_mhsa_reference`` (float, with its ``res_add``) and
    ``_kernel`` (``quant``, with the residual only)."""
    if quant:
        check_res_add(res_add)
        return window_mhsa_q8_reference(x, gamma, beta, wqkv, bqkv, wproj,
                                        bproj, bias, mask, window=window,
                                        num_heads=num_heads)
    b, hp, wp, _ = x.shape
    n = window * window
    normed = layer_norm_f32(x, gamma, beta)
    qkv = (mm_f32(normed, wqkv) + bqkv.float()).to(x.dtype)
    qkv = window_partition(qkv, window).reshape(b, -1, n, qkv.shape[-1])
    o = window_attention_core(qkv, bias, mask, num_heads, x.dtype)
    o = window_reverse(o.flatten(0, 1), window, hp, wp)
    o = (mm_f32(o, wproj) + bproj.float()).to(x.dtype)
    if not res_add:
        return o
    return (x.float() + o.float()).to(x.dtype)


def check_geometry(x, window: int, num_heads: int,
                   multiple: int = C_MULTIPLE) -> None:
    """The kernels' limits on the block geometry (C % ``multiple``: 32 on
    the float paths, 64 on the int8 branch); raises ValueError."""
    if x.ndim != 4:
        raise ValueError(f"x must be (B, Hp, Wp, C), got {tuple(x.shape)}")
    _, hp, wp, c = x.shape
    if hp % window or wp % window:
        raise ValueError(f"map {hp}x{wp} is not a multiple of window "
                         f"{window}")
    if not 0 < window <= MAX_WINDOW:
        raise ValueError(f"window kernels take window <= {MAX_WINDOW}, got "
                         f"{window}")
    if c != num_heads * HEAD_DIM or c % multiple:
        raise ValueError(f"window kernels need head_dim {HEAD_DIM} and C % "
                         f"{multiple} == 0, got C={c}, heads={num_heads}")


def attention_operands(what, x, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                       mask, window, num_heads, quant: bool = False):
    """Checked, aligned operands of the attention half (matrices, mask or
    None, float32 LN vectors). ``bias`` and ``mask`` are cast to x's dtype,
    as the JAX module passes them. The matrices are x, wqkv, bqkv, wproj,
    bproj, bias; with ``quant`` (``Q8Weight``s) x, wqkv's codes and scales,
    bqkv, wproj's codes and scales, bproj, bias."""
    check_geometry(x, window, num_heads,
                   Q8_C_MULTIPLE if quant else C_MULTIPLE)
    _, hp, wp, c = x.shape
    n = window * window
    bias = bias.to(x.dtype)
    named = {"x": (x, x.shape), "bqkv": (bqkv, (3 * c,)),
             "bproj": (bproj, (c,)), "bias": (bias, (num_heads, n, n))}
    if not quant:
        named |= {"wqkv": (wqkv, (c, 3 * c)), "wproj": (wproj, (c, c))}
    if mask is not None:
        mask = mask.to(x.dtype)
        named["mask"] = (mask, ((hp // window) * (wp // window), n, n))
    mats, vecs = check_operands(what, x, named,
                                {"gamma": (gamma, (c,)),
                                 "beta": (beta, (c,))})
    got = dict(zip(named, mats))
    mask = got.get("mask")
    if quant:
        wq, sq, wpc, sp = check_q8(what, x, {"wqkv": (wqkv, (3 * c, c)),
                                             "wproj": (wproj, (c, c))})
        return ([got["x"], wq, sq, got["bqkv"], wpc, sp, got["bproj"],
                 got["bias"]], mask, vecs)
    return ([got[k] for k in ("x", "wqkv", "bqkv", "wproj", "bproj",
                              "bias")], mask, vecs)


@functools.cache
def _launch_fn(loop: bool = False):
    """The C entry point of ``csrc/window_mhsa.cu`` (built on first use),
    with its argument types declared; ``loop``: its ``_loop`` twin, every
    product on the loop."""
    from ._build import load_library

    lib = load_library("window_mhsa")
    fn = lib.window_mhsa_loop_launch if loop else lib.window_mhsa_launch
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 6
                   + [ctypes.c_float] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def attn_products(c: int) -> list:
    """(K, N) of the attention half's two products: QKV and proj."""
    return [(c, 3 * c), (c, c)]


def launch_window_mhsa(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                       mask, *, window: int, num_heads: int, res_add: bool,
                       counter, loop: bool = False):
    """Launch the float path of ``csrc/window_mhsa.cu`` on x's device and
    current stream, with or without the residual, and add one to
    ``counter.launches`` (K3's or K6's wrapper) when the kernel launches,
    and its two products to ``swin_gemm.launches`` by path. ``loop``: every
    product on the loop (the parent's entry point).

    x (B, Hp, Wp, C) float32 or bfloat16, Hp and Wp multiples of ``window``
    (<= 12), head_dim 32, C % 32 == 0; weights and biases in x's dtype;
    gamma, beta in any float dtype; bias and mask are cast to x's dtype.
    In bf16 the attn scratch holds LN(x) for the QKV product first.
    """
    (x, wqkv, bqkv, wproj, bproj, bias), mask, (gamma, beta) = \
        attention_operands("window_mhsa", x, gamma, beta, wqkv, bqkv, wproj,
                           bproj, bias, mask, window, num_heads)
    b, hp, wp, c = x.shape
    m = b * hp * wp
    y = torch.empty_like(x)
    if m == 0:
        return y
    qkv = torch.empty(m, 3 * c, dtype=x.dtype, device=x.device)
    attn = torch.empty(m, c, dtype=x.dtype, device=x.device)
    stats = torch.empty(m, 2, dtype=torch.float32, device=x.device)
    launch_checked("window_mhsa", _launch_fn(loop), x, gamma, beta, wqkv,
                   bqkv, wproj, bproj, bias, mask, qkv, attn, stats, y, b, hp,
                   wp, c, num_heads, window, HEAD_DIM ** -0.5, int(res_add),
                   DTYPE_CODES[x.dtype])
    counter.launches += 1
    swin_gemm.count("window_mhsa", swin_gemm.operand_kind(x.dtype),
                    attn_products(c), loop)
    count_phase("window_mhsa")
    return y


def window_mhsa_cuda(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, mask,
                     *, window: int, num_heads: int, res_add: bool = True):
    """Launch K3 (``launch_window_mhsa``) on x's device and current stream.
    ``launches`` counts the kernel launches made through this wrapper."""
    return launch_window_mhsa(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                              mask, window=window, num_heads=num_heads,
                              res_add=res_add, counter=window_mhsa_cuda)


window_mhsa_cuda.launches = 0


def window_mhsa_loop_cuda(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                          mask, *, window: int, num_heads: int,
                          res_add: bool = True):
    """K3 (or, with ``res_add=False``, K6's branch) with both products on
    the loop: the parent that ``chip_smoke.py`` compares against."""
    return launch_window_mhsa(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                              mask, window=window, num_heads=num_heads,
                              res_add=res_add, counter=window_mhsa_loop_cuda,
                              loop=True)


window_mhsa_loop_cuda.launches = 0


@functools.cache
def _launch_q8_fn(loop: bool = False):
    """The int8 branch's C entry point in ``csrc/window_mhsa.cu`` (``loop``:
    its ``_loop`` twin)."""
    from ._build import load_library

    lib = load_library("window_mhsa")
    fn = lib.window_mhsa_q8_loop_launch if loop else lib.window_mhsa_q8_launch
    fn.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def launch_window_mhsa_q8(x, gamma, beta, wqkv: Q8Weight, bqkv,
                          wproj: Q8Weight, bproj, bias, mask, *, window: int,
                          num_heads: int, counter, loop: bool = False):
    """Launch K3's int8 branch (``loop``: on the ``mma.sync`` loop) on x's
    device and current stream; add one to ``counter.launches`` and the two
    products to ``swin_gemm.launches``. Scratch beside the float path's: the
    strip and window absmaxes (int32) and the A codes (M, C) int8."""
    mats, mask, (gamma, beta) = attention_operands(
        "window_mhsa", x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, mask,
        window, num_heads, quant=True)
    x, wq, sq, bqkv, wpc, sp, bproj, bias = mats
    b, hp, wp, c = x.shape
    m = b * hp * wp
    y = torch.empty_like(x)
    if m == 0:
        return y
    strips = b * (hp // window)
    qkv = torch.empty(m, 3 * c, dtype=x.dtype, device=x.device)
    attn = torch.empty(m, c, dtype=x.dtype, device=x.device)
    stats = torch.empty(m, 2, dtype=torch.float32, device=x.device)
    amax = torch.empty(strips * (1 + wp // window), dtype=torch.int32,
                       device=x.device)
    codes = torch.empty(m, c, dtype=torch.int8, device=x.device)
    launch_checked("window_mhsa", _launch_q8_fn(loop), x, gamma, beta, wq,
                   sq, bqkv, wpc, sp, bproj, bias, mask, qkv, attn, stats,
                   amax, codes, y, b, hp, wp, c, num_heads, window,
                   HEAD_DIM ** -0.5, DTYPE_CODES[x.dtype])
    counter.launches += 1
    swin_gemm.count("window_mhsa", "int8", attn_products(c), loop)
    count_phase("window_mhsa")
    return y


def window_mhsa_q8_cuda(x, gamma, beta, wqkv: Q8Weight, bqkv,
                        wproj: Q8Weight, bproj, bias, mask, *, window: int,
                        num_heads: int):
    """Launch K3's int8 branch on x's device and current stream: as
    ``window_mhsa_cuda``, with wqkv and wproj as ``Q8Weight``s.
    ``launches`` counts the launches made through this wrapper."""
    return launch_window_mhsa_q8(x, gamma, beta, wqkv, bqkv, wproj, bproj,
                                 bias, mask, window=window,
                                 num_heads=num_heads,
                                 counter=window_mhsa_q8_cuda)


window_mhsa_q8_cuda.launches = 0


def window_mhsa_q8_loop_cuda(x, gamma, beta, wqkv: Q8Weight, bqkv,
                             wproj: Q8Weight, bproj, bias, mask, *,
                             window: int, num_heads: int):
    """K3's int8 branch on the ``mma.sync`` loop: the parent."""
    return launch_window_mhsa_q8(x, gamma, beta, wqkv, bqkv, wproj, bproj,
                                 bias, mask, window=window,
                                 num_heads=num_heads,
                                 counter=window_mhsa_q8_loop_cuda, loop=True)


window_mhsa_q8_loop_cuda.launches = 0


def window_attn_phase_reference(qkv, bias, mask, *, window: int,
                                num_heads: int, absmax: bool = False):
    """The attention phase alone, plain: qkv (B, Hp, Wp, 3C) as the QKV
    product writes it -> (B, Hp, Wp, C) in qkv's dtype; with ``absmax``
    also each window's max |output| (B * nW,) float32, with the padded
    query of an odd window (the int8 branch's proj scales)."""
    b, hp, wp, c3 = qkv.shape
    n = window * window
    win = window_partition(qkv, window).reshape(b, -1, n, c3)
    o = window_attention_core(win, bias, mask, num_heads, qkv.dtype)
    out = window_reverse(o.flatten(0, 1), window, hp, wp)
    if not absmax:
        return out
    amax = block_absmax(o.float())
    if window % 2:
        amax = torch.maximum(amax, padded_query_absmax(win, num_heads,
                                                       qkv.dtype))
    return out, amax.flatten()


@functools.cache
def _phase_fn():
    """``window_attn_phase_launch`` of ``csrc/window_mhsa.cu``."""
    from ._build import load_library

    fn = load_library("window_mhsa").window_attn_phase_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def launch_window_attn_phase(qkv, bias, mask, *, window: int,
                             num_heads: int, absmax: bool, counter):
    """Launch the attention phase alone on qkv's device and current stream;
    add one to ``counter.launches`` and to the phase's count. Operands as
    ``window_attn_phase_reference``; bias and mask are cast to qkv's
    dtype."""
    if qkv.ndim != 4 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (B, Hp, Wp, 3C), got "
                         f"{tuple(qkv.shape)}")
    b, hp, wp, c3 = qkv.shape
    c, n = c3 // 3, window * window
    check_geometry(qkv[..., :c], window, num_heads)
    named = {"qkv": (qkv, qkv.shape),
             "bias": (bias.to(qkv.dtype), (num_heads, n, n))}
    if mask is not None:
        named["mask"] = (mask.to(qkv.dtype),
                         ((hp // window) * (wp // window), n, n))
    mats, _ = check_operands("window_attn_phase", qkv, named, {})
    qkv, bias = mats[:2]
    mask = mats[2] if mask is not None else None
    out = torch.empty(b, hp, wp, c, dtype=qkv.dtype, device=qkv.device)
    amax = (torch.empty(b * (hp // window) * (wp // window),
                        dtype=torch.int32, device=qkv.device)
            if absmax else None)
    if b:
        launch_checked("window_attn_phase", _phase_fn(), qkv, bias, mask,
                       out, amax, b, hp, wp, c, num_heads, window,
                       HEAD_DIM ** -0.5, DTYPE_CODES[qkv.dtype])
        counter.launches += 1
        count_phase("window_mhsa")
    return (out, amax.view(torch.float32)) if absmax else out


def window_attn_phase_cuda(qkv, bias, mask, *, window: int, num_heads: int,
                           absmax: bool = False):
    """K3's attention phase alone, scores in registers
    (``csrc/window_attn.cuh``). ``launches`` counts its launches."""
    return launch_window_attn_phase(qkv, bias, mask, window=window,
                                    num_heads=num_heads, absmax=absmax,
                                    counter=window_attn_phase_cuda)


window_attn_phase_cuda.launches = 0


def window_mhsa_fused(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, mask,
                      *, window: int, num_heads: int, quant: bool = False,
                      res_add: bool = True):
    """K3 on CUDA tensors, its plain version on CPU tensors. ``quant``: the
    int8 branch, wqkv and wproj as ``Q8Weight``s (with the residual only).
    ``res_add=False`` returns the branch without the residual."""
    if x.device.type == "cpu":
        return window_mhsa_reference(x, gamma, beta, wqkv, bqkv, wproj,
                                     bproj, bias, mask, window=window,
                                     num_heads=num_heads, quant=quant,
                                     res_add=res_add)
    if x.device.type == "cuda":
        if quant:
            check_res_add(res_add)
            return window_mhsa_q8_cuda(x, gamma, beta, wqkv, bqkv, wproj,
                                       bproj, bias, mask, window=window,
                                       num_heads=num_heads)
        return window_mhsa_cuda(x, gamma, beta, wqkv, bqkv, wproj, bproj,
                                bias, mask, window=window,
                                num_heads=num_heads, res_add=res_add)
    raise ValueError(f"window_mhsa_fused runs on CPU (plain version) or CUDA "
                     f"(kernel) tensors, got {x.device}")
