"""Int8 post-training quantization primitives for the deployed student path.

Counterpart of ``computervision_codes_tpu/ops/quant.py``. Scheme (symmetric
PTQ, as there):

* weights: per-output-channel absmax scales, quantized at conversion time;
* activations: one per-tensor scale, either the dynamic absmax of the
  input or a static calibrated ``act_scale``;
* the convolution accumulates int8 x int8 -> int32 exactly, then one
  per-channel affine dequantizes and applies the folded inference
  BatchNorm: ``out = acc * (s_act * mult) + bias``.

Rounding is half to even (``torch.round``), division is a true division
(not a product with the reciprocal), codes clip at +-127 and scales have a
1e-8 floor, so the quantizers equal the JAX package's bit for bit.

Layouts: activations are NHWC. A float weight ``w`` is HWIO, as in the JAX
tree. An int8 weight ``w_q`` is (Cout, kh, kw, Cin), the kernel's layout
(``quantize_weight`` itself returns the HWIO codes, as JAX does;
``models.quantized`` transposes them once when it builds a module).

On a CUDA tensor the int8 branch of ``quantized_conv_bn`` launches Q1,
the hand-written kernels of ``csrc/qconv_bn.cu``, through
``qconv_bn_cuda``, which picks one of two paths from the shapes alone
(``qconv_path``): where ``Cin % 16 == 0`` a quantize pass
(``quantize_codes_cuda``) and then the ``wgmma`` int8 GEMM over the codes,
with a TMA producer for a 1x1 stride-1 unpadded convolution
(``qconv_gemm_cuda``: every Dense) or a ``cp.async`` implicit-GEMM
producer for the others (``qconv_conv_cuda``); otherwise the older loop
that quantizes on load (``qconv_loop_cuda``). On a CPU tensor it runs the
plain version below, whose int8 convolution is a float64 convolution of
the codes, exact because every partial sum stays below 2**53. Any other
device raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

Padding = Union[str, Sequence[Tuple[int, int]]]
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ACT_NONE, _ACT_RELU, _ACT_LEAKY = 0, 1, 2
_FORMS = {"gemm": 0, "conv": 1}  # the wgmma kernel's producers


def quantize_weight(w: torch.Tensor, axis: int = -1):
    """Symmetric per-output-channel int8 weights. ``w``: HWIO (out = last).
    Returns (int8 codes in w's layout, float32 scales (O,))."""
    red = tuple(i for i in range(w.ndim) if i != axis % w.ndim)
    absmax = w.float().abs().amax(dim=red, keepdim=True)
    scale = torch.clamp_min(absmax, 1e-8) / 127.0
    q = torch.round(w.float() / scale).clamp(-127, 127).to(torch.int8)
    return q, scale.reshape(-1)


def activation_scale(x: torch.Tensor) -> torch.Tensor:
    """The dynamic per-tensor scale max(absmax(x), 1e-8) / 127, float32,
    on x's device (no host sync)."""
    return torch.clamp_min(x.abs().amax().float(), 1e-8) / 127.0


def quantize_with_scale(x: torch.Tensor, scale) -> torch.Tensor:
    """int8 codes clamp(round(x / scale), -127, 127), in float32."""
    return torch.round(x.float() / scale).clamp(-127, 127).to(torch.int8)


def quantize_activation(x: torch.Tensor):
    """Symmetric per-tensor dynamic int8. Returns (q, scale float32)."""
    scale = activation_scale(x)
    return quantize_with_scale(x, scale), scale


def conv_padding(padding: Padding, kh: int, kw: int, stride: int, h: int,
                 w: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((top, bottom), (left, right)) of a JAX-style padding: "SAME",
    "VALID", or a pair of (low, high) pairs."""
    if isinstance(padding, str):
        if padding == "VALID":
            return (0, 0), (0, 0)
        if padding != "SAME":
            raise ValueError(f"unknown padding {padding!r}")
        out = []
        for size, k in ((h, kh), (w, kw)):
            total = max((-(-size // stride) - 1) * stride + k - size, 0)
            out.append((total // 2, total - total // 2))
        return out[0], out[1]
    (t, b), (l, r) = padding
    return (int(t), int(b)), (int(l), int(r))


def conv_i8(xq: torch.Tensor, wq: torch.Tensor, stride: int = 1,
            padding: Padding = "SAME") -> torch.Tensor:
    """int8 x int8 -> int32 NHWC convolution, exact (plain version).

    ``xq`` (N, H, W, Cin) int8, ``wq`` (Cout, kh, kw, Cin) int8. The codes
    are convolved in float64, which is exact here: |acc| <= 127**2 * K is
    far below 2**53 for every K a ResNet has.
    """
    _, h, w, _ = xq.shape
    (pt, pb), (pl, pr) = conv_padding(padding, wq.shape[1], wq.shape[2],
                                      stride, h, w)
    xf = F.pad(xq.permute(0, 3, 1, 2).double(), (pl, pr, pt, pb))
    acc = F.conv2d(xf, wq.permute(0, 3, 1, 2).double(), stride=stride)
    return acc.round().to(torch.int32).permute(0, 2, 3, 1).contiguous()


def fold_bn(scale_w: torch.Tensor, bn: Mapping[str, torch.Tensor],
            eps: float = 1e-5):
    """Fold inference BatchNorm into the dequant affine: returns
    (scale_w * s, bias - mean * s) with s = scale / sqrt(var + eps)."""
    s = bn["scale"] * torch.rsqrt(bn["var"] + eps)
    b = bn["bias"] - bn["mean"] * s
    return scale_w * s, b


def _activate(out: torch.Tensor, relu: bool, leaky_slope) -> torch.Tensor:
    if leaky_slope is not None:
        return torch.where(out >= 0, out, leaky_slope * out)
    if relu:
        return torch.relu(out)
    return out


def qconv_codes_reference(xq, s_act, w_q, mult, bias, stride: int,
                          padding: Padding, relu: bool = False,
                          leaky_slope=None, dtype=torch.bfloat16):
    """Plain version of the ``wgmma`` path over int8 codes ``xq``: the exact
    int8 convolution, then ``acc * (s_act * mult) + bias``, activation,
    rounding to ``dtype``."""
    acc = conv_i8(xq, w_q, stride=stride, padding=padding)
    out = acc.float() * (s_act * mult) + bias
    return _activate(out, relu, leaky_slope).to(dtype)


def qconv_bn_reference(x, s_act, w_q, mult, bias, stride: int,
                       padding: Padding, relu: bool = False,
                       leaky_slope=None, dtype=torch.bfloat16):
    """Plain version of the int8 branch: ``quantize_with_scale`` with
    ``s_act`` (a float32 tensor or float), then ``qconv_codes_reference``."""
    return qconv_codes_reference(quantize_with_scale(x, s_act), s_act, w_q,
                                 mult, bias, stride, padding, relu,
                                 leaky_slope, dtype)


def qconv_path(cin: int, kh: int, kw: int, stride: int,
               pads: Tuple[Tuple[int, int], Tuple[int, int]]) -> str:
    """Which Q1 path a convolution takes on the card: "gemm" (quantize
    pass, then the wgmma GEMM fed by TMA) for a 1x1 stride-1 unpadded
    convolution, "conv" (quantize pass, then the wgmma implicit GEMM fed by
    cp.async) for any other shape whose 16-byte runs of K stay inside one
    tap (``cin % 16 == 0``), else "loop" (quantize on load, mma.sync)."""
    if cin % 16:
        return "loop"
    if kh == kw == 1 and stride == 1 and not any(pads[0] + pads[1]):
        return "gemm"
    return "conv"


@functools.cache
def _launch_fns():
    """The C entry points of ``csrc/qconv_bn.cu`` (built on first use), with
    their argument types declared."""
    from ._build import load_library

    lib = load_library("qconv_bn")
    # N, H, W, Cin, Ho, Wo, Cout, kh, kw, stride, pad_t, pad_l, act; slope
    geometry = [ctypes.c_int] * 13 + [ctypes.c_float]
    quantize = lib.qconv_quantize_launch
    quantize.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                                 ctypes.c_int,
                                                 ctypes.c_void_p]
    wgmma = lib.qconv_wgmma_launch
    wgmma.argtypes = ([ctypes.c_void_p] * 6 + geometry + [ctypes.c_int] * 2
                      + [ctypes.c_void_p])
    loop = lib.qconv_loop_launch
    loop.argtypes = ([ctypes.c_void_p] * 6 + geometry + [ctypes.c_int] * 2
                     + [ctypes.c_void_p])
    for fn in (quantize, wgmma, loop):
        fn.restype = ctypes.c_int
    return {"quantize": quantize, "wgmma": wgmma, "loop": loop}


def _aligned(a: torch.Tensor) -> torch.Tensor:
    """``a`` contiguous and 16-byte aligned (the kernels move 16-byte
    vectors and TMA needs 16-byte aligned bases)."""
    if a.is_contiguous() and a.data_ptr() % 16 == 0:
        return a
    return a.clone(memory_format=torch.contiguous_format)


def _on_card(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {x.device}")


def _scale_on(s_act, device) -> torch.Tensor:
    s_act = torch.as_tensor(s_act, dtype=torch.float32, device=device)
    if s_act.numel() != 1:
        raise ValueError(f"s_act must hold 1 float32, got "
                         f"{tuple(s_act.shape)}")
    return s_act


def _run(fn, device: torch.device, *args) -> None:
    """Calls the C entry point ``fn`` with ``args`` and the current stream
    of ``device``, on that device."""
    if device.index is None or device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"qconv_bn kernel launch failed: CUDA error {err}")


def _quantize(x, s_act) -> torch.Tensor:
    x = _aligned(x)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if x.numel():
        _run(_launch_fns()["quantize"], x.device, x.data_ptr(),
             s_act.data_ptr(), q.data_ptr(), x.numel(),
             _DTYPE_CODES[x.dtype])
        quantize_codes_cuda.launches += 1
    return q


def quantize_codes_cuda(x: torch.Tensor, s_act) -> torch.Tensor:
    """Q1's quantize pass on the card: int8 codes of ``x`` (float32 or
    bfloat16, any shape) with the scale ``s_act`` (one float32, read on the
    device), equal to ``quantize_with_scale``. ``launches`` counts its
    launches."""
    _on_card(x, "quantize_codes_cuda")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the quantize pass takes float32 or bfloat16, got "
                        f"{x.dtype}")
    return _quantize(x, _scale_on(s_act, x.device))


class _Geometry(NamedTuple):
    n: int
    h: int
    w: int
    cin: int
    ho: int
    wo: int
    cout: int
    kh: int
    kw: int
    stride: int
    pt: int
    pl: int
    path: str


def _geometry(x, w_q, mult, bias, stride, padding, dtype,
              what) -> _Geometry:
    """Checks the arguments every convolution entry point of Q1 shares."""
    _on_card(x, what)
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"Q1 writes float32 or bfloat16, got {dtype}")
    if x.ndim != 4 or w_q.ndim != 4:
        raise ValueError(f"x must be NHWC and w_q (Cout, kh, kw, Cin), got "
                         f"{tuple(x.shape)} and {tuple(w_q.shape)}")
    n, h, w, cin = x.shape
    cout, kh, kw, wcin = w_q.shape
    if wcin != cin:
        raise ValueError(f"w_q takes {wcin} input channels, x has {cin}")
    if w_q.dtype != torch.int8:
        raise TypeError(f"w_q must be int8, got {w_q.dtype}")
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    for name, arr in (("mult", mult), ("bias", bias)):
        if arr.numel() != cout or arr.dtype != torch.float32:
            raise ValueError(f"{name} must hold {cout} float32, got "
                             f"{tuple(arr.shape)} {arr.dtype}")
    for name, arr in (("w_q", w_q), ("mult", mult), ("bias", bias)):
        if arr.device != x.device:
            raise ValueError(f"{name} is on {arr.device}; x is on "
                             f"{x.device}")
    (pt, pb), (pl, pr) = conv_padding(padding, kh, kw, stride, h, w)
    if min(pt, pb, pl, pr) < 0 or max(pt, pb) >= kh or max(pl, pr) >= kw:
        raise ValueError(f"padding {((pt, pb), (pl, pr))} is outside what "
                         f"a {kh}x{kw} kernel takes")
    ho = (h + pt + pb - kh) // stride + 1
    wo = (w + pl + pr - kw) // stride + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"{kh}x{kw}/{stride} leaves no output on {h}x{w}")
    return _Geometry(n, h, w, cin, ho, wo, cout, kh, kw, stride, pt, pl,
                     qconv_path(cin, kh, kw, stride, ((pt, pb), (pl, pr))))


def _launch_conv(entry, x, s_act, w_q, mult, bias, g: _Geometry, relu,
                 leaky_slope, dtype, last):
    """Launches ``entry`` ("wgmma" over int8 codes ``x``, or "loop" over
    float ``x``) on x's current stream, ``s_act`` already on x's device;
    ``last`` ends its arguments (the dtype codes and the form). Returns y
    (N, Ho, Wo, Cout)."""
    x, w_q, mult, bias = (_aligned(a) for a in (x, w_q, mult, bias))
    y = torch.empty(g.n, g.ho, g.wo, g.cout, dtype=dtype, device=x.device)
    if leaky_slope is not None:
        act, slope = _ACT_LEAKY, float(leaky_slope)
    else:
        act, slope = (_ACT_RELU if relu else _ACT_NONE), 0.0
    _run(_launch_fns()[entry], x.device, x.data_ptr(), s_act.data_ptr(),
         w_q.data_ptr(), mult.data_ptr(), bias.data_ptr(), y.data_ptr(), g.n,
         g.h, g.w, g.cin, g.ho, g.wo, g.cout, g.kh, g.kw, g.stride, g.pt,
         g.pl, act, slope, *last)
    return y


def _launch_wgmma(xq, s_act, w_q, mult, bias, g: _Geometry, relu,
                  leaky_slope, dtype):
    y = _launch_conv("wgmma", xq, s_act, w_q, mult, bias, g, relu,
                     leaky_slope, dtype, (_DTYPE_CODES[dtype], _FORMS[g.path]))
    wrapper = qconv_gemm_cuda if g.path == "gemm" else qconv_conv_cuda
    wrapper.launches += 1
    return y


def _launch_loop(x, s_act, w_q, mult, bias, g: _Geometry, relu, leaky_slope,
                 dtype):
    y = _launch_conv("loop", x, s_act, w_q, mult, bias, g, relu, leaky_slope,
                     dtype, (_DTYPE_CODES[x.dtype], _DTYPE_CODES[dtype]))
    qconv_loop_cuda.launches += 1
    return y


def _wgmma(form, xq, s_act, w_q, mult, bias, stride, padding, relu,
           leaky_slope, dtype):
    what = f"qconv_{form}_cuda"
    g = _geometry(xq, w_q, mult, bias, stride, padding, dtype, what)
    if xq.dtype != torch.int8:
        raise TypeError(f"{what} takes int8 codes, got {xq.dtype}")
    if g.path != form:
        raise ValueError(f"{what} does not take Cin {g.cin}, {g.kh}x{g.kw}"
                         f"/{g.stride}, padding {padding}: that shape takes "
                         f"the {g.path} path")
    return _launch_wgmma(xq, _scale_on(s_act, xq.device), w_q, mult, bias, g,
                         relu, leaky_slope, dtype)


def qconv_gemm_cuda(xq, s_act, w_q, mult, bias, stride: int = 1,
                    padding: Padding = "VALID", relu: bool = False,
                    leaky_slope=None, dtype=torch.bfloat16):
    """Q1's wgmma kernel with the TMA producer, over int8 codes ``xq``
    (N, H, W, Cin), for the shapes ``qconv_path`` calls "gemm" (1x1,
    stride 1, no padding, Cin % 16 == 0). Arguments as
    ``qconv_codes_reference``, its plain version; ``launches`` counts."""
    return _wgmma("gemm", xq, s_act, w_q, mult, bias, stride, padding, relu,
                  leaky_slope, dtype)


def qconv_conv_cuda(xq, s_act, w_q, mult, bias, stride: int,
                    padding: Padding, relu: bool = False, leaky_slope=None,
                    dtype=torch.bfloat16):
    """Q1's wgmma kernel with the cp.async implicit-GEMM producer, over int8
    codes ``xq``, for the shapes ``qconv_path`` calls "conv". Arguments as
    ``qconv_codes_reference``, its plain version; ``launches`` counts."""
    return _wgmma("conv", xq, s_act, w_q, mult, bias, stride, padding, relu,
                  leaky_slope, dtype)


def qconv_loop_cuda(x, s_act, w_q, mult, bias, stride: int,
                    padding: Padding, relu: bool = False, leaky_slope=None,
                    dtype=torch.bfloat16):
    """Q1's loop (quantize on load, mma.sync s8) over float ``x`` (float32
    or bfloat16); it takes every shape, and ``qconv_bn_cuda`` sends it those
    ``qconv_path`` calls "loop". Arguments as ``qconv_bn_reference``, its
    plain version; ``launches`` counts."""
    g = _geometry(x, w_q, mult, bias, stride, padding, dtype,
                  "qconv_loop_cuda")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the loop takes float32 or bfloat16, got "
                        f"{x.dtype}")
    return _launch_loop(x, _scale_on(s_act, x.device), w_q, mult, bias, g,
                        relu, leaky_slope, dtype)


def qconv_bn_cuda(x, s_act, w_q, mult, bias, stride: int, padding: Padding,
                  relu: bool = False, leaky_slope=None,
                  dtype=torch.bfloat16):
    """Q1 on the card: the path ``qconv_path`` chooses from the shapes.

    x (N, H, W, Cin) float32 or bfloat16; s_act a float32 tensor of one
    element on the same device; w_q (Cout, kh, kw, Cin) int8; mult and
    bias (Cout,) float32; ``dtype`` of the output float32 or bfloat16.
    "gemm" and "conv" run ``quantize_codes_cuda``, then ``qconv_gemm_cuda``
    or ``qconv_conv_cuda``; "loop" runs ``qconv_loop_cuda``. ``launches``
    counts the calls, each wrapper its own kernel's launches.
    """
    g = _geometry(x, w_q, mult, bias, stride, padding, dtype,
                  "qconv_bn_cuda")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"Q1 takes float32 or bfloat16 in, got {x.dtype}")
    s_act = _scale_on(s_act, x.device)
    if g.path == "loop":
        y = _launch_loop(x, s_act, w_q, mult, bias, g, relu, leaky_slope,
                         dtype)
    else:
        y = _launch_wgmma(_quantize(x, s_act), s_act, w_q, mult, bias, g,
                          relu, leaky_slope, dtype)
    qconv_bn_cuda.launches += 1
    return y


for _fn in (quantize_codes_cuda, qconv_gemm_cuda, qconv_conv_cuda,
            qconv_loop_cuda, qconv_bn_cuda):
    _fn.launches = 0


def _qconv_bn(x, s_act, qw, stride, padding, relu, leaky_slope, dtype):
    if x.device.type == "cpu":
        return qconv_bn_reference(x, s_act, qw["w_q"], qw["mult"],
                                  qw["bias"], stride, padding, relu,
                                  leaky_slope, dtype)
    if x.device.type == "cuda":
        return qconv_bn_cuda(x, s_act, qw["w_q"], qw["mult"], qw["bias"],
                             stride, padding, relu, leaky_slope, dtype)
    raise ValueError(f"quantized_conv_bn runs on CPU (plain version) or CUDA "
                     f"(kernel) tensors, got {x.device}")


def quantized_conv_bn(x: torch.Tensor, qw: Mapping[str, torch.Tensor], *,
                      stride: int = 1, padding: Padding = "SAME",
                      relu: bool = False, leaky_slope=None,
                      dtype: torch.dtype = torch.bfloat16,
                      record: Optional[list] = None) -> torch.Tensor:
    """x (NHWC float) -> quantize -> int8 conv -> fused dequant+BN[+act].

    ``qw``: ``{"w_q" int8 (Cout, kh, kw, Cin), "mult" (O,), "bias" (O,),
    optional "act_scale"}`` or, for a BN-folded float conv, ``{"w" HWIO,
    "bias"}``. With ``act_scale`` the input is quantized with that static
    scale; without it, with its dynamic absmax scale. ``record`` (a list)
    switches to calibration: the dynamic scale is appended as a float
    (this syncs with the device).
    """
    if "w" in qw:
        # BN-folded float conv: inputs rounded to ``dtype``, products
        # summed in float32 and the bias added before the one rounding
        w = qw["w"].to(dtype).permute(3, 2, 0, 1).float()
        xc = x.to(dtype).permute(0, 3, 1, 2).float()
        (pt, pb), (pl, pr) = conv_padding(padding, w.shape[2], w.shape[3],
                                          stride, xc.shape[2], xc.shape[3])
        if pt == pb and pl == pr:
            out = F.conv2d(xc, w, stride=stride, padding=(pt, pl))
        else:
            out = F.conv2d(F.pad(xc, (pl, pr, pt, pb)), w, stride=stride)
        out = out.add_(qw["bias"].view(1, -1, 1, 1))
        out = _activate(out, relu, leaky_slope).to(dtype)
        return out.permute(0, 2, 3, 1)
    if record is not None:
        s_act = activation_scale(x)
        record.append(float(s_act))
    elif "act_scale" in qw:
        s_act = qw["act_scale"]
    else:
        s_act = activation_scale(x)
    return _qconv_bn(x, s_act, qw, stride, padding, relu, leaky_slope, dtype)
