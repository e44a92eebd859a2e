"""Fused dilated residual TCN layer: hand-written CUDA kernel + plain version.

Counterpart of ``computervision_codes_tpu/ops/dilated_conv.py``. One layer
over x (B, T, C) is

    y = x + relu(conv3_dilated(x; w_taps) + b1) @ w2 + b2

with ``w_taps`` (3, C, C) = [left, centre, right] in the JAX layout. The
kernel (``csrc/dilated_residual.cu``) fuses the three taps, bias, relu, the
1x1 projection and the residual into one pass, accumulating in float32. In
bf16 a thread-block cluster owns each tile of 64 rows and splits the hidden
and output columns among its CTAs (``dilated_residual_plan``); each CTA runs
both products on wgmma and gathers the hidden tile from the others' shared
memory. float32 runs an FMA kernel. ``dilated_residual_prev_cuda`` launches
the previous design (``csrc/dilated_residual_prev.cuh``), for timings only;
launches are counted per design (``design_launches``) here and in the C
library (``library_design_launches``).

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

from .mlp_block import on_card, run_entry

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_C_MULTIPLE, _C_MAX = 128, 1024
ROWS = {torch.bfloat16: 64, torch.float32: 32}  # rows a cluster / block owns
DESIGNS = ("new", "prev")
# launches made through the wrappers per design: "new" the current kernels,
# "prev" the previous design's (``dilated_residual_prev_cuda`` only)
design_launches = dict.fromkeys(DESIGNS, 0)


def dilated_residual_plan(b: int, t: int, c: int, dtype=torch.bfloat16,
                          resident: int | None = None) -> dict:
    """The launch geometry of ``csrc/dilated_residual.cu`` for x (b, t, c),
    as its ``plan_of`` takes it: ``rows`` a tile, ``slice`` (the columns a
    CTA owns), ``cluster`` (CTAs a cluster, slice x cluster = C),
    ``stages`` (the TMA ring) and ``grid`` ((cluster x row tiles, b); CTA x
    of a cluster has rank x % cluster and row tile x // cluster).

    bf16: up to C = 512, slices of 64 columns (clusters of 8 at 512, 9
    stages of 16 KB) where the layer's b x ceil(t / 64) clusters fit on the
    card at once, else slices of 128 (clusters of 4 at 512, 6 stages of 24
    KB): twice the work a CTA, but one wave where 64-column clusters would
    take several. ``resident`` is the clusters of 64-column CTAs the card
    holds at once (the C library asks the card: 15 at C = 512 on an H100);
    None counts every cluster as fitting. Above C = 512, slices of 128 (the
    hidden tile takes 2 C bytes a row of shared memory, which leaves 3
    stages at C = 1024). float32, the FMA kernel: one block of 32 rows and
    every column."""
    if c <= 0 or c % _C_MULTIPLE or c > _C_MAX:
        raise ValueError(f"dilated_residual kernel needs C % {_C_MULTIPLE} "
                         f"== 0 and C <= {_C_MAX}, got C={c}")
    if dtype not in ROWS:
        raise TypeError(f"dilated_residual kernel takes float32 or bfloat16, "
                        f"got {dtype}")
    rows = ROWS[dtype]
    if dtype == torch.float32:
        width, stages = c, 1
    elif c > 512:
        width, stages = 128, 3
    elif resident is not None and b * -(-t // rows) > resident:
        width, stages = 128, 6
    else:
        width, stages = 64, 9
    cluster = c // width
    return {"rows": rows, "slice": width, "cluster": cluster,
            "stages": stages, "grid": (cluster * -(-t // rows), b)}


def dilated_residual_tiles_reference(x, w_taps, b1, w2, b2, dilation: int,
                                     causal: bool = False,
                                     resident: int | None = None):
    """The bf16 kernel's algorithm in plain PyTorch, for the tests: each
    cluster's 64-row tile reads its taps with rows outside [0, T) as zero;
    each CTA's slice of H (``dilated_residual_plan``'s, for ``resident``)
    is the float32 sum of its columns, plus b1, relu, rounded to x's dtype;
    the slices gathered, each CTA's output slice is H W2[:, slice] + b2 + x
    in float32, rounded once."""
    b, t, c = x.shape
    plan = dilated_residual_plan(b, t, c, torch.bfloat16, resident)
    rows, width = plan["rows"], plan["slice"]
    offs = ((-2 * dilation, -dilation, 0) if causal
            else (-dilation, 0, dilation))
    xf, wf = x.float(), w_taps.float()
    y = torch.empty_like(x)
    for t0 in range(0, t, rows):
        idx = torch.arange(t0, t0 + rows)
        taps = []
        for o in offs:  # TMA's zero fill outside [0, T)
            src = idx + o
            ok = (src >= 0) & (src < t)
            tap = torch.zeros(b, rows, c)
            tap[:, ok] = xf[:, src[ok]]
            taps.append(tap)
        a = torch.cat(taps, dim=-1)  # (b, rows, 3C)
        h = torch.cat([  # each CTA's slice, rounded on its own
            torch.relu(a @ wf[:, :, n0:n0 + width].reshape(3 * c, width)
                       + b1[n0:n0 + width].float()).to(x.dtype)
            for n0 in range(0, c, width)], dim=-1).float()
        keep = idx < t
        centre = taps[offs.index(0)]
        out = torch.cat([
            h @ w2[:, n0:n0 + width].float() + b2[n0:n0 + width].float()
            + centre[..., n0:n0 + width] for n0 in range(0, c, width)],
            dim=-1)
        y[:, idx[keep]] = out[:, keep].to(x.dtype)
    return y


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
def _launch_fn(prev: bool = False):
    """The C entry point of ``csrc/dilated_residual.cu`` (built on first
    use), with its argument types declared; ``prev``: the previous
    design's."""
    from ._build import load_library

    lib = load_library("dilated_residual")
    fn = lib.dilated_residual_prev_launch if prev else \
        lib.dilated_residual_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def library_design_launches() -> dict:
    """The C library's own launches per design since it was loaded or
    reset (builds and loads it: the card only)."""
    from ._build import load_library

    fn = load_library("dilated_residual").dilated_residual_launches
    fn.argtypes, fn.restype = [ctypes.c_void_p], None
    out = (ctypes.c_longlong * 2)()
    fn(ctypes.addressof(out))
    return dict(zip(DESIGNS, out))


def reset_design_launches() -> None:
    """The counts per design to 0, here and in the C library if this
    process has loaded it."""
    from ._build import loaded

    design_launches.update(dict.fromkeys(DESIGNS, 0))
    lib = loaded("dilated_residual")
    if lib is not None:
        lib.dilated_residual_reset.argtypes = []
        lib.dilated_residual_reset.restype = None
        lib.dilated_residual_reset()


def _launch(x, w_taps, b1, w2, b2, dilation: int, causal: bool, prev: bool):
    name = "dilated_residual_prev_cuda" if prev else "dilated_residual_cuda"
    on_card(name, x)
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"dilated_residual kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if x.ndim != 3:
        raise ValueError(f"x must be (B, T, C), got {tuple(x.shape)}")
    b, t, c = x.shape
    want = {"w_taps": (3, c, c), "b1": (c,), "w2": (c, c), "b2": (c,)}
    for arg, arr in zip(want, (w_taps, b1, w2, b2)):
        if tuple(arr.shape) != want[arg]:
            raise ValueError(f"{arg} must be {want[arg]}, got "
                             f"{tuple(arr.shape)}")
        if arr.dtype != x.dtype or arr.device != x.device:
            raise ValueError(f"{arg} is {arr.dtype} on {arr.device}; x is "
                             f"{x.dtype} on {x.device}")
    dilated_residual_plan(b, t, c, x.dtype)  # raises on a C it does not take
    if dilation < 0:
        raise ValueError(f"dilation must be >= 0, got {dilation}")
    if b > 65535:
        raise ValueError(f"dilated_residual kernel takes B <= 65535, got {b}")
    # contiguous, and 16-byte aligned: the kernels move 16-byte vectors and
    # TMA boxes (a fresh allocation is aligned; a view at an odd offset is
    # copied)
    x, w_taps, b1, w2, b2 = (
        a if a.is_contiguous() and a.data_ptr() % 16 == 0
        else a.clone(memory_format=torch.contiguous_format)
        for a in (x, w_taps, b1, w2, b2))
    y = torch.empty_like(x)
    err = run_entry(_launch_fn(prev), x.device, x, w_taps, b1, w2, b2, y, b,
                    t, c, dilation, int(causal), _DTYPE_CODES[x.dtype])
    if err != 0:
        raise RuntimeError(f"dilated_residual kernel launch failed"
                           f"{' (previous design)' if prev else ''}: CUDA "
                           f"error {err}")
    design_launches["prev" if prev else "new"] += 1
    return y


def dilated_residual_cuda(x, w_taps, b1, w2, b2, dilation: int,
                          causal: bool = False):
    """Launch the CUDA kernel on x's device and current stream: bf16 the
    cluster design, float32 the FMA kernel.

    Takes float32 or bfloat16, all six tensors in one dtype on one CUDA
    device, with C % 128 == 0 and C <= 1024. ``launches`` counts the
    kernel launches made through this wrapper.
    """
    y = _launch(x, w_taps, b1, w2, b2, dilation, causal, prev=False)
    dilated_residual_cuda.launches += 1
    return y


def dilated_residual_prev_cuda(x, w_taps, b1, w2, b2, dilation: int,
                               causal: bool = False):
    """``dilated_residual_cuda`` in the previous design (one block of 32
    rows computing every column, WMMA in bf16), for timings only; no model
    calls it."""
    y = _launch(x, w_taps, b1, w2, b2, dilation, causal, prev=True)
    dilated_residual_prev_cuda.launches += 1
    return y


dilated_residual_cuda.launches = 0
dilated_residual_prev_cuda.launches = 0


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
