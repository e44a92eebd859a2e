"""Fused ResNet stem: hand-written CUDA kernel + plain version.

Counterpart of ``computervision_codes_tpu/ops/stem_pool.py``. Over NHWC
frames x (N, H, W, 3), with H and W divisible by 4,

    y = maxpool3x3/s2/p1(relu(conv7x7/s2/p3(x; w) + bias))

where ``w`` (7, 7, 3, 64) HWIO is the stem kernel with BatchNorm already
folded in and ``bias`` (64,) the folded float32 bias. The convolution
accumulates in float32; bias and ReLU are applied in float32 and the result
is rounded to x's dtype before the max-pool, as the JAX kernel does. The kernel (``csrc/stem_pool.cu``) writes only the pooled
(H/4, W/4, 64) map. In bf16 it is a persistent implicit GEMM on wgmma: each
block walks bands of pooled rows (``stem_pool_plan``), staging the raw input
rows and computing each conv row once, with the weight laid out as
``stem_pair_weight`` (pairs of adjacent input elements, K = 160), which the
kernel gathers from w itself.
float32 runs an FMA kernel. ``stem_pool_prev_cuda`` launches the previous
design (``csrc/stem_pool_prev.cuh``), for timings only; launches are
counted per design (``design_launches``) here and in the C library
(``library_design_launches``).

``stem_pool_fused`` dispatches on the tensor's device: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel, anything else raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .mlp_block import on_card, run_entry

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
OUT_CHANNELS = 64
# the bf16 kernel's depth: 7 kernel rows x 11 pairs of adjacent input
# elements, rounded to the 16-deep wgmma step; pooled columns a chunk
PAIRS, PAIRS_PER_ROW, DEPTH, QW_MAX = 77, 11, 160, 127
DESIGNS = ("new", "prev")
# launches made through the wrappers per design: "new" the current kernels,
# "prev" the previous design's (``stem_pool_prev_cuda`` only)
design_launches = dict.fromkeys(DESIGNS, 0)


def _pair_taps():
    """For each depth row k of the bf16 kernel's weight: the (dy, dx, c)
    tap it holds, or None. Pair P = 11 dy + u holds the input elements
    6 s - 10 + 2u and 6 s - 9 + 2u of row 2 r + dy for conv cell (r, s),
    which are taps (dx, c) = divmod(2u - 1 + e, 3) for e = 0, 1 (the first
    element of pair 0 is no tap)."""
    taps = [None] * DEPTH
    for p in range(PAIRS):
        dy, u = divmod(p, PAIRS_PER_ROW)
        for e in (0, 1):
            tap = 2 * u - 1 + e
            if tap >= 0:
                taps[2 * p + e] = (dy,) + divmod(tap, 3)
    return taps


_PAIR_TAPS = _pair_taps()


@functools.cache
def _pair_index(device) -> torch.Tensor:
    """Row k of the pair weight as a row of w.reshape(147, 64) with a zero
    row appended (147 where it holds no tap), on ``device``."""
    idx = [147 if tap is None else (tap[0] * 7 + tap[1]) * 3 + tap[2]
           for tap in _PAIR_TAPS]
    return torch.tensor(idx, device=device)


def stem_pair_weight(w):
    """The (160, 64) weight of the bf16 kernel from the (7, 7, 3, 64) HWIO
    kernel, in its dtype: row k holds tap ``_pair_taps()[k]``, zeros where
    it holds none. The kernel gathers the same rows from w itself; this is
    its plain version, for the tests."""
    flat = torch.cat([w.reshape(147, w.shape[-1]), w.new_zeros(1, w.shape[-1])])
    return flat[_pair_index(w.device)]


def stem_pool_plan(n: int, h: int, w: int, sms: int) -> dict:
    """The bf16 kernel's work split for n frames of h x w on ``sms`` SMs,
    as ``csrc/stem_pool.cu``'s ``plan_of`` takes it: work items are
    (frame, band of ``band`` pooled rows, chunk of at most ``qw`` pooled
    columns), chunk fastest; ``grid`` blocks walk them (item i, i + grid,
    ...); ``row_bytes`` a staged input row. The band is the one whose
    rounds of items over the blocks times its conv rows (2 a pooled row,
    one more where bands split the frame) is least, the longer on a tie."""
    ph, qw_all = h // 4, w // 4
    chunks = -(-qw_all // QW_MAX)
    qw = -(-qw_all // chunks)
    band, best = ph, None
    for length in range(ph, 0, -1):
        bands = -(-ph // length)
        items = n * bands * chunks
        cost = -(-items // sms) * (2 * length + (1 if bands > 1 else 0))
        if best is None or cost < best:
            band, best = length, cost
    items = n * -(-ph // band) * chunks
    return {"band": band, "chunks": chunks, "qw": qw, "items": items,
            "grid": min(items, sms),
            "row_bytes": -(-2 * (12 * qw + 40) // 16) * 16}


def stem_pool_walk_reference(x, w, bias, sms: int = 132):
    """The bf16 kernel's algorithm in plain PyTorch, for the tests: for
    each work item of ``stem_pool_plan``, the padded input rows staged from
    the chunk's first element (zeros outside the frame), each conv row
    computed once as the K = 160 pair product over its 7 staged rows
    (float32 sums of x's dtype values), bias and ReLU in float32, rounded
    once to x's dtype, conv row 2p + 1 carried as the next row's 2p - 1
    (row -1 and column -1 zero), the 3 x 3 / 2 max."""
    _check_geometry(x)
    n, h, wd, _ = x.shape
    plan = stem_pool_plan(n, h, wd, sms)
    ph, qw_all = h // 4, wd // 4
    wk = stem_pair_weight(w.to(x.dtype)).float()
    bias = bias.float()
    y = torch.empty(n, ph, qw_all, OUT_CHANNELS, dtype=x.dtype)
    for item in range(plan["items"]):
        chunk = item % plan["chunks"]
        frame, band = divmod(item // plan["chunks"], -(-ph // plan["band"]))
        p0 = band * plan["band"]
        p1 = min(p0 + plan["band"], ph)
        q0 = chunk * plan["qw"]
        qwc = min(plan["qw"], qw_all - q0)
        es0 = (12 * q0 - 16) // 8 * 8
        mc = 2 * qwc + 1
        s = 2 * q0 - 1 + torch.arange(mc)  # the chunk's conv columns
        # every padded row the band reads, elements es0 .., zero outside
        width = plan["row_bytes"] // 2
        padded = torch.zeros(h + 6, width)
        src = torch.arange(es0, es0 + width)
        ok = (src >= 0) & (src < 3 * wd)
        padded[3:h + 3, ok] = x[frame].reshape(h, 3 * wd)[:, src[ok]].float()
        # A of conv row r: (mc, 160) with A[m, 2P + e] = element
        # 6 s - 10 + 2u + e of padded row 2r + dy, P = 11 dy + u
        pair = torch.arange(PAIRS)
        dy, u = pair // PAIRS_PER_ROW, pair % PAIRS_PER_ROW
        col = (6 * s[:, None] - 10 + 2 * u[None] - es0)  # (mc, 77)

        def conv_row(r):
            rows = padded[2 * r + dy]  # (77, width)
            a = torch.zeros(mc, DEPTH)
            a[:, 0:2 * PAIRS:2] = rows[pair, col]
            a[:, 1:2 * PAIRS:2] = rows[pair, col + 1]
            a[:, 0:2 * PAIRS:2 * PAIRS_PER_ROW] = 0.0  # no tap's element
            v = torch.relu(a @ wk + bias).to(x.dtype).float()
            v[s < 0] = 0.0  # conv column -1: the pool's pad
            return v

        carry = conv_row(2 * p0 - 1) if p0 > 0 else torch.zeros(
            mc, OUT_CHANNELS)
        for p in range(p0, p1):
            rm = torch.maximum(carry, conv_row(2 * p))
            carry = conv_row(2 * p + 1)
            rm = torch.maximum(rm, carry)
            pooled = torch.stack([rm[0:2 * qwc:2], rm[1:2 * qwc:2],
                                  rm[2:2 * qwc + 1:2]]).amax(0)
            y[frame, p, q0:q0 + qwc] = pooled.to(x.dtype)
    return y


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
def _launch_fn(prev: bool = False):
    """The C entry point of ``csrc/stem_pool.cu`` (built on first use),
    with its argument types declared; ``prev``: the previous design's."""
    from ._build import load_library

    lib = load_library("stem_pool")
    fn = lib.stem_pool_prev_launch if prev else lib.stem_pool_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def library_design_launches() -> dict:
    """The C library's own launches per design since it was loaded or
    reset (builds and loads it: the card only)."""
    from ._build import load_library

    fn = load_library("stem_pool").stem_pool_launches
    fn.argtypes, fn.restype = [ctypes.c_void_p], None
    out = (ctypes.c_longlong * 2)()
    fn(ctypes.addressof(out))
    return dict(zip(DESIGNS, out))


def reset_design_launches() -> None:
    """The counts per design to 0, here and in the C library if this
    process has loaded it."""
    from ._build import loaded

    design_launches.update(dict.fromkeys(DESIGNS, 0))
    lib = loaded("stem_pool")
    if lib is not None:
        lib.stem_pool_reset.argtypes = []
        lib.stem_pool_reset.restype = None
        lib.stem_pool_reset()


def _launch(x, w, bias, prev: bool):
    name = "stem_pool_prev_cuda" if prev else "stem_pool_cuda"
    on_card(name, x)
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
    # contiguous and 16-byte aligned: the bf16 kernel copies 16-byte pieces
    x = (x if x.is_contiguous() and x.data_ptr() % 16 == 0
         else x.clone(memory_format=torch.contiguous_format))
    w = w.to(x.dtype).contiguous()
    bias = bias.float().contiguous()
    y = torch.empty(n, h // 4, wd // 4, OUT_CHANNELS, dtype=x.dtype,
                    device=x.device)
    if n == 0:
        return y
    err = run_entry(_launch_fn(prev), x.device, x, w, bias, y, n, h, wd,
                    _DTYPE_CODES[x.dtype])
    if err != 0:
        raise RuntimeError(f"stem_pool kernel launch failed"
                           f"{' (previous design)' if prev else ''}: CUDA "
                           f"error {err}")
    design_launches["prev" if prev else "new"] += 1
    return y


def stem_pool_cuda(x, w, bias):
    """Launch the CUDA kernel on x's device and current stream: bf16 the
    persistent wgmma design, float32 the FMA kernel.

    x (N, H, W, 3) float32 or bfloat16 with H, W % 4 == 0; w (7, 7, 3, 64)
    (cast to x's dtype here); bias (64,) (float32). ``launches`` counts the
    kernel launches made through this wrapper.
    """
    y = _launch(x, w, bias, prev=False)
    if x.shape[0]:
        stem_pool_cuda.launches += 1
    return y


def stem_pool_prev_cuda(x, w, bias):
    """``stem_pool_cuda`` in the previous design (one block per 4 x 8
    pooled outputs over an im2col tile, WMMA in bf16), for timings only; no
    model calls it."""
    y = _launch(x, w, bias, prev=True)
    if x.shape[0]:
        stem_pool_prev_cuda.launches += 1
    return y


stem_pool_cuda.launches = 0
stem_pool_prev_cuda.launches = 0


def stem_pool_fused(x, w, bias):
    """Fused stem: kernel on CUDA tensors, plain version on CPU tensors.
    Raises ``ValueError`` when H or W is not divisible by 4."""
    if x.device.type == "cpu":
        return stem_pool_reference(x, w, bias)
    if x.device.type == "cuda":
        return stem_pool_cuda(x, w, bias)
    raise ValueError(f"stem_pool_fused runs on CPU (plain version) or CUDA "
                     f"(kernel) tensors, got {x.device}")
