"""Probe (P1): one GEMM three ways at the Swin-L GEMM shapes, on the card.

Counterpart of the JAX package's ``scripts/int8_kernel_probe.py``, which
times its Pallas kernels on the TPU. Over x (M, K) bf16 and a (K, N)
weight, per shape:

  bf16   out = bf16(x w), float32 sums: the GEMM core of the shipped Swin
         kernels (``csrc/swin_gemm.cuh``'s TMA-fed wgmma GEMM, run with a
         zero bias);
  int8w  weight-only int8: w as int8 codes, widened to bf16,
         out = bf16((x w) * s), s (1, N) float32 per output channel: the
         same GEMM core, whose producer warpgroup loads the codes by TMA and
         widens them in shared memory into the bf16 stage that the wgmma
         consumers read (wgmma cannot widen int8 operands itself);
  int8   dynamic int8 x int8 with one activation scale per block of ``blk``
         rows: amax = max|x_blk| + 1e-6, q = round(x * (127 / amax)),
         acc = q w exact in int32, out = bf16(acc * ((amax / 127) * s));
         the shipped quantize pass and s8 wgmma GEMM.

Each has a plain PyTorch version (``gemm_*_reference``) and an entry point
(``gemm_bf16``, ``gemm_int8w``, ``gemm_int8``) that takes the plain version
for a CPU tensor and launches the hand-written kernel
(``csrc/int8_kernel_probe.cu``) for a CUDA tensor; any other device
raises. ``gemm_*_cuda.launches`` counts the kernel launches, and
``ops.swin_gemm.launches["int8_kernel_probe"]`` the products per path.
``gemm_bf16_loop_cuda``, ``gemm_int8w_loop_cuda`` and
``gemm_int8_loop_cuda`` run each variant on the loops the Swin kernels ran
before (WMMA, int8w's widening on load, ``mma.sync``): the parent that
``chip_smoke.py`` compares against. The kernels take the loops' shapes:
K % 32 == 0 and N % 64 == 0, any M.

The JAX probe hands int8w its codes as integer-valued bf16; here
``gemm_int8w`` takes the int8 codes (K, N) and widens them on the card, the
same function at half the weight bytes. ``gemm_int8`` takes the weight as
a ``Q8Weight`` (codes (N, K), the int8 kernel's layout; scale (1, N)),
transposed once at setup. ``blk`` only tiles the TPU's bf16 and int8w
grids, so those accept it and ignore it; for int8 it defines the scale
groups, and ``M % blk != 0`` raises (the TPU grid of ``M // blk`` steps
would drop the tail rows). ``amax / 127`` is computed as
``amax * float32(1 / 127)``: the JAX body divides by the constant, and XLA
rewrites that division as a multiply by the reciprocal, so this is the
function the JAX package computes.

The driver runs the JAX probe's twelve shapes and prints, after a line with
the card's name and power limit, one JSON line per (shape, variant): ``ms``
and ``tflops`` of the entry point, ``bound_ms`` and ``bound_by``, the
plain version's ``plain_ms``, ``max_abs_err`` against it and its
``max_abs_ref``, and ``lib_ms``,
one library call's time as a yardstick (``torch.matmul`` in bf16 for bf16,
and on the codes widened to bf16 for int8w; ``torch._int_mm`` on the codes
for int8: the GEMM alone). A
failed build or launch raises; nothing is caught.

    python -m computervision_codes_tpu_torch.scripts.int8_kernel_probe
    python -m computervision_codes_tpu_torch.scripts.int8_kernel_probe \\
        --device cpu --tiny
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json

import numpy as np
import torch

from ..ops import swin_gemm
from ..ops.mlp_block import (Q8Weight, aligned, launch_checked, mm_f32,
                             on_card)
from ..utils.timing import bound, device_label, median_ms
from . import on_device

INV127 = float(np.float32(1.0 / 127.0))
K_MULTIPLE, N_MULTIPLE = 32, 64  # the loops' tiles: K % 32, N % 64

# (name, M, K, N, blk): the JAX probe's shapes (its main(), :100-120)
SHAPES = [
    ("MLP1 s3 chunk (1152x768x1024)", 9216, 768, 1024, 1152),
    ("MLP2 s3 chunk (1152x1024x768)", 9216, 1024, 768, 1152),
    ("MLP1 s3 (9216x768x3072)", 9216, 768, 3072, 512),
    ("MLP2 s3 (9216x3072x768)", 9216, 3072, 768, 512),
    ("QKV s3 (288x768x2304)", 9216, 768, 2304, 288),
    ("proj s3 (288x768x768)", 9216, 768, 768, 288),
    ("QKV s2 (576x384x1152)", 36864, 384, 1152, 576),
    ("MLP1 s2 chunk (1152x384x1024)", 36864, 384, 1024, 1152),
    ("MLP2 s2 chunk (1152x1024x384)", 36864, 1024, 384, 1152),
    ("MLP1 s4 chunk (1152x1536x1024)", 2304, 1536, 1024, 1152),
    ("MLP2 s4 chunk (1152x1024x1536)", 2304, 1024, 1536, 1152),
    ("QKV s1 (1152x192x576)", 9216, 192, 576, 1152),
]
# a few small shapes for a CPU run (M = 96 is ragged for the kernels'
# 128-row tiles)
TINY_SHAPES = [("tiny (64x64x64)", 64, 64, 64, 32),
               ("tiny (96x128x128)", 96, 128, 128, 48)]


def gemm_bf16_reference(x, w):
    """bf16(x w) with float32 sums; x (M, K), w (K, N) bf16."""
    return mm_f32(x, w).to(torch.bfloat16)


def gemm_int8w_reference(x, wq, s):
    """bf16((x w) * s) with float32 sums; wq (K, N) int8 codes, s (1, N)
    float32."""
    return (mm_f32(x, wq) * s.float()).to(torch.bfloat16)


def check_blk(m: int, blk: int) -> None:
    """int8's scale groups: ``blk`` rows each, covering every row."""
    if blk <= 0 or m % blk:
        raise ValueError(f"gemm_int8 needs M % blk == 0 (one activation "
                         f"scale per block of blk rows), got M={m}, "
                         f"blk={blk}")


def quantize_blocks(x, blk: int):
    """int8 codes of x (M, K) with one scale per block of ``blk`` rows, in
    the JAX body's order: amax = max|x_blk| + 1e-6, q = round(x * (127 /
    amax)) (half to even). Returns (codes (M, K) int8, amax (M / blk, 1, 1)
    float32)."""
    m, k = x.shape
    check_blk(m, blk)
    xf = x.float().reshape(m // blk, blk, k)
    amax = xf.abs().amax(dim=(1, 2), keepdim=True) + 1e-6
    q = torch.round(xf * (torch.full_like(amax, 127.0) / amax))
    return q.to(torch.int8).reshape(m, k), amax


def gemm_int8_reference(x, w: Q8Weight, blk: int):
    """bf16(acc * ((amax / 127) * s)) per block of ``blk`` rows, acc the
    exact int32 sums of the codes (float64 products, exact at these sizes,
    rounded to float32 as JAX's ``astype``); w codes (N, K)."""
    m, _ = x.shape
    n = w.codes.shape[0]
    q, amax = quantize_blocks(x, blk)
    acc = torch.matmul(q.double(), w.codes.t().double()).float()
    scale = (amax * INV127) * w.scale.float().reshape(1, 1, n)
    out = acc.reshape(m // blk, blk, n) * scale
    return out.to(torch.bfloat16).reshape(m, n)


@functools.cache
def _lib():
    """``csrc/int8_kernel_probe.cu``, built on first use, with its entry
    points' argument types declared."""
    from ..ops._build import load_library

    lib = load_library("int8_kernel_probe")
    for name, pointers, ints in (("probe_gemm_bf16_launch", 4, 3),
                                 ("probe_gemm_bf16_loop_launch", 4, 3),
                                 ("probe_gemm_int8w_launch", 4, 3),
                                 ("probe_gemm_int8w_loop_launch", 4, 3),
                                 ("probe_gemm_int8_launch", 6, 4),
                                 ("probe_gemm_int8_loop_launch", 6, 4)):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _operands(what, x, w, w_dtype, k_first: bool):
    """Checked operands of a kernel: x (M, K) bf16 on a CUDA device; w of
    ``w_dtype`` on the same device, (K, N) when ``k_first``, else (N, K);
    K % 32 == 0 and N % 64 == 0. Returns x, w, M, K, N."""
    on_card(what, x)
    if x.dtype != torch.bfloat16 or x.ndim != 2:
        raise ValueError(f"{what}: x must be (M, K) bfloat16, got "
                         f"{x.dtype} {tuple(x.shape)}")
    m, k = x.shape
    if (w.dtype != w_dtype or w.ndim != 2
            or w.shape[0 if k_first else 1] != k):
        raise ValueError(f"{what}: w must be {w_dtype} "
                         f"{'(K, N)' if k_first else '(N, K)'} with K={k}, "
                         f"got {w.dtype} {tuple(w.shape)}")
    if w.device != x.device:
        raise ValueError(f"{what}: w is on {w.device}; x is on {x.device}")
    n = w.shape[1 if k_first else 0]
    if m == 0 or k % K_MULTIPLE or n % N_MULTIPLE:
        raise ValueError(f"{what} kernel needs M > 0, K % {K_MULTIPLE} == 0 "
                         f"and N % {N_MULTIPLE} == 0, got ({m}, {k}, {n})")
    x, w = aligned(x, w)
    return x, w, m, k, n


def _scale(s, n, x):
    if tuple(s.shape) not in ((1, n), (n,)) or s.device != x.device:
        raise ValueError(f"scale must be (1, {n}) on {x.device}, got "
                         f"{tuple(s.shape)} on {s.device}")
    return s.float().contiguous()


@functools.cache
def _zero_bias(n: int, device: torch.device):
    """The bf16 kernel's bias: zeros (N,), made once per width."""
    return torch.zeros(n, dtype=torch.bfloat16, device=device)


def _bf16(x, w, counter, loop=False):
    x, w, m, k, n = _operands("gemm_bf16", x, w, torch.bfloat16, True)
    out = torch.empty(m, n, dtype=torch.bfloat16, device=x.device)
    lib = _lib()
    launch_checked("gemm_bf16", lib.probe_gemm_bf16_loop_launch if loop
                   else lib.probe_gemm_bf16_launch, x, w,
                   _zero_bias(n, x.device), out, m, n, k)
    counter.launches += 1
    swin_gemm.count("int8_kernel_probe", "bfloat16", [(k, n)], loop)
    return out


def gemm_bf16_cuda(x, w):
    """P1's bf16 kernel on x's device and current stream: the shipped GEMM
    with a zero bias."""
    return _bf16(x, w, gemm_bf16_cuda)


gemm_bf16_cuda.launches = 0


def gemm_bf16_loop_cuda(x, w):
    """P1's bf16 on the WMMA loop: the parent."""
    return _bf16(x, w, gemm_bf16_loop_cuda, loop=True)


gemm_bf16_loop_cuda.launches = 0


def _int8w(x, wq, s, counter, loop=False):
    x, wq, m, k, n = _operands("gemm_int8w", x, wq, torch.int8, True)
    s = _scale(s, n, x)
    out = torch.empty(m, n, dtype=torch.bfloat16, device=x.device)
    lib = _lib()
    launch_checked("gemm_int8w", lib.probe_gemm_int8w_loop_launch if loop
                   else lib.probe_gemm_int8w_launch, x, wq, s, out, m, n, k)
    counter.launches += 1
    swin_gemm.count("int8_kernel_probe", "int8w", [(k, n)], loop)
    return out


def gemm_int8w_cuda(x, wq, s):
    """P1's int8w kernel (the core's bf16 GEMM with the codes widened in
    its B stage): wq (K, N) int8 codes, s (1, N) float32."""
    return _int8w(x, wq, s, gemm_int8w_cuda)


gemm_int8w_cuda.launches = 0


def gemm_int8w_loop_cuda(x, wq, s):
    """P1's int8w on the WMMA loop (widening on load): the parent."""
    return _int8w(x, wq, s, gemm_int8w_loop_cuda, loop=True)


gemm_int8w_loop_cuda.launches = 0


def _int8(x, w: Q8Weight, blk: int, counter, loop=False):
    x, codes, m, k, n = _operands("gemm_int8", x, w.codes, torch.int8,
                                  False)
    check_blk(m, blk)
    s = _scale(w.scale, n, x)
    amax = torch.empty(m // blk, dtype=torch.int32, device=x.device)
    a_codes = torch.empty(m, k, dtype=torch.int8, device=x.device)
    out = torch.empty(m, n, dtype=torch.bfloat16, device=x.device)
    lib = _lib()
    launch_checked("gemm_int8", lib.probe_gemm_int8_loop_launch if loop
                   else lib.probe_gemm_int8_launch, x, codes, s, amax,
                   a_codes, out, m, n, k, blk)
    counter.launches += 1
    swin_gemm.count("int8_kernel_probe", "int8", [(k, n)], loop)
    return out


def gemm_int8_cuda(x, w: Q8Weight, blk: int):
    """P1's int8 kernel (the amax pass, the quantize pass into an (M, K)
    codes scratch, then the s8 wgmma GEMM): w codes (N, K)."""
    return _int8(x, w, blk, gemm_int8_cuda)


gemm_int8_cuda.launches = 0


def gemm_int8_loop_cuda(x, w: Q8Weight, blk: int):
    """P1's int8 on the ``mma.sync`` loop (quantizing on load): the
    parent."""
    return _int8(x, w, blk, gemm_int8_loop_cuda, loop=True)


gemm_int8_loop_cuda.launches = 0


def gemm_bf16(x, w, blk=None):
    """bf16(x w); ``blk`` (the TPU grid's row block) is accepted and
    ignored."""
    return on_device("gemm_bf16", x, lambda: gemm_bf16_reference(x, w),
                     lambda: gemm_bf16_cuda(x, w))


def gemm_int8w(x, wq, s, blk=None):
    """bf16((x w) * s) from int8 codes wq (K, N); ``blk`` is ignored."""
    return on_device("gemm_int8w", x, lambda: gemm_int8w_reference(x, wq, s),
                     lambda: gemm_int8w_cuda(x, wq, s))


def gemm_int8(x, w: Q8Weight, blk: int):
    """Dynamic int8 with one activation scale per ``blk`` rows; ``M % blk
    != 0`` raises on either device."""
    return on_device("gemm_int8", x, lambda: gemm_int8_reference(x, w, blk),
                     lambda: gemm_int8_cuda(x, w, blk))


def probe_inputs(m, k, n, device, seed=0):
    """x (M, K) and w (K, N) standard normal in bf16 from a seeded
    generator on ``device``, and the JAX probe's weight codes (:59-63):
    wq = clip(round(16 w), -127, 127) int8, s = 1/16 per channel."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=device).to(torch.bfloat16)
    w = torch.randn(k, n, generator=g, device=device).to(torch.bfloat16)
    wq = torch.clamp(torch.round(w.float() * 16), -127, 127).to(torch.int8)
    s = torch.full((1, n), 1 / 16.0, dtype=torch.float32, device=device)
    return x, w, wq, s


def work(m, k, n, variant) -> tuple:
    """(operations, bytes, kind) of one call: x, the weight, its scales and
    the output each moved once."""
    w_bytes = {"bf16": 2 * k * n, "int8w": k * n + 4 * n,
               "int8": k * n + 4 * n}[variant]
    kind = "int8" if variant == "int8" else "bf16"
    return 2 * m * k * n, 2 * m * k + w_bytes + 2 * m * n, kind


def run(name, m, k, n, blk=None, device="cuda", iters=32,
        plain_iters=4) -> list:
    """Each variant at one shape: prints and returns a row per variant."""
    blk = blk or m
    x, w, wq, s = probe_inputs(m, k, n, device)
    w8 = Q8Weight(wq.t().contiguous(), s)  # the int8 kernel's layout, once
    wq_bf16 = wq.to(torch.bfloat16)  # the JAX probe's int8w weight
    # the yardstick's int8 operands: the codes of x, and w8's codes as a
    # column-major (K, N) view (cuBLAS's int8 layout)
    codes = quantize_blocks(x, blk)[0]
    fns = {
        "bf16": (lambda: gemm_bf16(x, w, blk),
                 lambda: gemm_bf16_reference(x, w),
                 lambda: torch.matmul(x, w)),
        "int8w": (lambda: gemm_int8w(x, wq, s, blk),
                  lambda: gemm_int8w_reference(x, wq, s),
                  lambda: torch.matmul(x, wq_bf16)),
        "int8": (lambda: gemm_int8(x, w8, blk),
                 lambda: gemm_int8_reference(x, w8, blk),
                 lambda: torch._int_mm(codes, w8.codes.t())),
    }
    rows = []
    for tag, (fn, plain, lib) in fns.items():
        want = plain().float()
        err = (fn().float() - want).abs().max().item()
        ms = median_ms(fn, device, iters)
        ops, nbytes, kind = work(m, k, n, tag)
        row = {"metric": f"{name} {tag}", "ms": ms,
               "tflops": ops / ms / 1e9, **bound(ops, nbytes, kind),
               "max_abs_err": err, "max_abs_ref": want.abs().max().item(),
               "plain_ms": median_ms(plain, device, plain_iters),
               "lib_ms": median_ms(lib, device, iters)}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> list:
    """Every shape of the JAX probe (``--tiny``: small shapes for a CPU
    run) on ``--device``; returns the rows."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="small shapes (a CPU run)")
    ap.add_argument("--iters", type=int, default=32)
    args = ap.parse_args(argv)
    print(device_label(args.device), flush=True)
    rows = []
    for name, m, k, n, blk in TINY_SHAPES if args.tiny else SHAPES:
        rows += run(name, m, k, n, blk, device=args.device, iters=args.iters)
    return rows


if __name__ == "__main__":
    main()
