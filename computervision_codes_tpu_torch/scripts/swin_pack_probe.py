"""Probe (P2): how many heads of a window one attention program should own.

Counterpart of the JAX package's ``scripts/swin_pack_probe.py``, which
times three formulations of K3's function on the TPU at Swin-L stage-1 and
stage-3 shapes: y = x + proj(window_MHSA(LN(x))), unshifted, no mask,
x (B, Hp, Wp, C) bf16, head_dim 32, window 12:

  loop     one program per (window, head): the port's K3
           (``ops.window_mhsa.window_mhsa_fused``);
  pack<g>  one program per (window, group of g heads): ``mhsa_pack``
           (g = 1 added here);
  batched  one program per window over every head: ``mhsa_batched``.

All three compute one function, whose plain version is
``ops.window_mhsa.window_mhsa_reference(..., mask=None)``. ``mhsa_pack``
and ``mhsa_batched`` take the plain version for a CPU tensor and launch
the hand-written kernel (``csrc/swin_pack_probe.cu``: K3's phases, its
products on the Swin GEMM core, around an attention phase of one block per
(window, group)) for a CUDA tensor;
any other device raises. ``mhsa_pack_cuda.launches`` and
``mhsa_batched_cuda.launches`` count the launches. The kernel takes bf16
(the probe's dtype) and any window up to 12: a window of 7 (N = 49) is
masked at its real size, as K3 masks it.

A block stages its heads' q, k and v in shared memory; more heads than fit
are staged in chunks, one after another. The kernel chooses the chunk (the
largest divisor of the group that fits the card's shared memory per
block); ``staged_heads`` asks it which, for the driver's rows.
``mhsa_pack_cuda`` and ``mhsa_batched_cuda`` take ``res_add=False`` as
K3's ``window_mhsa_cuda`` does: the attention half without the residual,
which a check compares where the residual would hide it.

The driver runs the JAX probe's two stages and prints, after a line with
the card's name and power limit, one JSON line per formulation: ``ms``,
``tflops``, ``bound_ms`` and ``bound_by`` of the whole function,
``max_abs_err`` against the plain version, its ``max_abs_ref`` and its
``plain_ms``; pack and batched rows also give the heads per block and
the blocks launched, and on the card the heads staged at once. A failed
build or launch raises; nothing is caught.

    python -m computervision_codes_tpu_torch.scripts.swin_pack_probe
    python -m computervision_codes_tpu_torch.scripts.swin_pack_probe \\
        --device cpu --tiny
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json

import torch

from ..models.swin import _relative_position_index
from ..ops import swin_gemm
from ..ops.mlp_block import launch_checked
from ..ops.window_mhsa import (HEAD_DIM, attention_operands, attn_products,
                               window_mhsa_fused, window_mhsa_reference)
from ..utils.timing import bound, device_label, median_ms
from . import on_device

# (name, B, H = W, C, heads, groups): the JAX probe's stages and groups
# (:255-258), each with g = 1 besides: the same kernel at one head per
# block, which tells the gain of grouping heads from that of the kernel's
# scores in registers (the loop, K3, keeps them in shared memory)
STAGES = [("MHSA stage1 (96^2, c=192, h=6)", 16, 96, 192, 6, (1, 2, 3, 6)),
          ("MHSA stage3 (24^2, c=768, h=24)", 16, 24, 768, 24, (1, 4, 8))]
WINDOW = 12
# a small stage for a CPU run
TINY_STAGES = [("MHSA tiny (8^2, c=128, h=4)", 1, 8, 128, 4, (1, 2, 4))]
TINY_WINDOW = 4


@functools.cache
def _lib():
    """``csrc/swin_pack_probe.cu`` (built on first use), with its entry
    points' argument types declared."""
    from ..ops._build import load_library

    lib = load_library("swin_pack_probe")
    for fn in (lib.swin_pack_launch, lib.swin_pack_loop_launch):
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.swin_pack_chunk.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.swin_pack_chunk.restype = ctypes.c_int
    return lib


def staged_heads(group: int, window: int) -> int:
    """Heads whose q, k and v the kernel stages at once for a block of
    ``group`` heads on the current CUDA device (the kernel's own choice);
    raises if it reports an error or that no head fits."""
    chunk = _lib().swin_pack_chunk(group, window)
    if chunk <= 0:
        raise RuntimeError(f"swin_pack_chunk({group}, {window}) returned "
                           f"{chunk}")
    return chunk


def _launch(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, *, window,
            num_heads, group, res_add, counter, loop=False):
    """Launch ``csrc/swin_pack_probe.cu`` with ``group`` heads per block on
    x's device and current stream (``loop``: its QKV and proj products on
    the WMMA loop); add one to ``counter.launches`` and the two products to
    ``swin_gemm.launches``."""
    (x, wqkv, bqkv, wproj, bproj, bias), _, (gamma, beta) = \
        attention_operands("swin_pack_probe", x, gamma, beta, wqkv, bqkv,
                           wproj, bproj, bias, None, window, num_heads)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"swin_pack_probe kernel takes bfloat16, got "
                        f"{x.dtype}")
    b, hp, wp, c = x.shape
    m = b * hp * wp
    y = torch.empty_like(x)
    qkv = torch.empty(m, 3 * c, dtype=x.dtype, device=x.device)
    attn = torch.empty(m, c, dtype=x.dtype, device=x.device)
    stats = torch.empty(m, 2, dtype=torch.float32, device=x.device)
    lib = _lib()
    launch_checked("swin_pack_probe",
                   lib.swin_pack_loop_launch if loop else lib.swin_pack_launch,
                   x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, qkv, attn,
                   stats, y, b, hp, wp, c, num_heads, window, group,
                   HEAD_DIM ** -0.5, int(res_add))
    counter.launches += 1
    swin_gemm.count("swin_pack_probe", "bfloat16", attn_products(c), loop)
    return y


def check_group(num_heads: int, group: int) -> None:
    if group <= 0 or num_heads % group:
        raise ValueError(f"mhsa_pack needs group to divide num_heads, got "
                         f"group={group}, num_heads={num_heads}")


def mhsa_pack_cuda(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, *,
                   window: int, num_heads: int, group: int,
                   res_add: bool = True):
    """P2's pack<g>: one block per (window, group of ``group`` heads);
    ``res_add=False`` returns the branch without the residual."""
    check_group(num_heads, group)
    return _launch(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                   window=window, num_heads=num_heads, group=group,
                   res_add=res_add, counter=mhsa_pack_cuda)


mhsa_pack_cuda.launches = 0


def mhsa_batched_cuda(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, *,
                      window: int, num_heads: int, res_add: bool = True):
    """P2's batched: one block per window over every head."""
    return _launch(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                   window=window, num_heads=num_heads, group=num_heads,
                   res_add=res_add, counter=mhsa_batched_cuda)


mhsa_batched_cuda.launches = 0


def mhsa_pack_loop_cuda(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, *,
                        window: int, num_heads: int, group: int,
                        res_add: bool = True):
    """``mhsa_pack_cuda`` with its QKV and proj products on the WMMA loop:
    the parent that ``chip_smoke.py`` times against."""
    check_group(num_heads, group)
    return _launch(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                   window=window, num_heads=num_heads, group=group,
                   res_add=res_add, counter=mhsa_pack_loop_cuda, loop=True)


mhsa_pack_loop_cuda.launches = 0


def mhsa_pack(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, *,
              window: int, num_heads: int, group: int):
    """y = x + proj(window_MHSA(LN(x))), heads in groups of ``group`` per
    program (on the card); ``group`` must divide ``num_heads``."""
    check_group(num_heads, group)
    args = (x, gamma, beta, wqkv, bqkv, wproj, bproj, bias)
    return on_device(
        "mhsa_pack", x,
        lambda: window_mhsa_reference(*args, None, window=window,
                                      num_heads=num_heads),
        lambda: mhsa_pack_cuda(*args, window=window, num_heads=num_heads,
                               group=group))


def mhsa_batched(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, *,
                 window: int, num_heads: int):
    """The same function, every head of a window in one program (on the
    card)."""
    args = (x, gamma, beta, wqkv, bqkv, wproj, bproj, bias)
    return on_device(
        "mhsa_batched", x,
        lambda: window_mhsa_reference(*args, None, window=window,
                                      num_heads=num_heads),
        lambda: mhsa_batched_cuda(*args, window=window, num_heads=num_heads))


def stage_inputs(b, hw, c, heads, w, device, seed=0, table_std=0.02):
    """x and the attention half's operands as the JAX probe builds them
    (:208-222), from a seeded generator on ``device``: x standard normal,
    gamma 1, beta 0.01 (float32), weights N(0, 1/C), biases N(0, 0.01^2),
    a relative-position table N(0, ``table_std``^2) (the probe's 0.02)
    gathered into the (heads, N, N) bias; all but gamma and beta in bf16.
    Returns (x, operands)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape):
        return torch.randn(*shape, generator=g, device=device)

    bf16 = torch.bfloat16
    n = w * w
    x = normal(b, hw, hw, c).to(bf16)
    gamma = torch.ones(c, device=device)
    beta = torch.full((c,), 0.01, device=device)
    wqkv = (normal(c, 3 * c) * c ** -0.5).to(bf16)
    bqkv = (normal(3 * c) * 0.01).to(bf16)
    wproj = (normal(c, c) * c ** -0.5).to(bf16)
    bproj = (normal(c) * 0.01).to(bf16)
    table = normal((2 * w - 1) ** 2, heads) * table_std
    idx = torch.as_tensor(_relative_position_index(w).reshape(-1),
                          device=device)
    bias = table[idx].reshape(n, n, heads).permute(2, 0, 1).to(bf16)
    return x, (gamma, beta, wqkv, bqkv, wproj, bproj, bias)


def work(b, hw, c, heads, w) -> tuple:
    """(operations, bytes) of the function: the QKV, score, P V and proj
    products; x in, y out, the weights, biases and relative-position bias
    each moved once (bf16; LayerNorm vectors float32)."""
    m, n = b * hw * hw, w * w
    ops = 2 * m * c * 3 * c + 2 * m * c * c + 4 * m * n * c
    nbytes = 2 * (2 * m * c + 4 * c * c + 4 * c + heads * n * n) + 8 * c
    return ops, nbytes


def run_stage(name, b, hw, c, heads, groups, w=WINDOW, device="cuda",
              iters=32, plain_iters=2) -> list:
    """loop, each pack<g> and batched at one stage: prints and returns a
    row per formulation."""
    x, ops_args = stage_inputs(b, hw, c, heads, w, device)
    kw = dict(window=w, num_heads=heads)
    want = window_mhsa_reference(x, *ops_args, None, **kw)
    plain_ms = median_ms(lambda: window_mhsa_reference(x, *ops_args, None,
                                                       **kw),
                         device, plain_iters)
    ops, nbytes = work(b, hw, c, heads, w)
    windows = b * (hw // w) ** 2
    fns = {"loop": (lambda: window_mhsa_fused(x, *ops_args, None, **kw), 1)}
    for g in groups:
        fns[f"pack{g}"] = (lambda g=g: mhsa_pack(x, *ops_args, group=g,
                                                 **kw), g)
    fns["batched"] = (lambda: mhsa_batched(x, *ops_args, **kw), heads)
    rows = []
    for tag, (fn, g) in fns.items():
        err = (fn().float() - want.float()).abs().max().item()
        ms = median_ms(fn, device, iters)
        row = {"metric": f"{name} {tag}", "ms": ms,
               "tflops": ops / ms / 1e9, **bound(ops, nbytes, "bf16"),
               "max_abs_err": err,
               "max_abs_ref": want.float().abs().max().item(),
               "plain_ms": plain_ms}
        if tag != "loop":
            row |= {"heads_per_block": g, "blocks": windows * heads // g}
            if torch.device(device).type == "cuda":
                row["staged_heads"] = staged_heads(g, w)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> list:
    """Both stages of the JAX probe (``--tiny``: a small stage for a CPU
    run) on ``--device``; returns the rows."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="a small stage (a CPU run)")
    ap.add_argument("--iters", type=int, default=32)
    args = ap.parse_args(argv)
    print(device_label(args.device), flush=True)
    rows = []
    w = TINY_WINDOW if args.tiny else WINDOW
    for name, b, hw, c, heads, groups in (TINY_STAGES if args.tiny
                                          else STAGES):
        rows += run_stage(name, b, hw, c, heads, groups, w,
                          device=args.device, iters=args.iters)
    return rows


if __name__ == "__main__":
    main()
