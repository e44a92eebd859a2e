"""K1 and K2 on the card: each design against the plain version, then
timed in turns (new, previous, plain, plain, previous, new).

    python3 -m computervision_codes_tpu_torch.scripts.k1_k2_probe [--check]

Builds ``csrc/dilated_residual.cu`` and ``csrc/stem_pool.cu`` from the
checkout it runs in, prints ptxas' registers and spills, checks both
designs of each kernel at the main path's shapes and a few ragged ones
(bf16: K1 within 8 bf16 ulps of max|ref|, K2 within one; float32 1e-4 and
2e-5), and, unless ``--check``, prints one JSON line per timed shape with
the median ms of each design beside the plain version's and the card's
name and power limit. Exits 1 when a check fails. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch

from ..ops import _build
from ..ops.dilated_conv import (dilated_residual_cuda,
                                dilated_residual_prev_cuda,
                                dilated_residual_reference)
from ..ops.stem_pool import (stem_pool_cuda, stem_pool_prev_cuda,
                             stem_pool_reference)
from ..utils.timing import cuda_ms

K1_REL = {torch.bfloat16: 8 * 2.0 ** -8, torch.float32: 1e-4}
K1_CHECK = [(4, 256, 512, d, causal) for d in (1, 16, 1024)
            for causal in (False, True)] + [
    (1, 256, 512, 16, True), (16, 256, 512, 1024, True), (3, 37, 512, 16,
                                                          False),
    (1, 1, 512, 1, True), (2, 300, 128, 128, False), (2, 300, 1024, 4, True),
    (2, 70, 256, 3, False), (1, 130, 384, 2, True), (1, 90, 640, 5, False),
    (72, 64, 128, 3, True)]
K1_TIMED = [(4, 256, 512, 1, False), (4, 256, 512, 16, False),
            (4, 256, 512, 1024, False), (1, 256, 512, 16, True),
            (1, 256, 512, 1024, True), (16, 256, 512, 16, True),
            (16, 256, 512, 1024, True)]
K2_CHECK = [(1, 256, 448), (4, 256, 448), (64, 256, 448), (2, 32, 56),
            (2, 16, 16), (2, 24, 40), (9, 16, 16), (22, 16, 16), (3, 20, 12),
            (1, 16, 1040)]
K2_TIMED = [(1, 256, 448), (64, 256, 448), (1024, 256, 448)]


def layer_inputs(b, t, c, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, t, c, generator=g)
    w_taps = torch.randn(3, c, c, generator=g) / (3 * c) ** 0.5
    b1 = 0.1 * torch.randn(c, generator=g)
    w2 = torch.randn(c, c, generator=g) / c ** 0.5
    b2 = 0.1 * torch.randn(c, generator=g)
    return [a.to("cuda", dtype) for a in (x, w_taps, b1, w2, b2)]


def stem_inputs(n, h, w, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, h, w, 3, generator=g, device="cuda").to(dtype)
    wt = (0.1 * torch.randn(7, 7, 3, 64, generator=g, device="cuda")
          ).to(dtype)
    return x, wt, 0.5 * torch.randn(64, generator=g, device="cuda")


def bf16_ulp(top: float) -> float:
    return 2.0 ** (torch.tensor(max(top, 1e-30)).log2().floor().item() - 7)


def check_k1() -> bool:
    ok = True
    for seed, (b, t, c, d, causal) in enumerate(K1_CHECK):
        for dtype in (torch.bfloat16, torch.float32):
            args = layer_inputs(b, t, c, dtype, seed)
            want = dilated_residual_reference(*args, d, causal).float()
            tol = K1_REL[dtype] * max(1.0, want.abs().max().item())
            for name, fn in (("new", dilated_residual_cuda),
                             ("prev", dilated_residual_prev_cuda)):
                got = fn(*args, d, causal)
                torch.cuda.synchronize()
                err = (got.float() - want).abs().max().item()
                good = bool(torch.isfinite(got).all()) and err <= tol
                ok &= good
                print(f"[k1] {name} {str(dtype)[6:]} {(b, t, c, d, causal)}:"
                      f" max_abs_err {err:.3g} tol {tol:.3g}"
                      f"{'' if good else '  FAIL'}", flush=True)
    return ok


def check_k2() -> bool:
    ok = True
    for seed, (n, h, w) in enumerate(K2_CHECK):
        for dtype in (torch.bfloat16, torch.float32):
            args = stem_inputs(n, h, w, dtype, seed)
            want = stem_pool_reference(*args).float()
            top = want.abs().max().item()
            tol = 2e-5 if dtype == torch.float32 else bf16_ulp(top)
            for name, fn in (("new", stem_pool_cuda),
                             ("prev", stem_pool_prev_cuda)):
                got = fn(*args)
                torch.cuda.synchronize()
                err = (got.float() - want).abs().max().item()
                good = bool(torch.isfinite(got).all()) and err <= tol
                ok &= good
                print(f"[k2] {name} {str(dtype)[6:]} {(n, h, w)}: max_abs_err"
                      f" {err:.3g} tol {tol:.3g}{'' if good else '  FAIL'}",
                      flush=True)
    return ok


def kernel_ms(fn, reps: int, names) -> float:
    """Mean device time per call of the kernels whose names contain one of
    ``names``, under torch.profiler over ``reps`` calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0)
             for e in prof.key_averages()
             if any(n in e.key for n in names))
    return round(us / reps / 1e3, 5)


def in_turns(fns: dict, reps: int) -> dict:
    for fn in fns.values():
        cuda_ms(fn, 2)
    runs = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        runs[k].append(cuda_ms(fns[k], reps))
    return {k: sorted(v)[len(v) // 2] for k, v in runs.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="check only, no timings")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build(["dilated_residual", "stem_pool"])
    for name in ("dilated_residual", "stem_pool"):
        for line in _build.build_logs.get(name, "").splitlines():
            if any(k in line for k in ("Compiling entry", "registers",
                                       "spill", "arning", "erformance")):
                print(f"[build] {name}: {line.strip()}")
    lib = _build.load_library("dilated_residual")
    for b, t, c in ((1, 256, 128), (4, 256, 512), (1, 256, 512),
                    (16, 256, 512), (2, 300, 1024)):
        out = (ctypes.c_int * 4)()
        err = lib.dilated_residual_plan(b, t, c, out)
        print(f"[k1] {(b, t, c)}: slice, cluster, stages, clusters of 64 "
              f"columns resident {list(out)} (error {err})")
    ok = check_k1() and check_k2()
    if not ok:
        print("FAIL", file=sys.stderr)
        return 1
    if args.check:
        return 0
    for b, t, c, d, causal in K1_TIMED:
        a = layer_inputs(b, t, c, torch.bfloat16, 99)
        ms = in_turns({
            "new": lambda: dilated_residual_cuda(*a, d, causal),
            "prev": lambda: dilated_residual_prev_cuda(*a, d, causal),
            "plain": lambda: dilated_residual_reference(*a, d, causal)}, 50)
        dev = {"new": kernel_ms(lambda: dilated_residual_cuda(*a, d, causal),
                                20, ["k1_kernel"]),
               "prev": kernel_ms(
                   lambda: dilated_residual_prev_cuda(*a, d, causal), 20,
                   ["dilated_residual_kernel"])}
        print(json.dumps({"kernel": "K1", "shape": [b, t, c], "d": d,
                          "causal": causal, "ms": ms, "device_ms": dev,
                          "card": card}), flush=True)
    for n, h, w in K2_TIMED:
        a = stem_inputs(n, h, w, torch.bfloat16, 99)
        reps = 5 if n >= 1024 else 20
        ms = in_turns({"new": lambda: stem_pool_cuda(*a),
                       "prev": lambda: stem_pool_prev_cuda(*a),
                       "plain": lambda: stem_pool_reference(*a)}, reps)
        dev = {"new": kernel_ms(lambda: stem_pool_cuda(*a), reps,
                                ["stem_wgmma_kernel"]),
               "prev": kernel_ms(lambda: stem_pool_prev_cuda(*a), reps,
                                 ["stem_pool_kernel"])}
        print(json.dumps({"kernel": "K2", "shape": [n, h, w], "ms": ms,
                          "device_ms": dev, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
