"""P1's weight-only int8 product in one launch against two, on the card.

One launch is the shipped kernel (``int8_kernel_probe.gemm_int8w_cuda``):
the Swin GEMM core whose producer warpgroup widens each stage's int8 codes
into the bf16 B stage in shared memory. Two launches
(``csrc/int8w_split_probe.cu``, for timing only) widen the whole (K, N)
weight into a bf16 scratch in device memory, then run the core's bf16
product with the same scale epilogue over it. Both give the same bits (the
same bf16 values through the same wgmma sums), which this checks at each of
P1's twelve shapes before it times, in turns (a, b, ..., b, a), the one
launch, the two, each of the two alone, and the core's bf16 product on the
widened codes. Prints ptxas' registers of the int8w kernels, then the
card's name and power limit, then one JSON line per shape. Exits 1 when a
check fails. Needs a CUDA card.

    python3 -m computervision_codes_tpu_torch.scripts.int8w_split_probe
"""

from __future__ import annotations

import ctypes
import functools
import json
import re
import statistics
import sys

import torch

from ..ops import _build
from ..ops.mlp_block import launch_checked
from ..utils.timing import bound, cuda_ms, device_label
from . import int8_kernel_probe as p1

REPS = 20


@functools.cache
def _lib():
    lib = _build.load_library("int8w_split_probe")
    lib.int8w_widen_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_longlong, ctypes.c_void_p]
    lib.int8w_gemm_scale_launch.argtypes = ([ctypes.c_void_p] * 4
                                            + [ctypes.c_int] * 3
                                            + [ctypes.c_void_p])
    for fn in (lib.int8w_widen_launch, lib.int8w_gemm_scale_launch):
        fn.restype = ctypes.c_int
    return lib


def widen_cuda(wq):
    """The codes (K, N) int8 as bf16, by the widen pass."""
    out = torch.empty(wq.shape, dtype=torch.bfloat16, device=wq.device)
    launch_checked("int8w widen", _lib().int8w_widen_launch, wq, out,
                   wq.numel())
    return out


def gemm_scale_cuda(x, w, s):
    """bf16((x w) * s) on the core, w (K, N) bf16."""
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty(m, n, dtype=torch.bfloat16, device=x.device)
    launch_checked("int8w gemm_scale", _lib().int8w_gemm_scale_launch, x, w,
                   s, out, m, n, k)
    return out


def in_turns(fns: dict) -> dict:
    """Median ms of each of ``fns`` over two runs of REPS calls, in the
    order a, b, ..., b, a after a warm-up."""
    for fn in fns.values():
        cuda_ms(fn, 2)
    runs = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        runs[name].append(cuda_ms(fns[name], REPS))
    return {name: statistics.median(v) for name, v in runs.items()}


def registers() -> list:
    """ptxas' registers and spills of the int8w kernels built in this
    process."""
    rows, current = [], None
    for line in _build.build_logs.get("int8_kernel_probe", "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = m.group(1)
        elif current and "Int8wOp" in current and (
                "registers" in line or "spill" in line):
            rows.append(f"{current}: {line.strip()}")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("int8w_split_probe needs a CUDA card", file=sys.stderr)
        return 1
    _build.build(["int8_kernel_probe", "int8w_split_probe"])
    for row in registers():
        print(row)
    print(device_label("cuda"), flush=True)
    failed = False
    for name, m, k, n, _ in p1.SHAPES:
        x, _, wq, s = p1.probe_inputs(m, k, n, "cuda", 99)
        wide = wq.to(torch.bfloat16)
        one = p1.gemm_int8w_cuda(x, wq, s)
        two = gemm_scale_cuda(x, widen_cuda(wq), s)
        same = (torch.equal(widen_cuda(wq), wide) and torch.equal(one, two))
        failed |= not same
        ms = in_turns({
            "one launch": lambda: p1.gemm_int8w_cuda(x, wq, s),
            "two launches": lambda: gemm_scale_cuda(x, widen_cuda(wq), s),
            "widen pass": lambda: widen_cuda(wq),
            "product on the widened codes": lambda: gemm_scale_cuda(x, wide,
                                                                    s),
            "bf16 core": lambda: p1.gemm_bf16_cuda(x, wide)})
        print(json.dumps({"metric": name, "equal": same, "ms": ms,
                          **bound(2 * m * k * n,
                                  2 * m * k + k * n + 4 * n + 2 * m * n,
                                  "bf16")}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
