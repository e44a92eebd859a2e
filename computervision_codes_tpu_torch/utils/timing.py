"""Timing and bounds for the port's probe drivers and ``chip_smoke.py``.

``median_ms`` is the counterpart of the JAX package's
``scripts/swin_roofline.py::timed_scan``: the time of one call of ``fn``,
the median over ``runs`` runs of ``iters`` calls each, after one warm-up
call. On a CUDA device each run is timed with CUDA events recorded on the
current stream around its calls; on the CPU with ``time.perf_counter``, so
that the tests can drive the probes (a CPU time is the CPU's, never a
device number).

What ``timed_scan`` needs and this does not: it chains the calls through a
``lax.scan`` with a perturbed input so that XLA cannot hoist the body out of
the loop, and subtracts a fixed dispatch overhead measured once on an
empty loop. Eager PyTorch runs every call as written, and CUDA events time
the device's own span of the calls, so neither has a counterpart here.

``cuda_ms`` is one such run: the mean device time of ``reps`` calls from
CUDA events, with no warm-up.

``bound`` is the least time the card could take for a piece of work: the
larger of its operations at the published peak for their type and its
bytes (each input read once, each output written once) at the memory rate,
from the NVIDIA H100 SXM data sheet (dense rates); ``bound_mixed`` the same
for operations of several types, whose times at their peaks add up.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import torch

PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, from CUDA events on
    the current stream."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def median_ms(fn, device, iters: int, runs: int = 3) -> float:
    """Milliseconds per call of ``fn`` on ``device``: one warm-up call, then
    the median over ``runs`` of the mean of ``iters`` calls."""
    device = torch.device(device)
    fn()
    means = []
    for _ in range(runs):
        if device.type == "cuda":
            means.append(cuda_ms(fn, iters))
        elif device.type == "cpu":
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            means.append(1e3 * (time.perf_counter() - t0) / iters)
        else:
            raise ValueError(f"median_ms times CPU or CUDA work, got {device}")
    return statistics.median(means)


def bound(ops: float, nbytes: float, kind: str) -> dict:
    """``bound_ms`` (to 1e-6 ms) and ``bound_by`` ("operations" or "bytes")
    of work of ``ops`` operations of ``kind`` (a key of ``PEAK_OPS_S``) that
    moves ``nbytes``."""
    return bound_mixed({kind: ops}, nbytes)


def bound_mixed(ops: dict, nbytes: float) -> dict:
    """``bound`` for work of several kinds (kind -> operations)."""
    t_ops = sum(n / PEAK_OPS_S[kind] for kind, n in ops.items())
    t_bytes = nbytes / PEAK_BYTES_S
    return {"bound_ms": round(1e3 * max(t_ops, t_bytes), 6),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def device_label(device) -> str:
    """The line a probe prints first: for a CUDA device the card's name and
    power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them (raises if it fails), else the
    device's name."""
    device = torch.device(device)
    if device.type != "cuda":
        return f"{device.type} (no card: times are host times)"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return smi.stdout.strip().splitlines()[index]
