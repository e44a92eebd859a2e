#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
and nvcc. Imports torch, numpy and the port only (no JAX). Phases, each
printing its own lines:

1. device: the card's name and power limit (nvidia-smi); float32 checks
   run with TF32 off in cuDNN and cuBLAS;
2. build: every kernel of the path from the checkout's sources (timed);
3. kernels: each kernel against its plain PyTorch version on the card, at
   every (dilation, causal) pair of the main path, B=4, T=256, C=512, in
   bf16 and float32, plus ragged shapes; and its time beside the plain
   version's;
4. model: the full-width float32 EndToEndRecognizer (ResNet18, 11 + 3x10
   TCN layers, 512 maps) on the card against the same module and weights
   on the CPU, on a (1, 16, 256, 448, 3) clip;
5. offline serving: InferenceSession (bf16) at 4 x 256 frames of 256x448,
   uint8 input: shapes, range, kernel launches per predict, ms, frames/s;
6. streaming: StreamingSession at context 256, streams 1 and 16;
7. breakdown: input, backbone and TCN time of one offline forward and
   of one push.

Then one JSON line with the kernels, and the last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero and the
last line is not printed. Without a CUDA card, or outside a checkout, it
exits non-zero at once.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
PACKAGE = "computervision_codes_tpu_torch"
DEVICE = "cuda"
KERNEL_SOURCE = f"{PACKAGE}/csrc/dilated_residual.cu"
KERNEL_REPLACES = "computervision_codes_tpu/ops/dilated_conv.py:88"
LAYERS_PER_FORWARD = 11 + 3 * 10  # dilated layers of the default TCN
# the serving geometry: (B, T, H, W) offline, K1 at (B, T, C)
OFFLINE = (4, 256, 256, 448)
LAYER = (4, 256, 512)
MODEL_CLIP = (1, 16, 256, 448)
STREAM_CONTEXT, STREAM_COUNTS, PUSHES = 256, (1, 16), 8
# bf16 keeps 8 significant bits; the plain bf16 version rounds about six
# times per element, the kernel twice, so allow 8 ulps at the output's
# largest magnitude. float32: sums of up to 1536 products taken in another
# order, far inside 1e-4 relative to the largest magnitude.
REL_TOL = {torch.bfloat16: 8 * 2.0 ** -8, torch.float32: 1e-4}
# full model, float32, card vs CPU: 17 convolutions and 41 residual layers
# with sums in another order (and other cuDNN algorithms)
MODEL_REL_TOL = 1e-3
TASK_SIZES = {"ivt": 100, "i": 6, "v": 10, "t": 15}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, from CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def layer_inputs(b, t, c, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, t, c, generator=g)
    w_taps = torch.randn(3, c, c, generator=g) / (3 * c) ** 0.5
    b1 = 0.1 * torch.randn(c, generator=g)
    w2 = torch.randn(c, c, generator=g) / c ** 0.5
    b2 = 0.1 * torch.randn(c, generator=g)
    return [a.to(DEVICE, dtype) for a in (x, w_taps, b1, w2, b2)]


def check_probs(probs: dict, lead: tuple, what: str) -> None:
    for k, n in TASK_SIZES.items():
        p = probs[k]
        check(p.shape == lead + (n,), f"{what} {k}: shape {p.shape}")
        check(bool(np.isfinite(p).all()), f"{what} {k}: non-finite")
        check(bool(((p >= 0) & (p <= 1)).all()), f"{what} {k}: outside [0,1]")


def timed_call(fn):
    """(result, ms) of one call that ends synchronised, from CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(f"[device] {torch.cuda.get_device_name(0)}; count "
          f"{torch.cuda.device_count()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; float32 checks with TF32 off "
          f"(cudnn.allow_tf32=False, matmul precision 'highest')")
    return card


def phase_build() -> None:
    from computervision_codes_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library("dilated_residual")
    print(f"[build] dilated_residual.cu -> "
          f"{_build.library_path('dilated_residual').name} in "
          f"{time.perf_counter() - t0:.2f} s")
    for line in _build.build_logs.get("dilated_residual", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] ptxas: {line.strip()}")


def phase_kernels(card: str) -> dict:
    from computervision_codes_tpu_torch.ops.dilated_conv import (
        dilated_residual_cuda, dilated_residual_reference)

    b0, t0, c = LAYER
    cases = [(b0, t0, 2 ** i, causal) for causal in (False, True)
             for i in range(11)]
    # ragged: T not a multiple of the 32-row tile, T = 1, B = 3, d >= T
    cases += [(b, t, d, causal) for causal in (False, True)
              for b, t, d in ((3, 37, 1), (3, 37, 16), (3, 37, 64),
                              (1, 1, 1), (1, 1, 1024), (2, 300, 128))]
    worst_main = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        worst = (0.0, None)
        for n, (b, t, d, causal) in enumerate(cases):
            args = layer_inputs(b, t, c, dtype, seed=n)
            got = dilated_residual_cuda(*args, d, causal)
            want = dilated_residual_reference(*args, d, causal)
            check(bool(torch.isfinite(got).all()),
                  f"K1 non-finite output {dtype} b={b} t={t} d={d}")
            err = (got.float() - want.float()).abs().max().item()
            tol = REL_TOL[dtype] * max(1.0, want.float().abs().max().item())
            check(err <= tol, f"K1 {dtype} b={b} t={t} d={d} causal={causal}"
                              f": max_abs_err {err} > tol {tol}")
            if err / tol >= worst[0]:
                worst = (err / tol, (b, t, d, causal, err, tol))
            if dtype == torch.bfloat16 and (b, t) == (b0, t0):
                worst_main = max(worst_main, err)
        print(f"[kernels] K1 {str(dtype)[6:]}: {len(cases)} cases within "
              f"tolerance ({REL_TOL[dtype]:g} x max|ref|); worst "
              f"(b, t, d, causal, err, tol) = {worst[1]}")

    # times at the offline shape in both dtypes, and at the streaming
    # shapes (B = streams) in bf16; kernel and plain in turns
    times = {}
    for b, dtype in ((b0, torch.bfloat16), (b0, torch.float32),
                     *((s, torch.bfloat16) for s in STREAM_COUNTS)):
        args = layer_inputs(b, t0, c, dtype, seed=99)
        fns = {"kernel": lambda: dilated_residual_cuda(*args, 16, False),
               "plain": lambda: dilated_residual_reference(*args, 16, False)}
        for fn in fns.values():
            cuda_ms(fn, 5)  # warm up
        runs = {"kernel": [], "plain": []}
        for name in ("plain", "kernel", "kernel", "plain"):
            runs[name].append(cuda_ms(fns[name], 50))
        times[b, dtype] = {k: float(np.median(v)) for k, v in runs.items()}
        kern_ms = times[b, dtype]["kernel"]
        print(f"[kernels] K1 time {str(dtype)[6:]} B={b} T={t0} C={c} d=16:"
              f" kernel {kern_ms:.4f} ms "
              f"({8 * b * t0 * c * c / kern_ms / 1e9:.1f} TFLOP/s), plain "
              f"{times[b, dtype]['plain']:.4f} ms; runs {runs}; {card}")
    return {"max_abs_err": worst_main,
            "ms": times[b0, torch.bfloat16]["kernel"],
            "plain_ms": times[b0, torch.bfloat16]["plain"]}


def phase_model() -> None:
    from computervision_codes_tpu_torch.models.pipeline import (
        EndToEndRecognizer)

    cpu_model = EndToEndRecognizer(
        dtype=torch.float32,
        generator=torch.Generator().manual_seed(0)).eval()
    dev_model = copy.deepcopy(cpu_model).to(DEVICE)
    rng = np.random.default_rng(0)
    clip = torch.from_numpy(
        rng.standard_normal(MODEL_CLIP + (3,)).astype(np.float32))
    with torch.inference_mode():
        t0 = time.perf_counter()
        want = cpu_model(clip)
        t_cpu = time.perf_counter() - t0
        got = {k: v.cpu() for k, v in dev_model(clip.to(DEVICE)).items()}
    for k in ("ivt", "i", "v", "t", "features"):
        g, w = got[k], want[k]
        check(g.shape == w.shape, f"model {k}: shape {g.shape} != {w.shape}")
        check(bool(torch.isfinite(g).all()), f"model {k}: non-finite")
        err = (g - w).abs().max().item()
        scale = max(1.0, w.abs().max().item())
        check(err <= MODEL_REL_TOL * scale,
              f"model {k}: card vs CPU max_abs_err {err} > "
              f"{MODEL_REL_TOL} x {scale}")
        print(f"[model] float32 {k} {tuple(g.shape)}: card vs CPU max_abs_err "
              f"{err:.3e} (max|ref| {scale:.3f}, tol {MODEL_REL_TOL:g} x "
              f"max|ref|)")
    print(f"[model] CPU forward {t_cpu:.2f} s (host clock)")


def phase_offline(card: str, launches):
    from computervision_codes_tpu_torch.serving import InferenceSession

    b, t, h, w = OFFLINE
    sess = InferenceSession.create(batch=b, clip_len=t, height=h, width=w,
                                   device=DEVICE)
    base = np.random.default_rng(1).integers(0, 256, (b, t, h, w, 3),
                                             dtype=np.uint8)
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for call in range(4):  # call 0 warms up (cuDNN plans, allocator)
        clips = base + np.uint8(call)  # a different clip per call
        before = launches()
        probs, call_ms = timed_call(lambda: sess.predict(clips))
        ms.append(call_ms)
        check(launches() - before == LAYERS_PER_FORWARD,
              f"predict {call}: {launches() - before} K1 launches, want "
              f"{LAYERS_PER_FORWARD}")
        check_probs(probs, (b, t), f"predict {call}")
    steady = float(np.median(ms[1:]))
    print(f"[offline] InferenceSession bf16 {b}x{t} frames {h}x{w} uint8: "
          f"{LAYERS_PER_FORWARD} K1 launches per predict; ms per predict "
          f"{[round(m, 3) for m in ms]} (first warms up); median "
          f"{steady:.3f} ms = {b * t / steady * 1e3:.1f} frames/s; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB; {card}")
    return sess, base


def phase_streaming(card: str, launches) -> list:
    from computervision_codes_tpu_torch.serving import StreamingSession

    _, _, h, w = OFFLINE
    rng = np.random.default_rng(2)
    sessions = []
    for streams in STREAM_COUNTS:
        sess = StreamingSession.create(context=STREAM_CONTEXT, height=h,
                                       width=w, streams=streams,
                                       device=DEVICE)
        frames = rng.integers(0, 256, (PUSHES, streams, h, w, 3),
                              dtype=np.uint8)
        ms = []
        for i in range(PUSHES):
            before = launches()
            probs, push_ms = timed_call(lambda: sess.push(frames[i]))
            ms.append(push_ms)
            check(launches() - before == LAYERS_PER_FORWARD,
                  f"push {i}: {launches() - before} K1 launches, want "
                  f"{LAYERS_PER_FORWARD}")
            check_probs(probs, (streams,) if streams > 1 else (),
                        f"push {i} streams={streams}")
        check(sess.frames_seen == PUSHES, f"frames_seen {sess.frames_seen}")
        print(f"[streaming] StreamingSession causal bf16 "
              f"context={STREAM_CONTEXT} streams={streams}: "
              f"{LAYERS_PER_FORWARD} K1 launches per push; ms per push "
              f"{[round(m, 3) for m in ms]} (first warms up); median "
              f"{float(np.median(ms[1:])):.3f} ms; {card}")
        sessions.append((sess, frames[-1]))
    return sessions


def breakdown(model, x_host: torch.Tensor, buffer=None) -> dict:
    """ms of the input transfer and normalisation, the backbone and the TCN
    of one forward (CUDA events, mean of 3 after a warm-up). The TCN runs
    over ``buffer`` when given (streaming), else over the backbone's
    features of ``x_host`` (offline, (B, T, H, W, 3))."""
    from computervision_codes_tpu_torch.serving import _to_model_input

    dev, dtype = next(model.parameters()).device, model.backbone.dtype
    with torch.inference_mode():
        x = _to_model_input(x_host, dev, dtype)
        frames = x.reshape(-1, *x.shape[-3:])
        seq = buffer if buffer is not None else model.backbone(frames)[
            "pooled"].reshape(*x.shape[:2], -1)
        parts = {}
        for name, fn in (
                ("input", lambda: _to_model_input(x_host, dev, dtype)),
                ("backbone", lambda: model.backbone(frames)),
                ("tcn", lambda: model.tcn(seq))):
            fn()
            parts[name] = round(cuda_ms(fn, 3), 3)
    return parts


def phase_breakdown(card: str, offline, clips: np.ndarray, streaming) -> None:
    print(f"[breakdown] ms per offline forward "
          f"{breakdown(offline.model, torch.from_numpy(clips))}; {card}")
    for sess, frame in streaming:
        parts = breakdown(sess.model, torch.from_numpy(frame), sess.buffer)
        print(f"[breakdown] ms per push, streams={sess.streams}: {parts}; "
              f"{card}")


def main() -> None:
    if not (ROOT / PACKAGE / "csrc" / "dilated_residual.cu").is_file():
        fail(f"{PACKAGE}/ not found beside {Path(__file__).name}: run from a "
             f"checkout of the repository")
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False); this "
             "check runs only on the card")
    sys.path.insert(0, str(ROOT))
    from computervision_codes_tpu_torch.ops import dilated_conv

    card = phase_device()
    phase_build()
    k1 = phase_kernels(card)
    phase_model()

    def launches() -> int:
        return dilated_conv.dilated_residual_cuda.launches

    dilated_conv.dilated_residual_cuda.launches = 0  # main path starts here
    sess, clips = phase_offline(card, launches)
    streaming = phase_streaming(card, launches)
    total = launches()
    check(total > 0, "the main path launched no K1 kernel")
    phase_breakdown(card, sess, clips, streaming)
    print(json.dumps({"kernels": [{
        "name": "dilated_residual", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": total, **k1}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
