"""The window-attention phase's two ways of reading the relative-position
bias, in turns on one CUDA card, at Swin-L-384's stage shapes (bf16, B = 16,
N = 144), shifted and not:

- "pairs" (the kept design, ``window_attn_phase_cuda``): one block per
  (window, head) reads the head's bias, and the window's mask, from device
  memory in the accumulator's layout as bf16 pairs;
- "walk4", "walk16": a block walks 4 or 16 windows of one head with the
  head's (N, N) bias staged once in its shared memory
  (``scripts/window_attn_bias_probe.cu``, built here with nvcc), the mask
  read as before.

Both run ``csrc/window_attn.cuh``'s body, so the outputs must be equal bit
for bit (the script exits 1 if not). Each time is the median over the order
pairs, walk4, walk16, walk16, walk4, pairs of the mean of 20 calls from CUDA
events; it prints one JSON line per shape and the card's name and power
limit.

    python scripts/window_attn_bias_probe.py

Imports only the port (``computervision_codes_tpu_torch``), never JAX.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from computervision_codes_tpu_torch.models.swin import shift_mask  # noqa: E402
from computervision_codes_tpu_torch.ops import _build  # noqa: E402
from computervision_codes_tpu_torch.ops.window_mhsa import (  # noqa: E402
    window_attn_phase_cuda)
from computervision_codes_tpu_torch.utils.timing import cuda_ms  # noqa: E402

# (what, B, map side, heads); window 12
STAGES = [("SwinL-384 stage 0", 16, 96, 6), ("SwinL-384 stage 1", 16, 48, 12),
          ("SwinL-384 stage 2", 16, 24, 24)]
W, REPS = 12, 20


def build() -> ctypes.CDLL:
    """nvcc the probe's kernel into the package's git-ignored build
    directory, with the port's flags."""
    src = Path(__file__).with_suffix(".cu")
    out = _build.BUILD_DIR / "libwindow_attn_bias_probe.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    fn = lib.window_attn_walk_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    walk = build()
    same = True
    for what, b, side, heads in STAGES:
        for shift in (0, W // 2):
            g = torch.Generator(device="cuda").manual_seed(side + shift)
            c, n = heads * 32, W * W
            qkv = torch.randn(b, side, side, 3 * c, generator=g,
                              device="cuda").bfloat16()
            bias = torch.randn(heads, n, n, generator=g,
                               device="cuda").bfloat16()
            mask = (shift_mask(side, side, W, shift, "cuda", torch.bfloat16)
                    if shift else None)
            outs = {}

            def walked(wpb):
                out = torch.empty(b, side, side, c, device="cuda",
                                  dtype=torch.bfloat16)

                def call():
                    err = walk(qkv.data_ptr(), bias.data_ptr(),
                               None if mask is None else mask.data_ptr(),
                               out.data_ptr(), b, side, side, c, heads, W,
                               32 ** -0.5, wpb,
                               torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"walk{wpb}: CUDA error {err}")
                    return out
                return call

            fns = {"pairs": lambda: window_attn_phase_cuda(
                       qkv, bias, mask, window=W, num_heads=heads),
                   "walk4": walked(4), "walk16": walked(16)}
            for name, fn in fns.items():
                outs[name] = fn().clone()
                cuda_ms(fn, 2)
            torch.cuda.synchronize()
            equal = {k: bool(torch.equal(v, outs["pairs"]))
                     for k, v in outs.items()}
            same &= all(equal.values())
            runs = {k: [] for k in fns}
            for name in list(fns) + list(fns)[::-1]:
                runs[name].append(round(cuda_ms(fns[name], REPS), 4))
            print(json.dumps({
                "shape": f"{what} (B, H, N) = ({b * (side // W) ** 2}, "
                         f"{heads}, {n}) shift={shift}",
                "ms": {k: float(np.median(v)) for k, v in runs.items()},
                "runs": runs, "equal_to_pairs": equal, "card": card}),
                flush=True)
    print(f"window_attn bias probe: outputs "
          f"{'equal' if same else 'DIFFER'}; {card}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
