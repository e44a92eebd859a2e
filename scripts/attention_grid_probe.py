"""K7 (the port's ``attention_cuda``) from two checkouts of the repo, in
turns on one CUDA card: the grid layout of one against the other's.

Each checkout's ``computervision_codes_tpu_torch`` builds K7 from its own
``csrc/`` and times it in a process of its own, in the order a, b, b, a.
A process times ``attention_cuda`` at MS-TCT's shapes, the ones
``chip_smoke.py``'s K7 phase times: (1, 8, 8192, D) for D in 32, 48, 72
and 108 and the training window (32, 8, 256, 108), bf16 and float32, the
median of three means of 10 calls from CUDA events, and hashes each output
(the inputs are made from a seed on the card), so the two checkouts must
also give the same bytes. It prints one JSON line per process and a
summary with the card's name and power limit.

    python scripts/attention_grid_probe.py OLD_CHECKOUT NEW_CHECKOUT

Imports only the port (``computervision_codes_tpu_torch``), never JAX.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys

import numpy as np

SHAPES = [(1, 8, 8192, d) for d in (32, 48, 72, 108)] + [(32, 8, 256, 108)]
DTYPES = ("bfloat16", "float32")
REPS, RUNS = 10, 3


def time_checkout(root: str) -> dict:
    """K7's ms and output hash at each shape and dtype, from ``root``."""
    sys.path.insert(0, root)
    import torch

    from computervision_codes_tpu_torch.ops.attention import attention_cuda

    def ms(fn) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / REPS

    out = {}
    for name in DTYPES:
        dtype = getattr(torch, name)
        for b, h, t, d in SHAPES:
            g = torch.Generator(device="cuda").manual_seed(t + d)
            q, k, v = (torch.randn(b, h, t, d, generator=g,
                                   device="cuda").to(dtype)
                       for _ in range(3))
            o = attention_cuda(q, k, v)
            digest = hashlib.sha256(
                o.float().cpu().numpy().tobytes()).hexdigest()[:16]
            ms(lambda: attention_cuda(q, k, v))  # warm-up
            runs = [round(ms(lambda: attention_cuda(q, k, v)), 4)
                    for _ in range(RUNS)]
            out[f"{name} {(b, h, t, d)}"] = {"ms": float(np.median(runs)),
                                             "runs": runs, "sha": digest}
    return out


def main(argv) -> int:
    if argv[:1] == ["--time"]:
        print(json.dumps(time_checkout(argv[1])))
        return 0
    old, new = argv
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    readings = {"old": [], "new": []}
    for side, root in (("old", old), ("new", new), ("new", new),
                       ("old", old)):
        proc = subprocess.run([sys.executable, __file__, "--time", root],
                              capture_output=True, text=True, check=True)
        line = proc.stdout.strip().splitlines()[-1]
        print(f"[{side}] {root}: {line}")
        readings[side].append(json.loads(line))
    same = True
    for key in readings["old"][0]:
        ms = {side: [r[key]["ms"] for r in readings[side]]
              for side in readings}
        shas = {r[key]["sha"] for side in readings for r in readings[side]}
        same &= len(shas) == 1
        print(f"{key}: old {ms['old']} ms, new {ms['new']} ms (mean "
              f"{np.mean(ms['old']):.4f} / {np.mean(ms['new']):.4f}); "
              f"outputs {'equal' if len(shas) == 1 else 'DIFFER'}; {card}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
