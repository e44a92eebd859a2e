"""Backbone-zoo inference on the card: CvT-13, TResNet-M and the int8
TResNets.

The port's counterpart of the JAX package's ``scripts/zoo_bench.py``, the
one entry point there that runs the int8 TResNet. It times, at batch
``BATCH`` (32) and ``IMG`` (224), the three rows that script prints:

* the bf16 CvT-13 backbone;
* the bf16 TResNet-M backbone (K9 on every activated ABN);
* the int8 TResNet-M (``models.quant_tresnet``, Q1 on every convolution),
  its activation scales calibrated on 4 of the frames;

and a fourth at the published teacher's width: the int8 TResNet-L at
``LARGE_IMG`` (448), batch ``LARGE_BATCH`` (16). Weights are random, from
a seed; frames are seeded normal bf16. Each row is the time of one
forward, the median of three runs of ``ITERS`` calls after a warm-up
(``utils.timing.median_ms``: CUDA events on the card), and the frames per
second it gives. Prints the card's name and power limit, then one JSON
line per row.

    python3 -m computervision_codes_tpu_torch.scripts.zoo_bench [--device cuda]

On ``--device cpu`` the times are the host's, not a device number.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional, Sequence

import torch

from ..models.cvt import build_cvt
from ..models.quant_tresnet import make_int8_tresnet
from ..models.tresnet import build_tresnet
from ..utils.timing import device_label, median_ms


BATCH, IMG = 32, 224
LARGE_BATCH, LARGE_IMG = 16, 448
ITERS = 20


def parse_flags(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def _row(metric: str, fn, batch: int, device) -> dict:
    with torch.inference_mode():
        ms = median_ms(fn, device, ITERS)
    return {"metric": metric, "fps": round(1e3 * batch / ms, 1),
            "per_step_ms": round(ms, 4)}


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    flags = parse_flags(argv)
    device = torch.device(flags.device)
    print(device_label(device), flush=True)
    g = torch.Generator().manual_seed(0)
    dt = torch.bfloat16

    def frames(n, img):
        return torch.randn(n, img, img, 3, generator=g).to(device, dt)

    imgs = frames(BATCH, IMG)
    rows = []
    cvt = build_cvt("cvt_13", dt, g).to(device).eval()
    rows.append(_row(f"CvT-13 backbone {IMG} (b={BATCH}, bf16)",
                     lambda: cvt(imgs)["pooled"], BATCH, device))
    del cvt
    tres = build_tresnet("tresnet_m", dt, g).to(device).eval()
    rows.append(_row(f"TResNet-M backbone {IMG} (b={BATCH}, bf16, K9 ABN)",
                     lambda: tres(imgs)["pooled"], BATCH, device))
    with torch.inference_mode():
        q = make_int8_tresnet("tresnet_m", tres, imgs[:4])
    rows.append(_row(f"TResNet-M backbone {IMG} int8-PTQ (b={BATCH}, "
                     f"calibrated static scales)",
                     lambda: q(imgs)["pooled"], BATCH, device))
    del tres, q
    large = frames(LARGE_BATCH, LARGE_IMG)
    tres_l = build_tresnet("tresnet_l", dt, g).to(device).eval()
    with torch.inference_mode():
        q = make_int8_tresnet("tresnet_l", tres_l, large[:4])
    del tres_l
    rows.append(_row(f"TResNet-L backbone {LARGE_IMG} int8-PTQ "
                     f"(b={LARGE_BATCH}, calibrated static scales)",
                     lambda: q(large)["pooled"], LARGE_BATCH, device))
    for row in rows:
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
