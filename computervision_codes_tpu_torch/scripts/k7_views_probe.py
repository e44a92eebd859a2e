"""Probe: K7's bf16 forward on MS-TCT's views, for comparing checkouts.

Times ``ops.attention.attention_cuda`` on q, k and v laid out as MS-TCT
passes them (``chip_smoke.mstct_qkv``: (B, H, T, D) views of its
projections, which the TMA producer feeds) at (1, 8, 8192, D) for D = 32,
48, 72 and 108, and at (1, 8, 1000, 108); and on contiguous (1, 8, 8192,
108) tensors (rows of 216 bytes: the ``cp.async`` producer, as K8's
forward takes them in ``chip_smoke.py``), with ``chip_smoke.in_turns``
(the median of two runs of 20 calls each, after a warm-up). It imports
``chip_smoke`` and the package from the working directory, so two
checkouts are compared in one call on one card by running it from the root
of each in turns (a, b, b, a):

    (cd parent && python3 -m computervision_codes_tpu_torch.scripts.k7_views_probe)

Prints one ``TIME`` line per case and the card's name and power limit.
The card only: it builds and launches the kernel.
"""

from __future__ import annotations

import os
import sys


def main() -> None:
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from computervision_codes_tpu_torch.ops import _build, attention

    card = cs.phase_device()
    _build.build(["attention"])
    cases = [("MS-TCT views", cs.mstct_qkv, t, d)
             for d in (32, 48, 72, 108)
             for t in ((8192, 1000) if d == 108 else (8192,))]
    cases.append(("contiguous", cs.attention_inputs, 8192, 108))
    for layout, make, t, d in cases:
        q, k, v = make(1, 8, t, t, d, torch.bfloat16, 3)
        ms, runs = cs.in_turns(
            {"k7": lambda: attention.attention_cuda(q, k, v)}, {"k7": 20})
        print(f"TIME K7 bf16 {layout} (1, 8, {t}, {t}, {d}) "
              f"{ms['k7']:.4f} ms; runs {runs['k7']}; {os.getcwd()}; "
              f"{card}", flush=True)


if __name__ == "__main__":
    main()
