"""Export a trained student checkpoint as a serving artifact.

The port's copy of ``cli/export.py`` in the JAX package: chains
``serving.InferenceSession.from_checkpoint`` -> ``.export``. The output
directory holds ``variables.msgpack`` (the JAX variables, or the int8
codes and scales with ``--quantize``) and ``meta.json`` (the shape and
the build options); ``InferenceSession.load_exported`` rebuilds the session
from them, and ``cli.infer --servable`` serves it. JAX's directory also
holds StableHLO programs, which only JAX runs: the port writes none (see
``serving``). The reference releases bare state_dict .pth files that still
need the repo (MT4MTLKD/readme.md:96-106).

Usage:
  python -m computervision_codes_tpu_torch.cli.export \\
      --ckpt_dir __checkpoint__/run_Res18 --modelname <name> \\
      --out servable [--quantize] [--batch 4 --clip_len 256] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> str:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt_dir", type=str, required=True)
    p.add_argument("--modelname", type=str, required=True)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--network", type=str, default="resnet18")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--clip_len", type=int, default=256)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=448)
    p.add_argument("--quantize", action="store_true",
                   help="export the int8-PTQ serving config (calibrated "
                        "here, once)")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the session is built (and calibrated)")
    flags, _ = p.parse_known_args(argv)

    from ..serving import InferenceSession

    sess = InferenceSession.from_checkpoint(
        flags.ckpt_dir, flags.modelname, network=flags.network,
        batch=flags.batch, clip_len=flags.clip_len, height=flags.height,
        width=flags.width, quantize=flags.quantize, device=flags.device)
    path = sess.export(flags.out)
    print(f"exported servable -> {path} "
          f"({'int8-PTQ' if flags.quantize else 'bf16'}, "
          f"{flags.batch}x{flags.clip_len}x{flags.height}x{flags.width})")
    return path


if __name__ == "__main__":
    main(sys.argv[1:])
