"""5-fold cross-validation orchestrator.

Counterpart of ``cli/crossval.py`` in the JAX package. The reference
chains stages per fold with shell scripts (MT4MTLKD/Scripts/*, TERL
runT.sh); this driver runs one stage driver of the port
(``computervision_codes_tpu_torch.cli.<stage>``) on each fold and
aggregates the per-fold test mAPs, the cross-validation protocol behind
the published tables:

    python -m computervision_codes_tpu_torch.cli.crossval \\
        --stage temporal_tcn --folds 1 2 3 4 5 -- --data_dir D -t -e

Arguments after ``--`` go to the stage driver, with ``-k <fold>`` added.
It prints and returns ``{"stage", "per_fold", "mean"}``: the mean of each
component's mAP where a stage reports a table, else of the single mAP.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from typing import Optional, Sequence

import numpy as np

STAGES = ("spatial_cnn", "spatial_transformer", "temporal_mstct",
          "temporal_tcn", "terl_learnt")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        split_at = argv.index("--")
        own, rest = argv[:split_at], argv[split_at + 1:]
    else:
        own, rest = argv, []
    p = argparse.ArgumentParser(description="5-fold crossval orchestrator")
    p.add_argument("--stage", choices=STAGES, required=True)
    p.add_argument("--folds", type=int, nargs="+", default=[1, 2, 3, 4, 5])
    flags = p.parse_args(own)

    mod = importlib.import_module(f"{__package__}.{flags.stage}")
    per_fold = {}
    for fold in flags.folds:
        print(f"=== fold {fold} ===")
        res = mod.main(rest + ["-k", str(fold)])
        per_fold[fold] = res.get("test_mAP")
    summary = {"stage": flags.stage, "per_fold": per_fold}
    maps = [m for m in per_fold.values() if m is not None]
    if maps and isinstance(maps[0], dict):
        summary["mean"] = {
            c: float(np.mean([m[c] for m in maps])) for c in maps[0]}
    elif maps:
        summary["mean"] = float(np.mean(maps))
    print(json.dumps(summary, indent=2, default=float))
    return summary


if __name__ == "__main__":
    main()
