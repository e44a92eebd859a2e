"""The teacher's fixed-batch training step and eval step, timed on two
checkouts of the port in turns (A, B, B, A, ...), each in a process of its
own that imports its checkout's package.

    python3 -m computervision_codes_tpu_torch.scripts.train_step_ab \\
        --other DIR [--rounds 2] [--steps 12] [--out FILE]

``DIR`` is the root of another checkout (for example the parent commit,
unpacked by ``git archive``); this checkout is the other side. Each run
makes the bf16 Swin-L-384 Q2L at loss "i" with ``fused_train`` and remat
"dots" from seed 0, SGD 1e-2 with weight decay 1e-5 and the reference's
pos-weights, and one seeded batch of 8 frames of 384x384 on the card, as
``chip_smoke.py``'s training phase does; it times ``--steps`` training
steps and as many eval forwards of the trained module
(``make_spatial_eval_step``), each call ending synchronised, by CUDA
events. Prints one JSON line per run (the medians after the first two
calls) and a summary line with the card's name and power limit; with
``--out`` also writes them there. Kernels a checkout builds are copied to
the other's ``_build/`` when its sources are the same (the file names
carry their hash). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve()
ROOT = HERE.parents[2]
PACKAGE = HERE.parents[1].name
WARM = 2


def worker(steps: int) -> dict:
    """One run in this process's checkout (the package on ``sys.path``)."""
    import numpy as np
    import torch

    from computervision_codes_tpu_torch.losses import (
        TARGET_POS_WEIGHT, TOOL_POS_WEIGHT, VERB_POS_WEIGHT)
    from computervision_codes_tpu_torch.models.q2l import TASK_SIZES, Q2L
    from computervision_codes_tpu_torch.train import (
        build_sgd, create_train_state, make_spatial_eval_step,
        make_spatial_train_step)

    device = "cuda"
    rng = np.random.default_rng(12)
    batch = {"image": rng.standard_normal((8, 384, 384, 3)).astype(
        np.float32)}
    for k, n in TASK_SIZES.items():
        batch[f"label_{k}"] = (rng.random((8, n)) < 0.3).astype(np.float32)
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    model = Q2L(backbone="swin_L_384_22k", loss_type="i",
                dtype=torch.bfloat16, remat=True, remat_policy="dots",
                fused_train=True, drop_path_rate=0.1,
                generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, build_sgd(1e-2, weight_decay=1e-5),
                               seed=1, device=device)
    pw = {"i": TOOL_POS_WEIGHT, "v": VERB_POS_WEIGHT, "t": TARGET_POS_WEIGHT}
    train = make_spatial_train_step(model, "i", pos_weights=pw,
                                    device=device)
    evaluate = make_spatial_eval_step(model, device=device)

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    train_ms, eval_ms, losses = [], [], []
    for _ in range(steps):
        (_, metrics), ms = timed(lambda: train(state, batch))
        train_ms.append(ms)
        losses.append(metrics["loss"].item())
    for _ in range(steps):
        eval_ms.append(timed(lambda: evaluate(state, batch["image"]))[1])
    return {"train_ms": train_ms, "eval_ms": eval_ms, "losses": losses,
            "train_median": float(np.median(train_ms[WARM:])),
            "eval_median": float(np.median(eval_ms[WARM:])),
            "finite": bool(np.isfinite(losses).all())}


def share_builds(src: Path, dst: Path) -> None:
    """Copy the kernels built in ``src`` that ``dst`` lacks (same name:
    same source, flags and compiler)."""
    src, dst = src / PACKAGE / "_build", dst / PACKAGE / "_build"
    if not src.is_dir():
        return
    dst.mkdir(exist_ok=True)
    for f in src.glob("*.so"):
        if not (dst / f.name).exists():
            shutil.copy2(f, dst / f.name)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--other", help="root of the other checkout")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--out", default="")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    flags = p.parse_args(argv)
    if flags.worker:
        print(json.dumps(worker(flags.steps)))
        return 0
    if not flags.other:
        p.error("--other is required")
    trees = {"other": Path(flags.other).resolve(), "this": ROOT}
    order = []
    for r in range(flags.rounds):
        order += ["other", "this"] if r % 2 == 0 else ["this", "other"]
    lines, runs = [], {k: [] for k in trees}
    for label in order:
        tree = trees[label]
        env = dict(os.environ, PYTHONPATH=str(tree))
        proc = subprocess.run([sys.executable, str(HERE), "--worker",
                               "--steps", str(flags.steps)], cwd=tree,
                              env=env, capture_output=True, text=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout + proc.stderr)
            return 1
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        run |= {"tree": label, "root": str(tree)}
        runs[label].append(run)
        lines.append(json.dumps(run))
        print(lines[-1], flush=True)
        for other in trees.values():
            share_builds(tree, other)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    summary = {label: {"train_ms": [r["train_median"] for r in rs],
                       "eval_ms": [r["eval_median"] for r in rs],
                       "finite": all(r["finite"] for r in rs)}
               for label, rs in runs.items()}
    summary |= {"order": order, "card": card}
    lines.append(json.dumps(summary))
    print(lines[-1])
    if flags.out:
        Path(flags.out).parent.mkdir(parents=True, exist_ok=True)
        Path(flags.out).write_text("\n".join(lines) + "\n")
    return 0 if all(s["finite"] for s in summary.values()
                    if isinstance(s, dict)) else 1


if __name__ == "__main__":
    sys.exit(main())
