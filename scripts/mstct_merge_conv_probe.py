"""The PyTorch port's MS-TCT driver end to end with its k3 merge
convolution in two forms, in turns on one CUDA card.

The port's ``models/common.py::TemporalConv`` runs a dense (groups 1)
convolution as one GEMM over the k shifted copies of x side by side; the
other form is ``F.conv1d`` (cuDNN), which plans anew for every sequence
length it has not seen. The driver evaluates each video at its own length,
so every test video is a new length. This script runs the port's driver
``-e -d`` (the CLI's ``main``, in process) at the driver's full width on a
synthetic CholecT45 tree (the nine fold-1 test videos at 1,000-6,000
frames of random 1536-d features, every other video at 64): first one
untimed run per form and dtype (the libraries' first use in the process),
then once per form and dtype in the order GEMM, conv1d, conv1d, GEMM. Each
run gets a tree of its own whose lengths no earlier run used, so each run
pays the new-length cost a user's run pays. cuDNN's TF32 is off, so both
forms compute float32 sums in the float32 driver; the conv1d form permutes
the (k, Cin, Cout) kernel to cuDNN's layout at each call (a copy of at
most 1.5 M values). It prints frames/s over the test videos and the ms of
each, per run, with the card's name and power limit.

    python scripts/mstct_merge_conv_probe.py

Imports only the port (``computervision_codes_tpu_torch``), never JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from computervision_codes_tpu_torch.cli import temporal_mstct  # noqa: E402
from computervision_codes_tpu_torch.data.feature_store import (  # noqa: E402
    FeatureStore)
from computervision_codes_tpu_torch.data.splits import (  # noqa: E402
    resolve_split)
from computervision_codes_tpu_torch.data.synthetic import (  # noqa: E402
    synthetic_feature_dict, write_synthetic_dataset)
from computervision_codes_tpu_torch.models.common import (  # noqa: E402
    TemporalConv)

TEST_LENGTHS = tuple(int(t) for t in np.linspace(1000, 6000, 9))
OTHER_LENGTH, IN_DIM = 64, 1536
GEMM_FORWARD = TemporalConv.forward


def conv1d_forward(self, x):
    """``TemporalConv`` with every group count on ``F.conv1d``."""
    x, w = x.to(self.dtype), self.kernel.to(self.dtype).permute(2, 1, 0)
    k = w.shape[-1]
    y = F.conv1d(x.transpose(1, 2), w, padding=k // 2,
                 groups=self.groups).transpose(1, 2)
    return y + self.bias.to(self.dtype)


def write_tree(root: str, offset: int) -> tuple:
    """The fold-1 tree with every length moved by ``offset`` frames."""
    split = resolve_split("cholect45-crossval", 1)
    lengths = dict.fromkeys(split.all_videos, OTHER_LENGTH + offset)
    lengths |= {v: t + offset for v, t in zip(split.test, TEST_LENGTHS)}
    counts = [lengths[v] for v in split.all_videos]
    write_synthetic_dataset(root, split.all_videos, counts)
    FeatureStore(root + "/data_feats", "Q2L").save(
        1, "feats", synthetic_feature_dict(split.all_videos, counts, IN_DIM,
                                           seed=6))
    return split, lengths


def run(dtype: str, forward, offset: int) -> dict:
    TemporalConv.forward = forward
    with tempfile.TemporaryDirectory() as root:
        split, lengths = write_tree(root, offset)
        result = temporal_mstct.main(
            ["--data_dir", root, "--ckpt_root", root + "/ckpt", "--dtype",
             dtype, "--device", "cuda", "-e", "-d"])
    ms = result["eval_ms"]["test"]
    frames = sum(lengths[v] for v in split.test)
    return {"frames_per_s": frames / (sum(ms.values()) / 1e3),
            "test_ms": sum(ms.values()),
            "ms_per_video": [round(ms[v], 3) for v in split.test]}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    forms = {"gemm": GEMM_FORWARD, "conv1d": conv1d_forward}
    offset = 1
    for dtype in ("float32", "bfloat16"):  # warm-up; builds K7
        for forward in forms.values():
            run(dtype, forward, offset)
            offset += 1
    for dtype in ("float32", "bfloat16"):
        for form in ("gemm", "conv1d", "conv1d", "gemm"):
            reading = run(dtype, forms[form], offset)
            offset += 1
            print(json.dumps({"dtype": dtype, "form": form,
                              "offset": offset - 1, **reading,
                              "card": card}), flush=True)
    TemporalConv.forward = GEMM_FORWARD


if __name__ == "__main__":
    main()
