"""The student's data-parallel training step at world size 1 on NCCL
against the single-device step, under three settings of cuDNN, and with
the BatchNorm moments taken as all-reduced sums over the count (the
arithmetic the data-parallel BatchNorm had before it averaged each rank's
own E[x] and E[x^2]).

    python3 -m computervision_codes_tpu_torch.scripts.dp_step_probe

The ResNet18 ``SpatialCNN`` at loss "ivt" from seed 24, SGD 1e-2 with
weight decay 1e-5, one seeded batch of 8 frames of 256x448, as
``chip_smoke.py``'s phase 20 takes its DP step. For each setting it runs
the single-device step twice and the DP step once from the same weights
and prints whether they agree bit for bit, and the parameters whose
difference is the largest share of their update. The last line is the
card's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import copy
import subprocess
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from computervision_codes_tpu_torch.models import resnet
from computervision_codes_tpu_torch.models.q2l import TASK_SIZES
from computervision_codes_tpu_torch.models.spatial_cnn import SpatialCNN
from computervision_codes_tpu_torch.parallel import mesh as pmesh
from computervision_codes_tpu_torch.parallel.context import (all_reduce_sum,
                                                              data_group)
from computervision_codes_tpu_torch.train import (build_sgd,
                                                  create_train_state,
                                                  make_spatial_train_step)

BATCH, HEIGHT, WIDTH = 8, 256, 448
SETTINGS = (("TF32, cuDNN's default algorithms", True, False),
            ("TF32, cuDNN's deterministic algorithms", True, True),
            ("no TF32, cuDNN's deterministic algorithms", False, True))


def sums_over_count_forward(self, x):
    """Training-mode BatchNorm with the group's moments as all-reduced
    sums of x and x^2 over the all-reduced count."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    dims = (0, 2, 3)
    group = data_group()
    if group is None:
        mean, sq = xf.mean(dims), (xf * xf).mean(dims)
    else:
        c = xf.shape[1]
        sums = all_reduce_sum(torch.cat([
            xf.sum(dims), (xf * xf).sum(dims),
            xf.new_full((1,), xf.numel() // c)]), group)
        mean, sq = sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]
    var = torch.clamp_min(sq - mean * mean, 0.0)
    with torch.no_grad():
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)
    shape = (1, -1, 1, 1)
    mul = torch.rsqrt(var + resnet.BN_EPS) * self.weight
    y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
    return y.to(self.dtype)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("dp_step_probe needs a CUDA card")
    rng = np.random.default_rng(23)
    batch = {"image": rng.standard_normal(
        (BATCH, HEIGHT, WIDTH, 3)).astype(np.float32)}
    for k, c in TASK_SIZES.items():
        batch[f"label_{k}"] = (rng.random((BATCH, c)) < 0.3).astype(
            np.float32)
    student = SpatialCNN("resnet18", loss_type="ivt",
                         generator=torch.Generator().manual_seed(24))
    before = {k: v.clone() for k, v in student.state_dict().items()}
    with tempfile.TemporaryDirectory() as tmp:
        pmesh.init_process(0, 1, f"file://{tmp}/store", "cuda")
        try:
            mesh = pmesh.make_mesh(n_data=1, device_type="cuda")

            def step(use_mesh: bool):
                state = create_train_state(copy.deepcopy(student),
                                           build_sgd(1e-2, 1e-5),
                                           device="cuda")
                _, metrics = make_spatial_train_step(
                    student, "ivt", device="cuda",
                    mesh=mesh if use_mesh else None)(state, batch)
                return ({k: float(v) for k, v in metrics.items()},
                        state.model.state_dict())

            runs = [("group moments the mean of the ranks' own", None)]
            runs.append(("group moments as sums over the count",
                         sums_over_count_forward))
            kept = resnet.BatchNorm.batch_forward
            for moments, forward in runs:
                resnet.BatchNorm.batch_forward = forward or kept
                try:
                    for label, tf32, deterministic in SETTINGS:
                        torch.backends.cudnn.allow_tf32 = tf32
                        torch.backends.cudnn.deterministic = deterministic
                        torch.backends.cudnn.benchmark = False
                        single, again, dp = step(False), step(False), \
                            step(True)
                        report(f"{moments}; {label}", single, again, dp,
                               before)
                finally:
                    resnet.BatchNorm.batch_forward = kept
        finally:
            dist.destroy_process_group()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())


def report(label, single, again, dp, before) -> None:
    def equal(a, b):
        return a[0] == b[0] and all(torch.equal(v, b[1][k])
                                    for k, v in a[1].items())

    rows = []
    for name, v in dp[1].items():
        if not v.is_floating_point() or "running" in name:
            continue
        ref = single[1][name]
        update = float((ref.cpu() - before[name]).abs().max())
        err = float((v - ref).abs().max())
        rows.append((err / max(update, 1e-30), err, update, name))
    rows.sort(reverse=True)
    top = ", ".join(f"{name} {share:.4f} ({err:.3g} of {update:.3g})"
                    for share, err, update, name in rows[:3])
    print(f"[dp probe] {label}: single twice equal {equal(single, again)}, "
          f"DP equal to single {equal(dp, single)}; loss DP "
          f"{dp[0]['loss']!r} single {single[0]['loss']!r}; largest "
          f"differences as shares of the update: {top}", flush=True)


if __name__ == "__main__":
    main()
