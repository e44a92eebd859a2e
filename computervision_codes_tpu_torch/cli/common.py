"""Shared CLI plumbing of the port's drivers.

The port's copy of what its drivers need from ``cli/common.py`` in the JAX
package: the reference-compatible flags (``common_parser``, names and
defaults unchanged), ``build_modelname``, the challenge-protocol table
(``ignore_null_protocol``), ``seed_everything``, which seeds ``random``,
numpy and torch, ``maybe_warm_start`` (``--imagenet_pretrain``),
``maybe_resume``, the ranks of a parallel driver (``launch_ranks``,
``parallel_context`` and its ``Placement``), and
the eval loop over frames from disk with its reports (``make_metrics``,
``reset_metrics``, ``evaluate_videos``, ``host_outputs``,
``compute_map_table``, ``print_final_report``).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import random
import shutil
import sys
import tempfile
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..data.pipeline import CholecDataset, video_eval_batches
from ..metrics import Recognition
from ..train.checkpoint import CheckpointManager
from ..utils.logging import ExperimentLogger

COMPONENTS = ("i", "v", "t", "iv", "it", "ivt")


def common_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    # model
    p.add_argument("--model", type=str, default="rendezvous")
    p.add_argument("--version", type=str, default="")
    p.add_argument("--network", type=str, default="resnet18")
    # job
    p.add_argument("--seed", type=int, default=47)
    p.add_argument("-t", "--train", action="store_true")
    p.add_argument("-e", "--test", action="store_true")
    p.add_argument("-d", "--dump", action="store_true",
                   help="dump per-video features/preds for the feature bus")
    p.add_argument("--val_interval", type=int, default=1)
    # data
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--dataset_variant", type=str, default="cholect45-crossval",
                   choices=["cholect50", "cholect45", "cholect50-challenge",
                            "cholect50-crossval", "cholect45-crossval",
                            "cholect45-challenge"])
    p.add_argument("-k", "--kfold", type=int, default=1,
                   choices=[1, 2, 3, 4, 5])
    p.add_argument("--image_width", type=int, default=448)
    p.add_argument("--image_height", type=int, default=256)
    p.add_argument("--augmentation_list", type=str, nargs="*",
                   default=["original", "vflip", "hflip", "contrast", "rot90"])
    # hp
    p.add_argument("-b", "--batch", type=int, default=32)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("-w", "--warmups", type=int, nargs="+", default=[9, 18, 58])
    p.add_argument("-l", "--initial_learning_rates", type=float, nargs="+",
                   default=[0.01, 0.01, 0.01])
    p.add_argument("--weight_decay", type=float, default=1e-5)
    p.add_argument("--decay_rate", type=float, default=0.99)
    p.add_argument("--momentum", type=float, default=0.95)
    p.add_argument("--power", type=float, default=0.1)
    p.add_argument("--temp", type=int, default=4)
    p.add_argument("--optimizer", type=str, default="sgd",
                   choices=["sgd", "sam"],
                   help="'sam' wraps the train step's gradient in two-step "
                        "sharpness-aware minimization (train/optim.py: "
                        "sam_gradients; the reference ships SAM in "
                        "TERL/6_baseline_learnT/imbsam.py:5-41 but never "
                        "wires it into a driver — here it is usable)")
    p.add_argument("--sam_rho", type=float, default=0.05,
                   help="SAM neighborhood radius (imbsam.py:9)")
    # weights / io
    p.add_argument("--pretrain_dir", type=str, default="")
    p.add_argument("--imagenet_pretrain", type=str, default="",
                   help="warm-start the backbone from an official ImageNet "
                        ".pth (file, or a Pretrain/ dir holding the "
                        "reference's PTDICT filenames — backbone.py:26-41)")
    p.add_argument("--loss_type", type=str, default="all")
    p.add_argument("--test_ckpt", type=str, default=None)
    p.add_argument("--student_dim", type=int, default=512)
    p.add_argument("--teacher_dim", type=int, default=1536)
    p.add_argument("--ckpt_root", type=str, default="./__checkpoint__")
    p.add_argument("--feats_dir", type=str, default=None,
                   help="feature-bus root (default <data_dir>/data_feats)")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--resume", action="store_true",
                   help="resume from the _latest checkpoint (full train "
                        "state incl. optimizer/schedule — improvement over "
                        "the reference's weights-only manual resume)")
    return p


def seed_everything(seed: int) -> torch.Generator:
    """Seed ``random``, numpy and torch; returns a CPU ``torch.Generator``
    seeded the same, for weights made from the seed."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def maybe_warm_start(flags, state, backbone: str, logger,
                     submodule: str = "backbone"):
    """Apply ``--imagenet_pretrain``: the converted official checkpoint
    into the backbone at ``submodule`` (child names joined by "/"; TERL's
    is ``encoder/backbone``), by ``models.pretrained``; a no-op when the
    flag is empty. A directory is best-effort per backbone (no file for
    it: train from scratch, logged); a .pth path raises on any problem."""
    path = getattr(flags, "imagenet_pretrain", "")
    if not path:
        return state
    from ..models.pretrained import PTDICT, warm_start_backbone

    if os.path.isdir(path) and (
            backbone not in PTDICT
            or not os.path.exists(os.path.join(path, PTDICT[backbone]))):
        logger.log(f"imagenet_pretrain: no checkpoint for {backbone} in "
                   f"{path} — training from scratch")
        return state
    return warm_start_backbone(state, backbone, path, log=logger.log,
                               submodule=submodule)


def launch_ranks(main, argv, flags, n: int):
    """Run the driver's ``main(argv)`` on ``n`` ranks (one command, as one
    JAX process drives every local device; or joined under ``torchrun``)
    on ``--device``'s kind of device; rank 0's result."""
    from ..parallel.mesh import launch

    argv = list(sys.argv[1:] if argv is None else argv)
    return launch(main, n, (argv,), device_type=torch.device(
        flags.device).type)


@dataclass
class Placement:
    """Where a driver's rank runs: its mesh (None on one device), its
    device, and for a rank other than 0 of a group a temporary directory
    for its logs (``scratch``)."""

    mesh: object
    device: torch.device
    scratch: Optional[str] = None

    def logger(self, model_dir: str, modelname: str) -> ExperimentLogger:
        """The run's logger; a rank other than 0 logs into ``scratch``."""
        return ExperimentLogger(self.scratch or model_dir, modelname)

    def checkpoints(self, model_dir: str, modelname: str):
        """The run's ``CheckpointManager``; in a group every rank reads its
        files, whole under tensor parallelism, and rank 0 alone writes them
        (``RankZeroWrites``)."""
        ckpt = CheckpointManager(model_dir, modelname)
        return ckpt if self.mesh is None else RankZeroWrites(ckpt)


class RankZeroWrites:
    """A ``CheckpointManager`` shared by a group's ranks. Its writes and
    restores see the whole parameters of a tensor-parallel state
    (``parallel.tp.gathered_tp``, a no-op where nothing is split); rank 0
    alone writes (``save``, ``update``) and every rank then waits at a
    barrier, so that a read that follows sees the file; everything else
    passes through."""

    def __init__(self, ckpt):
        self.ckpt = ckpt

    def __getattr__(self, name):
        return getattr(self.ckpt, name)

    def _write(self, name, state, *args, **kw):
        import torch.distributed as dist

        from ..parallel.tp import gathered_tp

        with gathered_tp(state.model):
            out = (getattr(self.ckpt, name)(state, *args, **kw)
                   if dist.get_rank() == 0 else "written by rank 0")
        dist.barrier()
        return out

    def save(self, state, *args, **kw):
        return self._write("save", state, *args, **kw)

    def update(self, state, *args, **kw):
        return self._write("update", state, *args, **kw)

    def restore(self, state, *args, **kw):
        from ..parallel.tp import gathered_tp

        with gathered_tp(state.model):
            return self.ckpt.restore(state, *args, **kw)


@contextlib.contextmanager
def parallel_context(flags, n_data: int, n_model: int = 1, n_seq: int = 1):
    """The ``Placement`` of this rank for ``--dp_devices`` x
    ``--seq_devices`` x ``--tp_devices`` (no mesh, ``--device``, on one
    device). The global ``--batch`` must divide by the data axis. A rank
    other than 0's scratch directory is removed when the block ends."""
    import torch.distributed as dist

    if n_data * n_model * n_seq <= 1:
        yield Placement(None, torch.device(flags.device))
        return
    from ..parallel.mesh import make_mesh, mesh_device

    if flags.batch % n_data:
        raise ValueError("--batch must be divisible by --dp_devices")
    mesh = make_mesh(n_data=n_data, n_seq=n_seq, n_model=n_model,
                     device_type=torch.device(flags.device).type)
    scratch = (tempfile.mkdtemp(prefix=f"rank{dist.get_rank()}_")
               if dist.get_rank() else None)
    try:
        yield Placement(mesh, mesh_device(mesh), scratch)
        dist.barrier()
    finally:
        if scratch:
            shutil.rmtree(scratch, ignore_errors=True)


def is_rank_zero() -> bool:
    """Outside a group, or rank 0 of it (the rank that writes shared
    outputs such as the feature dump)."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def maybe_resume(flags, ckpt, state, logger):
    """With ``--resume``, restore ``state`` from the ``_latest`` checkpoint
    when there is one (its weights, step, schedule count and generator),
    whichever package wrote it."""
    if getattr(flags, "resume", False) and ckpt.exists("latest"):
        state = ckpt.restore(state, tag="latest")
        logger.log(f"Resumed from {ckpt.path('latest')} at step "
                   f"{state.step}")
    return state


def build_modelname(flags) -> str:
    """Reference naming (Spatial_cnn/run.py:126-128): zip of headers
    ['', 'l', 'cholect', 'k'] with [model, variant, kfold] — yielding e.g.
    'rendezvous_lcholect45-crossval_cholect1'."""
    kfold = flags.kfold if "crossval" in flags.dataset_variant else 0
    headers = ["", "l", "cholect", "k"]
    args = [flags.model, flags.dataset_variant, kfold]
    return "_".join(f"{h}{a}" for h, a in zip(headers, args) if str(a))


def make_metrics() -> Dict[str, Recognition]:
    return {"ivt": Recognition(100), "i": Recognition(6),
            "v": Recognition(10), "t": Recognition(15)}


def reset_metrics(metrics: Dict[str, Recognition]) -> None:
    for m in metrics.values():
        m.reset_global()


def evaluate_videos(run_batch, dataset: CholecDataset, videos: Sequence[str],
                    batch_size: int, metrics: Dict[str, Recognition],
                    collect_features: bool = False) -> Dict[str, np.ndarray]:
    """Per-video eval loop feeding the Recognition accumulators.

    ``run_batch(images) -> (probs dict with i/v/t/ivt, features or None)``,
    ``images`` the (B, H, W, 3) float32 normalised frames of a batch (the
    last padded to ``batch_size``). Returns {video: (T, D) features} when
    requested (the dump path).
    """
    feats_out: Dict[str, np.ndarray] = {}
    for video in videos:
        chunks = []
        for batch in video_eval_batches(dataset, video, batch_size):
            probs, feats = run_batch(batch["image"])
            valid = batch["valid"]
            for key, m in metrics.items():
                m.update(batch[f"label_{key}"][valid],
                         np.asarray(probs[key])[valid])
            if collect_features and feats is not None:
                chunks.append(np.asarray(feats)[valid])
        for m in metrics.values():
            m.video_end()
        if collect_features:
            feats_out[video] = np.concatenate(chunks, axis=0)
    return feats_out


def host_outputs(probs: Dict, feats) -> tuple:
    """An eval step's outputs (tensors on any device, in any dtype) as
    float32 numpy arrays, as ``evaluate_videos`` takes them."""
    return ({k: v.float().cpu().numpy() for k, v in probs.items()},
            feats.float().cpu().numpy())


# Which reference drivers HARDCODE the challenge protocol (ignore_null=True)
# for their printed AP tables vs derive it from the dataset-variant name.
# Checkpoint SELECTION always uses compute_video_AP() defaults
# (ignore_null=False) in every reference driver (weight_mgt call sites).
REFERENCE_CHALLENGE_PROTOCOL = {
    # variant-derived: True iff "challenge" in dataset_variant
    "spatial_cnn": None,          # MT4MTLKD/Spatial_cnn/run.py:122
    "temporal_mstct": None,       # MT4MTLKD/Temporal_mstct/run.py:119
    "temporal_tenco": None,       # MT4MTLKD/Temporal_tenco/run.py:131
    # hardcoded True
    "spatial_transformer": True,  # variant-derived at run.py:127 but
    # unconditionally OVERWRITTEN right before the run loop
    # (MT4MTLKD/Spatial_transformer/run.py:421, test.py:335)
    "terl_learnt": True,          # TERL/6_baseline_learnT/run.py:160
    "tcn_black": True,            # TERL/0_5fold_TCN_black/run.py:142
}


def ignore_null_protocol(stage: str, dataset_variant: str) -> bool:
    """The ignore_null setting the reference stage uses for its AP tables."""
    fixed = REFERENCE_CHALLENGE_PROTOCOL[stage]
    return fixed if fixed is not None else "challenge" in dataset_variant


def compute_map_table(metrics: Dict[str, Recognition], loss_type: str,
                      ignore_null: bool) -> Dict[str, Dict]:
    """Reference metric selection (Spatial_cnn/run.py:518-529): single-task
    runs use the per-task accumulators; multi-task uses disentangled ivt."""
    out = {}
    if loss_type in ("i", "v", "t"):
        for c in ("i", "v", "t"):
            out[c] = metrics[c].compute_video_AP(ignore_null=ignore_null)
    else:
        for c in ("i", "v", "t"):
            out[c] = metrics["ivt"].compute_video_AP(
                c, ignore_null=ignore_null)
    for c in ("iv", "it", "ivt"):
        out[c] = metrics["ivt"].compute_video_AP(c, ignore_null=ignore_null)
    return out


def print_final_report(logger, table: Dict[str, Dict],
                       metrics: Dict[str, Recognition]) -> None:
    """Reference final report format (Spatial_cnn/run.py:530-561)."""
    logger.log("-" * 50)
    logger.log("Test Results\nPer-category AP: ")
    for c in COMPONENTS:
        logger.log(f"{c.upper():<4}: {table[c]['AP']}")
    logger.log("-" * 50)
    logger.log("Mean AP:  I  |  V  |  T  |  IV  |  IT  |  IVT ")
    logger.log(":::::: : " + " | ".join(
        f"{table[c]['mAP']:.4f}" for c in COMPONENTS))
    for k in (5, 10, 20):
        tops = [metrics["ivt"].topK(k, c) for c in COMPONENTS]
        logger.log(f"top {k}:  I  |  V  |  T  |  IV  |  IT  |  IVT ")
        logger.log(":::::: : " + " | ".join(f"{v:.4f}" for v in tops))
    logger.log("=" * 50)
