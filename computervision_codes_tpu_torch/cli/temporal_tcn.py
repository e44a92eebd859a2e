"""Temporal TCN driver: MT4MTLKD's student TCN stage and TERL's TCN_black.

Counterpart of ``cli/temporal_tcn.py`` in the JAX package, with every one
of its flags; one script covers both reference stages:

- MT4MTLKD/Temporal_tenco/run.py (the student TCN over the spatial
  student's features): ``--mask`` (the 75% train-time input mask), the loss
  0.1 (i + v + t) + ivt, no dedup;
- TERL/0_5fold_TCN_black/run.py (the TCN over TERL's features):
  ``--dedup_black`` (frozen frames dropped), the i/v/t pos-weights
  (``--weight_source sampling``, the constant sampling weights, or
  ``balancing``, ``data.class_weights``), ``--loss_type`` (``all``, ``i``,
  ``v``, ``t``, ``ivt``, ``single``: the mean of i, v and t) and
  ``--train_div`` (each epoch on 1 / div of the videos).

``--train`` runs one SGD step a video (shuffled by
``np.random.default_rng(--seed)``, a clip of each from ``sample_clip`` in
the JAX driver's order of draws), validation every ``--val_interval``
epochs (``_latest`` saved, the best kept by the val mAP of ``--loss_type``
or ivt), and SIGTERM or SIGINT saves ``_latest`` and stops; ``--resume``
continues from ``_latest``, whichever package wrote it
(``train.checkpoint``); ``--test`` prints the test mAP tables under the
challenge protocol of the stage (``challenge_protocol``).

    python -m computervision_codes_tpu_torch.cli.temporal_tcn -t -e \\
        --data_dir D --feats_version Res18 -k 1 --epochs 20 \\
        [--mask] [--dedup_black] [--loss_type single] [--device cuda]

The TCN trains in ``.train()`` on the plain path with its dropouts (the
JAX module does; its kernel has no backward) and evaluates in ``.eval()``,
where every dilated layer is kernel K1 on the card: 41 launches a forward
at the default depth. Each video, and each training clip, runs at its own
length. The JAX driver pads both with zeros to a power-of-two bucket
(``data.temporal.pad_sequence_batch``); its loss masks the padded frames,
but its TCN does not see the mask, so the padding's outputs enter every
non-causal layer of the real frames near the end (the reference runs each
video at its own length, Temporal_tenco/run.py:252-264). At a length equal
to a bucket the two drivers compute the same thing.

``--device`` (default ``cuda``) is where the model runs. Flags the driver
does not declare are ignored, as the JAX driver ignores them
(``parse_known_args``): the frame-level drivers' ``--dp_devices``,
``--tp_devices`` and ``--device_augment`` among them.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..data.feature_store import FeatureStore
from ..data.splits import resolve_split
from ..data.temporal import TemporalSequenceDataset, sample_clip
from ..losses import TARGET_POS_WEIGHT, TOOL_POS_WEIGHT, VERB_POS_WEIGHT
from ..models.tcn import TemporalTCN
from ..train import (build_sgd, create_train_state, make_tcn_eval_step,
                     reference_warmup_exp_schedule)
from ..train.checkpoint import CheckpointManager
from ..train.trainer import tcn_loss_step
from ..utils.logging import ExperimentLogger
from ..utils.preempt import PreemptionGuard
from . import common

LOSS_TYPES = ("all", "i", "v", "t", "ivt", "single")


def parse_flags(argv: Optional[Sequence[str]] = None):
    p = common.common_parser("Temporal TCN stage (PyTorch port)")
    p.add_argument("--feats_version", type=str, default="Res18",
                   help="feature-bus run version to read (reference version1)")
    p.add_argument("--feats_task", type=str, default="",
                   help="task suffix of the feats artifact ('' for student)")
    p.add_argument("--num_layers_PG", type=int, default=11)
    p.add_argument("--num_layers_R", type=int, default=10)
    p.add_argument("--num_R", type=int, default=3)
    p.add_argument("--num_f_maps", type=int, default=512)
    p.add_argument("--mask", action="store_true",
                   help="75%% random train-time feature masking")
    p.add_argument("--fpn", action="store_true", default=True)
    p.add_argument("--causal", action="store_true")
    p.add_argument("--hier", action="store_true",
                   help="hierarchical pyramid (avgpool k7 s3 per refinement)")
    p.add_argument("--dedup_black", action="store_true",
                   help="drop frozen/black frames (TERL TCN_black)")
    p.add_argument("--train_div", type=float, default=1.0,
                   help="train on 1/div of the videos per epoch")
    p.add_argument("--comp_weight", type=float, default=0.1)
    p.add_argument("--weight_source", choices=["sampling", "balancing"],
                   default="sampling",
                   help="i/v/t BCE pos-weights: 'sampling' = the constant "
                        "sampling-average weights the reference trains "
                        "with (0_5fold_TCN_black/run.py:432-435); "
                        "'balancing' = the per-variant/per-fold "
                        "get_weight_balancing tables (run.py:168-265)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the model runs on")
    flags, _ = p.parse_known_args(argv)
    return flags


def challenge_protocol(dedup_black: bool, dataset_variant: str) -> bool:
    """The ignore_null protocol of the eval tables, per driver mode: TCN_black
    (``--dedup_black``) hardcodes the challenge protocol
    (TERL/0_5fold_TCN_black/run.py:142), tenco mode derives it from the
    dataset variant (MT4MTLKD/Temporal_tenco/run.py:131)."""
    return common.ignore_null_protocol(
        "tcn_black" if dedup_black else "temporal_tenco", dataset_variant)


def make_loss_type_train_step(model, loss_type: str, comp_weight: float,
                              pos_weights, device="cuda"):
    """The train step with the TCN_black ``--loss_type`` branches
    (run.py:330-343): one task's loss, ``single`` the mean of i, v and t,
    ``all`` the fusion total. The step trains the state's module; ``model``
    is accepted for parity."""
    del model
    if loss_type not in LOSS_TYPES:
        raise ValueError(f"unknown loss_type {loss_type!r}; one of "
                         f"{LOSS_TYPES}")

    def select(parts):
        if loss_type in ("i", "v", "t", "ivt"):
            return parts[loss_type]
        if loss_type == "single":
            return (parts["i"] + parts["v"] + parts["t"]) / 3.0
        return parts["total"]

    return tcn_loss_step(select, comp_weight, pos_weights, apply_mask=True,
                         device=device)


def pos_weights_of(flags) -> Dict[str, np.ndarray]:
    """The i/v/t BCE pos-weights of ``--weight_source``."""
    if flags.weight_source == "balancing":
        from ..data.class_weights import weight_balancing

        wb = weight_balancing(flags.dataset_variant, flags.kfold)
        return {"i": np.asarray(wb["tool"], np.float32),
                "v": np.asarray(wb["verb"], np.float32),
                "t": np.asarray(wb["target"], np.float32)}
    return {"i": np.asarray(TOOL_POS_WEIGHT, np.float32),
            "v": np.asarray(VERB_POS_WEIGHT, np.float32),
            "t": np.asarray(TARGET_POS_WEIGHT, np.float32)}


def clip_batch(seq) -> Dict[str, np.ndarray]:
    """One sequence as a training batch at its own length."""
    return {"features": seq.features[None],
            **{f"label_{k}": a.astype(np.float32)
               for k, a in seq.labels.items()}}


def eval_video(state, eval_step, seq) -> Dict[str, np.ndarray]:
    """Per-frame sigmoid probabilities (T, C) of each task for one video at
    its own length, float32 numpy."""
    probs = eval_step(state, seq.features[None])
    return {k: v[0].float().cpu().numpy() for k, v in probs.items()}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    flags = parse_flags(argv)
    if flags.loss_type not in LOSS_TYPES:
        raise ValueError(f"unknown --loss_type {flags.loss_type!r}; one of "
                         f"{LOSS_TYPES}")
    generator = common.seed_everything(flags.seed)
    np_rng = np.random.default_rng(flags.seed)
    device = torch.device(flags.device)
    dtype = torch.bfloat16 if flags.dtype == "bfloat16" else torch.float32

    feats_root = flags.feats_dir or f"{flags.data_dir}/data_feats"
    store = FeatureStore(feats_root, flags.feats_version)
    split = resolve_split(flags.dataset_variant, flags.kfold)
    ds = TemporalSequenceDataset(flags.data_dir, store, flags.kfold,
                                 split.all_videos, task=flags.feats_task,
                                 dedup_black=flags.dedup_black)
    in_dim = ds[split.train[0]].features.shape[1]

    modelname = common.build_modelname(flags) + "_tcn"
    model_dir = f"{flags.ckpt_root}/run_{flags.version}"
    logger = ExperimentLogger(model_dir, modelname)
    ckpt = CheckpointManager(model_dir, modelname)

    model = TemporalTCN(in_dim, num_layers_pg=flags.num_layers_PG,
                        num_layers_r=flags.num_layers_R,
                        num_refinements=flags.num_R,
                        num_f_maps=flags.num_f_maps, use_fpn=flags.fpn,
                        causal=flags.causal, hier=flags.hier,
                        mask_rate=0.75 if flags.mask else 0.0, dtype=dtype,
                        generator=generator)
    sched = reference_warmup_exp_schedule(
        flags.initial_learning_rates[2], flags.power, flags.warmups[2],
        flags.decay_rate, steps_per_epoch=max(1, len(split.train)))
    state = create_train_state(model, build_sgd(sched, flags.weight_decay),
                               seed=flags.seed, device=device)
    state = common.maybe_resume(flags, ckpt, state, logger)
    train_step = make_loss_type_train_step(
        model, flags.loss_type, flags.comp_weight, pos_weights_of(flags),
        device)
    eval_step = make_tcn_eval_step(model, device)

    def run_eval(videos, metrics):
        ms = {}
        for video in videos:
            seq = ds[video]
            t0 = time.perf_counter()
            probs = eval_video(state, eval_step, seq)
            ms[video] = (time.perf_counter() - t0) * 1e3  # ends on the host
            for key, m in metrics.items():
                m.update(seq.labels[key], probs[key])
                m.video_end()
        return ms

    metrics = common.make_metrics()
    set_chlg = challenge_protocol(flags.dedup_black, flags.dataset_variant)
    logger.run_header("temporal_tcn", modelname, flags.version, 1,
                      f"peak {flags.initial_learning_rates[2]} warmup "
                      f"{flags.warmups[2]} decay {flags.decay_rate} dtype "
                      f"{flags.dtype} device {device}")
    result: Dict = {"eval_ms": {}}

    if flags.train:
        losses, seconds, frames = [], [], []
        # the handlers are restored on leaving: main may run in a process
        # that goes on
        with PreemptionGuard() as guard:
            for epoch in range(flags.epochs):
                t_epoch, n_frames = time.perf_counter(), 0
                order = list(split.train)
                np_rng.shuffle(order)
                order = order[: max(1, int(len(order) / flags.train_div))]
                for video in order:
                    if guard.requested:
                        break
                    seq = sample_clip(np_rng, ds[video])
                    state, m = train_step(state, clip_batch(seq))
                    n_frames += seq.length
                if guard.requested:
                    ckpt.save(state, tag="latest")
                    logger.log("preemption signal: saved _latest, "
                               "stopping training (resume with --resume)")
                    result["preempted"] = True
                    break
                scalars = {k: float(v) for k, v in m.items()}
                losses.append(scalars)
                seconds.append(time.perf_counter() - t_epoch)
                frames.append(n_frames)
                logger.scalars("train/loss", scalars, epoch)
                if epoch % flags.val_interval == 0:
                    common.reset_metrics(metrics)
                    run_eval(split.val, metrics)
                    selector = flags.loss_type if flags.loss_type in \
                        ("i", "v", "t") else "ivt"
                    score = metrics[selector].compute_video_AP()["mAP"]
                    behaviour = ckpt.update(state, score, epoch,
                                            logger.logfile)
                    logger.log(f"epoch {epoch} val mAP[{selector}] "
                               f"{score:.5f} ckpt {behaviour}")
        result["train_epochs"] = flags.epochs
        result["train_loss"] = losses
        result["train_seconds"] = seconds  # each epoch's loop, host clock
        result["train_frames"] = frames  # the frames of each epoch's clips
        result["step"] = state.step

    if flags.test:
        if ckpt.exists():
            state = ckpt.restore(state)
        common.reset_metrics(metrics)
        result["eval_ms"]["test"] = run_eval(split.test, metrics)
        table = common.compute_map_table(metrics, flags.loss_type, set_chlg)
        common.print_final_report(logger, table, metrics)
        result["test_mAP"] = {c: table[c]["mAP"] for c in table}
        print("test mAP:", {c: round(table[c]["mAP"], 4) for c in table})

    logger.close()
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
