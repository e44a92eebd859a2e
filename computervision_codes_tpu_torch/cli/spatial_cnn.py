"""Spatial CNN student driver (MT4MTLKD stage 3).

Counterpart of ``cli/spatial_cnn.py`` in the JAX package (the reference
MT4MTLKD/Spatial_cnn/run.py + test.py), with every one of its flags and
``--device`` (default ``cuda``, where the model runs): train the ResNet
student (with multi-teacher KD under ``--loss_type all``: the Q2L
teacher's features ``--teacher_feat_version`` and the MS-TCT teacher's
predictions ``--teacher_pred_version`` from the feature bus), evaluate per
video, keep ``_latest`` and the best checkpoint, and dump every video's
feature (``k{fold}[_{task}]_feats.pkl`` under ``run_<version or Res18>``,
what the temporal TCN stage reads).

- ``--optimizer sam`` takes the gradient by two-step SAM at
  ``--sam_rho`` (the BatchNorm statistics from the perturbed pass);
  ``--qat`` trains through the int8 weight fake-quant of the serving path
  and evaluates and dumps the fake-quant weights.
- ``--imagenet_pretrain`` warm-starts the backbone from torchvision's
  ``.pth`` (``models.pretrained``); ``--pretrain_dir`` restores a
  checkpoint of this driver; ``--resume`` continues from ``_latest``.
- Training batches are decoded and augmented on a host thread and copied
  to the device by ``data.prefetch.prefetch_to_device``.
- ``main`` returns the losses, the step, ``train_seconds`` (each epoch's
  training loop on the host clock, up to its losses read back), the test
  mAP table and the dump's path.

The student runs on cuDNN and cuBLAS, as the JAX student runs plain XLA:
no kernel of the port sits on this path. ``--device_augment`` ships the
training frames as uint8 and augments and normalises them on ``--device``
(``data.device_augment``), each step's draws from a generator seeded from
``seed ^ 0x5EED``, the epoch and the step, as the JAX driver folds its
key.

``--dp_devices N`` trains data-parallel on N ranks, started by this one
command (``parallel.mesh.launch``; or joined under ``torchrun``), one per
device: each rank takes its 1/N of every batch, training-mode BatchNorm
takes the moments of the whole batch and the gradients (and SAM's norm)
are averaged over the ranks, so that the step is the single-device step on
the global batch, as JAX's under a batch-sharded mesh. Under
``--device_augment`` every rank draws the numbers of the whole batch and
keeps its rows, so each frame is augmented as on one device. Evaluation
runs whole on every rank; rank 0 writes the logs, checkpoints and dump.

    python -m computervision_codes_tpu_torch.cli.spatial_cnn \\
        --data_dir D -t -e -d [--loss_type all --rates 1 0.5 0.1] \\
        [--optimizer sam] [--qat] [--device cuda]
"""

from __future__ import annotations

import sys
import time
from typing import Optional, Sequence

import torch

from ..data.device_augment import make_device_augment, step_generator
from ..data.feature_store import FeatureStore
from ..data.pipeline import CholecDataset, batch_iterator
from ..data.prefetch import prefetch_to_device
from ..losses import TARGET_POS_WEIGHT, TOOL_POS_WEIGHT, VERB_POS_WEIGHT
from ..models.spatial_cnn import SpatialCNN
from ..parallel.mesh import batch_sharding, replicate
from ..train import (build_sgd, create_train_state, make_spatial_eval_step,
                     make_spatial_train_step, reference_warmup_exp_schedule)
from ..train.checkpoint import CheckpointManager
from ..utils.preempt import PreemptionGuard
from . import common


def parse_flags(argv: Optional[Sequence[str]] = None):
    p = common.common_parser("MT4MTLKD spatial CNN student (PyTorch port)")
    p.add_argument("--rates", type=float, nargs="+", default=[1, 0, 0.1])
    p.add_argument("--teacher_feat_version", type=str, default="Q2L")
    p.add_argument("--teacher_pred_version", type=str, default="Q2LMSTCT")
    p.add_argument("--qat", action="store_true",
                   help="quantization-aware fine-tune: train through the "
                        "int8 weight fake-quant the serving path applies "
                        "(models/qat.py); eval/dump run the fake-quant "
                        "weights")
    p.add_argument("--dp_devices", type=int, default=0,
                   help="data-parallel devices (batch split over the mesh "
                        "data axis; 0 or 1 = one device)")
    p.add_argument("--device_augment", action="store_true",
                   help="train-time augmentation and normalisation on the "
                        "device (data/device_augment.py): the host only "
                        "decodes and resizes")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the model runs on")
    flags, _ = p.parse_known_args(argv)
    return flags


def main(argv: Optional[Sequence[str]] = None) -> dict:
    flags = parse_flags(argv)
    n_data = max(1, flags.dp_devices)
    if n_data > 1 and not torch.distributed.is_initialized():
        return common.launch_ranks(main, argv, flags, n_data)
    with common.parallel_context(flags, n_data) as place:
        return _main(flags, place)


def _main(flags, place) -> dict:
    mesh, device = place.mesh, place.device
    generator = common.seed_everything(flags.seed)
    dtype = torch.bfloat16 if flags.dtype == "bfloat16" else torch.float32

    dataset = CholecDataset(flags.data_dir, flags.dataset_variant,
                            flags.kfold,
                            augmentation_list=flags.augmentation_list,
                            image_size=(flags.image_height,
                                        flags.image_width),
                            device_augment=flags.device_augment)
    split = dataset.split
    feats_root = flags.feats_dir or f"{flags.data_dir}/data_feats"
    if flags.loss_type == "all" and flags.train:
        dataset.attach_teachers(
            FeatureStore(feats_root, flags.teacher_feat_version),
            FeatureStore(feats_root, flags.teacher_pred_version),
            flags.kfold, split.train)

    modelname = common.build_modelname(flags)
    model_dir = f"{flags.ckpt_root}/run_{flags.version}"
    logger = place.logger(model_dir, modelname)
    ckpt = place.checkpoints(model_dir, modelname)

    model = SpatialCNN(network=flags.network, loss_type=flags.loss_type,
                       teacher_dim=flags.teacher_dim, dtype=dtype,
                       generator=generator)
    steps_per_epoch = max(
        1, len(dataset.frame_index(split.train)) // flags.batch)
    sched = reference_warmup_exp_schedule(
        flags.initial_learning_rates[2], flags.power, flags.warmups[2],
        flags.decay_rate, steps_per_epoch)
    state = create_train_state(model, build_sgd(sched, flags.weight_decay),
                               seed=flags.seed, device=device)
    state = common.maybe_warm_start(flags, state, flags.network, logger)
    if flags.pretrain_dir:
        state = CheckpointManager(flags.pretrain_dir, modelname).restore(
            state)
    state = common.maybe_resume(flags, ckpt, state, logger)
    batch_sh = None
    if mesh is not None:
        state.model = replicate(state.model, mesh)
        batch_sh = batch_sharding(mesh)

    pos_weights = {"i": TOOL_POS_WEIGHT, "v": VERB_POS_WEIGHT,
                   "t": TARGET_POS_WEIGHT}
    train_step = make_spatial_train_step(
        model, flags.loss_type, flags.rates, flags.temp, pos_weights,
        sam_rho=flags.sam_rho if flags.optimizer == "sam" else 0.0,
        qat=flags.qat, device=device, mesh=mesh)
    eval_step = make_spatial_eval_step(model, qat=flags.qat, device=device)

    def run_batch(images):
        return common.host_outputs(*eval_step(state, images))

    metrics = common.make_metrics()
    set_chlg = common.ignore_null_protocol("spatial_cnn",
                                           flags.dataset_variant)
    logger.run_header("spatial_cnn", modelname, flags.version, flags.batch,
                      f"peak {flags.initial_learning_rates} warmup "
                      f"{flags.warmups} decay {flags.decay_rate} dtype "
                      f"{flags.dtype} device {device}")
    result = {}
    augment = (make_device_augment(tuple(flags.augmentation_list),
                                   sharding=batch_sh)
               if flags.device_augment else None)

    if flags.train:
        losses, seconds = [], []
        with PreemptionGuard() as guard:
            for epoch in range(flags.epochs):
                logger.log(f"Training | epoch {epoch}")
                t_epoch = time.perf_counter()
                stream = batch_iterator(dataset, split.train, flags.batch,
                                        train=True, seed=flags.seed + epoch,
                                        teacher_dim=flags.teacher_dim,
                                        drop_last=False, pad_last=True)
                stream = ({k: v for k, v in b.items() if k != "valid"}
                          for b in stream)
                for step_no, batch in enumerate(
                        prefetch_to_device(stream, device=device,
                                           sharding=batch_sh)):
                    if guard.requested:
                        break
                    if augment is not None:
                        batch["image"] = augment(step_generator(
                            device, flags.seed ^ 0x5EED, epoch, step_no),
                            batch["image"])
                    state, m = train_step(state, batch)
                if guard.requested:
                    ckpt.save(state, tag="latest")
                    logger.log("preemption signal: saved _latest, stopping "
                               "training (resume with --resume)")
                    result["preempted"] = True
                    break
                scalars = {k: float(v) for k, v in m.items()}
                losses.append(scalars)
                seconds.append(time.perf_counter() - t_epoch)
                logger.scalars("train/loss", scalars, epoch)
                if epoch % flags.val_interval == 0:
                    start = time.time()
                    common.reset_metrics(metrics)
                    logger.log(f"Evaluating @ epoch: {epoch}")
                    common.evaluate_videos(run_batch, dataset, split.val,
                                           flags.batch, metrics)
                    # the trained task for single-task runs, disentangled
                    # ivt otherwise (reference run.py:425-432)
                    selector = flags.loss_type if flags.loss_type in \
                        ("i", "v", "t") else "ivt"
                    score = metrics[selector].compute_video_AP()["mAP"]
                    behaviour = ckpt.update(state, score, epoch,
                                            logger.logfile)
                    table = common.compute_map_table(
                        metrics, flags.loss_type, set_chlg)
                    logger.scalars("val/mAP", {f"mAP_{c}": table[c]["mAP"]
                                               for c in table}, epoch)
                    logger.log(f"\tval | eta {time.time() - start:.2f}s | "
                               f"mAP ivt [{table['ivt']['mAP']:.5f}] | "
                               f"ckpt {behaviour}")
        result["train_epochs"] = flags.epochs
        result["train_loss"] = losses
        result["train_seconds"] = seconds
        result["step"] = state.step

    if flags.test:
        if ckpt.exists():
            state = ckpt.restore(state)
        logger.log(f"Test weight: {ckpt.path('')}")
        common.reset_metrics(metrics)
        common.evaluate_videos(run_batch, dataset, split.test, flags.batch,
                               metrics)
        table = common.compute_map_table(metrics, flags.loss_type, set_chlg)
        common.print_final_report(logger, table, metrics)
        result["test_mAP"] = {c: table[c]["mAP"] for c in table}
        print("test mAP:", {c: round(table[c]["mAP"], 4) for c in table})

    if flags.dump:
        if ckpt.exists():
            state = ckpt.restore(state)
        store = FeatureStore(feats_root, flags.version or "Res18")
        feats = common.evaluate_videos(run_batch, dataset, split.all_videos,
                                       flags.batch, common.make_metrics(),
                                       collect_features=True)
        task = "" if flags.loss_type in ("all", "ivt") else flags.loss_type
        if common.is_rank_zero():
            path = store.save(flags.kfold, "feats", feats, task=task)
            logger.log(f"Dumped features for {len(feats)} videos to {path}")
            result["dump_path"] = path

    logger.close()
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
