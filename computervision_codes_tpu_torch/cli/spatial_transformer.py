"""Spatial transformer teacher driver (MT4MTLKD stage 1: Swin/Q2L).

Counterpart of ``cli/spatial_transformer.py`` in the JAX package (the
reference MT4MTLKD/Spatial_transformer/run.py + test.py), with every one of
its flags and ``--device`` (default ``cuda``, where the model runs):

- ``--train``: SGD (``build_sgd`` with the reference's warmup-exponential
  schedule) over ``batch_iterator(..., train=True, seed=seed + epoch,
  pad_last=True)`` frames from disk; for ``--loss_type all`` the teachers'
  artifacts (``--teacher_feat_version`` features, ``--teacher_pred_version``
  predictions) ride along each frame and the step adds the soft KL and the
  KD block's feature loss at ``--rates``. Validation every
  ``--val_interval`` epochs, with the float model, saves ``_latest`` and,
  when the val mAP improves, the best checkpoint (flax msgpack the JAX
  driver reads); SIGTERM or SIGINT saves ``_latest`` and stops.
  ``--break_after_first_epoch`` copies the reference's epoch-0 break.
- ``--resume`` (``_latest``: weights, step, the schedule's count) and
  ``--imagenet_pretrain`` (a published Swin / ResNet / TResNet ``.pth``).
- ``--test`` (the test mAP table) and ``--dump`` (every video's feature,
  ``k{fold}[_{task}]_feats.pkl`` under ``run_<version or Q2L>``, the
  artifact the MS-TCT and student stages read), from the best checkpoint
  when there is one. Under ``--quant_eval`` these two run the int8 twin
  ``Q2L(quant_eval=True, quant_min_dim)`` with the state's weights;
  validation stays on the float model (PTQ noise must not pick the
  checkpoint).
- ``main`` returns the losses, the step, ``train_seconds`` (each epoch's
  training loop on the host clock, up to its losses read back), the test
  mAP table and the dump's path.

Probabilities are the sigmoid of the logits in the model dtype; the
dumped features are float32 (numpy has no bfloat16), holding the model's
values exactly. On the card the Swin blocks run K3, K4 and K5 in eval and
K6 under ``--fused_train``. ``--device_augment`` ships each training
batch's frames as uint8 and augments and normalises them on ``--device``
(``data.device_augment``), each step's draws from a generator seeded from
``seed ^ 0x5EED`` and the step's number, as the JAX driver folds its key.

``--dp_devices`` x ``--tp_devices`` ranks (started by this one command,
``parallel.mesh.launch``, or joined under ``torchrun``) train on a (data,
model) mesh: the batch is split over ``data`` and the gradients averaged
over it (under ``--device_augment`` every rank draws the numbers of the
whole batch and keeps its rows, as on one device), and ``parallel.tp``
splits the transformer's Dense pairs over ``model`` (Megatron column ->
row). As the JAX driver forces, tensor parallelism takes the plain path:
no ``--fused_train``, no ``--quant_eval`` and ``fused_eval=False``, so no
kernel runs under it.
Checkpoints hold the whole parameters (gathered over ``model`` for the
write, cut again after a restore); rank 0 writes them, the logs and the
dump.

    python -m computervision_codes_tpu_torch.cli.spatial_transformer \\
        --data_dir D -t -e -d [--loss_type all --rates 1 0.5 0.1] \\
        [--fused_train --remat] [--dtype bfloat16] [--device cuda]
"""

from __future__ import annotations

import sys
import time
from typing import Optional, Sequence

import torch

from ..data.device_augment import make_device_augment, step_generator
from ..data.feature_store import FeatureStore
from ..data.pipeline import CholecDataset, batch_iterator
from ..losses import TARGET_POS_WEIGHT, TOOL_POS_WEIGHT, VERB_POS_WEIGHT
from ..models.q2l import Q2L
from ..parallel.mesh import batch_sharding, local_slice, replicate
from ..parallel.tp import shard_state_tp
from ..train import (build_sgd, create_train_state, make_spatial_eval_step,
                     make_spatial_train_step, reference_warmup_exp_schedule)
from ..utils.preempt import PreemptionGuard
from . import common


def parse_flags(argv: Optional[Sequence[str]] = None):
    p = common.common_parser("MT4MTLKD spatial transformer teacher "
                             "(PyTorch port)")
    p.add_argument("--backbone", type=str, default="swin_L_384_22k")
    p.add_argument("--rates", type=float, nargs="+", default=[1, 0, 0.1])
    p.add_argument("--teacher_feat_version", type=str, default="Res18")
    p.add_argument("--teacher_pred_version", type=str, default="Res18TCN")
    p.add_argument("--break_after_first_epoch", action="store_true",
                   help="reproduce the reference's epoch-0 break quirk")
    p.add_argument("--quant_eval", action="store_true",
                   help="int8 GEMMs in the Swin kernels for the test and "
                        "dump passes (PTQ; training and validation stay "
                        "float)")
    p.add_argument("--quant_min_dim", type=int, default=768,
                   help="smallest stage dim quantized by --quant_eval")
    p.add_argument("--fused_train", action="store_true",
                   help="train forward through the fused Swin kernels "
                        "(K6), the plain version's backward")
    p.add_argument("--remat", action="store_true",
                   help="recompute each Swin block in the backward")
    p.add_argument("--remat_policy", type=str, default="dots",
                   choices=["dots", "none"],
                   help="'dots' keeps the GEMM outputs; 'none' recomputes "
                        "everything")
    p.add_argument("--dp_devices", type=int, default=0,
                   help="data-parallel devices (batch split over the mesh "
                        "data axis; 0 or 1 = one device)")
    p.add_argument("--device_augment", action="store_true",
                   help="train-time augmentation and normalisation on the "
                        "device (data/device_augment.py): the host only "
                        "decodes and resizes")
    p.add_argument("--tp_devices", type=int, default=0,
                   help="tensor-parallel devices: the Megatron split of "
                        "parallel/tp.py over the mesh model axis; composes "
                        "with --dp_devices")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the model runs on")
    flags, _ = p.parse_known_args(argv)
    return flags


def main(argv: Optional[Sequence[str]] = None) -> dict:
    flags = parse_flags(argv)
    n_data, n_model = max(1, flags.dp_devices), max(1, flags.tp_devices)
    if n_data * n_model > 1 and not torch.distributed.is_initialized():
        return common.launch_ranks(main, argv, flags, n_data * n_model)
    with common.parallel_context(flags, n_data, n_model) as place:
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

    modelname = common.build_modelname(flags) + f"_{flags.loss_type}"
    model_dir = f"{flags.ckpt_root}/run_{flags.version}"
    logger = place.logger(model_dir, modelname)
    ckpt = place.checkpoints(model_dir, modelname)

    # the kernels take whole weights: tensor parallelism takes the plain
    # path, as the JAX driver forces its XLA path
    tp_active = flags.tp_devices > 1
    if tp_active and (flags.fused_train or flags.quant_eval):
        print("[tp] --tp_devices forces the plain path: ignoring "
              "--fused_train/--quant_eval (the kernels take whole weights)")
    model_kw = dict(backbone=flags.backbone, loss_type=flags.loss_type,
                    teacher_dim=flags.teacher_dim, dtype=dtype)
    model = Q2L(**model_kw, remat=flags.remat,
                remat_policy="" if flags.remat_policy == "none"
                else flags.remat_policy,
                fused_train=flags.fused_train and not tp_active,
                fused_eval=False if tp_active else None,
                generator=generator)
    steps_per_epoch = max(1, len(dataset.frame_index(split.train))
                          // flags.batch)
    sched = reference_warmup_exp_schedule(
        flags.initial_learning_rates[2], flags.power, flags.warmups[2],
        flags.decay_rate, steps_per_epoch)
    state = create_train_state(model, build_sgd(sched, flags.weight_decay),
                               seed=flags.seed, device=device)
    state = common.maybe_warm_start(flags, state, flags.backbone, logger)
    state = common.maybe_resume(flags, ckpt, state, logger)
    if mesh is not None:
        state.model = replicate(state.model, mesh)
        state = shard_state_tp(state, mesh)

    pos_weights = {"i": TOOL_POS_WEIGHT, "v": VERB_POS_WEIGHT,
                   "t": TARGET_POS_WEIGHT}
    train_step = make_spatial_train_step(model, flags.loss_type, flags.rates,
                                         flags.temp, pos_weights,
                                         device=device, mesh=mesh)
    # validation picks the checkpoint with the float model; the int8 twin
    # serves only the final --test and --dump passes
    val_step = make_spatial_eval_step(model, device=device)
    eval_step = val_step
    if flags.quant_eval and not tp_active:
        twin = Q2L(**model_kw, quant_eval=True,
                   quant_min_dim=flags.quant_min_dim).to(device)
        eval_step = make_spatial_eval_step(twin, device=device)

    def run_batch(images):
        return common.host_outputs(*eval_step(state, images))

    def run_batch_val(images):
        return common.host_outputs(*val_step(state, images))

    metrics = common.make_metrics()
    set_chlg = common.ignore_null_protocol("spatial_transformer",
                                           flags.dataset_variant)
    logger.run_header("spatial_transformer", modelname, flags.version,
                      flags.batch, f"backbone {flags.backbone} dtype "
                      f"{flags.dtype} device {device}")
    result = {}
    augment = (make_device_augment(
        tuple(flags.augmentation_list),
        sharding=None if mesh is None else batch_sharding(mesh))
        if flags.device_augment else None)

    if flags.train:
        losses, seconds = [], []
        step_no = 0
        # the handlers are restored on leaving: main may run in a process
        # that goes on
        with PreemptionGuard() as guard:
            for epoch in range(flags.epochs):
                t_epoch = time.perf_counter()
                for batch in batch_iterator(dataset, split.train,
                                            flags.batch, train=True,
                                            seed=flags.seed + epoch,
                                            teacher_dim=flags.teacher_dim,
                                            pad_last=True):
                    if guard.requested:
                        break
                    batch.pop("valid")
                    if mesh is not None:  # this rank's rows of the batch
                        batch = {k: local_slice(v, batch_sharding(mesh))
                                 for k, v in batch.items()}
                    if augment is not None:
                        batch["image"] = augment(
                            step_generator(device, flags.seed ^ 0x5EED,
                                           step_no),
                            torch.as_tensor(batch["image"]).to(device))
                        step_no += 1
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
                    common.reset_metrics(metrics)
                    common.evaluate_videos(run_batch_val, dataset, split.val,
                                           flags.batch, metrics)
                    sel = flags.loss_type if flags.loss_type in (
                        "i", "v", "t") else "ivt"
                    score = metrics[sel].compute_video_AP()["mAP"]
                    behaviour = ckpt.update(state, score, epoch,
                                            logger.logfile)
                    logger.log(f"epoch {epoch} val mAP[{sel}] {score:.5f} "
                               f"ckpt {behaviour}")
                if flags.break_after_first_epoch:
                    break  # reference run.py:480 quirk
        result["train_epochs"] = flags.epochs
        result["train_loss"] = losses
        result["train_seconds"] = seconds
        result["step"] = state.step

    if flags.test:
        if ckpt.exists():
            state = ckpt.restore(state)
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
        store = FeatureStore(feats_root, flags.version or "Q2L")
        feats = common.evaluate_videos(run_batch, dataset, split.all_videos,
                                       flags.batch, common.make_metrics(),
                                       collect_features=True)
        task = flags.loss_type if flags.loss_type in ("i", "v", "t") else ""
        if common.is_rank_zero():
            path = store.save(flags.kfold, "feats", feats, task=task)
            logger.log(f"Dumped features to {path}")
            result["dump_path"] = path

    logger.close()
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
