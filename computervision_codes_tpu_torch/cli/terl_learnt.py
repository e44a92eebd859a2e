"""TERL learnT driver: the tail-enhanced contrastive spatial stage.

Counterpart of ``cli/terl_learnt.py`` in the JAX package (the reference's
TERL/6_baseline_learnT/run.py + test.py), with every one of its flags:
Swin + CAM heads + the MoCo queue and prototypes with the tail-aware
losses (``train.terl``). Evaluation scores i, v and t as the max of the
triplet probabilities over each component class (test.py:246-252);
``--dump`` writes ``k{fold}_feats.pkl`` (the pooled backbone feature) and
``k{fold}_pred.pkl`` (the ivt probabilities) for the TCN_black stage
(``cli.temporal_tcn --dedup_black``).

- ``--train``: SGD over ``batch_iterator(..., two_views=True)`` frames from
  disk, each batch's tail anchors picked on the host
  (``models.moco.select_tail_anchors``, ``--max_anchors_per_image`` a
  frame); ``--train_div`` cuts each epoch; validation every
  ``--val_interval`` epochs keeps ``_latest`` and the best (flax msgpack
  the JAX driver reads), and a ``w<w_epoch>`` snapshot after warmup;
  SIGTERM or SIGINT saves ``_latest`` and stops. ``--fused_train`` runs
  the query forward's Swin blocks through K6; ``--fix_backbone`` freezes
  the patch embed and stages 0-1 (``train.freeze_swin_early``); ``--ht``
  gives each task a head and a tail CAM head; ``--drop_classes`` takes
  triplet classes out of the ivt head (eval restores them as zeros);
  ``--optimizer sam`` takes SAM gradients. The tail anchors are the
  positives of every triplet class but the reference's head list
  (``HEAD_CLASSES``); ``--tail_num`` and ``--tail_classes_ivt`` are parsed
  and, as in the JAX driver, leave that set as it is (the reference takes
  the ``tail_num`` rarest, ``data.tail_stats.tail_triplet_classes``).
- ``--imagenet_pretrain`` (a published Swin ``.pth``) into
  ``encoder/backbone``, then the key module copied from it;
  ``--pretrain_dir`` starts from another TERL run's checkpoint;
  ``--resume`` from ``_latest``, whichever package wrote it.
- ``--test`` (with ``--eval_tag``: '' the best checkpoint, 'latest' the
  last) and ``--eval_train_tail`` (the last 9 training videos too);
  ``--cam_dump DIR``: per-task CAM overlay PNGs of up to ``--cam_frames``
  test frames (``utils.cam``).

    python -m computervision_codes_tpu_torch.cli.terl_learnt --data_dir D \\
        -t -e -d --mlp [--fused_train] [--ht] [--dtype bfloat16]

On the card the query's Swin blocks run K6 (under ``--fused_train``), the
key module's and every eval forward's run K3 and K4 (Swin-T's odd window
7: plan "split"). ``--device`` (default ``cuda``) is where the model runs.
``--device_augment`` ships each frame once, as uint8, and makes both
contrastive views from it on the device (``data.device_augment``,
``two_view``), each step's draws from a generator seeded from ``seed ^
0x2C0F``, the epoch and the step, as the JAX driver folds its key.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..data.device_augment import make_device_augment, step_generator
from ..data.feature_store import FeatureStore
from ..data.pipeline import CholecDataset, batch_iterator, video_eval_batches
from ..losses.components import component_max_logits
from ..models.moco import TERLModel, select_tail_anchors
from ..models.swin import swin_feature_dim
from ..train import (build_sgd, freeze_swin_early,
                     reference_warmup_exp_schedule)
from ..train.checkpoint import CheckpointManager
from ..train.terl import (create_terl_state, key_copy, make_terl_eval_step,
                          make_terl_train_step)
from ..utils.logging import ExperimentLogger
from ..utils.preempt import PreemptionGuard
from . import common

# the reference's head-class lists (TERL/6_baseline_learnT/run.py:224-227)
HEAD_CLASSES = {"ivt": (17, 60, 19), "i": (0, 2), "v": (1, 2), "t": (0, 8)}
TASK_NUM = {"ivt": 100, "i": 6, "v": 10, "t": 15}


def tail_head_masks(task: str):
    """(tail mask, head mask) of ``task``'s classes."""
    tail = np.ones(TASK_NUM[task], np.float32)
    tail[list(HEAD_CLASSES[task])] = 0.0
    return tail, 1.0 - tail


def parse_flags(argv: Optional[Sequence[str]] = None):
    p = common.common_parser("TERL learnT tail-contrastive stage "
                             "(PyTorch port)")
    p.add_argument("--backbone", type=str, default="swin_T_224_1k")
    p.add_argument("--img_size", type=int, default=224)
    p.add_argument("--moco_dim", type=int, default=768)
    p.add_argument("--moco_k", type=int, default=16384)
    p.add_argument("--moco_m", type=float, default=0.999)
    p.add_argument("--moco_t", type=float, default=0.07)
    p.add_argument("--mlp", action="store_true")
    p.add_argument("--fused_train", action="store_true",
                   help="train forward through the fused Swin kernels "
                        "(K6; plain backward)")
    p.add_argument("--fix_backbone", action="store_true",
                   help="freeze the Swin patch embed + stages 0-1 "
                        "(reference models/backbone.py:203-206)")
    p.add_argument("--ht", action="store_true",
                   help="separate head/tail CAM heads")
    p.add_argument("--w_epoch", type=int, default=5)
    p.add_argument("--drop_classes", type=int, nargs="+", default=[],
                   help="triplet class ids removed from the train head "
                        "(eval restores them as zeros, run.py:424-437)")
    p.add_argument("--tail_num", type=int, default=84,
                   help="number of rarest triplet classes treated as tail "
                        "(from ins_num.txt)")
    p.add_argument("--tail_classes_ivt", type=int, nargs="+", default=[],
                   help="explicit tail class list (overrides --tail_num)")
    p.add_argument("--eval_train_tail", action="store_true",
                   help="also evaluate the last 9 train videos "
                        "(reference build_test_train_dataset)")
    p.add_argument("--w_con", type=float, default=1.0)
    p.add_argument("--w_proto", type=float, default=1.0)
    p.add_argument("--w_tail", type=float, default=1.0)
    p.add_argument("--kcl_k", type=int, default=7)
    p.add_argument("--train_div", type=float, default=1.0)
    p.add_argument("--max_anchors_per_image", type=int, default=4)
    p.add_argument("--eval_tag", type=str, default="",
                   help="checkpoint tag for --test/--dump restore: '' = "
                        "best-by-val (reference protocol), 'latest' = "
                        "final epoch")
    p.add_argument("--cam_dump", type=str, default="",
                   help="directory: restore the checkpoint and write "
                        "per-task CAM overlay PNGs for test-split frames "
                        "(reference cam.py:200-278)")
    p.add_argument("--device_augment", action="store_true",
                   help="both contrastive views augmented on the device "
                        "from one uint8 upload (data/device_augment.py)")
    p.add_argument("--cam_frames", type=int, default=8,
                   help="max frames to render with --cam_dump")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the model runs on")
    flags, _ = p.parse_known_args(argv)
    return flags


def main(argv: Optional[Sequence[str]] = None) -> dict:
    flags = parse_flags(argv)
    generator = common.seed_everything(flags.seed)
    device = torch.device(flags.device)
    dtype = torch.bfloat16 if flags.dtype == "bfloat16" else torch.float32
    flags.moco_dim = swin_feature_dim(flags.backbone)  # see train/terl.py

    dataset = CholecDataset(flags.data_dir, flags.dataset_variant,
                            flags.kfold,
                            augmentation_list=flags.augmentation_list,
                            image_size=(flags.img_size, flags.img_size),
                            device_augment=flags.device_augment)
    split = dataset.split
    augment2 = (make_device_augment(tuple(flags.augmentation_list),
                                    two_view=True)
                if flags.device_augment else None)
    feats_root = flags.feats_dir or f"{flags.data_dir}/data_feats"

    modelname = common.build_modelname(flags) + "_learnT"
    model_dir = f"{flags.ckpt_root}/run_{flags.version}"
    logger = ExperimentLogger(model_dir, modelname)
    ckpt = CheckpointManager(model_dir, modelname)

    ht_masks = ({t: tail_head_masks(t)[::-1] for t in TASK_NUM}
                if flags.ht else None)  # (head mask, tail mask) a task
    tail_ivt_mask, _ = tail_head_masks("ivt")

    # class dropping (run.py:208-211,510): the ivt head covers only the
    # surviving classes; class_map sends their ids back to the 100
    valid_classes = [c for c in range(100) if c not in set(flags.drop_classes)]
    n_ivt = len(valid_classes)
    class_map = np.asarray(valid_classes, np.int64)
    tail_ivt_mask = tail_ivt_mask[class_map]
    if ht_masks is not None and n_ivt != 100:
        hm, tm = ht_masks["ivt"]
        ht_masks = dict(ht_masks, ivt=(hm[class_map], tm[class_map]))

    model = TERLModel(backbone=flags.backbone, moco_dim=flags.moco_dim,
                      mlp=flags.mlp, ht=flags.ht, num_triplet=n_ivt,
                      fused_train=flags.fused_train, dtype=dtype,
                      generator=generator)
    steps_per_epoch = max(1, len(dataset.frame_index(split.train))
                          // flags.batch)
    sched = reference_warmup_exp_schedule(
        flags.initial_learning_rates[2], flags.power, flags.warmups[2],
        flags.decay_rate, steps_per_epoch)
    optimizer = build_sgd(sched, flags.weight_decay)
    if flags.fix_backbone:
        optimizer = freeze_swin_early(optimizer)
    state = create_terl_state(model, optimizer, seed=flags.seed,
                              queue_size=flags.moco_k, device=device)
    if flags.imagenet_pretrain:
        # ImageNet Swin into the query encoder (the reference's regime:
        # runT.sh starts from pretrained backbones), then the key module
        # copied again, so MoCo's EMA starts from identical twins
        state = common.maybe_warm_start(flags, state, flags.backbone,
                                        logger, submodule="encoder/backbone")
        state.key_model = key_copy(state.model)
    if flags.pretrain_dir:
        # warm start from another TERL run's checkpoint (same model)
        state = CheckpointManager(flags.pretrain_dir, modelname).restore(
            state)
        logger.log(f"Warm-started from {flags.pretrain_dir}")
    state = common.maybe_resume(flags, ckpt, state, logger)

    max_anchors = flags.batch * flags.max_anchors_per_image
    train_step = make_terl_train_step(
        model, w_con=flags.w_con, w_proto=flags.w_proto, w_tail=flags.w_tail,
        w_epoch=flags.w_epoch, moco_m=flags.moco_m, moco_t=flags.moco_t,
        kcl_k=flags.kcl_k, use_mlp=flags.mlp, ht_masks=ht_masks,
        class_map=class_map if flags.drop_classes else None,
        sam_rho=flags.sam_rho if flags.optimizer == "sam" else 0.0)
    eval_step = make_terl_eval_step(model, ht_masks=ht_masks)

    def restore_full(probs_ivt: np.ndarray) -> np.ndarray:
        """Remapped ivt probabilities back to 100 classes (run.py:424-437)."""
        if n_ivt == 100:
            return probs_ivt
        full = np.zeros((probs_ivt.shape[0], 100), np.float32)
        full[:, class_map] = probs_ivt
        return full

    def run_batch(images):
        probs, feats = eval_step(state, images)
        ivt = torch.from_numpy(restore_full(
            probs["ivt"].float().cpu().numpy()))
        # component scores: the max over each class's triplets
        comp = component_max_logits(ivt)
        return ({"ivt": ivt.numpy(), **{k: v.numpy()
                                        for k, v in comp.items()}},
                feats.float().cpu().numpy())

    metrics = common.make_metrics()
    set_chlg = common.ignore_null_protocol("terl_learnt",
                                           flags.dataset_variant)
    logger.run_header("terl_learnt", modelname, flags.version, flags.batch,
                      f"backbone {flags.backbone} mocoK {flags.moco_k} "
                      f"dtype {flags.dtype} device {device}")
    result = {}

    if flags.train:
        losses, seconds = [], []
        with PreemptionGuard() as guard:
            for epoch in range(flags.epochs):
                t_epoch = time.perf_counter()
                n_batches = 0
                max_batches = steps_per_epoch / flags.train_div
                for batch in batch_iterator(dataset, split.train,
                                            flags.batch, train=True,
                                            seed=flags.seed + epoch,
                                            pad_last=True, two_views=True):
                    if n_batches > max_batches or guard.requested:
                        break  # --train_div's partial epoch (run.py:238)
                    lab_ivt = batch["label_ivt"][:, class_map]
                    s, c, v = select_tail_anchors(
                        lab_ivt * tail_ivt_mask[None, :], max_anchors)
                    if augment2 is not None:
                        img1, img2 = augment2(
                            step_generator(device, flags.seed ^ 0x2C0F,
                                           epoch, n_batches),
                            torch.as_tensor(batch["image"]).to(device))
                    else:
                        img1, img2 = batch["image"], batch["image2"]
                    tb = {"image1": img1, "image2": img2,
                          "anchor_sample": s, "anchor_class": c,
                          "anchor_valid": v,
                          "label_ivt": lab_ivt.astype(np.float32)}
                    for k in ("i", "v", "t"):
                        tb[f"label_{k}"] = batch[f"label_{k}"].astype(
                            np.float32)
                    state, m = train_step(state, tb, epoch)
                    n_batches += 1
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
                if epoch == flags.w_epoch - 1:
                    ckpt.save(state, tag=f"w{flags.w_epoch}")  # warmup
                if epoch % flags.val_interval == 0:
                    common.reset_metrics(metrics)
                    common.evaluate_videos(run_batch, dataset, split.val,
                                           flags.batch, metrics)
                    score = metrics["ivt"].compute_video_AP()["mAP"]
                    behaviour = ckpt.update(state, score, epoch,
                                            logger.logfile)
                    logger.log(f"epoch {epoch} val mAP[ivt] {score:.5f} "
                               f"ckpt {behaviour}")
        result["train_epochs"] = flags.epochs
        result["train_loss"] = losses
        result["train_seconds"] = seconds
        result["step"] = state.step

    if flags.test:
        if ckpt.exists(flags.eval_tag):
            state = ckpt.restore(state, tag=flags.eval_tag)
        common.reset_metrics(metrics)
        common.evaluate_videos(run_batch, dataset, split.test, flags.batch,
                               metrics)
        table = common.compute_map_table(metrics, "all", set_chlg)
        common.print_final_report(logger, table, metrics)
        result["test_mAP"] = {c: table[c]["mAP"] for c in table}
        print("test mAP:", {c: round(table[c]["mAP"], 4) for c in table})
        if flags.eval_train_tail:
            # the last 9 training videos (reference
            # build_test_train_dataset, dataloader.py:200-211)
            tt = common.make_metrics()
            common.evaluate_videos(run_batch, dataset, split.train[-9:],
                                   flags.batch, tt)
            score = tt["ivt"].compute_video_AP()["mAP"]
            logger.log(f"test-train (last 9 train videos) mAP[ivt] "
                       f"{score:.5f}")
            result["test_train_mAP"] = score

    if flags.dump:
        if ckpt.exists(flags.eval_tag):
            state = ckpt.restore(state, tag=flags.eval_tag)
        store = FeatureStore(feats_root, flags.version or "TERL")
        feats, preds = {}, {}
        for video in split.all_videos:
            chunks, pchunks = [], []
            for b in video_eval_batches(dataset, video, flags.batch):
                probs, f = run_batch(b["image"])
                chunks.append(f[b["valid"]])
                pchunks.append(probs["ivt"][b["valid"]])
            feats[video] = np.concatenate(chunks, 0)
            preds[video] = np.concatenate(pchunks, 0)
        fpath = store.save(flags.kfold, "feats", feats)
        ppath = store.save(flags.kfold, "pred", preds)
        logger.log(f"Dumped {fpath} and {ppath}")
        result["dump_paths"] = (fpath, ppath)

    if flags.cam_dump:
        result["cam_paths"] = cam_dump(flags, state, ckpt, dataset, split,
                                       class_map, ht_masks, logger)

    logger.close()
    return result


def cam_dump(flags, state, ckpt, dataset, split, class_map, ht_masks,
             logger) -> list:
    """Checkpoint -> CAM overlay PNGs (reference cam.py:200-278 draw_CAM):
    the JET map of each class's activation blended over the frame, for the
    ground-truth positives (up to 3 a task), or the top-1 prediction of a
    frame with none."""
    from ..utils.cam import denormalize_frame, draw_cam

    if ckpt.exists():
        ckpt.restore(state)
    os.makedirs(flags.cam_dump, exist_ok=True)
    dev = state.queue.feats.device
    paths, remaining = [], flags.cam_frames
    for video in split.test:
        if remaining <= 0:
            break
        row = 0  # the frame's index in the video
        for b in video_eval_batches(dataset, video, flags.batch):
            state.model.eval()
            with torch.inference_mode():
                out = state.model.encode(torch.from_numpy(b["image"]).to(dev),
                                         ht_masks)
            cams = {k: v.float().cpu().numpy() for k, v in out["cams"].items()}
            probs = {k: torch.sigmoid(v).float().cpu().numpy()
                     for k, v in out["logits"].items()}
            n_valid = int(b["valid"].sum())
            for i in range(n_valid):
                if remaining <= 0:
                    break
                base = denormalize_frame(b["image"][i])
                for task in ("ivt", "i", "v", "t"):
                    lab = (b["label_ivt"][i, class_map] if task == "ivt"
                           else b[f"label_{task}"][i])
                    cls = np.flatnonzero(lab > 0.5)
                    if cls.size == 0:  # reference cam.py:263-266
                        cls = [int(np.argmax(probs[task][i]))]
                    for c in cls[:3]:
                        path = os.path.join(
                            flags.cam_dump,
                            f"{video}_{row + i:06d}_{task}{int(c)}.png")
                        paths.append(draw_cam(base, cams[task][i, :, :,
                                                               int(c)], path))
                remaining -= 1
            row += n_valid
            if remaining <= 0:
                break
    logger.log(f"CAM dump: {len(paths)} overlays in {flags.cam_dump}")
    return paths


if __name__ == "__main__":
    main(sys.argv[1:])
