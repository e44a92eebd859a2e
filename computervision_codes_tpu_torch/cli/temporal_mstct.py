"""MS-TCT temporal teacher driver (MT4MTLKD stage 2): training, full-video
eval and the feature-bus dump.

Counterpart of ``cli/temporal_mstct.py`` in the JAX package, with every
one of its flags:

- ``--train``: SGD (``build_sgd`` with the reference's warmup-exponential
  schedule, momentum 0, as the JAX driver) on random ``--window``-frame
  windows of cached Q2L features, ``-b`` windows per step, with
  ``bce_with_logits`` and the task's pos-weights; the windows come from
  ``np.random.default_rng(--seed)`` in the JAX driver's order (shuffle the
  training videos, then one ``sample_window`` per video of the group), so
  a seed gives both drivers the same windows. Validation every
  ``--val_interval`` epochs saves ``_latest`` and, when the val mAP
  improves, the best checkpoint (``train.checkpoint.CheckpointManager``,
  flax msgpack that the JAX driver reads); ``--log_train_map`` logs each
  epoch's train mAP; SIGTERM or SIGINT saves ``_latest`` and stops.
- ``--resume``: continue from ``_latest`` (weights, step, the schedule's
  count), whichever package wrote it.
- ``--test`` (the test mAP over the fold's test videos) and ``--dump``
  (per-frame features and sigmoid predictions of every video,
  ``k{fold}_{task}_{feats,pred}.pkl`` under ``run_<version or
  Q2LMSTCT>``, the artifacts the KD student reads), from the best
  checkpoint when there is one, else from the weights in hand.

    python -m computervision_codes_tpu_torch.cli.temporal_mstct \\
        --data_dir D -t [-e -d] [--resume] [--log_train_map] \\
        [--dtype bfloat16] [--device cuda]

Two faults of the JAX driver that the port does not copy, following the
reference. Eval: each video is evaluated whole, at its own length; the JAX
driver pads it with zeros to a power-of-two bucket, and MS-TCT then
attends over the padded frames with no key mask, so there a real frame's
output depends on its bucket (the reference, Temporal_mstct/run.py:248,
runs every video at its own length). Training: a video shorter than
``--window`` gives a shorter window; the JAX driver zero-pads every window
of a group to the longest, so the padding enters attention and the BCE
(with labels of 0); here windows of one length go through the model
together and a shorter one at its own length, each window's loss is the
BCE over its own frames, and the group's loss is the mean of its windows'
losses, with one SGD step per group as in JAX (the reference computes a
loss per sample, Temporal_mstct/run.py:159-196). When every window is full
length, as on CholecT45, this is the JAX loss.

Probabilities are the sigmoid of the logits in the model dtype, as the
JAX ``eval_fn``; the dumped arrays are float32 (numpy has no bfloat16),
holding those values exactly. ``--device`` (default ``cuda``) is where the
model runs: on the card attention is kernel K7 (``ops/attention.py``),
differentiated through its plain version as in JAX.

``--seq_devices N`` evaluates (``-e``, ``-d`` and validation) with each
video's frames split over N ranks (``parallel.long_video.eval_sharded``,
started by this one command or joined under ``torchrun``): the temporal
convolutions exchange halos and the attention gathers the keys and values
(``--seq_attn gather``, K7 on the card) or rings them (``ring``:
``MSTCT.ring_mesh``, K8's forward per block). A video whose length does
not divide by N is padded with zero frames at its end to the next multiple
and the outputs trimmed; the padded frames are keys of the attention, as
the JAX driver's bucket padding is. Training runs whole on every rank;
rank 0 writes the logs, checkpoints and dumps.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.feature_store import FeatureStore
from ..data.splits import resolve_split
from ..data.temporal import TemporalSequenceDataset, sample_window
from ..losses import (
    TARGET_POS_WEIGHT,
    TOOL_POS_WEIGHT,
    VERB_POS_WEIGHT,
    bce_with_logits,
)
from ..metrics import Recognition
from ..models.mstct import MSTCT
from ..train import (build_sgd, create_train_state,
                     reference_warmup_exp_schedule)
from ..train.state import TrainState
from ..utils.preempt import PreemptionGuard
from . import common

TASK_INFO = {"i": (6, TOOL_POS_WEIGHT), "v": (10, VERB_POS_WEIGHT),
             "t": (15, TARGET_POS_WEIGHT), "ivt": (100, None)}


def parse_flags(argv: Optional[Sequence[str]] = None):
    p = common.common_parser("MS-TCT temporal teacher (PyTorch port)")
    p.add_argument("--feats_version", type=str, default="Q2L")
    p.add_argument("--window", type=int, default=256)
    p.add_argument("--inter_channels", type=int, nargs="+",
                   default=[256, 384, 576, 864])
    p.add_argument("--num_block", type=int, default=2)
    p.add_argument("--head", type=int, default=8)
    p.add_argument("--mlp_ratio", type=float, default=8.0)
    p.add_argument("--final_embedding_dim", type=int, default=512)
    p.add_argument("--log_train_map", action="store_true",
                   help="log per-epoch train mAP (the reference logs train "
                        "mAP every batch, run.py:159-196)")
    p.add_argument("--seq_devices", type=int, default=0,
                   help="context-parallel full-video eval: shard T over "
                        "this many devices (0 or 1 = one device)")
    p.add_argument("--seq_attn", type=str, default="gather",
                   choices=("gather", "ring"),
                   help="attention schedule under --seq_devices")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the model runs on")
    flags, _ = p.parse_known_args(argv)
    if flags.loss_type == "all":
        flags.loss_type = "ivt"
    return flags


def _by_length(arrays: Sequence) -> Dict[int, List[int]]:
    """Indices of ``arrays`` grouped by length, in order of first sight."""
    groups: Dict[int, List[int]] = {}
    for i, a in enumerate(arrays):
        groups.setdefault(len(a), []).append(i)
    return groups


def _stack(arrays: Sequence, idx: List[int], device) -> torch.Tensor:
    """The arrays ``idx`` of ``arrays`` (all of one length) as one batch on
    ``device``."""
    if len(idx) == 1:  # a whole video: no copy on the host
        return torch.from_numpy(np.asarray(arrays[idx[0]])[None]).to(device)
    return torch.from_numpy(np.stack([arrays[i] for i in idx])).to(device)


def make_mstct_train_step(model, task: str, pos_weight, device="cuda"):
    """The training step ``(state, batch) -> (state, {"loss"})`` of the
    JAX ``make_mstct_train_step``: the forward in ``.train()`` with the
    state's generator for its dropout masks, ``bce_with_logits`` with
    ``pos_weight``, the backward and one SGD update. ``batch["features"]``
    and ``batch["labels"]`` are lists of per-window (T_i, C) and (T_i, K)
    arrays, as the driver draws them: windows of one length are forwarded
    together, the loss of each group is the mean BCE
    over its windows' frames, and the step's loss is the mean of the
    windows' losses. ``model`` is accepted for parity; the step trains the
    state's module, as the JAX step applies ``state.apply_fn``."""
    del task  # the JAX signature; the labels are the task's already

    def step(state: TrainState, batch) -> tuple:
        feats, labels = batch["features"], batch["labels"]
        n = len(feats)
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        total = None
        for idx in _by_length(feats).values():
            out = state.model(_stack(feats, idx, device),
                              generator=state.rng)
            loss = bce_with_logits(out["logits"],
                                   _stack(labels, idx, device),
                                   pos_weight=pos_weight) * (len(idx) / n)
            loss.backward()
            total = loss.detach() if total is None else total + loss.detach()
        state.optimizer.step()
        state.step += 1
        return state, {"loss": total}

    return step


def predict(model, feats: Sequence, device) -> List[tuple]:
    """(sigmoid probabilities, feature) of each (T_i, C) sequence, float32
    numpy, from the eval forward; sequences of one length go together."""
    out: List[Optional[tuple]] = [None] * len(feats)
    model.eval()
    with torch.inference_mode():
        for idx in _by_length(feats).values():
            res = model(_stack(feats, idx, device))
            probs = torch.sigmoid(res["logits"]).float().cpu().numpy()
            feat = res["feature"].float().cpu().numpy()
            for j, i in enumerate(idx):
                out[i] = (probs[j], feat[j])
    return out


def predict_sharded(model, feats: np.ndarray, mesh, ring: bool, device
                    ) -> tuple:
    """(sigmoid probabilities, feature) of one (T, C) sequence, float32
    numpy, from the eval forward with T split over the mesh's ``seq``
    ranks (zero frames padded at the end to a multiple of them, trimmed
    from the outputs); ``ring`` rings every attention."""
    from ..parallel.long_video import eval_sharded
    from ..parallel.mesh import SEQ_AXIS, axis_size

    t = len(feats)
    pad = -t % axis_size(mesh, SEQ_AXIS)
    x = torch.from_numpy(np.pad(np.asarray(feats), ((0, pad), (0, 0)))[None])
    model.eval()
    model.ring_mesh = mesh if ring else None
    try:
        with torch.inference_mode():
            res = eval_sharded(model, x.to(device), mesh)
    finally:
        model.ring_mesh = None
    probs = torch.sigmoid(res["logits"][0, :t]).float().cpu().numpy()
    return probs, res["feature"][0, :t].float().cpu().numpy()


def main(argv: Optional[Sequence[str]] = None) -> dict:
    flags = parse_flags(argv)
    n_seq = max(1, flags.seq_devices)
    if n_seq > 1 and not torch.distributed.is_initialized():
        return common.launch_ranks(main, argv, flags, n_seq)
    with common.parallel_context(flags, 1, n_seq=n_seq) as place:
        return _main(flags, place)


def _main(flags, place) -> dict:
    seq_mesh, device = place.mesh, place.device
    generator = common.seed_everything(flags.seed)
    np_rng = np.random.default_rng(flags.seed)
    dtype = torch.bfloat16 if flags.dtype == "bfloat16" else torch.float32
    task = flags.loss_type
    num_classes, pos_weight = TASK_INFO[task]

    feats_root = flags.feats_dir or f"{flags.data_dir}/data_feats"
    store = FeatureStore(feats_root, flags.feats_version)
    split = resolve_split(flags.dataset_variant, flags.kfold)
    feats_task = task if task in ("i", "v", "t") else ""
    ds = TemporalSequenceDataset(flags.data_dir, store, flags.kfold,
                                 split.all_videos, task=feats_task)
    in_dim = ds[split.train[0]].features.shape[1]

    modelname = common.build_modelname(flags) + f"_mstct_{task}"
    model_dir = f"{flags.ckpt_root}/run_{flags.version}"
    logger = place.logger(model_dir, modelname)
    ckpt = place.checkpoints(model_dir, modelname)

    model = MSTCT(in_dim, tuple(flags.inter_channels), flags.num_block,
                  flags.head, flags.mlp_ratio, flags.final_embedding_dim,
                  num_classes, dtype, generator=generator)
    steps_per_epoch = max(1, -(-len(split.train) // flags.batch))
    sched = reference_warmup_exp_schedule(
        flags.initial_learning_rates[2], flags.power, flags.warmups[2],
        flags.decay_rate, steps_per_epoch=steps_per_epoch)
    state = create_train_state(model, build_sgd(sched, flags.weight_decay),
                               seed=flags.seed, device=device)
    state = common.maybe_resume(flags, ckpt, state, logger)
    train_step = make_mstct_train_step(model, task, pos_weight, device)
    logger.run_header("temporal_mstct", modelname, flags.version, flags.batch,
                      f"task {task} dims {flags.inter_channels} dtype "
                      f"{flags.dtype} device {device}")

    def run_eval(videos, metric, collect=False):
        feats_out, preds_out, ms = {}, {}, {}
        for video in videos:
            seq = ds[video]
            t0 = time.perf_counter()
            if seq_mesh is not None:
                probs, feats = predict_sharded(state.model, seq.features,
                                               seq_mesh,
                                               flags.seq_attn == "ring",
                                               device)
            else:
                [(probs, feats)] = predict(state.model, [seq.features],
                                           device)
            ms[video] = (time.perf_counter() - t0) * 1e3  # ends on the host
            metric.update(seq.labels[task], probs)
            metric.video_end()
            if collect:
                feats_out[video] = feats
                preds_out[video] = probs
        return feats_out, preds_out, ms

    metric = Recognition(num_classes)
    train_metric = Recognition(num_classes)
    result: Dict = {"eval_ms": {}}

    if flags.train:
        losses = []
        # the handlers are restored on leaving: main may run in a
        # process that goes on
        with PreemptionGuard() as guard:
            for epoch in range(flags.epochs):
                order = list(split.train)
                np_rng.shuffle(order)
                for start in range(0, len(order), flags.batch):
                    if guard.requested:
                        break
                    group = order[start:start + flags.batch]
                    wins = [sample_window(np_rng, ds[v], flags.window)
                            for v in group]
                    state, m = train_step(state, {
                        "features": [w.features for w in wins],
                        "labels": [w.labels[task].astype(np.float32)
                                   for w in wins]})
                    if flags.log_train_map:
                        preds = predict(state.model,
                                        [w.features for w in wins], device)
                        for w, (probs, _) in zip(wins, preds):
                            train_metric.update(w.labels[task], probs)
                            train_metric.video_end()
                if guard.requested:
                    ckpt.save(state, tag="latest")
                    logger.log("preemption signal: saved _latest, stopping "
                               "training (resume with --resume)")
                    result["preempted"] = True
                    break
                scalars = {"loss": float(m["loss"])}
                losses.append(scalars["loss"])
                if flags.log_train_map:
                    scalars["train_mAP"] = (
                        train_metric.compute_video_AP()["mAP"])
                    train_metric.reset_global()
                logger.scalars("train/loss", scalars, epoch)
                if epoch % flags.val_interval == 0:
                    metric.reset_global()
                    run_eval(split.val, metric)
                    score = metric.compute_video_AP()["mAP"]
                    behaviour = ckpt.update(state, score, epoch,
                                            logger.logfile)
                    logger.log(f"epoch {epoch} val mAP[{task}] {score:.5f} "
                               f"ckpt {behaviour}")
        result["train_epochs"] = flags.epochs
        result["train_loss"] = losses
        result["step"] = state.step

    if flags.test:
        if ckpt.exists():
            state = ckpt.restore(state)
        metric.reset_global()
        _, _, result["eval_ms"]["test"] = run_eval(split.test, metric)
        res = metric.compute_video_AP(
            ignore_null=common.ignore_null_protocol(
                "temporal_mstct", flags.dataset_variant))
        logger.log(f"test mAP[{task}]: {res['mAP']:.5f}")
        result["test_mAP"] = res["mAP"]
        print(f"test mAP[{task}]:", round(res["mAP"], 4))

    if flags.dump:
        if ckpt.exists():
            state = ckpt.restore(state)
        out_store = FeatureStore(feats_root, flags.version or "Q2LMSTCT")
        feats_out, preds_out, result["eval_ms"]["dump"] = run_eval(
            split.all_videos, Recognition(num_classes), collect=True)
        if common.is_rank_zero():
            fpath = out_store.save(flags.kfold, "feats", feats_out,
                                   task=task)
            ppath = out_store.save(flags.kfold, "pred", preds_out, task=task)
            logger.log(f"Dumped {fpath} and {ppath}")
            result["dump_paths"] = (fpath, ppath)

    logger.close()
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
