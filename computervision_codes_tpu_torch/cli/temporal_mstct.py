"""MS-TCT temporal teacher driver (MT4MTLKD stage 2): full-video eval and
the feature-bus dump.

Counterpart of ``cli/temporal_mstct.py`` in the JAX package, with every
one of its flags. Ported: ``--test`` (the test mAP over the fold's test
videos) and ``--dump`` (per-frame features and sigmoid predictions of
every video, ``k{fold}_{task}_{feats,pred}.pkl`` under
``run_<version or Q2LMSTCT>``, the artifacts the KD student reads), both
from the best checkpoint that the JAX driver's ``CheckpointManager`` wrote
(``<ckpt_root>/run_<version>/<modelname>.msgpack``, read without msgpack),
or from weights made from ``--seed`` when there is none, as there.

    python -m computervision_codes_tpu_torch.cli.temporal_mstct \\
        --data_dir D -e -d [--dtype bfloat16] [--device cuda]

Each video is evaluated whole, at its own length. The JAX driver pads it
with zeros to a power-of-two bucket and MS-TCT then attends over the
padded frames with no key mask, so there a real frame's output depends on
its bucket; the reference (Temporal_mstct/run.py:248) runs every video at
its own length, and so does this driver. Probabilities are the sigmoid of
the logits in the model dtype, as the JAX ``eval_fn``; the dumped arrays
are float32 (numpy has no bfloat16), holding those values exactly.

``--device`` (default ``cuda``) is where the model runs: on the card
attention is kernel K7 (``ops/attention.py``). Not ported yet, and
refused: ``--train``, ``--resume`` and ``--log_train_map`` (the MS-TCT
training slice) and ``--seq_devices > 1`` (the parallel slice).
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, Optional, Sequence

import torch

from ..data.feature_store import FeatureStore
from ..data.splits import resolve_split
from ..data.temporal import TemporalSequenceDataset
from ..metrics import Recognition
from ..models.convert import load_jax_variables
from ..models.mstct import MSTCT
from ..train.checkpoint import checkpoint_path, restore_variables
from . import common

TASK_CLASSES = {"i": 6, "v": 10, "t": 15, "ivt": 100}


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
                   help="log per-epoch train mAP (not ported yet)")
    p.add_argument("--seq_devices", type=int, default=0,
                   help="context-parallel full-video eval over this many "
                        "devices (not ported yet; 0 or 1 = one device)")
    p.add_argument("--seq_attn", type=str, default="gather",
                   choices=("gather", "ring"),
                   help="attention schedule under --seq_devices")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the model runs on")
    flags, _ = p.parse_known_args(argv)
    if flags.loss_type == "all":
        flags.loss_type = "ivt"
    return flags


def _refuse_unported(flags) -> None:
    for flag, on in (("--train", flags.train), ("--resume", flags.resume),
                     ("--log_train_map", flags.log_train_map)):
        if on:
            raise NotImplementedError(
                f"{flag} is not ported yet: it comes with the MS-TCT "
                f"training slice (SGD, the warmup-exp schedule, "
                f"bce_with_logits, the checkpoint writer)")
    if flags.seq_devices > 1:
        raise NotImplementedError("--seq_devices > 1 is not ported yet: it "
                                  "comes with the parallel slice")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    flags = parse_flags(argv)
    _refuse_unported(flags)
    generator = common.seed_everything(flags.seed)
    device = torch.device(flags.device)
    dtype = torch.bfloat16 if flags.dtype == "bfloat16" else torch.float32
    task = flags.loss_type
    num_classes = TASK_CLASSES[task]

    feats_root = flags.feats_dir or f"{flags.data_dir}/data_feats"
    store = FeatureStore(feats_root, flags.feats_version)
    split = resolve_split(flags.dataset_variant, flags.kfold)
    feats_task = task if task in ("i", "v", "t") else ""
    ds = TemporalSequenceDataset(flags.data_dir, store, flags.kfold,
                                 split.all_videos, task=feats_task)
    in_dim = ds[split.train[0]].features.shape[1]

    modelname = common.build_modelname(flags) + f"_mstct_{task}"
    model_dir = f"{flags.ckpt_root}/run_{flags.version}"
    os.makedirs(model_dir, exist_ok=True)
    logfile = os.path.join(model_dir, f"{modelname}.log")

    def log(msg: str) -> None:
        with open(logfile, "a") as fh:
            fh.write(msg + "\n")

    model = MSTCT(in_dim, tuple(flags.inter_channels), flags.num_block,
                  flags.head, flags.mlp_ratio, flags.final_embedding_dim,
                  num_classes, dtype, generator=generator)
    ckpt = checkpoint_path(model_dir, modelname)
    if (flags.test or flags.dump) and os.path.exists(ckpt):
        load_jax_variables(model, restore_variables(ckpt))
        log(f"Restored {ckpt}")
    model.to(device).eval()
    log(f"temporal_mstct (PyTorch port) {modelname} task {task} dims "
        f"{flags.inter_channels} dtype {flags.dtype} device {device}")

    def eval_video(video):
        seq = ds[video]
        x = torch.from_numpy(seq.features[None]).to(device)
        with torch.inference_mode():
            out = model(x)
            probs = torch.sigmoid(out["logits"][0]).float().cpu().numpy()
            feats = out["feature"][0].float().cpu().numpy()
        return probs, feats, seq

    def run_eval(videos, metric, collect=False):
        feats_out, preds_out, ms = {}, {}, {}
        for video in videos:
            t0 = time.perf_counter()
            probs, feats, seq = eval_video(video)  # ends on the host
            ms[video] = (time.perf_counter() - t0) * 1e3
            metric.update(seq.labels[task], probs)
            metric.video_end()
            if collect:
                feats_out[video] = feats
                preds_out[video] = probs
        return feats_out, preds_out, ms

    result: Dict = {"eval_ms": {}}
    if flags.test:
        metric = Recognition(num_classes)
        _, _, result["eval_ms"]["test"] = run_eval(split.test, metric)
        res = metric.compute_video_AP(
            ignore_null=common.ignore_null_protocol(
                "temporal_mstct", flags.dataset_variant))
        log(f"test mAP[{task}]: {res['mAP']:.5f}")
        result["test_mAP"] = res["mAP"]
        print(f"test mAP[{task}]:", round(res["mAP"], 4))

    if flags.dump:
        out_store = FeatureStore(feats_root, flags.version or "Q2LMSTCT")
        feats_out, preds_out, result["eval_ms"]["dump"] = run_eval(
            split.all_videos, Recognition(num_classes), collect=True)
        fpath = out_store.save(flags.kfold, "feats", feats_out, task=task)
        ppath = out_store.save(flags.kfold, "pred", preds_out, task=task)
        log(f"Dumped {fpath} and {ppath}")
        result["dump_paths"] = (fpath, ppath)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
