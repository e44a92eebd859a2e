"""The port's student driver (``cli/spatial_cnn.py``) against the JAX
package's, end to end on the CPU.

A PNG tree of 32x56 frames (fold 1 of CholecT45's cross-validation, one
frame a video, as tests/test_cli_smoke.py sizes the student) with the Q2L
feature and Q2LMSTCT prediction stores that ``--loss_type all`` reads.

* Training: both drivers train one epoch of the ResNet18 ``SpatialCNN`` at
  rates (1, 0.5, 0.1) from the same JAX-written ``_latest``
  (``--resume``), ``-b 32``: the 31 training frames are one step, on the
  same frames and augmentations from the same seed. Every logged loss term
  agrees within the step test's bound (rtol 1e-5,
  tests/test_torch_spatial_train.py); the running statistics of the
  ``_latest`` checkpoints within 5e-5 of max(1, max|JAX|), as that test
  bounds them, and each parameter within 1e-6 plus 10% of its update,
  50% in layer 4: on this batch of 32 frames units near 0 flip their
  ReLU under another sum order and layer 4 normalises over 64 values a
  channel; from this initialisation JAX and the port differed by 24% of
  an update in layer 4 and by at most 3.3% elsewhere (on another seeded
  initialisation 4.8% in all), the port on two convolution backends
  (mkldnn on and off) by 3.4% and 9.7%, while a wrong update moves every
  parameter by a whole one.
* Evaluation: the JAX driver's ``-e -d -b 1`` (after its step, from its
  best checkpoint) and the port's ``-e -d -b 1 --device cpu`` from that
  JAX-written file give the same test mAP table (within 1e-6) and dump:
  each video's (1, 512) float32 feature at atol 5e-5.
* ``--optimizer sam`` (with ``--resume`` from the initial ``_latest``) and
  ``--qat`` (from ``--pretrain_dir``, with an ``--imagenet_pretrain``
  directory that lacks the file: trained from scratch, logged) train one
  epoch each: finite losses and the running statistics moved
  (tests/test_torch_spatial_train.py holds both steps and the QAT eval to
  JAX); the unported flags raise.
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_cli_spatial_transformer import (  # noqa: E402
    given_state,
    initial_state,
)

from computervision_codes_tpu.cli import spatial_cnn as jax_driver
from computervision_codes_tpu.models.spatial_cnn import (
    SpatialCNN as JaxSpatialCNN,
)
from computervision_codes_tpu.train import (
    build_sgd,
    reference_warmup_exp_schedule,
)
from computervision_codes_tpu.train.checkpoint import (
    CheckpointManager as JaxCheckpointManager,
)
from computervision_codes_tpu_torch.cli import spatial_cnn
from computervision_codes_tpu_torch.data.feature_store import FeatureStore
from computervision_codes_tpu_torch.data.splits import resolve_split
from computervision_codes_tpu_torch.data.synthetic import (
    synthetic_feature_dict,
    write_synthetic_dataset,
)
from computervision_codes_tpu_torch.models.spatial_cnn import SpatialCNN
from computervision_codes_tpu_torch.train.checkpoint import read_msgpack
from computervision_codes_tpu_torch.utils.logging import summarize_events

TEACHER_DIM, FRAMES, H, W = 24, 1, 32, 56
MODELNAME = "rendezvous_lcholect45-crossval_cholect1"
BATCH, STEPS = 32, 1
SIZES = {"i": 6, "v": 10, "t": 15}
LOSS_RTOL, PARAM_ATOL, PARAM_REL, STATS_REL, DUMP_ATOL, MAP_ABS = (
    1e-5, 1e-6, 0.1, 5e-5, 5e-5, 1e-6)
LAYER4_REL = 0.5  # PARAM_REL in layer 4 (see the docstring)
COMMON = ["--image_height", str(H), "--image_width", str(W),
          "--loss_type", "all", "--rates", "1", "0.5", "0.1",
          "--teacher_dim", str(TEACHER_DIM), "--version", "stu",
          "--augmentation_list", "original", "vflip", "hflip", "contrast"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch work on one thread: under the suite's parallel
    workers, torch's default of one thread per core oversubscribes the
    host, and tiny ops then wait on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _save_init(root):
    """The JAX driver's initial state: ``_latest`` in ``ckpt_jax``,
    ``ckpt_port`` and ``ckpt_init`` (the last also as the best)."""
    sched = reference_warmup_exp_schedule(0.01, 0.1, 58, 0.99, STEPS)
    state = initial_state(
        JaxSpatialCNN(network="resnet18", loss_type="all",
                      teacher_dim=TEACHER_DIM),
        SpatialCNN("resnet18", loss_type="all", teacher_dim=TEACHER_DIM,
                   generator=torch.Generator().manual_seed(47)),
        build_sgd(sched, 1e-5))
    for side, tags in (("ckpt_jax", ("latest",)), ("ckpt_port", ("latest",)),
                       ("ckpt_init", ("latest", ""))):
        for tag in tags:
            JaxCheckpointManager(f"{root}/{side}/run_stu", MODELNAME).save(
                state, tag=tag)
    return state


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cholect45"))
    split = resolve_split("cholect45-crossval", 1)
    write_synthetic_dataset(root, split.all_videos, FRAMES, height=H,
                            width=W, seed=1, write_images=True)
    feats_root = root + "/data_feats"
    for k, n in SIZES.items():
        FeatureStore(feats_root, "Q2L").save(
            1, "feats", synthetic_feature_dict(
                split.all_videos, FRAMES, TEACHER_DIM, seed=3), task=k)
        FeatureStore(feats_root, "Q2LMSTCT").save(
            1, "pred", synthetic_feature_dict(
                split.all_videos, FRAMES, n, seed=4), task=k)
    state = _save_init(root)
    train = ["--data_dir", root, "-t", "--epochs", "1", "--resume",
             "-b", str(BATCH), "--feats_dir", feats_root, *COMMON]
    # eval one frame a call: each video has one frame
    evaluate = ["--data_dir", root, "-e", "-d", "-b", "1", *COMMON,
                "--ckpt_root", root + "/ckpt_jax"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_driver, "create_train_state", given_state(state))
        jax_driver.main(train + ["--ckpt_root", root + "/ckpt_jax"])
        jax_result = jax_driver.main(evaluate + ["--feats_dir", feats_root])
    port_train = spatial_cnn.main(train + ["--ckpt_root",
                                           root + "/ckpt_port",
                                           "--device", "cpu"])
    # the JAX driver's best checkpoint (after its step), evaluated as a
    # user runs the port's driver
    port_eval = spatial_cnn.main(evaluate + ["--feats_dir",
                                             root + "/feats_port",
                                             "--device", "cpu"])
    return {"root": root, "split": split, "jax_eval": jax_result,
            "port_train": port_train, "port_eval": port_eval,
            "train": train}


def _ckpt(root, side, tag="latest"):
    return read_msgpack(f"{root}/{side}/run_stu/{MODELNAME}_{tag}.msgpack")


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_training_matches_jax_driver(runs):
    root = runs["root"]
    got, want = (summarize_events(
        f"{root}/{side}/run_stu/{MODELNAME}.events.jsonl", "train/loss")
        for side in ("ckpt_port", "ckpt_jax"))
    assert len(got) == len(want) == 1
    g, w = got[0]["values"], want[0]["values"]
    assert set(g) == set(w) and {"soft_loss", "kd_loss"} <= set(g)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL, err_msg=k)
    init = read_msgpack(f"{root}/ckpt_init/run_stu/{MODELNAME}.msgpack")
    port, jax_ = _ckpt(root, "ckpt_port"), _ckpt(root, "ckpt_jax")
    assert int(port["step"]) == int(jax_["step"]) == STEPS
    for coll in ("params", "batch_stats"):
        before = dict(_leaves(init[coll]))
        theirs = dict(_leaves(jax_[coll]))
        ours = dict(_leaves(port[coll]))
        assert set(ours) == set(theirs)
        for path, w in theirs.items():
            if coll == "params":
                rel = LAYER4_REL if path[:2] in {
                    ("backbone", "layer4_0"), ("backbone", "layer4_1")} \
                    else PARAM_REL
                tol = PARAM_ATOL + rel * float(
                    np.abs(w - before[path]).max())
            else:
                tol = STATS_REL * max(1.0, float(np.abs(w).max()))
            assert float(np.abs(ours[path] - w).max()) <= tol, path


def _dump(root, side, version="stu"):
    return FeatureStore(f"{root}/{side}", version).load(1, "feats")


def test_eval_and_dump_from_jax_checkpoint_match_jax_driver(runs):
    root, split = runs["root"], runs["split"]
    got, want = _dump(root, "feats_port"), _dump(root, "data_feats")
    assert set(got) == set(want) == {v[3:] for v in split.all_videos}
    for v in want:
        assert got[v].dtype == np.float32 and got[v].shape == (FRAMES, 512)
        np.testing.assert_allclose(got[v], want[v], atol=DUMP_ATOL,
                                   err_msg=v)
    got_map, want_map = (runs[k]["test_mAP"] for k in ("port_eval",
                                                        "jax_eval"))
    assert set(got_map) == set(want_map)
    for c, m in want_map.items():
        assert abs(got_map[c] - m) <= MAP_ABS, c


@pytest.mark.parametrize("option", ["sam", "qat"])
def test_sam_qat_resume_and_refusals(runs, tmp_path, option):
    """``--optimizer sam`` resumes from a copy of the initial ``_latest``
    (``--resume``: step 0 -> 1); ``--qat`` starts from ``--pretrain_dir``
    with an ``--imagenet_pretrain`` directory that lacks the file."""
    root = runs["root"]
    base = [a for a in runs["train"] if a != "--resume"]
    base += ["--ckpt_root", str(tmp_path), "--device", "cpu"]
    if option == "sam":
        shutil.copytree(f"{root}/ckpt_init/run_stu", tmp_path / "run_stu")
        extra = ["--optimizer", "sam", "--resume"]
    else:
        os.makedirs(tmp_path / "pretrain")
        extra = ["--qat", "--pretrain_dir", f"{root}/ckpt_init/run_stu",
                 "--imagenet_pretrain", str(tmp_path / "pretrain")]
    result = spatial_cnn.main(base + extra)
    losses = result["train_loss"][0]
    assert result["step"] == STEPS and np.isfinite(list(losses.values())).all()
    stats = dict(_leaves(_ckpt(tmp_path, ".")["batch_stats"]))
    init = dict(_leaves(read_msgpack(
        f"{root}/ckpt_init/run_stu/{MODELNAME}.msgpack")["batch_stats"]))
    for path, s in stats.items():
        assert np.isfinite(s).all() and not np.array_equal(s, init[path])
    log = open(f"{tmp_path}/run_stu/{MODELNAME}.log").read()
    if option == "qat":
        assert "training from scratch" in log
        return
    assert "Resumed from" in log and "at step 0" in log
    for flag in ("--dp_devices", "--device_augment"):
        argv = base + [flag] + ([] if flag == "--device_augment" else ["2"])
        with pytest.raises(NotImplementedError,
                           match="item 8" if flag == "--dp_devices"
                           else "item 7"):
            spatial_cnn.main(argv)
