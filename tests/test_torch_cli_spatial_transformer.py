"""The port's teacher driver (``cli/spatial_transformer.py``) against the
JAX package's, end to end on the CPU: training (the evaluation and dump
are tests/test_torch_cli_spatial_transformer_eval.py).

A PNG tree (``write_synthetic_dataset(write_images=True)``, fold 1 of
CholecT45's cross-validation, one 64x64 frame a video) and the Res18
feature and Res18TCN prediction stores that ``--loss_type all`` reads.
Both drivers train one epoch of ``Q2L(swin_nano_64)`` at rates (1, 0.5,
0.1) from the same JAX-written ``_latest`` (``--resume``), drop rates 0 on
both sides, ``-b 32``: the 31 training frames are one step (the last frame
repeated), on the same frames and augmentations drawn from the same seed;
the port under ``--fused_train --remat`` (K6's plain versions on the CPU),
JAX on its XLA path. This one step is the teacher's training step at
loss "all" against JAX's, with the bounds of tests/test_torch_train_step.py:
every logged loss term at rtol 1e-5, and every parameter of the two
``_latest`` files (both at step 1, the KD block's too) within 1e-6 plus 1%
of its update, but for one unit per Q2L FFN layer (a ReLU unit within
float32 noise of 0 may flip between the packages). (Over more steps float32
rounding is amplified: after 31 steps at ``-b 2`` two plans of the port
itself differ by 8e-4 in ``hard_loss`` and 1.7% in ``soft_loss``.) Then
``--resume`` continues the port's step count, and the unported flags
raise. The JAX driver's eager flax init (35 s here) is swapped for the
initial state made here from a seeded port model; every run starts from
a checkpoint anyway.
"""

import functools
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from computervision_codes_tpu.cli import spatial_transformer as jax_driver
from computervision_codes_tpu.models import q2l as jax_q2l
from computervision_codes_tpu.train import (
    TrainState,
    build_sgd,
    reference_warmup_exp_schedule,
)
from computervision_codes_tpu.train.checkpoint import (
    CheckpointManager as JaxCheckpointManager,
)
from computervision_codes_tpu_torch.cli import spatial_transformer
from computervision_codes_tpu_torch.data.feature_store import FeatureStore
from computervision_codes_tpu_torch.data.splits import resolve_split
from computervision_codes_tpu_torch.data.synthetic import (
    synthetic_feature_dict,
    write_synthetic_dataset,
)
from computervision_codes_tpu_torch.models import q2l as port_q2l
from computervision_codes_tpu_torch.models.convert import jax_variables
from computervision_codes_tpu_torch.train.checkpoint import read_msgpack
from computervision_codes_tpu_torch.utils.logging import summarize_events

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_train_step import _assert_param_close  # noqa: E402

TEACHER_DIM, FRAMES, IMG = 24, 1, 64
MODELNAME = "rendezvous_lcholect45-crossval_cholect1_all"
TRAIN_BATCH = 32
STEPS = 1  # 31 training frames at -b 32
SIZES = {"i": 6, "v": 10, "t": 15}
LOSS_RTOL = 1e-5
COMMON = ["--backbone", "swin_nano_64", "--image_height", str(IMG),
          "--image_width", str(IMG), "--loss_type", "all",
          "--rates", "1", "0.5", "0.1", "--teacher_dim", str(TEACHER_DIM),
          "--version", "Q2L", "--augmentation_list", "original", "vflip",
          "hflip", "contrast"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch work on one thread: under the suite's parallel
    workers, torch's default of one thread per core oversubscribes the
    host, and tiny ops then wait on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def initial_state(jax_model, port_model, optimizer):
    """The JAX driver's initial TrainState, its variables those of a port
    model made from a seed (``jax_variables``: the same tree as the JAX
    init's, without compiling that init)."""
    variables = jax_variables(port_model)
    return TrainState.create(
        apply_fn=jax_model.apply, params=variables["params"], tx=optimizer,
        batch_stats=variables.get("batch_stats"),
        rng=jax.random.fold_in(jax.random.PRNGKey(47), 1))


def given_state(state):
    """A ``create_train_state`` for the JAX driver that hands it ``state``
    (made by the same model and optimizer) with the driver's own model
    and optimizer, without a second init."""
    def create(model, optimizer, rng, example_inputs, init_kwargs=None):
        return state.replace(apply_fn=model.apply, tx=optimizer)
    return create


def write_tree(root, feat_sides):
    """The PNG tree, the teachers' stores, and a link to them in each
    feature root of ``feat_sides``; returns the split."""
    split = resolve_split("cholect45-crossval", 1)
    write_synthetic_dataset(root, split.all_videos, FRAMES, height=IMG,
                            width=IMG, seed=1, write_images=True)
    feats_root = root + "/data_feats"
    for k, n in SIZES.items():
        FeatureStore(feats_root, "Res18").save(
            1, "feats", synthetic_feature_dict(
                split.all_videos, FRAMES, TEACHER_DIM, seed=3), task=k)
        FeatureStore(feats_root, "Res18TCN").save(
            1, "pred", synthetic_feature_dict(
                split.all_videos, FRAMES, n, seed=4), task=k)
    for side in feat_sides:
        os.makedirs(f"{root}/{side}")
        for store in ("Res18", "Res18TCN"):
            os.symlink(f"{feats_root}/run_{store}",
                       f"{root}/{side}/run_{store}")
    return split


def save_init(roots, tag):
    """The JAX driver's initial state, saved under ``tag`` in each root."""
    sched = reference_warmup_exp_schedule(0.01, 0.1, 58, 0.99, STEPS)
    state = initial_state(
        jax_q2l.Q2L(backbone="swin_nano_64", loss_type="all",
                    teacher_dim=TEACHER_DIM),
        port_q2l.Q2L(backbone="swin_nano_64", loss_type="all",
                     teacher_dim=TEACHER_DIM,
                     generator=torch.Generator().manual_seed(47)),
        build_sgd(sched, 1e-5))
    for root in roots:
        JaxCheckpointManager(root + "/run_Q2L", MODELNAME).save(state,
                                                                tag=tag)
    return state


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cholect45"))
    write_tree(root, ("feats_jax", "feats_port"))
    state = save_init([root + "/ckpt_jax", root + "/ckpt_port",
                       root + "/ckpt_init"], "latest")
    train = ["--data_dir", root, "-t", "--epochs", "1", "--resume",
             "-b", str(TRAIN_BATCH), *COMMON]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_q2l, "Q2LTransformer", functools.partial(
            jax_q2l.Q2LTransformer, dropout=0.0))
        mp.setattr(jax_driver, "Q2L", functools.partial(
            jax_q2l.Q2L, drop_path_rate=0.0))
        mp.setattr(jax_driver, "create_train_state", given_state(state))
        mp.setattr(port_q2l, "DROPOUT", 0.0)
        mp.setattr(spatial_transformer, "Q2L", functools.partial(
            port_q2l.Q2L, drop_path_rate=0.0))
        jax_result = jax_driver.main(train + [
            "--ckpt_root", root + "/ckpt_jax", "--feats_dir",
            root + "/feats_jax"])
        port_result = spatial_transformer.main(train + [
            "--ckpt_root", root + "/ckpt_port", "--feats_dir",
            root + "/feats_port", "--fused_train", "--remat",
            "--device", "cpu"])
    return {"root": root, "jax": jax_result, "port": port_result}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _events(root, side):
    return summarize_events(f"{root}/{side}/run_Q2L/{MODELNAME}.events.jsonl",
                            "train/loss")


def test_training_matches_jax_driver(runs):
    root = runs["root"]
    got, want = _events(root, "ckpt_port"), _events(root, "ckpt_jax")
    assert len(got) == len(want) == 1
    g, w = got[0]["values"], want[0]["values"]
    assert set(g) == set(w) and {"soft_loss", "kd_loss", "hard_loss"} <= \
        set(g)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL, err_msg=k)
    assert runs["port"]["step"] == STEPS
    assert runs["port"]["train_loss"] == [g]
    init, port, theirs = (read_msgpack(
        f"{root}/{side}/run_Q2L/{MODELNAME}_latest.msgpack")
        for side in ("ckpt_init", "ckpt_port", "ckpt_jax"))
    assert int(port["step"]) == int(theirs["step"]) == STEPS
    assert "kd_attention" in port["params"]
    before = dict(_leaves(init["params"]))
    ours = dict(_leaves(port["params"]))
    want = dict(_leaves(theirs["params"]))
    assert set(ours) == set(want) == set(before)
    for path, w in want.items():
        _assert_param_close(".".join(path), ours[path], w, before[path])


def test_resume_and_refusals(runs, tmp_path):
    root = runs["root"]
    shutil.copytree(f"{root}/ckpt_port/run_Q2L", f"{tmp_path}/run_Q2L")
    base = ["--data_dir", root, *COMMON, "-b", str(TRAIN_BATCH),
            "--ckpt_root", str(tmp_path), "--device", "cpu",
            "--feats_dir", f"{root}/feats_port"]
    result = spatial_transformer.main(base + ["-t", "--resume",
                                              "--epochs", "1"])
    assert result["step"] == 2 * STEPS
    log = open(f"{tmp_path}/run_Q2L/{MODELNAME}.log").read()
    assert "Resumed from" in log and f"at step {STEPS}" in log
    for flag, item in (("--dp_devices", "item 8"), ("--tp_devices", "item 8"),
                       ("--device_augment", "item 7")):
        argv = base + [flag] + ([] if flag == "--device_augment" else ["2"])
        with pytest.raises(NotImplementedError, match=item):
            spatial_transformer.main(argv)
