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
``--resume`` continues the port's step count, and ``--dp_devices 2
--tp_devices 2`` on four gloo ranks takes the same step; ``--dp_devices 2
--device_augment`` takes the port's one-device ``--device_augment`` step.
The same one-step comparison holds a CvT (``cvt_nano``) and a small
TResNet teacher, the TResNet's running statistics too. The JAX driver's
eager flax init (35 s here) is swapped for the initial state
made here from a seeded port model; every run starts from a checkpoint
anyway.
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
from computervision_codes_tpu_torch.parallel.mesh import launch
from computervision_codes_tpu_torch.train.checkpoint import read_msgpack
from computervision_codes_tpu_torch.utils.logging import summarize_events

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_train_step import _assert_param_close  # noqa: E402
import torch_parallel_workers as workers  # noqa: E402

TEACHER_DIM, FRAMES, IMG = 24, 1, 64
MODELNAME = "rendezvous_lcholect45-crossval_cholect1_all"
TRAIN_BATCH = 32
STEPS = 1  # 31 training frames at -b 32
SIZES = {"i": 6, "v": 10, "t": 15}
LOSS_RTOL = 1e-5
RANKS_TIMEOUT = 300  # s: a spawned group past it is killed, and fails
STATS_REL = 1e-3  # running statistics: tests/test_torch_tresnet.py's
# float32 training bound
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


def save_init(roots, tag, backbone="swin_nano_64"):
    """The JAX driver's initial state, saved under ``tag`` in each root."""
    sched = reference_warmup_exp_schedule(0.01, 0.1, 58, 0.99, STEPS)
    state = initial_state(
        jax_q2l.Q2L(backbone=backbone, loss_type="all",
                    teacher_dim=TEACHER_DIM),
        port_q2l.Q2L(backbone=backbone, loss_type="all",
                     teacher_dim=TEACHER_DIM,
                     generator=torch.Generator().manual_seed(47)),
        build_sgd(sched, 1e-5))
    for root in roots:
        JaxCheckpointManager(root + "/run_Q2L", MODELNAME).save(state,
                                                                tag=tag)
    return state


def train_both(root, ckpt, backbone, port_flags=()):
    """One ``-t`` epoch of each driver from the same ``_latest`` (saved in
    ``ckpt``'s init, jax and port roots), dropout and drop path 0, the
    JAX driver first; returns both results."""
    state = save_init([f"{ckpt}/ckpt_{side}"
                       for side in ("jax", "port", "init")], "latest",
                      backbone)
    train = ["--data_dir", root, "-t", "--epochs", "1", "--resume",
             "-b", str(TRAIN_BATCH), *COMMON, "--backbone", backbone]
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
            "--ckpt_root", ckpt + "/ckpt_jax", "--feats_dir",
            root + "/feats_jax"])
        port_result = spatial_transformer.main(train + [
            "--ckpt_root", ckpt + "/ckpt_port", "--feats_dir",
            root + "/feats_port", *port_flags, "--device", "cpu"])
    return jax_result, port_result


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cholect45"))
    write_tree(root, ("feats_jax", "feats_port"))
    jax_result, port_result = train_both(
        root, root, "swin_nano_64", ("--fused_train", "--remat"))
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


def assert_training_matches(ckpt, port_result, batch_stats=False,
                            ref="ckpt_jax"):
    """The port's logged losses and ``_latest`` parameters (and, with
    ``batch_stats``, running statistics within ``STATS_REL`` of each
    tensor's largest magnitude) after one step from ``ckpt``'s init,
    against the run in ``ref`` (the JAX driver's)."""
    got, want = _events(ckpt, "ckpt_port"), _events(ckpt, ref)
    assert len(got) == len(want) == 1
    g, w = got[0]["values"], want[0]["values"]
    assert set(g) == set(w) and {"soft_loss", "kd_loss", "hard_loss"} <= \
        set(g)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL, err_msg=k)
    assert port_result["step"] == STEPS
    assert port_result["train_loss"] == [g]
    init, port, theirs = (read_msgpack(
        f"{ckpt}/{side}/run_Q2L/{MODELNAME}_latest.msgpack")
        for side in ("ckpt_init", "ckpt_port", ref))
    assert int(port["step"]) == int(theirs["step"]) == STEPS
    assert "kd_attention" in port["params"]
    before = dict(_leaves(init["params"]))
    ours = dict(_leaves(port["params"]))
    want = dict(_leaves(theirs["params"]))
    assert set(ours) == set(want) == set(before)
    for path, w in want.items():
        _assert_param_close(".".join(path), ours[path], w, before[path])
    if batch_stats:
        ours = dict(_leaves(port["batch_stats"]))
        want = dict(_leaves(theirs["batch_stats"]))
        assert set(ours) == set(want) and want
        for path, w in want.items():
            np.testing.assert_allclose(ours[path], w, rtol=0,
                                       atol=STATS_REL * np.abs(w).max(),
                                       err_msg=".".join(path))


def test_training_matches_jax_driver(runs):
    assert_training_matches(runs["root"], runs["port"])


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


def test_data_and_tensor_parallel_match_jax_driver(runs, tmp_path,
                                                   monkeypatch):
    """``--dp_devices 2 --tp_devices 2``: four gloo ranks (a 2 x 2 data x
    model mesh, the plain path forced, drop rates 0 as in ``train_both``)
    take the JAX driver's step on the whole batch (under its mesh JAX's
    step is its single-device step, tests/test_tensor_parallel.py), in the
    bounds of ``assert_training_matches``; the checkpoint holds the whole
    parameters."""
    root = runs["root"]
    for side in ("ckpt_jax", "ckpt_init"):
        os.symlink(f"{root}/{side}", f"{tmp_path}/{side}")
    shutil.copytree(f"{root}/ckpt_init/run_Q2L",
                    f"{tmp_path}/ckpt_port/run_Q2L")
    argv = ["--data_dir", root, "-t", "--epochs", "1", "--resume", "-b",
            str(TRAIN_BATCH), *COMMON, "--ckpt_root", f"{tmp_path}/ckpt_port",
            "--feats_dir", f"{root}/feats_port", "--device", "cpu",
            "--dp_devices", "2", "--tp_devices", "2"]
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # one thread a rank
    result = launch(workers.transformer_main_without_dropout, 4, (argv,),
                    device_type="cpu", timeout=RANKS_TIMEOUT)
    assert_training_matches(str(tmp_path), result)


def test_data_parallel_device_augment_matches_one_device(runs, tmp_path,
                                                         monkeypatch):
    """``--dp_devices 2 --device_augment`` on two gloo ranks: each rank
    draws the augmentation numbers of the whole batch and keeps its rows,
    so the step equals the port's one-device ``--device_augment`` step
    with the same seed (drop rates 0), in the bounds of
    ``assert_training_matches``."""
    root = runs["root"]
    os.symlink(f"{root}/ckpt_init", f"{tmp_path}/ckpt_init")
    for side in ("ckpt_one", "ckpt_port"):
        shutil.copytree(f"{root}/ckpt_init/run_Q2L",
                        f"{tmp_path}/{side}/run_Q2L")
    argv = ["--data_dir", root, "-t", "--epochs", "1", "--resume", "-b",
            str(TRAIN_BATCH), *COMMON, "--feats_dir", f"{root}/feats_port",
            "--device", "cpu", "--device_augment"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_q2l, "DROPOUT", 0.0)
        mp.setattr(spatial_transformer, "Q2L", functools.partial(
            port_q2l.Q2L, drop_path_rate=0.0))
        spatial_transformer.main(argv + ["--ckpt_root",
                                         f"{tmp_path}/ckpt_one"])
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # one thread a rank
    result = launch(workers.transformer_main_without_dropout, 2,
                    (argv + ["--ckpt_root", f"{tmp_path}/ckpt_port",
                             "--dp_devices", "2"],),
                    device_type="cpu", timeout=RANKS_TIMEOUT)
    assert_training_matches(str(tmp_path), result, ref="ckpt_one")


def counting(fn, calls):
    """``fn``, each call appended to ``calls``."""
    def call(*args, **kw):
        calls.append(1)
        return fn(*args, **kw)
    return call


@pytest.mark.parametrize("path", ["cvt_nano", "tresnet_small",
                                  "--device_augment"])
def test_new_training_paths_run(runs, tmp_path, path, monkeypatch):
    """A CvT backbone and a TResNet backbone (training-mode ABN; width 16,
    layers (1, 2, 2, 1), registered as a variant in both packages): one
    step of each driver from the same ``_latest``, held to each other as
    ``test_training_matches_jax_driver`` holds the Swin's, the TResNet's
    running statistics too. ``--device_augment`` (the Swin nano, each
    step's uint8 batch augmented by ``make_device_augment``; its draws are
    the port's own): ``-t`` at batch 8 (4 steps over the 31 frames, loss
    "i"), the steps, finite losses and a ``_latest`` holding the
    backbone's parameters; the augmentation is held to JAX's by
    tests/test_torch_device_augment.py."""
    from computervision_codes_tpu.models import tresnet as jax_tresnet
    from computervision_codes_tpu_torch.models import tresnet
    from test_torch_tresnet import SMALL

    monkeypatch.setitem(jax_tresnet.VARIANTS, "tresnet_small", SMALL)
    monkeypatch.setitem(tresnet.VARIANTS, "tresnet_small", SMALL)
    if not path.startswith("--"):
        _, port_result = train_both(runs["root"], str(tmp_path), path)
        assert_training_matches(str(tmp_path), port_result,
                                batch_stats=path.startswith("tresnet"))
        return
    made, augmented = [], []
    original = spatial_transformer.make_device_augment

    def make(*args, **kw):
        made.append(args)
        return counting(original(*args, **kw), augmented)

    monkeypatch.setattr(spatial_transformer, "make_device_augment", make)
    argv = ["--data_dir", runs["root"], "-t", "--epochs", "1", "-b", "8",
            "--backbone", "swin_nano_64", "--loss_type", "i",
            "--image_height", str(IMG), "--image_width", str(IMG),
            "--ckpt_root", str(tmp_path), "--device", "cpu",
            "--augmentation_list", "original", "vflip", "hflip", "contrast",
            "rot90", path]
    result = spatial_transformer.main(argv)
    assert result["step"] == 4
    assert all(np.isfinite(list(e.values())).all()
               for e in result["train_loss"])
    assert made == [(("original", "vflip", "hflip", "contrast",
                      "rot90"),)] and len(augmented) == 4
    name = "rendezvous_lcholect45-crossval_cholect1_i"
    params = read_msgpack(f"{tmp_path}/run_/{name}_latest.msgpack")["params"]
    assert "backbone" in params and all(
        np.isfinite(v).all() for _, v in _leaves(params["backbone"]))
