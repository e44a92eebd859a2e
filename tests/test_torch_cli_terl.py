"""The port's TERL driver (``cli/terl_learnt.py``) against the JAX
package's, end to end on the CPU, and the TERL checkpoint both ways.

A PNG tree (fold 1 of CholecT45's cross-validation, one 64x64 frame a
video). Both drivers run ``-t -e`` for one epoch of
``TERLModel(swin_nano_64, moco_dim 256)`` with ``--mlp --moco_k 64
--kcl_k 0 --w_epoch 0 -b 32`` (the 31 training frames are one step, on the
same frames, views and anchors from the same seed), from one JAX-written
``_latest`` (``--resume``: the port reads the JAX TERL state), with
DropPath off in both packages (they draw different masks); at ``kcl_k``
0 the step draws nothing else. The logged losses agree at rtol 1e-5; the
two ``_latest`` files' params and key params within 1e-6 plus 1% of their
change in the step (the bound of tests/test_torch_train_step.py), their
queues and prototypes at 1e-5 of max(1, max|want|); the test mAP tables at
1e-3 (a ranking: a near-tie may swap). The JAX ``CheckpointManager``
restores the port's file into its own state (the other way), with and
without ``--fix_backbone``'s optimizer state. ``--imagenet_pretrain``
(a synthetic microsoft-layout Swin state dict, as
tests/test_torch_pretrained.py writes it: the published file is not in the
repository) fills ``encoder/backbone`` bit for bit and the key module is
copied from it.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervision_codes_tpu.cli import terl_learnt as jax_driver
from computervision_codes_tpu.models import moco as jax_moco
from computervision_codes_tpu.models.swin import SwinTransformer as JaxSwin
from computervision_codes_tpu.train import build_sgd as jax_build_sgd
from computervision_codes_tpu.train import freeze_swin_early as jax_freeze
from computervision_codes_tpu.train import reference_warmup_exp_schedule
from computervision_codes_tpu.train import terl as jax_terl
from computervision_codes_tpu.train.checkpoint import (
    CheckpointManager as JaxCheckpointManager,
)
from computervision_codes_tpu_torch.cli import terl_learnt
from computervision_codes_tpu_torch.data.splits import resolve_split
from computervision_codes_tpu_torch.data.synthetic import (
    write_synthetic_dataset)
from computervision_codes_tpu_torch.models import moco
from computervision_codes_tpu_torch.models.convert import jax_variables
from computervision_codes_tpu_torch.models.swin import build_swin
from computervision_codes_tpu_torch.train import build_sgd, freeze_swin_early
from computervision_codes_tpu_torch.train.checkpoint import (
    CheckpointManager, read_msgpack)
from computervision_codes_tpu_torch.train.terl import create_terl_state
from computervision_codes_tpu_torch.utils.logging import summarize_events

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_pretrained import _assert_trees_equal, _swin_sd  # noqa: E402

BACKBONE, DIM, IMG, QUEUE = "swin_nano_64", 256, 64, 64
MODELNAME = "rendezvous_lcholect45-crossval_cholect1_learnT"
LOSS_RTOL, PARAM_ATOL, PARAM_REL, QUEUE_ATOL, MAP_ABS = (1e-5, 1e-6, 1e-2,
                                                         1e-5, 1e-3)
ARGS = ["--backbone", BACKBONE, "--img_size", str(IMG), "-b", "32",
        "--epochs", "1", "--mlp", "--moco_k", str(QUEUE), "--kcl_k", "0",
        "--w_epoch", "0", "--augmentation_list", "original", "vflip",
        "hflip", "contrast"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def initial_state(tx):
    """The JAX driver's TERL state, its params a seeded port model's."""
    port = moco.TERLModel(BACKBONE, DIM, mlp=True,
                          generator=torch.Generator().manual_seed(47))
    model = jax_moco.TERLModel(BACKBONE, DIM, mlp=True)
    params = jax.tree.map(jnp.asarray, jax_variables(port)["params"])
    return jax_terl.TERLTrainState.create(
        apply_fn=model.apply, params=params, tx=tx,
        key_params=jax.tree.map(lambda x: jnp.array(x, copy=True), params),
        queue=jax_moco.init_queue(jax.random.PRNGKey(7), QUEUE, DIM),
        rng=jax.random.PRNGKey(3))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cholect45"))
    write_synthetic_dataset(root, resolve_split("cholect45-crossval",
                                                1).all_videos, 1,
                            height=IMG, width=IMG, seed=1, write_images=True)
    sched = reference_warmup_exp_schedule(0.01, 0.1, 58, 0.99, 1)
    state = initial_state(jax_build_sgd(sched, 1e-5))
    roots = {side: f"{root}/ckpt_{side}" for side in ("jax", "port")}
    for r in roots.values():
        JaxCheckpointManager(r + "/run_", MODELNAME).save(state, tag="latest")
    init = jax.tree.map(np.asarray, {"params": state.params,
                                     "key_params": state.key_params})

    def given(model, tx, rng, example, queue_size, ht_masks=None):
        return state.replace(apply_fn=model.apply, tx=tx)

    argv = ["--data_dir", root, "-t", "-e", "--resume", *ARGS]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_moco, "SwinTransformer", functools.partial(
            JaxSwin, drop_path_rate=0.0))
        mp.setattr(jax_driver, "create_terl_state", given)
        mp.setattr(moco, "build_swin", functools.partial(
            build_swin, drop_path_rate=0.0))
        jax_res = jax_driver.main(argv + ["--ckpt_root", roots["jax"]])
        port_res = terl_learnt.main(argv + ["--ckpt_root", roots["port"],
                                            "--device", "cpu"])
    return {"roots": roots, "jax": jax_res, "port": port_res, "init": init,
            "state": state}


def _file(root):
    return read_msgpack(f"{root}/run_/{MODELNAME}_latest.msgpack")


def test_one_step_matches_jax_driver(runs):
    events = {side: summarize_events(f"{r}/run_/{MODELNAME}.events.jsonl",
                                     "train/loss")
              for side, r in runs["roots"].items()}
    (jrec,), (prec,) = events["jax"], events["port"]
    assert set(prec["values"]) == set(jrec["values"])
    for k, v in jrec["values"].items():
        np.testing.assert_allclose(prec["values"][k], v, rtol=LOSS_RTOL,
                                   err_msg=k)
    files = {side: _file(r) for side, r in runs["roots"].items()}
    assert int(files["port"]["step"]) == int(files["jax"]["step"]) == 1

    def check(g, w, b):
        change = np.abs(w - b).max()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=PARAM_ATOL + PARAM_REL * change)
    for coll in ("params", "key_params"):
        jax.tree.map(check, files["port"][coll], files["jax"][coll],
                     runs["init"][coll])
    for f in moco.QUEUE_FIELDS:
        got, want = files["port"]["queue"][f], files["jax"]["queue"][f]
        assert got.dtype == want.dtype, f
        np.testing.assert_allclose(got, want, rtol=0, atol=QUEUE_ATOL * max(
            1.0, float(np.abs(want).max())), err_msg=f)
    want, got = runs["jax"]["test_mAP"], runs["port"]["test_mAP"]
    assert set(got) == set(want)
    for c in want:
        assert abs(got[c] - want[c]) <= MAP_ABS, c


def test_jax_restores_the_ports_checkpoint(runs):
    restored = JaxCheckpointManager(runs["roots"]["port"] + "/run_",
                                    MODELNAME).restore(runs["state"],
                                                       tag="latest")
    mine = _file(runs["roots"]["port"])
    assert int(restored.step) == 1 and int(restored.queue.ptr) == int(
        mine["queue"]["ptr"])
    jax.tree.map(np.testing.assert_array_equal,
                 jax.tree.map(np.asarray, restored.key_params),
                 mine["key_params"])


def test_fix_backbone_checkpoint_both_ways(tmp_path):
    """The port's --fix_backbone state (a multi_transform opt_state) in a
    file the JAX manager restores into its own frozen state, and back."""
    sched = reference_warmup_exp_schedule(0.01, 0.1, 58, 0.99, 1)
    jstate = initial_state(jax_freeze(jax_build_sgd(sched, 1e-5)))
    model = moco.TERLModel(BACKBONE, DIM, mlp=True)
    state = create_terl_state(model, freeze_swin_early(build_sgd(sched,
                                                                 1e-5)),
                              queue_size=QUEUE, device="cpu")
    state.optimizer.count = 5
    path = CheckpointManager(str(tmp_path), "m").save(state, tag="latest")
    restored = JaxCheckpointManager(str(tmp_path), "m").restore(
        jstate, tag="latest")
    assert int(restored.opt_state.inner_states["train"].inner_state[1][1]
               .count) == 5
    np.testing.assert_array_equal(np.asarray(restored.queue.feats),
                                  state.queue.feats.numpy())
    JaxCheckpointManager(str(tmp_path), "j").save(
        restored.replace(step=9), tag="latest")
    back = CheckpointManager(str(tmp_path), "j").restore(state,
                                                         tag="latest")
    assert back.step == 9 and back.optimizer.count == 5
    assert read_msgpack(path).keys() == {"step", "params", "opt_state",
                                         "key_params", "queue", "rng"}


def test_device_augment_is_refused(runs, tmp_path, monkeypatch):
    """``--device_augment``, refused until the device path was ported,
    trains: each step's frames leave the host once, as uint8, and both
    views come from ``make_device_augment(two_view=True)`` (held to JAX's
    ops by tests/test_torch_device_augment.py) with the step's generator;
    the step's loss is finite and the queue advances."""
    seen = []
    make = terl_learnt.make_device_augment

    def spy(*args, **kw):
        assert kw.get("two_view") is True
        fn = make(*args, **kw)

        def call(generator, images):
            seen.append((images.dtype, tuple(images.shape)))
            views = fn(generator, images)
            seen.append(tuple(v.shape for v in views))
            return views
        return call

    monkeypatch.setattr(terl_learnt, "make_device_augment", spy)
    root = os.path.dirname(runs["roots"]["port"])
    res = terl_learnt.main(["--data_dir", root, "-t", *ARGS,
                            "--ckpt_root", str(tmp_path), "--device", "cpu",
                            "--device_augment"])
    assert res["step"] == 1
    assert seen == [(torch.uint8, (32, IMG, IMG, 3)),
                    ((32, IMG, IMG, 3), (32, IMG, IMG, 3))]
    assert all(np.isfinite(list(e.values())).all()
               for e in res["train_loss"])


def test_imagenet_pretrain_fills_encoder_backbone(runs, tmp_path,
                                                  monkeypatch):
    from computervision_codes_tpu.models.swin import VARIANTS as JAX_SWIN
    from computervision_codes_tpu_torch.models.pretrained import (
        load_backbone_variables)

    nano = JAX_SWIN[BACKBONE]
    path = str(tmp_path / "swin_nano.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in _swin_sd(
        np.random.default_rng(5), nano["embed_dim"], nano["depths"],
        nano["num_heads"], nano["window_size"]).items()}}, path)
    seen = []
    make = terl_learnt.make_terl_eval_step

    def spy(model, ht_masks=None):
        step = make(model, ht_masks)

        def call(state, images):
            seen.append(state)
            return step(state, images)
        return call
    monkeypatch.setattr(terl_learnt, "make_terl_eval_step", spy)
    terl_learnt.main(["--data_dir", runs["roots"]["jax"].rsplit("/", 1)[0],
                      "-e", "--imagenet_pretrain", path, "--ckpt_root",
                      str(tmp_path / "ck"), "--device", "cpu", *ARGS])
    state = seen[0]
    want = load_backbone_variables(BACKBONE, path)
    _assert_trees_equal(jax_variables(state.model.encoder.backbone), want)
    _assert_trees_equal(jax_variables(state.key_model.encoder.backbone),
                        want)
