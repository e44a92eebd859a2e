"""The port's temporal TCN driver (``cli/temporal_tcn.py``) and
``cli/crossval.py`` against the JAX package's, end to end on the CPU.

A CSV tree with every video of CholecT45's cross-validation, each of 132
frames with two frozen pairs (two consecutive equal feature rows each), so
that ``--dedup_black`` leaves 128 frames, a bucket size: there the JAX
driver pads nothing and the two drivers compute the same function (at
other lengths the JAX driver pads, which moves its outputs: pinned below).
A small TCN (``--num_layers_PG 2 --num_layers_R 2 --num_R 1
--num_f_maps 64``).

- ``-e`` from one JAX-written checkpoint: each test video's probabilities
  at 1e-5 of max(1, max|want|) and the test mAP tables at 1e-6 (float32
  sums in another order);
- TERL's TCN_black mode, ``-t -e --dedup_black --loss_type single
  --weight_source balancing --causal --train_div 4``, both drivers from one
  JAX-written ``_latest`` (``--resume``) with every dropout rate 0 in both
  packages (they draw different masks): ``--causal`` keeps the JAX
  driver's padded frames out of the real frames, and its loss masks them,
  so both train the same function on the same clips (drawn from the same
  seed); the logged losses at rtol 1e-5, each parameter of the two
  ``_latest`` files within 1e-6 plus 1% of its change over the run (the
  bound of tests/test_torch_cli_mstct.py), the test mAP tables at 1e-3 (a
  ranking: a near-tie may swap);
- the JAX ``CheckpointManager`` restores the port's ``_latest``;
- ``crossval --stage temporal_tcn --folds 1 2`` (``-e --dedup_black``)
  from JAX-written checkpoints: the per-fold and mean tables at 1e-6.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervision_codes_tpu.cli import crossval as jax_crossval
from computervision_codes_tpu.cli import temporal_tcn as jax_driver
from computervision_codes_tpu.data.temporal import pad_sequence_batch
from computervision_codes_tpu.models import tcn as jax_tcn
from computervision_codes_tpu.train import (
    TrainState,
    build_sgd,
    make_tcn_eval_step,
    reference_warmup_exp_schedule,
)
from computervision_codes_tpu.train.checkpoint import (
    CheckpointManager as JaxCheckpointManager,
)
from computervision_codes_tpu_torch.cli import crossval, temporal_tcn
from computervision_codes_tpu_torch.data.feature_store import FeatureStore
from computervision_codes_tpu_torch.data.splits import resolve_split
from computervision_codes_tpu_torch.data.synthetic import (
    synthetic_feature_dict,
    write_synthetic_dataset,
)
from computervision_codes_tpu_torch.data.temporal import (
    TemporalSequenceDataset)
from computervision_codes_tpu_torch.models import tcn as port_tcn
from computervision_codes_tpu_torch.models.convert import (
    jax_variables, load_jax_variables)
from computervision_codes_tpu_torch.train import create_train_state
from computervision_codes_tpu_torch.train import make_tcn_eval_step as \
    port_eval_step
from computervision_codes_tpu_torch.train.checkpoint import read_msgpack
from computervision_codes_tpu_torch.utils.logging import summarize_events

IN_DIM, LENGTH, DEDUP = 16, 132, 128
TCN = dict(num_layers_pg=2, num_layers_r=2, num_refinements=1,
           num_f_maps=64)
FLAGS = ["--num_layers_PG", "2", "--num_layers_R", "2", "--num_R", "1",
         "--num_f_maps", "64"]
PROB_REL, MAP_ABS = 1e-5, 1e-6
LOSS_RTOL, PARAM_ATOL, PARAM_REL, TRAIN_MAP_ABS = 1e-5, 1e-6, 1e-2, 1e-3


def modelname(fold):
    return f"rendezvous_lcholect45-crossval_cholect{fold}_tcn"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_state(seed, causal=False):
    """A JAX driver TrainState whose params are a seeded port model's."""
    port = port_tcn.TemporalTCN(IN_DIM, causal=causal,
                                generator=torch.Generator().manual_seed(seed),
                                **TCN)
    model = jax_tcn.TemporalTCN(causal=causal, **TCN)
    sched = reference_warmup_exp_schedule(0.01, 0.1, 58, 0.99, 31)
    return model, TrainState.create(
        apply_fn=model.apply, params=jax_variables(port)["params"],
        tx=build_sgd(sched, 1e-5), rng=jax.random.PRNGKey(seed))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cholect45"))
    videos = resolve_split("cholect45-crossval", 1).all_videos
    write_synthetic_dataset(root, videos, LENGTH, seed=2)
    for fold in (1, 2):
        feats = synthetic_feature_dict(videos, LENGTH, IN_DIM, seed=fold)
        for f in feats.values():  # two frozen pairs: dedup keeps 128
            f[11] = f[10]
            f[61] = f[60]
        FeatureStore(root + "/data_feats", "Res18").save(fold, "feats",
                                                         feats)
    return root


def save(root, fold, state, tag=""):
    return JaxCheckpointManager(root + "/run_", modelname(fold)).save(
        state, tag=tag)


@pytest.fixture(scope="module")
def evals(tree):
    """Both drivers' ``-e --dedup_black`` from one JAX checkpoint."""
    ckpt = tree + "/ckpt_eval"
    _, state = jax_state(1)
    save(ckpt, 1, state)
    argv = ["--data_dir", tree, "-e", "--dedup_black", "--ckpt_root", ckpt,
            *FLAGS]
    return {"jax": jax_driver.main(argv),
            "port": temporal_tcn.main(argv + ["--device", "cpu"]),
            "state": state, "root": tree}


def test_eval_matches_jax_driver(evals):
    want, got = evals["jax"]["test_mAP"], evals["port"]["test_mAP"]
    assert set(got) == set(want)
    for c in want:
        assert abs(got[c] - want[c]) <= MAP_ABS, c


def test_eval_probabilities_match_jax(evals):
    root, state = evals["root"], evals["state"]
    split = resolve_split("cholect45-crossval", 1)
    ds = TemporalSequenceDataset(root, FeatureStore(root + "/data_feats",
                                                    "Res18"), 1,
                                 split.test, dedup_black=True)
    model = jax_tcn.TemporalTCN(**TCN)
    jstep = make_tcn_eval_step(model)
    port = load_jax_variables(port_tcn.TemporalTCN(IN_DIM, **TCN),
                              {"params": jax.tree.map(np.asarray,
                                                      state.params)})
    pstate = create_train_state(port, lambda p: None, device="cpu")
    pstep = port_eval_step(port, device="cpu")
    for video in split.test:
        seq = ds[video]
        assert seq.length == DEDUP
        batch = pad_sequence_batch(seq)
        want = jstep(state, jnp.asarray(batch["features"]))
        got = temporal_tcn.eval_video(pstate, pstep, seq)
        for k in want:
            w = np.asarray(want[k])[0]
            np.testing.assert_allclose(got[k], w, rtol=0, atol=PROB_REL * max(
                1.0, float(np.abs(w).max())), err_msg=f"{video} {k}")


def test_padding_to_a_bucket_moves_the_jax_tcn_outputs(rng):
    """The JAX driver pads a 100-frame video to 128 zero frames and its TCN
    (non-causal) mixes them into the real frames near the end; the port
    runs the video at its own length, which equals the JAX module on the
    unpadded video."""
    model, state = jax_state(3)
    x = rng.standard_normal((1, 100, IN_DIM)).astype(np.float32)
    padded = np.pad(x, ((0, 0), (0, 28), (0, 0)))
    step = make_tcn_eval_step(model)
    own = np.asarray(step(state, jnp.asarray(x))["ivt"])[0]
    bucket = np.asarray(step(state, jnp.asarray(padded))["ivt"])[0, :100]
    moved = np.abs(own - bucket).max(axis=1)
    assert moved[-1] > 1e-3  # the last frames move
    port = load_jax_variables(port_tcn.TemporalTCN(IN_DIM, **TCN),
                              {"params": jax.tree.map(np.asarray,
                                                      state.params)})
    pstate = create_train_state(port, lambda p: None, device="cpu")
    got = port_eval_step(port, device="cpu")(pstate, x)["ivt"][0].numpy()
    np.testing.assert_allclose(got, own, atol=PROB_REL)


@pytest.fixture(scope="module")
def trained(tree):
    """Both drivers' TCN_black training from one JAX-written _latest, every
    dropout rate 0."""
    roots = {side: tree + f"/ckpt_{side}" for side in ("jax", "port")}
    _, state = jax_state(4, causal=True)
    for root in roots.values():
        save(root, 1, state, "latest")
    argv = ["--data_dir", tree, "-t", "-e", "--epochs", "1", "--resume",
            "--dedup_black", "--loss_type", "single", "--weight_source",
            "balancing", "--causal", "--train_div", "4", *FLAGS]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_tcn, "DilatedResidualLayer", functools.partial(
            jax_tcn.DilatedResidualLayer, dropout=0.0))
        mp.setattr(jax_driver, "TemporalTCN", functools.partial(
            jax_tcn.TemporalTCN, channel_dropout=0.0))
        mp.setattr(port_tcn, "DilatedResidualLayer", functools.partial(
            port_tcn.DilatedResidualLayer, dropout=0.0))
        mp.setattr(temporal_tcn, "TemporalTCN", functools.partial(
            port_tcn.TemporalTCN, channel_dropout=0.0))
        jax_res = jax_driver.main(argv + ["--ckpt_root", roots["jax"]])
        port_res = temporal_tcn.main(argv + ["--ckpt_root", roots["port"],
                                             "--device", "cpu"])
    return {"roots": roots, "jax": jax_res, "port": port_res,
            "init": jax.tree.map(np.asarray, state.params)}


def _events(root):
    path = f"{root}/run_/{modelname(1)}.events.jsonl"
    return summarize_events(path, "train/loss")


def test_training_matches_jax_driver(trained):
    (jrec,), (prec,) = _events(trained["roots"]["jax"]), _events(
        trained["roots"]["port"])
    assert set(prec["values"]) >= set(jrec["values"])
    for k, v in jrec["values"].items():
        np.testing.assert_allclose(prec["values"][k], v, rtol=LOSS_RTOL,
                                   err_msg=k)
    files = {side: read_msgpack(f"{root}/run_/{modelname(1)}_latest.msgpack")
             for side, root in trained["roots"].items()}
    assert int(files["port"]["step"]) == int(files["jax"]["step"]) == 7

    def check(g, w, b):
        change = np.abs(w - b).max()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=PARAM_ATOL + PARAM_REL * change)
    jax.tree.map(check, files["port"]["params"], files["jax"]["params"],
                 trained["init"])
    want, got = trained["jax"]["test_mAP"], trained["port"]["test_mAP"]
    for c in want:
        assert abs(got[c] - want[c]) <= TRAIN_MAP_ABS, c


def test_jax_restores_the_ports_tcn_checkpoint(trained):
    """The port's ``_latest`` restores into the JAX driver's TrainState."""
    _, template = jax_state(4, causal=True)
    restored = JaxCheckpointManager(
        trained["roots"]["port"] + "/run_", modelname(1)).restore(
            template, tag="latest")
    mine = read_msgpack(
        f"{trained['roots']['port']}/run_/{modelname(1)}_latest.msgpack")
    assert int(restored.step) == 7
    jax.tree.map(np.testing.assert_array_equal,
                 jax.tree.map(np.asarray, restored.params), mine["params"])


def test_unported_flags_and_loss_types_raise(tree):
    base = ["--data_dir", tree, "-e", "--device", "cpu", *FLAGS]
    for extra, err in ((["--dp_devices", "2"], NotImplementedError),
                       (["--device_augment"], NotImplementedError),
                       (["--loss_type", "kd"], ValueError)):
        with pytest.raises(err):
            temporal_tcn.main(base + extra)


def test_crossval_matches_jax(tree, capsys):
    ckpt = tree + "/ckpt_cv"
    for fold in (1, 2):
        save(ckpt, fold, jax_state(10 + fold)[1])
    rest = ["--", "--data_dir", tree, "-e", "--dedup_black", "--ckpt_root",
            ckpt, *FLAGS]
    want = jax_crossval.main(["--stage", "temporal_tcn", "--folds", "1",
                              "2"] + rest)
    got = crossval.main(["--stage", "temporal_tcn", "--folds", "1", "2"]
                        + rest + ["--device", "cpu"])
    assert got["stage"] == "temporal_tcn"
    assert set(got["per_fold"]) == {1, 2}
    for fold in (1, 2):
        for c, v in want["per_fold"][fold].items():
            assert abs(got["per_fold"][fold][c] - v) <= MAP_ABS
    for c, v in want["mean"].items():
        assert abs(got["mean"][c] - v) <= MAP_ABS
    printed = capsys.readouterr().out
    assert json.loads(printed[printed.rindex('{\n  "stage"'):])["mean"]
