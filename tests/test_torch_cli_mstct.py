"""The port's MS-TCT driver against the JAX package's, end to end on the CPU.

Both drivers train one epoch on a tiny synthetic tree (dims 8, 2 heads,
``-t --epochs 1 --window 16 -b 8``: four SGD steps on the same windows,
drawn from the same seed), then evaluate and dump (``-e -d``), each from
the JAX driver's initial state (``--resume`` from a ``_latest`` holding
it) and with dropout off (the two packages draw different masks), the
port in process with ``--device cpu``. Their logged losses, checkpoints,
dumps and test mAP must agree within float32 bounds; then both resume
from their own ``_latest`` for one more epoch and must agree again. The
port's driver then runs ``-e -d --device cpu`` from the JAX driver's
checkpoint, as the command a user types, into a feature root of its own.
Its dumps and its test mAP must equal the JAX ``MSTCT.apply`` at each
video's own length.
Where a video's length is a bucket size (128), they must also equal the
JAX driver's own dump; at the other length (100) the JAX driver pads to
128 and its outputs move, which the port does not copy. Both drivers then
run ``-e -d --dtype bfloat16`` from the same checkpoint: at the bucket
length the port's dumps hold the JAX driver's values within bf16 bounds,
written as float32 where JAX pickles ml_dtypes bfloat16. Last, the port's
``-e -d --seq_devices 2 --seq_attn ring`` on two gloo ranks holds the same
values as the JAX model and, at the bucket length, as the JAX driver.
"""

import functools
import os
import shutil
import signal
import subprocess
import sys

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervision_codes_tpu.cli import temporal_mstct as jax_driver
from computervision_codes_tpu.data.labels import load_video_labels
from computervision_codes_tpu.metrics import Recognition as JaxRecognition
from computervision_codes_tpu.models.mstct import MSTCT as JaxMSTCT
from computervision_codes_tpu.train import (
    TrainState,
    build_sgd,
    reference_warmup_exp_schedule,
)
from computervision_codes_tpu.train.checkpoint import (
    CheckpointManager as JaxCheckpointManager,
)
from computervision_codes_tpu_torch.cli import temporal_mstct
from computervision_codes_tpu_torch.models import mstct as port_mstct
from computervision_codes_tpu_torch.models.common import Dropout
from computervision_codes_tpu_torch.parallel import mesh as parallel_mesh
from computervision_codes_tpu_torch.data.feature_store import FeatureStore
from computervision_codes_tpu_torch.data.splits import resolve_split
from computervision_codes_tpu_torch.data.synthetic import (
    synthetic_feature_dict,
    write_synthetic_dataset,
)
from computervision_codes_tpu_torch.train.checkpoint import (
    checkpoint_path,
    read_msgpack,
    restore_variables,
)
from computervision_codes_tpu_torch.utils.logging import summarize_events
from computervision_codes_tpu_torch.utils.preempt import PreemptionGuard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IN_DIM = 16
BUCKET, ODD = 128, 100  # a bucket size and a length the JAX driver pads
MODEL_FLAGS = ["--inter_channels", "8", "8", "8", "8", "--head", "2",
               "--num_block", "1", "--mlp_ratio", "2",
               "--final_embedding_dim", "8"]
# float32 on both sides, the same ops in the same order: the dumps agree to
# float32 rounding of sums in another order (1e-5 of max(1, max|want|))
REL = 1e-5
# bf16 on both sides: the packages round at different points (XLA after
# its fusions, the port after every op). Features: the whole-model bf16
# bound of tests/test_torch_mstct.py, 2^-5 of max(1, max|want|) (measured
# up to 1.2e-2 here); probabilities: the bf16 serving cross-check bound of
# tests/test_torch_serving.py, max 0.1 (measured up to 0.047); correlation
# > 0.999 for both
BF16_FEATS_REL, BF16_PROB_ABS, BF16_CORR = 2.0 ** -5, 0.1, 0.999
MODELNAME = "rendezvous_lcholect45-crossval_cholect1_mstct_ivt"
TRAIN_FLAGS = ["-t", "--epochs", "1", "--window", "16", "-b", "8",
               "--resume"]
# the two drivers' training, float32, dropout off: the same SGD steps with
# sums in another order. The logged loss at rtol 1e-5; each checkpointed
# parameter within 1e-6 plus 1% of its largest change in the run (as
# tests/test_torch_mstct_train.py bounds one step); the dumps after
# training, 1e-4 of max(1, max|want|) (four steps of rounding differences
# through the model); the test mAP within 1e-3 (a ranking over the test
# frames: a near-tie may swap)
TRAIN_LOSS_RTOL, TRAIN_PARAM_ATOL, TRAIN_PARAM_REL = 1e-5, 1e-6, 1e-2
TRAIN_DUMP_REL, TRAIN_MAP_ABS = 1e-4, 1e-3
RANKS_TIMEOUT = 300  # s: a spawned group past it is killed, and fails


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch work on one thread: under the suite's parallel
    workers, torch's default of one thread per core oversubscribes the
    host, and tiny ops then wait on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _init_latest(ckpt_roots):
    """The JAX driver's initial state (its seed, model and optimizer) as
    ``_latest`` in each checkpoint root, for ``--resume``; returns its
    params."""
    model = JaxMSTCT(embed_dims=(8, 8, 8, 8), num_blocks=1, num_heads=2,
                     mlp_ratio=2.0, final_embedding_dim=8, num_classes=100)
    sched = reference_warmup_exp_schedule(0.01, 0.1, 58, 0.99,
                                          steps_per_epoch=4)
    # create_train_state's state, its init jitted (an eager flax init of
    # MSTCT takes seconds)
    key = jax.random.PRNGKey(47)
    variables = jax.jit(model.init)(key, jnp.zeros((1, 16, IN_DIM)))
    state = TrainState.create(apply_fn=model.apply,
                              params=variables["params"],
                              tx=build_sgd(sched, 1e-5),
                              rng=jax.random.fold_in(key, 1))
    for root in ckpt_roots:
        path = JaxCheckpointManager(root + "/run_", MODELNAME).save(
            state, tag="latest")
    return read_msgpack(path)["params"]


def _train_both(jax_argv, port_argv):
    """The JAX driver, then the port's in process, with every dropout rate
    0 (the flax ``Dropout`` and the port's swapped for the length of the
    runs)."""
    flax_dropout = flax.linen.Dropout
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout",
                   lambda rate, **kw: flax_dropout(0.0, **kw))
        mp.setattr(port_mstct, "Dropout", lambda rate: Dropout(0.0))
        jax_result = jax_driver.main(jax_argv)
        port_result = temporal_mstct.main(port_argv + ["--device", "cpu"])
    return jax_result, port_result


def _lengths(split):
    """ODD frames for the first four test videos, BUCKET for the rest."""
    odd = set(split.test[:4])
    return [ODD if v in odd else BUCKET for v in split.all_videos]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cholect45"))
    split = resolve_split("cholect45-crossval", 1)
    lengths = _lengths(split)
    write_synthetic_dataset(root, split.all_videos, lengths)
    feats = synthetic_feature_dict(split.all_videos, lengths, IN_DIM)
    jax_feats, port_feats = root + "/feats_jax", root + "/feats_port"
    FeatureStore(jax_feats, "Q2L").save(1, "feats", feats)
    shutil.copytree(jax_feats, port_feats)
    common = ["--data_dir", root, "--ckpt_root", root + "/ckpt",
              *MODEL_FLAGS]
    # both drivers train from the same state; the port into roots of its
    # own, then the port evaluates the JAX driver's checkpoint
    shutil.copytree(jax_feats, root + "/feats_port_train")
    init_params = _init_latest([root + "/ckpt", root + "/ckpt_port"])
    jax_train, port_train = _train_both(
        [*common, "--feats_dir", jax_feats, *TRAIN_FLAGS, "-e", "-d"],
        ["--data_dir", root, "--ckpt_root", root + "/ckpt_port",
         *MODEL_FLAGS, "--feats_dir", root + "/feats_port_train",
         *TRAIN_FLAGS, "-e", "-d"])
    proc = subprocess.run(
        [sys.executable, "-m", "computervision_codes_tpu_torch.cli."
         "temporal_mstct", *common, "--feats_dir", port_feats, "-e", "-d",
         "--device", "cpu"],
        cwd=root, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr

    # the JAX model at each video's own length, from the same checkpoint
    ckpt = checkpoint_path(root + "/ckpt/run_",
                           "rendezvous_lcholect45-crossval_cholect1_mstct_ivt")
    variables = {"params": restore_variables(ckpt)["params"]}
    model = JaxMSTCT(embed_dims=(8, 8, 8, 8), num_blocks=1, num_heads=2,
                     mlp_ratio=2.0, final_embedding_dim=8, num_classes=100)
    apply = jax.jit(lambda v, x: model.apply(v, x))
    natural = {}
    for v in split.all_videos:
        out = apply(variables, jnp.asarray(feats[v][None]))
        natural[v] = (np.asarray(jax.nn.sigmoid(out["logits"][0])),
                      np.asarray(out["feature"][0]))
    jax_mAP = JaxRecognition(100)
    for v in split.test:
        jax_mAP.update(load_video_labels(root, v).triplet, natural[v][0])
        jax_mAP.video_end()

    def dump(feats_root, kind):
        return FeatureStore(feats_root, "Q2LMSTCT").load(1, kind, task="ivt")

    return {"root": root, "common": common, "feats_jax": jax_feats,
            "init_params": init_params,
            "jax_train": jax_train, "port_train": port_train,
            "port_train_dump": {k: dump(root + "/feats_port_train", k)
                                for k in ("feats", "pred")},
            "split": split, "lengths": dict(zip(split.all_videos, lengths)),
            "natural": natural, "stdout": proc.stdout,
            "natural_mAP": jax_mAP.compute_video_AP()["mAP"],
            "port": {k: dump(port_feats, k) for k in ("feats", "pred")},
            "jax": {k: dump(jax_feats, k) for k in ("feats", "pred")}}


def _err(got, want):
    return float(np.abs(got - want).max()) / max(1.0, float(
        np.abs(want).max()))


def test_driver_matches_jax_at_natural_length(runs):
    split, natural = runs["split"], runs["natural"]
    port = runs["port"]
    assert set(port["feats"]) == set(port["pred"]) == {
        v[3:] for v in split.all_videos}
    for v in split.all_videos:
        probs, feats = port["pred"][v[3:]], port["feats"][v[3:]]
        n = runs["lengths"][v]
        assert probs.shape == (n, 100) and feats.shape == (n, 8), v
        assert _err(probs, natural[v][0]) <= REL, v
        assert _err(feats, natural[v][1]) <= REL, v
    printed = [line for line in runs["stdout"].splitlines()
               if line.startswith("test mAP[ivt]:")]
    assert printed == [f"test mAP[ivt]: {round(runs['natural_mAP'], 4)}"]


def test_driver_matches_jax_driver_at_bucket_length(runs):
    """At a bucket length the JAX driver pads nothing, and the two drivers'
    dumps agree."""
    jax_dump, port = runs["jax"], runs["port"]
    at_bucket = [v for v, n in runs["lengths"].items() if n == BUCKET]
    assert len(at_bucket) == 41
    for v in at_bucket:
        for kind in ("feats", "pred"):
            assert _err(port[kind][v[3:]], jax_dump[kind][v[3:]]) <= REL, v


def test_padding_to_a_bucket_moves_the_jax_outputs(runs):
    """The fault of the reference that the port does not copy: the JAX
    driver pads a 100-frame video to 128 and MSTCT attends over the padded
    frames with no key mask, so the real frames' outputs move; the port
    evaluates at the video's own length, which the reference does
    (Temporal_mstct/run.py:248)."""
    jax_dump, natural = runs["jax"], runs["natural"]
    odd = [v for v, n in runs["lengths"].items() if n == ODD]
    assert len(odd) == 4
    for v in odd:
        padded = jax_dump["feats"][v[3:]]
        assert padded.shape == (ODD, 8)  # cut back to the video's length
        assert _err(padded, natural[v][1]) > 100 * REL, v
        assert _err(runs["port"]["feats"][v[3:]], natural[v][1]) <= REL, v


def _ckpt(root, tag):
    return read_msgpack(checkpoint_path(root + "/run_", MODELNAME, tag))


def _losses(root):
    return [r["values"]["loss"] for r in summarize_events(
        f"{root}/run_/{MODELNAME}.events.jsonl", "train/loss")]


def _assert_same_training(jax_root, port_root, init):
    """The two drivers' logged losses and ``_latest`` checkpoints agree."""
    np.testing.assert_allclose(_losses(port_root), _losses(jax_root),
                               rtol=TRAIN_LOSS_RTOL)
    got, want = _ckpt(port_root, "latest"), _ckpt(jax_root, "latest")
    assert int(got["step"]) == int(want["step"])
    assert int(got["opt_state"]["1"]["1"]["count"]) == int(
        want["opt_state"]["1"]["1"]["count"]) == int(want["step"])
    for g, w, o in zip(jax.tree.leaves(got["params"]),
                       jax.tree.leaves(want["params"]),
                       jax.tree.leaves(init["params"])):
        tol = TRAIN_PARAM_ATOL + TRAIN_PARAM_REL * float(np.abs(w - o).max())
        assert float(np.abs(g - w).max()) <= tol


def test_training_matches_jax_driver(runs):
    """``-t -e -d`` of both drivers from the same state on the same
    windows: the loss, the checkpoints, then the dumps and the test mAP
    from each driver's best checkpoint (JAX's as ``MSTCT.apply`` at each
    video's own length)."""
    root = runs["root"]
    init = {"params": runs["init_params"]}
    _assert_same_training(root + "/ckpt", root + "/ckpt_port", init)
    assert runs["port_train"]["step"] == 4
    best_port = _ckpt(root + "/ckpt_port", "")
    assert int(best_port["step"]) == 4
    dump, natural = runs["port_train_dump"], runs["natural"]
    for v in runs["split"].all_videos:
        assert _err(dump["pred"][v[3:]], natural[v][0]) <= TRAIN_DUMP_REL, v
        assert _err(dump["feats"][v[3:]], natural[v][1]) <= TRAIN_DUMP_REL, v
    assert abs(runs["port_train"]["test_mAP"] - runs["natural_mAP"]) <= \
        TRAIN_MAP_ABS


def test_training_resumes_like_jax_driver(runs, tmp_path):
    """Both drivers ``--resume`` from their own ``_latest`` (copies) for one
    more epoch: step 8 on both, the same loss and weights."""
    root = runs["root"]
    for side in ("ckpt", "ckpt_port"):
        shutil.copytree(f"{root}/{side}", f"{tmp_path}/{side}")
    init = {"params": _ckpt(root + "/ckpt", "latest")["params"]}
    tail = ["--feats_dir", runs["feats_jax"], *MODEL_FLAGS, *TRAIN_FLAGS]
    _train_both(["--data_dir", root, "--ckpt_root", f"{tmp_path}/ckpt",
                 *tail],
                ["--data_dir", root, "--ckpt_root", f"{tmp_path}/ckpt_port",
                 *tail])
    assert int(_ckpt(f"{tmp_path}/ckpt_port", "latest")["step"]) == 8
    _assert_same_training(f"{tmp_path}/ckpt", f"{tmp_path}/ckpt_port", init)


def test_driver_runs_training_flags_and_refuses_seq_devices(runs, tmp_path,
                                                            monkeypatch):
    """``--train``, ``--resume`` and ``--log_train_map`` run (dropout on);
    a preemption signal saves ``_latest`` and stops. (``--seq_devices 2``,
    refused until the parallel slice, runs: the test below.)"""
    base = ["--data_dir", runs["root"], "--feats_dir", runs["feats_jax"],
            "--ckpt_root", str(tmp_path), *MODEL_FLAGS, "--window", "16",
            "-b", "16", "--device", "cpu", "-t", "--log_train_map",
            "--resume"]
    handlers = [signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)]
    result = temporal_mstct.main(base + ["--epochs", "2"])
    assert result["train_epochs"] == 2 and result["step"] == 4
    # the preemption guard gives the signals back when training ends
    assert [signal.getsignal(s)
            for s in (signal.SIGTERM, signal.SIGINT)] == handlers
    records = summarize_events(
        f"{tmp_path}/run_/{MODELNAME}.events.jsonl", "train/loss")
    assert [r["step"] for r in records] == [0, 1]
    for r in records:
        assert np.isfinite(r["values"]["loss"])
        assert 0.0 <= r["values"]["train_mAP"] <= 1.0
    result = temporal_mstct.main(base + ["--epochs", "1"])
    assert result["step"] == 6  # resumed at step 4
    log = open(f"{tmp_path}/run_/{MODELNAME}.log").read()
    assert "Resumed from" in log and "at step 4" in log

    class Requested(PreemptionGuard):
        def __enter__(self):
            self.requested = True
            return self

    monkeypatch.setattr(temporal_mstct, "PreemptionGuard", Requested)
    result = temporal_mstct.main(base + ["--epochs", "1"])
    assert result["preempted"] and int(_ckpt(str(tmp_path), "latest")[
        "step"]) == 6


def test_seq_devices_ring_matches_jax(runs, tmp_path, monkeypatch):
    """``-e -d --seq_devices 2 --seq_attn ring`` from the JAX driver's
    checkpoint: two gloo ranks (spawned by the driver itself), each video's
    frames split between them (every length here divides by 2), the ring
    running every attention. Every dump equals the JAX model at the
    video's own length, and at the bucket length the JAX driver's dump,
    within ``REL``: JAX's tests/test_parallel.py holds its driver's
    sequence-sharded ring forward to the unsharded one (running that
    driver with ``--seq_devices 2`` here recompiles for every video, 94 s
    on this test's tree)."""
    argv = [*runs["common"], "-e", "-d", "--seq_devices", "2",
            "--seq_attn", "ring", "--device", "cpu"]
    feats = str(tmp_path / "feats")
    shutil.copytree(runs["feats_jax"], feats)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # one thread a rank
    monkeypatch.setattr(parallel_mesh, "launch", functools.partial(
        parallel_mesh.launch, timeout=RANKS_TIMEOUT))
    result = temporal_mstct.main(argv + ["--feats_dir", feats])
    assert result["test_mAP"] == pytest.approx(runs["natural_mAP"],
                                               abs=1e-6)
    port = {k: FeatureStore(feats, "Q2LMSTCT").load(1, k, task="ivt")
            for k in ("feats", "pred")}
    for v, n in runs["lengths"].items():
        probs, feats_v = port["pred"][v[3:]], port["feats"][v[3:]]
        assert probs.shape == (n, 100), v
        assert _err(probs, runs["natural"][v][0]) <= REL, v
        assert _err(feats_v, runs["natural"][v][1]) <= REL, v
        if n == BUCKET:
            for kind, got in (("pred", probs), ("feats", feats_v)):
                assert _err(got, runs["jax"][kind][v[3:]]) <= REL, v


@pytest.fixture(scope="module")
def bf16_runs(runs):
    """Both drivers ``-e -d --dtype bfloat16`` from the float32 run's
    checkpoint, on its tree and features."""
    root, common = runs["root"], runs["common"]
    out = {}
    for side in ("jax", "port"):
        feats_root = f"{root}/feats_{side}_bf16"
        shutil.copytree(f"{root}/feats_{side}", feats_root)
        argv = [*common, "--feats_dir", feats_root, "-e", "-d", "--dtype",
                "bfloat16"]
        if side == "jax":
            jax_driver.main(argv)
        else:
            proc = subprocess.run(
                [sys.executable, "-m", "computervision_codes_tpu_torch.cli."
                 "temporal_mstct", *argv, "--device", "cpu"],
                cwd=root, env=dict(os.environ, PYTHONPATH=REPO),
                capture_output=True, text=True, timeout=300)
            assert proc.returncode == 0, proc.stderr
        out[side] = {k: FeatureStore(feats_root, "Q2LMSTCT").load(
            1, k, task="ivt") for k in ("feats", "pred")}
    return out


def test_bf16_driver_matches_jax_driver_at_bucket_length(runs, bf16_runs):
    """``--dtype bfloat16``: at a bucket length the two drivers' dumps hold
    the same values within the bf16 bounds above, compared as float32; the
    JAX driver pickles ml_dtypes bfloat16 arrays, which need ml_dtypes to
    read, where the port writes float32 arrays holding bf16 values."""
    port, jax_dump = bf16_runs["port"], bf16_runs["jax"]
    at_bucket = [v for v, n in runs["lengths"].items() if n == BUCKET]
    for v in at_bucket:
        for kind in ("feats", "pred"):
            got, want = port[kind][v[3:]], jax_dump[kind][v[3:]]
            assert want.dtype == jnp.bfloat16, (v, kind)
            assert got.dtype == np.float32, (v, kind)
            np.testing.assert_array_equal(
                got, got.astype(jnp.bfloat16).astype(np.float32))
            want = want.astype(np.float32)
            if kind == "feats":
                assert _err(got, want) <= BF16_FEATS_REL, v
            else:
                assert np.abs(got - want).max() < BF16_PROB_ABS, v
            assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > BF16_CORR, (
                v, kind)
