"""The port's MS-TCT driver against the JAX package's, end to end on the CPU.

The JAX driver trains one epoch on a tiny synthetic tree (dims 8, 2 heads,
``--window 16``), then evaluates and dumps (``-t -e -d``). The port's
driver then runs ``-e -d --device cpu`` from that checkpoint, as the
command a user types, into a feature root of its own. Its dumps and its
test mAP must equal the JAX ``MSTCT.apply`` at each video's own length.
Where a video's length is a bucket size (128), they must also equal the
JAX driver's own dump; at the other length (100) the JAX driver pads to
128 and its outputs move, which the port does not copy. Both drivers then
run ``-e -d --dtype bfloat16`` from the same checkpoint: at the bucket
length the port's dumps hold the JAX driver's values within bf16 bounds,
written as float32 where JAX pickles ml_dtypes bfloat16.
"""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from computervision_codes_tpu.cli import temporal_mstct as jax_driver
from computervision_codes_tpu.data.labels import load_video_labels
from computervision_codes_tpu.metrics import Recognition as JaxRecognition
from computervision_codes_tpu.models.mstct import MSTCT as JaxMSTCT
from computervision_codes_tpu_torch.cli import temporal_mstct
from computervision_codes_tpu_torch.data.feature_store import FeatureStore
from computervision_codes_tpu_torch.data.splits import resolve_split
from computervision_codes_tpu_torch.data.synthetic import (
    synthetic_feature_dict,
    write_synthetic_dataset,
)
from computervision_codes_tpu_torch.train.checkpoint import (
    checkpoint_path,
    restore_variables,
)

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
    jax_driver.main([*common, "--feats_dir", jax_feats, "-t", "--epochs",
                     "1", "--window", "16", "-e", "-d"])
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

    return {"root": root, "common": common,
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


def test_driver_refuses_what_is_not_ported(tmp_path):
    base = ["--data_dir", str(tmp_path)]
    for extra, slice_name in ((["-t"], "training slice"),
                              (["--resume"], "training slice"),
                              (["--log_train_map"], "training slice"),
                              (["--seq_devices", "2"], "parallel slice")):
        with pytest.raises(NotImplementedError, match=slice_name):
            temporal_mstct.main(base + extra)


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
