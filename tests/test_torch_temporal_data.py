"""The port's copies of the data and metric modules against the JAX
package's, on the same synthetic tree: bank, splits, labels, the feature
bus, temporal sequences, synthetic data and the recognition metrics. All
are plain numpy, so they must agree exactly.
"""

import os

import numpy as np
import pytest

from computervision_codes_tpu.data import bank as jax_bank
from computervision_codes_tpu.data import feature_store as jax_fs
from computervision_codes_tpu.data import labels as jax_labels
from computervision_codes_tpu.data import splits as jax_splits
from computervision_codes_tpu.data import synthetic as jax_synthetic
from computervision_codes_tpu.data import temporal as jax_temporal
from computervision_codes_tpu.metrics import recognition as jax_rec
from computervision_codes_tpu_torch.data import bank, feature_store, labels
from computervision_codes_tpu_torch.data import splits, synthetic, temporal
from computervision_codes_tpu_torch.metrics import recognition

VIDEOS = ("VID01", "VID02", "VID110")
FRAMES = 12


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The same CSV tree written by both packages, and a feature pickle
    with a frozen pair of frames in every video."""
    roots = {}
    for name, write in (("jax", jax_synthetic.write_synthetic_dataset),
                        ("port", synthetic.write_synthetic_dataset)):
        roots[name] = str(tmp_path_factory.mktemp(name))
        write(roots[name], VIDEOS, frames_per_video=FRAMES,
              write_images=False)
    feats = synthetic.synthetic_feature_dict(VIDEOS, FRAMES, 6)
    for f in feats.values():
        f[5] = f[4]  # a frozen pair, dropped by the black-frame dedup
    feature_store.FeatureStore(roots["port"] + "/feats", "Q2L").save(
        1, "feats", feats)
    return roots, feats


def test_bank_matches_jax():
    np.testing.assert_array_equal(bank.load_bank(), jax_bank.load_bank())
    for comp in bank.COMPONENT_COLUMNS:
        np.testing.assert_array_equal(bank.component_class_ids(comp),
                                      jax_bank.component_class_ids(comp))
        np.testing.assert_array_equal(bank.component_projection(comp),
                                      jax_bank.component_projection(comp))
        np.testing.assert_array_equal(bank.null_component_mask(comp),
                                      jax_bank.null_component_mask(comp))
    with open(bank._MAPS_PATH) as a, open(jax_bank._MAPS_PATH) as b:
        assert a.read() == b.read()


def test_splits_match_jax():
    for variant in splits.VARIANTS:
        folds = (splits.crossval_folds(variant) if "crossval" in variant
                 else (1,))
        for fold in folds:
            assert (splits.resolve_split(variant, fold).__dict__
                    == jax_splits.resolve_split(variant, fold).__dict__)
    assert splits.video_name(7) == jax_splits.video_name(7) == "VID07"
    with pytest.raises(ValueError, match="unknown"):
        splits.resolve_split("cholect99")


def test_synthetic_tree_and_labels_match_jax(tree):
    roots, _ = tree
    for sub in ("triplet", "instrument", "verb", "target"):
        for v in VIDEOS:
            with open(os.path.join(roots["jax"], sub, f"{v}.txt")) as a, \
                    open(os.path.join(roots["port"], sub, f"{v}.txt")) as b:
                assert a.read() == b.read(), (sub, v)
    for v in VIDEOS:
        got = labels.load_video_labels(roots["port"], v)
        want = jax_labels.load_video_labels(roots["jax"], v)
        for field in ("frame_ids", "triplet", "tool", "verb", "target"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field))
        assert got.frame_basename(1) == want.frame_basename(1)
    rng_a, rng_b = (np.random.default_rng(3) for _ in range(2))
    got = synthetic.synthetic_labels(rng_a, 9)
    want = jax_synthetic.synthetic_labels(rng_b, 9)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    got = synthetic.synthetic_feature_dict(VIDEOS, 4, 3, seed=2)
    want = jax_synthetic.synthetic_feature_dict(VIDEOS, 4, 3, seed=2)
    for v in VIDEOS:
        np.testing.assert_array_equal(got[v], want[v])
    with pytest.raises(RuntimeError, match="libjpeg"):
        synthetic.write_synthetic_dataset(roots["port"], VIDEOS,
                                          write_images=True, container=True)


@pytest.mark.parametrize("fmt", ["pkl", "npz"])
def test_feature_store_interoperates_with_jax(tmp_path, fmt):
    data = {v: np.arange(6, dtype=np.float32).reshape(2, 3) + i
            for i, v in enumerate(VIDEOS)}
    for v in VIDEOS:
        assert feature_store.video_key(v) == jax_fs.video_key(v)
    assert feature_store.video_key("VID110") == "110"
    assert (feature_store.artifact_name(2, "pred", "ivt")
            == jax_fs.artifact_name(2, "pred", "ivt") == "k2_ivt_pred")
    port = feature_store.FeatureStore(str(tmp_path), "v", fmt)
    jax = jax_fs.FeatureStore(str(tmp_path), "v", fmt)
    assert port.save(1, "feats", data, "i") == jax.path(1, "feats", "i")
    loaded = jax.load(1, "feats", "i")
    port.save(1, "pred", loaded)
    back = port.load(1, "pred", videos=VIDEOS[:2])
    assert set(back) == {"01", "02"}
    np.testing.assert_array_equal(back["02"], data["VID02"])
    np.testing.assert_array_equal(port.load_video(1, "feats", "VID110", "i"),
                                  data["VID110"])


@pytest.mark.parametrize("dedup", [False, True])
def test_temporal_dataset_matches_jax(tree, dedup):
    root = tree[0]["port"]
    got = temporal.TemporalSequenceDataset(
        root, feature_store.FeatureStore(root + "/feats", "Q2L"), 1, VIDEOS,
        dedup_black=dedup)
    want = jax_temporal.TemporalSequenceDataset(
        root, jax_fs.FeatureStore(root + "/feats", "Q2L"), 1, VIDEOS,
        dedup_black=dedup)
    assert got.videos() == want.videos()
    for v in VIDEOS:
        g, w = got[v], want[v]
        assert g.length == w.length == (FRAMES - 2 if dedup else FRAMES)
        np.testing.assert_array_equal(g.features, w.features)
        for k in w.labels:
            np.testing.assert_array_equal(g.labels[k], w.labels[k])
        if dedup:
            np.testing.assert_array_equal(g.kept_mask, w.kept_mask)
        for window in (5, 32):
            a = temporal.sample_window(np.random.default_rng(1), g, window)
            b = jax_temporal.sample_window(np.random.default_rng(1), w,
                                           window)
            np.testing.assert_array_equal(a.features, b.features)
            np.testing.assert_array_equal(a.labels["ivt"], b.labels["ivt"])
        a = temporal.sample_clip(np.random.default_rng(4), g, min_len=3)
        b = jax_temporal.sample_clip(np.random.default_rng(4), w, min_len=3)
        np.testing.assert_array_equal(a.features, b.features)
        pa = temporal.pad_sequence_batch(g)
        pb = jax_temporal.pad_sequence_batch(w)
        assert set(pa) == set(pb)
        for k in pb:
            np.testing.assert_array_equal(pa[k], pb[k])
    for n in (1, 128, 129, 8192, 9000, 20000):
        assert temporal.pick_bucket(n) == jax_temporal.pick_bucket(n)
    x = np.ones((6, 2))
    np.testing.assert_array_equal(temporal.black_frame_dedup(x),
                                  jax_temporal.black_frame_dedup(x))


def test_recognition_matches_jax(rng):
    n = 40
    targets = [(rng.random((n, 100)) < 0.05).astype(np.float32)
               for _ in range(3)]
    scores = [rng.random((n, 100)) for _ in range(3)]
    scores[1][:, :10] = 0.5  # ties
    got, want = recognition.Recognition(100), jax_rec.Recognition(100)
    for t, s in zip(targets, scores):
        for m in (got, want):
            m.update(t[:25], s[:25])
            m.update(t[25:], s[25:])
            m.video_end()
    got.update(targets[0], scores[1])  # an open video
    want.update(targets[0], scores[1])
    for comp in ("ivt", "i", "v", "t", "iv", "it"):
        for null in (False, True):
            for fn in ("compute_video_AP", "compute_global_AP",
                       "compute_AP"):
                a = getattr(got, fn)(comp, ignore_null=null)
                b = getattr(want, fn)(comp, ignore_null=null)
                np.testing.assert_array_equal(a["AP"], b["AP"])
                assert np.array_equal(a["mAP"], b["mAP"], equal_nan=True)
        for k in (1, 5, 10):
            assert got.topK(k, comp) == want.topK(k, comp)
    np.testing.assert_array_equal(
        recognition.classwise_ap(targets[0], scores[0]),
        jax_rec.classwise_ap(targets[0], scores[0]))
    assert np.isnan(recognition.average_precision(np.zeros(4), np.ones(4)))
    with pytest.raises(ValueError, match="align"):
        got.update(np.zeros((2, 100)), np.zeros((3, 100)))
