"""The port's frame source (``data/synthetic.py``, ``data/pipeline.py``,
``data/prefetch.py``) and eval loop (``cli/common.py``) against the JAX
package's, on trees that both write.

Tolerances: the synthetic writers' labels and pixels exact; labels,
``valid``, teacher arrays and the shuffled order exact; eval images bit
for bit (both packages decode a chunk with the same fixed-point resize and
normalisation); train images exact at the frames' own size, and uint8
frames within 1 LSB of a resize (the JAX package resizes with PIL, the
port with the native plane; 1 / (255 * 0.224) after normalisation); the
eval loop's mAP and report equal.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from computervision_codes_tpu.cli import common as jax_common
from computervision_codes_tpu.data import feature_store as jax_fs
from computervision_codes_tpu.data import native as jax_native
from computervision_codes_tpu.data import pipeline as jax_pipeline
from computervision_codes_tpu.data import synthetic as jax_synthetic
from computervision_codes_tpu_torch.cli import common
from computervision_codes_tpu_torch.data import (
    VideoReader,
    feature_store,
    pipeline,
    synthetic,
    video_supported,
)
from computervision_codes_tpu_torch.data.prefetch import prefetch_to_device
from computervision_codes_tpu_torch.parallel.mesh import (
    batch_sharding,
    launch,
    make_mesh,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIDEOS = ("VID01", "VID02")
FRAMES, H, W = 7, 24, 40
SIZE = (16, 32)
LSB = 1.0 / (255.0 * 0.224) + 1e-6
KEYS = ("label_i", "label_v", "label_t", "label_ivt", "teacher_pred_i",
        "teacher_feat_t", "valid")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch work on one thread: under the suite's parallel
    workers, torch's default of one thread per core oversubscribes the
    host, and tiny ops then wait on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    roots = {}
    for name, write in (("jax", jax_synthetic.write_synthetic_dataset),
                        ("port", synthetic.write_synthetic_dataset)):
        roots[name] = str(tmp_path_factory.mktemp(name))
        write(roots[name], VIDEOS, frames_per_video=FRAMES, height=H,
              width=W, write_images=True)
    return roots


def _frames(root, video):
    d = os.path.join(root, "data", video)
    return [os.path.join(d, f) for f in sorted(os.listdir(d))]


def test_synthetic_png_tree_matches_jax(trees):
    """The same files, labels and pixels: the port's PNGs decode (PIL,
    libpng and the port's plane) to the JAX writer's pixels."""
    for v in VIDEOS:
        ours, theirs = _frames(trees["port"], v), _frames(trees["jax"], v)
        assert [os.path.basename(p) for p in ours] == [
            os.path.basename(p) for p in theirs]
        want = np.stack([np.asarray(Image.open(p)) for p in theirs])
        np.testing.assert_array_equal(
            pipeline.native.decode_batch_u8(ours, (H, W)), want)
        np.testing.assert_array_equal(
            jax_native.decode_batch_u8(ours, (H, W)), want)
        np.testing.assert_array_equal(
            np.stack([np.asarray(Image.open(p)) for p in ours]), want)
        for sub in ("triplet", "instrument", "verb", "target"):
            with open(os.path.join(trees["jax"], sub, f"{v}.txt")) as a, \
                    open(os.path.join(trees["port"], sub, f"{v}.txt")) as b:
                assert a.read() == b.read()


def test_container_tree_needs_libjpeg(tmp_path):
    """The JAX writer's MJPEG-AVI tree: the port's writer and dataset
    refuse it, naming libjpeg (the JAX frames stay readable by JAX)."""
    jax_root = str(tmp_path / "jax")
    jax_synthetic.write_synthetic_dataset(jax_root, VIDEOS[:1],
                                          frames_per_video=3, height=H,
                                          width=W, container=True)
    with jax_native.VideoReader(os.path.join(jax_root, "data",
                                             "VID01.avi")) as vr:
        assert len(vr) == 3
    with pytest.raises(RuntimeError, match="libjpeg"):
        synthetic.write_synthetic_dataset(str(tmp_path / "port"), VIDEOS[:1],
                                          frames_per_video=3,
                                          write_images=True, container=True)
    ds = pipeline.CholecDataset(jax_root, image_size=SIZE)
    with pytest.raises(RuntimeError, match="libjpeg"):
        next(pipeline.video_eval_batches(ds, "VID01", 2))
    assert not video_supported()
    with pytest.raises(RuntimeError, match="libjpeg"):
        VideoReader(os.path.join(jax_root, "data", "VID01.avi"))


def _datasets(root, **kw):
    return (jax_pipeline.CholecDataset(root, image_size=SIZE, **kw),
            pipeline.CholecDataset(root, image_size=SIZE, **kw))


def _compare(got, want, image_atol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in KEYS:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        for k in ("image", "image2"):
            if k in w:
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
                np.testing.assert_allclose(
                    g[k].astype(np.float32), w[k].astype(np.float32),
                    rtol=0, atol=image_atol, err_msg=k)


@pytest.mark.parametrize("batch,pad_last", [(3, True), (4, False)])
def test_eval_batches_match_jax(trees, batch, pad_last):
    jds, ds = _datasets(trees["jax"])
    want = list(jax_pipeline.batch_iterator(jds, VIDEOS, batch, train=False,
                                            pad_last=pad_last))
    got = list(pipeline.batch_iterator(ds, VIDEOS, batch, train=False,
                                       pad_last=pad_last))
    _compare(got, want, image_atol=0)
    want = list(jax_pipeline.video_eval_batches(jds, "VID02", batch))
    got = list(pipeline.video_eval_batches(ds, "VID02", batch))
    _compare(got, want, image_atol=0)


@pytest.mark.parametrize("seed", [0, 5])
def test_train_batches_match_jax(trees, seed):
    """The shuffled order and the augmentation draws equal under one seed;
    at the frames' own size (no resize) the images are exact: flips and
    autocontrast on equal pixels."""
    augs = ("original", "vflip", "hflip", "contrast")
    kw = dict(augmentation_list=augs, image_size=(H, W))
    jds = jax_pipeline.CholecDataset(trees["jax"], **kw)
    ds = pipeline.CholecDataset(trees["jax"], **kw)
    want = list(jax_pipeline.batch_iterator(jds, VIDEOS, 4, train=True,
                                            seed=seed, two_views=True))
    got = list(pipeline.batch_iterator(ds, VIDEOS, 4, train=True, seed=seed,
                                       two_views=True))
    _compare(got, want, image_atol=0)


def test_device_augment_ships_uint8(trees):
    jds, ds = _datasets(trees["jax"], device_augment=True)
    want = list(jax_pipeline.batch_iterator(jds, VIDEOS, 5, train=True,
                                            drop_last=True))
    got = list(pipeline.batch_iterator(ds, VIDEOS, 5, train=True,
                                       drop_last=True))
    assert got[0]["image"].dtype == np.uint8 and "image2" not in got[0]
    _compare(got, want, image_atol=1)
    # TERL's two views: under device_augment both are made on the device
    # from the one uint8 "image", so neither package ships an "image2"
    want = list(jax_pipeline.batch_iterator(jds, VIDEOS, 5, train=True,
                                            drop_last=True, two_views=True))
    got = list(pipeline.batch_iterator(ds, VIDEOS, 5, train=True,
                                       drop_last=True, two_views=True))
    assert "image2" not in got[0] and "image2" not in want[0]
    _compare(got, want, image_atol=1)


def test_load_frame_and_teachers_match_jax(trees, tmp_path):
    jds, ds = _datasets(trees["jax"])
    rng = np.random.default_rng(0)
    preds = {v: rng.random((FRAMES, 6)).astype(np.float32) for v in VIDEOS}
    feats = {v: rng.random((FRAMES, 8)).astype(np.float32) for v in VIDEOS}
    store = jax_fs.FeatureStore(str(tmp_path), "t")
    for task in ("i", "v", "t"):
        store.save(1, "pred", preds, task)
        store.save(1, "feats", feats, task)
    jds.attach_teachers(store, store, 1, VIDEOS)
    port_store = feature_store.FeatureStore(str(tmp_path), "t")
    ds.attach_teachers(port_store, port_store, 1, VIDEOS)
    assert ds.frame_index(VIDEOS) == jds.frame_index(VIDEOS)
    got = ds.load_frame("VID02", 3, teacher_dim=8)
    want = jds.load_frame("VID02", 3, teacher_dim=8)
    assert set(got) == set(want)
    for k in want:
        atol = LSB if k == "image" else 0
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=k)


def test_producer_exception_reraised(trees, tmp_path):
    """A frame that fails to decode raises in the consumer, eval and
    train, instead of ending the stream early."""
    import shutil

    root = str(tmp_path / "tree")
    shutil.copytree(trees["port"], root)
    os.remove(os.path.join(root, "data", "VID02", "000050.png"))
    ds = pipeline.CholecDataset(root, image_size=SIZE)
    for train in (False, True):
        with pytest.raises(IOError):
            list(pipeline.batch_iterator(ds, VIDEOS, 4, train=train))


def _run_batch(images):
    """Deterministic scores from the pixels: the same in both packages
    when the images are."""
    x = np.asarray(images, np.float64).reshape(len(images), -1)
    rng = np.random.default_rng(3)
    probs = {}
    for key, n in (("ivt", 100), ("i", 6), ("v", 10), ("t", 15)):
        proj = rng.standard_normal((x.shape[1], n)) / np.sqrt(x.shape[1])
        probs[key] = 1.0 / (1.0 + np.exp(-(x @ proj) * 4.0))
    return probs, x[:, :5]


class _Lines:
    def __init__(self):
        self.lines = []

    def log(self, msg, end="\n"):
        self.lines.append(msg)


def test_evaluate_videos_matches_jax(trees):
    jds, ds = _datasets(trees["jax"])
    jm, pm = jax_common.make_metrics(), common.make_metrics()
    want = jax_common.evaluate_videos(_run_batch, jds, VIDEOS, 3, jm,
                                      collect_features=True)
    got = common.evaluate_videos(_run_batch, ds, VIDEOS, 3, pm,
                                 collect_features=True)
    for v in VIDEOS:
        np.testing.assert_array_equal(got[v], want[v])
    for loss_type, ignore_null in (("all", False), ("i", True)):
        wt = jax_common.compute_map_table(jm, loss_type, ignore_null)
        gt = common.compute_map_table(pm, loss_type, ignore_null)
        assert set(gt) == set(wt) == set(common.COMPONENTS)
        for c in wt:
            np.testing.assert_array_equal(gt[c]["mAP"], wt[c]["mAP"])
            np.testing.assert_array_equal(gt[c]["AP"], wt[c]["AP"])
    jl, pl = _Lines(), _Lines()
    jax_common.print_final_report(jl, wt, jm)
    common.print_final_report(pl, gt, pm)
    assert pl.lines == jl.lines
    assert (common.REFERENCE_CHALLENGE_PROTOCOL
            == jax_common.REFERENCE_CHALLENGE_PROTOCOL)
    common.reset_metrics(pm)
    jax_common.reset_metrics(jm)
    assert pm["ivt"]._videos() == jm["ivt"]._videos()


def test_prefetch_to_device_on_cpu(trees):
    _, ds = _datasets(trees["port"])
    host = list(pipeline.batch_iterator(ds, VIDEOS, 4, train=False,
                                        pad_last=True))
    moved = list(prefetch_to_device(iter(host), depth=2, device="cpu"))
    assert len(moved) == len(host)
    for h, d in zip(host, moved):
        assert set(d) == set(h)
        for k, v in h.items():
            assert isinstance(d[k], torch.Tensor)
            assert torch.equal(d[k], torch.from_numpy(v))
    # a batch sharding over a one-rank mesh (a group in this process for
    # the call): the rank's slice is the whole batch
    sharded = launch(_prefetch_sharded, 1, (host,), device_type="cpu")
    assert len(sharded) == len(host)
    for h, d in zip(host, sharded):
        for k, v in h.items():
            assert torch.equal(d[k], torch.from_numpy(v))


def _prefetch_sharded(host):
    mesh = make_mesh(n_data=1, device_type="cpu")
    return list(prefetch_to_device(iter(host),
                                   sharding=batch_sharding(mesh)))


_NO_JAX_NO_PIL = """
import sys
for name in ("PIL", "jax", "jaxlib", "flax", "msgpack"):
    sys.modules[name] = None  # import raises ImportError
import numpy as np
from computervision_codes_tpu_torch.cli import infer
from computervision_codes_tpu_torch.data import pipeline
from computervision_codes_tpu_torch.data.synthetic import (
    write_synthetic_dataset)

root = sys.argv[1]
write_synthetic_dataset(root, ["VID01"], frames_per_video=5, height=40,
                        width=64, write_images=True)
ds = pipeline.CholecDataset(root, image_size=(32, 56))
for train in (True, False):
    batches = list(pipeline.batch_iterator(ds, ["VID01"], 2, train=train,
                                           pad_last=True))
    assert len(batches) == 3 and np.isfinite(batches[0]["image"]).all()
res = infer.main(["--video", root + "/data/VID01", "--device", "cpu",
                  "--random_init", "--quantize", "--batch", "1",
                  "--clip_len", "4", "--height", "32", "--width", "56"])
assert res["probs"]["ivt"].shape == (5, 100)
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("PIL", "jax", "flax", "msgpack", "computervision_codes_tpu")
             and sys.modules[m] is not None)
assert not bad, bad
print("frame path ok")
"""


def test_frame_path_without_pil_or_jax(tmp_path):
    """The synthetic PNG writer, batch_iterator (train, with rot90, and
    eval) and cli.infer with PIL, JAX, flax and msgpack unimportable; no
    module of PIL or of the JAX package gets loaded."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_NO_PIL,
                           str(tmp_path / "tree")], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "frame path ok" in proc.stdout
