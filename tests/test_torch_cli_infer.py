"""The port's ``cli.infer`` against the JAX package's, offline and
``--streaming``, serving JAX-written checkpoints from a PNG frame
directory at the serving size (the resize the identity in both: the JAX
driver decodes with PIL, the port with its data plane), with the geometry
and TCN sizes of tests/test_cli_infer.py:15-17; exported servables
(``--servable``, offline and streaming, JAX-written and the port's own);
and its refusals.

Bound: the bf16 cross-check of tests/test_torch_serving.py (max 0.1 with a
correlation above 0.999): both packages run the model in bf16 and round in
other places. The JAX driver's restore template comes from
``shaped_train_state`` (tests/test_torch_checkpoint.py), not an eager
flax init.
"""

import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervision_codes_tpu.cli import export as jax_export
from computervision_codes_tpu.cli import infer as jax_infer
from computervision_codes_tpu.models.pipeline import (
    EndToEndRecognizer as JaxRecognizer,
)
from computervision_codes_tpu.serving import (
    StreamingSession as JaxStreamingSession,
)
from computervision_codes_tpu.train import build_sgd
from computervision_codes_tpu.train.checkpoint import CheckpointManager
from computervision_codes_tpu.train.state import TrainState
from computervision_codes_tpu_torch.cli import export, infer
from computervision_codes_tpu_torch.data.synthetic import write_png

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_checkpoint import shaped_templates  # noqa: E402

H, W = 32, 56
GEOM = ["--height", str(H), "--width", str(W)]
TCN_SIZES = dict(num_layers_pg=3, num_layers_r=2, num_refinements=1,
                 num_f_maps=16)
TCN = ["--num_layers_PG", "3", "--num_layers_R", "2", "--num_R", "1",
       "--num_f_maps", "16"]
CPU = ["--device", "cpu"]


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
def frame_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("VID01")
    rng = np.random.default_rng(0)
    for i in range(6):
        write_png(str(d / f"{i:06d}.png"),
                  rng.integers(0, 256, (H, W, 3)).astype(np.uint8))
    return str(d)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """JAX-written TrainStates: "offline" (the default recognizer, which
    JAX's offline session serves) and "stream" (the small TCN)."""
    d = str(tmp_path_factory.mktemp("ckpt"))
    x = jnp.zeros((1, 4, H, W, 3), jnp.bfloat16)
    for name, kw in (("offline", {}), ("stream", TCN_SIZES)):
        model = JaxRecognizer(dtype=jnp.bfloat16, **kw)
        # create_train_state's fields, with the init jitted (eager takes
        # twice as long)
        v = jax.jit(model.init)(jax.random.PRNGKey(1), x)
        state = TrainState.create(apply_fn=model.apply, params=v["params"],
                                  tx=build_sgd(1e-2),
                                  batch_stats=v.get("batch_stats"),
                                  rng=jax.random.PRNGKey(2))
        CheckpointManager(d, name).save(state)
    return d


def _assert_bf16_close(got, want):
    assert set(got) == set(want) == {"ivt", "i", "v", "t"}
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        assert np.corrcoef(got[k].ravel(), want[k].ravel())[0, 1] > 0.999, k
        assert np.abs(got[k] - want[k]).max() < 0.1, k


def test_offline_matches_jax(frame_dir, ckpt_dir, tmp_path):
    """Two clips of 4 frames, the second padded and trimmed back."""
    args = ["--video", frame_dir, "--ckpt_dir", ckpt_dir, "--modelname",
            "offline", "--batch", "1", "--clip_len", "4"] + GEOM
    with shaped_templates():
        want = jax_infer.main(args)
    out = str(tmp_path / "preds.npz")
    got = infer.main(args + CPU + ["--out", out])
    assert got["frames"] == want["frames"] == 6
    assert got["seconds"] > 0
    _assert_bf16_close(got["probs"], want["probs"])
    z = np.load(out)
    for k, c in (("ivt", 100), ("i", 6), ("v", 10), ("t", 15)):
        assert z[k].shape == (6, c)
        np.testing.assert_array_equal(z[k], got["probs"][k])


def test_streaming_matches_jax(frame_dir, ckpt_dir):
    args = ["--video", frame_dir, "--ckpt_dir", ckpt_dir, "--modelname",
            "stream", "--streaming", "--context", "16"] + GEOM + TCN
    with warnings.catch_warnings(), shaped_templates():
        warnings.simplefilter("ignore")  # context 16 < receptive field 21
        want = jax_infer.main(args)
        got = infer.main(args + CPU)
    assert got["probs"]["ivt"].shape == (6, 100)
    _assert_bf16_close(got["probs"], want["probs"])


def test_quantized_random_init_runs(frame_dir):
    res = infer.main(["--video", frame_dir, "--random_init", "--quantize",
                      "--batch", "2", "--clip_len", "2"] + GEOM + CPU)
    for k, c in (("ivt", 100), ("i", 6), ("v", 10), ("t", 15)):
        p = res["probs"][k]
        assert p.shape == (6, c) and np.isfinite(p).all()
        assert ((p >= 0) & (p <= 1)).all()


def test_refusals(frame_dir, tmp_path):
    """As the JAX driver: a source of weights is required, and other
    inputs than a container or a directory are refused; beyond it, an
    MJPEG container (no libjpeg) and an empty directory. (``--servable``,
    refused until the parallel slice, serves: the tests below.)"""
    with pytest.raises(ValueError, match="random_init"):
        infer.main(["--video", frame_dir] + CPU + GEOM)
    mp4 = tmp_path / "x.mp4"
    mp4.write_bytes(b"\x00")
    for main in (jax_infer.main, infer.main):
        with pytest.raises(ValueError, match="container"):
            main(["--video", str(mp4), "--random_init"] + CPU)
    avi = tmp_path / "x.avi"
    avi.write_bytes(b"RIFF")
    with pytest.raises(RuntimeError, match="libjpeg"):
        infer.main(["--video", str(avi), "--random_init"] + CPU)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ValueError, match="no frames"):
        infer.main(["--video", str(empty), "--random_init"] + CPU)


def test_servable_offline_matches_jax(frame_dir, ckpt_dir, tmp_path):
    """``--servable``: the JAX package's ``cli.export`` of the offline
    checkpoint served by both drivers (the port ignores its StableHLO
    programs and rebuilds the session from its variables), within the
    bf16 bound; and the port's own ``cli.export`` of the same checkpoint
    serves exactly what ``--ckpt_dir`` serves."""
    shape = ["--batch", "1", "--clip_len", "4"] + GEOM
    jax_servable = str(tmp_path / "jax_servable")
    with shaped_templates():
        jax_export.main(["--ckpt_dir", ckpt_dir, "--modelname", "offline",
                         "--out", jax_servable] + shape)
        want = jax_infer.main(["--video", frame_dir, "--servable",
                               jax_servable] + GEOM)
    got = infer.main(["--video", frame_dir, "--servable", jax_servable]
                     + CPU)
    assert got["frames"] == want["frames"] == 6
    _assert_bf16_close(got["probs"], want["probs"])
    port_servable = str(tmp_path / "port_servable")
    export.main(["--ckpt_dir", ckpt_dir, "--modelname", "offline", "--out",
                 port_servable] + shape + CPU)
    served = infer.main(["--video", frame_dir, "--servable", port_servable]
                        + CPU)
    direct = infer.main(["--video", frame_dir, "--ckpt_dir", ckpt_dir,
                         "--modelname", "offline"] + shape + CPU)
    for k in direct["probs"]:
        np.testing.assert_array_equal(served["probs"][k], direct["probs"][k])


def test_servable_streaming_matches_jax(frame_dir, ckpt_dir, tmp_path):
    """``--servable --streaming``: the JAX streaming session's servable
    (its ring geometry from its meta.json, its TCN from the tree) pushed by
    both drivers, within the bf16 bound."""
    with warnings.catch_warnings(), shaped_templates():
        warnings.simplefilter("ignore")  # context 16 < receptive field 21
        sess = JaxStreamingSession.from_checkpoint(
            ckpt_dir, "stream", context=16, height=H, width=W, **TCN_SIZES)
        servable = sess.export(str(tmp_path / "stream_servable"))
        want = jax_infer.main(["--video", frame_dir, "--servable", servable,
                               "--streaming"] + GEOM)
    got = infer.main(["--video", frame_dir, "--servable", servable,
                      "--streaming"] + CPU)
    assert got["probs"]["ivt"].shape == (6, 100)
    _assert_bf16_close(got["probs"], want["probs"])


def test_runs_on_cuda_unless_told(frame_dir):
    """Without --device the sessions go to the card: on a machine without
    one that fails, and nothing falls back to the CPU."""
    with pytest.raises((RuntimeError, AssertionError)):
        infer.main(["--video", frame_dir, "--random_init", "--batch", "1",
                    "--clip_len", "4"] + GEOM)
