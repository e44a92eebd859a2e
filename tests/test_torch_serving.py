"""The port's serving sessions: against the JAX session, against the port's
own offline model, and the behaviours the JAX serving tests pin."""

import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from computervision_codes_tpu.models.pipeline import (
    EndToEndRecognizer as JaxRecognizer,
)
from computervision_codes_tpu.serving import InferenceSession as JaxSession
from computervision_codes_tpu.serving import (
    StreamingSession as JaxStreamingSession,
)
from computervision_codes_tpu_torch.models.convert import jax_variables
from computervision_codes_tpu_torch.models.pipeline import EndToEndRecognizer
from computervision_codes_tpu_torch.serving import (
    InferenceSession,
    StreamingSession,
    tcn_receptive_field,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(num_layers_pg=3, num_layers_r=2, num_refinements=2,
             num_f_maps=16)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch work on one thread: under the suite's parallel
    workers, torch's default of one thread per core oversubscribes the
    host, and tiny ops then wait on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def seeded_variables(seed: int, **kw):
    """The JAX variables of the port's recognizer made from ``seed`` (the
    flax init's distributions; an eager flax init of the recognizer takes
    longer than the JAX session's compiles)."""
    return jax_variables(EndToEndRecognizer(
        generator=torch.Generator().manual_seed(seed), **kw))


def test_inference_session_matches_jax_session(rng):
    """Same variables, same uint8 clip; both sessions normalise in float32
    and run the model in bf16. bf16 keeps 8 significant bits and the
    random-init logits reach |30|, so one rounding moves a probability near
    0.5 by up to ~0.06 (the JAX bf16 session was 0.056 from its float32
    model on a JAX init). Bound: max 0.1 with correlation > 0.999, the bf16
    cross-check bound of the JAX package's own serving tests."""
    variables = seeded_variables(0)
    jsess = JaxSession.create(batch=1, clip_len=4, height=32, width=56,
                              variables=variables)
    sess = InferenceSession.create(batch=1, clip_len=4, height=32, width=56,
                                   variables=variables, device="cpu")
    clips = rng.integers(0, 256, (1, 4, 32, 56, 3)).astype(np.uint8)
    want = jsess.predict(clips.copy())
    got = sess.predict(clips)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        assert np.corrcoef(got[k].ravel(), want[k].ravel())[0, 1] > 0.999
        assert np.abs(got[k] - want[k]).max() < 0.1, k


def _calibration(rng, shape):
    """Normalised uniform-pixel frames, the same array for both packages."""
    from computervision_codes_tpu_torch.data.transforms import (
        IMAGENET_MEAN,
        IMAGENET_STD,
    )

    pix = rng.uniform(0.0, 255.0, shape).astype(np.float32)
    return ((pix / 255.0 - np.asarray(IMAGENET_MEAN, np.float32))
            / np.asarray(IMAGENET_STD, np.float32)).astype(np.float32)


def _assert_bf16_close(got, want):
    """The bf16 cross-check bound of the test above."""
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        assert np.corrcoef(got[k].ravel(), want[k].ravel())[0, 1] > 0.999, k
        assert np.abs(got[k] - want[k]).max() < 0.1, k


def test_inference_session_quantized_matches_jax(rng):
    """quantize=True with fused_stem (the deployed config), same float
    variables and the same explicit calibration clips in both packages;
    the int8 backbone and the bf16 TCN under the bf16 bound."""
    h, w = 32, 56
    variables = seeded_variables(1)
    cal = _calibration(rng, (1, 8, h, w, 3))
    kw = dict(batch=1, clip_len=4, height=h, width=w, quantize=True,
              fused_stem=True)
    jsess = JaxSession.create(variables=variables,
                              calibrate_clips=jnp.asarray(cal), **kw)
    sess = InferenceSession.create(variables=variables, calibrate_clips=cal,
                                   device="cpu", **kw)
    backbone = sess.model.backbone
    assert "w" in backbone.conv1.qw and backbone.fused_stem
    assert float(backbone.layer1_0.conv1.act_scale) == pytest.approx(
        float(jsess.variables["q_backbone"]["layer1_0"]["conv1"]
              ["act_scale"]), rel=1e-5)
    clips = rng.integers(0, 256, (1, 4, h, w, 3)).astype(np.uint8)
    _assert_bf16_close(sess.predict(clips), jsess.predict(clips.copy()))


def test_streaming_quantized_matches_jax(rng):
    """StreamingSession(quantize=True, fused_stem=True) against the JAX
    session: same causal variables, same calibration frames, every push
    under the bf16 bound."""
    h, w = 32, 56
    tcn = dict(num_layers_pg=2, num_layers_r=2, num_refinements=1,
               num_f_maps=8)
    # the JAX init, jitted (eager takes three times as long)
    variables = jax.jit(JaxRecognizer(causal=True, dtype=jnp.bfloat16,
                                      **tcn).init)(
        jax.random.PRNGKey(5), jnp.zeros((1, 4, h, w, 3), jnp.bfloat16))
    cal = _calibration(rng, (4, h, w, 3))
    kw = dict(context=8, height=h, width=w, quantize=True, fused_stem=True,
              **tcn)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # context 8 < receptive field 13
        jsess = JaxStreamingSession.create(
            variables=variables, calibrate_frames=jnp.asarray(cal), **kw)
        sess = StreamingSession.create(variables=variables,
                                       calibrate_frames=cal, device="cpu",
                                       **kw)
    for _ in range(3):
        frame = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        got = sess.push(frame)
        assert got["ivt"].shape == (100,)
        _assert_bf16_close(got, jsess.push(frame.copy()))


def test_quantized_default_calibration(rng):
    """Without calibration data both sessions calibrate on uniform pixels
    through the ImageNet normalisation, and serve valid probabilities."""
    sess = InferenceSession.create(batch=1, clip_len=2, height=32, width=56,
                                   quantize=True, device="cpu")
    assert sess.model.backbone.layer4_1.conv2.act_scale is not None
    probs = sess.predict(rng.integers(0, 256, (1, 2, 32, 56, 3)).astype(
        np.uint8))
    for v in probs.values():
        assert np.isfinite(v).all() and (v >= 0).all() and (v <= 1).all()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        stream = StreamingSession.create(
            context=8, height=32, width=56, quantize=True, device="cpu",
            num_layers_pg=2, num_layers_r=2, num_refinements=1, num_f_maps=8)
    probs = stream.push(rng.integers(0, 256, (32, 56, 3)).astype(np.uint8))
    assert probs["ivt"].shape == (100,)
    assert np.isfinite(probs["ivt"]).all()


def test_streaming_quantized_bottleneck(rng):
    """quantize=True with a Bottleneck network calibrates with its own
    block (the JAX session calibrates as BasicBlock there, and fails), so
    every int8 conv, conv3 included, gets a static scale."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        stream = StreamingSession.create(
            context=8, height=32, width=32, network="resnet50",
            quantize=True, device="cpu", num_layers_pg=2, num_layers_r=2,
            num_refinements=1, num_f_maps=8)
    backbone = stream.model.backbone
    assert backbone.block == "bottleneck"
    assert all(getattr(backbone, f"layer{s}_0").conv3.act_scale is not None
               for s in (1, 2, 3, 4))
    probs = stream.push(rng.integers(0, 256, (32, 32, 3)).astype(np.uint8))
    assert probs["ivt"].shape == (100,) and np.isfinite(probs["ivt"]).all()


def _small_session():
    return InferenceSession.create(batch=1, clip_len=2, height=32, width=56,
                                   device="cpu")


def test_shape_guard_and_float_input(rng):
    sess = _small_session()
    with pytest.raises(ValueError, match="shape"):
        sess.predict(np.zeros((1, 4, 32, 56, 3), np.uint8))
    norm = rng.standard_normal((1, 2, 32, 56, 3)).astype(np.float32)
    probs = sess.predict(norm)
    for v in probs.values():
        assert np.isfinite(v).all() and (v >= 0).all() and (v <= 1).all()


def test_serving_normalizes_dark_uint8_frames():
    """Near-black uint8 clips are still normalised: the dtype decides, not
    the magnitude (the port's counterpart of tests/test_serving.py:28)."""
    sess = _small_session()
    p_dark = sess.predict(np.zeros((1, 2, 32, 56, 3), np.uint8))["ivt"]
    p_bright = sess.predict(np.full((1, 2, 32, 56, 3), 255, np.uint8))["ivt"]
    assert np.isfinite(p_dark).all()
    assert not np.allclose(p_dark, p_bright)
    # a float clip of zeros is taken as normalised, i.e. the mean pixel,
    # which differs from a normalised black frame
    p_zero = sess.predict(np.zeros((1, 2, 32, 56, 3), np.float32))["ivt"]
    assert not np.allclose(p_dark, p_zero)


def test_streaming_matches_offline_causal(rng):
    """Push output at step t equals the offline causal model (same seeded
    weights) at position t once t reaches the receptive field (float32,
    atol 1e-5 as the JAX test)."""
    ctx, h, w = 32, 32, 56
    model = EndToEndRecognizer(causal=True, dtype=torch.float32,
                               generator=torch.Generator().manual_seed(0),
                               **SMALL).eval()
    clips = rng.standard_normal((1, ctx, h, w, 3)).astype(np.float32)
    with torch.no_grad():
        offline = torch.sigmoid(model(torch.from_numpy(clips))["ivt"]).numpy()
    sess = StreamingSession.create(context=ctx, height=h, width=w,
                                   dtype=torch.float32, device="cpu",
                                   **SMALL)
    rf = tcn_receptive_field(3, 2, 2) - 1  # 26 frames of history
    for t in range(ctx):
        probs = sess.push(clips[0, t])
        assert probs["ivt"].shape == (100,)
        if t >= rf:
            np.testing.assert_allclose(probs["ivt"], offline[0, t],
                                       atol=1e-5, err_msg=f"step {t}")
    assert sess.frames_seen == ctx
    sess.reset()
    assert sess.frames_seen == 0
    assert float(sess.buffer.abs().max()) == 0.0


def test_multi_stream_independence_and_reset(rng):
    """streams=2 equals two single-stream sessions fed the same frames;
    reset(stream) clears only that stream's buffer and counter."""
    kw = dict(context=8, height=32, width=56, dtype=torch.float32,
              device="cpu", num_layers_pg=2, num_layers_r=2,
              num_refinements=1, num_f_maps=8)
    frames = rng.standard_normal((4, 2, 32, 56, 3)).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # context 8 < receptive field 13
        multi = StreamingSession.create(streams=2, **kw)
        singles = [StreamingSession.create(**kw) for _ in range(2)]
    for t in range(4):
        pm = multi.push(frames[t])
        assert pm["ivt"].shape == (2, 100)
        for s in range(2):
            np.testing.assert_allclose(pm["ivt"][s],
                                       singles[s].push(frames[t, s])["ivt"],
                                       atol=1e-5)
    with pytest.raises(ValueError, match="shape"):
        multi.push(frames[0, 0])
    multi.reset(stream=0)
    assert float(multi.buffer[0].abs().max()) == 0.0
    assert float(multi.buffer[1].abs().max()) > 0.0
    assert list(multi.frames_seen_per_stream) == [0, 4]


def test_receptive_field_and_context_warning():
    assert tcn_receptive_field(11, 10, 3) == 10233
    assert tcn_receptive_field(3, 2, 2) == 27
    kw = dict(height=32, width=56, dtype=torch.float32, device="cpu",
              num_layers_pg=2, num_layers_r=2, num_refinements=1,
              num_f_maps=8)  # receptive field 1 + 6 + 6 = 13
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sess = StreamingSession.create(context=8, **kw)
    assert any("receptive field" in str(w.message) for w in caught)
    assert sess.receptive_field == 13
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        StreamingSession.create(context=16, **kw)
    assert not any("receptive field" in str(w.message) for w in caught)


def test_port_imports_no_jax():
    """The GPU machine has no JAX, flax or msgpack: no module of the port
    may import them, nor the JAX package (whose data/__init__ imports
    JAX). Every module of the package is imported, found by walking it."""
    code = ("import pkgutil, sys, importlib; "
            "import computervision_codes_tpu_torch as pkg; "
            "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
            "pkg.__name__ + '.')]; "
            "assert len(names) >= 50, names; "
            "[importlib.import_module(n) for n in names]; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'msgpack', "
            "'computervision_codes_tpu')]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
