"""The port's TeacherSession against the JAX package's.

Both sessions serve ``Q2L(swin_nano_64)`` in bf16 at batch 2, 64x64, from
the same variables, and a TResNet teacher: a small TResNet (width 16,
layers (1, 2, 2, 1)) put into both packages' ``VARIANTS``, its BatchNorm
drawn at random (``test_torch_tresnet``), in bf16 and with
``quantize=True`` (a float TResNet under int8 Dense layers, as the JAX
session serves it). The variables are the port's seeded modules' in the
JAX layout (``jax_variables``): a JAX session made without variables runs
an eager flax init that takes longer than its two compiles. Building a
JAX session compiles two executables, so each pair is built once per
module. Bound: the bf16 cross-check bound of tests/test_torch_serving.py
for probabilities (max 0.1, correlation > 0.999) and, for the feature, 4%
of its largest magnitude with correlation > 0.999.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_tresnet import SMALL, randomize_bn

from computervision_codes_tpu.models import tresnet as jax_tresnet
from computervision_codes_tpu.serving import TeacherSession as JaxTeacher
from computervision_codes_tpu_torch.models import tresnet
from computervision_codes_tpu_torch.models.convert import jax_variables
from computervision_codes_tpu_torch.models.q2l import Q2L
from computervision_codes_tpu_torch.models.quant_dense import Int8Dense
from computervision_codes_tpu_torch.serving import TeacherSession

KW = dict(batch=2, img_size=64, backbone="swin_nano_64")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch work on one thread: under the suite's parallel
    workers, torch's default of one thread per core oversubscribes the
    host, and tiny ops then wait on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=["i", "all"])
def sessions(request):
    variables = jax_variables(Q2L(
        backbone=KW["backbone"], loss_type=request.param,
        generator=torch.Generator().manual_seed(0)))
    jsess = JaxTeacher.create(loss_type=request.param, variables=variables,
                              **KW)
    sess = TeacherSession.create(loss_type=request.param,
                                 variables=variables, device="cpu", **KW)
    return jsess, sess


def _assert_close(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k], want[k]
        assert g.shape == w.shape and g.dtype == np.float32, k
        assert np.corrcoef(g.ravel(), w.ravel())[0, 1] > 0.999, k
        bound = 0.04 * np.abs(w).max() if k == "feature" else 0.1
        assert np.abs(g - w).max() < bound, k


def test_uint8_frames_match_jax(sessions):
    jsess, sess = sessions
    frames = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3),
                                               dtype=np.uint8)
    got = sess.predict(frames)
    assert set(got) == set(jsess.tasks) | {"feature"}
    assert got["feature"].shape == (2, 256)
    _assert_close(got, jsess.predict(frames.copy()))


def test_float_frames_match_jax(sessions):
    """Float frames are taken as normalised (not divided by 255)."""
    jsess, sess = sessions
    frames = np.random.default_rng(1).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)
    got = sess.predict(frames)
    _assert_close(got, jsess.predict(frames.copy()))
    dark = sess.predict(np.zeros((2, 64, 64, 3), np.uint8))
    zero = sess.predict(np.zeros((2, 64, 64, 3), np.float32))
    assert not np.allclose(dark["feature"], zero["feature"])


def test_shape_guard_and_quantize(sessions):
    _, sess = sessions
    with pytest.raises(ValueError, match="shape"):
        sess.predict(np.zeros((1, 64, 64, 3), np.uint8))
    with pytest.raises(ValueError, match="shape"):
        sess.predict(np.zeros((2, 32, 64, 3), np.float32))
    # the int8 teacher builds, and guards its shape alike
    # (tests/test_torch_int8_teacher.py holds it against the JAX session)
    q8 = TeacherSession.create(quantize=True, device="cpu", **KW)
    assert q8.model.backbone.s2d_embed
    with pytest.raises(ValueError, match="shape"):
        q8.predict(np.zeros((1, 64, 64, 3), np.uint8))


TRESNET_KW = dict(batch=2, img_size=64, backbone="tresnet_small")


@pytest.fixture(scope="module")
def small_tresnet():
    """``tresnet_small`` in both packages' VARIANTS for the module, and its
    Q2L teacher's variables, BatchNorm drawn at random."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_tresnet.VARIANTS, "tresnet_small", SMALL)
        mp.setitem(tresnet.VARIANTS, "tresnet_small", SMALL)
        yield randomize_bn(jax_variables(Q2L(
            backbone="tresnet_small", loss_type="i",
            generator=torch.Generator().manual_seed(0))), seed=2)


@pytest.fixture(scope="module")
def tresnet_sessions(small_tresnet):
    kw = dict(variables=small_tresnet, **TRESNET_KW)
    return (JaxTeacher.create(**kw),
            TeacherSession.create(device="cpu", **kw))


def test_tresnet_uint8_frames_match_jax(tresnet_sessions):
    jsess, sess = tresnet_sessions
    frames = np.random.default_rng(2).integers(0, 256, (2, 64, 64, 3),
                                               dtype=np.uint8)
    got = sess.predict(frames)
    assert got["feature"].shape == (2, 512)
    _assert_close(got, jsess.predict(frames.copy()))


def test_tresnet_float_frames_match_jax(tresnet_sessions):
    jsess, sess = tresnet_sessions
    frames = np.random.default_rng(3).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)
    _assert_close(sess.predict(frames), jsess.predict(frames.copy()))


def test_tresnet_int8_teacher_is_refused(small_tresnet):
    """``quantize=True`` on a TResNet, refused until the JAX session's
    path was ported: a float TResNet (K9 on the card) under the int8 Dense
    layers of at least 512 inputs, on the same variables and calibration
    frames as the JAX session."""
    cal = np.random.default_rng(4).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)
    kw = dict(variables=small_tresnet, quantize=True, **TRESNET_KW)
    jsess = JaxTeacher.create(calibrate_frames=jnp.asarray(cal), **kw)
    sess = TeacherSession.create(calibrate_frames=cal, device="cpu", **kw)
    swapped = {k for k, m in sess.model.named_modules()
               if isinstance(m, Int8Dense)}
    assert swapped == {"input_proj_i", "transformer.encoder0.linear2",
                       "transformer.decoder0.linear2",
                       "transformer.decoder1.linear2"} | {
        f"transformer.{layer}.{attn}.{proj}"
        for layer, attn in (("encoder0", "self_attn"),
                            ("decoder0", "cross_attn"),
                            ("decoder1", "cross_attn"))
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj")} | {
        f"transformer.{layer}.linear1"
        for layer in ("encoder0", "decoder0", "decoder1")}
    assert isinstance(sess.model.backbone, tresnet.TResNet)
    frames = np.random.default_rng(5).integers(0, 256, (2, 64, 64, 3),
                                               dtype=np.uint8)
    _assert_close(sess.predict(frames), jsess.predict(frames.copy()))
