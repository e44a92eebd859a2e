"""The port's TeacherSession against the JAX package's.

Both sessions serve ``Q2L(swin_nano_64)`` in bf16 at batch 2, 64x64, from
the same variables (the JAX session's, carried across by
``load_jax_variables``), and a TResNet teacher: a small TResNet (width 16,
layers (1, 2, 2, 1)) put into both packages' ``VARIANTS``, from the JAX
init with its BatchNorm drawn at random (``test_torch_tresnet``). Building
a JAX session compiles two executables (tens of seconds), so each pair is
built once per module. Bound: the bf16 cross-check bound of
tests/test_torch_serving.py for probabilities (max 0.1, correlation >
0.999) and, for the feature, 4% of its largest magnitude with correlation
> 0.999.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_tresnet import SMALL, randomize_bn

from computervision_codes_tpu.models import tresnet as jax_tresnet
from computervision_codes_tpu.models.q2l import Q2L as JaxQ2L
from computervision_codes_tpu.serving import TeacherSession as JaxTeacher
from computervision_codes_tpu_torch.models import tresnet
from computervision_codes_tpu_torch.serving import TeacherSession

KW = dict(batch=2, img_size=64, backbone="swin_nano_64")


@pytest.fixture(scope="module", params=["i", "all"])
def sessions(request):
    jsess = JaxTeacher.create(loss_type=request.param, **KW)
    sess = TeacherSession.create(loss_type=request.param,
                                 variables=jsess.variables, device="cpu",
                                 **KW)
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


@pytest.fixture(scope="module")
def tresnet_sessions():
    kw = dict(batch=2, img_size=64, backbone="tresnet_small")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_tresnet.VARIANTS, "tresnet_small", SMALL)
        mp.setitem(tresnet.VARIANTS, "tresnet_small", SMALL)
        init = jax.jit(JaxQ2L(backbone="tresnet_small", loss_type="i",
                              dtype=jnp.bfloat16).init)
        variables = randomize_bn(init(jax.random.PRNGKey(0), jnp.zeros(
            (1, 64, 64, 3), jnp.bfloat16)), seed=2)
        jsess = JaxTeacher.create(variables=variables, **kw)
        sess = TeacherSession.create(variables=variables, device="cpu", **kw)
    return jsess, sess


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


def test_tresnet_int8_teacher_is_refused():
    with pytest.raises(NotImplementedError, match="int8 TResNet"):
        TeacherSession.create(backbone="tresnet_m", quantize=True,
                              device="cpu")
