"""The port's int8 teacher against the JAX package's.

* ``s2d_embed``: the patch embedding as the GEMM over the space-to-depth
  view, float32, against the JAX module's at atol 5e-5
  (tests/test_ops_kernels.py:385).
* The whole int8 ``Q2L(swin_nano_64, "i")`` with ``quant_eval``,
  ``s2d_embed`` and ``quant_min_dim=0`` (every block's kernels take their
  int8 branch: K5 at stages 0-2, K4 at stage 3), and its Swin backbone
  alone with ``fused_split`` (K3 then K4; the JAX ``Q2L`` has no
  ``fused_split``, its ``SwinTransformer`` has), each package calibrating
  its own Dense scales and swapping every Dense (``min_features=0``),
  float32, on two frames: the concatenated outputs with correlation
  > 0.999 and within 5% of the largest magnitude. Each package quantizes activations that its
  own float32 sums made, so an int8 code can differ by one in any layer
  and the change cascades through ten int8 layers (the correlation bound
  of the int8 student's cross-checks, tests/test_torch_quantized.py).
* ``TeacherSession(quantize=True)`` against the JAX session on the same
  variables and calibration frames, for plumbing, keys and dtypes, under
  the bf16 bounds of tests/test_torch_teacher.py. At nano width the Swin
  blocks stay float (dims below 768) and only the last patch merge and
  the decoder FFNs' ``linear2`` reach 512 inputs, and on the CPU the JAX
  session takes its XLA path: this checks the session's wiring and its
  int8 Dense layers, not the kernels' int8 branches (those are held to
  the JAX kernels by tests/test_torch_int8_kernels.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervision_codes_tpu.models import quant_dense as jqd
from computervision_codes_tpu.models.q2l import Q2L as JaxQ2L
from computervision_codes_tpu.models.swin import SwinTransformer as JaxSwin
from computervision_codes_tpu.models.swin import VARIANTS
from computervision_codes_tpu.serving import TeacherSession as JaxTeacher
from computervision_codes_tpu_torch.models import quant_dense as pqd
from computervision_codes_tpu_torch.models.convert import load_jax_variables
from computervision_codes_tpu_torch.models.q2l import Q2L
from computervision_codes_tpu_torch.models.swin import SwinTransformer
from computervision_codes_tpu_torch.serving import TeacherSession

KW = dict(backbone="swin_nano_64", loss_type="i")
INT8_FLAGS = dict(quant_eval=True, s2d_embed=True, quant_min_dim=0)
MODEL_CORR, MODEL_REL = 0.999, 0.05


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
def setup():
    rng = np.random.default_rng(11)
    frames = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    cal = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    variables = jax.jit(JaxQ2L(**KW).init)(jax.random.PRNGKey(4),
                                           jnp.asarray(frames))
    return frames, cal, variables


def test_s2d_embed_matches_jax(rng):
    cfg = VARIANTS["swin_nano_64"]
    frames = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    variables = jax.jit(JaxSwin(fused_eval=False, **cfg).init)(
        jax.random.PRNGKey(1), jnp.asarray(frames))
    want = jax.jit(JaxSwin(fused_eval=False, s2d_embed=True, **cfg).apply)(
        variables, jnp.asarray(frames))
    model = load_jax_variables(
        SwinTransformer(fused_eval=False, s2d_embed=True, **cfg),
        variables).eval()
    with torch.no_grad():
        x = torch.from_numpy(frames)
        got = model(x)
        conv = model.patch_norm(model.patch_embed(x))
        s2d = model.embed(x)
    np.testing.assert_allclose(got["pooled"].numpy(),
                               np.asarray(want["pooled"]), atol=5e-5)
    np.testing.assert_allclose(s2d.numpy(), conv.numpy(), atol=5e-5)


def _outputs(out, numpy_of):
    keys = ("pooled", "feature_map") if "pooled" in out else ("feature",)
    parts = [out["logits"]["i"]] if "logits" in out else []
    return np.concatenate([numpy_of(a).ravel()
                           for a in parts + [out[k] for k in keys]])


@pytest.mark.parametrize("fused_split", [False, True],
                         ids=["q2l-merged", "backbone-split"])
def test_int8_nano_q2l_matches_jax(setup, fused_split):
    frames, cal, variables = setup
    if fused_split:  # the backbone alone: the JAX Q2L has no fused_split
        cfg = dict(VARIANTS[KW["backbone"]], fused_split=True, **INT8_FLAGS)
        jm = JaxSwin(fused_eval=True, **cfg)
        variables = {"params": variables["params"]["backbone"]}
        model = load_jax_variables(SwinTransformer(**cfg), variables).eval()
        bb = model
    else:
        jm = JaxQ2L(fused_eval=True, **INT8_FLAGS, **KW)
        model = load_jax_variables(Q2L(**INT8_FLAGS, **KW), variables).eval()
        bb = model.backbone
    scales = jqd.collect_dense_scales(jm, variables, jnp.asarray(cal))
    qd = jqd.quantize_dense_params(variables)
    want = jax.jit(lambda v, x: jqd.int8_apply(jm, v, qd, scales, x))(
        variables, jnp.asarray(frames))
    assert [bb.stage0_block0.plan(16, 16), bb.stage3_block0.plan(2, 2)] == \
        ["split" if fused_split else "merged", "mlp"]
    assert all(getattr(bb, f"stage{s}_block0").quant for s in range(4))
    with torch.no_grad():
        x = torch.from_numpy(frames)
        float_out = model(x)
        got_scales = pqd.collect_dense_scales(model, torch.from_numpy(cal))
        assert set(got_scales) == set(scales)
        pqd.apply_int8_dense(model, pqd.quantize_dense_params(model),
                             got_scales)
        got = model(x)
    g = _outputs(got, lambda t: t.numpy())
    w = _outputs(want, np.asarray)
    assert np.corrcoef(g, w)[0, 1] > MODEL_CORR
    err = np.abs(g - w).max()
    assert err <= MODEL_REL * np.abs(w).max(), (err, np.abs(w).max())
    # the int8 path is taken: PTQ noise against the port's float model
    assert np.abs(g - _outputs(float_out, lambda t: t.numpy())).max() > 1e-3


def test_int8_session_matches_jax(setup):
    _, cal, variables = setup
    kw = dict(batch=2, img_size=64, quantize=True, **KW)
    jsess = JaxTeacher.create(variables=variables,
                              calibrate_frames=jnp.asarray(cal), **kw)
    sess = TeacherSession.create(variables=variables, calibrate_frames=cal,
                                 device="cpu", **kw)
    swapped = {k for k, m in sess.model.named_modules()
               if isinstance(m, pqd.Int8Dense)}
    assert swapped == {"backbone.merge2.reduction",
                       "transformer.encoder0.linear2",
                       "transformer.decoder0.linear2",
                       "transformer.decoder1.linear2"}
    assert sess.model.backbone.s2d_embed
    frames = np.random.default_rng(12).integers(0, 256, (2, 64, 64, 3),
                                                dtype=np.uint8)
    got, want = sess.predict(frames), jsess.predict(frames.copy())
    assert set(got) == set(want) == {"i", "feature"}
    for k in want:
        g, w = got[k], want[k]
        assert g.shape == w.shape and g.dtype == np.float32, k
        assert np.corrcoef(g.ravel(), w.ravel())[0, 1] > 0.999, k
        bound = 0.04 * np.abs(w).max() if k == "feature" else 0.1
        assert np.abs(g - w).max() < bound, k
