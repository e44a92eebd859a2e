"""The port's Query2Label teacher against the JAX package's.

``Q2L(swin_nano_64)`` for loss types "i" and "all" and ``Q2L(resnet18)``
(FrozenBatchNorm), JAX variables carried across with
``load_jax_variables``, the same seeded numpy frames through both. float32:
every task's logits and the feature at atol 5e-5
(tests/test_ops_kernels.py:385); bf16: 4% of the largest magnitude with
correlation > 0.999 (the packages round at different points).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervision_codes_tpu.models.q2l import Q2L as JaxQ2L
from computervision_codes_tpu_torch.models.convert import (jax_variables,
                                                          load_jax_variables)
from computervision_codes_tpu_torch.models.position_encoding import (
    sine_position_embedding,
)
from computervision_codes_tpu_torch.models.q2l import Q2L

ATOL = 5e-5
BF16_REL, BF16_CORR = 0.04, 0.999


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch work on one thread: under the suite's parallel
    workers, torch's default of one thread per core oversubscribes the
    host, and tiny ops then wait on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(backbone, loss_type, frames, dtype=jnp.float32):
    jmodel = JaxQ2L(backbone=backbone, loss_type=loss_type, fused_eval=False,
                    dtype=dtype)
    # the port's seeded module's variables (an eager flax init of Q2L
    # takes longer than the forwards)
    variables = jax_variables(Q2L(backbone=backbone, loss_type=loss_type,
                                  generator=torch.Generator().manual_seed(2)))
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(frames, dtype))
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    model = Q2L(backbone=backbone, loss_type=loss_type, dtype=tdtype)
    load_jax_variables(model, variables)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(frames).to(tdtype))
    return got, want


def _outputs(out, numpy_of):
    res = {f"logits_{k}": numpy_of(v) for k, v in out["logits"].items()}
    res["feature"] = numpy_of(out["feature"])
    return res


@pytest.mark.parametrize("backbone, loss_type", [
    ("swin_nano_64", "i"), ("swin_nano_64", "all"), ("resnet18", "i")])
def test_float32_matches_jax(rng, backbone, loss_type):
    frames = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    got, want = _pair(backbone, loss_type, frames)
    g = _outputs(got, lambda t: t.numpy())
    w = _outputs(want, np.asarray)
    assert set(g) == set(w)
    for k in w:
        assert g[k].shape == w[k].shape, k
        np.testing.assert_allclose(g[k], w[k], atol=ATOL, err_msg=k)
    assert set(got["task_features"]) == set(want["task_features"])


@pytest.mark.parametrize("loss_type", ["i", "all"])
def test_bf16_matches_jax(rng, loss_type):
    frames = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    got, want = _pair("swin_nano_64", loss_type, frames, jnp.bfloat16)
    g = _outputs(got, lambda t: t.float().numpy())
    w = _outputs(want, lambda a: np.asarray(a, np.float32))
    served = [k for k in w if np.abs(w[k]).max() > 0]  # unserved: zeros
    for k in w:
        if k not in served:
            assert np.abs(g[k]).max() == 0, k
            continue
        err = np.abs(g[k] - w[k]).max()
        assert err <= BF16_REL * np.abs(w[k]).max(), (k, err)
        assert np.corrcoef(g[k].ravel(), w[k].ravel())[0, 1] > BF16_CORR, k


def test_position_embedding_matches_jax():
    from computervision_codes_tpu.models.position_encoding import (
        sine_position_embedding as jax_sine,
    )

    for h, w, f in ((12, 12, 768), (2, 3, 16)):
        np.testing.assert_array_equal(sine_position_embedding(h, w, f),
                                      jax_sine(h, w, f))


def test_unported_parts_raise():
    # the CvT backbones build (their parity: tests/test_torch_cvt.py); a
    # CvT name outside VARIANTS is unknown
    assert Q2L(backbone="cvt_nano").dim == 64
    with pytest.raises(ValueError, match="unknown backbone"):
        Q2L(backbone="cvt_21_384_22k")
    with pytest.raises(ValueError, match="unknown backbone"):
        Q2L(backbone="vgg16")
    # the int8 teacher's options build: int8 branches from quant_min_dim on
    q8 = Q2L(backbone="swin_nano_64", quant_eval=True, quant_min_dim=128,
             s2d_embed=True)
    assert [q8.backbone.stage1_block0.quant, q8.backbone.stage2_block0.quant,
            q8.backbone.s2d_embed] == [False, True, True]
    # the KD call runs (its parity: tests/test_torch_kd_modules.py); a
    # model made without a teacher_dim has no KD block and refuses it
    model = Q2L(backbone="swin_nano_64", loss_type="all",
                teacher_dim=512).eval()
    feat = torch.zeros(1, 512)
    with torch.no_grad():
        out = model(torch.zeros(1, 64, 64, 3), feat_i=feat, feat_v=feat,
                    feat_t=feat)
    assert {k: tuple(v.shape) for k, v in out["kd"].items()} == {
        k: (1, 512) for k in ("i", "v", "t")}
    with pytest.raises(ValueError, match="KD block"):
        Q2L(backbone="swin_nano_64", loss_type="all")(
            torch.zeros(1, 64, 64, 3), feat_i=feat, feat_v=feat, feat_t=feat)
