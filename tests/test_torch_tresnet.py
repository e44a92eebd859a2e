"""The port's TResNet and Q2L(TResNet) against the JAX package's.

At the width and depths of tests/test_tresnet_parity.py (width 16, layers
(1, 2, 2, 1)), JAX variables carried across with ``load_jax_variables``,
the BatchNorm statistics and affine drawn at random (the JAX init's zero
gamma on each block's last ABN would hide the residual branches), the same
seeded numpy frames through both. The JAX ABN runs its Pallas kernel
interpreted. float32: every stage and the pooled vector within 1e-5 of the
largest magnitude (sums in another order); at 60x60 the stem map is 15x15,
so the stride-2 shortcut's SAME average pool pads and excludes the pad.
bf16: 4% of the largest magnitude with correlation > 0.999 (the packages
round at different points, as tests/test_torch_swin.py states).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervision_codes_tpu.models import tresnet as jax_tresnet
from computervision_codes_tpu.models.q2l import Q2L as JaxQ2L
from computervision_codes_tpu_torch.models import tresnet
from computervision_codes_tpu_torch.models.convert import load_jax_variables
from computervision_codes_tpu_torch.models.q2l import Q2L

SMALL = dict(width=16, layers=(1, 2, 2, 1))
REL = 1e-5
BF16_REL, BF16_CORR = 0.04, 0.999


def randomize_bn(variables, seed: int = 0):
    """A numpy copy of a flax variable tree with every BatchNorm's scale,
    bias, mean and var drawn from a seed."""
    rng = np.random.default_rng(seed)
    draw = {"scale": lambda n: rng.uniform(0.5, 1.5, n),
            "bias": lambda n: rng.normal(0.0, 0.1, n),
            "mean": lambda n: rng.normal(0.0, 0.1, n),
            "var": lambda n: rng.uniform(0.5, 1.5, n)}

    def walk(tree, in_bn):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = walk(v, k == "bn")
            elif in_bn and k in draw:
                out[k] = draw[k](np.shape(v)).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    return walk(variables, False)


@pytest.fixture(scope="module")
def variables():
    """The small TResNet's variables (their shapes do not depend on the
    frame size), BatchNorm drawn at random."""
    return randomize_bn(jax.jit(jax_tresnet.TResNet(**SMALL).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))


def _pair(variables, hw, dtype=jnp.float32):
    frames = np.random.default_rng(0).standard_normal(
        (2, hw, hw, 3)).astype(np.float32)
    want = jax.jit(jax_tresnet.TResNet(dtype=dtype, **SMALL).apply)(
        variables, jnp.asarray(frames, dtype))
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    model = load_jax_variables(tresnet.TResNet(dtype=tdtype, **SMALL),
                               variables).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(frames).to(tdtype))
    return got, want


def test_variants_and_launch_count():
    assert tresnet.VARIANTS == jax_tresnet.VARIANTS
    assert tresnet.feature_dim("tresnet_l") == 2432
    # every activated ABN is one K9 launch: 52 per TResNet-L forward (stem
    # 1, nine basic blocks 1 each, 21 bottlenecks 2 each); the count
    # follows the depths, so a narrow model at TResNet-L's depths shows it
    model = tresnet.TResNet(width=4, layers=tresnet.VARIANTS["tresnet_l"][
        "layers"])
    acts = [m for m in model.modules() if isinstance(m, tresnet.ABN)
            and m.act]
    assert len(acts) == 52
    assert model.stem_abn.slope == 1e-2
    assert {m.slope for m in acts} - {1e-2} == {1e-3}


@pytest.mark.parametrize("hw", [64, 60])
def test_small_float32_matches_jax(variables, hw):
    got, want = _pair(variables, hw)
    assert len(got["stages"]) == 4
    for i, (g, w) in enumerate(zip(got["stages"], want["stages"])):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, i
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=REL * np.abs(w).max(), err_msg=i)
    w = np.asarray(want["pooled"])
    np.testing.assert_allclose(got["pooled"].numpy(), w, rtol=0,
                               atol=REL * np.abs(w).max())


def test_small_bf16_matches_jax(variables):
    got, want = _pair(variables, 64, jnp.bfloat16)
    for g, w in ((got["stages"][-1], want["stages"][-1]),
                 (got["pooled"], want["pooled"])):
        assert g.dtype == torch.bfloat16
        g = g.float().numpy().ravel()
        w = np.asarray(w, np.float32).ravel()
        assert np.abs(g - w).max() <= BF16_REL * np.abs(w).max()
        assert np.corrcoef(g, w)[0, 1] > BF16_CORR


def test_q2l_tresnet_matches_jax(monkeypatch):
    """Q2L over a small TResNet registered in both packages' VARIANTS:
    d_model = width * 8 * 4 = 512, the logits and the feature."""
    monkeypatch.setitem(jax_tresnet.VARIANTS, "tresnet_small", SMALL)
    monkeypatch.setitem(tresnet.VARIANTS, "tresnet_small", SMALL)
    frames = np.random.default_rng(1).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)
    jmodel = JaxQ2L(backbone="tresnet_small", loss_type="i")
    variables = randomize_bn(jax.jit(jmodel.init)(
        jax.random.PRNGKey(2), jnp.asarray(frames)), seed=1)
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(frames))
    model = Q2L(backbone="tresnet_small", loss_type="i")
    assert model.dim == 512
    load_jax_variables(model, variables)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(frames))
    for g, w in ((got["logits"]["i"], want["logits"]["i"]),
                 (got["feature"], want["feature"])):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=REL * max(1.0, np.abs(w).max()))


def test_training_mode_abn_raises():
    model = tresnet.TResNet(**SMALL)
    with pytest.raises(NotImplementedError, match="training"):
        model(torch.zeros(1, 64, 64, 3))
