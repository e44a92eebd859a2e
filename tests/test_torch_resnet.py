"""The port's ResNet against the JAX package's, same weights, float32.

JAX variables are initialised, their BN statistics (or frozen vectors) are
randomised with numpy so the check is not trivially mean 0 / var 1, and
``load_jax_variables`` carries them into the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervision_codes_tpu.models.resnet import (
    Bottleneck as JaxBottleneck,
    build_resnet as jax_build_resnet,
)
from computervision_codes_tpu_torch.models.convert import load_jax_variables
from computervision_codes_tpu_torch.models.resnet import (
    Bottleneck,
    build_resnet,
    feature_dim,
)

# the tolerance of the JAX package's own torch-ResNet parity test
# (tests/test_convert.py): float32 convs summed in another order
ATOL = 2e-4


# uniform ranges for the BN vectors (the ResNets' convs have no bias)
_BN_DRAW = {"mean": (-0.5, 0.5), "var": (0.5, 1.5), "scale": (0.5, 1.5),
            "bias": (-0.2, 0.2)}


def _randomize_bn(tree, rng):
    """Numpy copy of a variables tree with every BN vector randomised."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _randomize_bn(v, rng)
        elif k in _BN_DRAW:
            out[k] = rng.uniform(*_BN_DRAW[k], v.shape).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


@pytest.mark.parametrize("frozen_bn", [False, True])
def test_resnet18_matches_jax(rng, frozen_bn):
    x = rng.standard_normal((2, 32, 56, 3)).astype(np.float32)
    jmodel = jax_build_resnet("resnet18", frozen_bn=frozen_bn)
    variables = _randomize_bn(
        jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    assert ("frozen" in variables) == frozen_bn
    want = jmodel.apply(variables, jnp.asarray(x))

    model = load_jax_variables(build_resnet("resnet18", frozen_bn=frozen_bn),
                               variables).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got["pooled"].shape == (2, feature_dim("resnet18"))
    np.testing.assert_allclose(got["pooled"].numpy(),
                               np.asarray(want["pooled"]), atol=ATOL)
    for g, w in zip(got["stages"], want["stages"]):
        assert tuple(g.shape) == w.shape  # NHWC, as in JAX
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_bottleneck_matches_jax(rng):
    """One strided Bottleneck with its downsample shortcut."""
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    jblock = JaxBottleneck(filters=8, stride=2)
    variables = _randomize_bn(
        jblock.init(jax.random.PRNGKey(2), jnp.asarray(x)), rng)
    want = np.asarray(jblock.apply(variables, jnp.asarray(x)))

    block = load_jax_variables(Bottleneck(16, 8, stride=2), variables)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = block.eval()(xt).permute(0, 2, 3, 1).numpy()
    assert got.shape == (2, 4, 4, 32)
    np.testing.assert_allclose(got, want, atol=ATOL)
