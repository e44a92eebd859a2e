"""The port's TemporalTCN and interpolate_1d against the JAX package's.

The JAX module is initialised, its variables are carried into the port by
``load_jax_variables``, and both run the same seeded numpy input in
float32. On the CPU both take their plain dilated-layer path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervision_codes_tpu.models.common import (
    interpolate_1d as jax_interpolate_1d,
)
from computervision_codes_tpu.models.tcn import TemporalTCN as JaxTCN
from computervision_codes_tpu_torch.models.common import interpolate_1d
from computervision_codes_tpu_torch.models.convert import load_jax_variables
from computervision_codes_tpu_torch.models.tcn import TemporalTCN

KW = dict(num_layers_pg=3, num_layers_r=2, num_refinements=2, num_f_maps=16)
# float32 through 1 + 7 residual layers and the FPN: rounding differences
# stay near 1e-6 relative at these O(1)-O(10) magnitudes
ATOL, RTOL = 1e-4, 1e-5


@pytest.mark.parametrize("causal,hier", [(False, False), (True, False),
                                         (False, True)])
def test_temporal_tcn_matches_jax(rng, causal, hier):
    x = rng.standard_normal((2, 64, 24)).astype(np.float32)
    jmodel = JaxTCN(causal=causal, hier=hier, **KW)
    variables = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = jmodel.apply(variables, jnp.asarray(x))

    model = TemporalTCN(in_features=24, causal=causal, hier=hier, **KW)
    load_jax_variables(model, variables).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert set(got) == set(want)
    for key in want:
        assert len(got[key]) == len(want[key]) == 3
        for level, (g, w) in enumerate(zip(got[key], want[key])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                       rtol=RTOL, err_msg=f"{key}[{level}]")


@pytest.mark.parametrize("mode", ["linear", "nearest"])
@pytest.mark.parametrize("t_in,size", [(5, 20), (20, 64), (64, 21), (7, 7)])
def test_interpolate_1d_matches_jax(rng, mode, t_in, size):
    x = rng.standard_normal((2, 3, t_in)).astype(np.float32)
    got = interpolate_1d(torch.from_numpy(x), size, mode).numpy()
    want = np.asarray(jax_interpolate_1d(jnp.asarray(x), size, mode))
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_load_jax_variables_rejects_bad_trees(rng):
    jmodel = JaxTCN(**KW)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 24)))
    params = jax.tree.map(np.asarray, dict(variables["params"]))
    model = TemporalTCN(in_features=24, **KW)

    missing = dict(params)
    del missing["head_t"]
    with pytest.raises(KeyError, match="head_t"):
        load_jax_variables(model, {"params": missing})
    extra = dict(params, head_extra={"kernel": np.zeros((1, 16, 3))})
    with pytest.raises(KeyError, match="head_extra"):
        load_jax_variables(model, {"params": extra})
    with pytest.raises(ValueError, match="shape"):
        load_jax_variables(TemporalTCN(in_features=32, **KW),
                           {"params": params})
