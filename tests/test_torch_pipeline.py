"""The port's EndToEndRecognizer against the JAX package's, same weights,
float32, small TCN (the ResNet18 backbone is at full width)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervision_codes_tpu.models.pipeline import (
    EndToEndRecognizer as JaxRecognizer,
)
from computervision_codes_tpu_torch.models.convert import load_jax_variables
from computervision_codes_tpu_torch.models.pipeline import EndToEndRecognizer

KW = dict(num_layers_pg=3, num_layers_r=2, num_refinements=2, num_f_maps=16)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch work on one thread: under the suite's parallel
    workers, torch's default of one thread per core oversubscribes the
    host, and tiny ops then wait on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("causal", [False, True])
def test_recognizer_matches_jax(rng, causal):
    clips = rng.standard_normal((1, 8, 32, 56, 3)).astype(np.float32)
    jmodel = JaxRecognizer(causal=causal, dtype=jnp.float32, **KW)
    variables = jmodel.init(jax.random.PRNGKey(4), jnp.asarray(clips))
    want = jmodel.apply(variables, jnp.asarray(clips))

    model = EndToEndRecognizer(causal=causal, dtype=torch.float32, **KW)
    load_jax_variables(model, variables).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(clips))
    assert set(got) == set(want)
    # features: the ResNet parity tolerance (tests/test_convert.py); logits:
    # the same absolute error carried through the 1x1 input conv, 7 float32
    # residual layers and a head, which grow values to O(10)
    np.testing.assert_allclose(got["features"].numpy(),
                               np.asarray(want["features"]), atol=2e-4)
    for k in ("ivt", "i", "v", "t"):
        assert tuple(got[k].shape) == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-3, rtol=1e-4, err_msg=k)
