"""The port's int8 Dense layers (models/quant_dense.py) against the JAX
package's ``collect_dense_scales`` / ``quantize_dense_params`` /
``int8_apply``.

Bounds:

* int8 weight codes and scales: equal bit for bit (the same quantizer on
  the same float32 parameters);
* activation scales: equal bit for bit where the two packages see the same
  inputs (a Dense fed the model's input, called twice: the max over its
  calls); inside Q2L, rtol 1e-5, as for the int8 student's calibrated
  scales (tests/test_torch_quantized.py): the activations come out of
  float32 sums taken in another order, so their absmax may differ in the
  last bits;
* one ``Int8Dense`` on the same input and scale: bit for bit in float32
  and bf16 (the same quantizer, exact int sums, the same epilogue);
* the whole ``Q2L(swin_nano_64, "all")`` through ``int8_apply`` at
  ``min_features=0`` from the same int8 weights and scales (the JAX
  calibration's, as the int8 student's forward test feeds both packages
  one quantized tree), float32: the 131 logits with correlation > 0.999
  and within 2% of the largest, the feature within 1e-4. A float32
  difference in a layer's input can move a value across an int8 rounding
  boundary, and the change cascades through the decoders (the bound of
  the int8 student's cross-checks, tests/test_torch_quantized.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from computervision_codes_tpu.models import quant_dense as jqd
from computervision_codes_tpu.models.q2l import Q2L as JaxQ2L
from computervision_codes_tpu_torch.models import quant_dense as pqd
from computervision_codes_tpu_torch.models.common import Dense
from computervision_codes_tpu_torch.models.convert import (
    jax_variables,
    load_jax_variables,
)
from computervision_codes_tpu_torch.models.q2l import Q2L

KW = dict(backbone="swin_nano_64", loss_type="all")
INT8_FLAGS = dict(quant_eval=True, s2d_embed=True, quant_min_dim=0)
SCALE_RTOL = 1e-5
MODEL_CORR, MODEL_REL = 0.999, 0.02


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch work on one thread: under the suite's parallel
    workers, torch's default of one thread per core oversubscribes the
    host, and tiny ops then wait on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _JaxTwice(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        d = fnn.Dense(8, name="shared")
        return fnn.Dense(4, use_bias=False, name="out")(d(x) + d(3.0 * x))


class _Twice(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.shared = Dense(16, 8)
        self.out = Dense(8, 4, use_bias=False)

    def forward(self, x):
        return self.out(self.shared(x) + self.shared(3.0 * x))


def test_shared_layer_scales_and_int8_dense_equal_jax(rng):
    """A Dense called twice takes the max over its calls; scales, codes and
    the int8 forward equal the JAX package's bit for bit."""
    x = rng.standard_normal((5, 16)).astype(np.float32)
    jm = _JaxTwice()
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    model = load_jax_variables(_Twice(), variables).eval()
    want = jqd.collect_dense_scales(jm, variables, jnp.asarray(x),
                                    margin=1.1)
    got = pqd.collect_dense_scales(model, torch.from_numpy(x), margin=1.1)
    assert got == want and set(got) == {"shared", "out"}
    assert got["shared"] == max(float(np.float32(3 * np.abs(x).max()))
                                * 1.1 / 127.0, 1e-8)
    jw = jqd.quantize_dense_params(variables)
    pw = pqd.quantize_dense_params(model)
    for k in jw:
        for a, b in zip(pw[k], jw[k]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ref = jqd.int8_apply(jm, variables, jw, want, jnp.asarray(x))
    pqd.apply_int8_dense(model, pw, got)
    assert isinstance(model.shared, pqd.Int8Dense)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_bias", [True, False])
def test_int8_dense_equals_jax_int8_apply(rng, dtype, use_bias):
    """One layer, the same input and scale: the JAX interception computes
    clip(round(x / s)) codes, int32 sums and acc * (s * s_w) + bias."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    x = rng.standard_normal((3, 7, 64)).astype(np.float32)
    jm = fnn.Dense(48, use_bias=use_bias, dtype=jdt)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    if use_bias:
        variables = {"params": dict(variables["params"],
                                    bias=jnp.asarray(rng.standard_normal(48),
                                                     jnp.float32))}
    scales = {"": 0.021}
    want = jqd.int8_apply(jm, variables, jqd.quantize_dense_params(variables),
                          scales, jnp.asarray(x, jdt))
    dense = load_jax_variables(Dense(64, 48, use_bias=use_bias, dtype=dtype),
                               variables)
    w_q, s_w = pqd.quantize_dense_params(dense)[""]
    layer = pqd.Int8Dense(dense, w_q, s_w, scales[""])
    with torch.no_grad():
        got = layer(torch.from_numpy(x).to(dtype))
    assert got.dtype == dtype and got.shape == (3, 7, 48)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.fixture(scope="module")
def q2l_pair():
    rng = np.random.default_rng(3)
    frames = rng.standard_normal((1, 64, 64, 3)).astype(np.float32)
    cal = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    # the variables of a port model made from a seed (the JAX init's tree,
    # without compiling that init)
    variables = jax_variables(Q2L(generator=torch.Generator().manual_seed(2),
                                  **KW))
    jm = JaxQ2L(fused_eval=True, **INT8_FLAGS, **KW)
    scales = jqd.collect_dense_scales(jm, variables, jnp.asarray(cal))
    qd = jqd.quantize_dense_params(variables)
    want = jax.jit(lambda v, x: jqd.int8_apply(jm, v, qd, scales, x))(
        variables, jnp.asarray(frames))
    model = load_jax_variables(Q2L(**INT8_FLAGS, **KW), variables).eval()
    return dict(frames=frames, cal=cal, variables=variables, scales=scales,
                qd=qd, want=want, model=model)


def test_q2l_weights_and_scales_match_jax(q2l_pair):
    p = q2l_pair
    model = p["model"]
    pw = pqd.quantize_dense_params(model)
    assert set(pw) == set(p["qd"])  # every Dense, by its flax path
    for k, (w_q, s_w) in p["qd"].items():
        np.testing.assert_array_equal(pw[k][0].numpy(), np.asarray(w_q))
        np.testing.assert_array_equal(pw[k][1].numpy(), np.asarray(s_w))
    # every call of a shared transformer layer, recorded on the side
    calls = []
    probe = model.transformer.encoder0.linear1.register_forward_pre_hook(
        lambda _m, a: calls.append(float(a[0].float().abs().amax())))
    try:
        got = pqd.collect_dense_scales(model, torch.from_numpy(p["cal"]))
    finally:
        probe.remove()
    assert set(got) == set(p["scales"])  # the Dense layers that ran
    assert "backbone/stage0_block0/attn/qkv" not in got  # inside K5
    for k, v in p["scales"].items():
        assert got[k] == pytest.approx(v, rel=SCALE_RTOL), k
    assert len(calls) == 4 and len(set(calls)) > 1  # one call per task
    assert got["transformer/encoder0/linear1"] == max(max(calls) / 127.0,
                                                      1e-8)


def test_q2l_int8_dense_forward_matches_jax(q2l_pair):
    p = q2l_pair
    model = p["model"]
    scales = {k: float(v) for k, v in p["scales"].items()}
    pqd.apply_int8_dense(model, pqd.quantize_dense_params(model), scales)
    swapped = [k for k, m in model.named_modules()
               if isinstance(m, pqd.Int8Dense)]
    assert len(swapped) == len(scales)
    with torch.no_grad():
        got = model(torch.from_numpy(p["frames"]))
    tasks = ("i", "v", "t", "ivt")  # 131 logits
    g = np.concatenate([got["logits"][k].numpy().ravel() for k in tasks])
    w = np.concatenate([np.asarray(p["want"]["logits"][k]).ravel()
                        for k in tasks])
    err = np.abs(g - w).max()
    assert np.corrcoef(g, w)[0, 1] > MODEL_CORR
    assert err <= MODEL_REL * np.abs(w).max(), (err, np.abs(w).max())
    np.testing.assert_allclose(got["feature"].numpy(),
                               np.asarray(p["want"]["feature"]), atol=1e-4)


def test_min_features_keeps_narrow_layers_float(q2l_pair):
    p = q2l_pair
    model = load_jax_variables(Q2L(**INT8_FLAGS, **KW), p["variables"])
    scales = pqd.collect_dense_scales(model.eval(),
                                      torch.from_numpy(p["cal"]))
    pqd.apply_int8_dense(model, pqd.quantize_dense_params(model), scales,
                         min_features=512)
    kinds = {k: type(m).__name__ for k, m in model.named_modules()
             if isinstance(m, (Dense, pqd.Int8Dense))}
    # at nano width the last patch merge (4 x 128 inputs) and linear2
    # (8192) reach 512
    assert {k for k, v in kinds.items() if v == "Int8Dense"} == {
        "backbone.merge2.reduction", "transformer.encoder0.linear2",
        "transformer.decoder0.linear2", "transformer.decoder1.linear2"}
