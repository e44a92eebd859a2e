"""The port's int8 TResNet (models/quant_tresnet.py) against the JAX
package's.

At the width and depths of tests/test_torch_tresnet.py (width 16, layers
(1, 2, 2, 1)), the float weights from the port's seeded module with every
BatchNorm drawn at random, exported to the JAX tree by ``jax_variables``;
the same seeded bf16 frames at 64x64 (every map even, so the shortcut's
average pool pads nothing). Bounds, those tests/test_torch_quantized.py
holds the int8 ResNet to:

* conversion: int8 codes equal, ``mult`` and ``bias`` rtol 1e-6 and 2e-7
  absolute (``rsqrt`` may differ in the last bit), the SE's float Dense
  parameters equal;
* calibrated activation scales: bit for bit, each conv's in the order the
  forward runs them;
* the forward on the same quantized tree (``load_jax_quantized``), with
  static and with dynamic scales: bf16, every stage and the pooled vector
  within one ulp of their largest magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_tresnet import SMALL

from computervision_codes_tpu.models import quant_tresnet as jqt
from computervision_codes_tpu_torch.models import quant_tresnet as pqt
from computervision_codes_tpu_torch.models import tresnet
from computervision_codes_tpu_torch.models.convert import (jax_variables,
                                                          load_jax_quantized)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch work on one thread: under the suite's parallel
    workers, torch's default of one thread per core oversubscribes the
    host, and tiny ops then wait on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randomize_bn(model: torch.nn.Module, seed: int) -> None:
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, tresnet.BatchNorm):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)


@pytest.fixture(scope="module")
def setup():
    model = tresnet.TResNet(generator=torch.Generator().manual_seed(0),
                            **SMALL).eval()
    _randomize_bn(model, 1)
    variables = jax_variables(model)
    frames = np.asarray(jnp.asarray(np.random.default_rng(2).standard_normal(
        (2, 64, 64, 3)), jnp.bfloat16).astype(jnp.float32))
    qj = jqt.quantize_tresnet(variables["params"], variables["batch_stats"])
    cal = jqt.calibrate_tresnet(qj, jnp.asarray(frames, jnp.bfloat16),
                                SMALL["width"], SMALL["layers"])
    return model, frames, qj, cal


def _nodes(qp):
    return {name: m for name, m in qp.named_modules()
            if isinstance(m, (pqt.QConv, pqt.FloatDense))}


def test_quantize_matches_jax(setup):
    model, _, qj, _ = setup
    qp = pqt.quantize_tresnet(model)
    nodes = _nodes(qp)
    seen = 0
    for name, m in nodes.items():
        want = qj
        for k in name.split("."):
            want = want[k]
        if isinstance(m, pqt.FloatDense):
            for key in ("kernel", "bias"):
                np.testing.assert_array_equal(getattr(m, key).numpy(),
                                              np.asarray(want[key]))
            continue
        seen += 1
        np.testing.assert_array_equal(m.w_q.permute(1, 2, 3, 0).numpy(),
                                      np.asarray(want["w_q"]))
        for key in ("mult", "bias"):
            np.testing.assert_allclose(getattr(m, key).numpy(),
                                       np.asarray(want[key]), rtol=1e-6,
                                       atol=2e-7, err_msg=f"{name}/{key}")
    assert seen == len(jqt._conv_call_order(qj, SMALL["layers"]))
    assert len(nodes) - seen == 2 * sum(SMALL["layers"][:3])  # SE fc1, fc2


def test_calibrated_scales_bit_for_bit(setup):
    model, frames, _, cal = setup
    qp = pqt.calibrate_tresnet(pqt.quantize_tresnet(model),
                               torch.from_numpy(frames).bfloat16(),
                               SMALL["layers"])
    got = [float(q.act_scale) for q in pqt._conv_call_order(
        qp, SMALL["layers"])]
    want = [float(q["act_scale"]) for q in jqt._conv_call_order(
        cal, SMALL["layers"])]
    assert len(got) == len(want) == 1 + 2 * 3 + 3 * 3 + 3  # stem, convs,
    assert got == want                                   # shortcuts


@pytest.mark.parametrize("static", [True, False])
def test_forward_on_the_same_tree_matches_jax(setup, static):
    model, frames, qj, cal = setup
    tree = cal if static else qj
    want = jqt.quantized_tresnet_apply(tree, jnp.asarray(frames),
                                       SMALL["width"], SMALL["layers"])
    qp = load_jax_quantized(pqt.quantize_tresnet(model, torch.bfloat16),
                            tree)
    assert (qp.stem.act_scale is not None) == static
    with torch.no_grad():
        got = qp(torch.from_numpy(frames))
    for g, w in zip(got["stages"] + [got["pooled"]],
                    want["stages"] + [want["pooled"]]):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        top = np.abs(w).max()
        ulp = float(np.spacing(np.float32(top))) * 2 ** 16  # bf16: 8 bits
        assert np.abs(g.float().numpy() - w).max() <= ulp


def test_make_int8_tresnet(setup, monkeypatch):
    """``make_int8_tresnet`` of a registered variant is the calibrated
    twin; without frames its scales stay dynamic."""
    model, frames, _, cal = setup
    monkeypatch.setitem(tresnet.VARIANTS, "tresnet_small", SMALL)
    x = torch.from_numpy(frames)
    qp = pqt.make_int8_tresnet("tresnet_small", model, x)
    got = [float(q.act_scale) for q in pqt._conv_call_order(
        qp, SMALL["layers"])]
    assert got == [float(q["act_scale"]) for q in jqt._conv_call_order(
        cal, SMALL["layers"])]
    dyn = pqt.make_int8_tresnet("tresnet_small", model)
    assert all(q.act_scale is None
               for q in pqt._conv_call_order(dyn, SMALL["layers"]))
    assert pqt.STEM_SLOPE == jqt.STEM_SLOPE == 1e-2
    assert pqt.BLOCK_SLOPE == jqt.BLOCK_SLOPE == 1e-3
