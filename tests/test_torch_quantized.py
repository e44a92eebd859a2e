"""The port's int8 ResNet student (models/quantized.py) against the JAX
package's, and its fidelity to the port's float model.

The same float weights go into both packages (``load_jax_variables``), and
the same quantized tree (``load_jax_quantized``) where the outputs are
compared. Bounds:

* conversion: int8 codes equal, ``mult``/``bias``/folded stem rtol 1e-6
  (``rsqrt`` may differ in the last bit) and 2e-7 absolute (``bias`` is a
  difference that cancels);
* calibrated scales: rtol 1e-5 (float32 activations summed in another
  order);
* forward on the same tree: float32 within 1e-4 of the largest output,
  bf16 within one ulp of it. A float32 difference in a conv input can move
  a value across a rounding boundary of the next quantizer, so this is
  not bit equality, though at these seeds the outputs agree exactly;
* fidelity to the float model: the JAX tests' own bounds
  (tests/test_quantized.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervision_codes_tpu.models import quantized as jqz
from computervision_codes_tpu.models.pipeline import (
    EndToEndRecognizer as JaxRecognizer,
)
from computervision_codes_tpu.models.resnet import (
    VARIANTS as JAX_VARIANTS,
    build_resnet as jax_build_resnet,
)
from computervision_codes_tpu_torch.models import quantized as pqz
from computervision_codes_tpu_torch.models.convert import (
    load_jax_quantized,
    load_jax_variables,
)
from computervision_codes_tpu_torch.models.pipeline import EndToEndRecognizer
from computervision_codes_tpu_torch.models.resnet import build_resnet

SIZES18 = JAX_VARIANTS["resnet18"][0]
TCN = dict(num_layers_pg=3, num_layers_r=2, num_refinements=1, num_f_maps=8)
_BN_DRAW = {"mean": (-0.5, 0.5), "var": (0.5, 1.5), "scale": (0.5, 1.5),
            "bias": (-0.2, 0.2)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch work on one thread: under the suite's parallel
    workers, torch's default of one thread per core oversubscribes the
    host, and tiny ops then wait on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randomize_bn(tree, rng):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _randomize_bn(v, rng)
        elif k in _BN_DRAW:
            out[k] = rng.uniform(*_BN_DRAW[k], v.shape).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _backbones(rng, network="resnet18", hw=(32, 56), batch=2, **plans):
    """(frames, JAX variables, JAX float model, port float model)."""
    x = rng.standard_normal((batch, *hw, 3)).astype(np.float32)
    jmodel = jax_build_resnet(network, **plans)
    variables = _randomize_bn(
        jax_build_resnet(network).init(jax.random.PRNGKey(0),
                                       jnp.asarray(x)), rng)
    port = load_jax_variables(build_resnet(network, **plans),
                              variables).eval()
    return x, variables, jmodel, port


def _close(got: torch.Tensor, want, dtype: str, what: str = "") -> None:
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    top = np.abs(want).max()
    if dtype == "float32":
        tol = 1e-4 * top
    else:
        tol = 2.0 ** (np.floor(np.log2(top)) - 7)
    err = np.abs(got - want).max()
    assert err <= tol, (what, err, tol)


@pytest.mark.parametrize("network, float_stem", [
    ("resnet18", True), ("resnet18", False), ("resnet50", True)])
def test_quantize_resnet_matches_jax(rng, network, float_stem):
    hw = (32, 56) if network == "resnet18" else (32, 32)
    _, variables, _, port = _backbones(rng, network, hw)
    want = jqz.quantize_resnet(variables["params"], variables["batch_stats"],
                               float_stem=float_stem)
    qp = pqz.quantize_resnet(port, float_stem=float_stem)
    convs = dict(qp.named_modules())
    count = 0
    for name, node in want.items():
        for sub, q in ([("", node)] if name == "conv1" else node.items()):
            conv = convs[".".join(p for p in (name, sub) if p)]
            assert set(q) == set(conv.qw), name
            for key, value in q.items():
                got = getattr(conv, key).numpy()
                value = np.asarray(value)
                if key == "w_q":
                    np.testing.assert_array_equal(
                        got, value.transpose(3, 0, 1, 2))
                else:  # bias = beta - mean * s cancels: 2e-7 absolute
                    np.testing.assert_allclose(got, value, rtol=1e-6,
                                               atol=2e-7)
            count += 1
    assert count == len([m for m in convs.values()
                         if isinstance(m, pqz.QConv)])


def test_calibrate_resnet_scales_match_jax(rng):
    x, variables, _, port = _backbones(rng)
    jq = jqz.quantize_resnet(variables["params"], variables["batch_stats"])
    jcal = jqz.calibrate_resnet(jq, jnp.asarray(x), SIZES18,
                                dtype=jnp.float32, margin=1.1)
    qp = pqz.quantize_resnet(port)
    cal = pqz.calibrate_resnet(qp, torch.from_numpy(x), SIZES18,
                               dtype=torch.float32, margin=1.1)
    want = [float(q["act_scale"])
            for q in jqz._conv_call_order(jcal, SIZES18, "basic")]
    convs = pqz._conv_call_order(cal, SIZES18, "basic")
    assert len(convs) == len(want) == 19  # 16 block convs + 3 downsamples
    for conv in convs:
        assert conv.act_scale.dtype == torch.float32
    np.testing.assert_allclose([float(c.act_scale) for c in convs], want,
                               rtol=1e-5)
    # the input module is left as it was
    assert all(c.act_scale is None
               for c in pqz._conv_call_order(qp, SIZES18, "basic"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("plan", ["standard", "s2d_stem", "fused_stem"])
def test_quantized_resnet_apply_matches_jax(rng, plan, dtype):
    """Same calibrated tree through both packages, every stem plan."""
    jdt, tdt = DTYPES[dtype]
    x, variables, _, port = _backbones(rng)
    jq = jqz.calibrate_resnet(
        jqz.quantize_resnet(variables["params"], variables["batch_stats"]),
        jnp.asarray(x), SIZES18, dtype=jdt)
    qp = load_jax_quantized(pqz.quantize_resnet(port), jq)
    flags = {} if plan == "standard" else {plan: True}
    want = jqz.quantized_resnet_apply(jq, jnp.asarray(x), SIZES18,
                                      dtype=jdt, **flags)
    with torch.no_grad():
        got = pqz.quantized_resnet_apply(qp, torch.from_numpy(x), SIZES18,
                                         dtype=tdt, **flags)
    _close(got["pooled"], want["pooled"], dtype, "pooled")
    for i, (g, w) in enumerate(zip(got["stages"], want["stages"])):
        _close(g, w, dtype, f"stage {i}")


def test_quantized_bottleneck_matches_jax(rng):
    x, variables, _, port = _backbones(rng, "resnet50", (32, 32))
    sizes = JAX_VARIANTS["resnet50"][0]
    jq = jqz.quantize_resnet(variables["params"], variables["batch_stats"])
    qp = load_jax_quantized(pqz.quantize_resnet(port), jq)
    want = jqz.quantized_resnet_apply(jq, jnp.asarray(x), sizes,
                                      block="bottleneck", dtype=jnp.float32)
    with torch.no_grad():
        got = pqz.quantized_resnet_apply(qp, torch.from_numpy(x), sizes,
                                         block="bottleneck",
                                         dtype=torch.float32)
    _close(got["pooled"], want["pooled"], "float32", "pooled")


@pytest.mark.parametrize("plan", ["s2d_stem", "fused_stem"])
def test_float_backbone_stem_plans_match_jax(rng, plan):
    """The float ResNet's stem plans against the JAX ResNet with the same
    flag (float32; the tolerance of tests/test_torch_resnet.py)."""
    x, variables, jmodel, port = _backbones(rng, **{plan: True})
    want = jmodel.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got["pooled"].numpy(),
                               np.asarray(want["pooled"]), atol=2e-4)
    for g, w in zip(got["stages"], want["stages"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4)


@pytest.mark.parametrize("plan", ["standard", "fused_stem"])
def test_make_int8_e2e_matches_jax(rng, plan):
    """The int8 recognizer (small TCN, float32) on the same tree.

    With ``fused_stem`` the JAX side runs its Pallas stem in interpret
    mode, whose sums differ from its reference (and the port's plain
    version, which equals that reference) by up to 4e-7; that moves some
    activations across an int8 rounding boundary and the change cascades,
    so the bound there is a correlation above 0.999, as in the JAX
    package's own plan-against-plan checks."""
    clips = rng.standard_normal((1, 4, 32, 56, 3)).astype(np.float32)
    jmodel = JaxRecognizer(dtype=jnp.float32, **TCN)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(clips))
    flags = {} if plan == "standard" else {plan: True}
    fn, qvars = jqz.make_int8_e2e(jmodel, variables,
                                  calibrate_clips=jnp.asarray(clips), **flags)
    want = fn(qvars, jnp.asarray(clips))

    model = load_jax_variables(
        EndToEndRecognizer(dtype=torch.float32, **TCN), variables).eval()
    int8 = pqz.make_int8_e2e(model, torch.from_numpy(clips), **flags)
    load_jax_quantized(int8.backbone, qvars["q_backbone"])
    with torch.no_grad():
        got = int8(torch.from_numpy(clips))
    for k in ("features", "ivt", "i", "v", "t"):
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape, k
        if plan == "fused_stem":
            assert np.corrcoef(g.ravel(), w.ravel())[0, 1] > 0.999, k
        elif k == "features":
            np.testing.assert_allclose(g, w, atol=2e-4)
        else:
            np.testing.assert_allclose(g, w, atol=1e-3, rtol=1e-4,
                                       err_msg=k)


def test_quantized_resnet18_feature_fidelity(rng):
    """Port only: int8 pooled features against the port's float ResNet
    (the bounds of tests/test_quantized.py)."""
    x = torch.from_numpy(rng.standard_normal((4, 32, 56, 3)).astype(
        np.float32))
    model = build_resnet("resnet18",
                         generator=torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        ref = model(x)
        got = pqz.quantized_resnet_apply(pqz.quantize_resnet(model), x,
                                         SIZES18, dtype=torch.float32)
    a = ref["pooled"].double().numpy().ravel()
    b = got["pooled"].double().numpy().ravel()
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    rel = np.linalg.norm(a - b) / np.linalg.norm(a)
    assert cos > 0.99, cos
    assert rel < 0.15, rel
    for r, g in zip(ref["stages"], got["stages"]):
        assert r.shape == g.shape


def test_int8_static_scales_track_dynamic_and_float(rng):
    """Port only, default-size recognizer: static (calibrated) against
    dynamic scales, corr > 0.995, and against float, corr > 0.98."""
    clips = torch.from_numpy(rng.standard_normal((1, 8, 32, 56, 3)).astype(
        np.float32))
    model = EndToEndRecognizer(
        dtype=torch.float32,
        generator=torch.Generator().manual_seed(1)).eval()
    dyn_model = pqz.make_int8_e2e(model)
    sta_model = pqz.make_int8_e2e(model, calibrate_clips=clips)
    assert "w" in sta_model.backbone.conv1.qw  # float stem
    assert sta_model.backbone.layer1_0.conv1.act_scale is not None
    assert dyn_model.backbone.layer1_0.conv1.act_scale is None
    with torch.no_grad():
        ref = model(clips)["ivt"].double().numpy().ravel()
        dyn = dyn_model(clips)["ivt"].double().numpy().ravel()
        sta = sta_model(clips)["ivt"].double().numpy().ravel()
    assert np.corrcoef(dyn, sta)[0, 1] > 0.995
    assert np.corrcoef(ref, sta)[0, 1] > 0.98
    assert np.corrcoef(ref, dyn)[0, 1] > 0.98
