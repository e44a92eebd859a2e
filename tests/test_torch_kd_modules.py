"""The student-training slice's modules in the port against the JAX
package's, on the same seeded numpy inputs and weights.

* ``distill_kl`` and ``mse_feature_kd``: float32, rtol 1e-6 (the same
  formula in the same order; a teacher probability underflowing to 0 takes
  the ``clip(p_t, 1e-12)`` inside the log on both sides).
* ``KDCrossTaskAttention`` and ``Q2L(swin_nano_64, "all")``'s ``kd`` and
  ``sim_mat`` outputs (with its logits and feature): atol 5e-5, the Q2L
  tests' float32 bound (tests/test_torch_q2l.py).
* Train-mode BatchNorm: one layer against flax's ``nn.BatchNorm(momentum=
  0.9, epsilon=1e-5)``, outputs and updated running statistics, rtol and
  atol 1e-6; the whole ResNet18 in training against the JAX one, its
  pooled feature and every updated statistic within 5e-5 of max(1,
  max|JAX|): at batch 4 of 32x56 the last stage normalises over 8 values
  a channel, which magnifies float32 rounding (measured 1.4e-5; each
  package within 1.2e-5 of a float64 forward); a frozen BN in
  training is the eval arithmetic and moves nothing.
* ``fake_quant_kernel``: bit for bit against JAX's on the same kernel (OIHW
  here, HWIO there), its gradient the identity; ``fake_quant_convs`` and
  ``qat_params`` cover what JAX's cover with the float stem, bit for bit.
* ``sam_gradients`` and ``imbsam_gradients`` against ``train/optim.py``:
  rtol 1e-6, and the parameters restored bit for bit.
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervision_codes_tpu.losses.distill import (
    distill_kl as jax_distill_kl,
    mse_feature_kd as jax_mse_feature_kd,
)
from computervision_codes_tpu.models.q2l import Q2L as JaxQ2L
from computervision_codes_tpu.models.qat import (
    fake_quant_convs as jax_fake_quant_convs,
    fake_quant_kernel as jax_fake_quant_kernel,
    qat_params as jax_qat_params,
)
from computervision_codes_tpu.models.resnet import (
    FrozenBatchNorm as JaxFrozenBN,
    build_resnet as jax_build_resnet,
)
from computervision_codes_tpu.models.spatial_cnn import (
    KDCrossTaskAttention as JaxKD,
)
from computervision_codes_tpu.train.optim import (
    imbsam_gradients as jax_imbsam,
    sam_gradients as jax_sam,
)
from computervision_codes_tpu_torch.losses import distill_kl, mse_feature_kd
from computervision_codes_tpu_torch.models.convert import (
    jax_variables,
    load_jax_variables,
)
from computervision_codes_tpu_torch.models.q2l import Q2L
from computervision_codes_tpu_torch.models.qat import (
    fake_quant_convs,
    fake_quant_kernel,
    qat_params,
)
from computervision_codes_tpu_torch.models.resnet import (
    BatchNorm,
    Conv2d,
    FrozenBatchNorm,
    build_resnet,
)
from computervision_codes_tpu_torch.models.spatial_cnn import (
    KDCrossTaskAttention,
)
from computervision_codes_tpu_torch.train.optim import (
    imbsam_gradients,
    sam_gradients,
)

ATOL = 5e-5
RESNET_REL = 5e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch work on one thread: under the suite's parallel
    workers, torch's default of one thread per core oversubscribes the
    host, and tiny ops then wait on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("temperature", [1.0, 4.0])
def test_distill_losses_match_jax(rng, temperature):
    y_s = (rng.standard_normal((5, 15)) * 3).astype(np.float32)
    y_t = (rng.standard_normal((5, 15)) * 3).astype(np.float32)
    y_t[0, :3] = (-300.0, 300.0, -300.0)  # probabilities that underflow
    for a, b in ((y_s, y_t), (y_s, 0.5 + 0.5 * np.tanh(y_t / 2))):
        want = jax_distill_kl(jnp.asarray(a), jnp.asarray(b), temperature)
        got = distill_kl(torch.from_numpy(a), torch.from_numpy(b),
                         temperature)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    f_s = rng.standard_normal((5, 24)).astype(np.float32)
    f_t = rng.standard_normal((5, 24)).astype(np.float32)
    np.testing.assert_allclose(
        mse_feature_kd(torch.from_numpy(f_s), torch.from_numpy(f_t)).item(),
        float(jax_mse_feature_kd(jnp.asarray(f_s), jnp.asarray(f_t))),
        rtol=1e-6)


def test_kd_attention_matches_jax(rng):
    s = rng.standard_normal((3, 32)).astype(np.float32)
    feats = [rng.standard_normal((3, 24)).astype(np.float32)
             for _ in range(3)]
    jmod = JaxKD(student_dim=32, teacher_dim=24)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(s),
                          *map(jnp.asarray, feats))
    want = jmod.apply(variables, jnp.asarray(s), *map(jnp.asarray, feats))
    mod = load_jax_variables(KDCrossTaskAttention(32, 24), variables)
    got = mod(torch.from_numpy(s), *map(torch.from_numpy, feats))
    assert set(got) == set(want) == {"i", "v", "t"}
    for k in want:
        assert got[k].shape == (3, 24)
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), atol=ATOL,
                                   err_msg=k)


def test_q2l_kd_and_sim_mat_match_jax(rng):
    frames = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    feats = [rng.standard_normal((2, 24)).astype(np.float32)
             for _ in range(3)]
    jmodel = JaxQ2L(backbone="swin_nano_64", loss_type="all", teacher_dim=24,
                    fused_eval=False, return_sim_mat=True)
    jargs = (jnp.asarray(frames), *map(jnp.asarray, feats))
    # the JAX tree of a seeded port model (the JAX init's tree, without
    # compiling that init)
    model = Q2L(backbone="swin_nano_64", loss_type="all", teacher_dim=24,
                return_sim_mat=True, generator=torch.Generator().manual_seed(2))
    variables = jax_variables(model)
    want = jax.jit(jmodel.apply)(variables, *jargs)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(frames),
                           *map(torch.from_numpy, feats))
    pairs = [(f"logits_{k}", got["logits"][k], want["logits"][k])
             for k in want["logits"]]
    pairs += [("feature", got["feature"], want["feature"])]
    pairs += [(f"kd_{k}", got["kd"][k], want["kd"][k]) for k in "ivt"]
    assert set(got["sim_mat"]) == set(want["sim_mat"]) == {"i", "v", "t",
                                                          "ivt"}
    for k, n in (("i", 6), ("v", 10), ("t", 15), ("ivt", 100)):
        assert got["sim_mat"][k].shape == (2, n, 4)  # (B, K, HW): 2x2 map
        pairs.append((f"sim_mat_{k}", got["sim_mat"][k], want["sim_mat"][k]))
    for name, g, w in pairs:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   err_msg=name)
    # the eval call without teacher features: no kd, the same logits
    with torch.no_grad():
        plain = model(torch.from_numpy(frames))
    assert "kd" not in plain
    np.testing.assert_array_equal(plain["logits"]["ivt"].numpy(),
                                  got["logits"]["ivt"].numpy())


def _bn_variables(rng, c):
    return {"params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                       "bias": rng.standard_normal(c).astype(np.float32)},
            "batch_stats": {
                "mean": rng.standard_normal(c).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}}


def test_batchnorm_train_matches_flax(rng):
    x = (rng.standard_normal((4, 5, 6, 8)) * 2 + 0.5).astype(np.float32)
    variables = _bn_variables(rng, 8)
    want, mutated = flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5).apply(
        variables, jnp.asarray(x), use_running_average=False,
        mutable=["batch_stats"])
    bn = BatchNorm(8)
    load_jax_variables(bn, variables)
    got = bn.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(want), rtol=1e-6, atol=1e-6)
    for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(
            getattr(bn, ours).numpy(),
            np.asarray(mutated["batch_stats"][theirs]), rtol=1e-6, atol=1e-6,
            err_msg=ours)
    # the weight and bias are trained parameters, the statistics buffers
    assert {n for n, _ in bn.named_parameters()} == {"weight", "bias"}
    frozen = FrozenBatchNorm(8)
    load_jax_variables(frozen, {"frozen": {**variables["params"],
                                           **variables["batch_stats"]}})
    before = [b.clone() for b in frozen.buffers()]
    got = frozen.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    want = JaxFrozenBN().apply(
        {"frozen": {**variables["params"], **variables["batch_stats"]}},
        jnp.asarray(x), use_running_average=False)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-6, atol=1e-6)
    assert not list(frozen.parameters())
    for b, a in zip(frozen.buffers(), before):
        assert torch.equal(b, a)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.fixture(scope="module")
def resnet18_variables():
    """The JAX ResNet18's variables: those of a seeded port ResNet18 (the
    JAX init's tree, without compiling that init)."""
    return jax_variables(build_resnet(
        "resnet18", generator=torch.Generator().manual_seed(0)))


def test_resnet18_train_forward_matches_jax(rng, resnet18_variables):
    x = rng.standard_normal((4, 32, 56, 3)).astype(np.float32)
    jmodel = jax_build_resnet("resnet18")
    # non-trivial statistics
    variables = jax.tree.map(np.array, resnet18_variables)
    for path, leaf in _leaves(variables["batch_stats"]):
        leaf[...] = rng.uniform(0.5, 1.5, leaf.shape) if path[-1] == "var" \
            else 0.1 * rng.standard_normal(leaf.shape)
    want, mutated = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables,
                                                    jnp.asarray(x))
    model = load_jax_variables(build_resnet("resnet18"), variables)
    got = model.train()(torch.from_numpy(x))
    scale = max(1.0, float(np.abs(want["pooled"]).max()))
    assert float(np.abs(got["pooled"].detach().numpy()
                        - np.asarray(want["pooled"])).max()) <= \
        RESNET_REL * scale
    stats = dict(_leaves(jax_variables(model)["batch_stats"]))
    jstats = dict(_leaves(jax.tree.map(np.asarray, mutated["batch_stats"])))
    assert set(stats) == set(jstats) and len(stats) == 40
    for path, w in jstats.items():
        scale = max(1.0, float(np.abs(w).max()))
        assert float(np.abs(stats[path] - w).max()) <= RESNET_REL * scale, \
            path
        assert not np.array_equal(w, dict(_leaves(
            variables["batch_stats"]))[path]), path  # they moved


def test_fake_quant_kernel_matches_jax(rng):
    w = rng.standard_normal((3, 3, 8, 16)).astype(np.float32)  # HWIO
    want = np.asarray(jax_fake_quant_kernel(jnp.asarray(w)))
    oihw = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    got = fake_quant_kernel(oihw)
    np.testing.assert_array_equal(got.permute(2, 3, 1, 0).numpy(), want)
    leaf = oihw.clone().requires_grad_(True)
    fake_quant_kernel(leaf).sum().backward()
    assert torch.equal(leaf.grad, torch.ones_like(leaf))


@pytest.mark.parametrize("form", ["backbone", "model"])
def test_fake_quant_convs_match_jax(form, resnet18_variables):
    """The backbone form (``fake_quant_convs``) and the model form
    (``qat_params`` over a model's ``backbone``) against JAX's, whose
    float stem is the serving default the port keeps."""
    variables = resnet18_variables
    if form == "backbone":
        want = jax.tree.map(np.asarray, jax_fake_quant_convs(
            variables["params"]))
    else:
        want = jax.tree.map(np.asarray, jax_qat_params(
            {"backbone": variables["params"]}))["backbone"]
    model = load_jax_variables(build_resnet("resnet18"), variables)
    holder = torch.nn.Module()
    holder.backbone = model
    covered = 0
    ctx = fake_quant_convs(model) if form == "backbone" else \
        qat_params(holder)
    with ctx:
        for name, conv in model.named_modules():
            if not isinstance(conv, Conv2d):
                continue
            w = conv.weight if conv.weight_fn is None else \
                conv.weight_fn(conv.weight)
            node = want
            for key in name.split("."):
                node = node[key]
            np.testing.assert_array_equal(
                w.detach().permute(2, 3, 1, 0).numpy(), node["kernel"],
                err_msg=name)
            covered += conv.weight_fn is not None
    assert covered == 19  # the stem stays float
    assert all(m.weight_fn is None for m in model.modules()
               if isinstance(m, Conv2d))


def _sam_problem(rng):
    w = rng.standard_normal(4).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)

    def jhead(p):
        return jnp.sum(p["w"] ** 2) + jnp.sum(jnp.cos(p["b"]))

    def jtail(p):
        return jnp.sum((p["w"] - 2.0) ** 4) + jnp.sum(jnp.sin(p["b"])
                                                      * p["w"][:3])

    def head(w, b):
        return (w ** 2).sum() + torch.cos(b).sum()

    def tail(w, b):
        return ((w - 2.0) ** 4).sum() + (torch.sin(b) * w[:3]).sum()

    return w, b, jhead, jtail, head, tail


def test_sam_and_imbsam_match_jax(rng):
    w, b, jhead, jtail, head, tail = _sam_problem(rng)
    jp = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    params = [torch.nn.Parameter(torch.from_numpy(w.copy())),
              torch.nn.Parameter(torch.from_numpy(b.copy()))]
    want = jax_sam(jtail, jp, rho=0.05)
    got = sam_gradients(lambda: tail(*params), params, rho=0.05)
    for g, k in zip(got, ("w", "b")):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]), rtol=1e-6,
                                   err_msg=k)
    want = jax_imbsam(jhead, jtail, jp, rho=0.05)
    got = imbsam_gradients(lambda: head(*params), lambda: tail(*params),
                           params, rho=0.05)
    for g, k in zip(got, ("w", "b")):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]), rtol=1e-6,
                                   err_msg=k)
    # the parameters come back bit for bit
    np.testing.assert_array_equal(params[0].detach().numpy(), w)
    np.testing.assert_array_equal(params[1].detach().numpy(), b)
    # with aux, and a parameter the loss does not reach: zero gradient
    unused = torch.nn.Parameter(torch.ones(2))
    got, aux = sam_gradients(lambda: (tail(*params), "aux"),
                             params + [unused], rho=0.05, has_aux=True)
    assert aux == "aux" and torch.equal(got[2], torch.zeros(2))
