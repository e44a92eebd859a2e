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
from computervision_codes_tpu_torch.models.convert import (jax_variables,
                                                          load_jax_variables)
from computervision_codes_tpu_torch.models.q2l import Q2L

SMALL = dict(width=16, layers=(1, 2, 2, 1))
REL = 1e-5
TRAIN_REL = 1e-3  # training: batch statistics over as few as 8 values
# (stage 4 at 64x64, batch 2) amplify float32 sums taken in another order
BF16_REL, BF16_CORR = 0.04, 0.999
STEP64_REL = 1e-9  # float64: sums in another order


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch work on one thread: under the suite's parallel
    workers, torch's default of one thread per core oversubscribes the
    host, and tiny ops then wait on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def _train_pair(variables, width, layers, frames):
    """The JAX TResNet's training forward (mutable batch statistics) and
    the port's in ``.train()`` from the same variables."""
    want, upd = jax.jit(lambda v, x: jax_tresnet.TResNet(
        width=width, layers=layers).apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, frames)
    model = load_jax_variables(tresnet.TResNet(width=width, layers=layers),
                               variables).train()
    got = model(torch.from_numpy(frames))
    return model, got, want, upd


def _assert_tree_close(got, want, what):
    flat = jax.tree_util.tree_leaves_with_path(want)
    assert flat
    for path, leaf in flat:
        node = got
        for p in path:
            node = node[p.key]
        w = np.asarray(leaf)
        np.testing.assert_allclose(node, w, rtol=0,
                                   atol=TRAIN_REL * np.abs(w).max(),
                                   err_msg=f"{what} {path}")


def test_training_mode_abn_raises(variables):
    """Training-mode ABN (the JAX training ABN: BatchNorm on the batch
    statistics, then the leaky ReLU; no K9) trains where it raised before
    it was ported: every stage and the new running statistics of the
    small TResNet against JAX's."""
    frames = np.random.default_rng(4).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)
    model, got, want, upd = _train_pair(variables, SMALL["width"],
                                        SMALL["layers"], frames)
    for g, w in zip(got["stages"], want["stages"]):
        w = np.asarray(w)
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0,
                                   atol=TRAIN_REL * np.abs(w).max())
    _assert_tree_close(jax_variables(model)["batch_stats"],
                       upd["batch_stats"], "batch_stats")


def _export64(model, m32):
    """``jax_variables`` of a float64 module without rounding it to
    float32: the float32 head and the float32 rest of each tensor exported
    apart through ``m32``, a float32 module of the same architecture (the
    export only moves and transposes), then summed."""
    head = {k: v.float() for k, v in model.state_dict().items()}
    rest = {k: (v - head[k].double()).float()
            for k, v in model.state_dict().items()}
    trees = []
    for state in (head, rest):
        m32.load_state_dict(state)
        trees.append(jax_variables(m32))
    return jax.tree.map(lambda a, b: np.float64(a) + b, *trees)


def test_tresnet_m_training_step_matches_jax():
    """One SGD step (lr 0.1) of TResNet-M at 64x64, batch 2, in float64 on
    both sides (``jax.enable_x64``; the port's TResNet at float64), the
    loss a fixed random projection of the pooled vector, so that every
    parameter, stage 4's too, takes a gradient: every stage and the pooled
    vector, and the new running statistics, within ``STEP64_REL`` of each
    tensor's largest magnitude; each updated parameter within
    ``STEP64_REL`` of the step's largest change (lr x the largest
    gradient), and stage 4's gradients nonzero. In float32 the step is
    not a sharp check at this size: JAX's own float32 gradients differ
    from its float64 ones by 2.3e-3 of the largest (the stem's; 2.2e-2 at
    128x128), through batch statistics over as few as 8 values, and the
    port's float32 gradients differ from JAX's by as much. The float32
    training step is held to the JAX driver's by
    tests/test_torch_cli_spatial_transformer.py."""
    port = tresnet.build_tresnet(
        "tresnet_m", generator=torch.Generator().manual_seed(5))
    variables = randomize_bn(jax_variables(port), seed=6)
    spec = jax_tresnet.VARIANTS["tresnet_m"]
    rng = np.random.default_rng(7)
    frames = rng.standard_normal((2, 64, 64, 3))
    proj = rng.standard_normal((2, tresnet.feature_dim("tresnet_m")))
    lr = 0.1
    with jax.enable_x64(True):
        jmodel = jax_tresnet.TResNet(dtype=jnp.float64, **spec)
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)

        def loss_fn(params):
            out, upd = jmodel.apply(
                {"params": params, "batch_stats": v64["batch_stats"]},
                frames, train=True, mutable=["batch_stats"])
            return jnp.sum(out["pooled"] * proj) / proj.size, (out, upd)

        (_, (want, upd)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(v64["params"])
        want, upd, grads = jax.tree.map(np.asarray, (want, upd, grads))
    step = lr * max(np.abs(g).max() for g in jax.tree_util.tree_leaves(grads))
    assert all(np.abs(g).max() > 0 for path, g in
               jax.tree_util.tree_leaves_with_path(grads)
               if path[0].key.startswith("layer4"))
    expected = {"params": jax.tree.map(
        lambda b, g: np.asarray(b, np.float64) - lr * g,
        variables["params"], grads), "batch_stats": upd["batch_stats"]}
    model = load_jax_variables(tresnet.TResNet(dtype=torch.float64, **spec),
                               variables).double().train()
    got = model(torch.from_numpy(frames))
    ((got["pooled"] * torch.from_numpy(proj)).sum() / proj.size).backward()
    assert all(p.grad is not None for p in model.parameters())
    with torch.no_grad():
        for p in model.parameters():
            p -= lr * p.grad
    for g, w in zip(got["stages"] + [got["pooled"]],
                    want["stages"] + [want["pooled"]]):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0,
                                   atol=STEP64_REL * np.abs(w).max())
    trained = _export64(model, port)
    for coll, bound in (("batch_stats", None), ("params", step)):
        for path, w in jax.tree_util.tree_leaves_with_path(
                expected[coll]):
            node = trained[coll]
            for p in path:
                node = node[p.key]
            atol = STEP64_REL * (np.abs(w).max() if bound is None else bound)
            np.testing.assert_allclose(node, w, rtol=0, atol=atol,
                                       err_msg=f"{coll} {path}")
