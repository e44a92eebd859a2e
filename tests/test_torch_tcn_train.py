"""The port's temporal TCN in training against the JAX package's.

One SGD step with the randomness out of play: the JAX side takes
``jax.grad`` of ``tcn_multitask_loss`` over ``TemporalTCN.apply(...,
train=False)`` (the same arithmetic as ``train=True`` without dropout: its
``custom_vjp`` differentiates the XLA reference), then ``build_sgd``'s
update; the port runs its own train step in ``.train()`` with every
dropout rate and ``mask_rate`` set to 0 on its modules. The losses agree
at rtol 1e-5 and every updated parameter within 1e-6 plus 1% of its
change in the step (float32 sums in another order; the bound of
tests/test_torch_spatial_train.py). The random parts are held by their
statistics: the input mask's keep share, the 1 / (1 - p) scale of both
dropouts, the channel mask constant over T, and one generator state
giving one result. The fusion loss (``--hier`` levels, ``frame_mask``)
and the eval step agree at 1e-5; ``weight_balancing`` gives JAX's tables
for every variant and fold. A recorder shows that ``.train()`` calls no
``dilated_residual_fused`` and ``.eval()`` calls it at every layer.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervision_codes_tpu.data import class_weights as jax_cw
from computervision_codes_tpu.losses import fusion as jax_fusion
from computervision_codes_tpu.losses.bce import (
    TARGET_POS_WEIGHT, TOOL_POS_WEIGHT, VERB_POS_WEIGHT)
from computervision_codes_tpu.models.tcn import TemporalTCN as JaxTCN
from computervision_codes_tpu.train import TrainState as JaxTrainState
from computervision_codes_tpu.train import build_sgd as jax_build_sgd
from computervision_codes_tpu.train.trainer import (
    make_tcn_eval_step as jax_make_tcn_eval_step)
from computervision_codes_tpu_torch.data import class_weights
from computervision_codes_tpu_torch.losses import fusion
from computervision_codes_tpu_torch.models import tcn as port_tcn
from computervision_codes_tpu_torch.models.convert import (
    jax_variables, load_jax_variables)
from computervision_codes_tpu_torch.models.tcn import TemporalTCN
from computervision_codes_tpu_torch.train import (
    build_sgd, create_train_state, make_tcn_eval_step, make_tcn_train_step)

KW = dict(num_layers_pg=3, num_layers_r=2, num_refinements=2, num_f_maps=64)
IN_DIM, T = 24, 40
LOSS_RTOL, PARAM_ATOL, PARAM_REL = 1e-5, 1e-6, 1e-2
ATOL = 1e-5  # the fusion loss and the eval step's probabilities
LR, WD = 0.05, 1e-4
POS = {"i": np.asarray(TOOL_POS_WEIGHT, np.float32),
       "v": np.asarray(VERB_POS_WEIGHT, np.float32),
       "t": np.asarray(TARGET_POS_WEIGHT, np.float32)}
SIZES = {"ivt": 100, "i": 6, "v": 10, "t": 15}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch work on one thread: under the suite's parallel
    workers, torch's default of one thread per core oversubscribes the
    host, and tiny ops then wait on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(rng, t=T, mask=False):
    batch = {"features": rng.standard_normal((1, t, IN_DIM)).astype(
        np.float32)}
    for k, n in SIZES.items():
        batch[f"label_{k}"] = (rng.random((t, n)) < 0.2).astype(np.float32)
    if mask:
        batch["frame_mask"] = (np.arange(t) < t - 7).astype(np.float32)
    return batch


def _models(hier=False, causal=False):
    jmodel = JaxTCN(hier=hier, causal=causal, mask_rate=0.0, **KW)
    variables = jmodel.init(jax.random.PRNGKey(3),
                            jnp.zeros((1, T, IN_DIM)))
    port = load_jax_variables(
        TemporalTCN(IN_DIM, hier=hier, causal=causal, **KW), variables)
    return jmodel, variables, port


def _no_randomness(model):
    model.mask_rate = model.channel_dropout = 0.0
    for m in model.modules():
        if isinstance(m, port_tcn.DilatedResidualLayer):
            m.dropout = 0.0


@pytest.mark.parametrize("hier, causal, mask", [(False, False, False),
                                                (True, False, True),
                                                (False, True, True)])
def test_one_sgd_step_matches_jax(rng, hier, causal, mask):
    jmodel, variables, port = _models(hier, causal)
    batch = _batch(rng, mask=mask)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        out = jmodel.apply({"params": params}, jb["features"], train=False)
        labels = {k: jb[f"label_{k}"] for k in SIZES}
        return jax_fusion.tcn_multitask_loss(
            out, labels, pos_weights=POS, frame_mask=jb.get("frame_mask"))[
                "total"]

    params = variables["params"]
    want_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tx = jax_build_sgd(LR, WD)
    updates, _ = tx.update(grads, tx.init(params), params)
    want = jax.tree.map(lambda p, u: np.asarray(p + u), params, updates)

    _no_randomness(port)
    state = create_train_state(port, build_sgd(LR, WD), device="cpu")
    step = make_tcn_train_step(port, pos_weights=POS, device="cpu")
    state, metrics = step(state, batch)
    np.testing.assert_allclose(float(metrics["loss_total"]),
                               float(want_loss), rtol=LOSS_RTOL)
    got = jax_variables(state.model)["params"]
    before = jax.tree.map(np.asarray, params)

    def check(g, w, b):
        change = np.abs(w - b).max()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=PARAM_ATOL + PARAM_REL * change)
    jax.tree.map(check, got, want, before)


def test_fusion_loss_matches_jax_at_every_level(rng):
    """Levels of three lengths (``--hier``) against labels of T frames:
    the labels and the frame mask nearest-resized to each."""
    levels = {k: [rng.standard_normal((2, t, n)).astype(np.float32)
                  for t in (T, 12, 3)] for k, n in SIZES.items()}
    labels = {k: (rng.random((T, n)) < 0.3).astype(np.float32)
              for k, n in SIZES.items()}
    fm = (np.arange(T) < 31).astype(np.float32)
    jax_loss = jax.jit(functools.partial(jax_fusion.tcn_multitask_loss,
                                         comp_weight=0.3, pos_weights=POS))
    for mask in (None, fm):
        want = jax_loss(jax.tree.map(jnp.asarray, levels),
                        jax.tree.map(jnp.asarray, labels),
                        frame_mask=None if mask is None
                        else jnp.asarray(mask))
        got = fusion.tcn_multitask_loss(
            jax.tree.map(torch.from_numpy, levels),
            jax.tree.map(torch.from_numpy, labels), comp_weight=0.3,
            pos_weights=POS, frame_mask=None if mask is None
            else torch.from_numpy(mask))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-6, atol=ATOL, err_msg=k)


def test_eval_step_matches_jax(rng):
    jmodel, variables, port = _models()
    x = rng.standard_normal((1, T, IN_DIM)).astype(np.float32)
    jstate = JaxTrainState.create(apply_fn=jmodel.apply,
                                  params=variables["params"],
                                  tx=jax_build_sgd(LR))
    want = jax_make_tcn_eval_step(jmodel)(jstate, jnp.asarray(x))
    state = create_train_state(port, build_sgd(LR), device="cpu")
    got = make_tcn_eval_step(port, device="cpu")(state, x)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=ATOL, err_msg=k)


def test_train_mode_skips_the_kernel_and_eval_calls_it(monkeypatch, rng):
    calls = []
    real = port_tcn.dilated_residual_fused

    def recorder(*args):
        calls.append(args[5])  # the dilation
        return real(*args)
    monkeypatch.setattr(port_tcn, "dilated_residual_fused", recorder)
    model = TemporalTCN(IN_DIM, generator=torch.Generator().manual_seed(0),
                        **KW)
    x = torch.from_numpy(rng.standard_normal((1, T, IN_DIM)).astype(
        np.float32))
    g = torch.Generator().manual_seed(1)
    model.train()(x, apply_mask=True, generator=g)
    assert calls == []
    with torch.no_grad():
        model.eval()(x)
    layers = KW["num_layers_pg"] + KW["num_refinements"] * KW["num_layers_r"]
    assert len(calls) == layers


def _train_features(model, x, seed, apply_mask=True):
    model.train()
    return model(x, apply_mask=apply_mask,
                 generator=torch.Generator().manual_seed(seed))


def test_the_random_parts_by_their_statistics():
    torch.manual_seed(0)
    c, t = 64, 400
    x = torch.ones(4, t, c)
    model = TemporalTCN(c, generator=torch.Generator().manual_seed(0),
                        num_layers_pg=1, num_layers_r=1, num_refinements=0,
                        num_f_maps=8, mask_rate=0.75, channel_dropout=0.5)
    seen = {}
    model.pg_conv_in.register_forward_hook(
        lambda mod, args, out: seen.__setitem__("x", args[0]))
    _train_features(model, x, 5)
    y = seen["x"]
    kept = y != 0
    # input mask keeps 1 - 0.75 of the elements, channel dropout half the
    # channels, each kept value scaled by 1 / (1 - 0.5)
    share = kept.float().mean().item()
    assert abs(share - 0.25 * 0.5) < 0.02
    assert torch.all(y[kept] == 2.0)
    # no input mask: the channel mask alone, constant over T
    _train_features(model, x, 6, apply_mask=False)
    y = seen["x"]
    per_channel = (y != 0).float().mean(dim=1)  # (B, C)
    assert torch.all((per_channel == 0) | (per_channel == 1))
    assert abs(per_channel.mean().item() - 0.5) < 0.1
    # one generator state, one result; another state, another
    a = _train_features(model, x, 7)["ivt"][0]
    b = _train_features(model, x, 7)["ivt"][0]
    c_ = _train_features(model, x, 8)["ivt"][0]
    assert torch.equal(a, b) and not torch.equal(a, c_)


def test_layer_dropout_scales_kept_values():
    layer = port_tcn.DilatedResidualLayer(1, 16, dropout=0.5,
                                          generator=torch.Generator()
                                          .manual_seed(0))
    with torch.no_grad():
        layer.w_taps.zero_()
        layer.w2.zero_()
        layer.b2.fill_(1.0)
    x = torch.zeros(2, 500, 16)
    out = layer.train()(x, torch.Generator().manual_seed(2))
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.5) < 0.02
    assert torch.all(out[kept] == 2.0)
    assert torch.equal(layer.eval()(x), torch.ones_like(x))


VARIANT_FOLDS = [(v, f) for v in ("cholect50", "cholect50-challenge")
                 for f in (None, 1)] + [
    (v, f) for v in ("cholect45-crossval", "cholect50-crossval")
    for f in (None, 1, 2, 3, 4, 5)]


@pytest.mark.parametrize("variant, fold", VARIANT_FOLDS)
def test_weight_balancing_matches_jax(variant, fold):
    assert class_weights.weight_balancing(variant, fold) == \
        jax_cw.weight_balancing(variant, fold)


def test_weight_balancing_refusals():
    with pytest.raises(KeyError):
        jax_cw.weight_balancing("cholect45-crossval", 6)
    with pytest.raises(ValueError, match="folds are 1-5"):
        class_weights.weight_balancing("cholect45-crossval", 6)
    with pytest.raises(ValueError, match="no balancing table"):
        class_weights.weight_balancing("cholect45", 1)
