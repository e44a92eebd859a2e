"""The port's training step of the spatial track against the JAX package's.

* ``bce_with_logits`` with pos-weights, element weights and each reduction,
  float32 at rtol 1e-6 (the same formula in the same order).
* ``reference_warmup_exp_schedule`` across the warmup, the peak and the
  decay, rtol 1e-6 (JAX computes in float32, the port in float64).
* ``build_sgd``: three updates under a schedule against optax's, with and
  without weight decay and momentum, rtol 1e-6.
* One ``make_spatial_train_step`` of ``Q2L("swin_nano_64", fused_train=True,
  remat=True)`` (K6's plain versions on the CPU) from the same weights
  (``load_jax_variables``) and batch as the JAX step of the XLA path
  (``fused_train=False``; JAX's own test holds its fused path to it), drop
  rates 0 on both sides (JAX's transformer dropout swapped to 0 in this
  process): the loss and the four ``hard_loss_*`` metrics at rtol 1e-5;
  every updated parameter within 1e-6 plus 1% of its largest update (one
  SGD update at lr 1e-2), but for one unit per FFN layer (below); for loss
  "i" also the eval step's probabilities and feature, at the weights before
  the update, at atol 5e-5; for loss "all" with rates (1, 0, 0) the
  ``hard_loss`` metric too.

A unit of a Q2L FFN whose pre-activation lies within float32 noise of 0
can switch its ReLU between the two packages (their sums run in another
order); the gradient of its column of ``linear1``'s kernel and of its bias
entry then differs by a whole term, and every gradient upstream of it (the
backbone's) by a small echo of that term: hence the 1% of the update, and
in each ``linear1`` at most one unit beyond the bound.

The JAX side runs jitted, as its trainer does (its variables from a jitted
``init``, then the state ``create_train_state`` makes; remat is off there,
which changes no value).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervision_codes_tpu.losses.bce import (
    TARGET_POS_WEIGHT as JAX_TARGET_PW,
    TOOL_POS_WEIGHT as JAX_TOOL_PW,
    VERB_POS_WEIGHT as JAX_VERB_PW,
    bce_with_logits as jax_bce,
)
from computervision_codes_tpu.models import q2l as jax_q2l
from computervision_codes_tpu.train import (
    TrainState as JaxTrainState,
    build_sgd as jax_build_sgd,
    make_spatial_eval_step as jax_eval_step,
    make_spatial_train_step as jax_train_step,
    reference_warmup_exp_schedule as jax_schedule,
)
from computervision_codes_tpu_torch.losses import (
    TARGET_POS_WEIGHT,
    TOOL_POS_WEIGHT,
    VERB_POS_WEIGHT,
    bce_with_logits,
)
from computervision_codes_tpu_torch.models.common import Dropout
from computervision_codes_tpu_torch.models.convert import load_jax_variables
from computervision_codes_tpu_torch.models.q2l import Q2L, TASK_SIZES
from computervision_codes_tpu_torch.train import (
    build_sgd,
    create_train_state,
    make_spatial_eval_step,
    make_spatial_train_step,
    reference_warmup_exp_schedule,
)

PW = {"i": TOOL_POS_WEIGHT, "v": VERB_POS_WEIGHT, "t": TARGET_POS_WEIGHT}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch work on one thread: under the suite's parallel
    workers, torch's default of one thread per core oversubscribes the
    host, and tiny ops then wait on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_pos_weights_match_jax():
    assert (TOOL_POS_WEIGHT, VERB_POS_WEIGHT, TARGET_POS_WEIGHT) == (
        JAX_TOOL_PW, JAX_VERB_PW, JAX_TARGET_PW)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_bce_with_logits_matches_jax(rng, reduction):
    logits = (rng.standard_normal((4, 15)) * 6).astype(np.float32)
    targets = (rng.random((4, 15)) < 0.4).astype(np.float32)
    weight = rng.random(15).astype(np.float32)
    for pw, w in ((None, None), (TARGET_POS_WEIGHT, None),
                  (TARGET_POS_WEIGHT, weight)):
        want = jax_bce(jnp.asarray(logits), jnp.asarray(targets), pw, w,
                       reduction)
        got = bce_with_logits(torch.from_numpy(logits),
                              torch.from_numpy(targets), pw,
                              None if w is None else torch.from_numpy(w),
                              reduction)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
    with pytest.raises(ValueError, match="reduction"):
        bce_with_logits(torch.zeros(1), torch.zeros(1), reduction="max")


def test_schedule_matches_jax():
    args = (0.01, 0.1, 3, 0.9, 5)  # peak, power, warmup epochs, decay, spe
    want = jax_schedule(*args)
    got = reference_warmup_exp_schedule(*args)
    steps = range(0, 60, 2)  # warmup (epochs 0-3), the peak (4), decay
    np.testing.assert_allclose([got(s) for s in steps],
                               [float(want(s)) for s in steps], rtol=1e-6)
    assert got(20) == pytest.approx(0.1)  # epoch 4 = warmup + 1: the peak


@pytest.mark.parametrize("weight_decay, momentum",
                         [(0.0, 0.0), (1e-2, 0.0), (1e-2, 0.9)])
def test_build_sgd_matches_optax(rng, weight_decay, momentum):
    sched = (0.1, 0.5, 1, 0.5, 1)  # lr 0.1, 0.2, 0.2 at updates 0, 1, 2
    params = [rng.standard_normal((3, 4)).astype(np.float32),
              rng.standard_normal(5).astype(np.float32)]
    grads = [[rng.standard_normal(p.shape).astype(np.float32)
              for p in params] for _ in range(3)]
    tx = jax_build_sgd(jax_schedule(*sched), weight_decay, momentum)
    jparams = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = build_sgd(reference_warmup_exp_schedule(*sched), weight_decay,
                    momentum)(tparams)
    for g in grads:
        updates, opt_state = tx.update([jnp.asarray(a) for a in g],
                                       opt_state, jparams)
        jparams = [p + u for p, u in zip(jparams, updates)]
        for p, a in zip(tparams, g):
            p.grad = torch.from_numpy(a)
        opt.step()
        for p, want in zip(tparams, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)
    assert opt.count == 3


def _batch(rng, b=2):
    batch = {"image": rng.standard_normal((b, 64, 64, 3)).astype(np.float32)}
    for k, n in TASK_SIZES.items():
        batch[f"label_{k}"] = (rng.random((b, n)) < 0.3).astype(np.float32)
    return batch


def _flax_path(name: str):
    path = name.split(".")
    if path[-2:] == ["patch_embed", "weight"]:
        return tuple(path[:-1] + ["kernel"]), (2, 3, 1, 0)
    return tuple(path), None


def _assert_param_close(name, got, want, before):
    atol = 1e-6 + 1e-2 * np.abs(want - before).max()
    if name.endswith(("linear1.kernel", "linear1.bias")):
        # per FFN unit (the last axis): at most one beyond the bound
        err = np.abs(got - want).reshape(-1, got.shape[-1]).max(0)
        assert (err > atol).sum() <= 1, (name, np.flatnonzero(err > atol))
        return
    np.testing.assert_allclose(got, want, atol=atol, err_msg=name)


@pytest.mark.parametrize("loss_type", ["i", "all"])
def test_train_step_matches_jax(rng, monkeypatch, loss_type):
    monkeypatch.setattr(jax_q2l, "Q2LTransformer", functools.partial(
        jax_q2l.Q2LTransformer, dropout=0.0))
    batch = _batch(rng)
    rates = (1.0, 0.0, 0.0)
    jmodel = jax_q2l.Q2L(backbone="swin_nano_64", loss_type=loss_type,
                         drop_path_rate=0.0, fused_train=False)
    key = jax.random.PRNGKey(0)
    params0 = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        key, jnp.asarray(batch["image"][:1]))["params"])
    jstate = JaxTrainState.create(
        apply_fn=jmodel.apply, params=jax.tree.map(jnp.asarray, params0),
        tx=jax_build_sgd(1e-2, weight_decay=1e-5),
        rng=jax.random.fold_in(key, 1))
    if loss_type == "i":  # the eval steps first, at the same parameters
        want_probs, want_feat = jax_eval_step(jmodel)(
            jstate, jnp.asarray(batch["image"]))
    jstate, jmetrics = jax_train_step(jmodel, loss_type, rates,
                                      pos_weights=PW)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})

    model = Q2L(backbone="swin_nano_64", loss_type=loss_type,
                drop_path_rate=0.0, fused_train=True, remat=True)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    load_jax_variables(model, {"params": params0})
    state = create_train_state(model, build_sgd(1e-2, weight_decay=1e-5),
                               device="cpu")
    if loss_type == "i":
        probs, feat = make_spatial_eval_step(model, device="cpu")(
            state, batch["image"])
        assert not model.training
        np.testing.assert_allclose(feat.numpy(), np.asarray(want_feat),
                                   atol=5e-5)
        for k in TASK_SIZES:
            np.testing.assert_allclose(probs[k].numpy(),
                                       np.asarray(want_probs[k]), atol=5e-5,
                                       err_msg=k)
    step = make_spatial_train_step(model, loss_type, rates, pos_weights=PW,
                                   device="cpu")
    state, metrics = step(state, batch)
    assert state.step == 1 and set(metrics) == set(jmetrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(v.item(), float(jmetrics[k]), rtol=1e-5,
                                   err_msg=k)
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == len(jax.tree_util.tree_leaves(jstate.params))
    for name, p in model.named_parameters():
        path, perm = _flax_path(name)
        want, before = jstate.params, params0
        for key in path:
            want, before = want[key], before[key]
        got = p.detach().numpy()
        _assert_param_close(name, got if perm is None else got.transpose(
            perm), np.asarray(want), before)
