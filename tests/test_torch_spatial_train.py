"""The port's spatial training step with the student-training slice's
options against the JAX package's step, from the same weights
(``load_jax_variables``) and batch, float32, on the ResNet18
``SpatialCNN`` (train-mode BatchNorm) at batch 4 of 32x56, whose last
stage normalises over 8 values a channel: the metrics and the updated
running statistics within 5e-5 of max(1, |JAX|), the ResNet18 training
forward's bound (tests/test_torch_kd_modules.py; measured 1.3e-5 on the
QAT step's loss), and every updated parameter within 1e-6 plus a share of
its largest update that each option sets from its own reading:

* SAM: 2%. Every parameter read within the 1e-6 floor. The check refuses
  a SAM step that applies the unperturbed gradient (up to 236% of an
  update away), one at rho 0.04 in place of 0.05 (78%), and one whose
  gradient is scaled by 0.8 (20%).
* QAT: 10%, and 50% in layer 4. JAX's jitted fake-quant leaves about 5%
  of the weights one ulp from its own eager policy (which the port follows
  bit for bit); that moved layer 4's update by up to 27.4% and the other
  leaves' by up to 5.0%.

At these shapes float32 rounding can move an update a long way: on other
seeds (1 and 4 of ``np.random.default_rng``) JAX's jitted plain step was
33% and 7% of an update from a float64 step, the port's within 0.01%.

* ``sam_rho`` 0.05 and ``qat`` (``loss_type="ivt"``); before the QAT step,
  at the same weights, the QAT eval step's probabilities and feature at
  atol 5e-5 (the Q2L float32 bound), and unlike the float weights' eval
  (after a step the two packages' weights differ, and any difference may
  move a weight across a quantization boundary).
* The zero-rate case: rates (1, 0, 0) with NaN teacher arrays gives the
  JAX step's finite loss and metric names (no ``soft_loss``, ``kd_loss``).

``loss_type="all"`` at rates (1, 0.5, 0.1) is held one step, driver
against driver, by tests/test_torch_cli_spatial_transformer.py (the Q2L
teacher) and tests/test_torch_cli_spatial_cnn.py (this student). The JAX
side runs jitted, as its trainer does.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_train_step import PW  # noqa: E402

from computervision_codes_tpu.models.spatial_cnn import (
    SpatialCNN as JaxSpatialCNN,
)
from computervision_codes_tpu.train import (
    TrainState as JaxTrainState,
    build_sgd as jax_build_sgd,
    make_spatial_eval_step as jax_eval_step,
    make_spatial_train_step as jax_train_step,
)
from computervision_codes_tpu_torch.models.convert import (
    jax_variables,
    load_jax_variables,
)
from computervision_codes_tpu_torch.models.q2l import TASK_SIZES
from computervision_codes_tpu_torch.models.spatial_cnn import SpatialCNN
from computervision_codes_tpu_torch.train import (
    build_sgd,
    create_train_state,
    make_spatial_eval_step,
    make_spatial_train_step,
)
from computervision_codes_tpu_torch.train import trainer

TEACHER_DIM = 24
STATS_REL = METRIC_REL = 5e-5
# the share of a parameter's update the port may be off, by option (see
# the docstring for the readings); LAYER4_REL for QAT's layer 4
PARAM_REL = {"sam": 0.02, "qat": 0.1}
LAYER4_REL = {"sam": 0.02, "qat": 0.5}
EVAL_ATOL = 5e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch work on one thread: under the suite's parallel
    workers, torch's default of one thread per core oversubscribes the
    host, and tiny ops then wait on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(rng, b, h, w, teacher_dim=TEACHER_DIM):
    batch = {"image": rng.standard_normal((b, h, w, 3)).astype(np.float32)}
    for k, n in TASK_SIZES.items():
        batch[f"label_{k}"] = (rng.random((b, n)) < 0.3).astype(np.float32)
    for k in ("i", "v", "t"):
        batch[f"teacher_pred_{k}"] = (rng.standard_normal(
            (b, TASK_SIZES[k])) * 2).astype(np.float32)
        batch[f"teacher_feat_{k}"] = rng.standard_normal(
            (b, teacher_dim)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _jax_variables(loss_type, teacher_dim):
    """The JAX student's variables: those of a seeded port student (the
    JAX init's tree, without compiling that init)."""
    return jax_variables(SpatialCNN(
        "resnet18", loss_type=loss_type, teacher_dim=teacher_dim,
        generator=torch.Generator().manual_seed(0)))


def _assert_metrics(metrics, jmetrics):
    assert set(metrics) == set(jmetrics), (sorted(metrics), sorted(jmetrics))
    for k, v in metrics.items():
        want = float(jmetrics[k])
        assert abs(v.item() - want) <= METRIC_REL * max(1.0, abs(want)), k


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _student_pair(rng, loss_type, teacher_dim=TEACHER_DIM, wd=1e-5):
    batch = _batch(rng, 4, 32, 56, teacher_dim)
    jmodel = JaxSpatialCNN(network="resnet18", loss_type=loss_type,
                           teacher_dim=teacher_dim)
    variables = _jax_variables(loss_type, teacher_dim)
    jstate = JaxTrainState.create(
        apply_fn=jmodel.apply,
        params=jax.tree.map(jnp.asarray, variables["params"]),
        tx=jax_build_sgd(1e-2, weight_decay=wd),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        rng=jax.random.fold_in(jax.random.PRNGKey(0), 1))
    model = SpatialCNN("resnet18", loss_type=loss_type,
                       teacher_dim=teacher_dim)
    load_jax_variables(model, variables)
    state = create_train_state(model, build_sgd(1e-2, weight_decay=wd),
                               device="cpu")
    return batch, jmodel, jstate, variables, model, state


def _assert_student_close(state, jstate, variables, option):
    got = jax_variables(state.model)
    want = {"params": jstate.params, "batch_stats": jstate.batch_stats}
    for coll in ("params", "batch_stats"):
        before = dict(_leaves(variables[coll]))
        w_leaves = dict(_leaves(jax.tree.map(np.asarray, want[coll])))
        g_leaves = dict(_leaves(got[coll]))
        assert set(g_leaves) == set(w_leaves), coll
        for path, w in w_leaves.items():
            g, b = g_leaves[path], before[path]
            if coll == "params":
                rel = (LAYER4_REL if path[:2] in {("backbone", "layer4_0"),
                                                  ("backbone", "layer4_1")}
                       else PARAM_REL)[option]
                atol = 1e-6 + rel * np.abs(w - b).max()
            else:
                atol = STATS_REL * max(1.0, float(np.abs(w).max()))
                assert not np.array_equal(w, b), path  # the step moved it
            np.testing.assert_allclose(g, w, atol=atol,
                                       err_msg="/".join(path))


@pytest.mark.parametrize("option", ["sam", "qat"])
def test_student_sam_and_qat_steps_match_jax(rng, option):
    kw = {"sam_rho": 0.05} if option == "sam" else {"qat": True}
    batch, jmodel, jstate, variables, model, state = _student_pair(rng, "ivt")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if option == "qat":  # the eval steps first, at the same weights
        want_probs, want_feat = jax_eval_step(jmodel, qat=True)(
            jstate, jb["image"])
        probs, feat = make_spatial_eval_step(model, qat=True, device="cpu")(
            state, batch["image"])
        np.testing.assert_allclose(feat.numpy(), np.asarray(want_feat),
                                   atol=EVAL_ATOL)
        for k in TASK_SIZES:
            np.testing.assert_allclose(probs[k].numpy(),
                                       np.asarray(want_probs[k]),
                                       atol=EVAL_ATOL, err_msg=k)
        # the QAT eval differs from the float weights' eval
        float_probs, _ = make_spatial_eval_step(model, device="cpu")(
            state, batch["image"])
        assert not torch.equal(float_probs["ivt"], probs["ivt"])
    jstate, jmetrics = jax_train_step(jmodel, "ivt", pos_weights=PW, **kw)(
        jstate, jb)
    state, metrics = make_spatial_train_step(
        model, "ivt", pos_weights=PW, device="cpu", **kw)(state, batch)
    _assert_metrics(metrics, jmetrics)
    _assert_student_close(state, jstate, variables, option)


@pytest.mark.parametrize("fault", ["unperturbed", "rho 0.04",
                                   "gradient x 0.8"])
def test_sam_check_refuses_a_wrong_sam_step(rng, monkeypatch, fault):
    """Port steps that get SAM wrong against JAX's SAM step at rho 0.05
    fail the SAM check: the unperturbed gradient (rho 0), rho 0.04, and the
    SAM gradient scaled by 0.8 (an update 20% short, which a bound of half
    an update would pass)."""
    rho = {"unperturbed": 0.0, "rho 0.04": 0.04}.get(fault, 0.05)
    if fault == "gradient x 0.8":
        sam = trainer.sam_gradients

        def short(*args, **kw):
            grads, aux = sam(*args, **kw)
            return [None if g is None else 0.8 * g for g in grads], aux

        monkeypatch.setattr(trainer, "sam_gradients", short)
    batch, jmodel, jstate, variables, model, state = _student_pair(rng, "ivt")
    jstate, _ = jax_train_step(jmodel, "ivt", pos_weights=PW, sam_rho=0.05)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state, _ = make_spatial_train_step(model, "ivt", pos_weights=PW,
                                       device="cpu", sam_rho=rho)(state,
                                                                  batch)
    with pytest.raises(AssertionError):
        _assert_student_close(state, jstate, variables, "sam")


def test_zero_rate_terms_ignore_nonfinite_teachers(rng):
    batch, jmodel, jstate, variables, model, state = _student_pair(
        rng, "all", wd=0.0)
    for k in ("i", "v", "t"):
        batch[f"teacher_pred_{k}"][:] = np.nan
        batch[f"teacher_feat_{k}"][:] = np.nan
    rates = (1.0, 0.0, 0.0)
    jstate, jmetrics = jax_train_step(jmodel, "all", rates, pos_weights=PW)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state, metrics = make_spatial_train_step(
        model, "all", rates, pos_weights=PW, device="cpu")(state, batch)
    assert np.isfinite(metrics["loss"].item())
    assert "soft_loss" not in metrics and "kd_loss" not in metrics
    _assert_metrics(metrics, jmetrics)
    assert all(bool(torch.isfinite(p).all())
               for p in state.model.parameters())
