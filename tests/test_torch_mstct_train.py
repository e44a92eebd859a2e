"""The port's MS-TCT training against the JAX package's, on the CPU.

* One ``make_mstct_train_step`` from the same weights (``load_jax_variables``)
  and batch as the JAX ``make_mstct_train_step``, float32, at dims 8 and 2
  heads, loss "i" with its pos-weights, SGD under the driver's schedule with
  weight decay. Dropout is off on both sides: the port's module runs in
  ``.train()`` with its two ``Dropout`` rates set to 0 (identity masks);
  the JAX state's ``apply_fn`` is swapped for one that applies at
  ``train=False`` (the JAX code is not edited). The loss at rtol 1e-5, and
  every updated parameter within 1e-6 plus 1% of its largest update (one
  update at lr 1e-2; float32 sums in another order, and no ReLU gate in
  MS-TCT to flip).
* Dropout in ``.train()``: about half the elements kept (0.5 +- 0.01 of
  2^16), scaled by 2; the same generator seed gives the same masks.
* Checkpoints both ways: a TrainState that the port writes (in a process in
  which ``import msgpack``, flax and JAX fail) restores in JAX through
  ``serialization.from_bytes``, params, step and ``count`` equal, and
  its state dict re-serialises (``msgpack_serialize``) to the same bytes;
  the port's state dict has the tree of
  ``serialization.to_state_dict`` of the JAX driver's state; the port
  resumes from what the JAX ``CheckpointManager`` writes, and its next
  step's lr is JAX's schedule at that step.
* Short windows: the JAX step's loss moves when a window is zero-padded to
  its group's longest; the port's step at mixed lengths equals the mean of
  its per-window losses (rtol 1e-6), each of which equals JAX's loss of
  that window alone (rtol 1e-5).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from computervision_codes_tpu.cli import temporal_mstct as jax_driver
from computervision_codes_tpu.models import mstct as jax_mstct
from computervision_codes_tpu.losses import bce_with_logits as jax_bce
from computervision_codes_tpu.train import (
    TrainState as JaxTrainState,
    build_sgd as jax_build_sgd,
    reference_warmup_exp_schedule as jax_schedule,
)
from computervision_codes_tpu.train.checkpoint import (
    CheckpointManager as JaxCheckpointManager,
)
from computervision_codes_tpu_torch.cli import common, temporal_mstct
from computervision_codes_tpu_torch.losses import TOOL_POS_WEIGHT
from computervision_codes_tpu_torch.models import mstct
from computervision_codes_tpu_torch.models.common import Dropout
from computervision_codes_tpu_torch.models.convert import (
    jax_variables,
    load_jax_variables,
)
from computervision_codes_tpu_torch.train import (
    build_sgd,
    create_train_state,
    reference_warmup_exp_schedule,
)
from computervision_codes_tpu_torch.train.checkpoint import (
    CheckpointManager,
    read_msgpack,
    train_state_dict,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IN_DIM, T, CLASSES = 12, 16, 6
KW = dict(embed_dims=(8, 8, 8, 8), num_blocks=1, num_heads=2, mlp_ratio=2.0,
          final_embedding_dim=8, num_classes=CLASSES)
# the driver's schedule (-l 0.01, --power 0.1, -w .. 58, --decay_rate 0.99)
# at 2 steps per epoch, and its weight decay
SCHED = (0.01, 0.1, 58, 0.99)
STEPS_PER_EPOCH, WD = 2, 1e-5
LOSS_RTOL, PARAM_ATOL, PARAM_UPDATE_REL = 1e-5, 1e-6, 1e-2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch work on one thread: under the suite's parallel
    workers, torch's default of one thread per core oversubscribes the
    host, and tiny ops then wait on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX model, its schedule, a train state as ``create_train_state``
    makes it (from a jitted ``init``) whose step applies at ``train=False``
    (no dropout), and the jitted step."""
    model = jax_mstct.MSTCT(**KW)
    sched = jax_schedule(*SCHED, steps_per_epoch=STEPS_PER_EPOCH)
    key = jax.random.PRNGKey(3)
    variables = jax.jit(model.init)(key, jnp.zeros((1, T, IN_DIM)))
    state = JaxTrainState.create(
        apply_fn=lambda v, x, train, rngs: model.apply(v, x, train=False),
        params=variables["params"], tx=jax_build_sgd(sched, WD),
        rng=jax.random.fold_in(key, 1))
    step = jax_driver.make_mstct_train_step(model, "i", TOOL_POS_WEIGHT)
    return model, sched, state, step


def _port_state(variables, device="cpu"):
    """The port's model from the JAX variables, in ``.train()`` with its
    dropout rates 0, and its train state (the same optimizer recipe)."""
    model = load_jax_variables(mstct.MSTCT(IN_DIM, **KW), variables)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    sched = reference_warmup_exp_schedule(
        *SCHED, steps_per_epoch=STEPS_PER_EPOCH)
    return create_train_state(model.train(), build_sgd(sched, WD), seed=0,
                              device=device)


def _batch(rng, lengths):
    return ([rng.standard_normal((t, IN_DIM)).astype(np.float32)
             for t in lengths],
            [(rng.random((t, CLASSES)) < 0.3).astype(np.float32)
             for t in lengths])


def _jax_batch(feats, labels):
    return {"features": jnp.asarray(np.stack(feats)),
            "labels": jnp.asarray(np.stack(labels))}


def test_train_step_matches_jax(rng, jax_side):
    model, _, state, step = jax_side
    feats, labels = _batch(rng, [T, T])
    port = _port_state(jax.device_get({"params": state.params}))
    new_state, m = step(jax.tree.map(jnp.copy, state),
                        _jax_batch(feats, labels))
    port_step = temporal_mstct.make_mstct_train_step(
        port.model, "i", TOOL_POS_WEIGHT, device="cpu")
    port, pm = port_step(port, {"features": feats, "labels": labels})
    np.testing.assert_allclose(float(pm["loss"]), float(m["loss"]),
                               rtol=LOSS_RTOL)
    assert port.step == int(new_state.step) == 1
    assert port.optimizer.count == int(new_state.opt_state[1][1].count) == 1
    got = jax_variables(port.model)["params"]
    old = jax.tree.leaves(state.params)
    want = jax.tree.leaves(new_state.params)
    flat_got = jax.tree.leaves(got)
    assert len(flat_got) == len(want) == len(old)
    for g, w, o in zip(flat_got, want, old):
        w, o = np.asarray(w), np.asarray(o)
        tol = PARAM_ATOL + PARAM_UPDATE_REL * float(np.abs(w - o).max())
        assert float(np.abs(g - w).max()) <= tol


def test_dropout_masks_come_from_the_generator():
    model = mstct.MSTCT(IN_DIM, **KW).train()
    x = torch.ones(1, 2 ** 16 // IN_DIM, IN_DIM)
    drop = model.dropout
    out = drop(x, torch.Generator().manual_seed(5))
    kept = (out != 0).float().mean().item()
    assert abs(kept - 0.5) <= 0.01
    assert set(out.unique().tolist()) == {0.0, 2.0}
    torch.testing.assert_close(drop(x, torch.Generator().manual_seed(5)), out)
    assert not torch.equal(drop(x, torch.Generator().manual_seed(6)), out)
    # the whole model: the same seed gives the same training forward, and
    # it is not the eval forward
    x = torch.randn(2, T, IN_DIM, generator=torch.Generator().manual_seed(0))
    a = model(x, torch.Generator().manual_seed(1))["logits"]
    b = model(x, torch.Generator().manual_seed(1))["logits"]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with torch.no_grad():
        c = model.eval()(x)["logits"]
    assert not torch.allclose(a, c)


# writes a port TrainState in a process where msgpack, flax and JAX do not
# import: the weights from a seed, step and count 3
_WRITER = """
import sys
for name in ("msgpack", "flax", "jax", "jaxlib"):
    sys.modules[name] = None  # import raises ImportError
import torch
from computervision_codes_tpu_torch.models.mstct import MSTCT
from computervision_codes_tpu_torch.train import (
    build_sgd, create_train_state, reference_warmup_exp_schedule)
from computervision_codes_tpu_torch.train.checkpoint import CheckpointManager

model = MSTCT(%d, embed_dims=(8, 8, 8, 8), num_blocks=1, num_heads=2,
              mlp_ratio=2.0, final_embedding_dim=8, num_classes=%d,
              generator=torch.Generator().manual_seed(0))
sched = reference_warmup_exp_schedule(*%r, steps_per_epoch=%d)
state = create_train_state(model, build_sgd(sched, %r), seed=7,
                           device="cpu")
state.step = state.optimizer.count = 3
print(CheckpointManager(sys.argv[1], "mstct").save(state, tag="latest"))
bad = [m for m in sys.modules if m.split(".")[0] in
       ("msgpack", "flax", "jax", "computervision_codes_tpu")
       and sys.modules[m] is not None]
assert not bad, bad
""" % (IN_DIM, CLASSES, SCHED, STEPS_PER_EPOCH, WD)


def test_port_checkpoint_restores_in_jax(tmp_path, jax_side):
    _, _, template, _ = jax_side
    proc = subprocess.run([sys.executable, "-c", _WRITER, str(tmp_path)],
                          cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    path = proc.stdout.strip()
    data = open(path, "rb").read()
    restored = serialization.from_bytes(template, data)
    assert int(restored.step) == 3
    assert int(restored.opt_state[1][1].count) == 3
    key = np.asarray(restored.rng)
    assert key.dtype == np.uint32 and key.shape == (2,)
    model = mstct.MSTCT(IN_DIM, generator=torch.Generator().manual_seed(0),
                        **KW)
    want = jax_variables(model)["params"]
    jax.tree.map(np.testing.assert_array_equal, want,
                 jax.device_get(restored.params))
    # byte for byte what flax's msgpack_serialize writes for the restored
    # state's dict (keys sorted)
    assert serialization.msgpack_serialize(
        serialization.to_state_dict(restored)) == data
    # the port's state dict has the JAX driver's tree
    port = _port_state(jax.device_get({"params": template.params}))
    structure = jax.tree_util.tree_structure
    jax_tree = serialization.to_state_dict(template)
    port_tree = train_state_dict(port)
    assert structure(port_tree) == structure(jax_tree)
    for a, b in zip(jax.tree.leaves(port_tree), jax.tree.leaves(jax_tree)):
        assert np.asarray(a).shape == np.asarray(b).shape
        if not isinstance(b, int):  # a fresh state's step; int32 once stepped
            assert np.asarray(a).dtype == np.asarray(b).dtype


def test_port_resumes_from_jax_checkpoint(tmp_path, rng, jax_side):
    """``maybe_resume`` restores a JAX-written ``_latest``: weights, step
    and count; the next step runs at JAX's schedule of that step."""
    _, sched, state, step = jax_side
    feats, labels = _batch(rng, [T, T])
    batch = _jax_batch(feats, labels)
    state = jax.tree.map(jnp.copy, state)
    for _ in range(3):
        state, _ = step(state, batch)
    JaxCheckpointManager(str(tmp_path), "mstct").save(state, tag="latest")

    port = _port_state(jax.device_get({"params": state.params}))
    with torch.no_grad():  # so the weights must come from the file
        for p in port.model.parameters():
            p.zero_()
    flags = common.common_parser("t").parse_args(["--data_dir", ".",
                                                  "--resume"])
    manager = CheckpointManager(str(tmp_path), "mstct")
    port = common.maybe_resume(flags, manager, port, _Log())
    assert port.step == 3 and port.optimizer.count == 3
    jax.tree.map(np.testing.assert_array_equal,
                 jax_variables(port.model)["params"],
                 jax.device_get(state.params))
    port_step = temporal_mstct.make_mstct_train_step(
        port.model, "i", TOOL_POS_WEIGHT, device="cpu")
    port, _ = port_step(port, {"features": feats, "labels": labels})
    np.testing.assert_allclose(port.optimizer.param_groups[0]["lr"],
                               float(sched(3)), rtol=1e-6)
    assert port.step == 4
    # what the port writes next reads back with the port's reader too
    manager.save(port, tag="latest")
    tree = read_msgpack(manager.path("latest"))
    assert int(tree["step"]) == 4
    assert int(tree["opt_state"]["1"]["1"]["count"]) == 4


class _Log:
    def log(self, msg):
        self.last = msg


def test_short_windows(rng, jax_side):
    """A 10-frame window beside a 16-frame one: zero-padding it moves the
    JAX step's loss away from the mean of the two windows' losses; the
    port's step at the two lengths is that mean."""
    model, _, state, step = jax_side
    feats, labels = _batch(rng, [T, 10])
    padded = [np.pad(a, ((0, T - len(a)), (0, 0))) for a in feats]
    padded_labels = [np.pad(a, ((0, T - len(a)), (0, 0))) for a in labels]
    _, m = step(jax.tree.map(jnp.copy, state),
                _jax_batch(padded, padded_labels))

    @jax.jit
    def jax_loss(params, x, y):
        out = model.apply({"params": params}, x, train=False)
        return jax_bce(out["logits"], y, pos_weight=TOOL_POS_WEIGHT)

    jax_each = [float(jax_loss(state.params, f[None], y[None]))
                for f, y in zip(feats, labels)]
    assert abs(float(m["loss"]) - np.mean(jax_each)) > 1e-3

    params = jax.device_get({"params": state.params})

    def port_loss(fs, ys):
        port = _port_state(params)
        port_step = temporal_mstct.make_mstct_train_step(
            port.model, "i", TOOL_POS_WEIGHT, device="cpu")
        return float(port_step(port, {"features": fs, "labels": ys})[1][
            "loss"])

    each = [port_loss([f], [y]) for f, y in zip(feats, labels)]
    np.testing.assert_allclose(each, jax_each, rtol=LOSS_RTOL)
    np.testing.assert_allclose(port_loss(feats, labels), np.mean(each),
                               rtol=1e-6)
