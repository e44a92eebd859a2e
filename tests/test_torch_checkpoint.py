"""The port's reader and writer of the JAX package's flax-msgpack
checkpoints.

A checkpoint is written by the JAX ``CheckpointManager`` and read back by
the port in a subprocess in which ``import msgpack`` fails (the GPU machine
has no msgpack, flax or JAX): params and batch_stats must come back equal.
Then ``InferenceSession.from_checkpoint`` of both packages serve the same
file. The port's msgpack writer gives flax's ``msgpack_serialize`` bytes
for every kind of object and length a state dict holds, and
``jax_variables`` inverts ``load_jax_variables`` for every module kind
(TrainState files of MS-TCT: ``tests/test_torch_mstct_train.py``).
"""

import contextlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from computervision_codes_tpu.models.pipeline import (
    EndToEndRecognizer as JaxRecognizer,
)
import computervision_codes_tpu.train as jax_train
from computervision_codes_tpu.serving import InferenceSession as JaxSession
from computervision_codes_tpu.train import build_sgd
from computervision_codes_tpu.train.checkpoint import CheckpointManager
from computervision_codes_tpu.train.state import TrainState
from computervision_codes_tpu_torch.models.convert import (
    jax_variables,
    load_jax_variables,
)
from computervision_codes_tpu_torch.models.pipeline import (
    EndToEndRecognizer,
)
from computervision_codes_tpu_torch.serving import InferenceSession
from computervision_codes_tpu_torch.train.checkpoint import (
    checkpoint_path,
    pack_msgpack,
    read_msgpack,
    restore_variables,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEP = "|"

# reads the checkpoint with msgpack, flax and JAX unimportable, and saves
# the flattened trees as .npz
_READER = """
import sys
for name in ("msgpack", "flax", "jax", "jaxlib"):
    sys.modules[name] = None  # import raises ImportError
import numpy as np
from computervision_codes_tpu_torch.train.checkpoint import restore_variables

def flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + k + "{sep}")
        else:
            yield prefix + k, v

variables = restore_variables(sys.argv[1])
np.savez(sys.argv[2], **dict(flat(variables)))
bad = [m for m in sys.modules if m.split(".")[0] in
       ("msgpack", "flax", "jax", "computervision_codes_tpu")
       and sys.modules[m] is not None]
assert not bad, bad
""".replace("{sep}", SEP)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's torch work on one thread: under the suite's parallel
    workers, torch's default of one thread per core oversubscribes the
    host, and tiny ops then wait on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + k + SEP)
        else:
            yield prefix + k, np.asarray(v)


@pytest.fixture(scope="module")
def small_state():
    """A small recognizer's TrainState: ``create_train_state``'s fields,
    with the init jitted (eager takes several times as long)."""
    model = JaxRecognizer(num_layers_pg=2, num_layers_r=2, num_refinements=1,
                          num_f_maps=8, dtype=jnp.bfloat16)
    key = jax.random.PRNGKey(0)
    variables = jax.jit(model.init)(key, jnp.zeros((1, 2, 32, 56, 3),
                                                   jnp.bfloat16))
    return TrainState.create(
        apply_fn=model.apply, params=variables["params"],
        tx=build_sgd(1e-2, momentum=0.9),
        batch_stats=variables["batch_stats"],
        rng=jax.random.fold_in(key, 1))


@pytest.mark.parametrize("save_optimizer", [True, False])
def test_restore_without_msgpack(tmp_path, small_state, save_optimizer):
    state = small_state
    manager = CheckpointManager(str(tmp_path), "student",
                                save_optimizer=save_optimizer)
    path = manager.save(state, tag="latest")
    assert path == checkpoint_path(str(tmp_path), "student", "latest")
    out = tmp_path / "restored.npz"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _READER, path, str(out)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = dict(np.load(out))
    want = dict(_flat({"params": state.params,
                       "batch_stats": state.batch_stats}))
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_rejects_what_it_does_not_read(tmp_path):
    """flax's chunked layout and complex numbers raise ValueError, and so
    does a file that is not a state dict with params."""
    cases = {
        "chunked": {"params": {"w": {"__msgpack_chunked_array__": True,
                                     "shape": {"0": 2}, "chunks": {}}}},
        "complex": {"params": {"w": msgpack.ExtType(2, msgpack.packb(
            (1.0, 2.0)))}},
        "noparams": {"step": 3},
        "notadict": [1, 2],
    }
    for name, tree in cases.items():
        path = tmp_path / f"{name}.msgpack"
        path.write_bytes(msgpack.packb(tree))
        with pytest.raises(ValueError):
            restore_variables(str(path))


def shaped_train_state(model, optimizer, rng, example_inputs,
                       init_kwargs=None):
    """``create_train_state``'s TrainState with zeros in place of the
    init's values: the tree a restore needs (it reads the template's
    structure only), from ``jax.eval_shape`` instead of an eager flax
    init, which takes longer than the sessions."""
    shapes = jax.eval_shape(
        lambda r, *x: model.init(r, *x, **(init_kwargs or {})), rng,
        *example_inputs)
    variables = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    return TrainState.create(
        apply_fn=model.apply, params=variables["params"], tx=optimizer,
        batch_stats=variables.get("batch_stats"),
        frozen=variables.get("frozen"), rng=jax.random.fold_in(rng, 1))


@contextlib.contextmanager
def shaped_templates():
    """JAX ``from_checkpoint`` within the block builds its restore
    template with ``shaped_train_state``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_train, "create_train_state", shaped_train_state)
        yield


def test_from_checkpoint_matches_jax(tmp_path, rng):
    """Both packages serve the same JAX-written TrainState (the default
    recognizer, as JAX ``from_checkpoint`` builds its template at
    (1, 4, H, W, 3) bf16; the template from ``shaped_train_state``).
    Bound: the bf16 cross-check of
    tests/test_torch_serving.py (max 0.1, correlation > 0.999)."""
    h, w = 32, 56
    # create_train_state's fields, the variables the port's seeded
    # recognizer's (an eager flax init takes longer than the sessions)
    variables = jax_variables(EndToEndRecognizer(
        generator=torch.Generator().manual_seed(0)))
    state = TrainState.create(
        apply_fn=JaxRecognizer(dtype=jnp.bfloat16).apply,
        params=variables["params"], tx=build_sgd(1e-2),
        batch_stats=variables["batch_stats"], rng=jax.random.PRNGKey(0))
    CheckpointManager(str(tmp_path), "student").save(state)
    kw = dict(batch=1, clip_len=4, height=h, width=w)
    with shaped_templates():
        jsess = JaxSession.from_checkpoint(str(tmp_path), "student", **kw)
    sess = InferenceSession.from_checkpoint(str(tmp_path), "student",
                                            device="cpu", **kw)
    clips = rng.integers(0, 256, (1, 4, h, w, 3)).astype(np.uint8)
    want = jsess.predict(clips.copy())
    got = sess.predict(clips)
    for k in want:
        assert got[k].shape == want[k].shape
        assert np.corrcoef(got[k].ravel(), want[k].ravel())[0, 1] > 0.999
        assert np.abs(got[k] - want[k]).max() < 0.1, k


def test_writer_matches_flax_msgpack(tmp_path):
    """Every header size: maps of <= 15 and more keys, strings of <= 31
    and more bytes, arrays whose records are fixext, ext8, ext16 and ext32,
    0-d and empty arrays, bfloat16, a numpy scalar (ext type 3), None."""
    rng = np.random.default_rng(0)
    tree = {
        "step": np.asarray(7, np.int32),
        "k" * 40: None,
        "many": {str(i): np.float32(i) for i in range(20)},
        "params": {
            "w": rng.standard_normal((3, 5)).astype(np.float32),
            "big": np.zeros(20000, np.float32),
            "bf": np.ones(9, ml_dtypes.bfloat16),
            "empty": np.zeros((0, 4), np.float32),
            "u": np.arange(2, dtype=np.uint32),
            "bytes": np.zeros(70000, np.uint8)},
        "opt": {"0": {}, "1": {"count": np.asarray(3, np.int32)}},
    }
    data = pack_msgpack(tree)
    assert data == serialization.msgpack_serialize(tree)
    path = tmp_path / "tree.msgpack"
    path.write_bytes(data)
    back = read_msgpack(str(path))
    assert int(back["step"]) == 7 and back["k" * 40] is None
    np.testing.assert_array_equal(back["params"]["w"], tree["params"]["w"])
    with pytest.raises(ValueError):
        pack_msgpack({"x": 1.5})


def test_jax_variables_inverts_load():
    """The student's Conv2d, BatchNorm, 1x1 convolutions and dilated
    layers: exported, loaded into a module made from another seed, equal."""
    kw = dict(num_layers_pg=2, num_layers_r=2, num_refinements=1,
              num_f_maps=8)
    src = EndToEndRecognizer(generator=torch.Generator().manual_seed(0),
                             **kw)
    with torch.no_grad():  # non-trivial BatchNorm statistics
        for name, buf in src.named_buffers():
            buf.copy_(torch.rand(buf.shape) + 0.5)
    variables = jax_variables(src)
    assert set(variables) == {"params", "batch_stats"}
    dst = load_jax_variables(EndToEndRecognizer(
        generator=torch.Generator().manual_seed(1), **kw), variables)
    want = src.state_dict()
    for k, v in dst.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
