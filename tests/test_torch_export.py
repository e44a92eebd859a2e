"""The port's exported servables: ``export`` / ``load_exported`` of both
sessions, ``cli.export``, and servables that the JAX package wrote.

* The port's round trip is bit for bit: the restored session, rebuilt from
  ``variables.msgpack`` and ``meta.json`` alone (the int8 codes and scales
  as stored, no calibration), predicts and pushes exactly what the
  exported one does, bf16 and int8, offline and streaming; a restored
  session is not exportable again, as in JAX.
* A servable that the JAX session exported (its ``.jaxexport`` programs
  ignored, what its ``meta.json`` lacks inferred from the tree) predicts
  within the bound tests/test_torch_serving.py holds the sessions to
  (bf16: max 0.1 with a correlation above 0.999), int8 offline and bf16
  streaming (the float tree); a tree the port cannot read raises ``ValueError``
  naming what it cannot tell.
* ``cli.export`` from a checkpoint the port wrote holds the checkpoint's
  variables, bit for bit.
"""

import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervision_codes_tpu.models.pipeline import (
    EndToEndRecognizer as JaxRecognizer,
)
from computervision_codes_tpu.serving import InferenceSession as JaxSession
from computervision_codes_tpu.serving import (
    StreamingSession as JaxStreamingSession,
)
from computervision_codes_tpu_torch.cli import export as cli_export
from computervision_codes_tpu_torch.models.convert import jax_variables
from computervision_codes_tpu_torch.models.pipeline import EndToEndRecognizer
from computervision_codes_tpu_torch.serving import (
    InferenceSession,
    StreamingSession,
)
from computervision_codes_tpu_torch.train import build_sgd, create_train_state
from computervision_codes_tpu_torch.train.checkpoint import (
    CheckpointManager,
    checkpoint_path,
    pack_msgpack,
    read_msgpack,
    restore_variables,
)

H, W = 32, 56
SMALL = dict(num_layers_pg=3, num_layers_r=2, num_refinements=1,
             num_f_maps=16)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _assert_bf16_close(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        assert np.corrcoef(got[k].ravel(), want[k].ravel())[0, 1] > 0.999, k
        assert np.abs(got[k] - want[k]).max() < 0.1, k


@pytest.mark.parametrize("quantize", [False, True])
def test_inference_round_trip_is_exact(rng, tmp_path, quantize):
    sess = InferenceSession.create(batch=1, clip_len=4, height=H, width=W,
                                   quantize=quantize, fused_stem=quantize,
                                   device="cpu")
    path = sess.export(str(tmp_path / "servable"))
    assert sorted(os.listdir(path)) == ["meta.json", "variables.msgpack"]
    meta = json.load(open(os.path.join(path, "meta.json")))
    assert meta == dict(batch=1, clip_len=4, height=H, width=W,
                        network="resnet18", quantize=quantize,
                        s2d_stem=False, fused_stem=quantize)
    tree = read_msgpack(os.path.join(path, "variables.msgpack"))
    assert set(tree) == ({"q_backbone", "tcn"} if quantize
                         else {"params", "batch_stats"})
    restored = InferenceSession.load_exported(path, device="cpu")
    clips = rng.integers(0, 256, (1, 4, H, W, 3)).astype(np.uint8)
    _assert_equal(restored.predict(clips), sess.predict(clips))
    with pytest.raises(ValueError, match="not exportable"):
        restored.export(str(tmp_path / "again"))


@pytest.mark.parametrize("quantize", [False, True])
def test_streaming_round_trip_is_exact(rng, tmp_path, quantize):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # context 8 < receptive field
        sess = StreamingSession.create(context=8, height=H, width=W,
                                       quantize=quantize, fused_stem=True,
                                       device="cpu", **SMALL)
    path = sess.export(str(tmp_path / "servable"))
    meta = json.load(open(os.path.join(path, "meta.json")))
    assert meta["dtype"] == "bfloat16" and meta["causal"] is True
    assert meta["receptive_field"] == sess.receptive_field
    restored = StreamingSession.load_exported(path, device="cpu")
    assert restored.buffer.shape == sess.buffer.shape
    for _ in range(3):
        frame = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
        _assert_equal(restored.push(frame), sess.push(frame))
    with pytest.raises(ValueError, match="re-exportable"):
        restored.export(str(tmp_path / "again"))


def _seeded(seed, **kw):
    return jax_variables(EndToEndRecognizer(
        generator=torch.Generator().manual_seed(seed), **kw))


def test_jax_int8_servable_predicts_as_jax(rng, tmp_path):
    """The JAX int8 session's servable: its calibrated codes and scales
    as stored (``fused_stem`` stands in for its stem, which its meta.json
    does not hold). The float tree is read by the streaming case below."""
    kw = dict(batch=1, clip_len=4, height=H, width=W, quantize=True,
              fused_stem=True)
    jsess = JaxSession.create(variables=_seeded(0), **kw)
    path = jsess.export(str(tmp_path / "jax_servable"))
    sess = InferenceSession.load_exported(path, device="cpu",
                                          fused_stem=True)
    backbone = sess.model.backbone
    assert backbone.fused_stem and float(
        backbone.layer1_0.conv1.act_scale) == float(
        jsess.variables["q_backbone"]["layer1_0"]["conv1"]["act_scale"])
    clips = rng.integers(0, 256, (1, 4, H, W, 3)).astype(np.uint8)
    _assert_bf16_close(sess.predict(clips), jsess.predict(clips.copy()))


def test_jax_streaming_servable_pushes_as_jax(rng, tmp_path):
    variables = jax.jit(JaxRecognizer(causal=True, dtype=jnp.bfloat16,
                                      **SMALL).init)(
        jax.random.PRNGKey(5), jnp.zeros((1, 4, H, W, 3), jnp.bfloat16))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsess = JaxStreamingSession.create(context=8, height=H, width=W,
                                           variables=variables, **SMALL)
    path = jsess.export(str(tmp_path / "jax_stream"))
    sess = StreamingSession.load_exported(path, device="cpu")
    assert sess.receptive_field == jsess.receptive_field
    for _ in range(3):
        frame = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
        _assert_bf16_close(sess.push(frame), jsess.push(frame.copy()))


def test_unreadable_trees_name_what_is_missing(tmp_path):
    base = _seeded(0, **SMALL)
    meta = dict(batch=1, clip_len=2, height=H, width=W)

    def write(tree):
        d = tmp_path / f"s{len(os.listdir(tmp_path))}"
        d.mkdir()
        (d / "meta.json").write_text(json.dumps(meta))
        (d / "variables.msgpack").write_bytes(pack_msgpack(tree))
        return str(d)

    odd = {"params": dict(base["params"], backbone={
        k: v for k, v in base["params"]["backbone"].items()
        if k != "layer2_1"}), "batch_stats": base["batch_stats"]}
    with pytest.raises(ValueError, match="cannot tell the network"):
        InferenceSession.load_exported(write(odd), device="cpu")
    tcn = dict(base["params"]["tcn"])
    tcn["refine1"] = {"layer0": tcn["refine0"]["layer0"]}
    ragged = {"params": dict(base["params"], tcn=tcn),
              "batch_stats": base["batch_stats"]}
    with pytest.raises(ValueError, match="cannot tell the TCN"):
        InferenceSession.load_exported(write(ragged), device="cpu")


def test_cli_export_from_a_port_checkpoint(tmp_path):
    """The servable holds the checkpoint's variables exactly (and the
    round trips above restore a servable's session exactly)."""
    model = EndToEndRecognizer(generator=torch.Generator().manual_seed(3))
    state = create_train_state(model, build_sgd(1e-2), device="cpu")
    CheckpointManager(str(tmp_path), "student").save(state)
    out = str(tmp_path / "servable")
    path = cli_export.main(
        ["--ckpt_dir", str(tmp_path), "--modelname", "student", "--out", out,
         "--batch", "1", "--clip_len", "2", "--height", str(H), "--width",
         str(W), "--device", "cpu"])
    assert path == out
    assert json.load(open(os.path.join(out, "meta.json")))["clip_len"] == 2
    want = dict(_leaves(restore_variables(checkpoint_path(str(tmp_path),
                                                          "student"))))
    got = dict(_leaves(read_msgpack(os.path.join(out, "variables.msgpack"))))
    assert set(got) == set(want)
    for path_, w in want.items():
        np.testing.assert_array_equal(got[path_], w, err_msg="/".join(path_))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)
