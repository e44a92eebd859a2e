"""The port's sequence parallelism against the JAX package's, at 2 and 4
ranks.

The port's side runs in a spawned gloo group per world size (one torch
thread a rank, ``tests/torch_parallel_workers.py``, which never imports
JAX); the JAX side runs here on a virtual submesh of as many devices
(``make_mesh(devices=jax.devices()[:n])``). Both take the same seeded numpy
inputs and the same weights (drawn by the port from a seed and carried to
JAX by ``models.convert.jax_variables``). Tolerances: float32 at atol
2e-5, as JAX's own ``tests/test_parallel.py`` holds its sharded functions
(the halo exchange and the gathers, which only move values, exactly).
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

import torch_parallel_workers as workers
from computervision_codes_tpu.models.mstct import MSTCT as JaxMSTCT
from computervision_codes_tpu.models.tcn import TemporalTCN as JaxTCN
from computervision_codes_tpu.parallel import context as jctx
from computervision_codes_tpu.parallel.long_video import eval_sharded
from computervision_codes_tpu.parallel.mesh import make_mesh
from computervision_codes_tpu.parallel.ring_attention import ring_attention
from computervision_codes_tpu_torch.models import moco
from computervision_codes_tpu_torch.models.convert import jax_variables
from computervision_codes_tpu_torch.models.mstct import MSTCT
from computervision_codes_tpu_torch.models.tcn import TemporalTCN

ATOL = 2e-5
MSTCT_KW = dict(embed_dims=(8, 8, 8, 8), num_blocks=1, num_heads=2,
                mlp_ratio=1.0, final_embedding_dim=8, num_classes=5)
# the deep TCNs' dilations (32, 64) pass a shard of 16 or 32 frames: their
# halos come from more ranks than the neighbours
TCNS = {"tcn": dict(num_layers_pg=3, num_layers_r=2, num_refinements=2),
        "tcn_deep": dict(num_layers_pg=7, num_layers_r=6, num_refinements=1),
        "tcn_causal": dict(num_layers_pg=7, num_layers_r=2,
                           num_refinements=1, causal=True)}
TCN_COMMON = dict(num_f_maps=8, num_classes=5, channel_dropout=0.0)
FAR_HALOS = ((11, 7), (0, 5), (20, 0), (1, 1))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    f32 = np.float32
    inp = {}
    for x in "qkv":
        inp[f"attn_{x}"] = rng.standard_normal((1, 2, 64, 16)).astype(f32)
        inp[f"ring_{x}"] = rng.standard_normal((2, 3, 64, 16)).astype(f32)
    inp["conv_x"] = rng.standard_normal((2, 64, 8)).astype(f32)
    inp["conv_w"] = (rng.standard_normal((3, 8, 8)) * 0.1).astype(f32)
    inp["conv_b"] = (rng.standard_normal(8) * 0.1).astype(f32)
    inp["conv_d"] = 4
    inp["halo_x"] = rng.standard_normal((2, 64, 3)).astype(f32)
    inp["halo"] = 5
    inp["far_x"] = rng.standard_normal((1, 16, 2)).astype(f32)
    inp["far_halos"] = FAR_HALOS
    inp["keys_k"] = rng.standard_normal((16, 4)).astype(f32)
    inp["keys_l"] = rng.integers(0, 100, 16).astype(np.int32)
    inp["keys_v"] = (rng.random(16) < 0.7).astype(f32)
    feats = rng.standard_normal((1, 64, 12)).astype(f32)
    inp["feats"] = feats
    # weights drawn by the port from a seed, carried to JAX by the exporter
    # (no JAX init to trace)
    gen = torch.Generator().manual_seed(0)
    inp["mstct_vars"] = jax_variables(MSTCT(12, generator=gen, **MSTCT_KW))
    inp["mstct_in"] = 12
    inp["mstct_kw"] = MSTCT_KW
    inp["tcn_feats"] = feats
    inp["tcn_in"] = 12
    inp["tcn_keys"] = tuple(TCNS)
    for key, kw in dict(TCNS, tcn_hier=dict(hier=True, **TCNS["tcn"])
                        ).items():
        inp[f"{key}_kw"] = dict(kw, **TCN_COMMON)
        inp[f"{key}_vars"] = jax_variables(
            TemporalTCN(12, generator=gen, **kw, **TCN_COMMON))
    return inp


@pytest.fixture(scope="module", params=[2, 4])
def group(request, inputs, tmp_path_factory):
    """{rank: results} of one gloo group of ``n`` ranks over every case."""
    n = request.param
    d = tmp_path_factory.mktemp(f"ctx{n}")
    with open(d / "in.pkl", "wb") as fh:
        pickle.dump(inputs, fh)
    return n, workers.spawn(str(d), workers.CONTEXT, n)


def _result(group, case):
    n, out = group
    res = [out[r][case] for r in range(n)]
    for r in res:
        assert "error" not in r, r.get("error")
    return n, res


def _seq_mesh(n):
    return make_mesh(n_data=1, n_seq=n, devices=jax.devices()[:n])


def test_sequence_parallel_attention(group, inputs):
    n, res = _result(group, "attention")
    q, k, v = (jnp.asarray(inputs[f"attn_{x}"]) for x in "qkv")
    want = np.asarray(jctx.sequence_parallel_attention(q, k, v, _seq_mesh(n)))
    for r in res:
        np.testing.assert_allclose(r["out"], want, atol=ATOL)


def test_ring_attention(group, inputs):
    n, res = _result(group, "ring")
    q, k, v = (jnp.asarray(inputs[f"ring_{x}"]) for x in "qkv")
    want = np.asarray(ring_attention(q, k, v, _seq_mesh(n)))
    for r in res:
        np.testing.assert_allclose(r["out"], want, atol=ATOL)


def test_sequence_parallel_dilated_conv(group, inputs):
    n, res = _result(group, "dilated_conv")
    want = np.asarray(jctx.sequence_parallel_dilated_conv(
        jnp.asarray(inputs["conv_x"]), jnp.asarray(inputs["conv_w"]),
        jnp.asarray(inputs["conv_b"]), inputs["conv_d"], _seq_mesh(n)))
    for r in res:
        np.testing.assert_allclose(r["out"], want, atol=ATOL)


def test_halo_exchange(group, inputs):
    """Each rank's extended shard, concatenated in rank order, is JAX's
    per-device output, exactly; a halo past the neighbour raises."""
    n, res = _result(group, "halo")
    halo = inputs["halo"]
    fn = shard_map(lambda x: jctx.halo_exchange(x, halo, "seq"),
                   mesh=_seq_mesh(n), in_specs=P(None, "seq"),
                   out_specs=P(None, "seq"), check_rep=False)
    want = np.asarray(fn(jnp.asarray(inputs["halo_x"])))
    for r in res:
        np.testing.assert_array_equal(r["out"], want)
        assert "exceeds the local length" in r["too_far"]


def test_gather_halo_spans_ranks(group, inputs):
    """Halos longer than a shard come from as many ranks as they span:
    every rank's [left | shard | right] is the zero-padded sequence's
    window, exactly."""
    n, res = _result(group, "gather_halo")
    x = inputs["far_x"][0]
    t = x.shape[0] // n
    for left, right in FAR_HALOS:
        padded = np.pad(x, ((left, right), (0, 0)))
        want = np.stack([padded[r * t:(r + 1) * t + left + right]
                         for r in range(n)])
        for r in res:
            np.testing.assert_array_equal(r[f"{left}_{right}"][:, 0], want)


def test_all_gather_keys(group, inputs):
    n, res = _result(group, "gather_keys")
    for r in res:
        np.testing.assert_array_equal(r["k"], inputs["keys_k"])
        np.testing.assert_array_equal(r["l"], inputs["keys_l"])
        np.testing.assert_array_equal(r["v"], inputs["keys_v"])


def test_enqueue_gathers_over_the_data_group(group, inputs):
    """Every rank's queue, enqueued with its own anchors under the data
    group, is the single-process queue enqueued with the whole batch."""
    n, res = _result(group, "enqueue")
    queue = moco.init_queue(torch.Generator().manual_seed(3), 32, 4, "cpu")
    moco.enqueue(queue, *(torch.from_numpy(inputs[f"keys_{x}"])
                          for x in ("k", "l", "v")))
    for r in res:
        for key in ("feats", "l_ivt", "ptr"):
            np.testing.assert_array_equal(
                r[key], getattr(queue, key).float().numpy())


_TCN_WANT = {}


def _tcn_want(inputs):
    """The TCNs' unsharded JAX forward (JAX's own tests hold its GSPMD
    sharding to it), made once for both world sizes."""
    if not _TCN_WANT:
        feats = jnp.asarray(inputs["feats"])
        for key, kw in TCNS.items():
            jt = JaxTCN(**kw, **TCN_COMMON)
            _TCN_WANT[key] = jax.jit(jt.apply)(inputs[f"{key}_vars"], feats)
    return _TCN_WANT


def test_eval_sharded_mstct_and_tcn(group, inputs):
    """MS-TCT (gathered attention; the ring by ``ring_mesh``, in
    ``eval_sharded`` and on the whole input) and the TCNs (the deep ones'
    halos spanning ranks, the causal one's on the left only) under the
    port's written-out sequence sharding match JAX's GSPMD-sharded
    forward (the TCNs: JAX's unsharded forward, which its GSPMD sharding
    equals); the ``hier`` TCN raises."""
    n, res = _result(group, "eval_sharded")
    mesh = _seq_mesh(n)
    feats = jnp.asarray(inputs["feats"])
    jm = JaxMSTCT(**MSTCT_KW)
    mv = inputs["mstct_vars"]
    want = {"gather": np.asarray(eval_sharded(
        lambda v, x: jm.apply(v, x)["logits"], mv, feats, mesh))}
    ring = jm.clone(ring_mesh=mesh)
    want["ring"] = np.asarray(eval_sharded(
        lambda v, x: ring.apply(v, x)["logits"], mv, feats, mesh))
    tcn_want = _tcn_want(inputs)
    for r in res:
        np.testing.assert_allclose(r["mstct_gather"], want["gather"],
                                   atol=ATOL)
        for k in ("mstct_ring", "mstct_ring_whole"):
            np.testing.assert_allclose(r[k], want["ring"], atol=ATOL,
                                       err_msg=k)
        for key in TCNS:
            for task in ("ivt", "i", "v", "t"):
                for level, (g, w) in enumerate(zip(r[key][task],
                                                   tcn_want[key][task])):
                    np.testing.assert_allclose(
                        g, np.asarray(w), atol=ATOL,
                        err_msg=f"{key} {task}[{level}]")
        assert "hier=True" in r["hier_error"]
