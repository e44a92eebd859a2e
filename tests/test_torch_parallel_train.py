"""The port's data, tensor and pipeline parallelism against the JAX
package's single-device results, at 2 and 4 ranks.

The port's side runs in a spawned gloo group per world size
(``tests/torch_parallel_workers.py``: torch only, one thread a rank); the
JAX side here, jitted. Weights are drawn by the port from a seed and
carried to JAX by ``models.convert.jax_variables``.

* The mesh: ``make_mesh`` refuses a world it does not cover, with JAX's
  "needs N devices, have M"; ``shard_batch``, the ``seq`` placement and
  ``replicate`` (rank 0's values, a module's in place).
* Data parallelism: one step of the ResNet18 student (train-mode
  BatchNorm) with each rank on its 1/n of a batch of 8, against JAX's
  single-device step on the whole batch, within the bounds
  tests/test_torch_cli_spatial_cnn.py holds one device to (the metrics and
  running statistics within 5e-5 of max(1, |JAX|), every parameter within
  1e-6 plus 10% of its update, 50% in layer 4); the SAM step (the global
  gradient's norm) against the port's single-device SAM step on the whole
  batch (held to JAX by tests/test_torch_spatial_train.py), in the same
  bounds. Over a one-rank data axis the step is the single-device step
  bit for bit.
* Tensor parallelism: the nano Q2L on a (n / 2, 1, 2) mesh. Every
  parameter's placement is JAX's ``tp_shardings`` and the split leaves
  count as JAX's; the eval before training at atol 5e-5; two steps of SGD
  with momentum 0.9 (the momentum kept on the local shards) against JAX's
  two single-device steps at drop rates 0: the metrics at rtol 1e-5 and
  every parameter, gathered, within the bound of
  tests/test_torch_train_step.py (1e-6 plus 1% of its update, one unit a
  ``linear1`` beyond it).
* Pipeline parallelism: 8 residual MLP layers over 2 or 4 stages (and on
  a 2 x 2 data x model mesh) at 2 and 4 microbatches, the output and the
  gradients of the input and of every layer against the sequential loop
  and ``jax.grad``; a Swin stage's two shift pairs over 2 stages against
  JAX's ``SwinBlock``s in order; float32 at atol 2e-5 (as JAX's own
  tests/test_pipeline_parallel.py), and the divisibility errors.
"""

import functools
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_workers as workers  # noqa: E402
from test_torch_train_step import PW, _assert_param_close  # noqa: E402
from test_torch_train_step import _flax_path  # noqa: E402

from computervision_codes_tpu.models import q2l as jax_q2l
from computervision_codes_tpu.models.spatial_cnn import (
    SpatialCNN as JaxSpatialCNN,
)
from computervision_codes_tpu.models.swin import SwinBlock as JaxSwinBlock
from computervision_codes_tpu.parallel.mesh import make_mesh
from computervision_codes_tpu.parallel.tp import (
    shard_params_tp as jax_shard_params_tp,
    sharded_leaf_count as jax_sharded_leaf_count,
    tp_shardings as jax_tp_shardings,
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
from computervision_codes_tpu_torch.models.q2l import TASK_SIZES, Q2L
from computervision_codes_tpu_torch.models.spatial_cnn import SpatialCNN
from computervision_codes_tpu_torch.models.swin import SwinTransformer
from computervision_codes_tpu_torch.parallel.mesh import launch
from computervision_codes_tpu_torch.train import (
    build_sgd,
    create_train_state,
    make_spatial_train_step,
)

TEACHER_DIM = 24
STATS_REL = METRIC_REL = 5e-5
PARAM_REL, LAYER4_REL = 0.1, 0.5
EVAL_ATOL = 5e-5
ATOL = 2e-5
RANKS_TIMEOUT = 150  # s: a spawned group past it is killed, and fails
SWIN_KW = dict(embed_dim=16, depths=(1, 1, 4, 1), num_heads=(1, 2, 4, 8),
               window_size=4, drop_path_rate=0.0, fused_eval=False)
PW_NP = {k: np.asarray(v, np.float32) for k, v in PW.items()}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _labels(rng, b):
    return {f"label_{k}": (rng.random((b, n)) < 0.3).astype(np.float32)
            for k, n in TASK_SIZES.items()}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    f32 = np.float32
    gen = torch.Generator().manual_seed(0)
    inp = {"batch_x": rng.standard_normal((8, 4, 3)).astype(f32),
           "teacher_dim": TEACHER_DIM, "pw": PW_NP}
    inp["dp_batch"] = dict(
        image=rng.standard_normal((8, 32, 56, 3)).astype(f32),
        **_labels(rng, 8))
    inp["dp_vars"] = jax_variables(SpatialCNN(
        "resnet18", loss_type="ivt", teacher_dim=TEACHER_DIM, generator=gen))
    inp["tp_batch"] = dict(
        image=rng.standard_normal((4, 64, 64, 3)).astype(f32),
        **_labels(rng, 4))
    inp["tp_params"] = jax_variables(Q2L(
        backbone="swin_nano_64", loss_type="i", drop_path_rate=0.0,
        generator=gen))["params"]
    inp["pp_layers"] = [
        {"w": (rng.standard_normal((16, 16)) * 0.3).astype(f32),
         "b": (rng.standard_normal(16) * 0.1).astype(f32)}
        for _ in range(8)]
    inp["pp_x"] = rng.standard_normal((8, 3, 16)).astype(f32)
    inp["swin_kw"] = SWIN_KW
    inp["swin_params"] = jax_variables(SwinTransformer(
        **SWIN_KW, generator=gen))["params"]
    inp["swin_x"] = rng.standard_normal((4, 8, 8, 64)).astype(f32)
    return inp


@pytest.fixture(scope="module", params=[2, 4])
def group(request, inputs, tmp_path_factory):
    n = request.param
    d = tmp_path_factory.mktemp(f"train{n}")
    with open(d / "in.pkl", "wb") as fh:
        pickle.dump(inputs, fh)
    return n, workers.spawn(str(d), workers.TRAIN, n)


def _result(group, case):
    n, out = group
    res = [out[r][case] for r in range(n)]
    for r in res:
        assert "error" not in r, r.get("error")
    return n, res


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_mesh_placements(group, inputs):
    n, res = _result(group, "mesh")
    x = inputs["batch_x"]
    step = len(x) // n
    for rank, r in enumerate(res):
        assert f"needs {n + 1} devices, have {n}" in r["too_big"]
        assert "covers 1 of the group's" in r["too_small"]
        assert r["sizes"] == [n, 1, 1]
        np.testing.assert_array_equal(r["shard"]["x"],
                                      x[rank * step:(rank + 1) * step])
        np.testing.assert_array_equal(
            r["seq_slice"], x[:, rank * 4 // n:(rank + 1) * 4 // n])
        np.testing.assert_array_equal(r["replicated"], np.zeros(3))
        np.testing.assert_array_equal(r["module"], np.zeros((2, 2)))


# ---------------------------------------------------------------------------
# data parallelism


def _once(fn):
    """``fn(inputs)`` computed once for the module (both world sizes)."""
    memo = {}

    @functools.wraps(fn)
    def wrapper(inputs):
        if not memo:
            memo["value"] = fn(inputs)
        return memo["value"]

    return wrapper


@_once
def _jax_dp_step(inp):
    """JAX's single-device step on the whole batch."""
    variables = inp["dp_vars"]
    jmodel = JaxSpatialCNN(network="resnet18", loss_type="ivt",
                           teacher_dim=TEACHER_DIM)
    jstate = JaxTrainState.create(
        apply_fn=jmodel.apply,
        params=jax.tree.map(jnp.asarray, variables["params"]),
        tx=jax_build_sgd(1e-2, weight_decay=1e-5),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        rng=jax.random.fold_in(jax.random.PRNGKey(0), 1))
    jstate, jmetrics = jax_train_step(jmodel, "ivt", pos_weights=PW)(
        jstate, {k: jnp.asarray(v) for k, v in inp["dp_batch"].items()})
    return ({"params": jax.tree.map(np.asarray, jstate.params),
             "batch_stats": jax.tree.map(np.asarray, jstate.batch_stats)},
            {k: float(v) for k, v in jmetrics.items()})


@_once
def _port_sam_step(inp):
    """The port's single-device SAM step on the whole batch."""
    model = SpatialCNN("resnet18", loss_type="ivt", teacher_dim=TEACHER_DIM)
    load_jax_variables(model, inp["dp_vars"])
    state = create_train_state(model, build_sgd(1e-2, weight_decay=1e-5),
                               device="cpu")
    state, metrics = make_spatial_train_step(
        model, "ivt", pos_weights=PW, device="cpu", sam_rho=0.05)(
        state, inp["dp_batch"])
    return jax_variables(state.model), {k: float(v)
                                        for k, v in metrics.items()}


def _assert_step_close(got, want, before, gmetrics, wmetrics):
    assert set(gmetrics) == set(wmetrics)
    for k, w in wmetrics.items():
        assert abs(gmetrics[k] - w) <= METRIC_REL * max(1.0, abs(w)), k
    for coll in ("params", "batch_stats"):
        b = dict(_leaves(before[coll]))
        g = dict(_leaves(got[coll]))
        w_leaves = dict(_leaves(want[coll]))
        assert set(g) == set(w_leaves), coll
        for path, w in w_leaves.items():
            if coll == "params":
                rel = LAYER4_REL if path[1].startswith("layer4") else \
                    PARAM_REL
                atol = 1e-6 + rel * np.abs(w - b[path]).max()
            else:
                atol = STATS_REL * max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(g[path], w, atol=atol,
                                       err_msg="/".join(path))


def test_data_parallel_step_is_the_global_step(group, inputs):
    n, res = _result(group, "dp")
    want, wmetrics = _jax_dp_step(inputs)
    sam_want, sam_metrics = _port_sam_step(inputs)
    for r in res:
        _assert_step_close(r["sam0.0"]["variables"], want, inputs["dp_vars"],
                           r["sam0.0"]["metrics"], wmetrics)
        _assert_step_close(r["sam0.05"]["variables"], sam_want,
                           inputs["dp_vars"], r["sam0.05"]["metrics"],
                           sam_metrics)


def test_data_parallel_step_at_one_rank_is_the_single_step(inputs):
    """Over a one-rank data axis the step is the single-device step bit for
    bit: BatchNorm's group moments are that rank's own, the averaged
    gradients its own (chip_smoke.py holds the card's NCCL step so)."""
    (dp_m, dp), (single_m, single) = launch(
        workers.dp_step_at_one_rank, 1, (inputs,), device_type="cpu",
        timeout=RANKS_TIMEOUT)
    assert dp_m == single_m and set(dp) == set(single)
    for k, v in single.items():
        np.testing.assert_array_equal(dp[k], v, err_msg=k)


# ---------------------------------------------------------------------------
# tensor parallelism


@_once
def _jax_tp_run(inp):
    """JAX's nano Q2L at drop rates 0: the eval, then two single-device
    steps of SGD with momentum 0.9 on the whole batch."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_q2l, "Q2LTransformer", functools.partial(
        jax_q2l.Q2LTransformer, dropout=0.0))
    try:
        jmodel = jax_q2l.Q2L(backbone="swin_nano_64", loss_type="i",
                             drop_path_rate=0.0, fused_train=False)
        params0 = inp["tp_params"]
        key = jax.random.PRNGKey(0)
        jstate = JaxTrainState.create(
            apply_fn=jmodel.apply, params=jax.tree.map(jnp.asarray, params0),
            tx=jax_build_sgd(1e-2, weight_decay=1e-5, momentum=0.9),
            rng=jax.random.fold_in(key, 1))
        batch = {k: jnp.asarray(v) for k, v in inp["tp_batch"].items()}
        probs, feat = jax_eval_step(jmodel)(jstate, batch["image"])
        evals = {"feature": np.asarray(feat),
                 **{k: np.asarray(v) for k, v in probs.items()}}
        step = jax_train_step(jmodel, "i", (1.0, 0.0, 0.0), pos_weights=PW)
        metrics = []
        for _ in range(2):
            jstate, m = step(jstate, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        return evals, metrics, jax.tree.map(np.asarray, jstate.params)
    finally:
        mp.undo()


def test_tensor_parallel_placements(group, inputs):
    """Every parameter's placement is JAX's for the same leaf, and as many
    leaves are split."""
    n, res = _result(group, "tp")
    mesh = make_mesh(n_data=n // 2, n_seq=1, n_model=2,
                     devices=jax.devices()[:n])
    params = jax.tree.map(jnp.asarray, inputs["tp_params"])
    jspecs = jax_tp_shardings(params, mesh)
    count = jax_sharded_leaf_count(jax_shard_params_tp(params, mesh))
    for r in res:
        assert r["count"] == count > 0
        for name, spec in r["specs"].items():
            path, perm = _flax_path(name)
            node = jspecs
            for k in path:
                node = node[k]
            want = tuple(node.spec)
            if perm is not None and want:
                want = tuple(want[i] for i in perm)
            assert tuple(spec) == want + (None,) * (len(spec) - len(want)) \
                or tuple(spec) == want, name


def test_tensor_parallel_steps_match_jax(group, inputs):
    n, res = _result(group, "tp")
    evals, metrics, params = _jax_tp_run(inputs)
    before = inputs["tp_params"]
    for r in res:
        for k, w in evals.items():
            np.testing.assert_allclose(r["eval"][k], w, atol=EVAL_ATOL,
                                       err_msg=k)
        for got_m, want_m in zip(r["metrics"], metrics):
            assert set(got_m) == set(want_m)
            for k, w in want_m.items():
                np.testing.assert_allclose(got_m[k], w, rtol=1e-5,
                                           err_msg=k)
        # linear1's shard is half its columns, whole while gathered, and
        # cut again after
        assert r["local_shape"] == r["after_shape"]
        assert r["gathered_shape"] == (r["local_shape"][0],
                                       2 * r["local_shape"][1])
        got = dict(_leaves(r["params"]))
        want = dict(_leaves(params))
        b = dict(_leaves(before))
        assert set(got) == set(want)
        for path, w in want.items():
            _assert_param_close("/".join(path).replace("/", "."), got[path],
                                w, b[path])


# ---------------------------------------------------------------------------
# pipeline parallelism


def _mlp_block(p, x):
    return x + jnp.tanh(x @ p["w"] + p["b"])


@_once
def _jax_pipeline_want(inp):
    layers = [jax.tree.map(jnp.asarray, p) for p in inp["pp_layers"]]
    x = jnp.asarray(inp["pp_x"])

    def loss(layers, x):
        for p in layers:
            x = _mlp_block(p, x)
        return jnp.mean(x ** 2), x

    (_, out), (g_layers, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(layers, x)
    return (np.asarray(out), np.asarray(gx),
            [np.asarray(g["w"]) for g in g_layers],
            [np.asarray(g["b"]) for g in g_layers])


def test_pipeline_matches_sequential(group, inputs):
    n, res = _result(group, "pipeline")
    out, gx, gw, gb = _jax_pipeline_want(inputs)
    for r in res:
        layouts = [k for k in r if k != "errors"]
        assert len(layouts) == (3 if n == 4 else 2)
        for key in layouts:
            got = r[key]
            np.testing.assert_allclose(got["out"], out, atol=ATOL,
                                       err_msg=key)
            np.testing.assert_allclose(got["dx"], gx, atol=ATOL, err_msg=key)
            for i in range(len(gw)):
                np.testing.assert_allclose(got["dw"][i], gw[i], atol=ATOL,
                                           err_msg=f"{key} w{i}")
                np.testing.assert_allclose(got["db"][i], gb[i], atol=ATOL,
                                           err_msg=f"{key} b{i}")
        assert [e.split(" not divisible")[0].split()[0]
                for e in r["errors"]] == [str(n + 1), "batch"]


def test_swin_stage_pipeline(group, inputs):
    n, res = _result(group, "swin_pipeline")
    params = inputs["swin_params"]
    x = jnp.asarray(inputs["swin_x"])
    dim, w = 64, 4
    blocks = [JaxSwinBlock(dim=dim, num_heads=4, window=w, shift=s,
                           fused_eval=False) for s in (0, w // 2)]
    want = x
    for d in range(4):
        want = blocks[d % 2].apply({"params": params[f"stage2_block{d}"]},
                                   want)
    for r in res:
        assert r["n_blocks"] == 4
        np.testing.assert_allclose(r["out"], np.asarray(want), atol=ATOL)
        assert "no stage9" in r["error9"]
        assert "whole shift-pairs" in r["error0"]
