"""Rank-side code of the port's parallel tests (torch only, never JAX).

The test modules (``tests/test_torch_parallel_*.py``) write their inputs,
numpy arrays and JAX variable trees made numpy, to ``<dir>/in.pkl`` and
start one gloo group per world size with ``parallel.mesh.launch`` (spawned
processes meeting at a ``file://`` store, with a join timeout). Every rank
runs ``run(dir, suite)``: each case of the suite on one torch thread, its
results (numpy, whole arrays: a sharded output is gathered) pickled to
``<dir>/out_<rank>.pkl``. A case that raises records its message instead,
so that one failure does not hide the others.
"""

from __future__ import annotations

import os
import pickle
import traceback

import numpy as np
import torch
import torch.distributed as dist

from computervision_codes_tpu_torch.models.convert import load_jax_variables
from computervision_codes_tpu_torch.parallel import context, mesh as pmesh

CPU = "cpu"


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _gather(t, group, dim):
    return context.all_gather_cat(t.contiguous(), group, dim)


def seq_mesh(n):
    return pmesh.make_mesh(n_data=1, n_seq=n, device_type=CPU)


def _shard(a, mesh, dim, axis=pmesh.SEQ_AXIS):
    spec = [None] * dim + [axis]
    return _t(pmesh.local_slice(a, pmesh.Sharding(mesh, tuple(spec))))


# ---------------------------------------------------------------------------
# sequence parallelism


def case_attention(inp, n):
    m = seq_mesh(n)
    q, k, v = (_shard(inp[f"attn_{x}"], m, 2) for x in "qkv")
    out = context.sequence_parallel_attention(q, k, v, m)
    return {"out": _np(_gather(out, pmesh.axis_group(m, "seq"), 2))}


def case_ring(inp, n):
    from computervision_codes_tpu_torch.parallel.ring_attention import (
        ring_attention)

    m = seq_mesh(n)
    q, k, v = (_shard(inp[f"ring_{x}"], m, 2) for x in "qkv")
    out = ring_attention(q, k, v, m)
    return {"out": _np(_gather(out, pmesh.axis_group(m, "seq"), 2))}


def case_dilated_conv(inp, n):
    m = seq_mesh(n)
    x = _shard(inp["conv_x"], m, 1)
    out = context.sequence_parallel_dilated_conv(
        x, _t(inp["conv_w"]), _t(inp["conv_b"]), int(inp["conv_d"]), m)
    return {"out": _np(_gather(out, pmesh.axis_group(m, "seq"), 1))}


def case_halo(inp, n):
    m = seq_mesh(n)
    x = _shard(inp["halo_x"], m, 1)
    out = context.halo_exchange(x, int(inp["halo"]), m)
    result = {"out": _np(_gather(out, pmesh.axis_group(m, "seq"), 1))}
    try:
        context.halo_exchange(x, x.shape[1] + 1, m)
    except ValueError as e:
        result["too_far"] = str(e)
    return result


def case_gather_halo(inp, n):
    m = seq_mesh(n)
    x = _shard(inp["far_x"], m, 1)
    shard = context.group_shard(pmesh.axis_group(m, "seq"))
    out = {}
    for left, right in inp["far_halos"]:
        ext = context.gather_halo(x, int(left), int(right), shard)
        out[f"{left}_{right}"] = _np(
            _gather(ext[None], pmesh.axis_group(m, "seq"), 0))
    return out


def case_gather_keys(inp, n):
    m = pmesh.make_mesh(n_data=n, device_type=CPU)
    group = pmesh.axis_group(m, "data")
    parts = [_shard(inp[f"keys_{x}"], m, 0, "data")
             for x in ("k", "l", "v")]
    gk, gl, gv = context.all_gather_keys(*parts, group)
    return {"k": _np(gk), "l": gl.numpy(), "v": gv.numpy()}


def case_enqueue(inp, n):
    from computervision_codes_tpu_torch.models import moco

    m = pmesh.make_mesh(n_data=n, device_type=CPU)
    group = pmesh.axis_group(m, "data")
    queue = moco.init_queue(torch.Generator().manual_seed(3), 32, 4, CPU)
    parts = [_shard(inp[f"keys_{x}"], m, 0, "data")
             for x in ("k", "l", "v")]
    moco.enqueue(queue, *parts, group=group)
    return {k: _np(getattr(queue, k)) for k in ("feats", "l_ivt", "ptr")}


def _mstct(inp):
    from computervision_codes_tpu_torch.models.mstct import MSTCT

    model = MSTCT(inp["mstct_in"], **inp["mstct_kw"])
    return load_jax_variables(model, inp["mstct_vars"]).eval()


def _tcn(inp, key):
    from computervision_codes_tpu_torch.models.tcn import TemporalTCN

    kw = inp[f"{key}_kw"]
    model = TemporalTCN(inp["tcn_in"], **kw)
    return load_jax_variables(model, inp[f"{key}_vars"]).eval()


def case_eval_sharded(inp, n):
    from computervision_codes_tpu_torch.parallel.long_video import (
        eval_sharded)

    m = seq_mesh(n)
    feats = _t(inp["feats"])
    out = {}
    model = _mstct(inp)
    with torch.no_grad():
        out["mstct_gather"] = _np(eval_sharded(model, feats, m)["logits"])
        model.ring_mesh = m
        out["mstct_ring"] = _np(eval_sharded(model, feats, m)["logits"])
        # ring_mesh outside a sharded block: the whole input is split here
        out["mstct_ring_whole"] = _np(model(feats)["logits"])
        model.ring_mesh = None
        for key in inp["tcn_keys"]:
            tcn = _tcn(inp, key)
            res = eval_sharded(tcn, _t(inp["tcn_feats"]), m)
            out[key] = {k: [_np(v) for v in res[k]]
                        for k in ("ivt", "i", "v", "t")}
        hier = _tcn(inp, "tcn_hier")
        try:
            eval_sharded(hier, _t(inp["tcn_feats"]), m)
        except ValueError as e:
            out["hier_error"] = str(e)
    return out


CONTEXT = ("attention", "ring", "dilated_conv", "halo", "gather_halo",
           "gather_keys", "enqueue", "eval_sharded")


# ---------------------------------------------------------------------------
# data, tensor and pipeline parallelism


def _local(batch, mesh):
    return {k: pmesh.local_slice(v, pmesh.batch_sharding(mesh))
            for k, v in batch.items()}


def case_mesh(inp, n):
    out = {}
    for kw, key in ((dict(n_data=n + 1), "too_big"),
                    (dict(n_data=1), "too_small")):
        try:
            pmesh.make_mesh(device_type=CPU, **kw)
        except ValueError as e:
            out[key] = str(e)
    m = pmesh.make_mesh(n_data=n, device_type=CPU)
    out["sizes"] = [pmesh.axis_size(m, a) for a in pmesh.AXES]
    out["shard"] = {k: _np(v) for k, v in
                    pmesh.shard_batch({"x": inp["batch_x"]}, m).items()}
    mine = torch.full((3,), float(dist.get_rank()))
    out["replicated"] = _np(pmesh.replicate(mine, m))
    module = torch.nn.Linear(2, 2)
    with torch.no_grad():
        module.weight.fill_(dist.get_rank())
    out["module"] = _np(pmesh.replicate(module, m).weight)
    seq = pmesh.make_mesh(n_data=1, n_seq=n, device_type=CPU)
    out["seq_slice"] = _np(_t(pmesh.local_slice(
        inp["batch_x"], pmesh.seq_sharding(seq))))
    return out


def case_dp(inp, n):
    """One data-parallel step of the student, plain and SAM."""
    from computervision_codes_tpu_torch.models.convert import jax_variables
    from computervision_codes_tpu_torch.models.spatial_cnn import SpatialCNN
    from computervision_codes_tpu_torch.train import (
        build_sgd, create_train_state, make_spatial_train_step)

    m = pmesh.make_mesh(n_data=n, device_type=CPU)
    batch = _local(inp["dp_batch"], m)
    out = {}
    for sam in (0.0, 0.05):
        model = SpatialCNN("resnet18", loss_type="ivt",
                           teacher_dim=inp["teacher_dim"])
        load_jax_variables(model, inp["dp_vars"])
        state = create_train_state(model, build_sgd(1e-2, weight_decay=1e-5),
                                   device=CPU)
        step = make_spatial_train_step(model, "ivt", pos_weights=inp["pw"],
                                       device=CPU, sam_rho=sam, mesh=m)
        state, metrics = step(state, batch)
        out[f"sam{sam}"] = {
            "variables": jax_variables(state.model),
            "metrics": {k: float(v) for k, v in metrics.items()}}
    return out


def _q2l(inp):
    from computervision_codes_tpu_torch.models.common import Dropout
    from computervision_codes_tpu_torch.models.q2l import Q2L

    model = Q2L(backbone="swin_nano_64", loss_type="i", drop_path_rate=0.0,
                fused_eval=False)
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.rate = 0.0
    return load_jax_variables(model, {"params": inp["tp_params"]})


def case_tp(inp, n):
    """Two tensor-parallel steps (SGD momentum 0.9) of the nano Q2L on a
    (n / 2, 1, 2) mesh, and its eval before them."""
    from computervision_codes_tpu_torch.models.convert import jax_variables
    from computervision_codes_tpu_torch.parallel import tp
    from computervision_codes_tpu_torch.train import (
        build_sgd, create_train_state, make_spatial_eval_step,
        make_spatial_train_step)

    m = pmesh.make_mesh(n_data=n // 2, n_model=2, device_type=CPU)
    model = _q2l(inp)
    specs = {k: v.spec for k, v in tp.tp_shardings(model, m).items()}
    state = create_train_state(model, build_sgd(
        1e-2, weight_decay=1e-5, momentum=0.9), device=CPU)
    state = tp.shard_state_tp(state, m)
    out = {"specs": specs, "count": tp.sharded_leaf_count(state)}
    probs, feat = make_spatial_eval_step(model, device=CPU)(
        state, inp["tp_batch"]["image"])
    out["eval"] = {"feature": _np(feat), **{k: _np(v)
                                            for k, v in probs.items()}}
    step = make_spatial_train_step(model, "i", (1.0, 0.0, 0.0),
                                   pos_weights=inp["pw"], device=CPU, mesh=m)
    batch = _local(inp["tp_batch"], m)
    metrics = []
    for _ in range(2):
        state, mt = step(state, batch)
        metrics.append({k: float(v) for k, v in mt.items()})
    out["metrics"] = metrics
    out["local_shape"] = tuple(
        model.transformer.encoder0.linear1.kernel.shape)
    with tp.gathered_tp(model):
        out["params"] = jax_variables(model)["params"]
        out["gathered_shape"] = tuple(
            model.transformer.encoder0.linear1.kernel.shape)
    out["after_shape"] = tuple(
        model.transformer.encoder0.linear1.kernel.shape)
    return out


def _mlp_block(p, x):
    return x + torch.tanh(x @ p["w"] + p["b"])


def case_pipeline(inp, n):
    from computervision_codes_tpu_torch.parallel.pipeline import (
        pipeline_blocks, stack_block_params)

    out = {}
    layouts = [((1, n), m_) for m_ in (2, 4)]
    if n == 4:
        layouts.append(((2, 2), 2))  # DP x PP
    for (n_data, n_model), n_micro in layouts:
        m = pmesh.make_mesh(n_data=n_data, n_model=n_model, device_type=CPU)
        layers = [{k: _t(v).requires_grad_(True) for k, v in p.items()}
                  for p in inp["pp_layers"]]
        x = _t(inp["pp_x"]).requires_grad_(True)
        stacked = stack_block_params(layers)
        got = pipeline_blocks(_mlp_block, stacked, x, m, n_micro=n_micro)
        (got ** 2).mean().backward()
        out[f"{n_data}x{n_model}/{n_micro}"] = {
            "out": _np(got), "dx": _np(x.grad),
            "dw": [_np(p["w"].grad) for p in layers],
            "db": [_np(p["b"].grad) for p in layers]}
    errors = []
    m = pmesh.make_mesh(n_data=1, n_model=n, device_type=CPU)
    for n_layers, n_micro in ((n + 1, 2), (2 * n, 3)):
        layers = [{k: _t(v) for k, v in p.items()}
                  for p in inp["pp_layers"][:1]] * n_layers
        try:
            pipeline_blocks(_mlp_block, stack_block_params(layers),
                            torch.zeros(4, 16), m, n_micro)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    return out


def case_swin_pipeline(inp, n):
    from computervision_codes_tpu_torch.models.swin import SwinTransformer
    from computervision_codes_tpu_torch.parallel.swin_pipeline import (
        extract_stage_pairs, pipelined_swin_stage)

    swin = SwinTransformer(**inp["swin_kw"])
    load_jax_variables(swin, {"params": inp["swin_params"]})
    out = {}
    with torch.no_grad():
        stacked, n_blocks = extract_stage_pairs(swin, 2)
        m = pmesh.make_mesh(n_data=n // 2, n_model=2, device_type=CPU)
        dim = inp["swin_kw"]["embed_dim"] * 4
        got = pipelined_swin_stage(stacked, _t(inp["swin_x"]), m, n_micro=2,
                                   dim=dim, num_heads=4, window=4)
    out["n_blocks"], out["out"] = n_blocks, _np(got)
    for stage in (9, 0):
        try:
            extract_stage_pairs(swin, stage)
        except ValueError as e:
            out[f"error{stage}"] = str(e)
    return out


def case_session(inp, n):
    """The mesh session against the meshless one, bf16 and int8."""
    from computervision_codes_tpu_torch.serving import InferenceSession

    m = pmesh.make_mesh(n_data=n, device_type=CPU)
    out = {}
    clips = inp["clips"]
    kw = dict(batch=clips.shape[0], clip_len=clips.shape[1],
              height=clips.shape[2], width=clips.shape[3])
    for q in (False, True):
        sess = InferenceSession.create(quantize=q, mesh=m, **kw)
        out[f"q{q}"] = sess.predict(clips)
        try:
            sess.export(inp["servable_dir"])
        except ValueError as e:
            out[f"export{q}"] = str(e)
    try:
        InferenceSession.create(mesh=m, **dict(kw, batch=n + 1))
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def case_prefetch(inp, n):
    from computervision_codes_tpu_torch.data.multihost import (
        form_global_batch)
    from computervision_codes_tpu_torch.data.prefetch import (
        prefetch_to_device)

    m = pmesh.make_mesh(n_data=n, device_type=CPU)
    group = pmesh.axis_group(m, "data")
    host = [{"x": inp["batch_x"] + i} for i in range(3)]
    got = [{k: _np(_gather(v, group, 0)) for k, v in b.items()}
           for b in prefetch_to_device(iter(host),
                                       sharding=pmesh.batch_sharding(m))]
    local = _local({"x": inp["batch_x"]}, m)
    formed = form_global_batch(m, local)
    return {"prefetch": got, "formed": _np(_gather(formed["x"], group, 0)),
            "formed_local": _np(formed["x"])}


TRAIN = ("mesh", "dp", "tp", "pipeline", "swin_pipeline")
MULTIHOST = ("session", "prefetch")


# ---------------------------------------------------------------------------
# drivers


def dp_step_at_one_rank(inp):
    """The student's step on ``inp["dp_batch"]`` from ``inp["dp_vars"]``
    over a one-rank data axis, then the single-device step: each one's
    metrics and state dict (numpy)."""
    from computervision_codes_tpu_torch.models.spatial_cnn import SpatialCNN
    from computervision_codes_tpu_torch.train import (
        build_sgd, create_train_state, make_spatial_train_step)

    torch.set_num_threads(1)
    m = pmesh.make_mesh(n_data=1, device_type=CPU)
    out = []
    for mesh in (m, None):
        model = SpatialCNN("resnet18", loss_type="ivt",
                           teacher_dim=inp["teacher_dim"])
        load_jax_variables(model, inp["dp_vars"])
        state = create_train_state(model, build_sgd(1e-2, weight_decay=1e-5),
                                   device=CPU)
        state, metrics = make_spatial_train_step(
            model, "ivt", pos_weights=inp["pw"], device=CPU, mesh=mesh)(
                state, {k: _t(v) for k, v in inp["dp_batch"].items()})
        out.append(({k: float(v) for k, v in metrics.items()},
                    {k: _np(v) for k, v in state.model.state_dict().items()}))
    return out


def transformer_main_without_dropout(argv):
    """``cli.spatial_transformer.main`` with every dropout and drop-path
    rate 0, as its test swaps them in the test process (a spawned rank
    starts from fresh modules)."""
    import functools

    from computervision_codes_tpu_torch.cli import spatial_transformer
    from computervision_codes_tpu_torch.models import q2l

    q2l.DROPOUT = 0.0
    spatial_transformer.Q2L = functools.partial(q2l.Q2L, drop_path_rate=0.0)
    return spatial_transformer.main(argv)


# ---------------------------------------------------------------------------
# runner


def run(directory: str, suite) -> None:
    torch.set_num_threads(1)
    with open(os.path.join(directory, "in.pkl"), "rb") as fh:
        inp = pickle.load(fh)
    n = dist.get_world_size()
    results = {}
    for name in suite:
        try:
            results[name] = globals()[f"case_{name}"](inp, n)
        except Exception:  # recorded: the test reports it
            results[name] = {"error": traceback.format_exc()}
    with open(os.path.join(directory, f"out_{dist.get_rank()}.pkl"),
              "wb") as fh:
        pickle.dump(results, fh)


def spawn(directory: str, suite, n: int, timeout: float = 150.0):
    """Run ``suite`` on ``n`` gloo ranks; {rank: results}."""
    pmesh.launch(run, n, (directory, tuple(suite)), device_type=CPU,
                 timeout=timeout)
    out = {}
    for r in range(n):
        with open(os.path.join(directory, f"out_{r}.pkl"), "rb") as fh:
            out[r] = pickle.load(fh)
    return out
