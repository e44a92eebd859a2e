"""The port's TERL modules against the JAX package's, on the CPU.

``swin_nano_64`` at 64x64, a queue of 32, batch 2. Both packages get the
same weights (``load_jax_variables`` of the JAX tree) and the same seeded
numpy inputs. Tolerances: float32 forwards and losses at rtol 1e-5 and
atol 1e-5 of max(1, max|want|) (sums in another order); the ASL terms are
scaled by 1000, so their absolute bound scales with them. One
``make_terl_train_step`` step at ``kcl_k=0`` (every positive kept: the
step is deterministic) with DropPath off in both: its losses at rtol 1e-5,
each updated parameter and key parameter within 1e-6 plus 1% of its change
in the step (the bound of tests/test_torch_train_step.py), the queue and
the prototypes at 1e-5. The random parts (``k_positive_mask``) are held by
their rules. The CAM overlay: cv2's JET table and its uint8 bilinear
resize within 1 LSB each; cv2 built with IPP rounds a few resized values
the other way, and one JET step is 4 / 255, so the overlay (0.4 of the
colour, truncated) is within 2 LSB of the JAX ``render_cam_overlay``, and
within 1 LSB wherever the resized maps agree.
"""

import functools
import json

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervision_codes_tpu.data import tail_stats as jax_tail
from computervision_codes_tpu.losses import asl as jax_asl
from computervision_codes_tpu.losses import components as jax_comp
from computervision_codes_tpu.losses import kcl as jax_kcl
from computervision_codes_tpu.models import moco as jax_moco
from computervision_codes_tpu.models.swin import SwinTransformer as JaxSwin
from computervision_codes_tpu.train import build_sgd as jax_build_sgd
from computervision_codes_tpu.train import freeze_swin_early as jax_freeze
from computervision_codes_tpu.train import terl as jax_terl
from computervision_codes_tpu.utils import cam as jax_cam
from computervision_codes_tpu.utils import misc as jax_misc
from computervision_codes_tpu_torch.data import tail_stats
from computervision_codes_tpu_torch.data.bank import load_bank
from computervision_codes_tpu_torch.losses import asl, components, kcl
from computervision_codes_tpu_torch.models import moco
from computervision_codes_tpu_torch.models.common import DropPath
from computervision_codes_tpu_torch.models.convert import (
    jax_variables, load_jax_variables)
from computervision_codes_tpu_torch.train import build_sgd, freeze_swin_early
from computervision_codes_tpu_torch.train import terl
from computervision_codes_tpu_torch.utils import cam, misc

BACKBONE, DIM, IMG, B, K = "swin_nano_64", 256, 64, 2, 32
RTOL, ATOL = 1e-5, 1e-5
PARAM_ATOL, PARAM_REL = 1e-6, 1e-2
LR, WD = 0.05, 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(got, want, rtol=RTOL, atol=ATOL, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=rtol,
        atol=atol * max(1.0, float(np.abs(want).max(initial=0))),
        err_msg=what)


def t(a):
    return torch.from_numpy(np.asarray(a))


def models(ht=False, num_triplet=100, mlp=True):
    """(JAX TERLModel, its params from a seeded port model, the port
    model)."""
    port = moco.TERLModel(BACKBONE, DIM, mlp=mlp, ht=ht,
                          num_triplet=num_triplet,
                          generator=torch.Generator().manual_seed(3))
    jmodel = jax_moco.TERLModel(BACKBONE, DIM, mlp=mlp, ht=ht,
                                num_triplet=num_triplet)
    params = jax.tree.map(jnp.asarray, jax_variables(port)["params"])
    return jmodel, params, port


def ht_masks(num_triplet=100):
    from computervision_codes_tpu_torch.cli.terl_learnt import (
        tail_head_masks)
    masks = {k: tail_head_masks(k)[::-1] for k in ("i", "v", "t", "ivt")}
    if num_triplet != 100:
        hm, tm = masks["ivt"]
        masks["ivt"] = (hm[:num_triplet], tm[:num_triplet])
    return masks


def images(rng, n=B):
    return rng.standard_normal((n, IMG, IMG, 3)).astype(np.float32)


@pytest.mark.parametrize("ht, num_triplet, mlp", [(False, 100, True),
                                                  (True, 100, True),
                                                  (False, 98, False)])
def test_encoder_forward_matches_jax(rng, ht, num_triplet, mlp):
    jmodel, params, port = models(ht, num_triplet, mlp)
    masks = ht_masks(num_triplet) if ht else None
    x = images(rng)
    want = jax.jit(functools.partial(jmodel.apply, ht_masks=masks))(
        {"params": params}, x)
    port.eval()
    with torch.no_grad():
        got = port(t(x), masks)
    for key in ("fmap", "feature", "mlp_feat"):
        close(got[key], want[key], what=key)
    for group in ("cams", "logits"):
        assert set(got[group]) == set(want[group])
        for k in want[group]:
            close(got[group][k], want[group][k], what=f"{group}/{k}")
    # the disentangled anchors and y_tail
    s, c, _ = moco.select_tail_anchors(
        np.eye(num_triplet)[[5, 42]], 4)
    jout = jax.tree.map(jnp.asarray, want)
    jpool, jmaps = jmodel.apply({"params": params}, jout, jnp.asarray(s),
                                jnp.asarray(c),
                                method=jax_moco.TERLModel.disentangle)
    with torch.no_grad():
        pool, maps = port.disentangle(got, t(s), t(c))
        y_tail = moco.apply_cam_ivt(port.encoder, maps,
                                    masks["ivt"] if ht else None)
    close(pool, jpool, what="pooled anchors")
    close(maps, jmaps, what="anchor maps")
    close(y_tail, jax_moco.apply_cam_ivt(params["encoder"], jmaps,
                                         masks["ivt"] if ht else None),
          what="y_tail")


def test_select_tail_anchors_matches_jax(rng):
    tails = (rng.random((4, 100)) < 0.05).astype(np.float32)
    for cap in (3, 40):
        for a, b in zip(moco.select_tail_anchors(tails, cap),
                        jax_moco.select_tail_anchors(tails, cap)):
            np.testing.assert_array_equal(a, b)


def _queue_pair(rng):
    """A JAX queue with labels drawn from the bank and its port copy."""
    q = jax_moco.init_queue(jax.random.PRNGKey(5), K, DIM)
    bank = load_bank()
    ivt = rng.integers(0, 100, K).astype(np.int32)
    q = q.replace(l_ivt=jnp.asarray(ivt),
                  **{f"l_{k}": jnp.asarray(bank[ivt, col].astype(np.int32))
                     for k, col in (("i", 1), ("v", 2), ("t", 3))},
                  ptr=jnp.asarray(K - 3, jnp.int32))
    port = moco.MoCoQueue(K, DIM)
    load_jax_variables(port, {"queue": {f: np.asarray(getattr(q, f))
                                        for f in moco.QUEUE_FIELDS}})
    return q, port


def _check_queue(port, q):
    for f in moco.QUEUE_FIELDS:
        got, want = getattr(port, f), np.asarray(getattr(q, f))
        if want.dtype.kind == "i":
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f)
        else:
            close(got, want, what=f)


def test_queue_functions_match_jax(rng):
    q, port = _queue_pair(rng)
    _check_queue(port, q)
    assert jax_variables(port)["queue"].keys() == set(moco.QUEUE_FIELDS)
    _check_queue(moco.update_prototypes(port), jax_moco.update_prototypes(q))
    q = jax_moco.update_prototypes(q)
    keys = rng.standard_normal((6, DIM)).astype(np.float32)
    lab = rng.integers(0, 100, 6).astype(np.int32)
    valid = np.array([1, 0, 1, 1, 1, 1], np.float32)  # 5 valid, 3 fit
    _check_queue(moco.enqueue(port, t(keys), t(lab), t(valid)),
                 jax_moco.enqueue(q, jnp.asarray(keys), jnp.asarray(lab),
                                  jnp.asarray(valid)))
    q = jax_moco.enqueue(q, jnp.asarray(keys), jnp.asarray(lab),
                         jnp.asarray(valid))
    assert int(port.ptr) == 0  # 3 of the 5 valid fit: K - 3 + 3, mod K
    qv = rng.standard_normal((3, DIM)).astype(np.float32)
    kv = rng.standard_normal((3, DIM)).astype(np.float32)
    close(moco.moco_logits(t(qv), t(kv), port),
          jax_moco.moco_logits(jnp.asarray(qv), jnp.asarray(kv), q))
    for k, v in moco.prototype_logits(t(qv), port).items():
        close(v, jax_moco.prototype_logits(jnp.asarray(qv), q)[k], what=k)
    small = np.concatenate([qv, 1e-5 * qv], 0)
    close(moco.l2_normalize(t(small)), jax_moco.l2_normalize(
        jnp.asarray(small)))
    np.testing.assert_array_equal(
        moco.queue_positive_mask(t(lab), port.l_ivt).numpy(),
        np.asarray(jax_moco.queue_positive_mask(jnp.asarray(lab), q.l_ivt)))
    fresh = moco.init_queue(torch.Generator().manual_seed(0), K, DIM)
    np.testing.assert_allclose(fresh.feats.norm(dim=-1).numpy(), 1.0,
                               rtol=1e-6)
    assert int(fresh.ptr) == 0 and float(fresh.proto_v.min()) >= 0


def test_momentum_update_and_model_ema_match_jax():
    a = moco.CamDisentangle(8, generator=torch.Generator().manual_seed(1))
    b = moco.CamDisentangle(8, generator=torch.Generator().manual_seed(2))
    pa, pb = jax_variables(a)["params"], jax_variables(b)["params"]
    want = jax_moco.momentum_update(pa, pb, 0.9)
    close(moco.momentum_update(a, b, 0.9).conv.kernel,
          want["conv"]["kernel"])
    ema = misc.ModelEma(a, decay=0.7)
    jema = jax_misc.ModelEma(pa, decay=0.7)
    close(ema.update(b).conv.bias, jema.update(jax_variables(b)["params"])[
        "conv"]["bias"])
    close(ema.set(a).conv.kernel, jema.set(pa)["conv"]["kernel"])


@pytest.mark.parametrize("reduction", ["sum", "terl", "mean_terl"])
@pytest.mark.parametrize("weighted", [False, True])
def test_asl_matches_jax(rng, reduction, weighted):
    logits = 3 * rng.standard_normal((5, 15)).astype(np.float32)
    targets = (rng.random((5, 15)) < 0.3).astype(np.float32)
    w = np.array([1, 1, 0, 1, 0], np.float32) if weighted else None
    for kw in ({}, dict(gamma_neg=2, gamma_pos=0, clip=0, eps=1e-5)):
        close(asl.asymmetric_loss(t(logits), t(targets), reduction=reduction,
                                  sample_weight=w, **kw),
              jax_asl.asymmetric_loss(jnp.asarray(logits),
                                      jnp.asarray(targets),
                                      reduction=reduction, sample_weight=w,
                                      **kw))
    with pytest.raises(ValueError, match="reduction"):
        asl.asymmetric_loss(t(logits), t(targets), reduction="mean")


def test_asl_focal_weight_is_a_constant(rng):
    logits = t(3 * rng.standard_normal((4, 6)).astype(np.float32))
    logits.requires_grad_(True)
    targets = t((rng.random((4, 6)) < 0.5).astype(np.float32))
    asl.asymmetric_loss(logits, targets, gamma_neg=2, gamma_pos=0, clip=0,
                        reduction="mean_terl").backward()
    jg = jax.grad(lambda x: jax_asl.asymmetric_loss(
        x, jnp.asarray(targets.numpy()), gamma_neg=2, gamma_pos=0, clip=0,
        reduction="mean_terl"))(jnp.asarray(logits.detach().numpy()))
    close(logits.grad, jg)


def test_component_maps_match_jax(rng):
    ivt = rng.standard_normal((3, 100)).astype(np.float32)
    lab = (rng.random((3, 100)) < 0.05).astype(np.float32)
    for got, want in ((components.component_max_logits(t(ivt)),
                       jax_comp.component_max_logits(jnp.asarray(ivt))),
                      (components.component_labels(t(lab)),
                       jax_comp.component_labels(jnp.asarray(lab)))):
        assert set(got) == set(want)
        for k in want:
            close(got[k], want[k], what=k)


def test_contrastive_losses_match_jax(rng):
    logits = rng.standard_normal((6, 1 + 20)).astype(np.float32)
    pos = (rng.random((6, 20)) < 0.3).astype(np.float32)
    pos[2] = 0  # an anchor without positives
    valid = np.array([1, 1, 1, 0, 1, 1], np.float32)
    key = jax.random.PRNGKey(0)
    for v in (None, valid):
        close(kcl.kcl_loss(None, t(logits), t(pos), k=0, anchor_valid=v),
              jax_kcl.kcl_loss(key, jnp.asarray(logits), jnp.asarray(pos),
                               k=0, anchor_valid=v))
    proto_logits = logits[:, :6]
    close(kcl.kcl_proto_loss(None, t(proto_logits), t(pos[:, :6]), k=0),
          jax_kcl.kcl_proto_loss(key, jnp.asarray(proto_logits),
                                 jnp.asarray(pos[:, :6]), k=0))
    cluster = (rng.random((6, 20)) < 0.3).astype(np.float32)
    close(kcl.supcon_ccl_loss(t(logits), t(pos), t(cluster)),
          jax_kcl.supcon_ccl_loss(jnp.asarray(logits), jnp.asarray(pos),
                                  jnp.asarray(cluster)))
    close(kcl.supcon_rank_loss(t(logits), t(pos), t(cluster)),
          jax_kcl.supcon_rank_loss(jnp.asarray(logits), jnp.asarray(pos),
                                   jnp.asarray(cluster)))
    target = rng.integers(0, 10, 6)
    counts = rng.integers(5, 500, 10)
    wts = rng.random(10).astype(np.float32) + 0.5
    for w in (None, wts):
        close(kcl.ldam_loss(t(logits[:, :10]), t(target), counts, weight=w),
              jax_kcl.ldam_loss(jnp.asarray(logits[:, :10]),
                                jnp.asarray(target), counts, weight=w))


def test_k_positive_mask_rules(rng):
    mask = (rng.random((64, 30)) < 0.2).astype(np.float32)
    mask[:4] = 0
    got = kcl.k_positive_mask(torch.Generator().manual_seed(0), t(mask), 3)
    assert torch.all(got <= t(mask))  # positives only
    assert torch.all(got[:4] == 0)  # none where there are none
    per_row = got.sum(1)
    has = t(mask).sum(1) > 0
    assert torch.all(per_row[has] >= 1) and torch.all(per_row <= 3)
    again = kcl.k_positive_mask(torch.Generator().manual_seed(0), t(mask), 3)
    assert torch.equal(got, again)
    # uniform over a row's positives: every positive of a wide row is drawn
    wide = np.zeros((2000, 4), np.float32)
    wide[:, :2] = 1
    hits = kcl.k_positive_mask(torch.Generator().manual_seed(1), t(wide),
                               1).mean(0)
    assert abs(float(hits[0]) - 0.5) < 0.05 and float(hits[2:].sum()) == 0


def test_tail_stats_match_jax():
    for task in ("i", "v", "t", "ivt"):
        np.testing.assert_array_equal(tail_stats.instance_counts()[task],
                                      jax_tail.instance_counts()[task])
        np.testing.assert_array_equal(
            tail_stats.class_counts_sorted_by_id(task),
            jax_tail.class_counts_sorted_by_id(task))
    assert tail_stats.tail_triplet_classes(84) == \
        jax_tail.tail_triplet_classes(84)
    assert tail_stats.tail_triplet_classes(5, [3, 4]) == [3, 4]


def _terl_batch(rng, num_triplet=100):
    tail = np.zeros((B, num_triplet), np.float32)
    tail[0, [5, 30]] = 1
    tail[1, 42] = 1
    s, c, v = moco.select_tail_anchors(tail, 4)
    lab = {k: (rng.random((B, n)) < 0.3).astype(np.float32)
           for k, n in (("i", 6), ("v", 10), ("t", 15))}
    lab["ivt"] = np.maximum(tail, (rng.random((B, num_triplet)) < 0.05))
    return {"image1": images(rng), "image2": images(rng),
            "anchor_sample": s, "anchor_class": c, "anchor_valid": v,
            **{f"label_{k}": a.astype(np.float32) for k, a in lab.items()}}


def _no_drop_path(module):
    for m in module.modules():
        if isinstance(m, DropPath):
            m.rate = 0.0


@pytest.mark.parametrize("epoch, ht", [(1, False), (0, True)])
def test_one_train_step_at_kcl_k0_matches_jax(rng, monkeypatch, epoch, ht):
    """w_epoch 1: epoch 1 the full loss, epoch 0 the warmup's."""
    jmodel, params, port = models(ht=ht)
    masks = ht_masks() if ht else None
    q, port_q = _queue_pair(rng)
    batch = _terl_batch(rng)
    key_params = jax.tree.map(lambda x: x + 0.01, params)  # another EMA
    jstate = jax_terl.TERLTrainState.create(
        apply_fn=jmodel.apply, params=params, tx=jax_build_sgd(LR, WD),
        key_params=key_params, queue=q, rng=jax.random.PRNGKey(1))
    monkeypatch.setattr(jax_moco, "SwinTransformer", functools.partial(
        JaxSwin, drop_path_rate=0.0))
    before = jax.tree.map(np.asarray, (params, key_params))
    jstep = jax_terl.make_terl_train_step(jmodel, w_epoch=1, kcl_k=0,
                                          ht_masks=masks)
    jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch),
                       jnp.asarray(epoch))

    _no_drop_path(port)
    state = terl.TERLTrainState(
        model=port, optimizer=build_sgd(LR, WD)(port.parameters()),
        rng=torch.Generator().manual_seed(0), queue=port_q,
        key_model=load_jax_variables(terl.key_copy(port), {
            "params": jax.tree.map(np.asarray, key_params)}))
    step = terl.make_terl_train_step(port, w_epoch=1, kcl_k=0,
                                     ht_masks=masks)
    state, m = step(state, batch, epoch)
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=RTOL,
                                   err_msg=k)

    def check(g, w, b):
        change = np.abs(w - b).max()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=PARAM_ATOL + PARAM_REL * change)
    want_p, want_k = jax.tree.map(np.asarray, (jstate.params,
                                               jstate.key_params))
    jax.tree.map(check, jax_variables(state.model)["params"], want_p,
                 before[0])
    jax.tree.map(check, jax_variables(state.key_model)["params"], want_k,
                 before[1])
    _check_queue(state.queue, jstate.queue)
    assert state.step == 1


def test_eval_step_matches_jax(rng):
    jmodel, params, port = models()
    x = images(rng)
    q, port_q = _queue_pair(rng)
    jstate = jax_terl.TERLTrainState.create(
        apply_fn=jmodel.apply, params=params, tx=jax_build_sgd(LR),
        key_params=params, queue=q, rng=jax.random.PRNGKey(1))
    jprobs, jfeat = jax_terl.make_terl_eval_step(jmodel)(jstate,
                                                         jnp.asarray(x))
    state = terl.TERLTrainState(
        model=port, optimizer=build_sgd(LR)(port.parameters()),
        rng=torch.Generator(), key_model=terl.key_copy(port), queue=port_q)
    probs, feat = terl.make_terl_eval_step(port)(state, x)
    close(feat, jfeat)
    for k in jprobs:
        close(probs[k], jprobs[k], what=k)


def test_freeze_swin_early_freezes_what_jax_freezes(rng):
    jmodel, params, port = models()
    tx = jax_freeze(jax_build_sgd(LR, WD))
    zero = jax.tree.map(jnp.ones_like, params)
    updates, _ = tx.update(zero, tx.init(params), params)
    frozen_jax = {"/".join(str(getattr(k, "key", k)) for k in path)
                  for path, u in jax.tree_util.tree_leaves_with_path(updates)
                  if not np.any(np.asarray(u))}
    opt = freeze_swin_early(build_sgd(LR, WD))(port.named_parameters())
    assert opt.frozen
    frozen_port = {n for n, p in port.named_parameters()
                   if not p.requires_grad}
    assert len(frozen_port) == len(frozen_jax) > 0
    assert all(n.startswith("encoder.backbone.") for n in frozen_port)
    assert sum(len(g["params"]) for g in opt.param_groups) == \
        len(list(port.parameters())) - len(frozen_port)


def test_terl_state_refuses_a_wrong_moco_dim():
    with pytest.raises(ValueError, match="moco_dim"):
        terl.create_terl_state(moco.TERLModel(BACKBONE, 128), build_sgd(LR),
                               device="cpu")


def test_misc_utilities_match_jax(rng, tmp_path):
    sd = {"module.a": 1, "b": 2}
    assert misc.clean_state_dict(sd) == jax_misc.clean_state_dict(sd)
    img = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    for seed in range(5):
        np.testing.assert_array_equal(
            misc.cutout(np.random.default_rng(seed), img),
            jax_misc.cutout(np.random.default_rng(seed), img))
    scores = rng.random((40, 6))
    targets = (rng.random((40, 6)) < 0.3).astype(np.float32)
    assert misc.voc_mAP(scores, targets) == jax_misc.voc_mAP(scores, targets)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"a": {"b": [1, {"c": 2}]}}))
    cfg = misc.load_config(str(path))
    assert cfg.a.b[1].c == jax_misc.load_config(str(path)).a.b[1].c == 2


def test_jet_and_resize_follow_cv2(rng):
    ref = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[None],
                            cv2.COLORMAP_JET)[0][:, ::-1]
    assert np.abs(cam.JET.astype(int) - ref.astype(int)).max() <= 1
    for h, w, hh, ww in ((7, 7, 224, 224), (2, 2, 64, 64), (7, 9, 256, 448),
                         (16, 16, 8, 8)):
        m = rng.integers(0, 256, (h, w), dtype=np.uint8)
        got = cam.resize_linear_u8(m, ww, hh)
        want = cv2.resize(m, (ww, hh))
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_cam_overlay_against_jax(rng, tmp_path):
    for _ in range(4):
        c = rng.standard_normal((7, 7)).astype(np.float32)
        frame = rng.integers(0, 256, (224, 224, 3), dtype=np.uint8)
        got = cam.render_cam_overlay(frame, c).astype(int)
        want = jax_cam.render_cam_overlay(frame, c).astype(int)
        heat = np.uint8(255 * jax_cam.normalize_cam(c))
        same = cam.resize_linear_u8(heat, 224, 224) == cv2.resize(heat,
                                                                  (224, 224))
        assert np.abs(got - want).max() <= 2
        assert np.abs(got - want)[same].max() <= 1
    path = cam.draw_cam(frame, c, str(tmp_path / "o.png"))
    np.testing.assert_array_equal(cv2.imread(path)[..., ::-1],
                                  got.astype(np.uint8))
    norm = (frame / 255.0 - [0.485, 0.456, 0.406]) / [0.229, 0.224, 0.225]
    np.testing.assert_array_equal(cam.denormalize_frame(norm),
                                  jax_cam.denormalize_frame(norm))
