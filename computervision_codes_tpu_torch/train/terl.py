"""TERL's tail-enhanced contrastive training step.

Counterpart of ``computervision_codes_tpu/train/terl.py`` (the reference's
TERL/6_baseline_learnT/run.py train_loop :234-383 and MoCo.forward,
models/moco.py:310-405):

    loss = loss_cls_ivt + loss_cls1                  (ASL: direct + comp-max)
         + w_con   * KCL(moco logits against the queue's labels)
         + w_proto * ASL(prototype logits against one-hot components)
         + w_tail  * ASL(y_tail against the one-hot tail triplet)
    warmup (epoch < w_epoch): loss = loss_cls1 + w_con * KCL

The state (``TERLTrainState``) is the spatial ``TrainState`` (the query
module, its optimizer, the step, the generator) with ``key_model``, the
key encoder and disentangle conv as an EMA copy of the query module (no
gradients; in ``.eval()``, where its Swin blocks run the eval kernels K3
and K4 on the card), and ``queue``, a ``models.moco.MoCoQueue`` on the
module's device. A step: the prototypes from the queue, the query forward
in ``.train()`` (K6 under ``fused_train``), the losses, the backward, one
update, then the key module's momentum update and the enqueue of the key
anchors. The anchors are padded to a fixed count with a validity mask
(``models.moco.select_tail_anchors``, host side); a batch without tails
gives masked losses of exactly 0, where the reference skips it.

As in JAX, the key anchors' CAM slice comes from the key image's feature
map (the reference reads the query's, moco.py:371). ``kcl_k=0`` keeps
every positive and the step draws nothing but DropPath's masks.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..data import bank as bank_mod
from ..losses.asl import asymmetric_loss
from ..losses.kcl import kcl_loss
from ..models import moco as moco_mod
from ..models.moco import MoCoQueue, TERLModel
from ..models.swin import swin_feature_dim
from .optim import sam_gradients
from .state import TrainState
from .trainer import create_train_state


@dataclass
class TERLTrainState(TrainState):
    key_model: Optional[nn.Module] = None
    queue: Optional[MoCoQueue] = None


def create_terl_state(model: TERLModel, optimizer, seed: int = 0,
                      queue_size: int = 16384,
                      device: str = "cuda") -> TERLTrainState:
    """The TERL state on ``device``: ``create_train_state``'s (``model``,
    its weights already made, with ``optimizer``: ``build_sgd``, or
    ``freeze_swin_early`` of it), a key module copied from the model, and
    a queue of ``queue_size`` keys drawn from the state's generator. ``moco_dim`` must be the backbone's feature width: the
    queue holds the pooled disentangled features (the reference runs Swin-T
    at 768)."""
    want = swin_feature_dim(model.backbone)
    if model.moco_dim != want:
        raise ValueError(f"moco_dim must equal the backbone feature dim "
                         f"({want} for {model.backbone}), got "
                         f"{model.moco_dim}")
    state = create_train_state(model, optimizer, seed, device)
    queue = moco_mod.init_queue(state.rng, queue_size, model.moco_dim,
                                device)
    return TERLTrainState(**vars(state), key_model=key_copy(state.model),
                          queue=queue)


def key_copy(model: nn.Module) -> nn.Module:
    """A copy of ``model`` for the key path: no gradients, ``.eval()``."""
    key = copy.deepcopy(model).eval()
    for p in key.parameters():
        p.requires_grad_(False)
    return key


def _device_of(state) -> torch.device:
    return state.queue.feats.device


def make_terl_train_step(model: TERLModel, w_con: float = 1.0,
                         w_proto: float = 1.0, w_tail: float = 1.0,
                         w_epoch: int = 1, moco_m: float = 0.999,
                         moco_t: float = 0.07, kcl_k: int = 7,
                         use_mlp: bool = True, ht_masks=None,
                         class_map=None, sam_rho: float = 0.0):
    """``step(state, batch, epoch) -> (state, metrics)``. ``batch``:
    ``image1``/``image2`` (B, H, W, 3), ``label_{i,v,t,ivt}`` (B, C) (ivt
    in the head's class space), ``anchor_sample``/``anchor_class``/
    ``anchor_valid`` (A,), numpy arrays or tensors. ``class_map`` (V,)
    sends the head's ids back to the 100 triplet ids under
    ``--drop_classes`` (run.py:208-211): the queue keeps the original ids.
    ``sam_rho`` > 0 takes the gradient by two-step SAM, both passes with
    the same masks and draws (the generator's state is replayed), and the
    enqueue takes the second pass's keys. The metrics are ``loss_cls1``,
    ``loss_cls_ivt``, ``loss`` and with ``use_mlp`` ``loss_con``,
    ``loss_proto`` and ``loss_tail``; the step trains the state's module
    (``model`` gives its triplet count)."""
    n_ivt = model.num_triplet
    cm_np = np.arange(100) if class_map is None else np.asarray(class_map)
    bank_np = bank_mod.load_bank()
    projs_np = {k: bank_mod.component_projection(k)[cm_np] > 0
                for k in ("i", "v", "t")}

    def asl(lg, tg, w=None):  # the TERL ASL configuration
        return asymmetric_loss(lg, tg, gamma_neg=2, gamma_pos=0, clip=0,
                               eps=1e-5, reduction="mean_terl",
                               sample_weight=w)

    def step(state: TERLTrainState, batch: Dict[str, Any], epoch: int
             ) -> Tuple[TERLTrainState, Dict[str, torch.Tensor]]:
        dev = _device_of(state)

        def arr(key, dtype=None):
            return torch.as_tensor(np.asarray(batch[key]) if not isinstance(
                batch[key], torch.Tensor) else batch[key]).to(dev, dtype)

        projs = {k: torch.from_numpy(v).to(dev) for k, v in projs_np.items()}
        bank = torch.from_numpy(bank_np).to(dev)
        class_map_t = torch.from_numpy(cm_np).to(dev).long()
        queue = moco_mod.update_prototypes(state.queue)
        s_idx, c_idx = arr("anchor_sample").long(), arr("anchor_class").long()
        valid = arr("anchor_valid", torch.float32)
        labels = {k: arr(f"label_{k}", torch.float32)
                  for k in ("i", "v", "t", "ivt")}
        images1, images2 = arr("image1"), arr("image2")
        rng_state = state.rng.get_state()
        enq: Dict[str, Any] = {}

        def loss_fn():
            state.rng.set_state(rng_state)  # a SAM pass replays the draws
            enc_out = state.model.encode(images1, ht_masks, state.rng)
            logits = enc_out["logits"]
            loss_cls1 = sum(asl(logits[k], labels[k]) for k in ("i", "v",
                                                                "t"))
            neg = torch.tensor(float("-inf"), dtype=logits["ivt"].dtype,
                               device=dev)
            comp = {k: torch.where(projs[k], logits["ivt"][..., None],
                                   neg).amax(dim=-2)
                    for k in ("i", "v", "t")}
            loss_cls_ivt = sum(asl(comp[k], labels[k])
                               for k in ("i", "v", "t"))
            loss_cls_ivt = loss_cls_ivt + asl(logits["ivt"], labels["ivt"])
            metrics = {"loss_cls1": loss_cls1, "loss_cls_ivt": loss_cls_ivt}
            if not use_mlp:
                total = loss_cls1 + loss_cls_ivt
                metrics["loss"] = total
                return total, metrics

            q_pooled, q_maps = state.model.disentangle(enc_out, s_idx, c_idx)
            y_tail = moco_mod.apply_cam_ivt(
                state.model.encoder, q_maps,
                ht_masks["ivt"] if ht_masks else None)
            q = moco_mod.l2_normalize(q_pooled)
            with torch.no_grad():  # the key path: EMA weights, no gradient
                k_enc = state.key_model.encode(images2, ht_masks)
                k_pooled, _ = state.key_model.disentangle(k_enc, s_idx,
                                                          c_idx)
                k = moco_mod.l2_normalize(k_pooled)
            lab_ivt = class_map_t[c_idx]  # the original 100 ids
            cl = moco_mod.moco_logits(q, k, queue)
            pos_mask = moco_mod.queue_positive_mask(lab_ivt, queue.l_ivt)
            loss_con = kcl_loss(state.rng, cl, pos_mask, k=kcl_k,
                                temperature=moco_t, anchor_valid=valid)
            both = torch.cat([q_pooled, k_pooled], dim=0)
            both_valid = torch.cat([valid, valid], dim=0)
            pl = moco_mod.prototype_logits(both, queue)
            lab2 = torch.cat([lab_ivt, lab_ivt], dim=0)
            loss_proto = sum(
                asl(pl[t], F.one_hot(bank[lab2, col].long(),
                                     pl[t].shape[-1]).float(), both_valid)
                for t, col in (("i", 1), ("v", 2), ("t", 3)))
            # y_tail lives in the head's (possibly remapped) class space
            loss_tail = asl(y_tail, F.one_hot(c_idx, n_ivt).float(), valid)
            if epoch < w_epoch:
                total = loss_cls1 + w_con * loss_con
            else:
                total = (loss_cls1 + loss_cls_ivt + w_con * loss_con
                         + w_proto * loss_proto + w_tail * loss_tail)
            metrics.update(loss_con=loss_con, loss_proto=loss_proto,
                           loss_tail=loss_tail, loss=total)
            enq.update(k=k, lab_ivt=lab_ivt)
            return total, metrics

        state.model.train()
        params = [p for p in state.model.parameters() if p.requires_grad]
        if sam_rho > 0:
            grads, metrics = sam_gradients(loss_fn, params, rho=sam_rho,
                                           has_aux=True, module=state.model)
        else:
            loss, metrics = loss_fn()
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        for p, g in zip(params, grads):  # zero where the loss misses it
            p.grad = torch.zeros_like(p) if g is None else g
        state.optimizer.step()
        state.step += 1
        # the momentum update and the enqueue come after the update
        moco_mod.momentum_update(state.model, state.key_model, moco_m)
        if enq:
            moco_mod.enqueue(queue, enq["k"], enq["lab_ivt"], valid)
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def make_terl_eval_step(model: TERLModel, ht_masks=None):
    """``(state, images) -> (sigmoid probabilities by task, pooled
    feature)`` of the state's module in ``.eval()`` (on the card its Swin
    blocks run K3 and K4); ``model`` is accepted for parity."""
    del model

    def step(state: TERLTrainState, images):
        dev = _device_of(state)
        state.model.eval()
        with torch.inference_mode():
            out = state.model.encode(torch.as_tensor(images).to(dev),
                                     ht_masks)
        return ({k: torch.sigmoid(v) for k, v in out["logits"].items()},
                out["feature"])

    return step
