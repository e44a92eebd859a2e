"""Train and eval steps of the spatial (frame-level) track.

Counterpart of ``computervision_codes_tpu/train/trainer.py``:
``create_train_state``, ``make_spatial_train_step`` and
``make_spatial_eval_step``, and the temporal TCN's ``make_tcn_train_step``
and ``make_tcn_eval_step``. A step is a function ``(state, batch) ->
(state, metrics)`` that runs eagerly on the state's device: the forward in
training mode with the state's generator for its dropout and DropPath
masks, the reference's loss mix (MT4MTLKD/Spatial_cnn/run.py:145-224), the
backward and one optimizer update. Metrics are 0-d tensors on the device;
reading one waits for the step.

The loss is the hard BCE of one task, or for ``loss_type="all"``
``rates[0]`` times the four hard losses plus ``rates[1]`` times the soft
KL (``distill_kl`` of each of the i, v, t logits against the sigmoid of
the teacher's predictions, averaged) plus ``rates[2]`` times the feature
KD (``mse_feature_kd`` of the KD block's i, v, t outputs against the
teacher's features, averaged). As JAX skips a zero-rate term when it
traces the step, such a term is left out when the step is made: it reads
none of its teacher arrays, so a non-finite one cannot reach the loss,
and without the KD term the teacher features do not go into the model.
A parameter the loss does not reach gets a zero gradient (so SGD's weight
decay still moves it, as optax does).

``sam_rho > 0`` takes the gradient by two-step SAM (``train.optim.
sam_gradients``), the BatchNorm statistics from the perturbed pass alone;
``qat`` trains and evaluates through the backbone's weight fake-quant
(``models.qat``). The BatchNorm statistics of a student update in place
in each training forward (the JAX ``batch_stats`` mutation).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..losses import (bce_with_logits, distill_kl, mse_feature_kd,
                      tcn_multitask_loss)
from ..models.qat import qat_params
from .optim import sam_gradients
from .state import TrainState

TASKS = ("i", "v", "t", "ivt")
TEACHER_TASKS = ("i", "v", "t")


def create_train_state(model: nn.Module, optimizer: Callable, seed: int = 0,
                       device: str = "cuda") -> TrainState:
    """Move ``model`` (its weights already made, from a seed or loaded) to
    ``device`` and build its optimizer there (``optimizer``: what
    ``build_sgd`` returns, or ``freeze_swin_early`` of it, which takes the
    named parameters). The state's generator, on the same device, starts
    from ``seed``."""
    model = model.to(device)
    rng = torch.Generator(device=device).manual_seed(seed)
    params = (model.named_parameters() if getattr(optimizer, "named", False)
              else model.parameters())
    return TrainState(model=model, optimizer=optimizer(params), rng=rng)


def _to_device(value, device) -> torch.Tensor:
    return torch.as_tensor(value).to(device, non_blocking=True)


def make_spatial_train_step(model: nn.Module, loss_type: str = "all",
                            rates: Sequence[float] = (1.0, 0.0, 0.1),
                            temperature: float = 4.0,
                            pos_weights: Optional[Dict[str, Any]] = None,
                            sam_rho: float = 0.0, qat: bool = False,
                            device: str = "cuda"):
    """The training step on a batch of ``image`` (B, H, W, 3) and
    ``label_{i,v,t,ivt}`` multi-hot targets, and for ``"all"`` the
    teacher arrays its non-zero terms read, ``teacher_pred_{i,v,t}``
    (logits) and ``teacher_feat_{i,v,t}``: numpy arrays or tensors, moved
    to ``device``. ``pos_weights``: task -> per-class positive weights.
    The metrics are ``hard_loss_{task}`` for each task and ``loss``, and
    for ``"all"`` ``hard_loss``, ``soft_loss`` (where ``rates[1]``) and
    ``kd_loss`` (where ``rates[2]``), where the JAX step has them. The
    step trains the state's module, as the JAX step applies
    ``state.apply_fn``; ``model`` is accepted for parity."""
    if loss_type not in TASKS + ("all",):
        raise ValueError(f"unknown loss_type {loss_type!r}")
    pos_weights = pos_weights or {}
    soft_rate = rates[1] if loss_type == "all" else 0
    kd_rate = rates[2] if loss_type == "all" else 0

    def loss_fn(state: TrainState, batch: Dict[str, Any]):
        def arr(key):
            return _to_device(batch[key], device)

        feats = ([arr(f"teacher_feat_{k}") for k in TEACHER_TASKS]
                 if kd_rate else [None] * 3)
        qat_ctx = qat_params(state.model) if qat else contextlib.nullcontext()
        with qat_ctx:
            out = state.model(arr("image"), *feats, generator=state.rng)
        logits = out["logits"]
        hard = {k: bce_with_logits(logits[k], arr(f"label_{k}"),
                                   pos_weight=pos_weights.get(k))
                for k in TASKS}
        metrics = {f"hard_loss_{k}": v.detach() for k, v in hard.items()}
        if loss_type != "all":
            loss = hard[loss_type]
        else:
            hard_loss = sum(hard[k] for k in TASKS)
            loss = rates[0] * hard_loss
            metrics["hard_loss"] = hard_loss.detach()
            if soft_rate:
                soft = sum(distill_kl(logits[k],
                                      torch.sigmoid(arr(f"teacher_pred_{k}")),
                                      temperature)
                           for k in TEACHER_TASKS) / 3.0
                loss = loss + soft_rate * soft
                metrics["soft_loss"] = soft.detach()
            if kd_rate:
                kd = sum(mse_feature_kd(out["kd"][k], f)
                         for k, f in zip(TEACHER_TASKS, feats)) / 3.0
                loss = loss + kd_rate * kd
                metrics["kd_loss"] = kd.detach()
        metrics["loss"] = loss.detach()
        return loss, metrics

    def step(state: TrainState, batch: Dict[str, Any]
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        state.model.train()
        params = [p for p in state.model.parameters() if p.requires_grad]
        if sam_rho > 0:
            grads, metrics = sam_gradients(lambda: loss_fn(state, batch),
                                           params, rho=sam_rho, has_aux=True,
                                           module=state.model)
        else:
            loss, metrics = loss_fn(state, batch)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        for p, g in zip(params, grads):  # left in place after the update
            p.grad = torch.zeros_like(p) if g is None else g
        state.optimizer.step()
        state.step += 1
        return state, metrics

    return step


def make_spatial_eval_step(model: nn.Module, qat: bool = False,
                           device: str = "cuda"):
    """The eval step ``(state, images) -> (probabilities by task, feature)``
    of ``model``: the state's module, or a twin of another configuration
    (for example ``fused_eval=False`` or ``quant_eval=True``) into which
    the state's weights are copied at each call, as the JAX step applies
    the state's params through the model it is given. ``qat`` evaluates
    the fake-quant weights, the model that is served."""

    def step(state: TrainState, images) -> Tuple[Dict[str, torch.Tensor],
                                                  torch.Tensor]:
        if model is not state.model:
            model.load_state_dict(state.model.state_dict())
        model.eval()
        ctx = qat_params(model) if qat else contextlib.nullcontext()
        with torch.inference_mode(), ctx:
            out = model(_to_device(images, device))
        probs = {k: torch.sigmoid(v) for k, v in out["logits"].items()}
        return probs, out["feature"]

    return step


# ---------------------------------------------------------------------------
# Temporal TCN track


def tcn_loss_step(select: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
                  comp_weight: float = 0.1,
                  pos_weights: Optional[Dict[str, Any]] = None,
                  apply_mask: bool = True, device: str = "cuda"):
    """A TCN training step whose loss is ``select(parts)`` of the
    ``tcn_multitask_loss`` parts: the forward in ``.train()`` (the input
    mask with ``apply_mask``, the channel and layer dropouts, all from the
    state's generator), the backward and one SGD update. The batch holds
    ``features`` (B, T, D) and ``label_{ivt,i,v,t}`` (T, C) or (B, T, C),
    and optionally ``frame_mask`` (T,): numpy arrays or tensors. A
    parameter the selected loss does not reach gets a zero gradient, so
    weight decay moves it as optax does. The metrics are ``loss_{part}``
    of every part and ``loss_selected``."""

    def step(state: TrainState, batch: Dict[str, Any]
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        out = state.model(_to_device(batch["features"], device),
                          apply_mask=apply_mask, generator=state.rng)
        labels = {k: _to_device(batch[f"label_{k}"], device)
                  for k in ("ivt", "i", "v", "t")}
        mask = batch.get("frame_mask")
        parts = tcn_multitask_loss(
            out, labels, comp_weight=comp_weight, pos_weights=pos_weights,
            frame_mask=None if mask is None else _to_device(mask, device))
        loss = select(parts)
        loss.backward()
        for p in state.model.parameters():  # weight decay moves them too
            if p.requires_grad and p.grad is None:
                p.grad = torch.zeros_like(p)
        state.optimizer.step()
        state.step += 1
        return state, {f"loss_{k}": v.detach()
                       for k, v in dict(parts, selected=loss).items()}

    return step


def make_tcn_train_step(model: nn.Module, comp_weight: float = 0.1,
                        pos_weights: Optional[Dict[str, Any]] = None,
                        apply_mask: bool = True, device: str = "cuda"):
    """The JAX ``make_tcn_train_step``: ``tcn_loss_step`` on the fusion
    loss's total, comp_weight (i + v + t) + ivt. The step trains the
    state's module; ``model`` is accepted for parity."""
    del model
    return tcn_loss_step(lambda parts: parts["total"], comp_weight,
                         pos_weights, apply_mask, device)


def make_tcn_eval_step(model: nn.Module, device: str = "cuda"):
    """``(state, features) -> {task: sigmoid of pyramid level 0}`` in
    ``.eval()`` (every dilated layer through K1 on the card), as the
    reference evaluates (Temporal_tenco/run.py:252-264). The state's
    module runs; ``model`` is accepted for parity."""
    del model

    def step(state: TrainState, features) -> Dict[str, torch.Tensor]:
        state.model.eval()
        with torch.inference_mode():
            out = state.model(_to_device(features, device))
        return {k: torch.sigmoid(out[k][0]) for k in ("ivt", "i", "v", "t")}

    return step
