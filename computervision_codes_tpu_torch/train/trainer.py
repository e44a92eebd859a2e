"""Train and eval steps of the spatial (frame-level) track.

Counterpart of ``computervision_codes_tpu/train/trainer.py``:
``create_train_state``, ``make_spatial_train_step`` and
``make_spatial_eval_step``. A step is a function ``(state, batch) ->
(state, metrics)`` that runs eagerly on the state's device: the forward in
training mode with the state's generator for its dropout and DropPath
masks, the four hard BCE losses of the reference's loss mix
(MT4MTLKD/Spatial_cnn/run.py:145-224), the backward and one optimizer
update. Metrics are 0-d tensors on the device; reading one waits for the
step.

Not ported yet, and refused when the step is made: the distillation terms
of ``loss_type="all"`` (``rates[1]`` or ``rates[2]`` non-zero: the soft KL
and the KD block), ``sam_rho > 0`` and ``qat`` (the student-training
slice). As JAX skips zero-rate terms when it traces the step, ``"all"``
with ``rates[1] == rates[2] == 0`` is the sum of the four hard losses
times ``rates[0]``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..losses import bce_with_logits
from .state import TrainState

TASKS = ("i", "v", "t", "ivt")
STUDENT_SLICE = "not ported yet (the student-training slice)"


def create_train_state(model: nn.Module, optimizer: Callable, seed: int = 0,
                       device: str = "cuda") -> TrainState:
    """Move ``model`` (its weights already made, from a seed or loaded) to
    ``device`` and build its optimizer there (``optimizer``: what
    ``build_sgd`` returns). The state's generator, on the same device,
    starts from ``seed``."""
    model = model.to(device)
    rng = torch.Generator(device=device).manual_seed(seed)
    return TrainState(model=model, optimizer=optimizer(model.parameters()),
                      rng=rng)


def _to_device(value, device) -> torch.Tensor:
    return torch.as_tensor(value).to(device, non_blocking=True)


def make_spatial_train_step(model: nn.Module, loss_type: str = "all",
                            rates: Sequence[float] = (1.0, 0.0, 0.1),
                            temperature: float = 4.0,
                            pos_weights: Optional[Dict[str, Any]] = None,
                            sam_rho: float = 0.0, qat: bool = False,
                            device: str = "cuda"):
    """The training step on a batch of ``image`` (B, H, W, 3) and
    ``label_{i,v,t,ivt}`` multi-hot targets, numpy arrays or tensors, moved
    to ``device``. ``pos_weights``: task ->
    per-class positive weights. The loss is the hard BCE of ``loss_type``
    (``i``, ``v``, ``t``, ``ivt``), or for ``"all"`` ``rates[0]`` times
    the sum of the four; the metrics are ``hard_loss_{task}`` for each task,
    ``hard_loss`` for ``"all"``, and ``loss``. ``temperature`` weighs the
    distillation term, which is not ported. The step trains the state's
    module, as the JAX step applies ``state.apply_fn``; ``model`` is
    accepted for parity."""
    if loss_type not in TASKS + ("all",):
        raise ValueError(f"unknown loss_type {loss_type!r}")
    if loss_type == "all" and (rates[1] or rates[2]):
        raise NotImplementedError(
            f"loss_type='all' with distillation rates {tuple(rates)} is "
            f"{STUDENT_SLICE}: rates[1] and rates[2] must be 0")
    if sam_rho > 0:
        raise NotImplementedError(f"sam_rho > 0 (SAM) is {STUDENT_SLICE}")
    if qat:
        raise NotImplementedError(f"qat=True is {STUDENT_SLICE}")
    pos_weights = pos_weights or {}

    def step(state: TrainState, batch: Dict[str, Any]
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        state.model.train()
        out = state.model(_to_device(batch["image"], device),
                          generator=state.rng)
        logits = out["logits"]
        hard = {k: bce_with_logits(logits[k],
                                   _to_device(batch[f"label_{k}"], device),
                                   pos_weight=pos_weights.get(k))
                for k in TASKS}
        metrics = {f"hard_loss_{k}": v.detach() for k, v in hard.items()}
        if loss_type == "all":
            hard_loss = sum(hard[k] for k in TASKS)
            loss = rates[0] * hard_loss
            metrics["hard_loss"] = hard_loss.detach()
        else:
            loss = hard[loss_type]
        metrics["loss"] = loss.detach()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, metrics

    return step


def make_spatial_eval_step(model: nn.Module, qat: bool = False,
                           device: str = "cuda"):
    """The eval step ``(state, images) -> (probabilities by task, feature)``
    of ``model``: the state's module, or a twin of another configuration
    (for example ``fused_eval=False``) into which the state's parameters
    are copied at each call, as the JAX step applies the state's params
    through the model it is given."""
    if qat:
        raise NotImplementedError(f"qat=True is {STUDENT_SLICE}")

    def step(state: TrainState, images) -> Tuple[Dict[str, torch.Tensor],
                                                  torch.Tensor]:
        if model is not state.model:
            model.load_state_dict(state.model.state_dict())
        model.eval()
        with torch.inference_mode():
            out = model(_to_device(images, device))
        probs = {k: torch.sigmoid(v) for k, v in out["logits"].items()}
        return probs, out["feature"]

    return step
