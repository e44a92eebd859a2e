"""SGD with the reference's decay rule and an optax-style schedule.

Counterpart of ``computervision_codes_tpu/train/optim.py::build_sgd``:
optax's ``add_decayed_weights`` then ``sgd`` add the L2 term to the
gradient before momentum, which is ``torch.optim.SGD``'s own rule
(MT4MTLKD/Spatial_cnn/run.py:344).

``sam_gradients`` and ``imbsam_gradients`` are the JAX functional SAM and
ImbSAM (the reference's TERL/6_baseline_learnT/imbsam.py:5-41 and 49-96):
each gradient comes from a loss evaluated at perturbed parameters,

    SAM:    g1 = ∇L(w);  ε = ρ g1/(|g1| + 1e-16);  g = ∇L(w + ε)
    ImbSAM: g_head = ∇L_head(w);  g_t = ∇L_tail(w);
            ε = ρ g_t/(|g_t| + 1e-16);  g = ∇L_tail(w + ε) + g_head

where |g| is the global norm over every parameter's gradient (a parameter
the loss does not reach has a zero gradient, as in JAX). Here the
parameters are perturbed in place and restored, bit for bit, before the
functions return, so the optimizer applies the gradient at the unperturbed
weights.

``freeze_swin_early`` is TERL's ``--fix_backbone``: the optimizer of the
other parameters, with the Swin patch embed and stages 0-1 frozen.
"""

from __future__ import annotations

import functools
from typing import Callable, Iterable, List, Optional, Sequence, Union

import torch
import torch.nn as nn

LearningRate = Union[float, Callable[[int], float]]


class SGD(torch.optim.SGD):
    """``torch.optim.SGD`` whose lr may be a schedule of the update count:
    before update n (counted from 0) every group's lr is set to
    ``schedule(n)``, as optax evaluates a schedule at the count before it
    is incremented."""

    def __init__(self, params: Iterable, learning_rate: LearningRate,
                 weight_decay: float = 0.0, momentum: float = 0.0):
        self.schedule = learning_rate if callable(learning_rate) else None
        self.count = 0
        lr = self.schedule(0) if self.schedule else learning_rate
        super().__init__(params, lr=lr, momentum=momentum,
                         weight_decay=weight_decay)

    @torch.no_grad()
    def step(self, closure=None):
        if self.schedule is not None:
            for group in self.param_groups:
                group["lr"] = float(self.schedule(self.count))
        loss = super().step(closure)
        self.count += 1
        return loss


def build_sgd(learning_rate: LearningRate, weight_decay: float = 0.0,
              momentum: float = 0.0) -> Callable[[Iterable], SGD]:
    """The optimizer as a function of the parameters it updates (a torch
    optimizer is made over its parameters; ``create_train_state`` calls
    it): SGD with ``learning_rate`` a float or a schedule of the update
    count, L2 ``weight_decay`` and ``momentum`` (0: none)."""
    return functools.partial(SGD, learning_rate=learning_rate,
                             weight_decay=weight_decay, momentum=momentum)


SWIN_EARLY = ("patch_embed", "patch_norm", "stage0_block", "stage1_block",
              "merge0", "merge1")


def is_swin_early(name: str) -> bool:
    """Whether the parameter ``name`` (``named_parameters``) is in a Swin
    backbone's patch embed or stages 0-1, patch merges included: the name
    after its ``backbone`` part starts with one of ``SWIN_EARLY``."""
    parts = name.split(".")
    if "backbone" not in parts:
        return False
    nxt = parts[parts.index("backbone") + 1:]
    return bool(nxt) and nxt[0].startswith(SWIN_EARLY)


def freeze_swin_early(optimizer: Callable[[Iterable], SGD]
                      ) -> Callable[[Iterable], SGD]:
    """TERL ``--fix_backbone``: the reference sets requires_grad=False on
    every backbone parameter whose torch name holds 'patch', 'layers.0' or
    'layers.1' (TERL/6_baseline_learnT/models/backbone.py:203-206), the
    patch embed and its norm and the first two stages with their patch
    merges; the JAX version gives them ``optax.set_to_zero`` (no update,
    no weight decay). Returns the optimizer as a function of the module's
    ``named_parameters()`` (``create_train_state`` passes them when the
    function has ``named``): it sets requires_grad=False on those
    parameters and makes ``optimizer`` over the rest, marked ``frozen``
    (the checkpoint writes the JAX ``multi_transform`` state)."""

    def make(named) -> SGD:
        train = []
        for name, p in named:
            if is_swin_early(name):
                p.requires_grad_(False)
            else:
                train.append(p)
        opt = optimizer(train)
        opt.frozen = True
        return opt

    make.named = True
    return make


def _gradients(loss_fn: Callable, params: Sequence[torch.Tensor],
               has_aux: bool):
    """(the gradient of ``loss_fn()`` for each parameter, zeros where the
    loss does not reach it; the aux output or None)."""
    out = loss_fn()
    loss, aux = out if has_aux else (out, None)
    grads = torch.autograd.grad(loss, list(params), allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)], aux


def _global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """optax's ``global_norm``: the root of every leaf's sum of squares."""
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))


def _perturb(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
             rho: float) -> List[torch.Tensor]:
    """w + g * rho / (|g| + 1e-16), in place; returns copies of the
    parameters before, for ``_restore``."""
    scale = rho / (_global_norm(grads) + 1e-16)
    saved = [p.detach().clone() for p in params]
    with torch.no_grad():
        for p, g in zip(params, grads):
            p.copy_(p + g * scale)
    return saved


def _restore(tensors: Sequence[torch.Tensor],
             saved: Sequence[torch.Tensor]) -> None:
    with torch.no_grad():
        for t, s in zip(tensors, saved):
            t.copy_(s)


def _buffers(module: Optional[nn.Module]) -> List[torch.Tensor]:
    return [] if module is None else list(module.buffers())


def sam_gradients(loss_fn: Callable, params: Sequence[torch.Tensor],
                  rho: float = 0.05, has_aux: bool = False,
                  module: Optional[nn.Module] = None):
    """Two-step SAM gradient of ``loss_fn() -> loss`` (or ``(loss, aux)``)
    over ``params``: a list of gradients (and the second pass's aux). The
    buffers of ``module`` (its BatchNorm statistics) are restored after the
    first pass, so that the perturbed pass alone moves them, as the JAX
    step keeps the batch statistics of that pass."""
    buffers = _buffers(module)
    before = [b.detach().clone() for b in buffers]
    g1, _ = _gradients(loss_fn, params, has_aux)
    _restore(buffers, before)
    saved = _perturb(params, g1, rho)
    try:
        g2, aux2 = _gradients(loss_fn, params, has_aux)
    finally:
        _restore(params, saved)
    return (g2, aux2) if has_aux else g2


def imbsam_gradients(loss_head_fn: Callable, loss_tail_fn: Callable,
                     params: Sequence[torch.Tensor], rho: float = 0.05,
                     module: Optional[nn.Module] = None):
    """Three-step ImbSAM: sharpness-aware for the tail loss only. The
    buffers of ``module`` are restored after each pass (the JAX losses
    return no mutated statistics)."""
    buffers = _buffers(module)
    before = [b.detach().clone() for b in buffers]

    def grad(fn):
        g, _ = _gradients(fn, params, False)
        _restore(buffers, before)
        return g

    g_head = grad(loss_head_fn)
    g_tail = grad(loss_tail_fn)
    saved = _perturb(params, g_tail, rho)
    try:
        g_sharp = grad(loss_tail_fn)
    finally:
        _restore(params, saved)
    return [a + b for a, b in zip(g_sharp, g_head)]
