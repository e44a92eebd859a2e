"""SGD with the reference's decay rule and an optax-style schedule.

Counterpart of ``computervision_codes_tpu/train/optim.py::build_sgd``:
optax's ``add_decayed_weights`` then ``sgd`` add the L2 term to the
gradient before momentum, which is ``torch.optim.SGD``'s own rule
(MT4MTLKD/Spatial_cnn/run.py:344). SAM, ImbSAM and ``freeze_swin_early``
are not ported yet (the student-training and TERL slices).
"""

from __future__ import annotations

import functools
from typing import Callable, Iterable, Union

import torch

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
