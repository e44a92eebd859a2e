"""Training-side code of the port: reading JAX checkpoints, the SGD recipe
and the spatial track's train and eval steps."""

from .optim import build_sgd
from .schedule import reference_warmup_exp_schedule
from .state import TrainState
from .trainer import (create_train_state, make_spatial_eval_step,
                      make_spatial_train_step)

__all__ = [
    "build_sgd",
    "reference_warmup_exp_schedule",
    "TrainState",
    "create_train_state",
    "make_spatial_train_step",
    "make_spatial_eval_step",
]
