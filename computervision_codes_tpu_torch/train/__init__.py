"""Training-side code of the port: JAX-compatible checkpoints (read and
written), the SGD recipe and the spatial track's train and eval steps (the
MS-TCT step is its driver's, ``cli/temporal_mstct.py``)."""

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
