"""Training-side code of the port: JAX-compatible checkpoints (read and
written), the SGD recipe, SAM and ImbSAM, and the spatial track's train and
eval steps, the temporal TCN's (the MS-TCT step is its driver's,
``cli/temporal_mstct.py``)."""

from .optim import (build_sgd, freeze_swin_early, imbsam_gradients,
                    sam_gradients)
from .schedule import reference_warmup_exp_schedule
from .state import TrainState
from .trainer import (create_train_state, make_spatial_eval_step,
                      make_spatial_train_step, make_tcn_eval_step,
                      make_tcn_train_step)

__all__ = [
    "build_sgd",
    "freeze_swin_early",
    "sam_gradients",
    "imbsam_gradients",
    "reference_warmup_exp_schedule",
    "TrainState",
    "create_train_state",
    "make_spatial_train_step",
    "make_spatial_eval_step",
    "make_tcn_train_step",
    "make_tcn_eval_step",
]
