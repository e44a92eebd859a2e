"""The training state: the module, its optimizer, the step count and the
dropout generator.

Counterpart of ``computervision_codes_tpu/train/state.py::TrainState``. The
JAX state is one immutable pytree (params, optimizer state, rng) that a
jitted step returns anew; here the module holds the parameters and the
optimizer its state, both updated in place. The JAX ``next_rng`` (split the
carried key, use one half for the step's dropout) becomes a draw from
``rng``, a ``torch.Generator`` on the model's device that every step's
dropout and DropPath masks come from.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    rng: torch.Generator
    step: int = 0
