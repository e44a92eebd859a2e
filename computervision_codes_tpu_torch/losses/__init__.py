"""Losses of the port: BCE with logits and the class pos-weights, and the
distillation losses."""

from .bce import (TARGET_POS_WEIGHT, TOOL_POS_WEIGHT, VERB_POS_WEIGHT,
                  bce_with_logits)
from .distill import distill_kl, mse_feature_kd

__all__ = ["TARGET_POS_WEIGHT", "TOOL_POS_WEIGHT", "VERB_POS_WEIGHT",
           "bce_with_logits", "distill_kl", "mse_feature_kd"]
