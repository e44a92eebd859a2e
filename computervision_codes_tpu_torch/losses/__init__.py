"""Losses of the port: BCE with logits and the class pos-weights, the
distillation losses, the TCN's fusion loss and TERL's losses (ASL, the
component maps, the k-positive contrastive losses)."""

from .bce import (TARGET_POS_WEIGHT, TOOL_POS_WEIGHT, VERB_POS_WEIGHT,
                  bce_with_logits)
from .distill import distill_kl, mse_feature_kd
from .fusion import fpn_level_loss, tcn_multitask_loss

__all__ = ["TARGET_POS_WEIGHT", "TOOL_POS_WEIGHT", "VERB_POS_WEIGHT",
           "bce_with_logits", "distill_kl", "mse_feature_kd",
           "fpn_level_loss", "tcn_multitask_loss"]
