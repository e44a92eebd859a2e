"""Losses of the port (so far: BCE with logits and the class pos-weights)."""

from .bce import (TARGET_POS_WEIGHT, TOOL_POS_WEIGHT, VERB_POS_WEIGHT,
                  bce_with_logits)

__all__ = ["TARGET_POS_WEIGHT", "TOOL_POS_WEIGHT", "VERB_POS_WEIGHT",
           "bce_with_logits"]
