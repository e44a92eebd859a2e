"""Binary cross-entropy with logits, with the reference's class pos-weights.

Counterpart of ``computervision_codes_tpu/losses/bce.py``: the stable form
torch's ``BCEWithLogitsLoss(pos_weight=...)`` computes, in float32, with
``mean``, ``sum`` and ``none`` reductions.
"""

from __future__ import annotations

import torch

# Constant per-class positive weights "from average of the random sampling of
# the dataset" (MT4MTLKD/Spatial_cnn/run.py:305-310): dataset statistics,
# used by the spatial drivers for the i/v/t heads.
TOOL_POS_WEIGHT = (0.93487068, 0.94234964, 0.93487068, 1.18448115,
                   1.02368339, 0.97974447)
VERB_POS_WEIGHT = (0.60002400, 0.60002400, 0.60002400, 0.61682467,
                   0.67082683, 0.80163207, 0.70562823, 2.11208448,
                   2.69230769, 0.60062402)
TARGET_POS_WEIGHT = (0.49752894, 0.52041527, 0.49752894, 0.51394739,
                     2.71899565, 1.75577963, 0.58509403, 1.25228034,
                     0.49752894, 2.42993134, 0.49802647, 0.87266576,
                     1.36074165, 0.50150917, 0.49802647)


def _as_f32(value, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.float32, device=like.device)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    pos_weight=None, weight=None,
                    reduction: str = "mean") -> torch.Tensor:
    """Elementwise -[w_p y log sigma(x) + (1 - y) log(1 - sigma(x))] in
    float32, as (1 - y) x + (1 + (w_p - 1) y) (log1p(exp(-|x|)) +
    max(-x, 0)); ``weight`` scales each element; then the reduction."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"unknown reduction {reduction!r}")
    x, y = logits.float(), targets.float()
    log_weight = (torch.ones_like(x) if pos_weight is None
                  else 1.0 + (_as_f32(pos_weight, x) - 1.0) * y)
    loss = (1.0 - y) * x + log_weight * (
        torch.log1p(torch.exp(-x.abs())) + torch.clamp(-x, min=0.0))
    if weight is not None:
        loss = loss * _as_f32(weight, x)
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss
