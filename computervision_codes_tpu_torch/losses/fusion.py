"""Multi-scale FPN fusion loss of the temporal TCN stages.

Counterpart of ``computervision_codes_tpu/losses/fusion.py`` (the
reference's ``fusion`` + per-level BCE loop, MT4MTLKD/Temporal_tenco/
run.py:159-212; TERL/0_5fold_TCN_black/run.py:273-343):

- each pyramid level's logits are compared against the labels; where a
  level's length differs from the labels' (``--hier``), the labels are
  nearest-resized to the level's length (torch's asymmetric rule);
- the mean BCE of each level, summed over the levels; with a
  ``frame_mask`` (T,) the padded frames leave both the sum and the count
  (the mask nearest-resized with the labels);
- total = ``comp_weight`` (i + v + t) + ivt.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from ..models.common import interpolate_1d
from .bce import bce_with_logits

TASKS = ("ivt", "i", "v", "t")


def _resize_labels(labels: torch.Tensor, length: int) -> torch.Tensor:
    """(B, T, C) -> (B, length, C), nearest."""
    if labels.shape[1] == length:
        return labels
    return interpolate_1d(labels.transpose(1, 2), length,
                          "nearest").transpose(1, 2)


def fpn_level_loss(levels: Sequence[torch.Tensor], labels: torch.Tensor,
                   pos_weight=None,
                   frame_mask: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Sum over the pyramid levels (B, T_l, C) of the mean BCE against
    ``labels`` (T, C) or (B, T, C); ``frame_mask`` (T,) excludes padded
    frames."""
    if labels.ndim == 2:
        labels = labels[None]
    labels = labels.float()
    total = 0.0
    for lvl in levels:
        la = _resize_labels(labels, lvl.shape[1])
        la = la.expand(lvl.shape[0], *la.shape[1:])
        loss = bce_with_logits(lvl, la, pos_weight=pos_weight,
                               reduction="none")
        if frame_mask is None:
            total = total + loss.mean()
            continue
        fm = _resize_labels(frame_mask.float()[None, :, None], lvl.shape[1])
        total = total + (loss * fm).sum() / torch.clamp(
            fm.sum() * lvl.shape[0] * la.shape[2], min=1.0)
    return total


def tcn_multitask_loss(outputs: Dict[str, List[torch.Tensor]],
                       labels: Dict[str, torch.Tensor],
                       comp_weight: float = 0.1,
                       pos_weights: Optional[Dict] = None,
                       frame_mask: Optional[torch.Tensor] = None) -> Dict:
    """Each task's ``fpn_level_loss`` and their ``total``, comp_weight (i +
    v + t) + ivt (run.py:196-212)."""
    pos_weights = pos_weights or {}
    parts = {task: fpn_level_loss(outputs[task], labels[task],
                                  pos_weight=pos_weights.get(task),
                                  frame_mask=frame_mask)
             for task in TASKS}
    parts["total"] = comp_weight * (parts["i"] + parts["v"] + parts["t"]) \
        + parts["ivt"]
    return parts
