"""Bank-based component maps of the triplet scores.

Counterpart of ``computervision_codes_tpu/losses/components.py``: the
reference's loop of ``torch.max(logit_ivt[:, idxes])`` per component class
(TERL/6_baseline_learnT/run.py:282-294) as one masked max over the
(100, C) projection of ``data.bank``.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..data import bank as bank_mod

COMPONENTS = ("i", "v", "t")


def _projection(comp: str, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(bank_mod.component_projection(comp)).to(
        like.device)


def component_max_logits(ivt_logits: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(..., 100) triplet logits -> {'i': (..., 6), 'v': (..., 10),
    't': (..., 15)}, each the max over the component class's triplets."""
    out = {}
    for comp in COMPONENTS:
        proj = _projection(comp, ivt_logits) > 0
        masked = torch.where(proj, ivt_logits[..., None],
                             torch.tensor(float("-inf"),
                                          dtype=ivt_logits.dtype,
                                          device=ivt_logits.device))
        out[comp] = masked.amax(dim=-2)
    return out


def component_labels(ivt_labels: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Multi-hot triplet labels -> component multi-hot labels (max / OR)."""
    return {comp: (ivt_labels[..., None] * _projection(comp, ivt_labels)
                   .to(ivt_labels.dtype)).amax(dim=-2)
            for comp in COMPONENTS}
