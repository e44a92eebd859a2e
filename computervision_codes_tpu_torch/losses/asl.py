"""Asymmetric focal loss for multi-label classification (ASL).

Counterpart of ``computervision_codes_tpu/losses/asl.py``. Both reference
variants: MT4MTLKD's (Spatial_transformer/models/aslloss.py), a scalar
``-loss.sum()`` (``reduction="sum"``), and TERL's
(TERL/6_baseline_learnT/models/aslloss.py:111-115), the per-class vector
``-loss.sum(dim=0) / B * 1000`` (``"terl"``) whose call sites take the
mean (``"mean_terl"``), built with gamma_neg 2, gamma_pos 0, clip 0, eps
1e-5 (run.py:531-536). The focal weight is a constant of the gradient, as
the reference's ``disable_torch_grad_focal_loss=True`` makes it.
``sample_weight`` (B,) weights the rows, and the batch size B becomes
their sum (at least 1): padded anchors drop out.
"""

from __future__ import annotations

import torch

REDUCTIONS = ("sum", "terl", "mean_terl")


def asymmetric_loss(logits: torch.Tensor, targets: torch.Tensor,
                    gamma_neg: float = 4.0, gamma_pos: float = 1.0,
                    clip: float = 0.05, eps: float = 1e-8,
                    reduction: str = "sum",
                    sample_weight=None) -> torch.Tensor:
    """ASL of (B, C) logits against multi-hot (B, C) targets, in float32."""
    if reduction not in REDUCTIONS:
        raise ValueError(f"unknown reduction {reduction!r}; one of "
                         f"{REDUCTIONS}")
    logits, targets = logits.float(), targets.float()
    anti = 1.0 - targets
    xs_pos = torch.sigmoid(logits)
    xs_neg = 1.0 - xs_pos
    if clip and clip > 0:
        xs_neg = torch.clamp(xs_neg + clip, max=1.0)
    loss = targets * torch.log(torch.clamp(xs_pos, min=eps))
    loss = loss + anti * torch.log(torch.clamp(xs_neg, min=eps))
    if gamma_neg > 0 or gamma_pos > 0:
        pt = xs_pos * targets + xs_neg * anti
        gamma = gamma_pos * targets + gamma_neg * anti
        loss = loss * torch.pow(1.0 - pt, gamma).detach()
    if sample_weight is not None:
        w = torch.as_tensor(sample_weight, dtype=torch.float32,
                            device=logits.device)[:, None]
        loss = loss * w
        denom = torch.clamp(w.sum(), min=1.0)
    else:
        denom = torch.tensor(float(logits.shape[0]), device=logits.device)
    if reduction == "sum":
        return -loss.sum()
    per_class = -loss.sum(dim=0) / denom * 1000.0
    return per_class if reduction == "terl" else per_class.mean()
