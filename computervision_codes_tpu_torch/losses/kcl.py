"""k-positive contrastive losses (TERL's tail-enhanced representation
learning).

Counterpart of ``computervision_codes_tpu/losses/kcl.py`` (the reference's
TERL/6_baseline_learnT/loss.py: ``KCL`` :72-117, ``KCLProto`` :120-163,
``SupConLoss_ccl`` :166-190, ``SupConLoss_rank`` :193-227, ``LDAMLoss``
:8-30). Logits are MoCo's: column 0 the positive pair, columns 1..K the
queue (the positive mask gets a column of ones in front, loss.py:111).

``k_positive_mask`` keeps up to k positives of each row: k uniform draws
with replacement from the row's positives, their union, as the reference's
loop of k draws and the JAX version's k categorical draws (the same
distribution; the draws come from a ``torch.Generator``, so they are not
JAX's). At ``k == 0`` every positive is kept and nothing is drawn.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def k_positive_mask(generator: Optional[torch.Generator], mask: torch.Tensor,
                    k: int) -> torch.Tensor:
    """Up to k positives a row of the {0, 1} ``mask`` (B, K), drawn
    uniformly with replacement; a row without positives stays zero."""
    mask = mask.float()
    has_pos = mask.sum(dim=1) > 0
    # a row with no positive draws from every column, then is zeroed
    weights = torch.where(has_pos[:, None], mask, torch.ones_like(mask))
    idx = torch.multinomial(weights, k, replacement=True, generator=generator)
    out = torch.zeros_like(mask).scatter_(1, idx, 1.0)
    return out * has_pos[:, None].float()


def _log_prob(logits: torch.Tensor) -> torch.Tensor:
    # the reference's F.normalize(logits.exp(), dim=1, p=1).log()
    return F.log_softmax(logits, dim=1)


def kcl_loss(generator: Optional[torch.Generator], logits: torch.Tensor,
             pos_mask: torch.Tensor, k: int = 7, temperature: float = 0.07,
             anchor_valid=None) -> torch.Tensor:
    """KCL over MoCo logits (B, 1 + K); ``pos_mask`` (B, K) marks the queue's
    positives; ``anchor_valid`` (B,) leaves padded anchors out."""
    logits = logits.float() / temperature
    pos_mask = pos_mask.float()
    sampled = (k_positive_mask(generator, pos_mask, k) if k > 0
               else pos_mask)
    mask = torch.cat([torch.ones_like(sampled[:, :1]), sampled], dim=1)
    per_anchor = (mask * _log_prob(logits)).sum(dim=1) / mask.sum(dim=1)
    if anchor_valid is None:
        return -per_anchor.sum() / mask.shape[0]
    v = torch.as_tensor(anchor_valid, dtype=torch.float32,
                        device=logits.device)
    return -(per_anchor * v).sum() / torch.clamp(v.sum(), min=1.0)


def kcl_proto_loss(generator: Optional[torch.Generator], logits: torch.Tensor,
                   proto_mask: torch.Tensor, k: int = 7,
                   temperature: float = 0.07) -> torch.Tensor:
    """KCL against class prototypes: ``logits`` (B, P), ``proto_mask`` (B, P)
    the positives; anchors without positives contribute 0."""
    logits = logits.float() / temperature
    proto_mask = proto_mask.float()
    valid = proto_mask.sum(dim=1) > 0
    n_valid = valid.sum()
    sampled = (k_positive_mask(generator, proto_mask, k) if k > 0
               else proto_mask)
    denom = torch.clamp(sampled.sum(dim=1), min=1.0)
    per_anchor = (sampled * _log_prob(logits)).sum(dim=1) / denom
    total = -torch.where(valid, per_anchor, torch.zeros_like(per_anchor)).sum()
    return torch.where(n_valid > 0, total / torch.clamp(n_valid, min=1),
                       torch.zeros_like(total))


def supcon_ccl_loss(logits: torch.Tensor, label_mask: torch.Tensor,
                    cluster_mask: torch.Tensor, gamma: float = 0.2,
                    temperature: float = 0.07) -> torch.Tensor:
    """Cluster + label supervised-contrastive mix (loss.py:166-190)."""
    lp = _log_prob(logits.float() / temperature)
    ones = torch.ones(logits.shape[0], 1, device=logits.device)
    lm = torch.cat([ones, label_mask.float()], dim=1)
    cm = torch.cat([ones, cluster_mask.float()], dim=1)
    loss_label = -((lm * lp).sum(1) / lm.sum(1)).sum() / lm.shape[0]
    loss_cluster = -((cm * lp).sum(1) / cm.sum(1)).sum() / cm.shape[0]
    return loss_cluster + gamma * loss_label


def supcon_rank_loss(logits: torch.Tensor, label_mask: torch.Tensor,
                     cluster_mask: torch.Tensor, temperature: float = 0.07,
                     ranking_temperature: float = 0.12,
                     gamma: float = 0.2) -> torch.Tensor:
    """The ranking variant (loss.py:193-227): label positives compete only
    outside the anchor's cluster."""
    b = logits.shape[0]
    logits = logits.float()
    ones = torch.ones(b, 1, device=logits.device)
    cm = cluster_mask.float()
    cm_full = torch.cat([ones, cm], dim=1)
    lp_cluster = _log_prob(logits / temperature)
    loss_cluster = -((cm_full * lp_cluster).sum(1) / cm_full.sum(1)).sum() / b
    inverse = 1.0 - cm
    lm_full = torch.cat([ones, inverse * label_mask.float()], dim=1)
    inv_full = torch.cat([ones, inverse], dim=1)
    z = logits / ranking_temperature
    log_denom = torch.log((torch.exp(z) * inv_full).sum(1, keepdim=True))
    loss_label = -((lm_full * (z - log_denom)).sum(1)
                   / torch.clamp(lm_full.sum(1), min=1e-12)).sum() / b
    return loss_cluster + gamma * loss_label


def ldam_loss(logits: torch.Tensor, target: torch.Tensor, cls_num_list,
              max_m: float = 0.5, s: float = 30.0,
              weight=None) -> torch.Tensor:
    """Label-distribution-aware margin loss (loss.py:8-30); ``target`` the
    (B,) int class ids."""
    dev = logits.device
    m_list = 1.0 / torch.sqrt(torch.sqrt(torch.as_tensor(
        cls_num_list, dtype=torch.float32, device=dev)))
    m_list = m_list * (max_m / m_list.max())
    index = F.one_hot(target.long(), logits.shape[1]).float()
    x_m = logits.float() - (index @ m_list)[:, None]
    out = torch.where(index > 0, x_m, logits.float())
    nll = -(index * F.log_softmax(s * out, dim=1)).sum(dim=1)
    if weight is None:
        return nll.mean()
    w = torch.as_tensor(weight, dtype=torch.float32, device=dev)[target.long()]
    return (nll * w).sum() / w.sum()
