"""Spatial CNN student with the multi-teacher KD cross-task attention.

Counterpart of ``models/spatial_cnn.py`` in the JAX package (the reference
MT4MTLKD/Spatial_cnn/network.py:13-92 ``VideoNas``): a ResNet backbone
whose pooled feature feeds four linear heads (``classifier_{i,v,t,ivt}``,
each a ``Classifier``), and for ``loss_type="all"`` the KD block.

``KDCrossTaskAttention`` computes the reference's math without the
(B, D, D) stack (network.py:55-71): there ``stus[b, c, d] = s[b, c]``, so
the einsum collapses to ``attn[b, c, n] = softmax_n(s[b, c] * sum_d
m_n(t_n)[b, d] / sqrt(D))``, a per-channel weight of each teacher; the
student feature scaled by it is projected by ``w_i``/``w_v``/``w_t`` into
the teacher's space for the MSE feature-KD loss. The JAX block is also the
Q2L teacher's (``models/q2l.py``).

The heads are always made, and the driver picks the logits its loss reads,
as the reference's zero-filled placeholder logits do (network.py:79-82).
Child modules carry the flax names for ``models.convert``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from .common import Classifier, Dense
from .resnet import build_resnet, feature_dim

TASK_SIZES = {"i": 6, "v": 10, "t": 15, "ivt": 100}


class KDCrossTaskAttention(nn.Module):
    """Cross-task attention over three teacher features (module
    docstring): ``m{i,v,t}`` Dense teacher -> student, ``w{i,v,t}`` Dense
    student -> teacher, in the compute dtype."""

    def __init__(self, student_dim: int, teacher_dim: int,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.student_dim, self.dtype = student_dim, dtype
        for k in ("i", "v", "t"):
            self.add_module(f"m{k}", Dense(teacher_dim, student_dim,
                                           dtype=dtype, generator=generator))
            self.add_module(f"w{k}", Dense(student_dim, teacher_dim,
                                           dtype=dtype, generator=generator))

    def forward(self, s: torch.Tensor, feat_i: torch.Tensor,
                feat_v: torch.Tensor, feat_t: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        s = s.to(self.dtype)
        teas = torch.stack([getattr(self, f"m{k}")(f) for k, f in
                            (("i", feat_i), ("v", feat_v), ("t", feat_t))],
                           dim=-1)  # (B, Ds, 3)
        # only the teacher column-sums survive the d-contraction
        scale = 1.0 / torch.sqrt(torch.tensor(float(self.student_dim),
                                              dtype=self.dtype))
        tea_sums = teas.sum(dim=1) * scale.to(teas.device)  # (B, 3)
        attn = torch.softmax(s[:, :, None] * tea_sums[:, None, :], dim=-1)
        return {k: getattr(self, f"w{k}")(s * attn[:, :, n])
                for n, k in enumerate(("i", "v", "t"))}


class SpatialCNN(nn.Module):
    """Frame-level multi-task student: NHWC frames -> ``{"logits": {task:
    (B, K)}, "feature": (B, Ds)}``, plus ``"kd"`` ({i, v, t}: (B,
    teacher_dim)) when the KD block exists and teacher features are given.
    The block exists for ``loss_type="all"`` with a ``teacher_dim``, as the
    JAX block's parameters exist when its init saw teacher features (the
    driver's init)."""

    def __init__(self, network: str = "resnet18", loss_type: str = "all",
                 teacher_dim: Optional[int] = 1536,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.loss_type, self.dtype = loss_type, dtype
        g = generator
        self.backbone = build_resnet(network, dtype=dtype, generator=g)
        dim = feature_dim(network)
        for k, n in TASK_SIZES.items():
            self.add_module(f"classifier_{k}",
                            Classifier(dim, n, dtype=dtype, generator=g))
        if loss_type == "all" and teacher_dim:
            self.kd_attention = KDCrossTaskAttention(dim, teacher_dim, dtype,
                                                     g)

    def forward(self, images: torch.Tensor,
                feat_i: Optional[torch.Tensor] = None,
                feat_v: Optional[torch.Tensor] = None,
                feat_t: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Dict:
        """``generator`` is accepted for the trainer's call (the student
        draws no random masks)."""
        s = self.backbone(images)["pooled"]
        logits = {k: getattr(self, f"classifier_{k}")(s) for k in TASK_SIZES}
        out = {"logits": logits, "feature": s}
        if self.loss_type == "all" and feat_i is not None:
            out["kd"] = kd_forward(self, s, feat_i, feat_v, feat_t)
        return out


def kd_forward(model: nn.Module, s: torch.Tensor, feat_i, feat_v,
               feat_t) -> Dict[str, torch.Tensor]:
    """``model.kd_attention`` over the feature ``s`` and the teacher
    features (cast to the model's dtype); a model made without the block
    raises."""
    kd = getattr(model, "kd_attention", None)
    if kd is None:
        raise ValueError(f"{type(model).__name__} was made without the KD "
                         f"block (loss_type='all' and a teacher_dim make "
                         f"it): it takes no teacher features")
    dt = model.dtype
    return kd(s, feat_i.to(dt), feat_v.to(dt), feat_t.to(dt))
