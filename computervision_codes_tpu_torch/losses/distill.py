"""Knowledge-distillation losses; the port's copy of ``losses/distill.py``
in the JAX package.

* ``distill_kl``: Hinton soft-label KL (reference DistillKL,
  MT4MTLKD/Spatial_cnn/run.py:284-295): KL(log_softmax(s/T) ||
  softmax(t/T)) summed, scaled by T²/B, in float32. The reference feeds
  *sigmoid-activated* teacher predictions as ``y_t`` (run.py:180-182);
  callers do the same. The target's log is taken of ``clip(p_t, 1e-12)``,
  as in JAX, which is not ``F.kl_div`` (whose ``xlogy`` gives 0 where
  the target is 0).
* ``mse_feature_kd``: MSE feature-matching KD (run.py:187-191,
  torch.nn.MSELoss default mean reduction), in float32.
"""

from __future__ import annotations

import torch


def distill_kl(y_s: torch.Tensor, y_t: torch.Tensor,
               temperature: float = 4.0) -> torch.Tensor:
    t = temperature
    log_p_s = torch.log_softmax(y_s.float() / t, dim=1)
    p_t = torch.softmax(y_t.float() / t, dim=1)
    kl = p_t * (torch.log(torch.clamp_min(p_t, 1e-12)) - log_p_s)
    return kl.sum() * (t ** 2) / y_s.shape[0]


def mse_feature_kd(student_feat: torch.Tensor,
                   teacher_feat: torch.Tensor) -> torch.Tensor:
    diff = student_feat.float() - teacher_feat.float()
    return (diff ** 2).mean()
