"""Small utilities of the reference's vendored Q2L utils.

The port's copy of ``computervision_codes_tpu/utils/misc.py``: the pieces
of MT4MTLKD/Spatial_transformer/utils/ with live semantics.

- ``clean_state_dict``: 'module.' prefixes stripped (misc.py:392);
- ``ModelEma``: an exponential moving average of a module's parameters
  (network.py:207-232), held in a copy of the module and updated in place
  under ``torch.no_grad()``;
- ``cutout``: random erasing of a rectangle (cutout.py), numpy;
- ``voc_mAP``: the Q2L-style global AP over concatenated frames
  (utils/metric.py);
- ``load_config``: a yaml or json file as a dot-accessible namespace (the
  vendored mmcv-style SLConfig; yaml is imported only for a yaml file).
"""

from __future__ import annotations

import copy
import json
import warnings
from types import SimpleNamespace
from typing import Dict

import numpy as np
import torch
import torch.nn as nn


def clean_state_dict(state_dict: Dict) -> Dict:
    """Strip 'module.' prefixes from (torch) checkpoint keys."""
    return {(k[7:] if k.startswith("module.") else k): v
            for k, v in state_dict.items()}


class ModelEma:
    """Exponential moving average of ``model``'s parameters: ``module`` is a
    copy that ``update`` moves to e d + p (1 - d) and ``set`` resets."""

    def __init__(self, model: nn.Module, decay: float = 0.9997):
        self.decay = decay
        self.module = copy.deepcopy(model)
        for p in self.module.parameters():
            p.requires_grad_(False)

    @torch.no_grad()
    def update(self, model: nn.Module) -> nn.Module:
        d = self.decay
        for e, p in zip(self.module.parameters(), model.parameters()):
            e.copy_(e * d + p * (1.0 - d))
        return self.module

    @torch.no_grad()
    def set(self, model: nn.Module) -> nn.Module:
        for e, p in zip(self.module.parameters(), model.parameters()):
            e.copy_(p)
        return self.module


def cutout(rng: np.random.Generator, image: np.ndarray,
           factor: float = 0.5) -> np.ndarray:
    """Random-erase a rectangle with a random colour (reference
    CutoutPIL)."""
    h, w = image.shape[:2]
    ch = int(rng.uniform(0, factor) * h)
    cw = int(rng.uniform(0, factor) * w)
    if ch == 0 or cw == 0:
        return image
    y = int(rng.integers(0, h - ch + 1))
    x = int(rng.integers(0, w - cw + 1))
    out = image.copy()
    out[y:y + ch, x:x + cw] = rng.integers(0, 256,
                                           size=(1, 1, image.shape[2]))
    return out


def voc_mAP(scores: np.ndarray, targets: np.ndarray) -> float:
    """Global (not video-wise) mAP over concatenated frames (Q2L
    metric.py)."""
    from ..metrics.recognition import classwise_ap

    ap = classwise_ap(targets, scores)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return float(np.nanmean(ap))


def load_config(path: str) -> SimpleNamespace:
    """A yaml or json config file as a dot-accessible namespace."""
    with open(path) as f:
        if path.endswith((".yaml", ".yml")):
            import yaml

            data = yaml.safe_load(f)
        else:
            data = json.load(f)

    def ns(obj):
        if isinstance(obj, dict):
            return SimpleNamespace(**{k: ns(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [ns(v) for v in obj]
        return obj

    return ns(data)
