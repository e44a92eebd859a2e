"""End-to-end recognizer: pixels -> triplet/component logits (eval forward).

Counterpart of ``models/pipeline.py`` in the JAX package: ResNet over every
frame, then the TCN over the pooled feature sequence. Input (B, T, H, W, 3)
normalised frames; output per-frame logits for the four tasks from TCN
pyramid level 0 plus the (B, T, D) backbone ``features``. ``causal=True``
front-pads every temporal layer (the variant ``serving.StreamingSession``
runs). ``s2d_stem`` and ``fused_stem`` choose the backbone's stem
execution plan (``models.resnet``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from .resnet import VARIANTS as RESNET_VARIANTS, ResNet
from .tcn import TemporalTCN


class EndToEndRecognizer(nn.Module):
    """ResNet student over frames + TCN temporal head (deployed path)."""

    def __init__(self, network: str = "resnet18", num_layers_pg: int = 11,
                 num_layers_r: int = 10, num_refinements: int = 3,
                 num_f_maps: int = 512, causal: bool = False,
                 s2d_stem: bool = False, fused_stem: bool = False,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        sizes, block = RESNET_VARIANTS[network]
        self.network = network
        self.backbone = ResNet(sizes, block, dtype=dtype, generator=generator,
                               s2d_stem=s2d_stem, fused_stem=fused_stem)
        self.tcn = TemporalTCN(
            in_features=self.backbone.num_channels,
            num_layers_pg=num_layers_pg, num_layers_r=num_layers_r,
            num_refinements=num_refinements, num_f_maps=num_f_maps,
            causal=causal, dtype=dtype, generator=generator)

    def forward(self, clips: torch.Tensor) -> Dict[str, torch.Tensor]:
        b, t, h, w, c = clips.shape
        feats = self.backbone(clips.reshape(b * t, h, w, c))["pooled"]
        seq = feats.reshape(b, t, -1)
        out = self.tcn(seq)
        return {"ivt": out["ivt"][0], "i": out["i"][0], "v": out["v"][0],
                "t": out["t"][0], "features": seq}
