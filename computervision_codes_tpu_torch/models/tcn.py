"""Dilated TCN + FPN temporal student: the eval forward and training.

Counterpart of ``models/tcn.py`` in the JAX package: a 1x1 input conv, a
prediction-generation stage of ``num_layers_pg`` dilated residual layers
(dilation 2^i), ``num_refinements`` stages of ``num_layers_r`` layers, a
one-lateral FPN over the stage features (every level goes through the
single ``latlayer1``) and four shared heads applied to every level.

Layout is (B, T, C) throughout. Parameters are held in float32 and cast to
the module's compute ``dtype`` at use, as flax does. In ``.eval()`` every
dilated layer runs through ``ops.dilated_conv.dilated_residual_fused``: the
CUDA kernel (K1) for CUDA tensors, the plain version for CPU tensors. In
``.train()`` no layer calls it: each runs the plain expression of the JAX
module's train path with its dropout (rate ``dropout``, 0.5) between the
1x1 product and the residual, as the JAX layer does (``:75,89`` there; its
kernel has no backward, and training never reaches it). The training
forward also takes, as the JAX module: with ``apply_mask``, an elementwise
Bernoulli input mask keeping 1 - ``mask_rate`` of the features, then a
channel dropout (rate ``channel_dropout``) constant over T. Every mask is
drawn from the ``generator`` passed to ``forward``.

Child modules carry the flax module names (``pg_conv_in``, ``pg``,
``refine0``, ``layer0``, ``fpn``, ``latlayer1``, ``head_ivt`` ...) so that
``models.convert.load_jax_variables`` maps the JAX tree by name.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.dilated_conv import dilated_residual_fused
from .common import drop, interpolate_1d, keep_mask


def _trunc_normal(shape, fan_in: int, scale: float,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """variance_scaling(scale, "fan_in", "truncated_normal"), as flax's
    initialiser draws it (std corrected for the cut at two sigma)."""
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    w = torch.empty(shape)
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
    return w


class Conv1x1(nn.Module):
    """flax ``nn.Conv(features, (1,))`` over (B, T, Cin): a linear map.

    ``weight`` is (Cout, Cin) as in ``nn.Linear``; initialised lecun-normal
    with zero bias, as flax's defaults.
    """

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(_trunc_normal(
            (out_features, in_features), in_features, 1.0, generator))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class DilatedResidualLayer(nn.Module):
    """conv(k3, dilated) -> relu -> conv1x1 -> dropout -> +residual.

    ``w_taps`` (3, C, C) = [left, centre, right], ``w2`` (C, C) in the JAX
    layout, which is the layout the kernel takes. ``causal`` pads 2 d zeros
    at the front instead of d on each side.
    """

    def __init__(self, dilation: int, features: int, causal: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 dropout: float = 0.5):
        super().__init__()
        c = features
        self.dilation, self.causal, self.dtype = dilation, causal, dtype
        self.dropout = dropout
        self.w_taps = nn.Parameter(_trunc_normal((3, c, c), 3 * c, 1.0 / 3.0,
                                                 generator))
        self.b1 = nn.Parameter(torch.zeros(c))
        self.w2 = nn.Parameter(_trunc_normal((c, c), c, 1.0, generator))
        self.b2 = nn.Parameter(torch.zeros(c))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        dt = self.dtype
        w_taps, b1 = self.w_taps.to(dt), self.b1.to(dt)
        w2, b2 = self.w2.to(dt), self.b2.to(dt)
        if not self.training:
            return dilated_residual_fused(x, w_taps, b1, w2, b2,
                                          self.dilation, self.causal)
        d, t = self.dilation, x.shape[1]
        xp = F.pad(x, (0, 0, 2 * d, 0) if self.causal else (0, 0, d, d))
        h = (xp[:, :t] @ w_taps[0] + xp[:, d:d + t] @ w_taps[1]
             + xp[:, 2 * d:2 * d + t] @ w_taps[2] + b1)
        out = torch.relu(h) @ w2 + b2
        if self.dropout:
            keep = 1.0 - self.dropout
            out = drop(out, keep_mask(out.shape, keep, out.device,
                                      generator), keep)
        return x + out


class TCNStage(nn.Module):
    """``num_layers`` dilated residual layers, dilation 2^i, named layer{i}."""

    def __init__(self, num_layers: int, features: int, causal: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"layer{i}", DilatedResidualLayer(
                2 ** i, features, causal, dtype, generator))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        for layer in self.children():
            x = layer(x, generator)
        return x


class FPN1D(nn.Module):
    """Top-down temporal pyramid: linear upsample + the single lateral conv."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.latlayer1 = Conv1x1(features, features, dtype, generator)

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        out = [feats[-1]]
        for c in reversed(feats[:-1]):
            y = self.latlayer1(c)
            up = interpolate_1d(out[-1].transpose(1, 2), y.shape[1], "linear")
            out.append(up.transpose(1, 2) + y)
        return out[::-1]


class TemporalTCN(nn.Module):
    """PG stage + refinements + FPN + shared ivt/i/v/t heads.

    Input (B, T, in_features); returns ``{task: [logits per pyramid level]}``
    plus ``"features"``, the list of level features. ``hier`` average-pools
    (k7, s3) after each refinement, as the JAX module does. ``mask_rate``
    (the JAX default 0.75; the driver's ``--mask`` picks it, else 0) and
    ``channel_dropout`` act in ``.train()`` only.
    """

    def __init__(self, in_features: int = 512, num_layers_pg: int = 11,
                 num_layers_r: int = 10, num_refinements: int = 3,
                 num_f_maps: int = 512, num_classes: int = 100,
                 num_tool: int = 6, num_verb: int = 10, num_target: int = 15,
                 use_fpn: bool = True, causal: bool = False,
                 hier: bool = False, mask_rate: float = 0.75,
                 channel_dropout: float = 0.5,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.use_fpn, self.hier, self.dtype = use_fpn, hier, dtype
        self.mask_rate, self.channel_dropout = mask_rate, channel_dropout
        self.num_refinements = num_refinements
        g = generator
        self.pg_conv_in = Conv1x1(in_features, num_f_maps, dtype, g)
        self.pg = TCNStage(num_layers_pg, num_f_maps, causal, dtype, g)
        for r in range(num_refinements):
            self.add_module(f"refine{r}", TCNStage(
                num_layers_r, num_f_maps, causal, dtype, g))
        if use_fpn:
            self.fpn = FPN1D(num_f_maps, dtype, g)
        for task, n in (("ivt", num_classes), ("i", num_tool),
                        ("v", num_verb), ("t", num_target)):
            self.add_module(f"head_{task}", Conv1x1(num_f_maps, n, dtype, g))

    def forward(self, x: torch.Tensor, apply_mask: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, List[torch.Tensor]]:
        """``apply_mask`` and ``generator`` act in ``.train()`` only: the
        input mask (with ``apply_mask``), the channel dropout and each
        layer's dropout, drawn from ``generator`` in that order."""
        x = x.to(self.dtype)
        if self.training:
            if apply_mask and self.mask_rate > 0:
                x = x * keep_mask(x.shape, 1.0 - self.mask_rate, x.device,
                                  generator).to(x.dtype)
            if self.channel_dropout:
                keep = 1.0 - self.channel_dropout
                b, _, c = x.shape  # one draw per (sample, channel)
                x = drop(x, keep_mask((b, 1, c), keep, x.device,
                                      generator).expand_as(x), keep)
        f = self.pg(self.pg_conv_in(x), generator)
        feats = [f]
        for r in range(self.num_refinements):
            f = getattr(self, f"refine{r}")(f, generator)
            if self.hier:
                f = F.avg_pool1d(f.transpose(1, 2), 7, 3).transpose(1, 2)
            feats.append(f)
        if self.use_fpn:
            feats = self.fpn(feats)
        out = {k: [getattr(self, f"head_{k}")(fl) for fl in feats]
               for k in ("ivt", "i", "v", "t")}
        out["features"] = feats
        return out
