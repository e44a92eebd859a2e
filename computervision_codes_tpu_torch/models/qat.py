"""Quantization-aware fine-tuning (weight fake-quant, straight-through).

The port's copy of ``models/qat.py`` in the JAX package. The int8 serving
path (``models/quantized.py``) quantizes trained float convolution weights
after the fact; QAT trains through the quantizer instead: in the forward
every backbone convolution's weight is replaced by its quantize ->
dequantize image, under the exact policy the serving path applies
(``ops.quant.quantize_weight``: per output channel, clip, 1e-8 floor), with
a straight-through gradient to the float weight. After QAT the served
int8 weights give the forward the training saw.

JAX transforms the parameter tree; here the same substitution is made at
forward time: ``fake_quant_convs`` (and ``qat_params`` over a model's
``backbone``) set each covered ``Conv2d``'s ``weight_fn`` to
``fake_quant_kernel`` for the length of a ``with`` block. The coverage is
``quantize_resnet``'s with its float stem (the serving default):
``layer{s}_{b}`` ``conv1-3`` and ``downsample_conv``.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List

import torch
import torch.nn as nn

from ..ops.quant import quantize_weight
from .resnet import Conv2d

BLOCK_CONVS = ("conv1", "conv2", "conv3", "downsample_conv")


def fake_quant_kernel(w: torch.Tensor) -> torch.Tensor:
    """quantize -> dequantize of an OIHW ``w`` per output channel, with
    identity (straight-through) gradients."""
    q, scale = quantize_weight(w, 0)
    deq = (q.float() * scale.view(-1, *[1] * (w.ndim - 1))).to(w.dtype)
    return w + (deq - w).detach()


def qat_convs(backbone: nn.Module) -> List[Conv2d]:
    """The convolutions of a ResNet backbone that QAT covers."""
    convs = []
    for name, block in backbone.named_children():
        if name.startswith("layer"):
            convs += [getattr(block, c) for c in BLOCK_CONVS
                      if isinstance(getattr(block, c, None), Conv2d)]
    return convs


@contextlib.contextmanager
def fake_quant_convs(backbone: nn.Module) -> Iterator[nn.Module]:
    """Within the block, the backbone's covered convolutions run on their
    fake-quant weights."""
    convs = qat_convs(backbone)
    for conv in convs:
        conv.weight_fn = fake_quant_kernel
    try:
        yield backbone
    finally:
        for conv in convs:
            conv.weight_fn = None


def qat_params(model: nn.Module):
    """The model-level form: fake-quant the model's ``backbone``."""
    return fake_quant_convs(model.backbone)
