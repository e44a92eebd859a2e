"""Int8 Dense layers for any model of the port (the int8 teacher).

Counterpart of ``computervision_codes_tpu/models/quant_dense.py``, which
swaps every flax ``nn.Dense`` call for a symmetric int8 matmul by method
interception. Here the calibrated ``models.common.Dense`` modules are
replaced in the module tree by ``Int8Dense``:

* weights: per-output-channel absmax scales, quantized once from the
  float32 parameters (``quantize_dense_params``; the JAX package quantizes
  the float32 tree too);
* activations: one static scale per layer, ``max(absmax * margin / 127,
  1e-8)`` in Python float, then float32, where absmax is the largest
  |input| the layer saw in one calibration forward, over all its calls
  (Q2L's transformer runs once per task decoder);
* the product: ``xq = clip(round(x / s_act), -127, 127)``, int8 x int8 ->
  int32 exactly, then ``acc * (s_act * s_w) + bias`` in float32, rounded
  to the layer's dtype.

That is the math of ``ops.quant``'s int8 convolution at 1x1, so on CUDA
tensors an ``Int8Dense`` runs on the hand-written kernel Q1
(``csrc/qconv_bn.cu``) over an (M, 1, 1, K) view of its input, and on CPU
tensors on Q1's exact plain version. Layers are keyed by their flax path:
the module names from the model's root joined by "/", as the JAX
``_dense_path`` joins them.

Use::

    scales = collect_dense_scales(model, frames)   # one float forward
    qdense = quantize_dense_params(model)
    apply_int8_dense(model, qdense, scales, min_features=512)
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

from ..ops.quant import _qconv_bn, quantize_weight
from .common import Dense


def dense_layers(model: nn.Module) -> Dict[str, Dense]:
    """Every ``Dense`` of ``model`` by its flax path."""
    return {name.replace(".", "/"): m for name, m in model.named_modules()
            if isinstance(m, Dense)}


def collect_dense_scales(model: nn.Module, *args, margin: float = 1.0,
                         **kwargs) -> Dict[str, float]:
    """One forward of ``model(*args, **kwargs)`` (in inference mode)
    recording the absmax of every called ``Dense``'s input, the max over
    its calls; returns each layer's static activation scale."""
    absmax: Dict[str, torch.Tensor] = {}

    def hook(path):
        def record(_module, inputs):
            m = inputs[0].float().abs().amax()
            absmax[path] = (torch.maximum(absmax[path], m) if path in absmax
                            else m)
        return record

    handles = [m.register_forward_pre_hook(hook(path))
               for path, m in dense_layers(model).items()]
    try:
        with torch.inference_mode():
            model(*args, **kwargs)
    finally:
        for handle in handles:
            handle.remove()
    return {k: max(float(v) * margin / 127.0, 1e-8)
            for k, v in absmax.items()}


def quantize_dense_params(model: nn.Module
                          ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Every ``Dense`` kernel (in, out) as (int8 codes (in, out), float32
    scales (out,)), from the float32 parameters."""
    with torch.no_grad():
        return {path: quantize_weight(m.kernel.float(), axis=-1)
                for path, m in dense_layers(model).items()}


class Int8Dense(nn.Module):
    """A ``Dense`` with int8 weights and a static activation scale. It
    keeps the replaced layer's ``kernel`` and ``bias`` parameters (so the
    module tree still loads by name); its int8 operands are buffers in
    Q1's layout: ``w_q`` (out, 1, 1, in), ``mult`` = the weight scales,
    ``qbias`` the float32 bias (zeros without one) and ``act_scale``."""

    def __init__(self, dense: Dense, w_q: torch.Tensor, s_w: torch.Tensor,
                 act_scale: float):
        super().__init__()
        self.dtype = dense.dtype
        self.kernel, self.bias = dense.kernel, dense.bias
        dev = dense.kernel.device
        cin, cout = w_q.shape
        with torch.no_grad():
            qbias = (torch.zeros(cout, device=dev) if dense.bias is None
                     else dense.bias.detach().float().clone())
        self.register_buffer("w_q", w_q.t().reshape(cout, 1, 1, cin)
                             .contiguous().to(dev))
        self.register_buffer("mult", s_w.float().to(dev))
        self.register_buffer("qbias", qbias)
        self.register_buffer("act_scale", torch.tensor(
            [act_scale], dtype=torch.float32, device=dev))

    def forward(self, x):
        lead, cin = x.shape[:-1], x.shape[-1]
        qw = {"w_q": self.w_q, "mult": self.mult, "bias": self.qbias}
        out = _qconv_bn(x.reshape(-1, 1, 1, cin), self.act_scale, qw, 1,
                        "VALID", False, None, self.dtype)
        return out.reshape(*lead, -1)


def apply_int8_dense(model: nn.Module, qdense, scales: Dict[str, float],
                     min_features: int = 0) -> nn.Module:
    """Replace, in place, each ``Dense`` that has int8 weights in
    ``qdense`` and a scale in ``scales`` and takes at least
    ``min_features`` inputs by an ``Int8Dense``; the others stay float (the
    JAX ``int8_apply``). Returns ``model``."""
    for path, dense in dense_layers(model).items():
        if path not in qdense or path not in scales:
            continue
        w_q, s_w = qdense[path]
        if w_q.shape[0] < min_features:
            continue
        parent_path, _, name = path.rpartition("/")
        parent = model.get_submodule(parent_path.replace("/", "."))
        setattr(parent, name, Int8Dense(dense, w_q, s_w, scales[path]))
    return model
