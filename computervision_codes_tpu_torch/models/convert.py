"""Carry the JAX package's weights into the port's modules.

``load_jax_variables(module, variables)`` takes the variables of the JAX
counterpart of ``module`` (what its ``init`` returns: a nested mapping of
collections ``params``, ``batch_stats`` and ``frozen``, with numpy or JAX
arrays at the leaves) and copies them in, walking the port's module tree by
the flax names its children carry:

* ``conv*/kernel`` (kh, kw, Cin, Cout) HWIO -> conv weight OIHW (TResNet's
  ``stem_conv``, ``conv1-3`` and ``downsample`` too);
* ``bn*``: ``params/{scale,bias}`` + ``batch_stats/{mean,var}`` -> BatchNorm
  ``weight, bias, running_mean, running_var`` (TResNet's ABN holds its
  BatchNorm as ``<abn>/bn``); a frozen BN reads all four from the
  ``frozen`` collection;
* a conv with a bias (Swin's ``patch_embed``) reads ``bias`` too;
* 1x1 ``nn.Conv`` over time (``pg_conv_in``, ``latlayer1``, ``head_*``):
  ``kernel`` (1, Cin, Cout) -> weight (Cout, Cin), plus ``bias``;
* every other parameter is read by its own name and keeps the JAX layout:
  ``Dense`` ``kernel`` (in, out) and ``bias``, any other 1-D ``nn.Conv``
  (MS-TCT's k3 ``merge*/proj`` and depthwise ``lrb/tc``, ``TemporalConv``)
  ``kernel`` (k, Cin / groups, Cout) and ``bias``, ``LayerNorm`` ``scale`` and
  ``bias``, the dilated layers' ``w_taps, b1, w2, b2``, and raw params
  such as ``relative_position_bias_table``, ``query_embed_*`` and
  ``fc_*/{W,b}`` (the ``Mlp`` children are named ``Dense_0``/``Dense_1``,
  as flax names them; TResNet's SE ``fc1``/``fc2`` are ``Dense``).

Every leaf of ``variables`` must be used and every parameter filled:
a missing or extra key raises ``KeyError``, a shape mismatch ``ValueError``.

``jax_variables(module)`` goes the other way: the variables of the JAX
counterpart, as nested dicts of float32 numpy arrays in the JAX layouts
above, so that ``load_jax_variables`` of the result fills an equal module
and a flax checkpoint of the port's weights restores in JAX.

``load_jax_quantized(qmodule, q_backbone)`` does the same for a tree that
the JAX ``quantize_resnet`` / ``calibrate_resnet`` made: int8 ``w_q`` goes
from HWIO to the kernel's (Cout, kh, kw, Cin), ``w`` (a float stem) stays
HWIO, and ``mult``, ``bias`` and ``act_scale`` come across as they are (a
conv without ``act_scale`` in the tree goes back to dynamic scales).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Set, Tuple

import numpy as np
import torch
import torch.nn as nn

from .quantized import QConv
from .resnet import BatchNorm, Conv2d, FrozenBatchNorm
from .tcn import Conv1x1

_COLLECTIONS = ("params", "batch_stats", "frozen")
Path = Tuple[str, ...]


def _leaves(tree, prefix: Path = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),)


class _Loader:
    def __init__(self, variables):
        extra = set(variables) - set(_COLLECTIONS)
        if extra:
            raise KeyError(f"unknown variable collections {sorted(extra)}")
        self.variables = variables
        self.used: Set[Path] = set()

    def get(self, coll: str, path: Path) -> np.ndarray:
        node = self.variables.get(coll, {})
        for i, k in enumerate(path):
            if not isinstance(node, Mapping) or k not in node:
                raise KeyError(f"missing {coll}/{'/'.join(path[:i + 1])}")
            node = node[k]
        self.used.add((coll,) + path)
        return np.asarray(node, dtype=np.float32)

    def put(self, dst: torch.Tensor, value: np.ndarray, where: str) -> None:
        if tuple(dst.shape) != value.shape:
            raise ValueError(f"{where}: shape {value.shape} does not fit "
                             f"{tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(np.array(value)))  # writable copy

    def load(self, module: nn.Module, path: Path) -> None:
        def p(*keys: str) -> Path:
            return path + keys

        name = "/".join(path)
        if isinstance(module, Conv2d):
            kernel = self.get("params", p("kernel"))  # HWIO
            self.put(module.weight, kernel.transpose(3, 2, 0, 1), name)
            if module.bias is not None:
                self.put(module.bias, self.get("params", p("bias")), name)
        elif isinstance(module, Conv1x1):
            kernel = self.get("params", p("kernel"))  # (1, Cin, Cout)
            if kernel.ndim != 3 or kernel.shape[0] != 1:
                raise ValueError(f"{name}: kernel {kernel.shape} is not a "
                                 f"(1, Cin, Cout) 1x1 conv")
            self.put(module.weight, kernel[0].T, name)
            self.put(module.bias, self.get("params", p("bias")), name)
        elif isinstance(module, FrozenBatchNorm):
            for dst, key in (("weight", "scale"), ("bias", "bias"),
                             ("running_mean", "mean"), ("running_var", "var")):
                self.put(getattr(module, dst), self.get("frozen", p(key)),
                         name)
        elif isinstance(module, BatchNorm):
            for dst, coll, key in (("weight", "params", "scale"),
                                   ("bias", "params", "bias"),
                                   ("running_mean", "batch_stats", "mean"),
                                   ("running_var", "batch_stats", "var")):
                self.put(getattr(module, dst), self.get(coll, p(key)), name)
        else:
            for key, param in module.named_parameters(recurse=False):
                self.put(param, self.get("params", p(key)), f"{name}/{key}")
            for child_name, child in module.named_children():
                self.load(child, p(child_name))


def load_jax_variables(module: nn.Module, variables) -> nn.Module:
    """Fill ``module`` in place from its JAX counterpart's variables."""
    loader = _Loader(variables)
    with torch.no_grad():
        loader.load(module, ())
    present = {(c,) + leaf for c in _COLLECTIONS
               for leaf in _leaves(variables.get(c, {}))}
    extra = sorted("/".join(k) for k in present - loader.used)
    if extra:
        raise KeyError(f"JAX variables not used by {type(module).__name__}: "
                       f"{extra[:8]}{' ...' if len(extra) > 8 else ''}")
    return module


class _Exporter:
    def __init__(self):
        self.variables = {}

    def put(self, coll: str, path: Path, value: torch.Tensor) -> None:
        node = self.variables.setdefault(coll, {})
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value.detach().float().cpu().numpy().copy()

    def export(self, module: nn.Module, path: Path) -> None:
        def p(*keys: str) -> Path:
            return path + keys

        if isinstance(module, Conv2d):
            self.put("params", p("kernel"), module.weight.permute(2, 3, 1, 0))
            if module.bias is not None:
                self.put("params", p("bias"), module.bias)
        elif isinstance(module, Conv1x1):
            self.put("params", p("kernel"), module.weight.T[None])
            self.put("params", p("bias"), module.bias)
        elif isinstance(module, BatchNorm):
            frozen = isinstance(module, FrozenBatchNorm)
            for src, coll, key in (("weight", "params", "scale"),
                                   ("bias", "params", "bias"),
                                   ("running_mean", "batch_stats", "mean"),
                                   ("running_var", "batch_stats", "var")):
                self.put("frozen" if frozen else coll, p(key),
                         getattr(module, src))
        else:
            for key, param in module.named_parameters(recurse=False):
                self.put("params", p(key), param)
            for child_name, child in module.named_children():
                self.export(child, p(child_name))


def jax_variables(module: nn.Module):
    """The variables of ``module``'s JAX counterpart (the inverse of
    ``load_jax_variables``): ``{"params": ...}``, with ``batch_stats`` and
    ``frozen`` where the module has such BatchNorms."""
    exporter = _Exporter()
    exporter.export(module, ())
    return exporter.variables


def load_jax_quantized(qmodule: nn.Module, q_backbone) -> nn.Module:
    """Fill a ``QuantizedResNet`` in place from a JAX quantized tree of the
    same architecture and stem kind."""
    convs = {name: m for name, m in qmodule.named_modules()
             if isinstance(m, QConv)}
    nodes = {}

    def walk(tree, prefix):
        if any(not isinstance(v, Mapping) for v in tree.values()):
            nodes[".".join(prefix)] = tree
            return
        for k, v in tree.items():
            walk(v, prefix + (str(k),))

    walk(q_backbone, ())
    if set(nodes) != set(convs):
        odd = sorted(set(nodes) ^ set(convs))
        raise KeyError(f"convs {odd[:8]} are not in both the quantized tree "
                       f"and the module")
    with torch.no_grad():
        for name, conv in convs.items():
            node = {k: np.asarray(v) for k, v in nodes[name].items()}
            kinds = ("w" in node, "w" in conv.qw)
            if kinds[0] != kinds[1]:
                raise ValueError(f"{name}: float stem in "
                                 f"{'the tree' if kinds[0] else 'the module'}"
                                 f" only")
            extra = set(node) - {"w", "w_q", "mult", "bias", "act_scale"}
            if extra:
                raise KeyError(f"{name}: unknown keys {sorted(extra)}")
            for key, value in node.items():
                if key == "act_scale":
                    conv.act_scale = torch.tensor(np.float32(value),
                                                  device=conv.bias.device)
                    continue
                if key == "w_q":
                    value = value.transpose(3, 0, 1, 2)  # HWIO -> OHWI
                want = getattr(conv, key)
                if tuple(want.shape) != value.shape:
                    raise ValueError(f"{name}/{key}: shape {value.shape} "
                                     f"does not fit {tuple(want.shape)}")
                want.copy_(torch.from_numpy(np.array(value)).to(want.dtype))
            if "w_q" in node and "act_scale" not in node:
                conv.act_scale = None
    return qmodule
