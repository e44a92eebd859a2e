"""Tensor parallelism over the mesh's ``model`` axis.

Counterpart of ``parallel/tp.py`` in the JAX package, with its suffix
rules (Megatron column -> row pairs):

  * MLP / FFN pairs: the first Dense COLUMN-split (output axis, bias with
    it), the second ROW-split (input axis);
  * Q2L attention: q/k/v column-split (each rank holds whole heads), and
    out_proj row-split;
  * Swin window attention: qkv and proj ROW-split (the fused qkv packs its
    output as (3, heads, hd), so a column split would straddle q/k/v);
  * everything else replicated.

A rule whose dimension does not divide by the axis size falls back to
replication for that leaf, as in JAX; so does a column-split attention
whose heads do not divide (JAX's placement would still be exact there,
but a rank's share of the columns would not be whole heads).

JAX only places the parameters and GSPMD inserts the collectives. Here
``shard_params_tp`` cuts each matched ``Dense`` parameter to this rank's
slice in place (the ``nn.Parameter`` objects stay, so an optimizer built
over them keeps working and SGD's momentum is made at the local shape)
and gives the ``Dense`` its product (``Dense.tp``):

  * column-split: ``copy_to_model`` (forward identity, backward the
    all-reduce of the input's gradient over the ``model`` group), then
    the local columns;
  * row-split: the input's local features (a whole input is sliced here,
    after ``copy_to_model``, so that its gradient gathers every rank's
    slice), the local product, then ``reduce_from_model`` (forward the
    all-reduce of the partial sums, backward identity), then the bias.

The backward of the row-split reduce is the identity, not the all-reduce
of ``torch.distributed.nn.functional.all_reduce``: every rank computes the
rest of the network on the same replicated values, so each already holds
the whole gradient of the reduced output. A replicated parameter's
gradient is then whole and equal on every rank of the group, and a
sharded one's is its slice of the single-device gradient.

``gathered_tp(model)`` makes the whole parameters visible for a block
(checkpoint writes and restores) and cuts them again when it ends.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from .mesh import MODEL_AXIS, Sharding, axis_group, axis_index, axis_size

_COL = "col"
_ROW = "row"

_RULES: Tuple[Tuple[Tuple[str, str], str], ...] = (
    (("qkv", "kernel"), _ROW),
    (("proj", "kernel"), _ROW),
    (("Dense_0", "kernel"), _COL),
    (("Dense_0", "bias"), _COL),
    (("Dense_1", "kernel"), _ROW),
    (("q_proj", "kernel"), _COL),
    (("q_proj", "bias"), _COL),
    (("k_proj", "kernel"), _COL),
    (("k_proj", "bias"), _COL),
    (("v_proj", "kernel"), _COL),
    (("v_proj", "bias"), _COL),
    (("out_proj", "kernel"), _ROW),
    (("linear1", "kernel"), _COL),
    (("linear1", "bias"), _COL),
    (("linear2", "kernel"), _ROW),
)
_HEADS = ("q_proj", "k_proj", "v_proj", "out_proj")


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromModel.apply(x, group)


def tp_spec(names: Tuple[str, ...], shape, n_model: int
            ) -> Tuple[object, ...]:
    """The partition of one leaf (its path ``names``, its ``shape``) as a
    JAX ``PartitionSpec`` tuple: ``MODEL_AXIS`` at the split dimension,
    () when replicated."""
    if len(names) < 2 or n_model <= 1:
        return ()
    suffix = (names[-2], names[-1])
    for rule, kind in _RULES:
        if suffix != rule:
            continue
        axis = len(shape) - 1 if kind == _COL else 0
        if len(shape) <= axis or shape[axis] % n_model:
            return ()
        spec = [None] * len(shape)
        spec[axis] = MODEL_AXIS
        return tuple(spec)
    return ()


@dataclass
class TPDense:
    """The product of a sharded ``Dense`` (its ``tp``)."""

    kind: str
    group: object
    index: int

    def __call__(self, dense, x):
        dt = dense.dtype
        w = dense.kernel.to(dt)
        bias = None if dense.bias is None else dense.bias.to(dt)
        if self.kind == _COL:
            y = copy_to_model(x.to(dt), self.group) @ w
            return y if bias is None else y + bias
        k = w.shape[0]
        if x.shape[-1] != k:  # a whole input: take this rank's features
            x = copy_to_model(x, self.group)[
                ..., self.index * k:(self.index + 1) * k]
        y = reduce_from_model(x.to(dt) @ w, self.group)
        return y if bias is None else y + bias


def _dense_modules(model: nn.Module, n_model: int):
    """(name, Dense, {leaf: split dim}) of every Dense that a rule shards."""
    from ..models.common import Dense

    heads_of = {}
    for name, mod in model.named_modules():
        h = getattr(mod, "num_heads", None)
        if isinstance(h, int):
            for child in _HEADS:
                heads_of[f"{name}.{child}" if name else child] = h
    for name, mod in model.named_modules():
        if not isinstance(mod, Dense):
            continue
        if name in heads_of and heads_of[name] % n_model:
            continue
        path = tuple(name.split("."))
        splits = {}
        for leaf, p in mod.named_parameters(recurse=False):
            spec = tp_spec(path + (leaf,), tuple(p.shape), n_model)
            if spec:
                splits[leaf] = spec.index(MODEL_AXIS)
        if "kernel" in splits:
            yield name, mod, splits


def tp_shardings(model: nn.Module, mesh) -> Dict[str, Sharding]:
    """{parameter name: placement} of every parameter of ``model``."""
    n = axis_size(mesh, MODEL_AXIS)
    out = {}
    for name, p in model.named_parameters():
        spec = tp_spec(tuple(name.split(".")), tuple(p.shape), n)
        out[name] = Sharding(mesh, spec)
    split = {f"{m}.{leaf}" for m, _, s in _dense_modules(model, n)
             for leaf in s}
    for name in out:
        if out[name].spec and name not in split:
            out[name] = Sharding(mesh, ())
    return out


def _cut(t: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size).clone()


def shard_params_tp(model: nn.Module, mesh) -> nn.Module:
    """Cut every matched ``Dense`` of ``model`` to this rank's slice along
    the ``model`` axis, in place, and give it its sharded product."""
    n, i = axis_size(mesh, MODEL_AXIS), axis_index(mesh, MODEL_AXIS)
    if n <= 1:
        return model
    group = axis_group(mesh, MODEL_AXIS)
    for _, dense, splits in list(_dense_modules(model, n)):
        kind = _COL if splits["kernel"] == 1 else _ROW
        for leaf, dim in splits.items():
            p = getattr(dense, leaf)
            p.data = _cut(p.data, dim, n, i)
            p.tp_dim, p.tp_size = dim, n
        dense.tp = TPDense(kind, group, i)
    model.tp_group = group
    return model


def shard_state_tp(state, mesh):
    """A TrainState under the TP rules: the module's parameters cut in
    place (the optimizer holds the same objects), and any momentum buffer
    cut as its parameter."""
    shard_params_tp(state.model, mesh)
    n, i = axis_size(mesh, MODEL_AXIS), axis_index(mesh, MODEL_AXIS)
    for p in state.model.parameters():
        buf = state.optimizer.state.get(p, {}).get("momentum_buffer")
        if buf is not None and hasattr(p, "tp_dim"):
            state.optimizer.state[p]["momentum_buffer"] = _cut(
                buf, p.tp_dim, n, i)
    return state


def sharded_leaf_count(tree) -> int:
    """How many parameters (of a module or a TrainState's module) carry a
    ``model``-axis split."""
    model = getattr(tree, "model", tree)
    return sum(hasattr(p, "tp_dim") for p in model.parameters())


@contextlib.contextmanager
def gathered_tp(model: nn.Module):
    """The whole parameters in the block (all-gathered over the model
    group); each is cut back to this rank's slice of its value at the
    end, so a restore inside the block is kept."""
    group = getattr(model, "tp_group", None)
    sharded = [p for p in model.parameters() if hasattr(p, "tp_dim")]
    if group is None or not sharded:
        yield model
        return
    i = dist.get_rank(group)
    for p in sharded:
        parts = [torch.empty_like(p.data) for _ in range(p.tp_size)]
        dist.all_gather(parts, p.data.contiguous(), group=group)
        p.data = torch.cat(parts, dim=p.tp_dim)
    try:
        yield model
    finally:
        for p in sharded:
            p.data = _cut(p.data, p.tp_dim, p.tp_size, i)
