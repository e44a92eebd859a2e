"""Pipeline parallelism (GPipe schedule) over stacked homogeneous blocks.

Counterpart of ``parallel/pipeline.py`` in the JAX package. The ``L``
layers of a stack (a tree of tensors with a leading layer axis,
``stack_block_params``) are split over the mesh's ``model`` axis: stage
``s`` applies layers ``[s L/D, (s+1) L/D)``. The batch is cut into
``n_micro`` microbatches; stage 0 feeds them in order, every stage applies
its chunk to each and sends the activation to stage s + 1 (``send`` and
``recv`` on the ``model`` group), so that stage s works on microbatch m
while stage s + 1 works on m - 1, the bubble being (D-1)/(M+D-1) as in
JAX. The last stage's outputs are broadcast over the group, so every rank
returns the whole result, what JAX's ``fn(...)[d - 1]`` returns. Where the
mesh has a ``data`` axis whose size divides the microbatch, each rank
holds its slice of every microbatch, and the result is all-gathered over
the ``data`` group.

The schedule is differentiable. Autograd does not cross ``send`` and
``recv``, so the backward is written out as GPipe's: the last stage takes
the gradient of the output, and for each microbatch in reverse order each
stage receives the output gradient from stage s + 1, runs
``torch.autograd.backward`` through its chunk and sends the input gradient
to stage s - 1. A stage's chunk gradient lands in its layers of the
stacked tree; the tree's gradient is then summed over the ``model`` group
(each layer's comes from one stage) and the ``data`` group (each rank's
comes from its slice), and the input's gradient is stage 0's, gathered
over the ``data`` group. Every rank computes the rest of the network on
the same replicated result, so each holds the whole output gradient and
none is reduced.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch
import torch.distributed as dist

from .mesh import (DATA_AXIS, MODEL_AXIS, AXES, axis_group, axis_index,
                   axis_size)


def _flatten(tree, prefix=()) -> List:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], prefix + (k,))
        return out
    return [(prefix, tree)]


def _unflatten(items) -> Dict:
    root: Dict = {}
    for path, leaf in items:
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return root


def stack_block_params(params_seq: Sequence) -> Dict:
    """Stack per-layer trees (nested dicts of tensors, one structure)
    along a new leading layer axis. For shift-alternating Swin stacks pass
    pairs ``[{"a": p0, "b": p1}, ...]``, so that each unit is the same."""
    flat = [_flatten(p) for p in params_seq]
    paths = [path for path, _ in flat[0]]
    if any([path for path, _ in f] != paths for f in flat):
        raise ValueError("the layer trees differ in structure")
    return _unflatten((path, torch.stack([f[i][1] for f in flat]))
                      for i, path in enumerate(paths))


def _global(group, i: int) -> int:
    return dist.get_global_rank(group, i)


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched, x, *leaves):
        ctx.sched = sched
        ctx.saved = sched.run_forward(x, leaves, sched.grad)
        return sched.result

    @staticmethod
    def backward(ctx, g):
        gx, gleaves = ctx.sched.run_backward(ctx.saved, g)
        ctx.saved = None
        return (None, gx) + tuple(gleaves)


class _Schedule:
    def __init__(self, apply_one, paths, mesh, n_micro, axis):
        self.apply_one, self.paths, self.n_micro = apply_one, paths, n_micro
        self.group = axis_group(mesh, axis)
        self.d, self.stage = axis_size(mesh, axis), axis_index(mesh, axis)
        self.n_data = axis_size(mesh, DATA_AXIS) if DATA_AXIS != axis \
            else 1
        self.data_group = axis_group(mesh, DATA_AXIS)
        self.data_index = axis_index(mesh, DATA_AXIS)
        self.result = None

    def chunk_tree(self, leaves):
        per = leaves[0].shape[0] // self.d
        lo = self.stage * per
        return [t[lo:lo + per] for t in leaves], per

    def apply_chunk(self, chunk, per, act):
        for layer in range(per):
            p = _unflatten((path, t[layer])
                           for path, t in zip(self.paths, chunk))
            act = self.apply_one(p, act)
        return act

    def micro(self, x):
        b = x.shape[0]
        mb = b // self.n_micro
        parts = list(x.reshape((self.n_micro, mb) + x.shape[1:]))
        self.dsplit = self.n_data > 1 and mb % self.n_data == 0
        if self.dsplit:
            step = mb // self.n_data
            parts = [p[self.data_index * step:(self.data_index + 1) * step]
                     for p in parts]
        return parts

    def gather_data(self, t):
        """(n_micro, rows, ...) local rows -> (B, ...) whole."""
        if self.dsplit:
            parts = [torch.empty_like(t) for _ in range(self.n_data)]
            dist.all_gather(parts, t.contiguous(), group=self.data_group)
            t = torch.cat(parts, dim=1)
        return t.reshape((-1,) + t.shape[2:])

    def run_forward(self, x, leaves, grad: bool):
        micro = self.micro(x)
        chunk, per = self.chunk_tree(leaves)
        if grad:
            chunk = [t.detach().requires_grad_(True) for t in chunk]
        shape, dtype = micro[0].shape, micro[0].dtype
        saved, outs = [], []
        first, last = self.stage == 0, self.stage == self.d - 1
        for m in range(self.n_micro):
            if first:
                act = micro[m]
            else:
                act = torch.empty(shape, dtype=dtype, device=x.device)
                dist.recv(act, _global(self.group, self.stage - 1),
                          group=self.group)
            if grad:
                act = act.detach().requires_grad_(True)
            with torch.set_grad_enabled(grad):
                out = self.apply_chunk(chunk, per, act)
            if grad:
                saved.append((act, out))
            if last:
                outs.append(out.detach())
            else:
                dist.send(out.detach().contiguous(),
                          _global(self.group, self.stage + 1),
                          group=self.group)
        result = (torch.stack(outs) if last else
                  torch.empty((self.n_micro,) + tuple(shape), dtype=dtype,
                              device=x.device))
        dist.broadcast(result, _global(self.group, self.d - 1),
                       group=self.group)
        self.result = self.gather_data(result)
        return (saved, chunk, per, leaves, x) if grad else None

    def run_backward(self, saved, g):
        saved, chunk, per, leaves, x = saved
        first, last = self.stage == 0, self.stage == self.d - 1
        g_micro = self.micro(g)
        gx = [None] * self.n_micro
        for m in reversed(range(self.n_micro)):
            act, out = saved[m]
            if last:
                gout = g_micro[m].contiguous()
            else:
                gout = torch.empty_like(out)
                dist.recv(gout, _global(self.group, self.stage + 1),
                          group=self.group)
            torch.autograd.backward(out, gout)
            gin = act.grad if act.grad is not None else torch.zeros_like(act)
            if first:
                gx[m] = gin
            else:
                dist.send(gin.contiguous(),
                          _global(self.group, self.stage - 1),
                          group=self.group)
        # the input's gradient: stage 0's, on every rank of the group
        gx_t = (torch.stack(gx) if first else
                torch.empty((self.n_micro,) + tuple(saved[0][0].shape),
                            dtype=x.dtype, device=x.device))
        dist.broadcast(gx_t, _global(self.group, 0), group=self.group)
        gx_full = self.gather_data(gx_t).reshape(x.shape)
        gleaves = []
        for t, c in zip(leaves, chunk):
            full = torch.zeros_like(t)
            lo = self.stage * per
            if c.grad is not None:
                full[lo:lo + per] = c.grad
            dist.all_reduce(full, group=self.group)
            if self.dsplit:
                dist.all_reduce(full, group=self.data_group)
            gleaves.append(full)
        return gx_full, gleaves


def pipeline_blocks(apply_one: Callable, stacked_params, x: torch.Tensor,
                    mesh, n_micro: int, axis: str = MODEL_AXIS
                    ) -> torch.Tensor:
    """Apply the ``L`` stacked layers to ``x`` with the stack pipelined
    over the ``axis`` ranks (GPipe). ``apply_one(params_one, x) -> x``
    must keep the shape (a residual block); ``stacked_params`` is the
    whole stack on every rank (each applies its chunk) with ``L % D ==
    0``; ``x`` (B, ...) with ``B % n_micro == 0``. Returns the sequential
    loop's result, on every rank; differentiable in ``x`` and the
    stack."""
    if axis not in AXES:
        raise ValueError(f"unknown mesh axis {axis!r}")
    d = axis_size(mesh, axis)
    flat = _flatten(stacked_params)
    lead = {int(t.shape[0]) for _, t in flat}
    if len(lead) != 1:
        raise ValueError(f"inconsistent layer-stack leading dims {lead}")
    n_layers = lead.pop()
    if n_layers % d:
        raise ValueError(f"{n_layers} layers not divisible by {d} stages")
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
    sched = _Schedule(apply_one, [p for p, _ in flat], mesh, n_micro, axis)
    sched.grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in [x] + [t for _, t in flat])
    return _Pipeline.apply(sched, x, *[t for _, t in flat])
