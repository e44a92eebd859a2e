"""Context (sequence) parallelism for the full-video temporal models.

Counterpart of ``parallel/context.py`` in the JAX package. Each rank of the
mesh's ``seq`` axis holds T / n consecutive frames:

  * ``sequence_parallel_attention`` — the keys and values are all-gathered
    over the ``seq`` group and the local queries attend to all of them
    (``ops.attention.multi_head_attention``: kernel K7 on the card, whose
    query and key lengths may differ; the plain version on the CPU);
  * ``halo_exchange`` — the ``halo`` frames of each neighbour, zeros at the
    global ends, JAX's contract (``halo`` <= the local length);
    ``gather_halo`` takes any halo on either side from as many ranks as it
    spans (point-to-point ``batch_isend_irecv``), which the model-level
    halos need: the TCN's dilations reach 1024 frames;
  * ``sequence_parallel_dilated_conv`` — the width-3 dilated convolution
    of the TCN layer on a halo-extended shard;
  * ``all_gather_keys`` — the MoCo queue's gather of every rank's anchor
    keys before the enqueue (``models.moco.enqueue``);
  * ``data_parallel(group)`` — the data group for training-mode
    BatchNorm's moments (``models.resnet.BatchNorm``).

``sequence_sharded(mesh)`` makes the sharding visible to the models for a
block (a context variable, read by ``models.common.TemporalConv``,
``models.tcn.DilatedResidualLayer`` and ``models.mstct.
GlobalRelationalBlock``): inside it every temporal convolution runs on its
halo-extended shard and crops, and every attention gathers its keys and
values, or rings them (``MSTCT.ring_mesh``: ``parallel.ring_attention``).
Everything per frame stays local. This is what GSPMD's partitioner
inserts into the JAX forward.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.distributed as dist

from ..ops.attention import multi_head_attention
from .mesh import SEQ_AXIS, axis_group


@dataclass(frozen=True)
class SeqShard:
    """The sequence sharding in force: the ``seq`` group, this rank's
    position in it and its size."""

    group: object
    rank: int
    size: int


_ACTIVE: contextvars.ContextVar[Optional[SeqShard]] = \
    contextvars.ContextVar("seq_shard", default=None)


_DATA: contextvars.ContextVar[Optional[object]] = \
    contextvars.ContextVar("data_group", default=None)


def data_group():
    """The data-parallel group of the enclosing ``data_parallel`` block, or
    None."""
    return _DATA.get()


@contextlib.contextmanager
def data_parallel(group):
    """Training-mode BatchNorm in the block takes its moments over
    ``group`` (``models.resnet.BatchNorm``): the global batch's, as under
    JAX's batch-sharded mesh."""
    token = _DATA.set(group)
    try:
        yield
    finally:
        _DATA.reset(token)


def active_shard() -> Optional[SeqShard]:
    """The sharding of the enclosing ``sequence_sharded`` block, or None."""
    return _ACTIVE.get()


def group_shard(group) -> SeqShard:
    return SeqShard(group, dist.get_rank(group), dist.get_world_size(group))


@contextlib.contextmanager
def sequence_sharded(mesh, axis: str = SEQ_AXIS):
    """Models called in the block see their (B, T, ...) inputs as this
    rank's T shard of ``axis``."""
    token = _ACTIVE.set(group_shard(axis_group(mesh, axis)))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def _take(x, time_axis: int, start: int, stop: int):
    index = [slice(None)] * x.ndim
    index[time_axis] = slice(start, stop)
    return x[tuple(index)].contiguous()


def _zeros(x, time_axis: int, n: int):
    shape = list(x.shape)
    shape[time_axis] = n
    return x.new_zeros(shape)


def gather_halo(x: torch.Tensor, left: int, right: int,
                shard: SeqShard, time_axis: int = 1) -> torch.Tensor:
    """[``left`` frames before the shard | x | ``right`` frames after it]
    along ``time_axis``, from as many ranks as each side spans, zeros past
    the global ends. Every rank holds the same local length."""
    t = x.shape[time_axis]
    r, n = shard.rank, shard.size
    peer = lambda i: dist.get_global_rank(shard.group, i)  # noqa: E731
    ops: List = []
    lefts, rights = [], []
    # left halo: hop s brings frames [max(0, s t - left), t) of rank r - s;
    # this rank sends the same cut of its own shard to rank r + s
    for s in range(1, -(-left // t) + 1 if left else 1):
        lo = max(0, s * t - left)
        if r + s < n:
            ops.append(dist.P2POp(dist.isend, _take(x, time_axis, lo, t),
                                  peer(r + s), shard.group, tag=0))
        buf = _zeros(x, time_axis, t - lo)
        if r - s >= 0:
            ops.append(dist.P2POp(dist.irecv, buf, peer(r - s), shard.group,
                                  tag=0))
        lefts.insert(0, buf)
    # right halo: hop s brings frames [0, min(t, right - (s-1) t)) of r + s
    for s in range(1, -(-right // t) + 1 if right else 1):
        hi = min(t, right - (s - 1) * t)
        if r - s >= 0:
            ops.append(dist.P2POp(dist.isend, _take(x, time_axis, 0, hi),
                                  peer(r - s), shard.group, tag=1))
        buf = _zeros(x, time_axis, hi)
        if r + s < n:
            ops.append(dist.P2POp(dist.irecv, buf, peer(r + s), shard.group,
                                  tag=1))
        rights.append(buf)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat(lefts + [x] + rights, dim=time_axis)


def halo_exchange(x: torch.Tensor, halo: int, mesh, axis: str = SEQ_AXIS,
                  time_axis: int = 1) -> torch.Tensor:
    """``halo`` frames of each neighbour on either side of the local shard
    (zeros at the global ends): (..., T_local + 2 halo, ...). As in JAX,
    ``halo`` may not exceed the local length."""
    t = x.shape[time_axis]
    if halo > t:
        raise ValueError(f"halo {halo} exceeds the local length {t}: "
                         f"neighbours only (gather_halo spans more ranks)")
    return gather_halo(x, halo, halo, group_shard(axis_group(mesh, axis)),
                       time_axis)


class _AllReduceSum(torch.autograd.Function):
    """The sum over ``group`` of every rank's tensor; its gradient is the
    sum over the group of every rank's output gradient (each rank's loss
    reads the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-reduce (sum) over ``group``."""
    return _AllReduceSum.apply(x, group)


def all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along ``dim``, in rank
    order."""
    if dist.get_world_size(group) == 1:
        return x
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def gathered_attention(q, k, v, shard: SeqShard):
    """Local queries against the keys and values of the whole sequence,
    all-gathered over the shard's group."""
    kg = all_gather_cat(k, shard.group, 2)
    vg = all_gather_cat(v, shard.group, 2)
    return multi_head_attention(q, kg, vg)


def sequence_parallel_attention(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, mesh,
                                axis: str = SEQ_AXIS) -> torch.Tensor:
    """Exact attention over (B, H, T, D) with T split over ``axis``: the
    arguments and the result are this rank's (B, H, T / n, D) shards."""
    return gathered_attention(q, k, v, group_shard(axis_group(mesh, axis)))


def sequence_parallel_dilated_conv(x: torch.Tensor, w_taps: torch.Tensor,
                                   b1: torch.Tensor, dilation: int, mesh,
                                   axis: str = SEQ_AXIS) -> torch.Tensor:
    """The width-3 dilated convolution (pre-activation) of a (B, T, C)
    shard, exact: xp = halo_exchange(x, d); taps at -d, 0, +d. Needs
    T_local >= dilation, as in JAX."""
    d, t = dilation, x.shape[1]
    xp = halo_exchange(x, d, mesh, axis, time_axis=1)
    return (xp[:, :t] @ w_taps[0] + xp[:, d:d + t] @ w_taps[1]
            + xp[:, 2 * d:2 * d + t] @ w_taps[2] + b1)


def all_gather_keys(keys: torch.Tensor, labels: torch.Tensor,
                    valid: torch.Tensor, group):
    """The MoCo queue's gather: every rank's anchor keys, labels and
    validity concatenated in rank order over ``group`` (the data group),
    the reference's ``concat_all_gather`` (TERL/6_baseline_learnT/models/
    moco.py:409-421, an identity stub there)."""
    return tuple(all_gather_cat(t, group, 0) for t in (keys, labels, valid))
