"""Context-parallel full-video evaluation (the sequence split over ranks).

Counterpart of ``parallel/long_video.py`` in the JAX package, where GSPMD
partitions the ordinary forward: the features go on the mesh with T split
over the ``seq`` axis and XLA inserts the convolutions' halo exchanges and
the attention's collectives. Here that partitioned forward is written out
in the models (``parallel.context.sequence_sharded``): every temporal
convolution exchanges a halo of (k - 1) / 2 frames per side (the TCN's
dilated layers d per side, or 2 d on the left when causal, gathered from
as many ranks as the halo spans), every attention gathers its keys and
values or rings them, and everything per frame stays local. On the card
the TCN's dilated layers run kernel K1 on the halo-extended shard
``[halo | x | halo]`` and crop its output: K1's zero padding touches only
the cropped rows, and past the global ends the halo is zeros.

Sharded, exactly: ``models.mstct.MSTCT`` (gathered attention, or the ring
with ``ring_mesh``) and ``models.tcn.TemporalTCN`` with ``hier=False``; a
``hier`` TCN raises ``ValueError`` (its stride-3 pooling does not split at
shard edges).
"""

from __future__ import annotations

from typing import Callable

import torch

from .context import active_shard, all_gather_cat, sequence_sharded
from .mesh import SEQ_AXIS, Sharding, local_slice


def _gather_tree(tree, group):
    if isinstance(tree, torch.Tensor):
        return all_gather_cat(tree, group, 1) if tree.dim() >= 2 else tree
    if isinstance(tree, dict):
        return {k: _gather_tree(v, group) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_gather_tree(v, group) for v in tree)
    return tree


def eval_sharded(apply_fn: Callable, feats: torch.Tensor, mesh,
                 seq_axis: str = SEQ_AXIS):
    """``apply_fn(x)`` with ``feats`` (B, T, D), the whole sequence on every
    rank, split over ``seq_axis``: each rank runs ``apply_fn`` on its T / n
    frames inside ``sequence_sharded``, and every (B, T, ...) tensor of
    the result is all-gathered back over T, so that each rank returns what
    the unsharded ``apply_fn(feats)`` returns. T must divide by the axis
    size. The weights are the module's own, replicated
    (``parallel.mesh.replicate``); an ``MSTCT`` with ``ring_mesh`` rings
    every attention."""
    local = local_slice(feats, Sharding(mesh, (None, seq_axis)))
    with sequence_sharded(mesh, seq_axis):
        out = apply_fn(local)
        group = active_shard().group
    return _gather_tree(out, group)
