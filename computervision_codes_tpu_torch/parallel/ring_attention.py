"""Ring attention: exact attention over a sequence-sharded ring of ranks.

Counterpart of ``parallel/ring_attention.py`` in the JAX package. Where even
the gathered keys and values would not fit one device, they stay sharded:
at each of the n steps every rank attends its local queries to the
resident K/V block, then passes the block one hop around the ``seq`` ring
(``batch_isend_irecv`` to rank r + 1, from rank r - 1) while carrying the
float32 running statistics, so that the result is exact:

    m' = max(m, lse_r);  out' = out e^(m - m') + o_r e^(lse_r - m');
    l' = l e^(m - m') + e^(lse_r - m')

where ``o_r`` and ``lse_r`` are the block's normalised output and the row
log-sum-exp of its scores, which kernel K8's forward returns on the card
(``ops.attention.flash_attention_fwd_cuda(..., with_lse=True)``) and its
plain version (``flash_attention_reference_fwd``) on the CPU. This is the
running max, normaliser and accumulator of the JAX scan, block by block.
At world size 1 there is no hop (``torch.distributed`` sends to no rank
itself): the one block is the whole sequence.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.attention import (flash_attention_fwd_cuda,
                             flash_attention_reference_fwd)
from .context import SeqShard, group_shard
from .mesh import SEQ_AXIS, axis_group


def block_attention(q, k, v):
    """(normalised output, float32 lse) of one K/V block: K8's forward on
    CUDA, its plain version on the CPU."""
    if q.device.type == "cuda":
        return flash_attention_fwd_cuda(q, k, v, with_lse=True)
    if q.device.type == "cpu":
        return flash_attention_reference_fwd(q, k, v)
    raise ValueError(f"ring attention runs on CPU or CUDA tensors, got "
                     f"{q.device}")


def _rotate(t: torch.Tensor, shard: SeqShard) -> torch.Tensor:
    """``t`` of rank r - 1 (the ring's predecessor)."""
    n, r = shard.size, shard.rank
    out = torch.empty_like(t)
    peer = lambda i: dist.get_global_rank(shard.group, i % n)  # noqa: E731
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, t, peer(r + 1), shard.group),
        dist.P2POp(dist.irecv, out, peer(r - 1), shard.group)])
    for req in reqs:
        req.wait()
    return out


def ring_attention_shard(q, k, v, shard: SeqShard) -> torch.Tensor:
    """Ring attention of this rank's (B, H, T / n, D) shards."""
    k, v = k.contiguous(), v.contiguous()
    out = m = l = None
    for step in range(shard.size):
        o, lse = block_attention(q, k, v)
        o = o.float()
        if out is None:
            out, m, l = o, lse, torch.ones_like(lse)
        else:
            m_new = torch.maximum(m, lse)
            c_old, c_new = torch.exp(m - m_new), torch.exp(lse - m_new)
            out = out * c_old[..., None] + o * c_new[..., None]
            l, m = l * c_old + c_new, m_new
        if step + 1 < shard.size:
            k, v = _rotate(k, shard), _rotate(v, shard)
    return (out / l[..., None]).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, axis: str = SEQ_AXIS) -> torch.Tensor:
    """Exact attention with (B, H, T, D) q, k, v split over T on ``axis``;
    the arguments and the result are this rank's shards."""
    return ring_attention_shard(q, k, v, group_shard(axis_group(mesh, axis)))
