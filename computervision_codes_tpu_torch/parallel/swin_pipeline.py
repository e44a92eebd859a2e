"""Bridge: a Swin stage's blocks -> the GPipe pipeline.

Counterpart of ``parallel/swin_pipeline.py`` in the JAX package. Swin-L's
stage 3 is 18 blocks of one structure (MT4MTLKD/Spatial_transformer/models/
swin_transformer.py ``depths=(2, 2, 18, 2)``). ``extract_stage_pairs``
stacks a model's ``stage{S}_block{d}`` parameters into shift pairs (shift
0 then shift w/2: one unit, the same program at every stage) and
``pipelined_swin_stage`` runs them over the mesh's ``model`` axis
(``parallel.pipeline``). The blocks run their plain path
(``fused_eval=False``), as JAX forces here: the pipeline calls them with
the stacked parameters through ``torch.func.functional_call``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..models.swin import MLP_RATIO, SwinBlock
from .pipeline import pipeline_blocks, stack_block_params


def _block_params(block) -> Dict[str, torch.Tensor]:
    return dict(block.named_parameters())


def extract_stage_pairs(swin, stage: int) -> Tuple[Dict, int]:
    """Stack the ``stage{S}_block{d}`` parameters of a ``SwinTransformer``
    into shift-pair units ``{"a": even (shift 0), "b": odd (shift w/2)}``
    along a new leading axis. Returns (stacked pairs, number of blocks)."""
    blocks = []
    d = 0
    while hasattr(swin, f"stage{stage}_block{d}"):
        blocks.append(_block_params(getattr(swin, f"stage{stage}_block{d}")))
        d += 1
    if not blocks:
        raise ValueError(f"no stage{stage}_block* in the model")
    if len(blocks) % 2:
        raise ValueError(f"stage {stage} has {len(blocks)} blocks — "
                         "pipelining needs whole shift-pairs")
    pairs = [{"a": blocks[i], "b": blocks[i + 1]}
             for i in range(0, len(blocks), 2)]
    return stack_block_params(pairs), len(blocks)


def _flat(tree, prefix="") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, name + "."))
        else:
            out[name] = v
    return out


def pipelined_swin_stage(stacked_pairs, x: torch.Tensor, mesh, n_micro: int,
                         *, dim: int, num_heads: int, window: int,
                         mlp_ratio: float = 4.0,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The extracted stage on (B, H, W, dim), the pair stack pipelined over
    the mesh's ``model`` ranks (eval path)."""
    if mlp_ratio != MLP_RATIO:
        raise ValueError(f"the Swin blocks' mlp_ratio is {MLP_RATIO}, got "
                         f"{mlp_ratio}")
    blocks = [SwinBlock(dim, num_heads, window, shift, fused_eval=False,
                        dtype=dtype).to(x.device).eval()
              for shift in (0, window // 2)]

    def apply_pair(p, act):
        for block, key in zip(blocks, ("a", "b")):
            act = torch.func.functional_call(block, _flat(p[key]), (act,))
        return act

    return pipeline_blocks(apply_pair, stacked_pairs, x, mesh, n_micro)
