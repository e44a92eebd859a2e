"""The multi-device layer of the port (``torch.distributed``).

Counterpart of ``parallel/`` in the JAX package, with its names (its
``__all__``); ``launch`` starts the ranks of a driver. The names load on
first use, so that the models can import ``parallel.context`` without the
modules that import the models.
"""

import importlib

_WHERE = {
    "DATA_AXIS": "mesh", "SEQ_AXIS": "mesh", "MODEL_AXIS": "mesh",
    "make_mesh": "mesh", "batch_sharding": "mesh", "seq_sharding": "mesh",
    "replicated": "mesh", "shard_batch": "mesh", "replicate": "mesh",
    "launch": "mesh",
    "sequence_parallel_attention": "context",
    "sequence_parallel_dilated_conv": "context",
    "halo_exchange": "context", "all_gather_keys": "context",
    "tp_shardings": "tp", "shard_params_tp": "tp", "shard_state_tp": "tp",
    "sharded_leaf_count": "tp",
    "pipeline_blocks": "pipeline", "stack_block_params": "pipeline",
    "extract_stage_pairs": "swin_pipeline",
    "pipelined_swin_stage": "swin_pipeline",
}

__all__ = [
    "DATA_AXIS", "SEQ_AXIS", "MODEL_AXIS",
    "make_mesh", "batch_sharding", "seq_sharding", "replicated",
    "shard_batch", "replicate",
    "sequence_parallel_attention", "sequence_parallel_dilated_conv",
    "halo_exchange", "all_gather_keys",
    "tp_shardings", "shard_params_tp", "shard_state_tp",
    "sharded_leaf_count",
    "pipeline_blocks", "stack_block_params",
    "extract_stage_pairs", "pipelined_swin_stage",
]


def __getattr__(name):
    if name not in _WHERE:
        raise AttributeError(name)
    return getattr(importlib.import_module(f".{_WHERE[name]}", __name__),
                   name)
