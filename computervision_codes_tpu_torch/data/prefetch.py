"""Device prefetch: overlap host-to-device copies with device compute.

The port's copy of ``data/prefetch.py`` in the JAX package. The reference
hides its copies behind DataLoader workers and ``pin_memory``
(MT4MTLKD/Spatial_cnn/run.py:367-368); here an iterator wrapper keeps
``depth`` batches in flight: each batch is staged in pinned host memory and
copied on a side CUDA stream with ``non_blocking=True``, so the copy of
batch N+1 overlaps the step on batch N (double buffering at depth 2). The
consumer's stream waits on each copy's event before it gets the batch, and
every handed-over tensor is recorded on that stream, so the allocator does
not reuse its memory while the consumer's work is queued.

With ``sharding`` (``parallel.mesh.batch_sharding``) each rank stages and
copies only its slice of every batch, to its own device, on the same path.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterator, Union

import numpy as np
import torch


def prefetch_to_device(iterator: Iterator[Dict], depth: int = 2,
                       device: Union[str, torch.device] = "cuda",
                       sharding=None) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield batches of ``iterator`` (dicts of arrays) as tensors on
    ``device``, keeping ``depth`` in flight. On a CPU device the tensors
    share the arrays' memory. ``sharding`` (a ``parallel.mesh.Sharding``
    of the batch): each leaf is cut to this rank's slice first, and the
    device is the rank's (``device`` is then not used)."""
    if sharding is not None:
        from ..parallel.mesh import local_slice, mesh_device

        device = mesh_device(sharding.mesh)
        iterator = ({k: local_slice(v, sharding) for k, v in b.items()}
                    for b in iterator)
    device = torch.device(device)
    if device.type != "cuda":
        for batch in iterator:
            yield {k: torch.from_numpy(np.ascontiguousarray(v))
                   for k, v in batch.items()}
        return

    copy_stream = torch.cuda.Stream(device)

    def put(batch):
        with torch.cuda.stream(copy_stream):
            out = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                   .to(device, non_blocking=True) for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(copy_stream)
        return out, done

    def take(item):
        out, done = item
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        for t in out.values():
            t.record_stream(consumer)
        return out

    queue: collections.deque = collections.deque()
    for batch in iterator:
        queue.append(put(batch))
        if len(queue) >= depth:
            yield take(queue.popleft())
    while queue:
        yield take(queue.popleft())
