"""Device mesh, placements and the process launcher.

Counterpart of ``parallel/mesh.py`` in the JAX package, whose mesh has
three named axes:

  * ``data``  — batch (data) parallelism, gradients averaged over it;
  * ``seq``   — sequence (context) parallelism for the full-video temporal
    models (frames split over devices);
  * ``model`` — tensor and pipeline parallelism.

JAX runs one program over a ``jax.sharding.Mesh`` and XLA inserts the
collectives. Here each device is one process (a rank of the
``torch.distributed`` default group) holding its local shard, and every
collective is written out where the computation needs it. ``make_mesh``
builds a ``torch.distributed.device_mesh.DeviceMesh`` over the whole group
with the three axis names; ``axis_group`` gives an axis's process group.
On ``device_type="cuda"`` the backend is NCCL and rank r owns
``cuda:<r>``; on ``"cpu"`` it is gloo.

``batch_sharding``, ``seq_sharding`` and ``replicated`` describe a
placement as JAX's ``PartitionSpec`` does, one mesh axis (or None) per
leading dimension; ``local_slice`` cuts a host array to this rank's part
of it. ``shard_batch`` places each rank's slice of a host batch on its
device; ``replicate`` broadcasts tensors, trees and modules from rank 0.

``launch(fn, n, args)`` runs ``fn(*args)`` on ``n`` ranks and returns rank
0's result: inside a group it just calls ``fn``; under ``torchrun`` it
joins the group from the environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``); otherwise it spawns ``n`` local
processes that meet at a ``file://`` store in a fresh temporary
directory, so that one command (``--dp_devices 2``) starts them all, as
one JAX process drives every local device (CPU ranks share the host's
cores out, unless ``OMP_NUM_THREADS`` says otherwise). A rank that fails,
or a group that outlives ``timeout``, fails the call and its ranks are
killed.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

DATA_AXIS = "data"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, SEQ_AXIS, MODEL_AXIS)

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _backend(device_type: str) -> str:
    if device_type not in BACKENDS:
        raise ValueError(f"device_type must be one of {sorted(BACKENDS)}, "
                         f"got {device_type!r}")
    return BACKENDS[device_type]


def init_process(rank: int, world_size: int, init_method: str,
                 device_type: str = "cuda") -> None:
    """Join the default group as ``rank`` of ``world_size``; on CUDA the
    rank's device becomes ``cuda:<rank % cards>``."""
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(_backend(device_type), init_method=init_method,
                            rank=rank, world_size=world_size)


def _check_cards(n: int, device_type: str) -> None:
    if device_type == "cuda":
        have = torch.cuda.device_count()
        if n > have:
            raise ValueError(f"mesh of {n} ranks needs {n} devices, have "
                             f"{have}")


def _rank_main(rank: int, n: int, init_method: str, device_type: str,
               fn: Callable, args: tuple, result_path: str) -> None:
    if device_type == "cpu" and n > 1 and "OMP_NUM_THREADS" not in \
            os.environ:  # the host's cores shared out, as torchrun does
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    init_process(rank, n, init_method, device_type)
    try:
        out = fn(*args)
        if rank == 0:
            with open(result_path, "wb") as fh:
                pickle.dump(out, fh)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, n: int, args: Sequence = (),
           device_type: str = "cuda",
           timeout: Optional[float] = None) -> Any:
    """``fn(*args)`` on ``n`` ranks; rank 0's return value (a spawned
    group's result is pickled back). ``fn`` must be importable by name
    (a module-level function) when the ranks are spawned."""
    args = tuple(args)
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise ValueError(f"{n} ranks asked inside a group of "
                             f"{dist.get_world_size()}")
        return fn(*args)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        if world != n:
            raise ValueError(f"{n} ranks asked, torchrun started {world}")
        _check_cards(int(os.environ.get("LOCAL_WORLD_SIZE", world)),
                     device_type)
        if device_type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(_backend(device_type), init_method="env://")
        try:
            return fn(*args)
        finally:
            dist.destroy_process_group()
    _check_cards(n, device_type)
    tmp = tempfile.mkdtemp(prefix="cvtpu_ranks_")
    init_method = f"file://{os.path.join(tmp, 'store')}"
    result_path = os.path.join(tmp, "result.pkl")
    try:
        if n == 1:
            _rank_main(0, 1, init_method, device_type, fn, args, result_path)
        else:
            _spawn(n, init_method, device_type, fn, args, result_path,
                   timeout)
        with open(result_path, "rb") as fh:
            return pickle.load(fh)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _spawn(n: int, init_method: str, device_type: str, fn: Callable,
           args: tuple, result_path: str, timeout: Optional[float]) -> None:
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=False,
                         args=(r, n, init_method, device_type, fn, args,
                               result_path)) for r in range(n)]
    for p in procs:
        p.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(f"rank(s) {failed} failed (exit codes "
                                   f"{[procs[r].exitcode for r in failed]})")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{n} ranks did not finish within "
                                   f"{timeout} s")
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise RuntimeError(f"rank(s) {failed} failed (exit codes "
                               f"{[procs[r].exitcode for r in failed]})")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()


def make_mesh(n_data: Optional[int] = None, n_seq: int = 1,
              n_model: int = 1, device_type: str = "cuda"):
    """A (data, seq, model) ``DeviceMesh`` over the whole default group
    (one rank per device). ``n_data`` None takes what the other two axes
    leave. Raises, as JAX does, when the mesh needs more devices than the
    group has."""
    from torch.distributed.device_mesh import init_device_mesh

    _backend(device_type)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: run under "
                           "parallel.mesh.launch or torchrun")
    have = dist.get_world_size()
    if n_data is None:
        n_data = have // (n_seq * n_model)
    need = n_data * n_seq * n_model
    if need > have:
        raise ValueError(f"mesh {n_data}x{n_seq}x{n_model} needs {need} "
                         f"devices, have {have}")
    if need != have:
        raise ValueError(f"mesh {n_data}x{n_seq}x{n_model} covers {need} "
                         f"of the group's {have} ranks: a mesh spans the "
                         f"whole group")
    return init_device_mesh(device_type, (n_data, n_seq, n_model),
                            mesh_dim_names=AXES)


def axis_group(mesh, axis: str):
    """The process group of this rank's line along ``axis``."""
    return mesh.get_group(axis)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(AXES.index(axis))


def axis_index(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def mesh_device(mesh) -> torch.device:
    """This rank's device: ``cuda:<current>`` or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


@dataclass(frozen=True)
class Sharding:
    """A placement: ``spec[i]`` is the mesh axis that splits dimension i
    (None: not split); trailing dimensions are replicated."""

    mesh: Any
    spec: Tuple[Optional[str], ...]


def batch_sharding(mesh) -> Sharding:
    """Leading axis split over the data axis, rest replicated."""
    return Sharding(mesh, (DATA_AXIS,))


def seq_sharding(mesh) -> Sharding:
    """(B, T, ...) with B over the data axis and T over the seq axis."""
    return Sharding(mesh, (DATA_AXIS, SEQ_AXIS))


def replicated(mesh) -> Sharding:
    return Sharding(mesh, ())


def local_slice(x, sharding: Sharding):
    """This rank's part of the host array or tensor ``x`` under
    ``sharding``; a split dimension must divide by its axis size."""
    for dim, axis in enumerate(sharding.spec):
        if axis is None:
            continue
        n, i = axis_size(sharding.mesh, axis), axis_index(sharding.mesh,
                                                            axis)
        size = x.shape[dim]
        if size % n:
            raise ValueError(f"dimension {dim} of size {size} does not "
                             f"divide over the {axis} axis ({n})")
        step = size // n
        index = [slice(None)] * x.ndim
        index[dim] = slice(i * step, (i + 1) * step)
        x = x[tuple(index)]
    return x


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def shard_batch(batch, mesh):
    """This rank's slice (over the data axis) of every leaf of a host batch
    dict, as tensors on its device."""
    sh, device = batch_sharding(mesh), mesh_device(mesh)
    return {k: _tensor(local_slice(v, sh)).to(device)
            for k, v in batch.items()}


def replicate(tree, mesh):
    """Rank 0's values on every rank's device: a tensor, a dict of them, or
    a module (parameters and buffers, in place)."""
    device = mesh_device(mesh)
    if isinstance(tree, nn.Module):
        tree = tree.to(device)
        with torch.no_grad():
            for t in list(tree.parameters()) + list(tree.buffers()):
                dist.broadcast(t.data, 0)
        return tree
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    t = _tensor(tree).to(device).contiguous()
    dist.broadcast(t, 0)
    return t
