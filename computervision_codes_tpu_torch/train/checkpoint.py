"""flax-msgpack checkpoints, read and written without flax or msgpack.

Counterpart of ``train/checkpoint.py`` in the JAX package, whose
``CheckpointManager`` writes ``<modelname>[_tag].msgpack`` with
``flax.serialization.to_bytes``: either the whole TrainState
(``save_optimizer=True``: ``step``, ``params``, ``opt_state``,
``batch_stats``, ``frozen``, ``rng``) or ``{"params", "batch_stats"}``. The
file is one msgpack map with string keys; arrays are msgpack ext type 1, a
packed ``(shape, dtype name, C-order bytes)`` triple, and numpy scalars
ext type 3 in the same form. This module encodes and decodes that much of
msgpack itself, byte for byte as the msgpack package does, so the GPU
machine (which has no msgpack package) can serve a JAX-trained student and
train where JAX stopped, and JAX's ``serialization.from_bytes`` restores
what the port writes. Anything else, such as flax's chunked layout for
arrays over 1 GiB or a complex number, raises ``ValueError``.

``CheckpointManager`` keeps the JAX manager's policy (the reference's
``weight_mgt``, MT4MTLKD/Spatial_cnn/run.py:260-271): ``_latest`` at every
validation, the best checkpoint when the score improves, reported as
"increased" or "decreased", the best score in a ``.meta.json`` sidecar, and
each file written to a temporary name and renamed. Its payload is the state
dict of the JAX driver's TrainState: the flax ``params`` of the port's
module (``models.convert.jax_variables``), ``step``, and ``opt_state`` as
optax lays out ``build_sgd``'s chain without momentum, whose only leaf is
the schedule's ``count``. The ``rng`` slot holds a JAX ``PRNGKey`` (uint32,
(2,)): the port writes a key drawn from a copy of the state's generator
(saving does not move it), and a restore seeds the generator from the key.
So a resumed port run and a resumed JAX run draw different dropout masks
from the same file, as the two packages do from one seed.

Usage::

    variables = restore_variables(checkpoint_path(directory, "student"))
    load_jax_variables(model, variables)
"""

from __future__ import annotations

import json
import os
import struct
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..models.convert import jax_variables, load_jax_variables

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


def checkpoint_path(directory: str, modelname: str, tag: str = "") -> str:
    """The file ``CheckpointManager`` writes: ``<modelname>[_tag].msgpack``
    in ``directory``."""
    suffix = f"_{tag}" if tag else ""
    return os.path.join(directory, f"{modelname}{suffix}.msgpack")


def _array(shape, dtype_name: bytes, buffer: bytes) -> np.ndarray:
    name = dtype_name.decode() if isinstance(dtype_name, bytes) \
        else dtype_name
    if name == "bfloat16":
        # numpy has no bfloat16: widen the bit patterns to float32 (exact)
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        flat = bits.view(np.float32)
    else:
        flat = np.frombuffer(buffer, np.dtype(name))
    return flat.reshape(tuple(shape)).copy()


class _Reader:
    """A msgpack decoder for the subset flax checkpoints use."""

    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("checkpoint ends inside a msgpack object")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",      # bin
                 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",      # str
                 0xDC: ">H", 0xDD: ">I",                  # array
                 0xDE: ">H", 0xDF: ">I"}                  # map
        if b in sized:
            n = self.unpack(sized[b])
            if b <= 0xC6:
                return self.take(n)
            if b <= 0xDB:
                return self.take(n).decode()
            if b <= 0xDD:
                return [self.value() for _ in range(n)]
            return self.map(n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(self.unpack(">b"), fixext[b])
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(self.unpack(">b"), n)
        raise ValueError(f"msgpack type byte 0x{b:02x} is not used by flax "
                         f"checkpoints")

    def map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, code: int, n: int):
        payload = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not an array or a "
                             f"numpy scalar (complex numbers and other "
                             f"objects are not read)")
        inner = _Reader(payload)
        triple = inner.value()
        if not (isinstance(triple, list) and len(triple) == 3):
            raise ValueError("malformed array record in checkpoint")
        arr = _array(*triple)
        return arr[()] if code == _EXT_NPSCALAR else arr


def _reject_chunked(tree, path="") -> None:
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            raise ValueError(f"{path or 'checkpoint'}: flax's chunked layout "
                             f"for arrays over 1 GiB is not read")
        for k, v in tree.items():
            _reject_chunked(v, f"{path}/{k}")


def read_msgpack(path: str) -> Dict[str, Any]:
    """The whole state dict of a flax msgpack file, arrays as numpy."""
    with open(path, "rb") as fh:
        data = fh.read()
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(data):
        raise ValueError(f"{path}: {len(data) - reader.pos} bytes after the "
                         f"state dict")
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: not a flax state dict")
    _reject_chunked(tree)
    return tree


def restore_variables(path: str) -> Dict[str, Any]:
    """``{"params", "batch_stats"}`` (and ``frozen`` when the state has it)
    as numpy trees, from a TrainState or a params + batch_stats checkpoint.
    """
    tree = read_msgpack(path)
    if not isinstance(tree.get("params"), dict):
        raise ValueError(f"{path}: no params in the checkpoint (keys "
                         f"{sorted(tree)})")
    out = {"params": tree["params"]}
    for coll in ("batch_stats", "frozen"):
        if isinstance(tree.get(coll), dict):
            out[coll] = tree[coll]
    return out


# ---------------------------------------------------------------------------
# writing: msgpack-python's encoding of the same objects


_U8, _U16, _U32, _U64 = 0xFF, 0xFFFF, 0xFFFFFFFF, 2 ** 64 - 1


def _header(out: bytearray, n: int, fix, sized) -> None:
    """A length (or unsigned integer) header: ``fix`` = (code, limit)
    writes ``code | n`` where n <= limit; else the first of ``sized``
    ((code, struct format, limit)) whose limit holds n."""
    if fix is not None and n <= fix[1]:
        out.append(fix[0] | n)
        return
    for code, fmt, limit in sized:
        if n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of length {n} is too long")


def _pack_array(a: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: (shape, dtype name, C-order bytes)."""
    return pack_msgpack((a.shape, a.dtype.name, a.tobytes("C")))


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, dict):
        _header(out, len(obj), (0x80, 0x0F), ((0xDE, ">H", _U16),
                                              (0xDF, ">I", _U32)))
        for k in sorted(obj):  # flax's tree_map sorts the keys
            _pack(k, out)
            _pack(obj[k], out)
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), (0x90, 0x0F), ((0xDC, ">H", _U16),
                                              (0xDD, ">I", _U32)))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, str):
        data = obj.encode()
        _header(out, len(data), (0xA0, 0x1F), (
            (0xD9, ">B", _U8), (0xDA, ">H", _U16), (0xDB, ">I", _U32)))
        out += data
    elif isinstance(obj, bytes):
        _header(out, len(obj), None, (
            (0xC4, ">B", _U8), (0xC5, ">H", _U16), (0xC6, ">I", _U32)))
        out += obj
    elif isinstance(obj, (np.ndarray, np.generic)):
        if obj.dtype.hasobject or obj.dtype.kind == "c":
            raise ValueError(f"{obj.dtype} arrays are not written")
        code = _EXT_NDARRAY if isinstance(obj, np.ndarray) else _EXT_NPSCALAR
        data = _pack_array(np.asarray(obj))
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if len(data) in fixed:
            out.append(fixed[len(data)])
        else:
            _header(out, len(data), None, (
                (0xC7, ">B", _U8), (0xC8, ">H", _U16), (0xC9, ">I", _U32)))
        out += struct.pack(">b", code) + data
    elif isinstance(obj, int) and not isinstance(obj, bool) and obj >= 0:
        _header(out, obj, (0x00, 0x7F), (
            (0xCC, ">B", _U8), (0xCD, ">H", _U16), (0xCE, ">I", _U32),
            (0xCF, ">Q", _U64)))
    else:
        raise ValueError(f"{type(obj).__name__} {obj!r} is not written to a "
                         f"flax checkpoint (a state dict of arrays)")


def pack_msgpack(tree: Any) -> bytes:
    """msgpack bytes of a tree of dicts with string keys, None, numpy
    arrays or scalars (and the tuples of shapes, strings, bytes and
    non-negative integers inside their records), as flax's
    ``msgpack_serialize`` packs it: keys sorted, arrays under 1 GiB."""
    out = bytearray()
    _pack(tree, out)
    return bytes(out)


# ---------------------------------------------------------------------------
# the TrainState as flax lays it out


def _sgd_opt_state(optimizer) -> Dict[str, Any]:
    """``opt_state`` of the JAX ``build_sgd(schedule or lr, weight_decay)``
    without momentum: ``chain([add_decayed_weights,] sgd)``, sgd being
    ``chain(identity, scale_by_learning_rate)``; only a schedule has a
    state, its ``count``."""
    group = optimizer.param_groups[0]
    if group.get("momentum", 0.0):
        raise NotImplementedError("checkpoints of SGD with momentum are not "
                                  "written yet (no driver of the port uses "
                                  "it)")
    lr_state = ({"count": np.asarray(optimizer.count, np.int32)}
                if getattr(optimizer, "schedule", None) is not None else {})
    sgd = {"0": {}, "1": lr_state}
    return {"0": {}, "1": sgd} if group["weight_decay"] else {"0": sgd}


def _find_count(tree) -> Optional[int]:
    if isinstance(tree, dict):
        if "count" in tree:
            return int(np.asarray(tree["count"]))
        for v in tree.values():
            found = _find_count(v)
            if found is not None:
                return found
    return None


def _rng_key(generator: torch.Generator) -> np.ndarray:
    """A JAX ``PRNGKey`` drawn from a copy of ``generator``."""
    copy = torch.Generator(device=generator.device)
    copy.set_state(generator.get_state())
    key = torch.randint(0, 2 ** 32, (2,), generator=copy,
                        device=generator.device, dtype=torch.int64)
    return key.cpu().numpy().astype(np.uint32)


def train_state_dict(state, save_optimizer: bool = True) -> Dict[str, Any]:
    """The flax state dict of a ``train.TrainState``: what JAX's
    ``serialization.to_state_dict`` gives for the JAX driver's state."""
    variables = jax_variables(state.model)
    if not save_optimizer:
        return {"params": variables["params"],
                "batch_stats": variables.get("batch_stats")}
    return {"step": np.asarray(state.step, np.int32),
            "params": variables["params"],
            "opt_state": _sgd_opt_state(state.optimizer),
            "batch_stats": variables.get("batch_stats"),
            "frozen": variables.get("frozen"),
            "rng": _rng_key(state.rng)}


def load_train_state(state, tree: Dict[str, Any],
                     save_optimizer: bool = True):
    """Restore ``state`` in place from a flax state dict: the weights, and
    with ``save_optimizer`` the step, the optimizer's schedule count and
    the generator (seeded from the ``rng`` key)."""
    variables = {"params": tree["params"]}
    for coll in ("batch_stats", "frozen"):
        if isinstance(tree.get(coll), dict):
            variables[coll] = tree[coll]
    load_jax_variables(state.model, variables)
    if not save_optimizer:
        return state
    state.step = int(np.asarray(tree["step"]))
    count = _find_count(tree.get("opt_state"))
    if count is not None:
        state.optimizer.count = count
    key = np.asarray(tree["rng"]).astype(np.uint64)
    state.rng.manual_seed(int(key[0]) << 32 | int(key[1]))
    return state


class CheckpointManager:
    """The JAX ``CheckpointManager``'s policy and files for a
    ``train.TrainState`` (msgpack only)."""

    def __init__(self, directory: str, modelname: str,
                 save_optimizer: bool = True):
        self.dir, self.modelname = directory, modelname
        self.save_optimizer = save_optimizer
        os.makedirs(directory, exist_ok=True)
        self._meta_path = os.path.join(directory, f"{modelname}.meta.json")
        self.best_score = float("-inf")
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                self.best_score = json.load(f).get("best_score",
                                                   float("-inf"))

    def path(self, tag: str = "") -> str:
        return checkpoint_path(self.dir, self.modelname, tag)

    def save(self, state, tag: str = "") -> str:
        """Write the state; a crash mid-write leaves the previous file (the
        resume path trusts ``_latest``)."""
        path = self.path(tag)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(pack_msgpack(train_state_dict(state,
                                                  self.save_optimizer)))
        os.replace(tmp, path)
        return path

    def update(self, state, score: float, epoch: int,
               logfile: Optional[str] = None) -> str:
        """Save ``_latest``; save the best when ``score`` improves."""
        self.save(state, tag="latest")
        if score > self.best_score:
            path = self.save(state, tag="")
            self.best_score = float(score)
            with open(self._meta_path, "w") as f:
                json.dump({"best_score": self.best_score, "epoch": epoch}, f)
            if logfile:
                with open(logfile, "a+") as f:
                    print(f">>> Saving checkpoint for epoch {epoch + 1} at "
                          f"{path}, time {time.ctime()} ", file=f)
            return "increased"
        return "decreased"

    def restore(self, state, tag: str = ""):
        """Restore ``state`` in place from the file (a TrainState or a
        params-only checkpoint, the port's or JAX's) and return it."""
        return load_train_state(state, read_msgpack(self.path(tag)),
                                self.save_optimizer)

    def exists(self, tag: str = "") -> bool:
        return os.path.exists(self.path(tag))
