"""Read the JAX package's flax-msgpack checkpoints without flax or msgpack.

Counterpart of the restore side of ``train/checkpoint.py`` in the JAX
package, whose ``CheckpointManager`` writes ``<modelname>[_tag].msgpack``
with ``flax.serialization.to_bytes``: either the whole TrainState
(``save_optimizer=True``: ``step``, ``params``, ``opt_state``,
``batch_stats``, ...) or ``{"params", "batch_stats"}``. The file is one
msgpack map with string keys; arrays are msgpack ext type 1, a packed
``(shape, dtype name, C-order bytes)`` triple, and numpy scalars ext type
3 in the same form. This module decodes that much of msgpack itself, so
the GPU machine (which has no msgpack package) can serve a JAX-trained
student. Anything else, such as flax's chunked layout for arrays over
1 GiB or a complex number, raises ``ValueError``.

Usage::

    variables = restore_variables(checkpoint_path(directory, "student"))
    load_jax_variables(model, variables)
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict

import numpy as np

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
