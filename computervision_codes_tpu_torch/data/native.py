"""The port's host data plane: frames from disk as resized uint8 or
ImageNet-normalised float32 arrays.

The port's copy of ``data/native.py`` in the JAX package, over
``csrc/dataplane.cpp`` built by ``ops/_build.py`` at first use. It is the
port's only decoder: there is no switch, no environment variable and no
other path, and a library that does not build, or a frame that does not
decode, raises.

PNG is decoded without libpng: this module reads the file, checks the
signature and the CRC of every critical chunk, takes the header and the
palette, and inflates the concatenated image data with the standard
library's ``zlib``; the C++ library undoes the row filters, expands the
pixels to 8-bit RGB as the JAX plane's libpng transforms do and resizes
with the JAX plane's fixed-point bilinear (within 1 LSB of PIL's). JPEG
stills and MJPEG containers (``VideoReader``) need libjpeg, which the plane
is built without: they raise ``RuntimeError`` naming it.

``decode_batch`` and ``decode_batch_u8`` fan the frames out over threads:
the file read, ``zlib.decompress`` and the ctypes call each release the
GIL, so the threads decode in parallel.
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from .transforms import IMAGENET_MEAN, IMAGENET_STD

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SOI = b"\xff\xd8\xff"
NO_LIBJPEG = ("{}: JPEG needs libjpeg, and the port's data plane is built "
              "without it (it decodes PNG only)")
# color type -> (channels, the bit depths it allows)
_COLOR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)),
                3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7: (x0, y0, dx, dy) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_MAX_INFLATE = 1032  # deflate's largest ratio of output to input bytes
_ERRORS = {1: "image data too short", 2: "unknown row filter",
           3: "bad header"}

_lib = None


def load_library():
    """The data plane's library, built on first use; raises if it does
    not build."""
    global _lib
    if _lib is None:
        from ..ops import _build

        lib = _build.load_library("dataplane")
        ptr, i32, size_t = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
        png_args = [ctypes.c_char_p, size_t, i32, i32, i32, i32, i32,
                    ctypes.c_char_p, i32, ptr, i32, i32]
        lib.dp_png_u8.restype = i32
        lib.dp_png_u8.argtypes = png_args
        lib.dp_png.restype = i32
        lib.dp_png.argtypes = png_args + [ptr, ptr]
        lib.dp_resize_u8.restype = None
        lib.dp_resize_u8.argtypes = [ptr, i32, i32, ptr, i32, i32]
        lib.dp_route.restype = ctypes.c_char_p
        lib.dp_route.argtypes = []
        _lib = lib
    return _lib


def route() -> str:
    """What the built library decodes, in its own words."""
    return load_library().dp_route().decode()


def default_threads() -> int:
    return min(len(os.sched_getaffinity(0)), 16)


class Png(NamedTuple):
    """One PNG file's inflated image data and the header that reads it."""

    data: bytes  # the inflated stream of the concatenated IDAT chunks
    width: int
    height: int
    bit_depth: int
    color_type: int
    interlace: int
    palette: bytes  # RGB triples


def _data_size(width: int, height: int, channels: int, bit_depth: int,
               interlace: int) -> int:
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    total = 0
    for x0, y0, dx, dy in passes:
        pw = max(0, -(-(width - x0) // dx))
        ph = max(0, -(-(height - y0) // dy))
        if pw and ph:
            total += ph * (1 + (pw * channels * bit_depth + 7) // 8)
    return total


def read_png(path: str) -> Png:
    """Read and inflate one PNG file; ``IOError`` when it is not a valid
    PNG, ``RuntimeError`` when it is a JPEG."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_SIGNATURE:
        if data[:3] == JPEG_SOI:
            raise RuntimeError(NO_LIBJPEG.format(path))
        raise IOError(f"{path}: not a PNG file")
    view = memoryview(data)
    header, palette, idat = None, b"", []
    pos = 8
    while True:
        if pos + 12 > len(data):
            raise IOError(f"{path}: truncated PNG (no IEND chunk)")
        length, kind = struct.unpack_from(">I4s", data, pos)
        end = pos + 12 + length
        if end > len(data):
            raise IOError(f"{path}: truncated {kind!r} chunk")
        body = view[pos + 8:end - 4]
        # critical chunks (upper-case first letter) must pass their CRC, as
        # libpng requires; ancillary chunks are skipped unread
        critical = not kind[0] & 0x20
        if critical and (zlib.crc32(view[pos + 4:end - 4])
                         != struct.unpack_from(">I", data, end - 4)[0]):
            raise IOError(f"{path}: CRC error in {kind!r}")
        if kind == b"IHDR":
            if len(body) != 13:
                raise IOError(f"{path}: IHDR of {len(body)} bytes, not 13")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = bytes(body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos = end
    if header is None or not idat:
        raise IOError(f"{path}: PNG without IHDR or IDAT")
    width, height, bit_depth, color_type, method, filt, interlace = header
    channels, depths = _COLOR_TYPES.get(color_type, (0, ()))
    if (bit_depth not in depths or method or filt or interlace > 1
            or not width or not height
            or (color_type == 3 and not palette)):
        raise IOError(f"{path}: unsupported PNG header {header}")
    size = _data_size(width, height, channels, bit_depth, interlace)
    stream = b"".join(idat)
    # deflate inflates at most 1032-fold: a header that asks for more than
    # the stream can hold is refused before the buffer is allocated
    if size > _MAX_INFLATE * len(stream):
        raise IOError(f"{path}: {len(stream)} bytes of image data cannot "
                      f"hold a {width}x{height} image")
    try:
        raw = zlib.decompress(stream, bufsize=size)
    except zlib.error as e:
        raise IOError(f"{path}: {e}") from e
    return Png(raw, width, height, bit_depth, color_type, interlace,
               palette)


def _check(rc: int, path: str) -> None:
    if rc:
        raise IOError(f"{path}: {_ERRORS.get(rc, rc)}")


def _png_args(png: Png) -> tuple:
    return (png.data, len(png.data), png.width, png.height, png.bit_depth,
            png.color_type, png.interlace, png.palette,
            len(png.palette) // 3)


def png_to_u8(png: Png, out: np.ndarray, what: str = "PNG") -> None:
    """Unfilter, expand and resize an inflated PNG into ``out``, (H, W, 3)
    uint8 C-contiguous."""
    h, w, _ = out.shape
    _check(load_library().dp_png_u8(*_png_args(png), out.ctypes.data, h, w),
           what)


def decode_one_u8(path: str, out: np.ndarray) -> None:
    """Decode ``path`` and resize it into ``out``, (H, W, 3) uint8
    C-contiguous."""
    png_to_u8(read_png(path), out, path)


def decode_one(path: str, out: np.ndarray, mean=IMAGENET_MEAN,
               std=IMAGENET_STD) -> None:
    """Decode ``path``, resize and normalise it into ``out``, (H, W, 3)
    float32 C-contiguous."""
    h, w, _ = out.shape
    png = read_png(path)
    mean_a = np.ascontiguousarray(mean, np.float32)
    std_a = np.ascontiguousarray(std, np.float32)
    _check(load_library().dp_png(*_png_args(png), out.ctypes.data, h, w,
                                 mean_a.ctypes.data, std_a.ctypes.data),
           path)


def _decode_all(paths: Sequence[str], out: np.ndarray,
                one: Callable[[str, np.ndarray], None],
                n_threads: Optional[int]) -> np.ndarray:
    """``one(paths[i], out[i])`` for every i on up to ``n_threads``
    threads. Files that fail to decode are counted and raise ``IOError``
    together; a JPEG raises its ``RuntimeError`` as it is."""
    load_library()  # build before the threads start

    def work(i: int) -> Optional[OSError]:
        try:
            one(paths[i], out[i])
        except OSError as e:
            return e
        return None

    n = len(paths)
    threads = max(1, min(n_threads or default_threads(), n))
    if threads == 1:
        errors = [work(i) for i in range(n)]
    else:
        with ThreadPoolExecutor(threads) as pool:
            errors = list(pool.map(work, range(n)))
    failed = [e for e in errors if e is not None]
    if failed:
        raise IOError(f"native decode failed for {len(failed)}/{n} "
                      f"files") from failed[0]
    return out


def decode_batch(paths: Sequence[str], size: Tuple[int, int],
                 mean=IMAGENET_MEAN, std=IMAGENET_STD,
                 n_threads: Optional[int] = None) -> np.ndarray:
    """Decode+resize+normalize a batch of files -> (N, H, W, 3) float32."""
    h, w = size
    out = np.empty((len(paths), h, w, 3), np.float32)
    return _decode_all(paths, out,
                       lambda p, o: decode_one(p, o, mean, std), n_threads)


def decode_batch_u8(paths: Sequence[str], size: Tuple[int, int],
                    n_threads: Optional[int] = None) -> np.ndarray:
    """Decode+resize WITHOUT normalization -> (N, H, W, 3) uint8 (the
    serving sessions normalise uint8 frames on the device)."""
    h, w = size
    out = np.empty((len(paths), h, w, 3), np.uint8)
    return _decode_all(paths, out, decode_one_u8, n_threads)


def resize_u8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """(h, w, 3) uint8 -> (H, W, 3) uint8 through the fixed-point
    bilinear."""
    src = np.ascontiguousarray(img, np.uint8)
    h, w = size
    out = np.empty((h, w, 3), np.uint8)
    load_library().dp_resize_u8(src.ctypes.data, src.shape[0], src.shape[1],
                                out.ctypes.data, h, w)
    return out


class VideoReader:
    """MJPEG video reader (AVI containers and raw ``.mjpg`` streams). Its
    frames are JPEGs, and the data plane is built without libjpeg, so
    opening a container raises ``RuntimeError`` naming it."""

    def __init__(self, path: str):
        raise RuntimeError(NO_LIBJPEG.format(path))


def video_supported() -> bool:
    """Whether the data plane decodes MJPEG containers: not without
    libjpeg."""
    return False
