"""Build the port's CUDA kernels with nvcc, and its host data plane with
g++, and load them with ctypes.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface (the Swin
kernels share ``csrc/swin_common.cuh``). At first
use it is compiled for Hopper (``sm_90a``) into ``_build/`` inside the
package (git-ignored), under a name that carries the hash of its source and
flags, so an edited source is rebuilt and an unchanged one is loaded as it
is. The host data plane, ``csrc/dataplane.cpp``, builds the same way with
g++ (standard headers only), under a name that also carries the
compiler's version. Only the repository's own sources are compiled;
nothing is fetched.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from functools import lru_cache
from pathlib import Path
from typing import Dict

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_loaded: Dict[str, ctypes.CDLL] = {}
# compiler output (ptxas register and shared-memory report) per kernel built
# in this process; empty for a library found already built
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); CUDA kernels cannot be built")
    return found


def _cxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found on PATH; the host data plane "
                           "(csrc/dataplane.cpp) cannot be built")
    return found


@lru_cache(maxsize=None)
def _cxx_version() -> str:
    """The first line of ``g++ --version``: a library built by another
    machine's compiler is not taken for this one's."""
    out = subprocess.run([_cxx(), "--version"], capture_output=True,
                         text=True, check=True).stdout
    return out.splitlines()[0]


def _source(name: str) -> Path:
    cu = CSRC_DIR / f"{name}.cu"
    return cu if cu.is_file() else CSRC_DIR / f"{name}.cpp"


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to for its current source and the
    shared headers (``csrc/*.cuh``) it may include; ``csrc/<name>.cpp``
    for its source, flags and compiler."""
    source = _source(name)
    src = source.read_bytes()
    if source.suffix == ".cu":
        src += b"".join(p.read_bytes()
                        for p in sorted(CSRC_DIR.glob("*.cuh")))
        flags = " ".join(NVCC_FLAGS)
    else:
        flags = " ".join(HOST_FLAGS) + _cxx_version()
    digest = hashlib.sha256(src + flags.encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _command(name: str, out: str) -> list:
    source = _source(name)
    if source.suffix == ".cu":
        return [_nvcc(), *NVCC_FLAGS, "-o", out, str(source)]
    return [_cxx(), *HOST_FLAGS, "-o", out, str(source)]


def build(names) -> Dict[str, float]:
    """Compile each ``csrc/<name>.cu`` (or ``.cpp``) whose library is
    missing, with one nvcc (or g++) per source, all started together.
    Returns the seconds each build took (0.0 for a library found already
    built); raises on a failed build."""
    started = {}
    for name in names:
        out = library_path(name)
        if out.is_file():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # compile to a private name, then rename: a concurrent builder of the
        # same source never sees a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(_command(name, tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out, t0) in started.items():
        _, stderr = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{Path(proc.args[0]).name} failed for "
                          f"{_source(name).name} (exit {proc.returncode}):"
                          f"\n{stderr}")
            continue
        os.replace(tmp, out)
        build_logs[name] = stderr
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def loaded(name: str):
    """``csrc/<name>``'s library if this process has loaded it, else
    None."""
    return _loaded.get(name)


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` (or ``.cpp``) if its library is missing,
    then load it."""
    if name in _loaded:
        return _loaded[name]
    build([name])
    lib = ctypes.CDLL(str(library_path(name)))
    _loaded[name] = lib
    return lib
