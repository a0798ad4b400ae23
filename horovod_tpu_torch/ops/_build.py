"""Builds the port's CUDA kernels from ``horovod_tpu_torch/csrc`` at first
use and loads them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C function and compiles with
``nvcc`` alone (no PyTorch headers) into ``_build/<name>-<digest>.so``
inside the package, for ``sm_90a``; the headers beside it (``csrc/*.cuh``)
are on its include path. The digest covers the source, every header, the
flags and the compiler, so an edited source or header builds anew and an
unchanged one loads the existing library. A failed build raises: there is no
fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from ..common.util import atomic_tmp

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the port's CUDA kernels cannot be built")
    return found


def _lib_path(name: str, nvcc: str) -> str:
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [name + ".cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read())
    h.update(" ".join((nvcc,) + NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def lib_path(name: str) -> str:
    """Where the library of ``csrc/<name>.cu`` is, or will be, built."""
    return _lib_path(name, _nvcc())


def nvcc_command(source: str, out: str) -> list:
    """The nvcc command that builds ``source`` into the library ``out``,
    with ``csrc/`` on the include path."""
    return [_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", out, source]


def cuda_tool(tool: str) -> str:
    """A CUDA toolkit program beside ``nvcc`` (``cuobjdump``, ...)."""
    return os.path.join(os.path.dirname(_nvcc()), tool)


def build(name: str) -> str:
    """Build ``csrc/<name>.cu`` unless its library exists. Returns nvcc's
    report (ptxas registers, shared memory and spills), empty when the
    library was already built."""
    nvcc = _nvcc()
    path = _lib_path(name, nvcc)
    if os.path.exists(path):
        return ""
    with atomic_tmp(path) as tmp:
        run = subprocess.run(
            nvcc_command(os.path.join(CSRC, name + ".cu"), tmp),
            capture_output=True, text=True)
        report = run.stdout + run.stderr
        if run.returncode != 0:
            raise RuntimeError(f"kernel build failed: {name}.cu (exit "
                               f"{run.returncode}):\n{report}")
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(lib_path(name))
            _libs[name] = lib
        return lib
