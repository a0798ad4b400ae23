"""The kernel-library build cache — the port's counterpart of
``horovod_tpu/utils/compile_cache.py``.

The JAX package points XLA's persistent compilation cache at a directory.
The port compiles no XLA program; what it builds is its CUDA kernel
libraries (``ops/_build.py``), one ``nvcc`` run a source, keyed by a digest
of the source, its headers, the flags and the compiler. The cache is the
directory they are built in: ``horovod_tpu_torch/_build/`` by default (the
repo's ``.gitignore`` lists it). :func:`enable_compilation_cache` moves it
(``HOROVOD_COMPILE_CACHE`` by default, which ``hvd.init()`` applies when it
is set), so processes and jobs that share the directory build each library
once.

The active directory is recorded (:func:`active_cache_dir`), so the memory
ledger's load records tell a hit from a miss against it, and a failure to
enable is visible three ways: a warning, once, with the reason; the reason
as the return value; and the ``hvd_compile_cache_enabled`` gauge (1/0).
"""

from __future__ import annotations

import logging
import os
from typing import Optional

from ..common import env as env_schema

LOG = logging.getLogger("horovod_tpu_torch")

_ACTIVE_DIR: Optional[str] = None
_WARNED = False


def active_cache_dir() -> Optional[str]:
    """The directory enabled in this process, or None."""
    return _ACTIVE_DIR


def enable_compilation_cache(cache_dir: Optional[str] = None
                             ) -> Optional[str]:
    """Build and load the kernel libraries in ``cache_dir`` (default:
    ``$HOROVOD_COMPILE_CACHE``, else the package's ``_build/``).

    Returns None on success, else the reason it failed (warned once and
    published on the ``hvd_compile_cache_enabled`` gauge); the libraries
    then stay where they were. Never raises."""
    global _ACTIVE_DIR, _WARNED
    from ..ops import _build

    try:
        cache_dir = os.path.abspath(
            cache_dir or os.environ.get(env_schema.HOROVOD_COMPILE_CACHE)
            or _build.DEFAULT_BUILD_DIR)
        os.makedirs(cache_dir, exist_ok=True)
        if not os.access(cache_dir, os.W_OK | os.X_OK):
            raise PermissionError(f"{cache_dir} is not writable")
        _build.set_build_dir(cache_dir)
        reason = None
    except Exception as e:
        reason = f"{type(e).__name__}: {e}"
    from . import metrics as metrics_mod

    metrics_mod.get_registry().gauge(
        "hvd_compile_cache_enabled",
        "1 when the kernel-library cache directory is enabled, 0 when the "
        "last attempt failed").set(0 if reason else 1)
    if reason is None:
        _ACTIVE_DIR = cache_dir
        return None
    if not _WARNED:
        _WARNED = True
        LOG.warning("kernel-library cache NOT enabled (%s): the libraries "
                    "are built in %s", reason, _build.build_dir())
    return reason
