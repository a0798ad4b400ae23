"""Small helpers the port needs from ``horovod_tpu/common/util.py``."""

from __future__ import annotations

import contextlib
import os
import tempfile


@contextlib.contextmanager
def atomic_tmp(path: str):
    """Yield a unique tmp filename next to ``path``; atomically commit it
    over ``path`` on clean exit, remove it on error.

    Every worker of a job may build the same artifact at once (the kernel
    libraries), so tmp names are per-call unique and the tmp lives in the
    target's directory so the rename stays on one filesystem. The tmp name
    keeps the target's extension, for tools that key on it (a linker
    writing ``.so``).
    """
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    stem, ext = os.path.splitext(os.path.basename(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=stem + ".", suffix=ext)
    os.close(fd)
    try:
        yield tmp
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def atomic_write_bytes(path: str, data: bytes):
    """Write ``data`` to ``path`` whole or not at all (through
    :func:`atomic_tmp`): a reader never sees a half-written file."""
    with atomic_tmp(path) as tmp:
        with open(tmp, "wb") as f:
            f.write(data)
