"""Crash-safe pickle checkpoints — counterpart of
``horovod_tpu/utils/checkpoint.py``'s pickle format.

A file written by either package loads in the other (numpy arrays and
plain containers pickle the same way in both). The JAX package's Orbax
directory format is JAX's and is not ported (ROADMAP.md queue 3): asking
for it raises.

``save_pytree`` streams the pickle (protocol 5) into a tmp file in the
same directory, fsyncs it and renames it over the path: the committed
path only ever goes from one whole checkpoint to the next. A
``ckpt.write:torn`` fault cuts the tmp file in half and fails before the
rename, as a crash mid-write would.
``load_pytree`` and ``exists`` also accept the ``.old`` rotation that the
JAX package's directory format leaves after a crash mid-save.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Optional


def _check_format(format: Optional[str]):
    if format not in (None, "pickle"):
        raise ValueError(
            f"checkpoint format {format!r} is not supported by "
            "horovod_tpu_torch: only 'pickle' is (Orbax is the JAX "
            "package's)")


def save_pytree(path: str, tree: Any, *, format: str = "pickle"):
    """Persist ``tree`` at ``path`` atomically (module docstring)."""
    _check_format(format)
    from ..common.exceptions import FaultInjectedError
    from ..common.util import atomic_tmp
    from . import faults

    with atomic_tmp(path) as tmp:
        with open(tmp, "wb") as f:
            # streamed at protocol 5: each array's buffer goes straight to
            # the file, whose write releases the GIL, so a writer thread
            # never holds it for a copy of the whole payload
            pickle.dump(tree, f, protocol=5)
            cut = faults.torn("ckpt.write")
            if cut:
                f.truncate(f.tell() // 2)
            f.flush()
            os.fsync(f.fileno())
        if cut:
            # the torn write "crashed" before the rename: the tmp goes and
            # the committed checkpoint stays readable
            raise FaultInjectedError(
                f"injected torn write at {path!r} (HOROVOD_FAULT_SPEC)")


def _resolve(path: str) -> str:
    """``path``, or its ``.old`` rotation when only that survived."""
    if os.path.exists(path):
        return path
    if os.path.exists(path + ".old"):
        return path + ".old"
    return path


def load_pytree(path: str, *, format: Optional[str] = None) -> Any:
    """Load a checkpoint written by ``save_pytree`` (either package's)."""
    _check_format(format)
    path = _resolve(path)
    if os.path.isdir(path):
        raise ValueError(f"{path!r} is a directory (an Orbax checkpoint?); "
                         "horovod_tpu_torch reads pickle files only")
    with open(path, "rb") as f:
        return pickle.load(f)


def exists(path: str) -> bool:
    return os.path.exists(path) or os.path.exists(path + ".old")
