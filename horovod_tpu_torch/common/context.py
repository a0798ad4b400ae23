"""Process lifecycle and topology — counterpart of
``horovod_tpu/common/context.py`` (``init`` :246, rank/size API :542-584).

The port follows the reference Horovod's rank model: one process per GPU.
Rank, size and the local/cross split come from the ``HOROVOD_*`` variables
a launcher injects per slot; the process drives ``cuda:<local_rank>``.
The data plane is ``torch.distributed``: NCCL on the GPU, gloo on the CPU.

- Standalone (no launcher environment) ``init`` makes a size-1 group over
  an in-process ``HashStore``: a single-GPU run still goes through a real
  NCCL communicator and needs no free port.
- Under a launcher the group rendezvouses through a ``TCPStore`` hosted by
  rank 0 at ``MASTER_ADDR``/``MASTER_PORT``.

Without CUDA, ``init`` raises unless the caller asks for
``device="cpu"``: it never carries on silently on the CPU.
"""

from __future__ import annotations

import datetime
import os
import threading
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from . import env as env_schema

_STORE_TIMEOUT = datetime.timedelta(seconds=300)


class ProcessSet:
    """A named set of ranks backed by a ``torch.distributed`` group (the
    counterpart of ``horovod_tpu``'s mesh-backed ``ProcessSet``)."""

    def __init__(self, name: str, ranks: Sequence[int], group):
        self.name = name
        self.ranks = list(ranks)
        self.group = group

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def rank(self) -> int:
        """This process's index within the set."""
        return dist.get_rank(self.group)

    def __repr__(self) -> str:
        return f"ProcessSet({self.name!r}, ranks={self.ranks})"


class _Context:
    def __init__(self):
        self.lock = threading.Lock()
        self.initialized = False
        self.device: Optional[torch.device] = None
        self.global_set: Optional[ProcessSet] = None
        self.rank = self.size = 0
        self.local_rank = self.local_size = 0
        self.cross_rank = self.cross_size = 0


_ctx = _Context()


def _env_local_rank() -> int:
    # a launcher that gives no local split describes a single host
    return env_schema.get_int(env_schema.HOROVOD_LOCAL_RANK,
                              env_schema.get_int(env_schema.HOROVOD_RANK, 0))


def _resolve_device(device, local_rank: int) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "horovod_tpu_torch: CUDA is not available; pass "
                "device='cpu' to run on the CPU")
        return torch.device("cuda", local_rank)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def _store(rank: int, size: int):
    if os.environ.get(env_schema.HOROVOD_RANK) is None:
        return dist.HashStore()
    port = os.environ.get(env_schema.MASTER_PORT)
    if port is None:
        raise RuntimeError(
            f"{env_schema.HOROVOD_RANK} is set but {env_schema.MASTER_PORT} "
            "is not: a launched worker needs the rendezvous address")
    addr = os.environ.get(env_schema.MASTER_ADDR, "127.0.0.1")
    return dist.TCPStore(addr, int(port), size, is_master=(rank == 0),
                         timeout=_STORE_TIMEOUT)


def init(device=None):
    """Initialize the port (reference ``hvd.init()``).

    ``device=None`` picks ``cuda:<local_rank>`` and raises when CUDA is
    absent; ``device="cpu"`` runs the gloo data plane on the CPU (tests).
    Idempotent.
    """
    with _ctx.lock:
        if _ctx.initialized:
            return
        rank = env_schema.get_int(env_schema.HOROVOD_RANK, 0)
        size = env_schema.get_int(env_schema.HOROVOD_SIZE, 1)
        local_rank = _env_local_rank()
        local_size = env_schema.get_int(env_schema.HOROVOD_LOCAL_SIZE, size)
        cross_rank = env_schema.get_int(env_schema.HOROVOD_CROSS_RANK, 0)
        cross_size = env_schema.get_int(env_schema.HOROVOD_CROSS_SIZE, 1)
        dev = _resolve_device(device, local_rank)
        kw = {}
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            # bind the communicator to the device now, not at first use
            kw["device_id"] = dev
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=_store(rank, size), rank=rank,
                                world_size=size, timeout=_STORE_TIMEOUT, **kw)
        _ctx.device = dev
        _ctx.global_set = ProcessSet("global", range(size), dist.group.WORLD)
        _ctx.rank, _ctx.size = rank, size
        _ctx.local_rank, _ctx.local_size = local_rank, local_size
        _ctx.cross_rank, _ctx.cross_size = cross_rank, cross_size
        _ctx.initialized = True


def shutdown():
    """Tear the process group down; a second call is a no-op."""
    with _ctx.lock:
        if not _ctx.initialized:
            return
        dist.destroy_process_group()
        _ctx.initialized = False
        _ctx.global_set = None
        _ctx.device = None


def is_initialized() -> bool:
    return _ctx.initialized


def _require_init() -> _Context:
    if not _ctx.initialized:
        raise ValueError(
            "horovod_tpu_torch has not been initialized; call hvd.init()")
    return _ctx


def global_process_set() -> ProcessSet:
    return _require_init().global_set


def device() -> torch.device:
    """The device this process drives: ``cuda:<local_rank>`` or the CPU."""
    return _require_init().device


def default_device() -> torch.device:
    """Where an entry point places its tensors when the caller names no
    device: ``device()`` once initialized, else ``cuda:<local_rank>``.
    Raises when CUDA is absent: the CPU is only ever asked for."""
    if _ctx.initialized:
        return _ctx.device
    return _resolve_device(None, _env_local_rank())


def size() -> int:
    return _require_init().size


def rank() -> int:
    return _require_init().rank


def local_size() -> int:
    return _require_init().local_size


def local_rank() -> int:
    return _require_init().local_rank


def cross_size() -> int:
    return _require_init().cross_size


def cross_rank() -> int:
    return _require_init().cross_rank
