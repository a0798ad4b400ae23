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

``init`` also reads the ``RuntimeConfig`` and starts the background runtime
(``ops/queue.py``) on ``device()``, as ``horovod_tpu/common/context.py``
:337-362 does. The runtime runs its collectives on a process group of its
own, so they never interleave with collectives the caller's thread issues
on the world group. A world of more than one rank negotiates over the
launcher's rendezvous store (``HOROVOD_GLOO_RENDEZVOUS_ADDR``/``_PORT``);
where no launcher set one, rank 0 serves a store itself and publishes its
address and a fresh secret through the ``torch.distributed`` store (the JAX
package falls back to name-ordered execution there, which two ranks whose
gradient hooks fire in different orders cannot survive). ``shutdown``
stops the runtime, whose pending handles fail with
``HorovodInternalError``.
"""

from __future__ import annotations

import datetime
import json
import os
import threading
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from . import env as env_schema

_KV_KEY = "horovod_tpu_torch/kv"

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
        self.config: Optional[env_schema.RuntimeConfig] = None
        self.runtime = None
        self.kv_server = None  # a store rank 0 serves without a launcher


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
        store = _store(rank, size)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=store, rank=rank,
                                world_size=size, timeout=_STORE_TIMEOUT, **kw)
        _ctx.device = dev
        _ctx.global_set = ProcessSet("global", range(size), dist.group.WORLD)
        _ctx.rank, _ctx.size = rank, size
        _ctx.local_rank, _ctx.local_size = local_rank, local_size
        _ctx.cross_rank, _ctx.cross_size = cross_rank, cross_size
        _ctx.config = env_schema.RuntimeConfig.from_env()
        _start_runtime(store)
        _ctx.initialized = True


def _kv_client(store):
    """The rendezvous store's client for negotiation: the launcher's, or
    one rank 0 serves when no launcher gave an address."""
    from ..runner.http_server import KVStoreClient, RendezvousServer

    addr = os.environ.get(env_schema.HOROVOD_GLOO_RENDEZVOUS_ADDR)
    port = os.environ.get(env_schema.HOROVOD_GLOO_RENDEZVOUS_PORT)
    if addr and port:
        return KVStoreClient(addr, int(port))
    if _ctx.rank == 0:
        from ..runner.secret import make_secret_key

        secret = make_secret_key()
        host = os.environ.get(env_schema.MASTER_ADDR, "127.0.0.1")
        _ctx.kv_server = RendezvousServer(secret_key=secret)
        _ctx.kv_server.start()
        store.set(_KV_KEY, json.dumps({"addr": host,
                                       "port": _ctx.kv_server.port,
                                       "secret": secret}))
    kv = json.loads(store.get(_KV_KEY))
    return KVStoreClient(kv["addr"], kv["port"], secret_key=kv["secret"])


def _start_runtime(store):
    from ..ops.queue import BackgroundRuntime

    # the runtime's own communicator (see the module docstring)
    group = dist.new_group(list(range(_ctx.size)))
    kv = _kv_client(store) if _ctx.size > 1 else None
    _ctx.runtime = BackgroundRuntime(_ctx.global_set, _ctx.config,
                                     _ctx.device, group, kv_client=kv)
    _ctx.runtime.start()


def shutdown():
    """Stop the runtime (its pending handles fail) and tear the process
    group down; a second call is a no-op."""
    with _ctx.lock:
        if not _ctx.initialized:
            return
        if _ctx.runtime is not None:
            _ctx.runtime.stop()
            _ctx.runtime = None
        if _ctx.kv_server is not None:
            _ctx.kv_server.stop()
            _ctx.kv_server = None
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


def runtime():
    """The background runtime ``init`` started."""
    return _require_init().runtime


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
