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
  rank 0 at ``MASTER_ADDR``. Rank 0 opens it on port 0, so the port is the
  one the OS gave the socket that holds it, and publishes that port through
  the launcher's KV store (``HOROVOD_GLOO_RENDEZVOUS_ADDR``/``_PORT``); the
  other ranks read it there before they dial. A ``MASTER_PORT`` set by the
  user wins.

Without CUDA, ``init`` raises unless the caller asks for
``device="cpu"``: it never carries on silently on the CPU. ``init`` warns
once for each knob of the JAX package that the port does not implement
and that is turned on (``env.UNIMPLEMENTED_KNOBS``), and raises on a
``HOROVOD_COMPRESSION`` value outside ``none|bf16|int8|int4`` before it
joins the process group.

Process sets (``add_process_set``, JAX ``common/context.py`` :519-540)
are named sets of ranks, each with two ``torch.distributed`` groups: one
for the caller's thread (``barrier``, the object collectives) and one for
the runtime's cycle thread, so the two never interleave on a
communicator. Creating a group is collective over the world, so unlike
the JAX package's purely local call, ``add_process_set`` and
``remove_process_set`` must be called by every rank, members and
non-members alike, in the same order (the reference Horovod's contract
since 0.21).

The global set has two levels where a hierarchical knob
(``HOROVOD_HIERARCHICAL_ALLREDUCE``/``_ALLGATHER``) is set and the job is
homogeneous (``local_size > 1`` and ``size == local_size * cross_size``,
as JAX ``common/context.py:93-104`` requires of its ``mesh_2d``): the
local group (this host's ranks) and the cross group (the ranks that share
this ``local_rank``), each made for the caller and for the runtime
(``Hierarchy``). The launcher fills hosts in order, so a rank is
``cross_rank * local_size + local_rank``. Without a knob no group is made:
every rank would pay for communicators that nothing uses. Other sets stay
flat.

``shutdown(drain=False)`` is the elastic reset's (``elastic/__init__.py``):
the runtime stops without the shutdown barrier, the device is
synchronized, and the next ``init`` builds new communicators under the
next ``HOROVOD_ELASTIC_GEN``. The key under which rank 0 publishes its
``TCPStore``'s port carries the driver's ``HOROVOD_ELASTIC_EPOCH``, the
generation and this process's count of inits, so no rank of a new
incarnation or generation dials a store that is gone.

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

The instruments (JAX ``common/context.py`` :327-381, :472-494), built by
``init`` only when their knobs are set: the flight recorder, the tracer
(its clock offset measured against the launcher's ``GET /clock``), the
perf ledger and its SLO engine, the step anatomy, the timeline (rank 0
writes ``HOROVOD_TIMELINE``; ``start_timeline``/``stop_timeline`` open and
close it at run time), the stall inspector (unless
``HOROVOD_STALL_CHECK_DISABLE``), the autotuner (``HOROVOD_AUTOTUNE``) and
the metrics dumper (a ``HOROVOD_METRICS_FILE``, ``.rank{k}`` on the other
ranks, and under a launcher the push of every instrument's snapshot).
``shutdown`` closes the timeline and stops the dumper after a final
flush; the recorder, the ledger and the anatomy live as long as the
process, as the metrics registry does.

The postmortem, memory and health layer (JAX ``common/context.py``
:270-306, :383-424), in the JAX package's order: ``_start_diag`` (the
recorder, the watchdog, the crash hooks and their KV client) runs first,
then the kernel-library cache (``HOROVOD_COMPILE_CACHE``), the memory
ledger and, after the stall inspector, the health engine; the
autotuner is handed to the engine once it exists; the async
checkpointer's SIGTERM handler comes after the crash hooks. ``shutdown``
dumps the health history (``HOROVOD_HEALTH_FILE``) after the dumper's last
pass and stops the watchdog. With every knob of the layer off, nothing is
made: no thread, no hook, no signal handler.
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
from .exceptions import HorovodInternalError

_KV_KEY = "horovod_tpu_torch/kv"

_STORE_TIMEOUT = datetime.timedelta(seconds=300)
# where rank 0 publishes its TCPStore's port in the launcher's KV store
_STORE_PORT_SCOPE, _STORE_PORT_KEY = "horovod_tpu_torch", "tcp_store_port"


class Hierarchy:
    """This rank's two levels of the global set (the port's counterpart of
    the JAX ``ProcessSet.mesh_2d``): ``local_group`` over this host's
    ``local_size`` ranks, ``cross_group`` over the ``cross_size`` ranks
    that share this ``local_rank``, one rank a host."""

    __slots__ = ("local_group", "cross_group", "local_size", "cross_size",
                 "local_rank", "cross_rank")

    def __init__(self, local_group, cross_group, local_size: int,
                 cross_size: int, local_rank: int, cross_rank: int):
        self.local_group = local_group
        self.cross_group = cross_group
        self.local_size = local_size
        self.cross_size = cross_size
        self.local_rank = local_rank
        self.cross_rank = cross_rank

    @property
    def size(self) -> int:
        return self.local_size * self.cross_size


class ProcessSet:
    """A named set of ranks (the counterpart of ``horovod_tpu``'s
    mesh-backed ``ProcessSet``). ``group`` serves the caller's thread,
    ``runtime_group`` the background runtime; on a non-member both are
    ``torch.distributed``'s non-member marker. A port rank is one process,
    so ``rank``/``size`` and the process-level ``cross_rank``/
    ``cross_size`` coincide: they equal the JAX package's for a launch that
    gives each JAX worker one device. ``hierarchy`` and
    ``runtime_hierarchy`` are the two levels on the caller's and the
    runtime's groups, or None (the module docstring says when)."""

    def __init__(self, name: str, ranks: Sequence[int], group,
                 runtime_group=None):
        self.name = name
        self.ranks = list(ranks)
        self.group = group
        self.runtime_group = runtime_group
        self.hierarchy: Optional[Hierarchy] = None
        self.runtime_hierarchy: Optional[Hierarchy] = None

    @property
    def size(self) -> int:
        return len(self.ranks)

    def included(self) -> bool:
        return dist.get_rank() in self.ranks

    @property
    def rank(self) -> int:
        """This process's index within the set; a non-member raises."""
        me = dist.get_rank()
        if me not in self.ranks:
            raise HorovodInternalError(
                f"rank {me} is not a member of process set {self.name!r}")
        return self.ranks.index(me)

    cross_rank = rank

    @property
    def cross_size(self) -> int:
        return self.size

    def __repr__(self) -> str:
        return f"ProcessSet({self.name!r}, ranks={self.ranks})"


class _Context:
    def __init__(self):
        self.lock = threading.Lock()
        self.initialized = False
        self.device: Optional[torch.device] = None
        self.global_set: Optional[ProcessSet] = None
        self.process_sets: dict[str, ProcessSet] = {}
        self.rank = self.size = 0
        self.local_rank = self.local_size = 0
        self.cross_rank = self.cross_size = 0
        self.config: Optional[env_schema.RuntimeConfig] = None
        self.runtime = None
        self.kv_server = None  # a store rank 0 serves without a launcher
        self.inits = 0  # completed inits of this process
        self.timeline = None  # utils.timeline.Timeline
        self.stall_inspector = None
        self.autotuner = None
        self.metrics_dumper = None  # utils.metrics.MetricsDumper


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


def _launcher_kv():
    """The launcher's KV store client, or None when no launcher gave its
    address."""
    from ..runner.http_server import KVStoreClient

    addr = os.environ.get(env_schema.HOROVOD_GLOO_RENDEZVOUS_ADDR)
    port = os.environ.get(env_schema.HOROVOD_GLOO_RENDEZVOUS_PORT)
    if addr and port:
        return KVStoreClient(addr, int(port))
    return None


def _store_port_key() -> str:
    """The launcher KV key under which rank 0 publishes its ``TCPStore``'s
    port: one key an incarnation (the elastic driver's epoch), a reset
    generation and an init of this process. A relaunched process counts
    its inits from 0 again, and the driver's KV store outlives the
    incarnation, so without the epoch a new rank could read the port of a
    store that died with the last one."""
    return (f"{_STORE_PORT_KEY}."
            f"e{env_schema.get_int(env_schema.HOROVOD_ELASTIC_EPOCH, 0)}"
            f"g{env_schema.get_int(env_schema.HOROVOD_ELASTIC_GEN, 0)}"
            f".{_ctx.inits}")


def _store(rank: int, size: int):
    if os.environ.get(env_schema.HOROVOD_RANK) is None:
        return dist.HashStore()
    addr = os.environ.get(env_schema.MASTER_ADDR, "127.0.0.1")
    port = os.environ.get(env_schema.MASTER_PORT)
    if port is not None:
        return dist.TCPStore(addr, int(port), size, is_master=(rank == 0),
                             timeout=_STORE_TIMEOUT)
    kv = _launcher_kv()
    if kv is None:
        raise RuntimeError(
            f"{env_schema.HOROVOD_RANK} is set but neither "
            f"{env_schema.MASTER_PORT} nor the launcher's rendezvous "
            f"address ({env_schema.HOROVOD_GLOO_RENDEZVOUS_ADDR}/_PORT) is: "
            "a launched worker needs one of them")
    key = _store_port_key()
    if rank == 0:
        # the OS picks the port of the socket the store holds: no other
        # process can take it between the choice and the bind
        store = dist.TCPStore(addr, 0, size, is_master=True,
                              timeout=_STORE_TIMEOUT, wait_for_workers=False)
        kv.put(_STORE_PORT_SCOPE, key, str(store.port).encode())
        return store
    port = int(kv.get(_STORE_PORT_SCOPE, key,
                      timeout=_STORE_TIMEOUT.total_seconds()))
    return dist.TCPStore(addr, port, size, is_master=False,
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
        config = env_schema.RuntimeConfig.from_env()
        from ..ops.compression import resolve_quant_spec

        resolve_quant_spec(config)  # an unknown wire raises here
        env_schema.warn_unimplemented()
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
        _ctx.config = config
        # the runtime resolves the megaplan's manager once, when it is
        # built (horovod_tpu/common/context.py:294-299)
        from ..ops import megaplan as megaplan_mod

        megaplan_mod.init_manager(rank=rank)
        _init_instruments()
        _start_runtime(store)
        # the async checkpointer and its SIGTERM flush, when
        # HOROVOD_ASYNC_CKPT is set (horovod_tpu/common/context.py:307)
        from ..utils import async_ckpt

        async_ckpt.init_checkpointer(rank=rank, world=size)
        _start_metrics_dumper()
        _ctx.initialized = True
        _ctx.inits += 1
        from ..utils import flightrec

        flightrec.note("init_phase", phase="initialized")


def _build_hierarchy(ps: ProcessSet):
    """The global set's local and cross groups, for the caller and for the
    runtime, where the module docstring says. Every rank makes every
    group, in the same order: each host's local group, then each local
    rank's cross group, the caller's set before the runtime's."""
    c = _ctx
    L, X = c.local_size, c.cross_size
    if not ((c.config.hierarchical_allreduce
             or c.config.hierarchical_allgather)
            and L > 1 and c.size == L * X):
        return
    if c.rank != c.cross_rank * L + c.local_rank:
        raise RuntimeError(
            f"rank {c.rank} is not cross_rank * local_size + local_rank "
            f"({c.cross_rank} * {L} + {c.local_rank}): the launcher must "
            "fill hosts in order for the hierarchical collectives")
    for attr in ("hierarchy", "runtime_hierarchy"):
        local = cross = None
        for x in range(X):
            g = _new_group([x * L + i for i in range(L)])
            if x == c.cross_rank:
                local = g
        for i in range(L):
            g = _new_group([x * L + i for x in range(X)])
            if i == c.local_rank:
                cross = g
        setattr(ps, attr, Hierarchy(local, cross, L, X, c.local_rank,
                                    c.cross_rank))


def _kv_client(store):
    """The rendezvous store's client for negotiation: the launcher's, or
    one rank 0 serves when no launcher gave an address."""
    from ..runner.http_server import KVStoreClient, RendezvousServer

    kv = _launcher_kv()
    if kv is not None:
        return kv
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


def _init_instruments():
    """The flight recorder, tracer, perf ledger, anatomy, timeline and
    stall inspector whose knobs are set, before the runtime and its
    controller resolve them."""
    from ..utils import anatomy, flightrec, perfledger, tracing
    from ..utils.stall import StallInspector
    from ..utils.timeline import Timeline

    from ..utils import health, memledger

    cfg, rank = _ctx.config, _ctx.rank
    _start_diag()
    if cfg.compile_cache:
        from ..utils.compile_cache import enable_compilation_cache

        enable_compilation_cache(cfg.compile_cache)
    # the memory ledger before the runtime: a plan build and a kernel load
    # check its handle (horovod_tpu/common/context.py:280-285)
    memledger.init_ledger(rank=rank, on=cfg.memledger_enabled,
                          capacity=cfg.memledger_buffer)
    if cfg.trace_enabled:
        tracing.init_tracer(
            rank=rank,
            addr=os.environ.get(env_schema.HOROVOD_GLOO_RENDEZVOUS_ADDR),
            port=os.environ.get(env_schema.HOROVOD_GLOO_RENDEZVOUS_PORT))
    # rank 0 writes the timeline, as the reference's coordinator does
    _ctx.timeline = Timeline(cfg.timeline_filename if rank == 0 else "",
                             mark_cycles=cfg.timeline_mark_cycles)
    _ctx.stall_inspector = None if cfg.stall_check_disable else \
        StallInspector(warning_time_s=cfg.stall_warning_time_s,
                       shutdown_time_s=cfg.stall_shutdown_time_s)
    perfledger.init_ledger(rank=rank, stall_inspector=_ctx.stall_inspector)
    anatomy.init_profiler(rank=rank)
    # its anomalies warn through the stall inspector; the autotuner is
    # handed over once it exists (_start_runtime)
    health.init_engine(rank=rank, stall_inspector=_ctx.stall_inspector,
                       on=cfg.health_enabled, capacity=cfg.health_buffer,
                       warmup=cfg.health_warmup)


def _start_diag():
    """The postmortem layer (horovod_tpu/common/context.py:383-424): the
    flight recorder (``HOROVOD_FLIGHTREC``), the wedge watchdog
    (``HOROVOD_WATCHDOG_SECS`` > 0), the crash hooks and, under a
    launcher, a KV client of the diagnostics' own for the ``diag/`` pushes
    (not the metrics dumper's: a client's connection is per thread, and a
    dump fires from the watchdog or a signal handler). The memory ledger
    arms the same path for its OOM bundles. With every knob off nothing is
    made and no hook is installed."""
    from ..utils import diag, flightrec

    recorder = flightrec.init_recorder(rank=_ctx.rank)
    flightrec.note("init_phase", phase="config")
    wd = diag.init_watchdog(_ctx.config.watchdog_secs)
    if (recorder is None and wd is None
            and not _ctx.config.memledger_enabled):
        return
    diag.set_kv_client(_launcher_kv())
    # before the async checkpointer's SIGTERM handler, which chains to
    # this one: a preemption flushes the snapshot first, dumps second
    diag.install_crash_hooks()


def _start_runtime(store):
    from ..ops.queue import BackgroundRuntime

    # the runtime's own communicator (see the module docstring)
    group = _new_group(list(range(_ctx.size)))
    _ctx.global_set.runtime_group = group
    _ctx.process_sets = {"global": _ctx.global_set}
    _build_hierarchy(_ctx.global_set)
    kv = _kv_client(store) if _ctx.size > 1 else None
    _ctx.runtime = BackgroundRuntime(_ctx.global_set, _ctx.config,
                                     _ctx.device, group, kv_client=kv,
                                     timeline=_ctx.timeline,
                                     stall_inspector=_ctx.stall_inspector)
    cfg = _ctx.config
    if cfg.autotune:
        from ..utils.autotune import Autotuner

        _ctx.autotuner = Autotuner(
            _ctx.runtime, log_path=cfg.autotune_log,
            warmup_samples=cfg.autotune_warmup_samples,
            max_samples=cfg.autotune_max_samples, config=cfg)
        _ctx.runtime.autotuner = _ctx.autotuner
        # a latched drift on a goodput series restarts its search
        from ..utils import health

        health.init_engine(rank=_ctx.rank, autotuner=_ctx.autotuner,
                           on=cfg.health_enabled)
    _ctx.runtime.start()
    from ..utils import flightrec

    flightrec.note("init_phase", phase="runtime_started")


def _start_metrics_dumper():
    """The metrics publisher, when there is somewhere to publish: a
    ``HOROVOD_METRICS_FILE`` (suffixed ``.rank{k}`` off rank 0, so ranks on
    one host do not share a file) or the launcher's KV store, whose
    endpoints merge what every rank pushes. With neither, no thread."""
    from ..utils import metrics

    cfg = _ctx.config
    path = cfg.metrics_file
    if path and _ctx.rank != 0:
        path = f"{path}.rank{_ctx.rank}"
    kv = _launcher_kv() if cfg.metrics_push else None
    if not path and kv is None:
        return
    _ctx.metrics_dumper = metrics.MetricsDumper(
        metrics.get_registry(), file_path=path,
        interval_s=cfg.metrics_dump_interval_s, kv_client=kv,
        rank=_ctx.rank)
    _ctx.metrics_dumper.start()


def shutdown(drain: bool = True):
    """Stop the runtime (its pending handles fail) and tear the process
    group down; a second call is a no-op. ``drain=False`` skips the
    shutdown barrier with the other ranks (an elastic reset, where a peer
    may be gone). The device is synchronized before the communicators go,
    so no NCCL call of this process is in flight when they are
    destroyed."""
    with _ctx.lock:
        if not _ctx.initialized:
            return
        if _ctx.runtime is not None:
            _ctx.runtime.stop(drain=drain)
            _ctx.runtime = None
        if _ctx.timeline is not None:
            _ctx.timeline.close()
            _ctx.timeline = None
        if _ctx.metrics_dumper is not None:
            # the final flush: the file and the pushes hold everything the
            # stopped runtime counted
            _ctx.metrics_dumper.stop()
            _ctx.metrics_dumper = None
        from ..utils import diag, health

        # after the dumper's last pass, so the file holds its window; the
        # engine and the ledgers live as long as the process, the watchdog
        # and the diagnostics' KV client do not
        health.dump_on_exit(_ctx.config.health_file)
        diag.reset_watchdog()
        diag.set_kv_client(None)
        _ctx.stall_inspector = None
        _ctx.autotuner = None
        if _ctx.device is not None and _ctx.device.type == "cuda":
            torch.cuda.synchronize(_ctx.device)
        from ..ops import megaplan as megaplan_mod

        megaplan_mod.reset_manager()
        if _ctx.kv_server is not None:
            _ctx.kv_server.stop()
            _ctx.kv_server = None
        dist.destroy_process_group()  # every set's groups with the world's
        _ctx.initialized = False
        _ctx.global_set = None
        _ctx.process_sets = {}
        _ctx.device = None


def is_initialized() -> bool:
    return _ctx.initialized


def start_timeline(filename: str, mark_cycles: bool = False):
    """Open the timeline at run time (reference operations.cc:738-764);
    every rank that calls it writes ``filename``."""
    _require_init().timeline.reopen(filename, mark_cycles=mark_cycles)


def stop_timeline():
    """Close the timeline's file, which then parses as JSON."""
    _require_init().timeline.reopen("", mark_cycles=False)


def _require_init() -> _Context:
    if not _ctx.initialized:
        raise ValueError(
            "horovod_tpu_torch has not been initialized; call hvd.init()")
    return _ctx


def global_process_set() -> ProcessSet:
    return _require_init().global_set


def _new_group(ranks: list):
    """A group over ``ranks``, its NCCL communicator bound to
    ``device()``. Collective over the world: every rank calls it."""
    kw = {"device_id": _ctx.device} if _ctx.device.type == "cuda" else {}
    return dist.new_group(ranks, **kw)


def add_process_set(ranks: Sequence[int],
                    name: Optional[str] = None) -> ProcessSet:
    """A process set over the global ``ranks`` (reference
    ``hvd.add_process_set``), keyed by ``name`` (by default
    ``set_<ranks>``, as in the JAX package); a name already present
    returns its set unchanged. Collective over the world: every rank,
    members and non-members, calls it with the same arguments and in the
    same order, because each set's groups are made by
    ``torch.distributed.new_group``."""
    ctx = _require_init()
    ranks = sorted({int(r) for r in ranks})
    if not ranks or ranks[0] < 0 or ranks[-1] >= ctx.size:
        raise ValueError(f"process set ranks {ranks} must be a non-empty "
                         f"subset of 0..{ctx.size - 1}")
    name = name or f"set_{','.join(map(str, ranks))}"
    with ctx.lock:
        if name in ctx.process_sets:
            return ctx.process_sets[name]
        ps = ProcessSet(name, ranks, _new_group(ranks), _new_group(ranks))
        ctx.process_sets[name] = ps
        return ps


def remove_process_set(process_set) -> None:
    """Forget a process set, given by name or by the set itself; the
    global set cannot be removed. Called by every rank, like
    ``add_process_set``. The set's groups live until ``shutdown``; its
    cached fused plans are dropped, so a set later added under the same
    name never runs on the old groups."""
    from ..ops.collectives import invalidate_fused_plans

    ctx = _require_init()
    name = getattr(process_set, "name", process_set)
    if name == "global":
        raise ValueError("cannot remove the global process set")
    with ctx.lock:
        if ctx.process_sets.pop(name, None) is not None:
            invalidate_fused_plans()


def process_set_by_name(name: str) -> Optional[ProcessSet]:
    return _require_init().process_sets.get(name)


def is_runtime_group(group) -> bool:
    """Whether ``group`` is a process set's ``runtime_group``: the
    background runtime's communicator, which only its cycle thread may
    use."""
    return group is not None and any(
        ps.runtime_group is group for ps in _ctx.process_sets.values())


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
