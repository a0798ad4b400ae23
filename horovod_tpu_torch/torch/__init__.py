"""The Horovod PyTorch front end of the port — counterpart of
``horovod_tpu/torch/__init__.py``, re-exported from the package top level.

    import horovod_tpu_torch as hvd
    hvd.init()
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    optimizer = hvd.DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters())

Every collective is a named ``TensorEntry`` enqueued on the background
runtime (``ops/queue.py``), as ``horovod_tpu/__init__.py`` :226-330 does:
the runtime negotiates the names across ranks, fuses allreduces into
chunks and runs them on its cycle thread, so the ranks need not issue
their collectives in one order. A handle is an ``int``; ``synchronize``
returns the result, ready on the caller's current stream. Tensors stay on
their device: nothing goes through numpy (unlike the JAX shim's
``_to_np``). ``DistributedOptimizer``'s gradient hooks enqueue
``allreduce.<param name>``; a sparse gradient goes through
``sparse_allreduce_async`` (its indices and values allgathered).

Every op takes ``process_set=`` (``add_process_set``, which every rank
calls, members or not). ``Compression.int8``/``int4`` are markers: the
allreduces and ``DistributedOptimizer`` carry them to the runtime as the
entry's wire (``quant``), and their ``compress``/``decompress`` are the
identity; a tensor that autograd tracks keeps the plain wire.

``DistributedOptimizer(..., sharded_update=True)`` (or
``HOROVOD_SHARDED_UPDATE=1`` when ``sharded_update=None``) is ZeRO-1 with
whole-leaf owners, as the JAX package's torch shim does it
(``_ShardedMixin``): each leaf of at least ``min_shard_elems`` elements
(``HOROVOD_SHARDED_MIN_ELEMS``) is stepped by one owning rank and
broadcast from it, so each rank holds optimizer state for its own leaves
and the small ones. The slice-level engine is ``opt.ShardedUpdateEngine``.

``op=Adasum`` reduces through K4 (``ops/adasum.py``); at more than one
rank ``DistributedOptimizer(op=Adasum)`` is the delta optimizer
(``_AdasumMixin``), at one rank the regular wrapper, whose Adasum of one
contribution is the identity. ``SyncBatchNorm`` (``torch/sync_batch_norm.py``)
averages batch statistics over the ranks.

Elastic training (``hvd.elastic``, ``elastic/``): ``hvd.elastic.run``
around a training function, ``TorchState`` (below) for the model, the
optimizer, an ``ElasticSampler`` (``torch/elastic_sampler.py``) and
picklable counters.
"""
from __future__ import annotations

import contextlib
import copy
import itertools
import logging
import weakref

import torch

from ..common.context import (  # noqa: F401  (topology + lifecycle)
    ProcessSet,
    add_process_set,
    cross_rank,
    cross_size,
    device,
    global_process_set,
    init,
    is_initialized,
    local_rank,
    local_size,
    rank,
    remove_process_set,
    shutdown,
    size,
    start_timeline,
    stop_timeline,
)
from ..common.context import runtime as _runtime
from ..common import env as _env
from ..common.exceptions import HorovodInternalError  # noqa: F401
from ..ops import collectives as _coll
from ..ops import compression as _comp
from ..ops.queue import TensorEntry
from ..opt.sharded import _resolve_min_shard_elems, sharded_update_enabled
from ..parallel.sharding_policy import assign_owners
from ..utils import memledger as _memledger
from ..utils import metrics as _metrics
from ..ops.collectives import (  # noqa: F401
    Adasum,
    Average,
    Max,
    Min,
    Product,
    ReduceOp,
    Sum,
)

LOG = logging.getLogger("horovod_tpu_torch")


class Compression:
    """fp16-on-the-wire compression (reference torch/compression.py)."""

    class none:
        @staticmethod
        def compress(t):
            return t, None

        @staticmethod
        def decompress(t, ctx):
            return t

    class fp16:
        @staticmethod
        def compress(t):
            if t.dtype in (torch.float32, torch.float64):
                return t.half(), t.dtype
            return t, None

        @staticmethod
        def decompress(t, ctx):
            return t.to(ctx) if ctx is not None else t

    # the blockwise wire's markers (ops/compression.py)
    int8 = _comp.Compression.int8
    int4 = _comp.Compression.int4


def _quant_of(compression):
    """The wire a marker asks for, or None. An async op cannot carry a
    cast compressor's decompress context, so it refuses one."""
    if compression in (None, Compression.none, _comp.NoneCompressor):
        return None
    spec = getattr(compression, "quant_spec", None)
    if spec is None:
        raise ValueError(
            "allreduce_async supports Compression.none/int8/int4; use "
            "hvd.allreduce(...) for fp16/bf16 cast compression")
    return spec


# handle -> (tensor the caller passed, its contiguous stand-in): an
# in-place op on a non-contiguous tensor runs on a contiguous copy, which
# synchronize writes back
_write_back: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
_group_counter = itertools.count()


def _default_name(prefix: str) -> str:
    return f"{prefix}.noname.{_runtime().handles._next}"


def _enqueue_all(op: str, tensors, names, inplace: bool, **kw) -> list:
    """Enqueue one entry per tensor at once: one cycle drains them all."""
    rt = _runtime()
    entries, targets = [], []
    for tensor, name in zip(tensors, names):
        t = tensor.detach()
        work = t if t.is_contiguous() else t.contiguous()
        # allreduce and broadcast write a result of the input's shape into
        # ``out``; the other ops allocate their own
        if inplace:
            out = work
        elif op in ("allreduce", "broadcast"):
            out = torch.empty_like(work)
        else:
            out = None
        entries.append(TensorEntry(name=name or _default_name(op), op=op,
                                   tensor=work, output=out, **kw))
        targets.append(t if inplace and work is not t else None)
    hs = rt.enqueue_group(entries)
    for h, e, t in zip(hs, entries, targets):
        if t is not None:
            _write_back[h] = (t, e.tensor)
    return hs


def _enqueue(op: str, tensor, name, inplace: bool, **kw) -> int:
    return _enqueue_all(op, [tensor], [name], inplace, **kw)[0]


def _allreduce_kw(tensors, average, op, prescale_factor, postscale_factor,
                  process_set) -> dict:
    op = _coll._resolve_op(op, average)
    for t in tensors:
        _coll._check_average_dtype(t, op)
    return dict(reduce_op=op, prescale_factor=float(prescale_factor),
                postscale_factor=float(postscale_factor),
                process_set=process_set)


def allreduce_async(tensor, average=None, name=None, op=None,
                    prescale_factor=1.0, postscale_factor=1.0,
                    process_set=None, compression=None) -> int:
    return _enqueue("allreduce", tensor, name, False, quant=_quant_of(
        compression), **_allreduce_kw([tensor], average, op, prescale_factor,
                                      postscale_factor, process_set))


def allreduce_async_(tensor, average=None, name=None, op=None,
                     prescale_factor=1.0, postscale_factor=1.0,
                     process_set=None, compression=None) -> int:
    """In place: the result lands in ``tensor`` (in its dtype)."""
    return _enqueue("allreduce", tensor, name, True, quant=_quant_of(
        compression), **_allreduce_kw([tensor], average, op, prescale_factor,
                                      postscale_factor, process_set))


def _group_base(name):
    # unique per unnamed call: two pending unnamed groups must not collide
    # on the in-flight name guard
    return name or f"grouped_allreduce.noname.{next(_group_counter)}"


def grouped_allreduce_async(tensors, average=None, name=None, op=None,
                            prescale_factor=1.0, postscale_factor=1.0,
                            process_set=None, compression=None) -> list:
    """One logical op over a list, named ``<name>.<i>``, enqueued at once:
    one cycle drains the whole group and fuses it (reference
    torch/mpi_ops.py:345)."""
    base = _group_base(name)
    return _enqueue_all("allreduce", tensors,
                        [f"{base}.{i}" for i in range(len(tensors))], False,
                        quant=_quant_of(compression),
                        **_allreduce_kw(tensors, average, op,
                                        prescale_factor, postscale_factor,
                                        process_set))


def grouped_allreduce_async_(tensors, average=None, name=None, op=None,
                             prescale_factor=1.0, postscale_factor=1.0,
                             process_set=None, compression=None) -> list:
    base = _group_base(name)
    return _enqueue_all("allreduce", tensors,
                        [f"{base}.{i}" for i in range(len(tensors))], True,
                        quant=_quant_of(compression),
                        **_allreduce_kw(tensors, average, op,
                                        prescale_factor, postscale_factor,
                                        process_set))


def _check_root(root_rank, process_set):
    ps = process_set or global_process_set()
    if not 0 <= int(root_rank) < ps.size:
        # synchronous, like the reference's rank check
        raise ValueError(f"root_rank {root_rank} out of range for process "
                         f"set of size {ps.size}")


def broadcast_async(tensor, root_rank, name=None, process_set=None) -> int:
    _check_root(root_rank, process_set)
    return _enqueue("broadcast", tensor, name, False,
                    root_rank=int(root_rank), process_set=process_set)


def broadcast_async_(tensor, root_rank, name=None, process_set=None) -> int:
    _check_root(root_rank, process_set)
    return _enqueue("broadcast", tensor, name, True,
                    root_rank=int(root_rank), process_set=process_set)


def allgather_async(tensor, name=None, process_set=None) -> int:
    """Gather ``tensor`` from every rank of the set along the first
    dimension, which may differ across ranks."""
    return _enqueue("allgather", tensor, name, False,
                    process_set=process_set)


def alltoall_async(tensor, splits=None, name=None, process_set=None) -> int:
    """Send ``splits[j]`` rows to rank j of the set (an even split when
    None); ``synchronize`` returns (output, received splits)."""
    if splits is not None:
        splits = torch.as_tensor(splits).detach().to("cpu", torch.int64)
    return _enqueue("alltoall", tensor, name, False, splits=splits,
                    process_set=process_set)


def reducescatter_async(tensor, name=None, op=None,
                        process_set=None) -> int:
    """Reduce across the set (SUM by default) and keep this rank's equal
    share of the first dimension, which must divide by the set's size."""
    nproc = (process_set or global_process_set()).size
    if tensor.dim() == 0 or tensor.shape[0] % nproc:
        # synchronous: the local shape and the set's size decide it
        raise ValueError("first dim must be divisible by the number of "
                         f"processes ({tuple(tensor.shape)} over {nproc})")
    op = ReduceOp(op) if op is not None else Sum
    _coll._check_average_dtype(tensor, op)
    return _enqueue("reducescatter", tensor, name, False, reduce_op=op,
                    process_set=process_set)


def megaplan_report() -> dict:
    """This rank's whole-step replay (``ops/megaplan.py``): ``{"enabled":
    False}`` without ``HOROVOD_MEGAPLAN``, else the captures, replays,
    misses, invalidations, hit rate and the live plan's shape."""
    from ..ops import megaplan as _megaplan

    return _megaplan.report()


def metrics_snapshot() -> dict:
    """The process's metrics registry as a JSON-able dict (what ``GET
    /metrics`` renders); valid before ``init`` and after ``shutdown``."""
    return _metrics.get_registry().snapshot()


def trace_report() -> dict:
    """This rank's spans (``utils/tracing.py``): phase latencies, span and
    error counts, open spans and the coordinator's straggler verdicts;
    ``{"enabled": False}`` without ``HOROVOD_TRACE``. ``GET /timeline`` on
    the launcher merges every rank's."""
    from ..utils import tracing as _tracing

    return _tracing.report()


def perf_report() -> dict:
    """This rank's perf ledger (``utils/perfledger.py``): goodput stats,
    the five-phase split of each working cycle and the SLO budgets'
    states; ``{"enabled": False}`` without ``HOROVOD_PERFLEDGER``."""
    from ..utils import perfledger as _perfledger

    return _perfledger.report()


def anatomy_report() -> dict:
    """This rank's step anatomy (``utils/anatomy.py``): the entity table,
    the critical path and the overlap and replay headroom;
    ``{"enabled": False}`` without ``HOROVOD_ANATOMY``."""
    from ..utils import anatomy as _anatomy

    return _anatomy.report()


def memory_report() -> dict:
    """This rank's memory ledger (``utils/memledger.py``): live and peak
    device bytes, the components (plan cache, fusion buffer, residuals,
    sharded state) and the dominant one, the newest samples, and the
    kernel-library loads and plan builds; ``{"enabled": False}`` without
    ``HOROVOD_MEMLEDGER``. ``GET /memory`` on the launcher merges every
    rank's."""
    return _memledger.report()


def checkpoint_report() -> dict:
    """This rank's async checkpointer (``utils/async_ckpt.py``);
    ``{"enabled": False}`` without ``HOROVOD_ASYNC_CKPT``. ``GET
    /checkpoint`` on the launcher merges every rank's."""
    from ..utils import async_ckpt as _async_ckpt

    return _async_ckpt.report()


def health_report() -> dict:
    """This rank's health engine (``utils/health.py``): the verdict
    (healthy, degraded, critical), the latched anomalies, the baselines,
    each series' newest value and the suspect rank; ``{"enabled":
    False}`` without ``HOROVOD_HEALTH``. ``GET /history`` and ``GET
    /health`` on the launcher merge every rank's."""
    from ..utils import health as _health

    return _health.report()


def diagnose() -> dict:
    """This rank's diagnostic bundle now (``utils/diag.py``): every
    thread's stack, the lock auditor, a metrics snapshot, open spans, the
    flight recorder's last events, the probes and the memory section;
    callable with or without ``init``."""
    from ..utils import diag as _diag

    return _diag.build_bundle("diagnose")


def maybe_dump_alloc_failure(exc) -> str:
    """Write an ``oom`` bundle when ``exc`` is an allocation failure
    (``torch.OutOfMemoryError``, ``MemoryError`` or the allocator's
    text); returns its path, "" otherwise (``utils/diag.py``)."""
    from ..utils import diag as _diag

    return _diag.maybe_dump_alloc_failure(exc)


def poll(handle: int) -> bool:
    return _runtime().handles.poll(handle)


def synchronize(handle: int):
    try:
        result = _runtime().handles.wait(handle)
    finally:
        target = _write_back.pop(handle, None)
    if target is not None:
        target[0].copy_(result)
        return target[0]
    return result


# --- differentiable sync ops ------------------------------------------------
# allreduce backpropagates an allreduce of the cotangent with the same op;
# broadcast backpropagates the averaged cotangent to the root, zeros
# elsewhere (the JAX package's torch shim, :302-404).

def _grad_wanted(tensor) -> bool:
    return torch.is_grad_enabled() and tensor.requires_grad


class _AllreduceOp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, average, name, op, prescale, postscale, ps):
        ctx.meta = (average, name, op, prescale, postscale, ps)
        return synchronize(allreduce_async(tensor, average, name, op,
                                           prescale, postscale, ps))

    @staticmethod
    def backward(ctx, dy):
        average, name, op, prescale, postscale, ps = ctx.meta
        red = allreduce(dy, average=average,
                        name=f"{name}.grad" if name else None, op=op,
                        prescale_factor=prescale, postscale_factor=postscale,
                        process_set=ps)
        return red, None, None, None, None, None, None


class _GroupedAllreduceOp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, average, name, op, prescale, postscale, ps, *tensors):
        ctx.meta = (average, name, op, prescale, postscale, ps)
        hs = grouped_allreduce_async(list(tensors), average, name, op,
                                     prescale, postscale, ps)
        return tuple(synchronize(h) for h in hs)

    @staticmethod
    def backward(ctx, *dys):
        average, name, op, prescale, postscale, ps = ctx.meta
        red = grouped_allreduce(
            [d.contiguous() for d in dys], average=average,
            name=f"{name}.grad" if name else None, op=op,
            prescale_factor=prescale, postscale_factor=postscale,
            process_set=ps)
        return (None,) * 6 + tuple(red)


class _AllgatherOp(torch.autograd.Function):
    """The gradient of an allgather is the AVERAGE allreduce of ``dy``,
    then this rank's rows, found by one exchange of row counts."""

    @staticmethod
    def forward(ctx, tensor, name, ps):
        ctx.meta = (name, ps, int(tensor.shape[0]) if tensor.dim() else 0)
        return synchronize(allgather_async(tensor, name, ps))

    @staticmethod
    def backward(ctx, dy):
        name, ps, rows = ctx.meta
        red = allreduce(dy, average=True,
                        name=f"{name}.grad" if name else None,
                        process_set=ps)
        sizes = synchronize(allgather_async(
            torch.tensor([rows], device=dy.device),
            f"{name or 'allgather'}.grad.sizes", ps))
        pset = ps or global_process_set()
        start = int(sizes[:pset.rank].sum())
        return red[start:start + rows], None, None


class _AlltoallOp(torch.autograd.Function):
    """The gradient of an alltoall is the alltoall of ``dy`` back, with the
    received splits as its splits."""

    @staticmethod
    def forward(ctx, tensor, splits, name, ps):
        out, recv = synchronize(alltoall_async(tensor, splits, name, ps))
        ctx.meta = (name, ps)
        ctx.recv = recv
        ctx.mark_non_differentiable(recv)
        return out, recv

    @staticmethod
    def backward(ctx, dy, _drecv=None):
        name, ps = ctx.meta
        back, _ = alltoall(dy.contiguous(), splits=ctx.recv,
                           name=f"{name}.grad" if name else None,
                           process_set=ps)
        return back, None, None, None


class _BroadcastOp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, root_rank, name, ps):
        ctx.meta = (root_rank, name, ps)
        return synchronize(broadcast_async(tensor, root_rank, name, ps))

    @staticmethod
    def backward(ctx, dy):
        root_rank, name, ps = ctx.meta
        red = allreduce(dy, average=True,
                        name=f"{name}.grad" if name else None,
                        process_set=ps)
        pset = ps or global_process_set()
        return (red if pset.rank == root_rank else red * 0), None, None, None


# --- sync wrappers ----------------------------------------------------------

def _marker(compression):
    """``compression`` when it is a wire marker (int8/int4), else None:
    a cast compressor has already compressed the tensor around the
    collective."""
    return (compression if getattr(compression, "quant_spec", None)
            is not None else None)


def allreduce(tensor, average=None, name=None, op=None,
              compression=Compression.none,
              prescale_factor=1.0, postscale_factor=1.0, process_set=None):
    t, ctx = compression.compress(tensor)
    if _grad_wanted(t):
        # the backward collective has no marker to match: the plain wire
        out = _AllreduceOp.apply(t, average, name, op, prescale_factor,
                                 postscale_factor, process_set)
    else:
        out = synchronize(allreduce_async(t, average, name, op,
                                          prescale_factor, postscale_factor,
                                          process_set, _marker(compression)))
    return compression.decompress(out, ctx)


def allreduce_(tensor, average=None, name=None, op=None,
               prescale_factor=1.0, postscale_factor=1.0, process_set=None,
               compression=None):
    return synchronize(allreduce_async_(tensor, average, name, op,
                                        prescale_factor, postscale_factor,
                                        process_set, compression))


def grouped_allreduce(tensors, average=None, name=None, op=None,
                      compression=Compression.none,
                      prescale_factor=1.0, postscale_factor=1.0,
                      process_set=None):
    comp = [compression.compress(t) for t in tensors]
    if any(_grad_wanted(c[0]) for c in comp):
        outs = _GroupedAllreduceOp.apply(
            average, name, op, prescale_factor, postscale_factor,
            process_set, *[c[0] for c in comp])
    else:
        hs = grouped_allreduce_async([c[0] for c in comp], average, name, op,
                                     prescale_factor, postscale_factor,
                                     process_set, _marker(compression))
        outs = [synchronize(h) for h in hs]
    return [compression.decompress(o, c[1]) for o, c in zip(outs, comp)]


def grouped_allreduce_(tensors, average=None, name=None, op=None,
                       prescale_factor=1.0, postscale_factor=1.0,
                       process_set=None, compression=None):
    hs = grouped_allreduce_async_(tensors, average, name, op,
                                  prescale_factor, postscale_factor,
                                  process_set, compression)
    return [synchronize(h) for h in hs]


def broadcast(tensor, root_rank, name=None, process_set=None):
    if _grad_wanted(tensor):
        return _BroadcastOp.apply(tensor, root_rank, name, process_set)
    return synchronize(broadcast_async(tensor, root_rank, name, process_set))


def allgather(tensor, name=None, process_set=None):
    if _grad_wanted(tensor):
        return _AllgatherOp.apply(tensor, name, process_set)
    return synchronize(allgather_async(tensor, name, process_set))


def alltoall(tensor, splits=None, name=None, process_set=None):
    """Returns (output, received splits)."""
    if _grad_wanted(tensor):
        return _AlltoallOp.apply(tensor, splits, name, process_set)
    return synchronize(alltoall_async(tensor, splits, name, process_set))


def reducescatter(tensor, name=None, op=None, process_set=None):
    return synchronize(reducescatter_async(tensor, name, op, process_set))


def sparse_allreduce_async(tensor, name, op=Average, prescale_factor=1.0,
                           postscale_factor=1.0, process_set=None):
    """Reduce a sparse COO tensor (reference torch/mpi_ops.py:512): its
    indices and values go through two allgathers, and the sum is the
    ``coalesce`` of what every rank sent. The factors scale the values;
    AVERAGE divides by the set's size, the number of contributors.
    Returns a function that completes the op and returns the result."""
    t = tensor.coalesce()
    values = t.values()
    if prescale_factor != 1.0:
        values = values * prescale_factor
    hi = allgather_async(t.indices().t().contiguous(), f"{name}.indices",
                         process_set=process_set)
    hv = allgather_async(values.contiguous(), f"{name}.values",
                         process_set=process_set)

    def finish():
        indices = synchronize(hi).t()
        values = synchronize(hv)
        if postscale_factor != 1.0:
            values = values * postscale_factor
        if op == Average:
            values = values / (process_set or global_process_set()).size
        return torch.sparse_coo_tensor(indices, values, t.shape).coalesce()

    return finish


def join(timeout=None) -> int:
    """Mark this rank out of data (reference ``hvd.join()``): until every
    rank has joined it contributes zeros to the others' collectives (no
    rows to an allgather or alltoall). Returns the last rank to join.
    Without a negotiating runtime (a world of one) it is a MAX allreduce
    of the ranks, which every rank must reach."""
    rt = _runtime()
    if rt.controller is not None:
        return rt.join(timeout)
    if size() > 1:
        LOG.warning(
            "join() without a rendezvous controller degenerates to a "
            "barrier: all ranks must call join(), and no zero "
            "contributions are fed to other ranks' collectives.")
    last = allreduce(torch.tensor([rank()], dtype=torch.int32,
                                  device=device()),
                     name="join.barrier", op=Max)
    return int(last[0])


def barrier(process_set=None):
    _coll.barrier(process_set)


def allgather_object(obj, name=None, process_set=None) -> list:
    """Every rank's ``obj``, in rank order (pickled)."""
    return _coll.allgather_object(obj, process_set)


# --- parameter/optimizer broadcast (reference torch/functions.py) -----------

def broadcast_parameters(params, root_rank: int = 0):
    """Broadcast a state_dict or an iterable of (name, tensor) in place,
    in name order (reference functions.py:29)."""
    items = sorted(params.items()) if isinstance(params, dict) \
        else sorted(dict(params).items())
    handles = [broadcast_async_(p.data, root_rank, f"bcast.{name}")
               for name, p in items if isinstance(p, torch.Tensor)]
    for h in handles:
        synchronize(h)


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def broadcast_optimizer_state(optimizer, root_rank: int = 0):
    """Broadcast the full optimizer state from the root (reference
    functions.py:61). The state travels pickled on the CPU;
    ``load_state_dict`` moves it onto each parameter's device."""
    state = broadcast_object(_to_cpu(optimizer.state_dict()), root_rank)
    optimizer.load_state_dict(state)


def broadcast_object(obj, root_rank: int = 0, name=None):
    return _coll.broadcast_object(obj, root_rank)


# --- DistributedOptimizer (reference torch/optimizer.py) --------------------

class _DistributedMixin:
    """Methods grafted onto the wrapped optimizer's own class: per-parameter
    post-accumulate hooks launch async in-place allreduces, step()
    synchronizes (reference optimizer.py:35, hooks :219-247, synchronize
    :249-286). Swapping ``__class__`` in place keeps isinstance checks (LR
    schedulers, GradScaler) working and preserves optimizer state."""

    def _hvd_setup(self, named_parameters, compression, op,
                   backward_passes_per_step, prescale_factor,
                   postscale_factor, gradient_predivide_factor=1.0,
                   sparse_as_dense=False, process_set=None):
        self._process_set = process_set
        if gradient_predivide_factor != 1.0:
            if op != Average:
                # predivide splits an Average into Sum with pre/postscale —
                # meaningless for other ops
                raise ValueError(
                    "gradient_predivide_factor requires op=Average")
            op = Sum
            prescale_factor = prescale_factor / gradient_predivide_factor
            n = (process_set or global_process_set()).size
            postscale_factor = (postscale_factor * gradient_predivide_factor
                                / max(n, 1))
        self._compression = compression
        self._op = op
        self._bpps = backward_passes_per_step
        self._prescale = prescale_factor
        self._postscale = postscale_factor
        self._sparse_as_dense = sparse_as_dense
        self._handles: dict[torch.Tensor, tuple[int, object]] = {}
        self._sparse_thunks: dict[torch.Tensor, object] = {}
        self._passes: dict[torch.Tensor, int] = {}
        self._should_sync = True
        self._hook_handles = []
        self._names = _build_param_names(self, named_parameters, "allreduce")
        hook = _weak_hook(self)
        for p in self._names:
            if p.requires_grad:
                self._passes[p] = 0
                self._hook_handles.append(
                    p.register_post_accumulate_grad_hook(hook))
        # the hooks go with the optimizer: a model kept for a new one
        # reduces once a step
        weakref.finalize(self, _remove_hooks, self._hook_handles)

    # fired when a parameter's gradient is fully accumulated; with
    # backward_passes_per_step > 1 the accumulated sum is reduced unscaled
    def _hook(self, p):
        self._passes[p] += 1
        if self._passes[p] < self._bpps:
            return
        self._passes[p] = 0
        self._launch_reduce(p, p.grad)

    def _launch_reduce(self, p, grad):
        if grad.is_sparse:
            if not self._sparse_as_dense:
                # indices and values through allgathers, completed in
                # synchronize(); the dense path's factors scale the values
                self._sparse_thunks[p] = sparse_allreduce_async(
                    grad, name=self._names[p], op=self._op,
                    prescale_factor=self._prescale,
                    postscale_factor=self._postscale,
                    process_set=self._process_set)
                return
            grad = grad.to_dense()
        comp, ctx = self._compression.compress(grad)
        h = allreduce_async_(comp, name=self._names[p], op=self._op,
                             prescale_factor=self._prescale,
                             postscale_factor=self._postscale,
                             process_set=self._process_set,
                             compression=_marker(self._compression))
        self._handles[p] = (h, ctx)

    def synchronize(self):
        # every tracked param without a pending handle is reduced now —
        # hooks that never fired (unused params) contribute zeros, so all
        # ranks issue the same collectives — and pass counters reset
        for p in self._names:
            if (not p.requires_grad or p in self._handles
                    or p in self._sparse_thunks):
                continue
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            self._launch_reduce(p, p.grad)
        for p in self._passes:
            self._passes[p] = 0
        for p, (h, ctx) in list(self._handles.items()):
            reduced = synchronize(h)
            p.grad = self._compression.decompress(
                reduced, ctx).reshape(p.shape).to(p.grad.dtype)
        self._handles.clear()
        for p, finish in list(self._sparse_thunks.items()):
            p.grad = finish().to(p.grad.dtype)
        self._sparse_thunks.clear()

    def set_backward_passes_per_step(self, passes: int):
        """Change the local gradient-accumulation window; resets pass
        counters."""
        self._bpps = int(passes)
        for p in self._passes:
            self._passes[p] = 0

    @contextlib.contextmanager
    def skip_synchronize(self):
        """Suppress the implicit synchronize in the next step() (used with
        gradient clipping after a manual synchronize())."""
        self._should_sync = False
        try:
            yield
        finally:
            self._should_sync = True

    def step(self, closure=None):
        if self._should_sync:
            self.synchronize()
        return self._hvd_base.step(self, closure)


def _weak_hook(optimizer):
    """The post-accumulate hook of ``optimizer``, holding it weakly. A
    parameter keeps its hooks in a table the garbage collector cannot see
    through, so a bound method there would keep the optimizer, its state,
    the parameters and their gradients alive after the caller drops them
    (the model's whole footprint a wrapped optimizer, for good)."""
    ref = weakref.ref(optimizer)

    def hook(p):
        opt = ref()
        if opt is not None:
            opt._hook(p)

    return hook


def _remove_hooks(handles):
    for h in handles:
        h.remove()


def _build_param_names(optimizer, named_parameters, noname_prefix):
    """Duplicate names would mis-pair collectives across ranks; uncovered
    params would silently never reduce."""
    if named_parameters is not None:
        seen, dups = set(), set()
        for n, _ in named_parameters:
            if n in seen:
                dups.add(n)
            seen.add(n)
        if dups:
            raise ValueError(
                "named_parameters contains duplicate names: "
                f"{sorted(dups)}")
        names = {p: n for n, p in named_parameters}
        all_params = {p for g in optimizer.param_groups for p in g["params"]}
        missing = all_params - names.keys()
        if missing:
            raise ValueError(
                "named_parameters does not cover all optimizer "
                f"parameters ({len(missing)} uncovered)")
        return names
    names = {}
    for gi, group in enumerate(optimizer.param_groups):
        for pi, p in enumerate(group["params"]):
            names[p] = f"{noname_prefix}.noname.{gi}.{pi}"
    return names


class _ShardedMixin:
    """ZeRO-1 for the torch front end, overlaid on ``_DistributedMixin``
    (the JAX package's torch shim, ``horovod_tpu/torch/__init__.py``
    :721-832): gradients hook-allreduce exactly as in the plain wrapper,
    but each parameter's optimizer step runs on one owning rank, which
    then broadcasts the updated parameter. A torch optimizer cannot slice
    one tensor's step across ranks, so ownership is whole-leaf
    (``parallel/sharding_policy.assign_owners``: largest first to the
    least-loaded rank; leaves under the replicate threshold step on every
    rank, with no broadcast). torch makes a parameter's state at its first
    step, so a rank only ever holds state for the parameters it owns and
    the replicated ones: about 1/n of the optimizer state, with no surgery
    on the state dict.

    Caveats (``docs/sharded_optimizer.md``, "torch mode"):
    ``state_dict()`` holds only this rank's share of the optimizer state,
    so gather before a checkpoint or save one per rank. After an elastic
    resize every rank rebuilds the same owner table from the new world,
    and a parameter that changed owner starts with fresh state (its
    momentum restarts). The owner broadcasts 1x the owned leaves' bytes
    on top of the gradients' allreduce."""

    def _hvd_sharded_setup(self, min_shard_elems):
        self._sharded_min_elems = _resolve_min_shard_elems(min_shard_elems)
        reg = _metrics.get_registry()
        wire = "hvd_sharded_update_wire_bytes_total"
        wire_help = ("sharded-update wire bytes by phase (ring accounting: "
                     "(N-1)/N of the buffer per RS or AG pass)")
        self._m_bcast = reg.counter(wire, wire_help, phase="broadcast")
        self._m_frac = reg.gauge(
            "hvd_sharded_update_shard_fraction",
            "fraction of elements on the sharded path (rest replicate)")
        self._sharded_gen = None
        self._hvd_build_owners()

    def _hvd_build_owners(self):
        ps = self._process_set or global_process_set()
        ws = max(ps.size, 1)
        # param_groups order is the leaf order, the same on every rank
        params = [p for g in self.param_groups for p in g["params"]]
        sizes = [p.numel() for p in params]
        owner_list = assign_owners(sizes, ws,
                                   min_shard_elems=self._sharded_min_elems)
        self._sharded_world = ws
        self._sharded_rank = ps.rank
        # one process a GPU: an owner is a rank of the set, the broadcast's
        # root as it is
        self._owners = dict(zip(params, owner_list))
        self._sharded_gen = _env.get_int(_env.HOROVOD_ELASTIC_GEN, 0)
        owned = sum(s for s, o in zip(sizes, owner_list) if o is not None)
        self._m_frac.set(owned / max(sum(sizes), 1))
        from ..utils import flightrec

        flightrec.note("reshard", generation=self._sharded_gen, world=ws,
                       rank=ps.rank, mode="torch-whole-leaf",
                       owned_leaves=sum(o is not None for o in owner_list),
                       replicated_leaves=sum(o is None for o in owner_list))

    def step(self, closure=None):
        if self._should_sync:
            self.synchronize()
        if self._sharded_gen != _env.get_int(_env.HOROVOD_ELASTIC_GEN, 0):
            # elastic resize: every rank rebuilds the same owner table
            # from the new world without communicating
            self._hvd_build_owners()
        stashed = []
        for group in self.param_groups:
            stashed.append(group["params"])
            group["params"] = [
                p for p in group["params"]
                if self._owners.get(p, None) in (None, self._sharded_rank)]
        try:
            loss = self._hvd_base.step(self, closure)
        finally:
            for params, group in zip(stashed, self.param_groups):
                group["params"] = params
        self._hvd_broadcast_owned()
        # this rank's state covers its owned and the replicated leaves
        _memledger.note_sharded_state(self)
        return loss

    def _hvd_broadcast_owned(self):
        if self._sharded_world <= 1:
            return
        handles = []
        nbytes = 0
        for p, owner in self._owners.items():
            if owner is None:
                continue
            handles.append(broadcast_async_(
                p.data, owner, f"sharded.{self._names[p]}",
                process_set=self._process_set))
            nbytes += p.numel() * p.element_size()
        for h in handles:
            synchronize(h)
        w = self._sharded_world
        self._m_bcast.inc(int(nbytes * (w - 1) / w))


class _AdasumMixin:
    """The delta optimizer of Adasum (the JAX package's torch shim,
    ``horovod_tpu/torch/__init__.py`` :833-927; reference
    torch/optimizer.py:329 ``_DistributedAdasumOptimizer``): each
    parameter's hook runs the wrapped optimizer's step for that parameter
    alone, turning the parameter into its delta ``p_after - p_before``;
    the deltas are combined across ranks by an Adasum allreduce and
    ``step()`` commits ``p = start + adasum(delta)``. A parameter whose hook
    did not fire in a step contributes its local step's delta, or a zero
    delta without a gradient, so every rank submits the same names. The
    hooks hold the optimizer weakly, as the regular wrapper's do."""

    def _hvd_adasum_setup(self, named_parameters, compression,
                          backward_passes_per_step, process_set=None):
        self._compression = compression
        self._process_set = process_set
        self._bpps = int(backward_passes_per_step)
        self._passes: dict[torch.Tensor, int] = {}
        self._handles: dict[torch.Tensor, tuple] = {}
        self._starts: dict[torch.Tensor, torch.Tensor] = {}
        self._hook_handles = []
        self._names = _build_param_names(self, named_parameters, "adasum")
        hook = _weak_hook(self)
        for p in self._names:
            if p.requires_grad:
                self._passes[p] = 0
                self._starts[p] = torch.zeros_like(p.data)
                self._hook_handles.append(
                    p.register_post_accumulate_grad_hook(hook))
        weakref.finalize(self, _remove_hooks, self._hook_handles)

    def _hook(self, p):
        self._passes[p] += 1
        if self._passes[p] < self._bpps:
            return
        self._passes[p] = 0
        self._hvd_local_step_delta(p)

    def _hvd_local_step_delta(self, p):
        """The wrapped optimizer's step on ``p`` alone, then ``p`` becomes
        its delta and its Adasum allreduce is enqueued (reference
        ``_allreduce_grad_async``, optimizer.py:397-439)."""
        start = self._starts[p]
        start.copy_(p.data)
        stashed = []
        for group in self.param_groups:
            stashed.append(group["params"])
            group["params"] = [p] if any(p is v for v in group["params"]) \
                else []
        try:
            self._hvd_base.step(self)
        finally:
            for params, group in zip(stashed, self.param_groups):
                group["params"] = params
        p.data.sub_(start)  # the delta: -lr * f(g)
        self._hvd_enqueue_delta(p)

    def _hvd_zero_delta(self, p):
        self._starts[p].copy_(p.data)
        p.data.zero_()
        self._hvd_enqueue_delta(p)

    def _hvd_enqueue_delta(self, p):
        comp, ctx = self._compression.compress(p.data)
        h = allreduce_async(comp, name=self._names[p], op=Adasum,
                            process_set=self._process_set)
        self._handles[p] = (h, ctx)

    def synchronize(self):
        """A separate synchronize means nothing to the delta optimizer:
        ``step()`` commits (reference optimizer.py:460)."""

    @contextlib.contextmanager
    def skip_synchronize(self):
        raise AssertionError(
            "Skipping synchronization is not supported when using Adasum "
            "optimizer.")

    def set_backward_passes_per_step(self, passes: int):
        self._bpps = int(passes)
        for p in self._passes:
            self._passes[p] = 0

    def step(self, closure=None):
        loss = closure() if closure is not None else None
        for p in self._names:
            if p.requires_grad and p not in self._handles:
                if p.grad is not None:
                    self._hvd_local_step_delta(p)
                else:
                    self._hvd_zero_delta(p)
        for p, (h, ctx) in list(self._handles.items()):
            reduced = synchronize(h)
            delta = self._compression.decompress(reduced, ctx) \
                .reshape(p.data.shape).to(p.data.dtype)
            p.data.copy_(self._starts[p] + delta)
        self._handles.clear()
        for p in self._passes:
            self._passes[p] = 0
        return loss


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters=None,
                         compression=Compression.none,
                         op=Average,
                         backward_passes_per_step: int = 1,
                         prescale_factor: float = 1.0,
                         postscale_factor: float = 1.0,
                         gradient_predivide_factor: float = 1.0,
                         sparse_as_dense: bool = False,
                         process_set=None,
                         sharded_update=None,
                         min_shard_elems=None):
    if hasattr(optimizer, "_hvd_base"):
        # re-wrapping would make the grafted step() re-enter itself and
        # register every hook twice
        raise ValueError(
            "optimizer is already wrapped by DistributedOptimizer")
    if sharded_update is None:
        sharded_update = sharded_update_enabled()
    base = optimizer.__class__
    # at one rank the regular wrapper, whose Adasum of one contribution is
    # the identity (the JAX shim's cross_size() > 1 counts processes, the
    # port's size() does)
    if op == Adasum and size() > 1:
        if sharded_update:
            # Adasum combines models (a local step a parameter, then the
            # deltas' reduction): there is no shared step to shard
            raise ValueError("sharded_update is not supported with op=Adasum")
        # reference optimizer.py:576: Adasum selects the delta optimizer
        if (gradient_predivide_factor != 1.0 or prescale_factor != 1.0
                or postscale_factor != 1.0 or sparse_as_dense):
            raise ValueError(
                "gradient_predivide_factor/prescale/postscale/"
                "sparse_as_dense are not supported with op=Adasum")
        body = {k: v for k, v in _AdasumMixin.__dict__.items()
                if not k.startswith("__")}
        body["_hvd_base"] = base
        optimizer.__class__ = type("DistributedAdasum" + base.__name__,
                                   (base,), body)
        optimizer._hvd_adasum_setup(
            list(named_parameters) if named_parameters is not None else None,
            compression, backward_passes_per_step, process_set)
        return optimizer
    body = {k: v for k, v in _DistributedMixin.__dict__.items()
            if not k.startswith("__")}
    prefix = "Distributed"
    if sharded_update:
        # overlay: the hooks and synchronize stay, step() becomes the
        # owners' step and their broadcast
        body.update({k: v for k, v in _ShardedMixin.__dict__.items()
                     if not k.startswith("__")})
        prefix = "ShardedDistributed"
    body["_hvd_base"] = base
    optimizer.__class__ = type(prefix + base.__name__, (base,), body)
    optimizer._hvd_setup(
        list(named_parameters) if named_parameters is not None else None,
        compression, op, backward_passes_per_step,
        prescale_factor, postscale_factor, gradient_predivide_factor,
        sparse_as_dense, process_set)
    if sharded_update:
        optimizer._hvd_sharded_setup(min_shard_elems)
    return optimizer


from .sync_batch_norm import SyncBatchNorm  # noqa: E402,F401


# --- elastic TorchState (reference torch/elastic/state.py) ------------------

from .. import elastic  # noqa: E402,F401  (hvd.elastic)
from ..elastic.state import ObjectState as _ObjectState  # noqa: E402
from .elastic_sampler import ElasticSampler  # noqa: E402,F401

# the store's key for the model's, the optimizer's and the sampler's state
_TORCH_STORE_KEY = "_torch_state"


class TorchState(_ObjectState):
    """Elastic state with a torch model, optimizer and sampler beside the
    keyword attributes (reference ``TorchState``, JAX
    ``horovod_tpu/torch/__init__.py:995-1073``).

    - ``save`` (a commit) snapshots the state dicts as ``clone()``s on the
      model's device and the sampler's progress;
    - ``restore`` loads them back, and drops the optimizer's handles of a
      step that failed;
    - ``sync`` broadcasts the parameters and buffers and the optimizer's
      state from rank 0, and merges every rank's processed indices into
      the sampler (no single rank knows the whole progress after a
      resize).

    One departure from the JAX package (ROADMAP.md queue 3): under
    ``HOROVOD_ELASTIC_STORE`` a commit also writes the model's and the
    optimizer's state dicts, as host tensors, with the keyword attributes,
    so a relaunched world resumes its weights as the JAX package's
    ``JaxState`` resumes its params; the JAX shim's ``TorchState`` comes
    back with fresh weights there. The lowest local rank of each host
    writes."""

    def __init__(self, model=None, optimizer=None, sampler=None, **kwargs):
        self._model = model
        self._optimizer = optimizer
        self._sampler = sampler
        self._model_saved = None
        self._opt_saved = None
        self._sampler_saved = None
        super().__init__(**kwargs)

    # a script may reassign these after a reset: the snapshots follow
    @property
    def model(self):
        return self._model

    @model.setter
    def model(self, m):
        self._model = m

    @property
    def optimizer(self):
        return self._optimizer

    @optimizer.setter
    def optimizer(self, o):
        self._optimizer = o

    @property
    def sampler(self):
        return self._sampler

    @sampler.setter
    def sampler(self, s):
        self._sampler = s

    def save(self):
        if self._model is not None:
            self._model_saved = {k: v.detach().clone()
                                 for k, v in self._model.state_dict().items()}
        if self._optimizer is not None:
            self._opt_saved = copy.deepcopy(self._optimizer.state_dict())
        if self._sampler is not None:
            self._sampler_saved = copy.deepcopy(self._sampler.state_dict())
        super().save()

    def _store_payload(self) -> dict:
        part = {}
        if self._model_saved is not None:
            part["model"] = _to_cpu(self._model_saved)
        if self._opt_saved is not None:
            part["optimizer"] = _to_cpu(self._opt_saved)
        if self._sampler_saved is not None:
            part["sampler"] = self._sampler_saved
        return dict(self._saved, **{_TORCH_STORE_KEY: part})

    def _load_store(self, payload: dict):
        payload = dict(payload)
        part = payload.pop(_TORCH_STORE_KEY, {})
        self._model_saved = part.get("model")
        self._opt_saved = part.get("optimizer")
        self._sampler_saved = part.get("sampler")
        super()._load_store(payload)

    def restore(self):
        super().restore()
        if self._model_saved is not None:
            self._model.load_state_dict(self._model_saved)
        if self._optimizer is not None:
            # a failed step leaves handles of the runtime that is gone
            for pending in ("_handles", "_sparse_thunks"):
                getattr(self._optimizer, pending, {}).clear()
            if self._opt_saved is not None:
                self._optimizer.load_state_dict(self._opt_saved)
        if self._sampler_saved is not None:
            self._sampler.load_state_dict(self._sampler_saved)

    def sync(self):
        if self._model is not None:
            broadcast_parameters(self._model.state_dict(), root_rank=0)
        if self._optimizer is not None:
            broadcast_optimizer_state(self._optimizer, root_rank=0)
        if self._sampler is not None:
            st = self._sampler.state_dict()
            merged = set()
            for s in allgather_object(st):
                merged.update(s.get("processed_indices", ()))
            st["processed_indices"] = sorted(merged)
            self._sampler.load_state_dict(st)
        super().sync()
