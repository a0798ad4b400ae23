"""The background runtime: named async collectives, negotiated and fused on
a cycle thread — counterpart of ``horovod_tpu/ops/queue.py``.

- ``TensorEntry`` (:63) is one pending op; ``HandleManager`` (:84) maps
  the int handles the front end returns to results; ``TensorQueue``
  (:137-173) bridges the callers' threads to the cycle thread and refuses
  a second op under a name that is still in flight (``DuplicateNameError``).
- ``BackgroundRuntime`` runs the cycle (``_loop``/``run_cycle`` :594-696):
  every ``cycle_time_ms`` it drains the queue, negotiates the drained
  names with the other ranks (``KVController``, when the world has more
  than one rank: a port worker is a GPU, where a JAX worker is a host),
  and dispatches the globally ready entries in the coordinator's order.
  Same-dtype SUM/AVERAGE allreduces fuse into chunks of at most
  ``fusion_threshold_bytes`` (``_chunk_group`` :1183), each reduced by one
  fused-chunk plan (``ops/collectives.py``: pack → collective → unpack in
  the K1 kernel, through the device fusion buffer of ``_native``); every
  other op runs alone (``_run_single`` :1454).

The cycle's timing follows the reference's ``RunLoopOnce``, not the JAX
package's: a cycle starts ``cycle_time_ms`` after the last one started,
and an enqueue does not cut the sleep short (the JAX runtime wakes on
every enqueue, :540). So what the callers enqueue within one cycle is
fused, and ``HOROVOD_CYCLE_TIME`` and ``HOROVOD_FUSION_THRESHOLD`` decide
the chunks; waking on every enqueue made nearly every gradient of a
backward pass its own chunk. Without a controller an idle cycle has
nothing to do, so the thread sleeps until something is enqueued and then
lets one cycle time pass before it drains: an idle runtime takes no GIL
(a 1 kHz idle wake cost a host-bound training step tens of ms on an H100
machine). ``enqueue_group`` enqueues a list at once (the reference's
``EnqueueTensorAllreduces``), so one cycle drains all of it: a grouped
allreduce is fused whatever the timing.

Streams, which XLA ordered for the JAX runtime and the port must order
itself (the reference's ready events and finalizers, SURVEY.md N16):

- *Readiness.* A gradient hook fires when its gradient is *enqueued* on the
  caller's stream, not when it is computed, so ``enqueue`` records a CUDA
  event on the caller's current stream, and the cycle thread's comm stream
  waits on it before a pack or collective reads the tensor.
- *Completion.* Every chunk and single op records a CUDA event on the comm
  stream after its last kernel. ``synchronize`` makes the caller's current
  stream wait on it (the host does not block), and ``poll`` queries it.
- *Allocator.* Tensors the comm stream touches are marked with
  ``record_stream``, so the caching allocator cannot hand their memory to
  another stream early; the fusion buffer lives as long as the runtime.

On the CPU (gloo) the cycle thread runs each collective to its end, and no
event is involved. Left out, as ROADMAP.md queue 1 lists them: join,
allgather, alltoall, reducescatter, process sets other than the global one,
the megaplan replay, the quantized and cast wires, autotuning, and the
tracing, timeline, anatomy and perf-ledger hooks.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from dataclasses import dataclass
from typing import Any, Optional

import torch

from ..common.exceptions import DuplicateNameError, HorovodInternalError
from ..utils import lockcheck
from ..utils import metrics as metrics_mod
from . import collectives as C
from . import fused_pack
from .controller import dtype_name

LOG = logging.getLogger("horovod_tpu_torch")


@dataclass
class TensorEntry:
    """One pending op (reference TensorTableEntry, common.h:197-240)."""

    name: str
    op: str  # allreduce | broadcast
    tensor: torch.Tensor
    # where the result lands: the tensor itself for an in-place op, a
    # buffer of its shape and dtype otherwise
    output: Optional[torch.Tensor] = None
    reduce_op: C.ReduceOp = C.ReduceOp.AVERAGE
    root_rank: int = 0
    prescale_factor: float = 1.0
    postscale_factor: float = 1.0
    process_set: Any = None
    handle: int = -1
    # CUDA event recorded on the caller's stream at enqueue
    ready: Any = None


class HandleManager:
    """Handle → result table (reference handle_manager.h:31). A result is
    (event set when the op was dispatched or failed, result tensor,
    exception, CUDA event recorded after the op's last kernel)."""

    def __init__(self):
        self._lock = lockcheck.make_lock("queue.handles")
        self._next = 0  # guarded-by: _lock
        self._results: dict[int, tuple] = {}  # guarded-by: _lock

    def allocate(self) -> int:
        with self._lock:
            h = self._next
            self._next += 1
            self._results[h] = (threading.Event(), None, None, None)
            return h

    def discard(self, handle: int):
        with self._lock:
            self._results.pop(handle, None)

    def mark_done(self, handle: int, result=None,
                  exc: Optional[BaseException] = None, done=None):
        with self._lock:
            rec = self._results.get(handle)
            if rec is None:
                return  # already consumed (shutdown race)
            self._results[handle] = (rec[0], result, exc, done)
        rec[0].set()

    def poll(self, handle: int) -> bool:
        """True once the op failed, or ran to its end on the device."""
        with self._lock:
            ev, _, exc, done = self._results[handle]
        if not ev.is_set():
            return False
        return exc is not None or done is None or done.query()

    def wait(self, handle: int):
        """Block until the op was dispatched; raise its failure, or return
        its result, ready for use on the caller's current stream."""
        with self._lock:
            ev = self._results[handle][0]
        ev.wait()
        with self._lock:
            _, result, exc, done = self._results.pop(handle)
        if exc is not None:
            raise exc
        if done is not None:
            stream = torch.cuda.current_stream(result.device)
            stream.wait_event(done)
            result.record_stream(stream)
        return result


class TensorQueue:
    """Pending-op FIFO with the in-flight name guard (reference
    tensor_queue.h)."""

    def __init__(self):
        self._lock = lockcheck.make_lock("queue.pending")
        self._queue: list[TensorEntry] = []  # guarded-by: _lock
        self._in_flight: set[str] = set()  # guarded-by: _lock
        self._finalized = False  # guarded-by: _lock

    def push(self, entries: list[TensorEntry]):
        """All of ``entries`` or none, under one lock, so one drain takes
        them together (reference AddToTensorQueueMulti)."""
        with self._lock:
            if self._finalized:
                raise HorovodInternalError("runtime is shut down")
            names = set()
            for e in entries:
                if e.name in self._in_flight or e.name in names:
                    raise DuplicateNameError(
                        f"a tensor named {e.name!r} is already in flight "
                        "(reference DUPLICATE_NAME_ERROR, common.h:169)")
                names.add(e.name)
            self._in_flight |= names
            self._queue.extend(entries)

    def drain(self) -> list[TensorEntry]:
        with self._lock:
            batch, self._queue = self._queue, []
            return batch

    def release(self, name: str):
        with self._lock:
            self._in_flight.discard(name)

    def finalize(self) -> list[TensorEntry]:
        """Fail-all on shutdown (reference FinalizeTensorQueue)."""
        with self._lock:
            self._finalized = True
            batch, self._queue = self._queue, []
            self._in_flight.clear()
            return batch


class BackgroundRuntime:
    """The cycle loop (reference RunLoopOnce, operations.cc:587) for one
    process set on one device. ``group`` is the ``torch.distributed`` group
    the runtime's collectives use; ``kv_client`` reaches the rendezvous
    store that carries negotiation (needed when the set has more than one
    rank)."""

    def __init__(self, process_set, config, device: torch.device, group,
                 kv_client=None):
        from .._native import FusionBuffer

        self.process_set = process_set
        self.group = group
        self.device = torch.device(device)
        self.cycle_time_ms = config.cycle_time_ms
        self.fusion_threshold = config.fusion_threshold_bytes
        self.queue = TensorQueue()
        self.handles = HandleManager()
        self.fusion_buffer = FusionBuffer(config.fusion_threshold_bytes,
                                          self.device)
        self.comm_stream = (torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" else None)
        self._has_avg = C._has_avg(group)
        self._pending: dict[str, TensorEntry] = {}  # negotiated backlog
        self._stop = threading.Event()
        self._work = threading.Event()  # set by an enqueue and by stop
        self._thread: Optional[threading.Thread] = None
        # counters a run reads (chip_smoke.py per step)
        self.cycles = 0
        self.work_cycles = 0
        self.chunks = 0            # fused chunks, one tensor or more
        self.collective_calls = 0  # calls into the communicator
        reg = metrics_mod.get_registry()
        self.metrics = reg
        self._m_cycle = reg.histogram(
            "hvd_cycle_seconds", "working background-cycle duration",
            buckets=metrics_mod.LATENCY_BUCKETS_S)
        self._m_queue_depth = reg.gauge(
            "hvd_queue_depth", "pending entries drained this cycle")
        self._m_fusion_batch = reg.histogram(
            "hvd_fusion_batch_size", "tensors fused per allreduce chunk",
            buckets=metrics_mod.BATCH_BUCKETS)
        self._m_fused_bytes = reg.histogram(
            "hvd_fused_chunk_bytes", "bytes per fused allreduce chunk",
            buckets=metrics_mod.SIZE_BUCKETS_BYTES)
        self._m_cycles_idle = reg.counter(
            "hvd_cycles_total", "background cycles", kind="idle")
        self._m_cycles_work = reg.counter(
            "hvd_cycles_total", "background cycles", kind="work")
        self._m_neg_rounds = reg.counter(
            "hvd_negotiation_rounds_total", "controller negotiation rounds")
        self._m_neg_errors = reg.counter(
            "hvd_negotiation_errors_total",
            "tensors failed by negotiation responses")
        self._m_op_errors = reg.counter(
            "hvd_op_errors_total", "eager ops failed during execution")
        self._m_by_op: dict[tuple, tuple] = {}
        self.controller = self._maybe_controller(config, kv_client)

    def _maybe_controller(self, config, kv_client):
        """Negotiation over the rendezvous store, whenever the set has more
        than one rank."""
        if self.process_set.size <= 1:
            return None
        if kv_client is None:
            raise ValueError("a runtime over more than one rank needs the "
                             "rendezvous store's client")
        from .controller import KVController

        return KVController(kv_client, rank=self.process_set.rank,
                            size=self.process_set.size,
                            poll_timeout=config.response_timeout_s,
                            stall_warning_s=config.stall_warning_time_s,
                            stall_shutdown_s=config.stall_shutdown_time_s)

    def _op_metrics(self, op: str, dtype: str) -> tuple:
        """(bytes_total, latency_hist, ops_total) of one (op, dtype)."""
        key = (op, dtype)
        handles = self._m_by_op.get(key)
        if handles is None:
            reg = self.metrics
            handles = (
                reg.counter(f"hvd_{op}_bytes_total",
                            f"bytes processed by eager {op}", dtype=dtype),
                reg.histogram(f"hvd_{op}_latency_seconds",
                              f"eager {op} launch latency",
                              buckets=metrics_mod.LATENCY_BUCKETS_S,
                              dtype=dtype),
                reg.counter(f"hvd_{op}_ops_total",
                            f"eager {op} operations launched", dtype=dtype),
            )
            self._m_by_op[key] = handles
        return handles

    # -- enqueue (callers' threads) -----------------------------------------
    def enqueue(self, entry: TensorEntry) -> int:
        return self.enqueue_group([entry])[0]

    def enqueue_group(self, entries: list[TensorEntry]) -> list[int]:
        """Enqueue ``entries`` at once; returns their handles. One cycle
        drains all of them, and one ready event on the caller's stream
        covers them all."""
        for e in entries:
            if e.tensor.device != self.device:
                raise ValueError(f"{e.name!r} lies on {e.tensor.device}; "
                                 f"the runtime runs on {self.device}")
        ready = None
        if self.comm_stream is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        for e in entries:
            e.handle = self.handles.allocate()
            e.ready = ready
        try:
            self.queue.push(entries)
        except BaseException:
            for e in entries:
                self.handles.discard(e.handle)
            raise
        self._work.set()
        return [e.handle for e in entries]

    # -- lifecycle ------------------------------------------------------------
    def start(self):
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="hvd-cycle")
        self._thread.start()

    def stop(self, drain: bool = True):
        """Stop the cycle thread; with ``drain``, hold the negotiation
        lockstep open until every rank has asked to stop. Pending handles
        fail with ``HorovodInternalError``."""
        self._stop.set()
        self._work.set()
        cycle_exited = True
        if self._thread:
            self._thread.join(timeout=10)
            cycle_exited = not self._thread.is_alive()
            self._thread = None
        if self.controller:
            if drain and cycle_exited:
                self.controller.drain_shutdown()
            self.controller.stop()
        err = HorovodInternalError("Horovod has been shut down")
        for e in list(self._pending.values()) + self.queue.finalize():
            self.handles.mark_done(e.handle, exc=err)
        self._pending.clear()
        # cached plans hold this runtime's process group, which dies with
        # it: a later runtime of the same shape must build its own
        C.invalidate_fused_plans()

    # -- cycle ---------------------------------------------------------------
    def _loop(self):
        if self.device.type == "cuda":
            # a new thread's current device is 0, whatever the caller's
            torch.cuda.set_device(self.device)
        start = time.monotonic()
        while True:
            if self.controller is None:
                # nothing to negotiate: sleep until an enqueue, which then
                # waits out one cycle with whatever follows it
                if not self._work.is_set():
                    self._work.wait()
                    start = time.monotonic()
                self._work.clear()
            # sleep out the rest of the cycle (reference RunLoopOnce); only
            # a stop cuts the sleep short
            if self._stop.wait(max(0.0, start + self.cycle_time_ms / 1e3
                                   - time.monotonic())):
                return
            start = time.monotonic()
            try:
                self.run_cycle()
            except Exception:
                LOG.exception("background cycle failed")

    def run_cycle(self):
        self.cycles += 1
        batch = self.queue.drain()
        t0 = time.perf_counter()
        if batch:
            self._m_queue_depth.set(len(batch))
        if self.controller is not None:
            batch = self._negotiate(batch)
        if not batch:
            self._m_cycles_idle.inc()
            return
        self._m_cycles_work.inc()
        self._dispatch_batch(batch)
        self.work_cycles += 1
        self._m_cycle.observe(time.perf_counter() - t0)

    def _dispatch_batch(self, batch: list[TensorEntry]):
        """Group a ready batch into fusable allreduces and single ops, and
        dispatch them on the comm stream, in the batch's order."""
        fusable: dict[tuple, list[TensorEntry]] = {}
        singles: list[TensorEntry] = []
        for e in batch:
            if e.op == "allreduce" and e.reduce_op in (C.ReduceOp.SUM,
                                                       C.ReduceOp.AVERAGE):
                key = (e.tensor.dtype, int(e.reduce_op), e.prescale_factor,
                       e.postscale_factor,
                       getattr(e.process_set, "name", None) or "global")
                fusable.setdefault(key, []).append(e)
            else:
                singles.append(e)
        stream = (torch.cuda.stream(self.comm_stream)
                  if self.comm_stream is not None
                  else contextlib.nullcontext())
        with stream:
            for group in fusable.values():
                self._run_fused_allreduce(group)
            for e in singles:
                self._run_single(e)

    def _negotiate(self, batch: list[TensorEntry]) -> list[TensorEntry]:
        """One round: post the pending set, receive the globally ready
        names in the coordinator's order. Runs every cycle: empty posts
        keep the lockstep advancing for ranks with nothing pending."""
        from .controller import entry_signature

        self._m_neg_rounds.inc()
        for e in batch:
            self._pending[e.name] = e
        sigs = {n: entry_signature(e) for n, e in self._pending.items()}
        try:
            resp = self.controller.negotiate(sigs)
        except Exception as exc:
            # fail everything, on shutdown too: a caller may be blocked in
            # synchronize
            if self._stop.is_set():
                err: Exception = HorovodInternalError(
                    "Horovod has been shut down")
            else:
                LOG.error("negotiation failed: %s", exc)
                err = HorovodInternalError(
                    f"controller negotiation failed: {exc}")
            for e in self._pending.values():
                self._finish(e, None, err)
            self._pending.clear()
            return []
        for n, msg in resp["errors"].items():
            e = self._pending.pop(n, None)
            if e is not None:
                self._m_neg_errors.inc()
                self._finish(e, None, HorovodInternalError(msg))
        return [self._pending.pop(n) for n in resp["ready"]
                if n in self._pending]

    # -- execution -----------------------------------------------------------
    def _finish(self, entry: TensorEntry, result, exc=None, done=None):
        self.queue.release(entry.name)
        self.handles.mark_done(entry.handle, result, exc, done)

    def _wait_ready(self, entries):
        if self.comm_stream is not None:
            for ev in {id(e.ready): e.ready for e in entries}.values():
                self.comm_stream.wait_event(ev)

    def _record_done(self, tensors):
        """The event after the comm stream's last kernel on ``tensors``,
        which are marked as used there (None on the CPU)."""
        if self.comm_stream is None:
            return None
        for t in tensors:
            t.record_stream(self.comm_stream)
        done = torch.cuda.Event()
        done.record(self.comm_stream)
        return done

    def _chunk_group(self, group: list[TensorEntry]) -> list[list]:
        """Split a fusable group into chunks of at most the fusion
        threshold's bytes (a tensor larger than it is a chunk alone)."""
        chunks, chunk, nbytes = [], [], 0
        for e in group:
            sz = e.tensor.numel() * e.tensor.element_size()
            if chunk and nbytes + sz > self.fusion_threshold:
                chunks.append(chunk)
                chunk, nbytes = [], 0
            chunk.append(e)
            nbytes += sz
        if chunk:
            chunks.append(chunk)
        return chunks

    def _needs_scale(self, e: TensorEntry) -> bool:
        return (e.prescale_factor != 1.0 or e.postscale_factor != 1.0
                or (e.reduce_op == C.ReduceOp.AVERAGE and not self._has_avg))

    def _run_fused_allreduce(self, group: list[TensorEntry]):
        """Each chunk through its fused-chunk plan. A chunk the K1 kernel
        cannot scale (an integer or other non-float dtype whose factors are
        not both 1) promotes to float like the JAX package: its tensors go
        one by one to ``_run_single``. So does a chunk of no elements."""
        e0 = group[0]
        dtype = e0.tensor.dtype
        ps = e0.process_set or self.process_set
        if self._needs_scale(e0) and not fused_pack.can_scale(dtype):
            for e in group:
                self._run_single(e)
            return
        for chunk in self._chunk_group(group):
            names = [e.name for e in chunk]
            t0 = time.perf_counter()
            plan = C.fused_chunk_plan(
                ps, self.group, e0.reduce_op, e0.prescale_factor,
                e0.postscale_factor, names,
                [e.tensor.numel() for e in chunk],
                [tuple(e.tensor.shape) for e in chunk], dtype,
                self.device.type)
            if plan is None:
                for e in chunk:
                    self._run_single(e)
                continue
            try:
                self._wait_ready(chunk)
                plan.execute([e.tensor for e in chunk],
                             [e.output for e in chunk], self.fusion_buffer)
                done = self._record_done(
                    [e.tensor for e in chunk]
                    + [e.output for e in chunk if e.output is not e.tensor])
            except Exception as exc:  # fail the whole chunk
                self._m_op_errors.inc(len(chunk))
                err = HorovodInternalError(f"fused allreduce failed: {exc}")
                for e in chunk:
                    self._finish(e, None, err)
                continue
            nbytes = sum(e.tensor.numel() * e.tensor.element_size()
                         for e in chunk)
            self.chunks += 1
            self.collective_calls += 1
            m_bytes, m_lat, m_ops = self._op_metrics(
                "allreduce", dtype_name(dtype))
            m_bytes.inc(nbytes)
            m_ops.inc()
            m_lat.observe(time.perf_counter() - t0)
            self._m_fusion_batch.observe(len(chunk))
            self._m_fused_bytes.observe(nbytes)
            for e in chunk:
                self._finish(e, e.output, done=done)

    def _run_single(self, e: TensorEntry):
        t0 = time.perf_counter()
        try:
            self._wait_ready([e])
            if e.op == "allreduce":
                r = C._eager_allreduce(e.tensor, e.reduce_op, self.group,
                                       e.prescale_factor,
                                       e.postscale_factor)
                if e.output is e.tensor:
                    e.tensor.copy_(r)  # in place, in the tensor's dtype
                    r = e.tensor
            elif e.op == "broadcast":
                r = C._eager_broadcast(e.tensor, e.root_rank, self.group,
                                       e.output)
            else:
                raise HorovodInternalError(f"unknown op {e.op}")
            done = self._record_done([e.tensor] if r is e.tensor
                                     else [e.tensor, r])
        except Exception as exc:
            self._m_op_errors.inc()
            self._finish(e, None, HorovodInternalError(str(exc)))
            return
        nbytes = e.tensor.numel() * e.tensor.element_size()
        if e.tensor.numel():
            self.collective_calls += 1
        m_bytes, m_lat, m_ops = self._op_metrics(
            e.op, dtype_name(e.tensor.dtype))
        m_bytes.inc(nbytes)
        m_ops.inc()
        m_lat.observe(time.perf_counter() - t0)
        self._finish(e, r, done=done)
