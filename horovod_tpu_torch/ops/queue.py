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
  other op (allgather, alltoall, reducescatter, broadcast, the other
  reductions) runs alone (``_run_single`` :1454).
- The compressed wire (``_quant_split`` :1132-1181,
  ``_run_quant_allreduce`` :1331-1420): with ``HOROVOD_COMPRESSION`` set
  or a ``Compression.int8``/``int4`` marker on the entries (a marker wins;
  its signature is part of the fusable group's key), a group splits into
  the tensors that go on the wire and those kept off it (opt-out names,
  small leaves, non-float dtypes), each reason counted once per tensor in
  ``hvd_quant_fallback_total``; a world of one sends the whole group
  uncompressed (reason ``world_size``), because quantizing at one rank
  would change the result. A quantized chunk reads its error-feedback
  residual before its dispatch and commits the new one only after the
  dispatch succeeded (``compression.ResidualStore``).
- Process sets: an entry on a set other than the global one negotiates
  under ``ps:<set>:<name>`` (``_wire_name`` :1069), so two sets may each
  have a tensor ``x``, is ready once the set's members submitted it, and
  runs on the set's own runtime group, fused or alone.
- Join (``join`` :1104): a joined rank keeps negotiating and, for every
  name the others make ready, runs a zero contribution built from the
  coordinator's signature (``_zero_entry_from_sig`` :1080; no rows for
  allgather and alltoall, none for a set it is not in), until every rank
  has joined.

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

- *Host reads.* allgather and alltoall exchange their first-dimension
  sizes before the data moves, a read of 8 bytes a rank to the host. It
  is issued before the comm stream waits on the entry's ready event and
  waits on the comm stream alone, so a backward still running on the
  caller's stream does not hold up the cycle, and every other rank's
  negotiation with it.

On the CPU (gloo) the cycle thread runs each collective to its end, and no
event is involved.

The megaplan (``HOROVOD_MEGAPLAN``, ``ops/megaplan.py``; the JAX cycle's
:655-697 and :773-957): after the same batch signature repeated on
``HOROVOD_MEGAPLAN_STABLE_ROUNDS`` working cycles, with every entry in a
``FusedChunkPlan``, nothing pending, no join and, at more than one rank,
the coordinator's lease, the cycle records its chunk chain
(``_mp_capture``: dropped by a single op, a chunk with no plan or one that
failed, and a quantized group, whose residuals change every step), and
later cycles with that signature replay it (``_megaplan_cycle``): one
lease round (the 1-byte marker) instead of a negotiation, and
``_native.chain_dispatch`` instead of grouping and plan lookups, under the
same stream contract (ready events waited on a chunk, done events, entries
finished with them). A miss falls back to the negotiated path; a lease
the coordinator withdrew in the lease round's own response is handled as
that round's negotiated response, because the round was consumed.

Left out, as ROADMAP.md queue 1 lists them: autotuning
(``set_compression_spec``), and the tracing, timeline, flight-recorder,
anatomy and perf-ledger hooks.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from dataclasses import dataclass
from typing import Any, Optional

import torch

from ..common import context as ctx_mod
from ..common.exceptions import DuplicateNameError, HorovodInternalError
from ..utils import lockcheck
from ..utils import metrics as metrics_mod
from .. import _native
from . import collectives as C
from . import compression as comp
from . import fused_pack
from . import megaplan as megaplan_mod
from .controller import dtype_name

LOG = logging.getLogger("horovod_tpu_torch")


@dataclass
class TensorEntry:
    """One pending op (reference TensorTableEntry, common.h:197-240)."""

    name: str
    op: str  # allreduce | broadcast | allgather | alltoall | reducescatter
    tensor: torch.Tensor
    # where the result lands: the tensor itself for an in-place op, a
    # buffer of its shape and dtype otherwise
    output: Optional[torch.Tensor] = None
    reduce_op: C.ReduceOp = C.ReduceOp.AVERAGE
    root_rank: int = 0
    prescale_factor: float = 1.0
    postscale_factor: float = 1.0
    process_set: Any = None
    splits: Any = None  # alltoall: a CPU int64 tensor, or None for even
    handle: int = -1
    # CUDA event recorded on the caller's stream at enqueue
    ready: Any = None
    # the entry's wire (a compression.QuantSpec from a marker), or None
    quant: Any = None


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
            # an alltoall's result is (output, received splits on the CPU)
            out = result[0] if isinstance(result, tuple) else result
            stream = torch.cuda.current_stream(out.device)
            stream.wait_event(done)
            out.record_stream(stream)
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
        self.process_set = process_set
        self.group = group
        self.device = torch.device(device)
        self.cycle_time_ms = config.cycle_time_ms
        self.fusion_threshold = config.fusion_threshold_bytes
        self.queue = TensorQueue()
        self.handles = HandleManager()
        self.fusion_buffer = _native.FusionBuffer(
            config.fusion_threshold_bytes, self.device)
        self.comm_stream = (torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" else None)
        self._pending: dict[str, TensorEntry] = {}  # by negotiation key
        self.joined = False  # set by join(), cleared when all have joined
        self._join_done = threading.Event()
        self._join_last_rank = -1
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
        self._m_enq: dict[str, Any] = {}
        self.controller = self._maybe_controller(config, kv_client)
        # the compressed wire (HOROVOD_COMPRESSION) and its guardrails;
        # the residuals are set up by the first group that asks for it
        self._quant = comp.resolve_quant_spec(config)
        self._quant_residuals: Optional[comp.ResidualStore] = None
        self._quant_optout = comp.quant_optout_patterns(config.quant_optout)
        self._quant_min_elems = config.quant_min_elems
        self._quant_noted: set = set()
        # the megaplan's manager, resolved once: None (the flag off) costs
        # the cycle one is-None check
        self._mp = megaplan_mod.get_manager()
        # the chunk chain being recorded this cycle, or None
        self._mp_capture: Optional[list] = None
        # the hierarchical knobs a captured chain was dispatched under
        self._mp_hier = C.hierarchy_verdicts()

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
                            stall_shutdown_s=config.stall_shutdown_time_s,
                            hier=config.hier_negotiation,
                            hier_group_size=config.hier_group_size,
                            hier_fallback_s=config.hier_fallback_s)

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
            if e.process_set is not None and not e.process_set.included():
                raise ValueError(f"{e.name!r}: this rank is not a member "
                                 f"of process set {e.process_set.name!r}")
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
        for e in entries:
            c = self._m_enq.get(e.op)
            if c is None:
                c = self._m_enq[e.op] = self.metrics.counter(
                    "hvd_ops_enqueued_total", "eager ops enqueued", op=e.op)
            c.inc()
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
        self._join_done.set()  # a join() in wait fails
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
        mp = self._mp
        if mp is not None and C.hierarchy_verdicts() != self._mp_hier:
            # the chunk plans' collectives changed: the captured chain
            # would replay the old ones
            self._mp_hier = C.hierarchy_verdicts()
            megaplan_mod.invalidate_megaplan("hierarchical")
        if mp is not None and batch and mp.plan is not None:
            # a live megaplan: one check and one chained dispatch; a miss
            # invalidates it and the cycle negotiates below
            if self._megaplan_cycle(batch, t0):
                return
        if self.controller is not None:
            batch = self._negotiate(batch)
        if not batch:
            self._m_cycles_idle.inc()
            return
        self._m_cycles_work.inc()
        cap_sig = None
        if mp is not None:
            # record this cycle's chunk chain once the batch has been
            # stable long enough, the whole step can replay and, at more
            # than one rank, the coordinator granted the lease in this
            # very round
            cap_sig = megaplan_mod.batch_signature(batch)
            if (mp.observe(cap_sig) and not self._pending
                    and not self.joined
                    and (self.controller is None
                         or self.controller.megaplan_lease)):
                self._mp_capture = []
        self._dispatch_batch(batch)
        if self._mp_capture is not None:
            self._megaplan_commit(cap_sig, batch)
        self._finish_cycle(batch, t0)

    def _finish_cycle(self, batch: list[TensorEntry], t0: float):
        """A working cycle's tail, the negotiated and the replayed one's."""
        self.work_cycles += 1
        self._m_cycle.observe(time.perf_counter() - t0)

    def _comm(self):
        """The comm stream as PyTorch's current stream (nothing on the
        CPU)."""
        if self.comm_stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.comm_stream)

    def _megaplan_commit(self, sig, batch: list[TensorEntry]):
        """Install the chain recorded in this cycle's dispatch, when every
        entry of the batch went through a chunk plan."""
        cap, self._mp_capture = self._mp_capture, None
        if not cap or sum(len(c[0]) for c in cap) != len(batch):
            self._mp.abort_capture()
            return
        self._mp.commit(megaplan_mod.Megaplan(
            sig=sig, chunks=tuple(cap), epoch=megaplan_mod.epoch(),
            plan_epoch=C._plan_epoch()))

    def _megaplan_cycle(self, batch: list[TensorEntry], t0: float) -> bool:
        """One cycle against the captured megaplan. True when the cycle
        was handled: replayed, or, at more than one rank, dispatched from
        the lease round's response after the coordinator withdrew the
        lease in it (the round was consumed). False on a miss before any
        round or dispatch, so the negotiated path runs the cycle; every
        miss invalidates."""
        mp = self._mp
        plan = mp.plan
        if (plan.epoch != megaplan_mod.epoch()
                or plan.plan_epoch != C._plan_epoch()):
            mp.invalidate("epoch")
            return False
        if self.joined or self._pending:
            mp.invalidate("membership")
            return False
        if megaplan_mod.batch_signature(batch) != plan.sig:
            mp.invalidate("signature")
            return False
        ctl = self.controller
        if ctl is not None and not ctl.megaplan_lease:
            # withheld on the last response: another rank broke stability
            mp.invalidate("lease")
            return False
        if ctl is not None:
            try:
                resp = ctl.lease_round()
            except Exception as exc:
                self._fail_negotiation(exc, batch)
                mp.invalidate("controller")
                return True
            if (not ctl.megaplan_lease or resp["errors"]
                    or resp["join_done"] is not None
                    or plan.epoch != megaplan_mod.epoch()):
                # the lease broke in this round, which merged our marker:
                # dispatch what its response released, as a negotiated
                # round would (negotiating again would desync the ranks)
                mp.invalidate("lease")
                for e in batch:
                    self._pending[self._wire_name(e)] = e
                out = self._process_response(resp)
                if not out:
                    self._m_cycles_idle.inc()
                    return True
                self._m_cycles_work.inc()
                self._dispatch_batch(out)
                self._finish_cycle(out, t0)
                return True
        self._m_cycles_work.inc()
        by = {self._wire_name(e): e for e in batch}
        steps = []
        for names, cplan, _, _ in plan.chunks:
            entries = [by[n] for n in names]
            steps.append((cplan, [e.tensor for e in entries],
                          [e.output for e in entries],
                          [e.ready for e in entries]))
        calls0, t_chain = C.dist_calls, time.perf_counter()
        with self._comm():
            outs, exc = _native.chain_dispatch(self.fusion_buffer, steps,
                                               self.comm_stream)
        chain_s = time.perf_counter() - t_chain
        self.collective_calls += C.dist_calls - calls0
        for done, (names, _, nbytes, dtype) in zip(outs, plan.chunks):
            self.chunks += 1
            m_bytes, m_lat, m_ops = self._op_metrics("allreduce", dtype)
            m_bytes.inc(nbytes)
            m_ops.inc()
            m_lat.observe(chain_s)
            self._m_fusion_batch.observe(len(names))
            self._m_fused_bytes.observe(nbytes)
            for n in names:
                self._finish(by[n], by[n].output, done=done)
        if exc is not None:
            # the chain stopped at a chunk: fail it and every later one,
            # and go back to negotiating
            err = HorovodInternalError(f"megaplan replay failed: {exc}")
            failed = [n for names, _, _, _ in plan.chunks[len(outs):]
                      for n in names]
            self._m_op_errors.inc(len(failed))
            for n in failed:
                self._finish(by[n], None, err)
            mp.invalidate("dispatch")
        else:
            mp.note_replay()
        self._finish_cycle(batch, t0)
        return True

    def _dispatch_batch(self, batch: list[TensorEntry]):
        """Group a ready batch into fusable allreduces and single ops, and
        dispatch them on the comm stream, in the batch's order."""
        fusable: dict[tuple, list[TensorEntry]] = {}
        singles: list[TensorEntry] = []
        for e in batch:
            if e.op == "allreduce" and e.reduce_op in (C.ReduceOp.SUM,
                                                       C.ReduceOp.AVERAGE):
                # entries with different wires never share a chunk
                key = (e.tensor.dtype, int(e.reduce_op), e.prescale_factor,
                       e.postscale_factor,
                       getattr(e.process_set, "name", None) or "global",
                       None if e.quant is None else e.quant.signature())
                fusable.setdefault(key, []).append(e)
            else:
                singles.append(e)
        if singles:
            # a single op runs outside any chunk plan: not replayable
            self._mp_capture = None
        with self._comm():
            for group in fusable.values():
                self._run_fused_allreduce(group)
            for e in singles:
                self._run_single(e)

    def _negotiate(self, batch: list[TensorEntry]) -> list[TensorEntry]:
        """One round: post the pending set (and whether this rank has
        joined), receive the globally ready names in the coordinator's
        order. Runs every cycle: empty posts keep the lockstep advancing
        for ranks with nothing pending."""
        from .controller import entry_signature

        self._m_neg_rounds.inc()
        for e in batch:
            self._pending[self._wire_name(e)] = e
        sigs = {n: entry_signature(e) for n, e in self._pending.items()}
        try:
            resp = self.controller.negotiate(sigs, joined=self.joined)
        except Exception as exc:
            self._fail_negotiation(exc, list(self._pending.values()))
            self._pending.clear()
            return []
        return self._process_response(resp)

    def _fail_negotiation(self, exc: Exception, entries):
        """Fail ``entries`` after a round failed, on shutdown too: a caller
        may be blocked in synchronize."""
        if self._stop.is_set():
            err: Exception = HorovodInternalError(
                "Horovod has been shut down")
        else:
            LOG.error("negotiation failed: %s", exc)
            err = HorovodInternalError(
                f"controller negotiation failed: {exc}")
        for e in entries:
            self._finish(e, None, err)

    def _process_response(self, resp: dict) -> list[TensorEntry]:
        """Apply one round's response to the pending table: fail the
        errored entries, pop the ready ones in the coordinator's order,
        make a joined rank's zero contributions and note a finished join.
        A negotiated round and a consumed lease round share it."""
        for n, msg in resp["errors"].items():
            e = self._pending.pop(n, None)
            if e is not None:
                self._m_neg_errors.inc()
                self._finish(e, None, HorovodInternalError(msg))
        out = []
        for n in resp["ready"]:
            e = self._pending.pop(n, None)
            if e is not None:
                out.append(e)
            elif self.joined:
                # joined ranks contribute zeros (reference
                # global_state.h:107-111), never to a set they are not in
                sig = resp["sigs"].get(n)
                if sig is not None and self._member_of_sig(sig):
                    out.append(self._zero_entry_from_sig(n, sig))
        if resp.get("join_done") is not None:
            self._join_last_rank = int(resp["join_done"])
            self.joined = False
            self._join_done.set()
        return out

    @staticmethod
    def _wire_name(e: TensorEntry) -> str:
        """The negotiation key: the name on the global set, scoped by the
        set's name on any other, where a name may repeat across sets."""
        pname = getattr(e.process_set, "name", None)
        return e.name if not pname or pname == "global" \
            else f"ps:{pname}:{e.name}"

    @staticmethod
    def _member_of_sig(sig: list) -> bool:
        if len(sig) <= 9 or not sig[9]:
            return True  # the global set
        return torch.distributed.get_rank() in sig[9]

    def _zero_entry_from_sig(self, name: str, sig: list) -> TensorEntry:
        """A zero contribution matching another rank's signature: zeros of
        its shape, and no rows for allgather and alltoall (ragged, so the
        empty contribution is exact). No caller waits on it."""
        op, shape = sig[0], list(sig[2])
        if op in ("allgather", "alltoall") and shape:
            shape[0] = 0  # the signature's "*"
        ps, plain = None, name
        if sig[7] != "global":
            ps = ctx_mod.process_set_by_name(sig[7])
            if ps is None:
                raise HorovodInternalError(
                    f"{name!r} names process set {sig[7]!r}, which this "
                    "rank never added")
            plain = name[len(f"ps:{sig[7]}:"):]
        t = torch.zeros(shape, dtype=getattr(torch, sig[1]),
                        device=self.device)
        return TensorEntry(name=plain, op=op, tensor=t, output=t,
                           reduce_op=C.ReduceOp(sig[3]), root_rank=sig[4],
                           prescale_factor=sig[5], postscale_factor=sig[6],
                           process_set=ps)

    def join(self, timeout: Optional[float] = None) -> int:
        """Mark this rank out of data (reference ``hvd.join()``): it keeps
        contributing zeros to the others' collectives until every rank has
        joined, and returns the last rank to join. Without a controller
        there is no one to wait for."""
        if self.controller is None:
            return self.process_set.rank
        self._join_done.clear()
        self.joined = True
        if not self._join_done.wait(timeout or 600.0):
            self.joined = False
            raise HorovodInternalError(
                "join() timed out waiting for all ranks")
        if self._stop.is_set():
            raise HorovodInternalError("Horovod has been shut down")
        return self._join_last_rank

    # -- execution -----------------------------------------------------------
    def _finish(self, entry: TensorEntry, result, exc=None, done=None):
        self.queue.release(entry.name)
        self.handles.mark_done(entry.handle, result, exc, done)

    def _wait_ready(self, entries):
        _native.wait_ready(self.comm_stream, [e.ready for e in entries])

    def _record_done(self, tensors):
        """The event after the comm stream's last kernel on ``tensors``,
        which are marked as used there (None on the CPU)."""
        return _native.record_done(self.comm_stream, tensors)

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

    def _group_of(self, ps):
        """The runtime group an entry on ``ps`` runs on."""
        if ps is None or ps is self.process_set:
            return self.group
        return ps.runtime_group

    @staticmethod
    def _needs_scale(e: TensorEntry, group) -> bool:
        return (e.prescale_factor != 1.0 or e.postscale_factor != 1.0
                or (e.reduce_op == C.ReduceOp.AVERAGE
                    and not C._has_avg(group)))

    def _run_fused_allreduce(self, group: list[TensorEntry]):
        """Each chunk through its fused-chunk plan. A chunk the K1 kernel
        cannot scale (an integer or other non-float dtype whose factors are
        not both 1) promotes to float like the JAX package: its tensors go
        one by one to ``_run_single``. So does a chunk of no elements. With
        a wire, the group's eligible tensors go to
        ``_run_quant_allreduce`` first."""
        spec = group[0].quant or self._quant
        if spec is not None:
            qgroup, group = self._quant_split(group, spec)
            if qgroup:
                self._run_quant_allreduce(qgroup, spec)
            if not group:
                return
        e0 = group[0]
        dtype = e0.tensor.dtype
        if (self._needs_scale(e0, self._group_of(e0.process_set))
                and not fused_pack.can_scale(dtype)):
            self._mp_capture = None
            for e in group:
                self._run_single(e)
            return
        for chunk in self._chunk_group(group):
            plan = self._chunk_plan(chunk)
            if plan is None:
                self._mp_capture = None
                for e in chunk:
                    self._run_single(e)
                continue
            if self._mp_capture is not None:
                # the plan is held by the megaplan from here on
                self._mp_capture.append((
                    tuple(self._wire_name(e) for e in chunk), plan,
                    sum(e.tensor.numel() * e.tensor.element_size()
                        for e in chunk), dtype_name(dtype)))
            self._dispatch_chunk(chunk, lambda plan=plan, chunk=chunk:
                                 plan.execute([e.tensor for e in chunk],
                                              [e.output for e in chunk],
                                              self.fusion_buffer))

    def _chunk_plan(self, chunk: list[TensorEntry], quant=None):
        e0 = chunk[0]
        return C.fused_chunk_plan(
            e0.process_set or self.process_set,
            self._group_of(e0.process_set), e0.reduce_op,
            e0.prescale_factor, e0.postscale_factor,
            [e.name for e in chunk], [e.tensor.numel() for e in chunk],
            [tuple(e.tensor.shape) for e in chunk], e0.tensor.dtype,
            self.device.type, quant=quant)

    def _dispatch_chunk(self, chunk: list[TensorEntry], run):
        """Run one chunk's dispatch (``run``) on the comm stream after its
        entries are ready; fail the whole chunk if it raises, else count
        it and finish its entries with their outputs."""
        t0 = time.perf_counter()
        calls0 = C.dist_calls
        try:
            self._wait_ready(chunk)
            run()
            done = self._record_done(
                [e.tensor for e in chunk]
                + [e.output for e in chunk if e.output is not e.tensor])
        except Exception as exc:  # fail the whole chunk
            self._mp_capture = None
            self._m_op_errors.inc(len(chunk))
            err = HorovodInternalError(f"fused allreduce failed: {exc}")
            for e in chunk:
                self._finish(e, None, err)
            return
        nbytes = sum(e.tensor.numel() * e.tensor.element_size()
                     for e in chunk)
        self.chunks += 1
        self.collective_calls += C.dist_calls - calls0
        m_bytes, m_lat, m_ops = self._op_metrics(
            "allreduce", dtype_name(chunk[0].tensor.dtype))
        m_bytes.inc(nbytes)
        m_ops.inc()
        m_lat.observe(time.perf_counter() - t0)
        self._m_fusion_batch.observe(len(chunk))
        self._m_fused_bytes.observe(nbytes)
        for e in chunk:
            self._finish(e, e.output, done=done)

    def _quant_fallback(self, e: TensorEntry, reason: str):
        """Count a tensor kept off the wire, once per name and reason."""
        mark = (e.name, reason)
        if mark not in self._quant_noted:
            self._quant_noted.add(mark)
            comp.quant_fallback_counter(reason).inc()

    def _quant_split(self, group: list[TensorEntry], spec):
        """(the entries that go on the wire, those kept off it)."""
        if self._quant_residuals is None:  # the first group with a wire
            self._quant_residuals = comp.ResidualStore()
        ps = group[0].process_set or self.process_set
        if ps.size <= 1:
            # no wire at one rank: the whole group stays uncompressed
            for e in group:
                self._quant_fallback(e, "world_size")
            return [], group
        quant, plain = [], []
        for e in group:
            reason = comp.quant_fallback_reason(
                e.name, e.tensor.numel(), e.tensor.dtype, self._quant_optout,
                self._quant_min_elems)
            if reason is None:
                quant.append(e)
            else:
                self._quant_fallback(e, reason)
                plain.append(e)
        return quant, plain

    def _run_quant_allreduce(self, group: list[TensorEntry], spec):
        """The compressed flavour of ``_run_fused_allreduce``: the same
        chunks, each through its cast or quantized plan. A quantized
        chunk's residuals (one a tensor, keyed by its name and the wire's
        signature) are read before the dispatch and committed only after
        it succeeded, so a failed dispatch leaves the last ones in
        place."""
        # the residuals' read-then-commit is state of each dispatch that a
        # captured chain cannot replay
        self._mp_capture = None
        store = self._quant_residuals
        for chunk in self._chunk_group(group):
            plan = self._chunk_plan(chunk, quant=spec)
            if plan is None:
                for e in chunk:
                    self._run_single(e)
                continue
            inputs = [e.tensor for e in chunk]
            outputs = [e.output for e in chunk]
            if isinstance(plan, C.QuantFusedChunkPlan):
                def run(plan=plan, inputs=inputs, outputs=outputs,
                        names=[e.name for e in chunk]):
                    sig = spec.signature()
                    residual = (store.get(names, plan.sizes, sig)
                                if spec.error_feedback else None)
                    new_res = plan.execute(inputs, outputs, residual)
                    if new_res is not None:
                        store.commit(names, plan.sizes, sig, new_res)
                    comp.record_quant_chunk(plan.pre_bytes, plan.wire_bytes,
                                            spec.bits, plan.n_blocks)
            elif isinstance(plan, C.CastFusedChunkPlan):
                def run(plan=plan, inputs=inputs, outputs=outputs):
                    plan.execute(inputs, outputs)
                    comp.record_quant_chunk(plan.pre_bytes, plan.wire_bytes,
                                            spec.bits, 0)
            else:
                # no compressed plan covers the chunk (an op or dtype the
                # wire does not take): the plain plan
                def run(plan=plan, inputs=inputs, outputs=outputs):
                    plan.execute(inputs, outputs, self.fusion_buffer)
            self._dispatch_chunk(chunk, run)

    def _run_single(self, e: TensorEntry):
        t0 = time.perf_counter()
        calls0 = C.dist_calls
        group = self._group_of(e.process_set)
        ps = e.process_set or self.process_set
        try:
            if e.op == "allgather":
                # sizes first: their host read waits on the comm stream
                # before it waits on the caller's
                sizes = C.allgather_sizes(e.tensor, group)
                self._wait_ready([e])
                r = C._eager_allgather(e.tensor, group, sizes,
                                       C.allgather_hierarchy(ps))
                done = self._record_done([e.tensor, r])
            elif e.op == "alltoall":
                splits, mat = C.alltoall_split_matrix(e.tensor, e.splits,
                                                      group)
                self._wait_ready([e])
                r = C._eager_alltoall(e.tensor, splits, group, mat)
                done = self._record_done([e.tensor, r[0]])
            else:
                self._wait_ready([e])
                if e.op == "allreduce":
                    r = C._eager_allreduce(
                        e.tensor, e.reduce_op, group, e.prescale_factor,
                        e.postscale_factor,
                        C.allreduce_hierarchy(ps, e.reduce_op))
                    if e.output is e.tensor:
                        e.tensor.copy_(r)  # in place, in the tensor's dtype
                        r = e.tensor
                elif e.op == "broadcast":
                    r = C._eager_broadcast(e.tensor, e.root_rank, group,
                                           e.output)
                elif e.op == "reducescatter":
                    r = C._eager_reducescatter(e.tensor, e.reduce_op, group)
                else:
                    raise HorovodInternalError(f"unknown op {e.op}")
                done = self._record_done([e.tensor] if r is e.tensor
                                         else [e.tensor, r])
        except Exception as exc:
            self._m_op_errors.inc()
            self._finish(e, None, HorovodInternalError(str(exc)))
            return
        nbytes = e.tensor.numel() * e.tensor.element_size()
        self.collective_calls += C.dist_calls - calls0
        m_bytes, m_lat, m_ops = self._op_metrics(
            e.op, dtype_name(e.tensor.dtype))
        m_bytes.inc(nbytes)
        m_ops.inc()
        m_lat.observe(time.perf_counter() - t0)
        self._finish(e, r, done=done)
