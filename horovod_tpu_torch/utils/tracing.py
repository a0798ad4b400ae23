"""Cross-rank tracing: collective lifecycle spans, clock alignment, the
merged timeline and straggler attribution — a copy of
``horovod_tpu/utils/tracing.py``.

- **Span**: one submitted collective, id ``(tensor name, round)``, with
  wall-clock phase stamps: submit, queue drain, negotiation start and
  end, dispatch start and end, done (``T_*``). A span rides its
  ``TensorEntry`` through ``ops/queue.py``, and every terminal path goes
  through the runtime's ``_finish``, so a fault may fail a span but never
  leak it.
- **Buffer**: finalized spans go through a ``queue.SimpleQueue`` (the JAX
  package's fallback; its native ring stays with its C++ core) into a
  bounded deque (``HOROVOD_TRACE_BUFFER``, 4096 spans) that reports and
  pushes read.
- **Clock alignment**: a few probes of the rendezvous server's
  auth-exempt ``GET /clock`` at init, NTP-style: ``offset = server_t -
  (t0 + t1) / 2`` from the probe with the least round trip, uncertainty
  half of it; ``HOROVOD_TRACE_CLOCK_OFFSET`` overrides. Spans keep local
  wall time and the offset rides every pushed buffer.
- **Merged timeline**: workers push span buffers under ``trace/rank{k}``
  (the ``MetricsDumper``'s cadence), and the launcher's ``GET /timeline``
  merges them into one Chrome trace: pid = rank, one lane a phase.
- **Straggler attribution**: a worker stamps its aligned submit time into
  its negotiation payload; the coordinator keeps each rank's first submit
  time a tensor and, when the tensor goes ready, names the rank that
  submitted last and how long the first waited
  (``hvd_straggler_wait_seconds``, ``hvd_straggler_last_rank_total``),
  stamped back on every rank's spans through the response and read by
  ``hvd.trace_report()`` and the stall inspector.

Zero-cost contract: with ``HOROVOD_TRACE`` unset ``get_tracer()`` is None,
no span is made, the negotiation wire is byte for byte the untraced one,
and a hook costs one ``is None`` check. Attribution resolves no finer
than the summed clock uncertainties of the two ranks involved.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import queue as queue_mod
import time
from typing import Optional

from ..common import env as env_schema
from . import lockcheck
from . import metrics as metrics_mod

LOG = logging.getLogger("horovod_tpu_torch")

# KV-store scope workers push span buffers under (key: "rank{k}"); the
# rendezvous server's /timeline reads the same scope back.
KV_SCOPE = "trace"

# Buckets for straggler waits: sub-millisecond waits are clock noise,
# multi-second waits are real input-pipeline/compile skew.
STRAGGLER_BUCKETS_S = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
    30.0, 60.0)

# Span phase-timestamp slots (indices into Span.t). Kept as one list of
# wall-clock floats, not attributes: the hot path stamps by index and the
# serialized record is one JSON array.
T_SUBMIT = 0        # enqueue() accepted the entry
T_DRAIN = 1         # run_cycle() drained it from the queue
T_NEG_START = 2     # first negotiation round that carried it
T_NEG_END = 3       # round response marked it ready
T_DISPATCH_START = 4  # chunk assignment done, program dispatch begins
T_DISPATCH_END = 5  # dispatch returned (async launch complete)
T_DONE = 6          # _finish(): handle marked done
N_PHASES = 7

# (lane name, start slot, end slot) for the merged Chrome trace: one tid
# per lane per rank, so Perfetto shows queue/negotiate/dispatch stacks
# under each rank's process row.
PHASE_LANES = (
    ("queue", T_SUBMIT, T_DRAIN),
    ("negotiate", T_NEG_START, T_NEG_END),
    ("fuse", T_NEG_END, T_DISPATCH_START),
    ("dispatch", T_DISPATCH_START, T_DISPATCH_END),
)
OP_LANE_TID = 0  # full-span lane ("op") is always tid 0


class Span:
    """One collective's lifecycle. Allocated only when tracing is on."""

    __slots__ = ("name", "op", "round", "t", "chunk_bytes", "chunk_tensors",
                 "straggler_rank", "straggler_wait_s", "error")

    def __init__(self, name: str, op: str, now: float):
        self.name = name
        self.op = op
        self.round = -1  # negotiation round; -1 = single-process (no round)
        self.t: list[Optional[float]] = [now] + [None] * (N_PHASES - 1)
        self.chunk_bytes = 0
        self.chunk_tensors = 0
        self.straggler_rank = -1
        self.straggler_wait_s = 0.0
        self.error = False

    def to_record(self) -> dict:
        """Compact JSON form (pushed buffers, ring traffic)."""
        return {"n": self.name, "o": self.op, "r": self.round, "t": self.t,
                "cb": self.chunk_bytes, "ct": self.chunk_tensors,
                "sr": self.straggler_rank,
                "sw": round(self.straggler_wait_s, 6),
                "e": 1 if self.error else 0}


class _RingBuffer:
    """Finalized-span transport: a ``SimpleQueue`` that ``finish`` puts to
    (the cycle thread, a teardown or a rejected enqueue) and ``drain``
    empties (the dumper's thread, report callers)."""

    def __init__(self):
        self._q: queue_mod.SimpleQueue = queue_mod.SimpleQueue()

    def put(self, rec: dict):
        self._q.put(rec)

    def drain(self) -> list[dict]:
        out = []
        while True:
            try:
                out.append(self._q.get_nowait())
            except queue_mod.Empty:
                return out


class Tracer:
    """Process-global span factory + buffer. One per process, created at
    init only when HOROVOD_TRACE is set (see ``init_tracer``)."""

    def __init__(self, rank: int = 0, buffer_limit: int = 4096,
                 clock_offset_s: float = 0.0,
                 clock_uncertainty_s: Optional[float] = None):
        self.rank = rank
        self.clock_offset_s = float(clock_offset_s)
        self.clock_uncertainty_s = clock_uncertainty_s
        self._ring = _RingBuffer()
        self._spans: collections.deque = collections.deque(
            maxlen=max(int(buffer_limit), 1))  # guarded-by: _drain_lock
        self._drain_lock = lockcheck.make_lock("tracing.drain")
        # begun/finished are plain ints bumped under the GIL: begin() runs
        # on caller threads, finish() on the cycle thread; an approximate
        # read is fine (open_spans is a diagnostic, not a sync primitive)
        self.begun = 0
        self.finished = 0
        reg = metrics_mod.get_registry()
        self._m_spans = reg.counter(
            "hvd_trace_spans_total", "collective spans finalized")
        self._m_errors = reg.counter(
            "hvd_trace_span_errors_total", "spans finalized with an error")
        self._m_dropped = reg.counter(
            "hvd_trace_spans_dropped_total",
            "finalized spans dropped by a full ring")

    # -- clock --------------------------------------------------------------
    def aligned_now(self) -> float:
        """Wall clock on the rendezvous coordinator's timebase — the value
        stamped into negotiation payloads so the coordinator compares
        submit times from different ranks on one clock."""
        return time.time() + self.clock_offset_s

    # -- span lifecycle ------------------------------------------------------
    def begin(self, name: str, op: str) -> Span:
        self.begun += 1
        return Span(name, op, time.time())

    def finish(self, span: Span, error: bool = False):
        """Terminal: stamp T_DONE, serialize into the ring. Called from
        every _finish path (success, negotiation error, stall shutdown,
        runtime teardown) so started spans never leak."""
        if error:
            span.error = True
        span.t[T_DONE] = time.time()
        self.finished += 1
        self._m_spans.inc()
        if span.error:
            self._m_errors.inc()
        try:
            self._ring.put(span.to_record())
        except Exception:
            self._m_dropped.inc()

    def open_spans(self) -> int:
        return self.begun - self.finished

    # -- buffer access -------------------------------------------------------
    def drain(self) -> None:
        """Move finalized spans from the ring into the bounded deque."""
        with self._drain_lock:
            for rec in self._ring.drain():
                self._spans.append(rec)

    def records(self) -> list[dict]:
        self.drain()
        # the copy must also hold the lock: a dumper-thread drain()
        # appending mid-iteration is a RuntimeError on a deque
        with self._drain_lock:
            return list(self._spans)

    def snapshot(self) -> dict:
        """Pushed-buffer form: rank identity + clock calibration + spans.
        The offset rides every push so the merge can align buffers even
        when ranks estimated their offsets at different times."""
        return {"rank": self.rank,
                "clock_offset_s": self.clock_offset_s,
                "clock_uncertainty_s": self.clock_uncertainty_s,
                "spans": self.records()}


# ---------------------------------------------------------------------------
# Clock-offset estimation (NTP-style, against GET /clock)
# ---------------------------------------------------------------------------

def estimate_clock_offset(addr: str, port: int, probes: int = 5,
                          timeout: float = 5.0) -> tuple[float, float]:
    """A few KV round-trip probes against the rendezvous server's
    auth-exempt ``GET /clock``; returns ``(offset_s, uncertainty_s)`` from
    the minimum-RTT probe (offset = server_t - midpoint(t0, t1),
    uncertainty = rtt / 2 — the server read can fall anywhere inside the
    round trip). Raises if every probe fails."""
    import urllib.request

    best: Optional[tuple[float, float]] = None
    last_err: Optional[Exception] = None
    for _ in range(max(int(probes), 1)):
        try:
            t0 = time.time()
            with urllib.request.urlopen(
                    f"http://{addr}:{int(port)}/clock",
                    timeout=timeout) as resp:
                server_t = float(json.loads(resp.read())["t"])
            t1 = time.time()
        except Exception as e:
            last_err = e
            continue
        rtt = t1 - t0
        offset = server_t - (t0 + t1) / 2.0
        if best is None or rtt < best[1]:
            best = (offset, rtt)
    if best is None:
        raise RuntimeError(f"clock-offset estimation failed: {last_err}")
    return best[0], best[1] / 2.0


# ---------------------------------------------------------------------------
# Process-global tracer
# ---------------------------------------------------------------------------

_TRACER: Optional[Tracer] = None


def enabled() -> bool:
    return env_schema.get_bool(env_schema.HOROVOD_TRACE)


def get_tracer() -> Optional[Tracer]:
    """The hot-path gate: None when tracing is off — call sites hold the
    result and guard with ``is not None`` (no env read per event)."""
    return _TRACER


def init_tracer(rank: int = 0, addr: Optional[str] = None,
                port: Optional[int] = None) -> Optional[Tracer]:
    """Create the process tracer iff HOROVOD_TRACE is set. When a
    rendezvous endpoint is given, estimate the clock offset against it;
    HOROVOD_TRACE_CLOCK_OFFSET overrides the estimate. Idempotent per
    process shape: re-init replaces the tracer (elastic reinit gets a
    fresh buffer; the metrics it feeds are process-lifetime)."""
    global _TRACER
    if not enabled():
        return _TRACER
    offset, uncertainty = 0.0, None
    override = os.environ.get(env_schema.HOROVOD_TRACE_CLOCK_OFFSET)
    if override is not None:
        try:
            offset = float(override)
            uncertainty = 0.0
        except ValueError:
            LOG.warning("invalid %s=%r ignored",
                        env_schema.HOROVOD_TRACE_CLOCK_OFFSET, override)
    elif addr and port:
        try:
            offset, uncertainty = estimate_clock_offset(addr, int(port))
        except Exception as e:
            # best-effort: an unaligned trace is still a trace
            LOG.warning("clock-offset estimation failed (%s); spans from "
                        "this rank merge unaligned", e)
    _TRACER = Tracer(
        rank=rank,
        buffer_limit=env_schema.get_int(env_schema.HOROVOD_TRACE_BUFFER,
                                        4096),
        clock_offset_s=offset, clock_uncertainty_s=uncertainty)
    LOG.info("tracing enabled: rank=%d clock_offset=%+.6fs uncertainty=%s",
             rank, offset,
             f"{uncertainty:.6f}s" if uncertainty is not None else "n/a")
    return _TRACER


def reset_tracer():
    """Drop the process tracer (tests / benchmarks only)."""
    global _TRACER
    _TRACER = None


# ---------------------------------------------------------------------------
# Merged Chrome trace + reports
# ---------------------------------------------------------------------------

def merge_chrome_trace(buffers: list[dict],
                       anatomy: Optional[list[dict]] = None) -> dict:
    """Merge per-rank span buffers (``Tracer.snapshot()`` dicts) into one
    Chrome trace-event object: pid = rank, tid 0 the full op span, one tid
    per phase lane, all timestamps shifted by the buffer's clock offset
    into the rendezvous coordinator's timebase (microseconds).

    ``anatomy`` optionally carries per-rank step-anatomy snapshots
    (``AnatomyProfiler.snapshot()`` dicts): their chunk entities render
    on one extra "anatomy" lane per rank (shifted by that rank's trace
    clock offset when a trace buffer supplied one) and the merged
    ``horovod`` block gains a per-rank ``critical_path`` summary."""
    events: list[dict] = []
    ranks_meta: dict[str, dict] = {}
    straggler_counts: dict[str, int] = {}
    total_wait = 0.0
    for buf in buffers:
        try:
            rank = int(buf["rank"])
            spans = buf.get("spans", [])
        except (KeyError, TypeError, ValueError):
            continue  # half-written push: skip, next scrape catches up
        offset = float(buf.get("clock_offset_s") or 0.0)
        ranks_meta[str(rank)] = {
            "clock_offset_s": offset,
            "clock_uncertainty_s": buf.get("clock_uncertainty_s"),
            "spans": len(spans)}
        events.append({"ph": "M", "pid": rank, "tid": 0,
                       "name": "process_name",
                       "args": {"name": f"rank {rank}"}})
        events.append({"ph": "M", "pid": rank, "tid": OP_LANE_TID,
                       "name": "thread_name", "args": {"name": "op"}})
        for i, (lane, _, _) in enumerate(PHASE_LANES):
            events.append({"ph": "M", "pid": rank, "tid": i + 1,
                           "name": "thread_name", "args": {"name": lane}})
        for rec in spans:
            t = rec.get("t")
            if not t or t[T_SUBMIT] is None:
                continue
            us = [(x + offset) * 1e6 if x is not None else None for x in t]
            args = {"op": rec.get("o"), "round": rec.get("r"),
                    "chunk_bytes": rec.get("cb"),
                    "chunk_tensors": rec.get("ct"),
                    "error": bool(rec.get("e"))}
            sr = rec.get("sr", -1)
            if sr is not None and sr >= 0:
                args["straggler_rank"] = sr
                args["straggler_wait_s"] = rec.get("sw", 0.0)
                straggler_counts[str(sr)] = \
                    straggler_counts.get(str(sr), 0) + 1
                total_wait += float(rec.get("sw") or 0.0)
            end = us[T_DONE] if us[T_DONE] is not None else us[T_SUBMIT]
            events.append({"ph": "X", "pid": rank, "tid": OP_LANE_TID,
                           "name": rec.get("n", "?"), "cat": "collective",
                           "ts": us[T_SUBMIT],
                           "dur": max(end - us[T_SUBMIT], 0.0),
                           "args": args})
            for i, (lane, s0, s1) in enumerate(PHASE_LANES):
                if us[s0] is None or us[s1] is None:
                    continue
                events.append({"ph": "X", "pid": rank, "tid": i + 1,
                               "name": f"{rec.get('n', '?')}:{lane}",
                               "cat": lane, "ts": us[s0],
                               "dur": max(us[s1] - us[s0], 0.0)})
    out = {"traceEvents": events, "displayTimeUnit": "ms",
           "horovod": {"ranks": ranks_meta,
                       "stragglers": {"last_rank_counts": straggler_counts,
                                      "total_wait_s": round(total_wait, 6)}}}
    if anatomy:
        offsets = {r: m.get("clock_offset_s") or 0.0
                   for r, m in ranks_meta.items()}
        anatomy_tid = len(PHASE_LANES) + 1
        critical: dict[str, dict] = {}
        for buf in anatomy:
            try:
                rank = int(buf["rank"])
            except (KeyError, TypeError, ValueError):
                continue  # half-written push: skip, next poll catches up
            offset = float(offsets.get(str(rank), 0.0))
            cp = buf.get("critical_path")
            if isinstance(cp, dict):
                critical[str(rank)] = cp
            lanes = buf.get("lanes") or []
            if lanes:
                events.append({"ph": "M", "pid": rank, "tid": anatomy_tid,
                               "name": "thread_name",
                               "args": {"name": "anatomy"}})
            for ent in lanes:
                try:
                    ts0 = float(ent["ts0"])
                    dur = float(ent.get("dur_s") or 0.0)
                except (KeyError, TypeError, ValueError):
                    continue
                events.append({"ph": "X", "pid": rank, "tid": anatomy_tid,
                               "name": str(ent.get("name", "?")),
                               "cat": "anatomy",
                               "ts": (ts0 + offset) * 1e6,
                               "dur": max(dur * 1e6, 0.0)})
        out["horovod"]["critical_path"] = critical
    return out


def _percentile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[i]


def _phase_summary(records: list[dict], s0: int, s1: int) -> Optional[dict]:
    vals = sorted(
        rec["t"][s1] - rec["t"][s0] for rec in records
        if rec.get("t") and rec["t"][s0] is not None
        and rec["t"][s1] is not None)
    if not vals:
        return None
    return {"count": len(vals),
            "p50_ms": round(_percentile(vals, 0.50) * 1e3, 4),
            "p95_ms": round(_percentile(vals, 0.95) * 1e3, 4),
            "max_ms": round(vals[-1] * 1e3, 4)}


def report() -> dict:
    """``hvd.trace_report()``: per-phase latency percentiles + straggler
    attribution over the tracer's buffered spans. ``{"enabled": False}``
    when tracing is off."""
    tracer = get_tracer()
    if tracer is None:
        return {"enabled": False}
    records = tracer.records()
    phases = {}
    for lane, s0, s1 in PHASE_LANES + (("total", T_SUBMIT, T_DONE),):
        s = _phase_summary(records, s0, s1)
        if s is not None:
            phases[lane] = s
    waits = sorted(r.get("sw", 0.0) for r in records
                   if r.get("sr", -1) is not None and r.get("sr", -1) >= 0)
    last_counts: dict[str, int] = {}
    for r in records:
        sr = r.get("sr", -1)
        if sr is not None and sr >= 0:
            last_counts[str(sr)] = last_counts.get(str(sr), 0) + 1
    out = {"enabled": True, "rank": tracer.rank,
           "clock_offset_s": tracer.clock_offset_s,
           "clock_uncertainty_s": tracer.clock_uncertainty_s,
           "spans": len(records),
           "open_spans": tracer.open_spans(),
           "errors": sum(1 for r in records if r.get("e")),
           "phases": phases}
    if waits:
        out["straggler"] = {
            "attributed_spans": len(waits),
            "last_rank_counts": last_counts,
            "wait_p50_ms": round(_percentile(waits, 0.50) * 1e3, 4),
            "wait_p95_ms": round(_percentile(waits, 0.95) * 1e3, 4),
            "wait_max_ms": round(waits[-1] * 1e3, 4)}
    return out
