"""Step-anatomy profiler: per-entity critical path and headroom — a copy
of ``horovod_tpu/utils/anatomy.py``.

A bounded ring of one record a working cycle, each a list of entities:
every dispatched chunk (named after its head tensor, ``grad_0+3``), the
negotiation round (named after the tensors it carried, with the slice of
it spent waiting on a straggler), the host gap outside both, and a
replayed megaplan's one chained dispatch. Each entity has its span, the
host-blocking window around its dispatch or round, and its exposed
seconds; the record names the critical entity and two Amdahl-style
what-ifs: ``overlap_headroom_s`` (the dispatch windows, were they fully
overlapped with compute) and ``replay_headroom_s`` (negotiation and the
host gap, which a megaplan replay removes).

On the card a chunk also gets ``device_s``, the comm stream's time from
the event before its first kernel to its done event, read with
``Event.query()`` and ``elapsed_time`` when the done event reports done,
on the cycle thread or a reader's, never with a synchronize
(``EventToken``; the JAX package polls a completion array and reports the
poll's host interval). It is context, never folded into the critical
path.

Exposure: ``hvd.anatomy_report()``, lazy ``hvd_anatomy_*`` series, the
``anatomy/rank{k}`` push the launcher's ``GET /anatomy`` merges, and an
``anatomy`` lane a rank with a ``critical_path`` summary in its
``GET /timeline``.

Zero-cost contract: with ``HOROVOD_ANATOMY`` unset no profiler exists, a
hook costs one ``is None`` check, and no ``hvd_anatomy_*`` series is
registered.
"""

from __future__ import annotations

import collections
import time
from typing import List, Optional, Sequence, Tuple

from ..common import env as env_schema
from . import lockcheck

#: KV scope the MetricsDumper pushes per-rank profiler snapshots under
#: (``anatomy/rank{k}``); the launcher's ``GET /anatomy`` merges it.
KV_SCOPE = "anatomy"

DEFAULT_CAPACITY = 512

#: Newest chunk entities carried in a snapshot as Perfetto lane events
#: (``GET /timeline`` renders them on a per-rank "anatomy" lane).
LANE_LIMIT = 200

#: Entity kinds a step decomposes into. ``chunk`` spans are dispatch
#: windows of fused/quantized/single-tensor plans; ``negotiate`` is the
#: controller round (carrying any coordinator-attributed stall slice);
#: ``host_gap`` is wall time outside both; ``compile`` (the JAX package's
#: compile seconds) never occurs here; ``megaplan`` is a whole-step
#: replay's single chained dispatch (ops/megaplan.py) — the step had no
#: per-chunk dispatch windows to decompose into.
KINDS = ("chunk", "negotiate", "host_gap", "compile", "megaplan")


def _entity_name(names: Sequence[str], prefix: str = "") -> str:
    """Stable display name for a (possibly fused) group of tensors:
    the head tensor plus a ``+N`` rider count, e.g. ``grad_0+3``."""
    if not names:
        return prefix or "anon"
    head = str(names[0])
    if len(names) > 1:
        head = f"{head}+{len(names) - 1}"
    return f"{prefix}{head}"


class EventToken:
    """A chunk's completion on the card: an event recorded on the comm
    stream before its first kernel and its done event after the last,
    both timed. ``is_ready`` queries the done event; ``device_s`` is the
    time between the two, valid once ``is_ready``."""

    __slots__ = ("start", "done")

    def __init__(self, start, done):
        self.start = start
        self.done = done

    def is_ready(self) -> bool:
        return self.done.query()

    def device_s(self) -> float:
        return self.start.elapsed_time(self.done) / 1e3


class AnatomyProfiler:
    """Bounded ring of per-step entity timelines.

    ``note_chunk()`` and ``record_step()`` run on the background cycle
    thread (``_cycle_chunks`` is cycle-thread-only scratch, no lock);
    readers copy the ring under the lock. Completion tokens are polled
    lazily — on the next ``record_step()`` or snapshot — so the hot
    path never blocks on a device array.
    """

    def __init__(self, rank: int = 0, capacity: int = DEFAULT_CAPACITY):
        self.rank = rank
        self.capacity = max(int(capacity), 16)
        self._lock = lockcheck.make_lock("anatomy.ring")
        self._ring = collections.deque(maxlen=self.capacity)  # guarded-by: _lock
        self._total = 0  # guarded-by: _lock
        # chunk entities noted by the dispatch hooks since the last
        # record_step(); cycle-thread-only scratch, flushed per step
        self._cycle_chunks: List[Tuple[dict, object, float]] = []
        # unresolved completion tokens: (entity, token, t0_perf_counter)
        self._outstanding: List[Tuple[dict, object, float]] = []  # guarded-by: _lock
        from . import metrics as metrics_mod

        reg = metrics_mod.get_registry()
        self._m_steps = reg.counter(
            "hvd_anatomy_steps_total",
            "steps recorded by the step-anatomy profiler")
        self._m_entities = reg.counter(
            "hvd_anatomy_entities_total",
            "timeline entities (chunks/negotiate/host_gap/compile) recorded")
        self._m_exposed = reg.counter(
            "hvd_anatomy_exposed_seconds_total",
            "seconds of step wall time exposed to communication "
            "(negotiation rounds plus host-blocking dispatch windows)")
        self._m_overlap = reg.counter(
            "hvd_anatomy_overlap_headroom_seconds_total",
            "cumulative step seconds recoverable by fully overlapping "
            "dispatched collectives with compute (the overlap ceiling)")
        self._m_replay = reg.counter(
            "hvd_anatomy_replay_headroom_seconds_total",
            "cumulative step seconds recoverable by eliminating "
            "negotiation + host gap via plan replay (the replay ceiling)")
        self._m_crit = reg.histogram(
            "hvd_anatomy_critical_span_seconds",
            "span of the per-step critical-path entity",
            buckets=metrics_mod.LATENCY_BUCKETS_S)

    # -- hot-path hooks (cycle thread) ---------------------------------

    def note_chunk(self, names: Sequence[str], nbytes: int, tensors: int,
                   dispatch_s: float, token=None,
                   t0_pc: Optional[float] = None) -> None:
        """One dispatched chunk: ``dispatch_s`` is the measured
        host-blocking execute window, ``token`` the chunk's
        ``EventToken`` on the card (None on the CPU). Called between
        ``record_step()``s on the cycle thread."""
        dispatch_s = max(float(dispatch_s), 0.0)
        ent = {"kind": "chunk", "name": _entity_name(names),
               "bytes": int(nbytes), "tensors": int(tensors),
               "span_s": dispatch_s, "exposed_s": dispatch_s,
               "device_done": token is None,
               "ts0": time.time() - dispatch_s}
        self._cycle_chunks.append(
            (ent, token, t0_pc if t0_pc is not None else time.perf_counter()))

    def note_megaplan(self, names: Sequence[str], nbytes: int,
                      tensors: int, dispatch_s: float, token=None,
                      t0_pc: Optional[float] = None) -> None:
        """One whole-step megaplan replay (ops/megaplan.py): the entire
        captured schedule rode a single chained dispatch, so the step
        contributes one ``megaplan`` entity instead of per-chunk spans —
        GET /timeline renders it as its own lane."""
        dispatch_s = max(float(dispatch_s), 0.0)
        ent = {"kind": "megaplan",
               "name": _entity_name(names, prefix="megaplan:"),
               "bytes": int(nbytes), "tensors": int(tensors),
               "span_s": dispatch_s, "exposed_s": dispatch_s,
               "device_done": token is None,
               "ts0": time.time() - dispatch_s}
        self._cycle_chunks.append(
            (ent, token, t0_pc if t0_pc is not None else time.perf_counter()))

    def record_step(self, wall_s: float, negotiate_s: float = 0.0,
                    dispatch_s: float = 0.0, tensors: int = 0,
                    names: Sequence[str] = (),
                    straggler: Optional[Tuple[int, float]] = None) -> dict:
        """Close one step: fold the cycle's chunk entities plus the
        negotiation round and host gap into a record, derive critical
        path and headroom, and append it."""
        wall_s = max(float(wall_s), 0.0)
        negotiate_s = min(max(float(negotiate_s), 0.0), wall_s)
        dispatch_s = max(float(dispatch_s), 0.0)
        chunks = self._cycle_chunks
        self._cycle_chunks = []
        now = time.time()

        entities: List[dict] = [c[0] for c in chunks]
        stall_s = 0.0
        strag_rank: Optional[int] = None
        if straggler is not None:
            strag_rank = int(straggler[0])
            if strag_rank != self.rank:
                # exposed wait on someone else; own lateness is own
                # negotiate time (same convention as the perf ledger)
                stall_s = min(max(float(straggler[1]), 0.0), negotiate_s)
        ent_neg = {"kind": "negotiate",
                   "name": _entity_name(names, prefix="negotiate:"),
                   "span_s": negotiate_s, "exposed_s": negotiate_s,
                   "stall_s": round(stall_s, 6),
                   "straggler_rank": strag_rank,
                   "ts0": now - wall_s}
        entities.append(ent_neg)
        host_gap_s = max(wall_s - negotiate_s - dispatch_s, 0.0)
        if host_gap_s > 0.0:
            entities.append({"kind": "host_gap", "name": "host_gap",
                             "span_s": host_gap_s, "exposed_s": 0.0,
                             "ts0": now - host_gap_s})
        chunk_span = sum(e["span_s"] for e in entities
                         if e["kind"] in ("chunk", "megaplan"))
        # every background-queue collective is overlappable: consumers
        # block in synchronize(), not at dispatch, so its host-blocking
        # window is pure headroom for an overlap scheduler
        overlap_headroom = min(chunk_span, wall_s)
        replay_headroom = min(negotiate_s + host_gap_s, wall_s)
        critical = max(entities, key=lambda e: e["span_s"])
        exposed_s = negotiate_s + chunk_span
        rec = {"ts": now, "wall_s": wall_s,
               "negotiate_s": round(negotiate_s, 6),
               "dispatch_s": round(dispatch_s, 6),
               "host_gap_s": round(host_gap_s, 6),
               # the JAX package's compile seconds: the port builds its
               # kernels before a run, so a step compiles nothing
               "compile_s": 0.0,
               "stall_s": round(stall_s, 6),
               "straggler_rank": strag_rank,
               "tensors": int(tensors),
               "exposed_s": round(exposed_s, 6),
               "overlap_headroom_s": round(overlap_headroom, 6),
               "replay_headroom_s": round(replay_headroom, 6),
               "critical": critical["name"],
               "critical_kind": critical["kind"],
               "critical_span_s": round(critical["span_s"], 6),
               "entities": entities}
        with self._lock:
            self._ring.append(rec)
            self._total += 1
            for ent, token, t0 in chunks:
                if token is not None:
                    self._outstanding.append((ent, token, t0))
            self._outstanding = self._poll_tokens(self._outstanding)
        self._m_steps.inc()
        self._m_entities.inc(len(entities))
        self._m_exposed.inc(exposed_s)
        self._m_overlap.inc(overlap_headroom)
        self._m_replay.inc(replay_headroom)
        self._m_crit.observe(critical["span_s"])
        return rec

    # -- token resolution ----------------------------------------------

    def _poll_tokens(self, outstanding):
        """Resolve completion tokens that have become ready; returns the
        entries still pending (the caller holds ``_lock`` and reassigns
        ``_outstanding``). ``device_s`` is the token's event time on the
        card (``EventToken.device_s``)."""
        if not outstanding:
            return outstanding
        now_pc = time.perf_counter()
        still: List[Tuple[dict, object, float]] = []
        for ent, token, t0 in outstanding:
            try:
                ready = bool(token.is_ready())
            except Exception:
                ready = True  # a failed query: nothing left to wait on
            if ready:
                ent["device_done"] = True
                try:
                    dev = token.device_s()
                except Exception:
                    dev = now_pc - t0  # no timed events: the host poll
                ent["device_s"] = round(max(dev, 0.0), 6)
            else:
                still.append((ent, token, t0))
        # bound the unresolved set: a wedged device must not grow a list
        del still[:max(len(still) - self.capacity, 0)]
        return still

    # -- readers --------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def records(self, last: Optional[int] = None) -> List[dict]:
        """Ring contents, oldest first (``last`` keeps the newest N)."""
        with self._lock:
            self._outstanding = self._poll_tokens(self._outstanding)
            recs = list(self._ring)
        if last is not None:
            recs = recs[-int(last):]
        return recs

    def entity_table(self, records: Optional[List[dict]] = None) -> dict:
        """Per-entity aggregate: name -> {kind, count, span_s,
        exposed_s, critical_steps} over the ring (or a window)."""
        recs = self.records() if records is None else records
        table: dict = {}
        for rec in recs:
            for ent in rec["entities"]:
                row = table.setdefault(
                    ent["name"], {"kind": ent["kind"], "count": 0,
                                  "span_s": 0.0, "exposed_s": 0.0,
                                  "critical_steps": 0})
                row["count"] += 1
                row["span_s"] += ent["span_s"]
                row["exposed_s"] += ent.get("exposed_s", 0.0)
            table[rec["critical"]]["critical_steps"] += 1
        for row in table.values():
            row["span_s"] = round(row["span_s"], 6)
            row["exposed_s"] = round(row["exposed_s"], 6)
        return table

    def critical_path(self, records: Optional[List[dict]] = None) -> dict:
        """Which entity bounds the most steps (tie broken by total
        span): the one-line answer ``GET /timeline`` surfaces."""
        recs = self.records() if records is None else records
        if not recs:
            return {"top_entity": None, "kind": None, "critical_steps": 0,
                    "steps": 0, "share": 0.0}
        table = self.entity_table(records=recs)
        name, row = max(table.items(),
                        key=lambda kv: (kv[1]["critical_steps"],
                                        kv[1]["span_s"]))
        return {"top_entity": name, "kind": row["kind"],
                "critical_steps": row["critical_steps"],
                "steps": len(recs),
                "share": round(row["critical_steps"] / len(recs), 6)}

    def headroom(self, records: Optional[List[dict]] = None) -> dict:
        """Amdahl-style what-if numbers over the ring: mean per-step and
        cumulative seconds recoverable by (a) fully overlapping
        dispatched collectives and (b) replaying plans to eliminate
        negotiation + host gap."""
        recs = self.records() if records is None else records
        if not recs:
            return {"overlap_headroom_s": 0.0, "replay_headroom_s": 0.0,
                    "overlap_headroom_total_s": 0.0,
                    "replay_headroom_total_s": 0.0, "steps": 0}
        ov = sum(r["overlap_headroom_s"] for r in recs)
        rp = sum(r["replay_headroom_s"] for r in recs)
        return {"overlap_headroom_s": round(ov / len(recs), 6),
                "replay_headroom_s": round(rp / len(recs), 6),
                "overlap_headroom_total_s": round(ov, 6),
                "replay_headroom_total_s": round(rp, 6),
                "steps": len(recs)}

    def lanes(self, records: Optional[List[dict]] = None) -> List[dict]:
        """Newest chunk entities as Perfetto-lane events for the
        ``GET /timeline`` merge: {name, ts0 (epoch s), dur_s, kind}."""
        recs = self.records() if records is None else records
        out: List[dict] = []
        for rec in recs:
            for ent in rec["entities"]:
                if ent["kind"] not in ("chunk", "megaplan"):
                    continue
                out.append({"name": ent["name"], "ts0": ent["ts0"],
                            "dur_s": ent["span_s"], "kind": ent["kind"]})
        return out[-LANE_LIMIT:]

    def snapshot(self) -> dict:
        """Push payload for ``anatomy/rank{k}`` (compact: aggregates,
        the newest few records with trimmed entity lists, and the lane
        events — not the whole ring)."""
        recs = self.records()
        with self._lock:
            total = self._total
            inflight = len(self._outstanding)
        recent = []
        for rec in recs[-5:]:
            slim = dict(rec)
            slim["entities"] = sorted(
                rec["entities"], key=lambda e: e["span_s"], reverse=True)[:8]
            recent.append(slim)
        return {"rank": self.rank, "steps": total,
                "inflight_tokens": inflight,
                "entities": self.entity_table(records=recs),
                "critical_path": self.critical_path(records=recs),
                "headroom": self.headroom(records=recs),
                "recent": recent,
                "lanes": self.lanes(records=recs)}

    def report(self) -> dict:
        """``hvd.anatomy_report()`` body for this rank."""
        out = self.snapshot()
        out["enabled"] = True
        out["capacity"] = self.capacity
        return out


# --------------------------------------------------------------------------
# Process-global profiler (the utils/perfledger.py module-trio pattern):
# get_profiler() returns None when HOROVOD_ANATOMY is off, and every hook
# site costs exactly one is-None check in that state.
# --------------------------------------------------------------------------

_PROFILER: Optional[AnatomyProfiler] = None


def enabled() -> bool:
    return env_schema.get_bool(env_schema.HOROVOD_ANATOMY)


def get_profiler() -> Optional[AnatomyProfiler]:
    return _PROFILER


def init_profiler(rank: int = 0) -> Optional[AnatomyProfiler]:
    """Create the process profiler when ``HOROVOD_ANATOMY`` is set
    (idempotent); no-op returning None when off."""
    global _PROFILER
    if not enabled():
        return _PROFILER
    if _PROFILER is None:
        capacity = env_schema.get_int(env_schema.HOROVOD_ANATOMY_BUFFER,
                                      DEFAULT_CAPACITY)
        _PROFILER = AnatomyProfiler(rank=rank, capacity=capacity)
    return _PROFILER


def reset_profiler() -> None:
    """Drop the process profiler (test/bench helper)."""
    global _PROFILER
    _PROFILER = None


def report() -> dict:
    """``hvd.anatomy_report()`` body: ``{"enabled": False}`` when the
    profiler is off, else this rank's entity table, critical path and
    headroom estimates."""
    profiler = _PROFILER
    if profiler is None:
        return {"enabled": False}
    return profiler.report()
