"""Per-step performance ledger and the SLO budget engine — a copy of
``horovod_tpu/utils/perfledger.py``.

A bounded ring of one record a working cycle, built from what the runtime
already observes: the cycle's phase stamps (``ops/queue.py``), the
counters' deltas (``hvd_allreduce_bytes_total``, the controller's wire
bytes, the fused plans' hits and misses) and the coordinator's straggler
verdict. Each record splits the cycle's wall time into five phases,
``negotiate``, ``fuse_dispatch``, ``device_exec``, ``stall`` and
``host_overhead``, which sum to it; the snapshot derives goodput from the
ring (allreduce GB/s, the exposed-communication fraction, wire bytes a
step, the plan hit rate), and ``window_score`` is the autotuner's
objective. On the card ``device_exec`` is the host's time inside a
chunk's dispatch, which queues kernels and returns: the card's own time
is the anatomy's ``device_s``.

Exposure: lazy ``hvd_perf_*`` series, ``hvd.perf_report()``, and the
``perf/rank{k}`` push the launcher's ``GET /perf`` merges.

``HOROVOD_SLO_SPEC`` declares budgets over the same stats in three
grammars: inline (``negotiate_p95_ms<=5,plan_hit_rate>=0.95``), a JSON
object (``{"negotiate_p95_ms": "<=5"}``), or the path of a file holding
either. The engine evaluates them over each new window of records on the
``MetricsDumper``'s cadence; a breach fires once a breach window
(``hvd_slo_breach_total{budget}``, a ``slo_breach`` flight-recorder note,
a warning through the stall inspector naming the suspect rank).

Zero-cost contract: with ``HOROVOD_PERFLEDGER`` unset no ledger exists, a
hook costs one ``is None`` check, and no ``hvd_perf_*``/``hvd_slo_*``
series is registered.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import time
from typing import List, Optional, Tuple

from ..common import env as env_schema
from . import flightrec as flightrec_mod
from . import lockcheck

LOG = logging.getLogger("horovod_tpu_torch")

#: KV scope the MetricsDumper pushes per-rank ledger snapshots under
#: (``perf/rank{k}``); the launcher's ``GET /perf`` merges the scope.
KV_SCOPE = "perf"

DEFAULT_CAPACITY = 1024

#: The five phases every step's wall time is decomposed into. ``stall``
#: is the slice of the negotiation round spent waiting on a coordinator-
#: attributed straggler (zero when this rank *was* the straggler — its
#: round time is its own negotiate phase, not exposed waiting).
PHASES = ("negotiate", "fuse_dispatch", "device_exec", "stall",
          "host_overhead")

#: Counters whose per-step deltas each record carries: (record key,
#: metric family). Reads go through ``MetricsRegistry.counter_value``,
#: which sums across label sets, so the dtype-labelled byte counters
#: collapse to one number per step.
_DELTA_COUNTERS = (
    ("wire_bytes", "hvd_allreduce_bytes_total"),
    ("control_bytes", "hvd_controller_wire_bytes_total"),
    ("plan_hits", "hvd_fused_plan_hits_total"),
    ("plan_misses", "hvd_fused_plan_misses_total"),
    ("staging_reuse", "hvd_staging_reuse_total"),
)


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted list (same
    convention as utils/tracing.py so /perf and /timeline agree)."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


class PerfLedger:
    """Bounded ring of per-step phase/goodput records.

    ``record_step()`` is the only hot method and is called once per
    *working* background cycle (idle cycles don't record) from the cycle
    thread; readers copy the ring under the lock.
    """

    def __init__(self, rank: int = 0, capacity: int = DEFAULT_CAPACITY):
        self.rank = rank
        self.capacity = max(int(capacity), 16)
        self._lock = lockcheck.make_lock("perfledger.ring")
        self._ring = collections.deque(maxlen=self.capacity)  # guarded-by: _lock
        self._total = 0  # guarded-by: _lock
        # counter baselines for per-step deltas; cycle-thread-only
        self._last_counters: dict = {}
        # running sums behind the goodput gauges (process lifetime, not
        # ring-windowed: a gauge that forgets history on wraparound lies)
        self._sum_wall = 0.0  # guarded-by: _lock
        self._sum_comm = 0.0  # guarded-by: _lock
        self._sum_exec = 0.0  # guarded-by: _lock
        self._sum_wire = 0.0  # guarded-by: _lock
        from . import metrics as metrics_mod

        reg = metrics_mod.get_registry()
        self._m_steps = reg.counter(
            "hvd_perf_steps_total", "steps recorded by the perf ledger")
        self._m_step_s = reg.histogram(
            "hvd_perf_step_seconds", "per-step wall time",
            buckets=metrics_mod.LATENCY_BUCKETS_S)
        self._m_phase = {
            p: reg.histogram(
                "hvd_perf_phase_seconds",
                "per-step wall time attributed to one phase",
                buckets=metrics_mod.LATENCY_BUCKETS_S, phase=p)
            for p in PHASES}
        self._m_wire = reg.histogram(
            "hvd_perf_step_wire_bytes", "data-plane wire bytes per step",
            buckets=metrics_mod.SIZE_BUCKETS_BYTES)
        self._m_exposed = reg.gauge(
            "hvd_perf_exposed_comm_ratio",
            "fraction of recorded wall time exposed to communication "
            "(negotiate + stall phases)")
        self._m_gbps = reg.gauge(
            "hvd_perf_allreduce_gbps",
            "effective allreduce goodput: wire bytes over device-exec "
            "seconds")
        self._m_hit = reg.gauge(
            "hvd_perf_plan_hit_rate",
            "cumulative fused-plan cache hit rate seen by the ledger")

    def _counter_deltas(self) -> dict:
        from . import metrics as metrics_mod

        reg = metrics_mod.get_registry()
        sums = reg.counter_values([f for _, f in _DELTA_COUNTERS])
        out = {}
        for key, family in _DELTA_COUNTERS:
            cur = sums[family]
            prev = self._last_counters.get(key, cur)
            self._last_counters[key] = cur
            # registry resets (tests) would otherwise show as a huge
            # negative step; clamp to zero instead
            out[key] = max(cur - prev, 0.0)
        return out

    def record_step(self, wall_s: float, negotiate_s: float = 0.0,
                    dispatch_s: float = 0.0, exec_s: float = 0.0,
                    tensors: int = 0,
                    straggler: Optional[Tuple[int, float]] = None) -> dict:
        """Append one step record.

        ``negotiate_s`` is the negotiation-round wall time,
        ``dispatch_s`` the whole dispatch-loop host time and ``exec_s``
        the execute window inside it; ``straggler`` is the coordinator's
        ``(rank, wait_s)`` verdict for this round when tracing computed
        one. The phase split and counter deltas are derived here so the
        queue hook stays four perf_counter() reads.
        """
        wall_s = max(float(wall_s), 0.0)
        negotiate_s = min(max(float(negotiate_s), 0.0), wall_s)
        dispatch_s = max(float(dispatch_s), 0.0)
        exec_s = min(max(float(exec_s), 0.0), dispatch_s)
        stall_s = 0.0
        strag_rank = None
        strag_wait = 0.0
        if straggler is not None:
            strag_rank = int(straggler[0])
            strag_wait = max(float(straggler[1]), 0.0)
            if strag_rank != self.rank:
                # exposed wait on someone else; our own lateness is our
                # own negotiate time, not a stall
                stall_s = min(strag_wait, negotiate_s)
        phases = {
            "negotiate": negotiate_s - stall_s,
            "fuse_dispatch": max(dispatch_s - exec_s, 0.0),
            "device_exec": exec_s,
            "stall": stall_s,
            "host_overhead": max(wall_s - negotiate_s - dispatch_s, 0.0),
        }
        rec = {"ts": time.time(), "tensors": int(tensors),
               "wall_s": wall_s,
               # the JAX package's compile seconds: the port builds its
               # kernels before a run, so a step compiles nothing
               "compile_s": 0.0,
               "straggler_rank": strag_rank,
               "straggler_wait_s": round(strag_wait, 6)}
        for p in PHASES:
            rec[p + "_s"] = phases[p]
        rec.update(self._counter_deltas())
        with self._lock:
            self._ring.append(rec)
            self._total += 1
            self._sum_wall += wall_s
            self._sum_comm += negotiate_s  # negotiate phase + stall
            self._sum_exec += exec_s
            self._sum_wire += rec["wire_bytes"]
            sum_wall, sum_comm = self._sum_wall, self._sum_comm
            sum_exec, sum_wire = self._sum_exec, self._sum_wire
        self._m_steps.inc()
        self._m_step_s.observe(wall_s)
        for p in PHASES:
            self._m_phase[p].observe(phases[p])
        self._m_wire.observe(rec["wire_bytes"])
        if sum_wall > 0:
            self._m_exposed.set(sum_comm / sum_wall)
        if sum_exec > 0:
            self._m_gbps.set(sum_wire / sum_exec / 1e9)
        hits = self._last_counters.get("plan_hits", 0.0)
        misses = self._last_counters.get("plan_misses", 0.0)
        if hits + misses > 0:
            self._m_hit.set(hits / (hits + misses))
        return rec

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def records(self, last: Optional[int] = None) -> List[dict]:
        """The ring's contents, oldest first (``last`` keeps the newest N)."""
        with self._lock:
            recs = list(self._ring)
        if last is not None:
            recs = recs[-int(last):]
        return recs

    def records_since(self, cursor: int) -> Tuple[int, List[dict]]:
        """Records appended after position ``cursor`` (a value previously
        returned by this method; start from 0), plus the new cursor.
        Records evicted by ring wraparound in between are simply gone —
        the SLO engine evaluates what survived, it does not block."""
        with self._lock:
            total = self._total
            n_new = min(max(total - int(cursor), 0), len(self._ring))
            recs = list(self._ring)[len(self._ring) - n_new:] if n_new else []
        return total, recs

    def window_score(self, cursor: int) -> Tuple[int, Optional[float], dict]:
        """Goodput score over the records since ``cursor`` — the
        autotuner's objective: effective allreduce
        bytes/sec discounted by the exposed-communication fraction,

            score = allreduce_gbps * 1e9 * (1 - exposed_comm_frac)

        so a config that moves bytes fast but leaves the step blocked on
        negotiation scores below one that overlaps. Returns
        ``(new_cursor, score, window_stats)``; score is None when the
        window holds no records or no wire/exec activity (idle windows
        must not be scored — the autotuner skips them rather than
        observing a fake zero)."""
        cursor, recs = self.records_since(cursor)
        if not recs:
            return cursor, None, {}
        st = self.stats(records=recs)
        gbps = st.get("allreduce_gbps", 0.0)
        if gbps <= 0.0:
            return cursor, None, st
        frac = min(max(st.get("exposed_comm_frac", 0.0), 0.0), 1.0)
        return cursor, gbps * 1e9 * (1.0 - frac), st

    def stats(self, records: Optional[List[dict]] = None) -> dict:
        """Flat derived-stat dict — the namespace SLO budgets bind to.

        Over the whole ring by default, or over an explicit window (the
        SLO engine passes the records since its last evaluation).
        ``negotiate_*`` stats cover the full negotiation round including
        any stall slice, matching what a training loop experiences.
        """
        recs = self.records() if records is None else records
        out = {"steps": len(recs)}
        if not recs:
            return out
        walls = sorted(r["wall_s"] for r in recs)
        rounds = sorted(r["negotiate_s"] + r["stall_s"] for r in recs)
        stalls = sorted(r["stall_s"] for r in recs)
        overheads = sorted(r["host_overhead_s"] for r in recs)
        sum_wall = sum(walls)
        sum_comm = sum(rounds)
        sum_exec = sum(r["device_exec_s"] for r in recs)
        sum_wire = sum(r["wire_bytes"] for r in recs)
        hits = sum(r["plan_hits"] for r in recs)
        misses = sum(r["plan_misses"] for r in recs)
        compiles = sorted(r.get("compile_s", 0.0) for r in recs)
        out.update({
            "compile_seconds_total": sum(compiles),
            "compile_seconds_p95": _percentile(compiles, 0.95),
            "step_p50_ms": _percentile(walls, 0.50) * 1e3,
            "step_p95_ms": _percentile(walls, 0.95) * 1e3,
            "negotiate_p50_ms": _percentile(rounds, 0.50) * 1e3,
            "negotiate_p95_ms": _percentile(rounds, 0.95) * 1e3,
            "stall_p95_ms": _percentile(stalls, 0.95) * 1e3,
            # per-step Python outside negotiation and dispatch — the
            # residual megaplan replay drives toward zero; SLO budgets
            # like host_overhead_p95_ms<=1 bind here
            "host_overhead_p50_ms": _percentile(overheads, 0.50) * 1e3,
            "host_overhead_p95_ms": _percentile(overheads, 0.95) * 1e3,
            "exposed_comm_frac": (sum_comm / sum_wall) if sum_wall else 0.0,
            # no plan activity in the window means nothing missed, not a
            # 0% hit rate — a >= budget must not breach on idle windows
            "plan_hit_rate": (hits / (hits + misses))
            if (hits + misses) else 1.0,
            "step_wire_bytes": sum_wire / len(recs),
            "allreduce_gbps": (sum_wire / sum_exec / 1e9)
            if sum_exec > 0 else 0.0,
        })
        return {k: (round(v, 6) if isinstance(v, float) else v)
                for k, v in out.items()}

    def phase_summary(self, records: Optional[List[dict]] = None) -> dict:
        """Per-phase p50/p95/max (ms) and share of total recorded wall
        time — the step-decomposition view ``GET /perf`` shows per rank."""
        recs = self.records() if records is None else records
        if not recs:
            return {}
        sum_wall = sum(r["wall_s"] for r in recs) or 1.0
        out = {}
        for p in PHASES:
            vals = sorted(r[p + "_s"] for r in recs)
            out[p] = {"p50_ms": round(_percentile(vals, 0.50) * 1e3, 6),
                      "p95_ms": round(_percentile(vals, 0.95) * 1e3, 6),
                      "max_ms": round(vals[-1] * 1e3, 6),
                      "share": round(sum(vals) / sum_wall, 6)}
        return out

    def snapshot(self) -> dict:
        """Push payload for ``perf/rank{k}`` (kept compact: derived stats
        plus the newest few raw records, not the whole ring)."""
        recs = self.records()
        with self._lock:
            total = self._total
        return {"rank": self.rank, "steps": total,
                "stats": self.stats(records=recs),
                "phases": self.phase_summary(records=recs),
                "recent": recs[-5:]}

    def report(self) -> dict:
        """``hvd.perf_report()`` body for this rank."""
        out = self.snapshot()
        out["enabled"] = True
        out["capacity"] = self.capacity
        return out


# --------------------------------------------------------------------------
# SLO budget engine
# --------------------------------------------------------------------------

_OPS = ("<=", ">=")


def parse_slo_spec(text: str) -> List[Tuple[str, str, float]]:
    """Parse ``HOROVOD_SLO_SPEC`` into ``(stat_name, op, limit)`` budgets.

    Accepts the inline grammar (``negotiate_p95_ms<=5,plan_hit_rate>=0.95``),
    an inline JSON object mapping stat name to a bound string
    (``{"negotiate_p95_ms": "<=5"}``), or a path to a JSON file holding
    either form. Raises ``ValueError`` on anything malformed.
    """
    text = (text or "").strip()
    if not text:
        return []
    if not text.startswith("{") and os.path.isfile(text):
        with open(text, "r", encoding="utf-8") as f:
            content = f.read().strip()
        if not content:
            raise ValueError(f"SLO spec file {text!r} is empty")
        return parse_slo_spec(content)
    clauses: List[Tuple[str, str]] = []
    if text.startswith("{"):
        try:
            obj = json.loads(text)
        except json.JSONDecodeError as e:
            raise ValueError(f"SLO spec is not valid JSON: {e}") from e
        if not isinstance(obj, dict):
            raise ValueError("JSON SLO spec must be an object of "
                             "{stat_name: bound}")
        clauses = [(str(k), str(v)) for k, v in obj.items()]
    else:
        for part in text.split(","):
            part = part.strip()
            if not part:
                continue
            for op in _OPS:
                if op in part:
                    name, _, bound = part.partition(op)
                    clauses.append((name.strip(), op + bound.strip()))
                    break
            else:
                raise ValueError(
                    f"SLO clause {part!r} has no comparator (use "
                    "name<=value or name>=value)")
    budgets: List[Tuple[str, str, float]] = []
    for name, bound in clauses:
        bound = bound.strip()
        op = bound[:2]
        if op not in _OPS or not name:
            raise ValueError(f"SLO bound {bound!r} for {name!r} must start "
                             "with <= or >=")
        try:
            limit = float(bound[2:])
        except ValueError as e:
            raise ValueError(
                f"SLO bound {bound!r} for {name!r}: not a number") from e
        budgets.append((name, op, limit))
    return budgets


class SloEngine:
    """Evaluates declared budgets over each new window of ledger records.

    Single-threaded by construction: ``evaluate()`` runs on the
    MetricsDumper thread (its flush cadence is the evaluation cadence).
    A budget fires once per breach window — it latches on the first
    breaching window and re-arms when a later window is back in bound —
    so a sustained breach produces one escalation, not one per flush.
    """

    def __init__(self, ledger: PerfLedger, budgets, stall_inspector=None):
        self.ledger = ledger
        self.budgets = list(budgets)
        self._stall = stall_inspector
        self._cursor = 0
        self._latched: set = set()
        from . import metrics as metrics_mod

        reg = metrics_mod.get_registry()
        self._m_evals = reg.counter(
            "hvd_slo_evaluations_total",
            "SLO budget evaluation passes (one per flush with new steps)")
        self._m_breach = {
            name: reg.counter(
                "hvd_slo_breach_total",
                "SLO budget breach windows (fires once per window)",
                budget=name)
            for name, _, _ in self.budgets}

    def attach_stall_inspector(self, inspector) -> None:
        self._stall = inspector

    @staticmethod
    def _holds(value: float, op: str, limit: float) -> bool:
        return value <= limit if op == "<=" else value >= limit

    def _fire(self, name: str, op: str, limit: float, value: float) -> None:
        self._m_breach[name].inc()
        flightrec_mod.note("slo_breach", budget=name,
                           value=round(float(value), 6),
                           bound=f"{op}{limit:g}", rank=self.ledger.rank)
        detail = f"{value:.4g} vs bound {op}{limit:g}"
        inspector = self._stall
        if inspector is not None:
            inspector.note_slo_breach(name, detail)
        else:
            LOG.warning("SLO budget %r breached: %s.", name, detail)

    def evaluate(self) -> List[dict]:
        """One pass over the records since the last call; returns the
        budgets that newly fired (empty when no new records arrived)."""
        self._cursor, recs = self.ledger.records_since(self._cursor)
        if not recs:
            return []
        self._m_evals.inc()
        stats = self.ledger.stats(records=recs)
        fired: List[dict] = []
        for name, op, limit in self.budgets:
            value = stats.get(name)
            if value is None:
                continue
            if self._holds(float(value), op, limit):
                self._latched.discard(name)
            elif name not in self._latched:
                self._latched.add(name)
                self._fire(name, op, limit, float(value))
                fired.append({"budget": name, "bound": f"{op}{limit:g}",
                              "value": float(value)})
        return fired

    def state(self) -> dict:
        """JSON-able engine view for reports and ``GET /perf``."""
        return {"budgets": [
            {"budget": name, "bound": f"{op}{limit:g}",
             "breaching": name in self._latched}
            for name, op, limit in self.budgets]}


# --------------------------------------------------------------------------
# Process-global ledger + engine (the utils/tracing.py module-trio
# pattern): get_ledger() returns None when HOROVOD_PERFLEDGER is off, and
# every hook site costs exactly one is-None check in that state.
# --------------------------------------------------------------------------

_LEDGER: Optional[PerfLedger] = None
_ENGINE: Optional[SloEngine] = None


def enabled() -> bool:
    return env_schema.get_bool(env_schema.HOROVOD_PERFLEDGER)


def get_ledger() -> Optional[PerfLedger]:
    return _LEDGER


def get_engine() -> Optional[SloEngine]:
    return _ENGINE


def init_ledger(rank: int = 0, stall_inspector=None) -> Optional[PerfLedger]:
    """Create the process ledger when ``HOROVOD_PERFLEDGER`` is set
    (idempotent, like flightrec's init_recorder) and arm the SLO engine
    when ``HOROVOD_SLO_SPEC`` is also set; no-op returning None when off.
    A malformed spec is logged and skipped — a bad budget string must not
    take the job down at init."""
    global _LEDGER, _ENGINE
    if not enabled():
        return _LEDGER
    if _LEDGER is None:
        capacity = env_schema.get_int(env_schema.HOROVOD_PERFLEDGER_BUFFER,
                                      DEFAULT_CAPACITY)
        _LEDGER = PerfLedger(rank=rank, capacity=capacity)
    spec = env_schema.get_str(env_schema.HOROVOD_SLO_SPEC)
    if _ENGINE is None and spec.strip():
        try:
            budgets = parse_slo_spec(spec)
        except ValueError as e:
            budgets = []
            LOG.warning("ignoring malformed HOROVOD_SLO_SPEC: %s", e)
        if budgets:
            _ENGINE = SloEngine(_LEDGER, budgets,
                                stall_inspector=stall_inspector)
    if _ENGINE is not None and stall_inspector is not None:
        _ENGINE.attach_stall_inspector(stall_inspector)
    return _LEDGER


def reset_ledger() -> None:
    """Drop the process ledger and SLO engine (test/bench helper)."""
    global _LEDGER, _ENGINE, _STALL_WARNED
    _LEDGER = None
    _ENGINE = None
    _STALL_WARNED = False


def evaluate_slos() -> List[dict]:
    """Cold-path convenience for the MetricsDumper: run one SLO pass iff
    the engine is armed."""
    engine = _ENGINE
    if engine is None:
        return []
    return engine.evaluate()


# one-shot guard for the stall-attribution warning below; reset together
# with the ledger so tests observe the warning deterministically
_STALL_WARNED = False


def report() -> dict:
    """``hvd.perf_report()`` body: ``{"enabled": False}`` when the ledger
    is off, else this rank's stats/phase decomposition plus the SLO
    engine's budget states when one is armed.

    Straggler/stall attribution comes from coordinator verdicts that
    only exist when cross-rank tracing is on: without ``HOROVOD_TRACE``
    the ``stall`` phase reads 0 because no verdicts arrive, not because
    no rank stalled. The report marks that with
    ``stall_attributed: False`` (and warns once) instead of silently
    showing a clean decomposition."""
    global _STALL_WARNED
    ledger = _LEDGER
    if ledger is None:
        return {"enabled": False}
    out = ledger.report()
    from . import tracing as tracing_mod

    attributed = tracing_mod.get_tracer() is not None
    out["stall_attributed"] = attributed
    if not attributed and not _STALL_WARNED:
        _STALL_WARNED = True
        LOG.warning(
            "perf_report(): stall/straggler attribution needs "
            "HOROVOD_TRACE=1 — the stall phase reads 0 because "
            "coordinator straggler verdicts are unavailable, not because "
            "no rank stalled.")
    engine = _ENGINE
    if engine is not None:
        out["slo"] = engine.state()
    return out
