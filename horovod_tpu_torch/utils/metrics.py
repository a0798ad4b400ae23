"""Metrics registry: counters, gauges and histograms, quantiles, JSON
snapshots and the Prometheus text exposition (version 0.0.4) — a copy of
``horovod_tpu/utils/metrics.py``. The series names are the JAX package's
(``hvd_allreduce_bytes_total``, ``hvd_cycles_total``,
``hvd_fusion_batch_size``, ``hvd_negotiation_rounds_total``, ...), so one
harness reads either package.

Every update is O(1) arithmetic under the registry's one lock
(``Histogram.observe`` adds a ``bisect`` over a fixed bucket table); the
runtime resolves its metric objects once, when it is built.

Two exposures: ``GET /metrics`` on the launcher's rendezvous server
(``runner/http_server.py``) renders every rank's snapshot, labelled
``rank="k"``, which each worker's ``MetricsDumper`` pushes under
``metrics/rank{k}``; ``HOROVOD_METRICS_FILE`` makes the dumper write the
JSON snapshot every ``HOROVOD_METRICS_DUMP_INTERVAL`` seconds and at
shutdown. The dumper's thread also pushes the tracer's spans
(``trace/``), the perf ledger's snapshot (``perf/``, evaluating the SLO
budgets first), the anatomy's (``anatomy/``), the memory ledger's
(``mem/``, after a sample), the async checkpointer's status (``ckpt/``)
and the health engine's (``health/``, after its sampling pass): JSON
encoding and KV writes stay off the cycle thread.

    from horovod_tpu_torch.utils import metrics
    reg = metrics.get_registry()
    reg.counter("hvd_allreduce_bytes_total", "wire bytes", dtype="float32").inc(4096)
    reg.snapshot()            # JSON-able structured dict
    reg.render_prometheus()   # exposition format 0.0.4
"""

from __future__ import annotations

import bisect
import json
import logging
import os
import threading
import time
from typing import Optional

from . import lockcheck

LOG = logging.getLogger("horovod_tpu_torch")

# Default bucket tables (upper bounds, seconds / bytes / tensor counts).
# Fixed at metric creation: observe() only bisects, never resizes.
LATENCY_BUCKETS_S = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)
SIZE_BUCKETS_BYTES = (
    1 << 10, 1 << 12, 1 << 14, 1 << 16, 1 << 18, 1 << 20, 1 << 22,
    1 << 24, 1 << 26, 1 << 28, 1 << 30)
BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


def _fmt(v) -> str:
    """Prometheus sample-value formatting: integers bare, floats via %g."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _label_str(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class _Metric:
    """Base: name + frozen labels + a reference to the registry lock."""

    kind = "untyped"

    def __init__(self, name: str, help_text: str, labels: dict, lock):
        self.name = name
        self.help = help_text
        self.labels = dict(labels)
        self._lock = lock


class Counter(_Metric):
    """Monotonic counter (reference semantics: bytes_processed-style
    tallies, but queryable)."""

    kind = "counter"

    def __init__(self, name, help_text, labels, lock):
        super().__init__(name, help_text, labels, lock)
        self._value = 0

    def inc(self, amount=1):
        with self._lock:
            self._value += amount

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge(_Metric):
    """Point-in-time value (queue depth, tuned knobs, oldest pending age)."""

    kind = "gauge"

    def __init__(self, name, help_text, labels, lock):
        super().__init__(name, help_text, labels, lock)
        self._value = 0

    def set(self, value):
        with self._lock:
            self._value = value

    def inc(self, amount=1):
        with self._lock:
            self._value += amount

    def dec(self, amount=1):
        with self._lock:
            self._value -= amount

    @property
    def value(self):
        with self._lock:
            return self._value


class Histogram(_Metric):
    """Fixed-bucket histogram (cycle time, per-op latency, fused sizes).

    Buckets are upper bounds; the implicit +Inf bucket is always present.
    ``observe`` is a bisect over the fixed bound table + three int/float
    adds — no allocation, no resizing.
    """

    kind = "histogram"

    def __init__(self, name, help_text, labels, lock,
                 buckets=LATENCY_BUCKETS_S):
        super().__init__(name, help_text, labels, lock)
        self.bounds = tuple(sorted(float(b) for b in buckets))
        self._counts = [0] * (len(self.bounds) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, value):
        i = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    @property
    def count(self):
        with self._lock:
            return self._count

    @property
    def sum(self):
        with self._lock:
            return self._sum

    def cumulative(self):
        """[(upper_bound, cumulative_count), ...] ending with ('+Inf', n)."""
        with self._lock:
            counts = list(self._counts)
        out, acc = [], 0
        for b, c in zip(self.bounds, counts[:-1]):
            acc += c
            out.append((b, acc))
        out.append(("+Inf", acc + counts[-1]))
        return out


class MetricsRegistry:
    """Thread-safe named-metric table with get-or-create semantics.

    One lock is shared by the registry and every metric it owns: a single
    uncontended ``threading.Lock`` acquire per update is cheaper than
    per-metric locks and makes ``snapshot()`` a consistent cut.
    """

    def __init__(self):
        self._lock = lockcheck.make_lock("metrics.registry")
        # key: (name, sorted-label-items tuple) -> metric
        self._metrics: dict[tuple, _Metric] = {}  # guarded-by: _lock

    def _get_or_create(self, cls, name, help_text, labels, **kw):
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, help_text, labels, self._lock, **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help_text: str = "", **labels) -> Counter:
        return self._get_or_create(Counter, name, help_text, labels)

    def gauge(self, name: str, help_text: str = "", **labels) -> Gauge:
        return self._get_or_create(Gauge, name, help_text, labels)

    def histogram(self, name: str, help_text: str = "",
                  buckets=LATENCY_BUCKETS_S, **labels) -> Histogram:
        return self._get_or_create(Histogram, name, help_text, labels,
                                   buckets=buckets)

    def names(self) -> set:
        """The names of every registered series."""
        with self._lock:
            return {n for n, _ in self._metrics}

    # -- snapshots ----------------------------------------------------------
    def snapshot(self) -> dict:
        """Structured, JSON-able consistent cut of every series."""
        with self._lock:
            metrics = list(self._metrics.values())
        counters, gauges, hists = [], [], []
        for m in metrics:
            if isinstance(m, Histogram):
                hists.append({"name": m.name, "labels": m.labels,
                              "buckets": [[b, c] for b, c in m.cumulative()],
                              "sum": m.sum, "count": m.count})
            elif isinstance(m, Counter):
                counters.append({"name": m.name, "labels": m.labels,
                                 "value": m.value})
            else:
                gauges.append({"name": m.name, "labels": m.labels,
                               "value": m.value})
        return {"ts": time.time(), "counters": counters, "gauges": gauges,
                "histograms": hists}

    def counter_value(self, name: str, **labels) -> float:
        """Sum of a counter family across the label sets that carry
        ``labels`` (all of them without ``labels``)."""
        if not labels:
            return self.counter_values((name,))[name]
        total = 0.0
        with self._lock:
            for (n, items), m in self._metrics.items():
                if (n == name and isinstance(m, Counter)
                        and labels.items() <= dict(items).items()):
                    total += m._value
        return total

    def counter_values(self, names) -> dict:
        """Per-family sums for several counter families in one pass — one
        lock acquire and one table scan however many families are asked
        for. The perf ledger reads five families per recorded step, so
        the batch form keeps that read O(table) instead of O(5·table)."""
        out = {n: 0.0 for n in names}
        with self._lock:
            for (n, _), m in self._metrics.items():
                if n in out and isinstance(m, Counter):
                    out[n] += m._value
        return out

    def gauge_value(self, name: str) -> Optional[float]:
        """A gauge family's value without creating it (the first label set
        wins; the families read so have one). None when absent, so the
        health engine samples a gauge of a feature that is off without
        registering it."""
        with self._lock:
            for (n, _), m in self._metrics.items():
                if n == name and isinstance(m, Gauge):
                    return float(m._value)
        return None

    def histogram_quantile(self, name: str, q: float) -> Optional[float]:
        """Bucket-interpolated quantile over a histogram family, merged
        across label sets (the PromQL ``histogram_quantile`` estimate:
        linear within the winning bucket, lower bound 0, upper bound the
        last finite edge). None when the family has no observations —
        callers (perf ledger SLO fields) skip absent series instead of
        reporting a fake 0."""
        with self._lock:
            hists = [m for (n, _), m in self._metrics.items()
                     if n == name and isinstance(m, Histogram)]
            if not hists:
                return None
            bounds = hists[0].bounds
            counts = [0] * (len(bounds) + 1)
            for m in hists:
                if m.bounds != bounds:
                    continue  # mixed bucket layouts merge meaninglessly
                for i, c in enumerate(m._counts):
                    counts[i] += c
        total = sum(counts)
        if total == 0:
            return None
        rank = max(0.0, min(1.0, float(q))) * total
        acc = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if acc + c >= rank:
                if i >= len(bounds):
                    return bounds[-1] if bounds else 0.0
                lo = bounds[i - 1] if i > 0 else 0.0
                frac = (rank - acc) / c
                return lo + (bounds[i] - lo) * frac
            acc += c
        return bounds[-1] if bounds else 0.0

    def render_prometheus(self) -> str:
        return render_snapshots([({}, self.snapshot())])

    def dump_json(self, path: str):
        """Atomic-ish JSON dump for post-mortem of wedged runs: write to a
        sibling temp file, then rename — a reader never sees a torn dump."""
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.snapshot(), f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)


def render_snapshots(snapshots) -> str:
    """Render one exposition from structured snapshots.

    ``snapshots`` is ``[(extra_labels, snapshot_dict), ...]``; series of
    the same family from different snapshots (ranks) are grouped under one
    HELP/TYPE header, as the exposition format requires — the launcher's
    ``/metrics`` merges every pushed worker snapshot through this.
    """
    # family name -> (kind, [(labels, payload), ...]); insertion-ordered
    families: dict[str, tuple[str, list]] = {}

    def add(kind, entry, extra):
        labels = dict(entry.get("labels") or {})
        labels.update(extra)
        fam = families.setdefault(entry["name"], (kind, []))
        if fam[0] != kind:
            return  # conflicting kinds across ranks: keep the first
        fam[1].append((labels, entry))

    for extra, snap in snapshots:
        for c in snap.get("counters", ()):
            add("counter", c, extra)
        for g in snap.get("gauges", ()):
            add("gauge", g, extra)
        for h in snap.get("histograms", ()):
            add("histogram", h, extra)

    lines = []
    for name, (kind, series) in families.items():
        lines.append(f"# TYPE {name} {kind}")
        for labels, entry in series:
            if kind != "histogram":
                lines.append(f"{name}{_label_str(labels)} "
                             f"{_fmt(entry['value'])}")
                continue
            for b, c in entry["buckets"]:
                bl = dict(labels)
                bl["le"] = b if isinstance(b, str) else _fmt(b)
                lines.append(f"{name}_bucket{_label_str(bl)} {c}")
            lines.append(f"{name}_sum{_label_str(labels)} "
                         f"{_fmt(entry['sum'])}")
            lines.append(f"{name}_count{_label_str(labels)} "
                         f"{entry['count']}")
    return "\n".join(lines) + "\n" if lines else ""


# --------------------------------------------------------------------------
# Process-global default registry: one per process, shared by every
# subsystem, surviving init/shutdown cycles (counters are cumulative over
# the process lifetime, like any Prometheus target's).
# --------------------------------------------------------------------------

_REGISTRY = MetricsRegistry()

# KV-store scope workers push snapshots under (key: "rank{k}"); the
# rendezvous server's /metrics reads the same scope back.
KV_SCOPE = "metrics"


def get_registry() -> MetricsRegistry:
    return _REGISTRY


class MetricsDumper:
    """Background publisher: periodic ``HOROVOD_METRICS_FILE`` JSON dumps
    and, in a launched job, snapshot pushes into the launcher's KV store
    under ``metrics/rank{k}`` (and the tracer's, the perf ledger's and the
    anatomy's under their scopes), so the launcher's endpoints show every
    rank. Best-effort: telemetry never takes down the job it observes."""

    KV_SCOPE = KV_SCOPE

    def __init__(self, registry: MetricsRegistry, file_path: str = "",
                 interval_s: float = 30.0, kv_client=None,
                 rank: int = 0):
        self.registry = registry
        self.file_path = file_path
        self.interval_s = max(float(interval_s), 0.5)
        self.kv_client = kv_client
        self.rank = rank
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # freshness stamp riding every push: the launcher's merges mark
        # ranks whose stamps lag the newest as stale
        self._push_seq = 0

    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="hvd-metrics")
        self._thread.start()

    def _stamp(self, snap: dict) -> bytes:
        snap["push_seq"] = self._push_seq
        snap["push_ts"] = time.time()
        snap["push_interval_s"] = self.interval_s
        return json.dumps(snap).encode()

    def flush(self):
        """One synchronous dump and push (the shutdown path and tests)."""
        if self.file_path:
            try:
                self.registry.dump_json(self.file_path)
            except OSError as e:
                LOG.warning("metrics file dump failed: %s", e)
        from ..common import env as env_schema
        from . import anatomy as anatomy_mod
        from . import faults as faults_mod
        from . import perfledger as perfledger_mod
        from . import tracing as tracing_mod

        kv = self.kv_client
        if kv is not None:
            try:
                # a dropped push is absorbed here; a torn one is stored and
                # skipped by the /metrics merge on read
                faults_mod.fault_point("metrics.push")
                snap = self.registry.snapshot()
                # the launcher's merge keeps only the newest elastic
                # generation's snapshots
                snap["elastic_epoch"] = env_schema.get_int(
                    env_schema.HOROVOD_ELASTIC_EPOCH, 0)
                snap["elastic_gen"] = env_schema.get_int(
                    env_schema.HOROVOD_ELASTIC_GEN, 0)
                self._push_seq += 1
                kv.put(self.KV_SCOPE, f"rank{self.rank}",
                       faults_mod.corrupt("metrics.push", self._stamp(snap)))
            except Exception as e:
                LOG.debug("metrics KV push failed: %s", e)
            try:
                tracer = tracing_mod.get_tracer()
                if tracer is not None:
                    kv.put(tracing_mod.KV_SCOPE, f"rank{self.rank}",
                           json.dumps(tracer.snapshot()).encode())
            except Exception as e:
                LOG.debug("trace KV push failed: %s", e)
        # the SLO budgets are evaluated on this cadence, with or without a
        # KV store, so a file-only dumper still evaluates them
        try:
            ledger = perfledger_mod.get_ledger()
            if ledger is not None:
                perfledger_mod.evaluate_slos()
                if kv is not None:
                    kv.put(perfledger_mod.KV_SCOPE, f"rank{self.rank}",
                           self._stamp(ledger.snapshot()))
        except Exception as e:
            LOG.debug("perf KV push failed: %s", e)
        try:
            profiler = anatomy_mod.get_profiler()
            if profiler is not None and kv is not None:
                kv.put(anatomy_mod.KV_SCOPE, f"rank{self.rank}",
                       self._stamp(profiler.snapshot()))
        except Exception as e:
            LOG.debug("anatomy KV push failed: %s", e)
        self._flush_postmortem(kv)

    def _flush_postmortem(self, kv):
        """The memory ledger's sample and push, the async checkpointer's
        status push and the health engine's sampling pass with its push,
        each only when its owner exists (JAX utils/metrics.py:501-571).
        The samples are taken with or without a KV store; the fault point
        ``health.sample`` precedes the health pass, so a dropped pass leaves
        no half-filled ring."""
        from . import async_ckpt as async_ckpt_mod
        from . import faults as faults_mod
        from . import health as health_mod
        from . import memledger as memledger_mod

        try:
            mledger = memledger_mod.get_ledger()
            if mledger is not None:
                mledger.sample(event="interval")
                if kv is not None:
                    kv.put(memledger_mod.KV_SCOPE, f"rank{self.rank}",
                           self._stamp(mledger.snapshot()))
        except Exception as e:
            LOG.debug("memory KV push failed: %s", e)
        try:
            ckpt = async_ckpt_mod.get_checkpointer()
            if ckpt is not None and kv is not None:
                kv.put(async_ckpt_mod.KV_SCOPE, f"rank{self.rank}",
                       self._stamp(ckpt.snapshot_status()))
        except Exception as e:
            LOG.debug("checkpoint KV push failed: %s", e)
        try:
            heng = health_mod.get_engine()
            if heng is not None:
                faults_mod.fault_point("health.sample")
                heng.sample_and_detect()
                if kv is not None:
                    kv.put(health_mod.KV_SCOPE, f"rank{self.rank}",
                           faults_mod.corrupt("health.sample",
                                              self._stamp(heng.snapshot())))
        except Exception as e:
            LOG.debug("health sample/push failed: %s", e)

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            self.flush()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self.flush()  # the final dump: the post-mortem artifact
