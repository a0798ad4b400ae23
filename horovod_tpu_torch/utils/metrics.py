"""Metrics registry: counters, gauges and histograms — the registry of
``horovod_tpu/utils/metrics.py``, cut to what the port records and reads.
The series names are the JAX package's (``hvd_allreduce_bytes_total``,
``hvd_cycles_total``, ``hvd_fusion_batch_size``, ``hvd_fused_chunk_bytes``,
``hvd_negotiation_rounds_total``, ``hvd_controller_cache_hits_total``, ...),
so a harness reads either package the same way. The Prometheus exposition,
JSON snapshots, quantiles, the periodic dumper and the KV push come with
the launcher's ``/metrics`` endpoint (ROADMAP.md queue 1 item 16).

    from horovod_tpu_torch.utils import metrics
    reg = metrics.get_registry()
    reg.counter("hvd_allreduce_bytes_total", "wire bytes", dtype="float32").inc(4096)
    reg.counter_value("hvd_allreduce_bytes_total")
"""

from __future__ import annotations

import bisect

from . import lockcheck

# Default bucket tables (upper bounds, seconds / bytes / tensor counts).
# Fixed at metric creation: observe() only bisects, never resizes.
LATENCY_BUCKETS_S = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)
SIZE_BUCKETS_BYTES = (
    1 << 10, 1 << 12, 1 << 14, 1 << 16, 1 << 18, 1 << 20, 1 << 22,
    1 << 24, 1 << 26, 1 << 28, 1 << 30)
BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


class _Metric:
    """Base: name + frozen labels + a reference to the registry lock."""

    kind = "untyped"

    def __init__(self, name: str, help_text: str, labels: dict, lock):
        self.name = name
        self.help = help_text
        self.labels = dict(labels)
        self._lock = lock


class Counter(_Metric):
    """Monotonic counter."""

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
    """Point-in-time value (queue depth)."""

    kind = "gauge"

    def __init__(self, name, help_text, labels, lock):
        super().__init__(name, help_text, labels, lock)
        self._value = 0

    def set(self, value):
        with self._lock:
            self._value = value

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


class MetricsRegistry:
    """Thread-safe named-metric table with get-or-create semantics.

    One lock is shared by the registry and every metric it owns: a single
    uncontended ``threading.Lock`` acquire per update is cheaper than
    per-metric locks.
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

    def counter_value(self, name: str, **labels) -> float:
        """Sum of a counter family across the label sets that carry
        ``labels``."""
        total = 0.0
        with self._lock:
            for (n, items), m in self._metrics.items():
                if (n == name and isinstance(m, Counter)
                        and labels.items() <= dict(items).items()):
                    total += m._value
        return total


# --------------------------------------------------------------------------
# Process-global default registry: one per process, shared by every
# subsystem, surviving init/shutdown cycles (counters are cumulative over
# the process lifetime, like any Prometheus target's).
# --------------------------------------------------------------------------

_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY
