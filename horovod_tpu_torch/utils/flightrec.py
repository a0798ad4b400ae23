"""Flight recorder: a bounded ring of control-plane events — a copy of
``horovod_tpu/utils/flightrec.py``. Each event carries monotonic and wall
times, a category from the closed ``CATEGORIES`` registry (the JAX
package's, row for row) and small key-value fields: the breadcrumb trail
of what the control plane did last before a hang or a crash.

The port notes ``init_phase``, ``negotiation_round`` (the runtime's
rounds), ``leader_round`` (``ops/controller.py``), ``elastic_generation``
(``elastic/``), ``fault_injected`` (``utils/faults.py``), ``retry_attempt``,
``plan_cache_invalidated``, ``reshard`` (``opt/sharded.py``, the
whole-leaf front end), ``quant_fallback`` (``ops/queue.py``), ``checkpoint``
(``utils/async_ckpt.py``), ``megaplan`` (captured, invalidated),
``autotune_step``, ``slo_breach``, ``watchdog`` and ``diag_dump``
(``utils/diag.py``), ``compile`` (``utils/memledger.py``: a kernel-library
load or a plan build) and ``health`` (``utils/health.py``). The JAX
package's ``probe_verdict`` (its backend liveness probe, which the port
has no counterpart of) has no call site.

Zero-cost contract: with ``HOROVOD_FLIGHTREC`` unset no recorder exists,
a hot path pays one ``is None`` check a hook, and no ``hvd_flightrec_*``
series is registered. ``HOROVOD_FLIGHTREC_BUFFER`` sizes the ring.
"""

from __future__ import annotations

import collections
import time
from typing import List, Optional

from ..common import env as env_schema
from . import lockcheck

#: The closed event-category registry: (name, meaning), the JAX
#: package's; a category is added here before it is noted anywhere.
CATEGORIES = (
    ("init_phase", "hvd.init() milestone reached"),
    ("negotiation_round", "controller negotiation round begin/end"),
    ("elastic_generation", "elastic discovery epoch/generation change"),
    ("retry_attempt", "control-plane retry about to back off"),
    ("fault_injected", "chaos fault fired at an instrumented site"),
    ("plan_cache_invalidated", "compiled fused-chunk plans dropped"),
    ("reshard", "sharded-update layout (re)built"),
    ("probe_verdict", "backend liveness probe decided"),
    ("watchdog", "wedge watchdog fired"),
    ("diag_dump", "diagnostic bundle written"),
    ("quant_fallback", "tensor kept off the quantized wire"),
    ("slo_breach", "declared SLO budget crossed its bound"),
    ("compile", "XLA program compiled for a cached plan"),
    ("leader_round", "node-leader negotiation round merged or fell back"),
    ("autotune_step", "autotuner proposed/applied/reverted a config"),
    ("checkpoint", "async checkpoint snapshot/flush/restore lifecycle"),
    ("megaplan", "whole-step schedule captured/replayed/invalidated"),
    ("health", "fleet-health anomaly latched or cleared on a drifted series"),
)

CATEGORY_NAMES = frozenset(name for name, _ in CATEGORIES)

DEFAULT_CAPACITY = 2048


class FlightRecorder:
    """Bounded structured event ring, safe to write from any thread.

    ``note()`` is the only hot method: one tuple build plus a deque
    append under a short lock. Readers (:meth:`events`) copy the ring
    under the same lock, so a reader mid-flight sees a clean cut.
    """

    def __init__(self, rank: int = 0, capacity: int = DEFAULT_CAPACITY):
        self.rank = rank
        self.capacity = max(int(capacity), 16)
        self._lock = lockcheck.make_lock("flightrec.ring")
        self._ring = collections.deque(maxlen=self.capacity)  # guarded-by: _lock
        from . import metrics as metrics_mod

        reg = metrics_mod.get_registry()
        self._m_events = reg.counter(
            "hvd_flightrec_events_total", "flight-recorder events noted")
        self._m_dropped = reg.counter(
            "hvd_flightrec_dropped_total",
            "flight-recorder events evicted by ring wraparound")

    def note(self, category: str, **kv) -> None:
        """Append one event. ``kv`` holds JSON-able scalars; callers keep
        payloads tiny: this is a breadcrumb trail, not a log."""
        ev = (time.monotonic(), time.time(), category, kv)
        with self._lock:
            dropped = len(self._ring) == self.capacity
            self._ring.append(ev)
        self._m_events.inc()
        if dropped:
            self._m_dropped.inc()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def events(self, last: Optional[int] = None) -> List[dict]:
        """The ring's contents, oldest first, as JSON-able dicts
        (``last`` keeps only the newest N)."""
        with self._lock:
            evs = list(self._ring)
        if last is not None:
            evs = evs[-int(last):]
        return [{"ts_mono": mono, "ts": wall, "cat": cat,
                 "rank": self.rank, "kv": kv}
                for mono, wall, cat, kv in evs]

    def snapshot(self, last: int = 200) -> dict:
        """Rank and the newest ``last`` events."""
        return {"rank": self.rank, "events": self.events(last=last)}


# The process recorder: get_recorder() returns None when HOROVOD_FLIGHTREC
# is off, and every hook site costs one is-None check in that state.

_RECORDER: Optional[FlightRecorder] = None


def enabled() -> bool:
    return env_schema.get_bool(env_schema.HOROVOD_FLIGHTREC)


def get_recorder() -> Optional[FlightRecorder]:
    return _RECORDER


def init_recorder(rank: int = 0) -> Optional[FlightRecorder]:
    """Create the process recorder when ``HOROVOD_FLIGHTREC`` is set
    (idempotent: reuses a live recorder so init/shutdown cycles keep one
    continuous ring); no-op returning None when off."""
    global _RECORDER
    if not enabled():
        return _RECORDER
    if _RECORDER is None:
        capacity = env_schema.get_int(env_schema.HOROVOD_FLIGHTREC_BUFFER,
                                      DEFAULT_CAPACITY)
        _RECORDER = FlightRecorder(rank=rank, capacity=capacity)
    return _RECORDER


def reset_recorder() -> None:
    """Drop the process recorder (test/bench helper)."""
    global _RECORDER
    _RECORDER = None


def note(category: str, **kv) -> None:
    """Record an event iff the recorder is on: for the sites that fire
    rarely (retries, faults, elastic transitions). Hot paths
    (``ops/queue.py``) resolve the handle once instead."""
    recorder = _RECORDER
    if recorder is None:
        return
    recorder.note(category, **kv)
