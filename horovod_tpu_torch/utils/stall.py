"""Stall inspector: tensors stuck in the runtime's pending table — a copy
of ``horovod_tpu/utils/stall.py`` (reference ``stall_inspector.{h,cc}``).

A tensor enqueued and not finished for ``warning_time_s``
(``HOROVOD_STALL_CHECK_TIME_SECONDS``, 60 by default) draws one warning
naming it, the pending table's age spread and, when the coordinator
attributed a recent straggler (``HOROVOD_TRACE``), the suspect rank; past
``shutdown_time_s`` (``HOROVOD_STALL_SHUTDOWN_TIME_SECONDS``) ``check``
raises ``StalledTensorError`` with the names, which the runtime fails.
At more than one rank the coordinator owns the shutdown, because it knows
which ranks are missing (``ops/controller.py``): the runtime sets the
local inspector's shutdown time to 0 and keeps its warnings.
``HOROVOD_STALL_CHECK_DISABLE`` leaves the inspector unbuilt.

``record_pending`` runs on the enqueuing thread while ``check`` runs on
the cycle thread, so ``check`` reads one snapshot of the pending table,
copied in a single call under the GIL, and never iterates the live dict.

The oldest pending age and the table's size are gauges a scraper can
alert on before the warning; warnings and shutdowns are counters.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

from ..common.exceptions import StalledTensorError
from . import metrics as metrics_mod

LOG = logging.getLogger("horovod_tpu_torch")


def _age_distribution(ages: list[float]) -> str:
    """Compact pending-queue age summary for the warning message:
    count + min/median/max, enough to tell one straggler from a wedge."""
    if not ages:
        return "no tensors pending"
    s = sorted(ages)
    return (f"{len(s)} pending (age min/median/max = "
            f"{s[0]:.1f}/{s[len(s) // 2]:.1f}/{s[-1]:.1f} s)")


class StallInspector:
    def __init__(self, warning_time_s: float = 60.0,
                 shutdown_time_s: float = 0.0):
        self.warning_time_s = warning_time_s
        self.shutdown_time_s = shutdown_time_s
        self._pending: dict[str, float] = {}
        self._warned: set[str] = set()
        # most recent straggler attribution from the coordinator (tracing
        # on): (rank, tensor name, wait_s, monotonic time). A stall
        # warning that can name the suspect rank beats one that can only
        # name the stuck tensor.
        self._last_straggler: Optional[tuple] = None
        reg = metrics_mod.get_registry()
        self._m_oldest = reg.gauge(
            "hvd_stall_oldest_pending_age_seconds",
            "age of the oldest tensor still waiting to execute")
        self._m_pending = reg.gauge(
            "hvd_stall_pending_tensors", "tensors in the pending table")
        self._m_warnings = reg.counter(
            "hvd_stall_warnings_total", "stall warnings emitted")
        self._m_stalled = reg.counter(
            "hvd_stall_stalled_tensors_total",
            "tensors that crossed the warning threshold")
        self._m_shutdowns = reg.counter(
            "hvd_stall_shutdowns_total",
            "warning-to-shutdown escalations (StalledTensorError raised)")

    def record_pending(self, name: str):
        self._pending.setdefault(name, time.monotonic())

    def record_done(self, name: str):
        self._pending.pop(name, None)
        self._warned.discard(name)

    def note_straggler(self, name: str, rank: int, wait_s: float):
        """Record the coordinator's latest straggler attribution (fed by
        the negotiation response when tracing is on)."""
        self._last_straggler = (rank, name, wait_s, time.monotonic())

    # attribution staler than this is history, not a lead on the current
    # stall — keep it out of the warning text
    STRAGGLER_FRESH_S = 300.0

    def _suspect(self) -> str:
        if self._last_straggler is None:
            return ""
        rank, name, wait_s, t = self._last_straggler
        if time.monotonic() - t > self.STRAGGLER_FRESH_S:
            return ""
        return (f" Straggler attribution: rank {rank} was last to submit "
                f"{name!r} (peers waited {wait_s:.3f} s); suspect that "
                "rank first.")

    def note_slo_breach(self, budget: str, detail: str):
        """Escalate an SLO-budget breach (utils/perfledger.py) through the
        same warning path a stalled tensor takes — the breach names the
        violated budget and, when the coordinator attributed a recent
        straggler, the suspect rank."""
        LOG.warning("SLO budget %r breached: %s.%s", budget, detail,
                    self._suspect())
        self._m_warnings.inc()

    def check(self):
        """Called once a working cycle (reference ComputeResponseList,
        controller.cc:294)."""
        pending = list(self._pending.items())
        if not pending:
            self._m_oldest.set(0.0)
            self._m_pending.set(0)
            return
        now = time.monotonic()
        ages = [now - t for _, t in pending]
        self._m_oldest.set(max(ages))
        self._m_pending.set(len(ages))
        stalled = [(n, now - t) for n, t in pending
                   if now - t > self.warning_time_s]
        dist = _age_distribution(ages) if stalled else ""
        suspect = self._suspect() if stalled else ""
        for name, age in stalled:
            if name not in self._warned:
                LOG.warning(
                    "Tensor %s has been pending for %.0f s without executing. "
                    "This may indicate that not all processes are submitting "
                    "the same collectives in the same order. Queue: %s.%s",
                    name, age, dist, suspect)
                self._warned.add(name)
                self._m_warnings.inc()
                self._m_stalled.inc()
        if self.shutdown_time_s > 0:
            dead = [n for n, t in pending if now - t > self.shutdown_time_s]
            if dead:
                self._m_shutdowns.inc()
                err = StalledTensorError(
                    f"tensors stalled beyond shutdown time: {sorted(dead)}")
                err.names = sorted(dead)
                raise err
