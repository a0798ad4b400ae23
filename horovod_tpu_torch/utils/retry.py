"""Unified retry/backoff/deadline policy for the control plane — a copy of
``horovod_tpu/utils/retry.py`` without its flight-recorder note (the
flight recorder is not ported). The KV client (runner/http_server.py)
and the controller's response poll (ops/controller.py) go through one
:class:`Retrier`:

- **exponential backoff with full jitter** (AWS architecture-blog
  formulation: ``sleep = uniform(0, min(cap, base * mult**attempt))``) —
  full jitter because control-plane retries are synchronized across
  ranks by construction (everyone notices a store blip in the same
  round), exactly the thundering-herd shape jitter exists to break;
- **two deadlines**: per-policy ``max_attempts`` and an overall
  ``deadline_s`` — whichever is hit first ends the retry loop;
- **retryable classification**: by default only connection-level
  faults (``OSError`` / ``http.client.HTTPException``) are retried;
  everything else — auth failures, protocol bugs — propagates on the
  first throw;
- **metrics**: every attempt increments
  ``hvd_retry_attempts_total{site}``; running out of budget increments
  ``hvd_retry_exhausted_total{site}`` and re-raises the *last real
  exception*, so existing except-clauses keep working.

Global knobs (call sites pass their own defaults; env overrides both):

- ``HOROVOD_RETRY_MAX_ATTEMPTS`` — attempt budget per retried operation.
- ``HOROVOD_RETRY_DEADLINE`` — overall deadline (seconds) per operation.
- ``HOROVOD_RETRY_BASE_DELAY`` — first-backoff scale (seconds).
"""

from __future__ import annotations

import dataclasses
import http.client
import logging
import random
import time
from typing import Callable, Optional

from ..common import env as env_schema
from ..common.exceptions import RetriesExhaustedError

LOG = logging.getLogger("horovod_tpu_torch")


def default_retryable(exc: BaseException) -> bool:
    """Connection-level faults only: a refused/reset/timed-out socket or
    a torn HTTP exchange is worth a retry; anything else (auth rejection,
    JSON garbage, programming errors) must propagate immediately."""
    return isinstance(exc, (OSError, http.client.HTTPException))


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Immutable retry budget + backoff shape for one class of operation.

    ``max_attempts=None`` means unbounded attempts (gate on
    ``deadline_s`` instead — the controller's response poll works this
    way); ``deadline_s=None`` means no overall deadline.
    """

    max_attempts: Optional[int] = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    deadline_s: Optional[float] = None
    retryable: Callable[[BaseException], bool] = default_retryable

    @classmethod
    def from_env(cls, **defaults) -> "RetryPolicy":
        """Site defaults overridden by the global env knobs (an operator
        mitigating an incident can widen every budget at once without a
        deploy)."""
        kw = dict(defaults)
        v = env_schema.get_int(env_schema.HOROVOD_RETRY_MAX_ATTEMPTS, -1)
        if v >= 1:
            kw["max_attempts"] = v
        d = env_schema.get_float(env_schema.HOROVOD_RETRY_DEADLINE, -1.0)
        if d > 0:
            kw["deadline_s"] = d
        b = env_schema.get_float(env_schema.HOROVOD_RETRY_BASE_DELAY, -1.0)
        if b > 0:
            kw["base_delay_s"] = b
        return cls(**kw)

    def backoff_delay(self, attempt: int,
                      rng: Optional[random.Random] = None) -> float:
        """Full-jitter delay before retry number ``attempt`` (1-based:
        the delay after the first failure is ``attempt=1``)."""
        cap = min(self.max_delay_s,
                  self.base_delay_s * self.multiplier ** (attempt - 1))
        return (rng or _rng).uniform(0.0, cap)


_rng = random.Random()

# (site -> metric handles) resolved once per site, not per attempt
_metrics_cache: dict = {}


def _site_metrics(site: str):
    handles = _metrics_cache.get(site)
    if handles is None:
        from . import metrics as metrics_mod

        reg = metrics_mod.get_registry()
        handles = (
            reg.counter("hvd_retry_attempts_total",
                        "control-plane operation attempts", site=site),
            reg.counter("hvd_retry_exhausted_total",
                        "operations that ran out of retry budget",
                        site=site),
        )
        _metrics_cache[site] = handles
    return handles


class Retrier:
    """Run a callable under a :class:`RetryPolicy`, labelled ``site``.

    ``sleep`` and ``rng`` are injectable for tests (a chaos suite must
    not spend wall-clock on backoff to prove backoff happened).
    """

    def __init__(self, site: str, policy: Optional[RetryPolicy] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 rng: Optional[random.Random] = None):
        self.site = site
        self.policy = policy or RetryPolicy()
        self._sleep = sleep
        self._rng = rng
        self.attempts = 0  # observability for callers/tests

    def call(self, fn: Callable[[], object]):
        """Invoke ``fn`` until it returns, raises a non-retryable
        exception, or the budget (attempts/deadline) runs out — then the
        last exception re-raises."""
        pol = self.policy
        m_attempts, m_exhausted = _site_metrics(self.site)
        start = time.monotonic()
        attempt = 0
        while True:
            if (pol.deadline_s is not None and attempt > 0
                    and time.monotonic() - start >= pol.deadline_s):
                # deadline expired while backing off: budget is gone
                m_exhausted.inc()
                raise RetriesExhaustedError(
                    self.site, attempt, time.monotonic() - start)
            attempt += 1
            self.attempts = attempt
            m_attempts.inc()
            try:
                return fn()
            except Exception as e:
                if not pol.retryable(e):
                    raise
                elapsed = time.monotonic() - start
                out_of_attempts = (pol.max_attempts is not None
                                   and attempt >= pol.max_attempts)
                out_of_time = (pol.deadline_s is not None
                               and elapsed >= pol.deadline_s)
                if out_of_attempts or out_of_time:
                    m_exhausted.inc()
                    LOG.debug(
                        "%s: retry budget exhausted after %d attempt(s) / "
                        "%.1fs: %s", self.site, attempt, elapsed, e)
                    raise
                delay = pol.backoff_delay(attempt, self._rng)
                if pol.deadline_s is not None:
                    delay = min(delay, max(0.0, pol.deadline_s - elapsed))
                LOG.debug("%s: attempt %d failed (%s); retrying in %.3fs",
                          self.site, attempt, e, delay)
                from . import flightrec

                flightrec.note("retry_attempt", site=self.site,
                               attempt=attempt, delay_s=round(delay, 3))
                if delay > 0:
                    self._sleep(delay)
