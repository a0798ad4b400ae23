"""Fault injection at the control plane's seams — a copy of
``horovod_tpu/utils/faults.py`` (the same grammar, the same seeded
streams, so one ``HOROVOD_FAULT_SPEC`` fires the same hits in either
package). A trigger counts on ``hvd_fault_injected_total{site,mode}``
and notes ``fault_injected`` in the flight recorder.

    HOROVOD_FAULT_SPEC="kv.get:drop#1,controller.poll:delay=250ms@0.5,plan.dispatch:fail#1"

Each comma-separated entry is ``site:mode[=arg][@gate][#count]``:

- ``site``: a fault point's name (``SITES``);
- ``mode``: ``drop`` (a connection-level error, as if the peer vanished),
  ``delay`` (sleep ``arg``, 50 ms by default; ``5s``, ``250ms`` or bare
  seconds), ``error``/``fail`` (``FaultInjectedError``, ``arg`` its
  message), ``torn`` (a payload cut in half at a write site, through
  :func:`corrupt` or :func:`torn`);
- ``@gate``: a float ``<= 1`` is a probability a hit, drawn from a
  ``random.Random`` seeded by ``HOROVOD_FAULT_SEED``, the site, the mode
  and the rank (a failing run replays exactly); an integer ``> 1`` fires
  every Nth hit; by default every hit fires;
- ``#count``: how many times the entry may fire (unlimited by default).

Unset, a fault point costs one lookup in the environment and registers
no ``hvd_fault_*`` series. Sites whose modules the port lacks
(``metrics.push``, ``health.sample``, ``autotune.propose``) stay in
``SITES`` so a spec naming them validates, and have no call site.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from typing import Optional

from ..common import env as env_schema
from ..common.exceptions import FaultInjectedError

LOG = logging.getLogger("horovod_tpu_torch")

HOROVOD_FAULT_SPEC = "HOROVOD_FAULT_SPEC"
HOROVOD_FAULT_SEED = "HOROVOD_FAULT_SEED"

#: Instrumented fault-point names (documentation + spec validation aid).
SITES = (
    "kv.get", "kv.put", "kv.wait", "kv.delete",
    "controller.poll", "controller.submit",
    "leader.merge",
    "elastic.spawn", "elastic.heartbeat",
    "metrics.push",
    "autotune.propose",
    "plan.dispatch",
    "ckpt.write", "ckpt.flush",
    "megaplan.capture", "megaplan.replay",
    "health.sample",
)

MODES = ("drop", "delay", "error", "fail", "torn")


class FaultInjectedConnectionError(FaultInjectedError, ConnectionError):
    """Injected connection-level fault (``drop`` mode): an OSError
    subclass, so transport-layer retry policies classify it exactly like
    a real dropped socket."""


def _parse_duration(s: str) -> float:
    s = s.strip().lower()
    if s.endswith("ms"):
        return float(s[:-2]) / 1000.0
    if s.endswith("s"):
        return float(s[:-1])
    return float(s)


class _Rule:
    """One parsed spec entry with its trigger state (hits / budget)."""

    def __init__(self, site: str, mode: str, arg: str,
                 gate: Optional[str], count: Optional[int], seed: int):
        self.site = site
        self.mode = "error" if mode == "fail" else mode
        if self.mode not in ("drop", "delay", "error", "torn"):
            raise ValueError(f"unknown fault mode {mode!r}")
        self.arg = arg
        self.delay_s = _parse_duration(arg) if self.mode == "delay" and arg \
            else 0.05
        self.probability: Optional[float] = None
        self.every_nth: Optional[int] = None
        if gate is not None:
            g = float(gate)
            if g <= 1.0:
                self.probability = g
            else:
                self.every_nth = int(g)
        self.remaining = count  # None = unlimited
        self.hits = 0
        # deterministic per-(seed, site, rank) stream: a failing chaos run
        # replays bit-for-bit, and ranks draw distinct sequences
        rank = os.environ.get(env_schema.HOROVOD_RANK, "0")
        self._rng = random.Random(f"{seed}:{site}:{mode}:{rank}")
        self._lock = threading.Lock()
        self._metric = None

    def should_fire(self) -> bool:
        with self._lock:
            self.hits += 1
            if self.remaining is not None and self.remaining <= 0:
                return False
            if self.probability is not None:
                if self._rng.random() >= self.probability:
                    return False
            elif self.every_nth is not None:
                if self.hits % self.every_nth != 0:
                    return False
            if self.remaining is not None:
                self.remaining -= 1
            return True

    def record(self):
        # registered at the first trigger: an unconfigured run registers
        # no hvd_fault_* series
        if self._metric is None:
            from . import metrics as metrics_mod

            self._metric = metrics_mod.get_registry().counter(
                "hvd_fault_injected_total", "chaos faults injected",
                site=self.site, mode=self.mode)
        self._metric.inc()
        from . import flightrec

        flightrec.note("fault_injected", site=self.site, mode=self.mode)

    def fire(self):
        self.record()
        if self.mode == "delay":
            LOG.debug("fault %s: injected %.3fs delay", self.site,
                      self.delay_s)
            time.sleep(self.delay_s)
        elif self.mode == "drop":
            raise FaultInjectedConnectionError(
                f"injected connection drop at fault point {self.site!r} "
                f"(HOROVOD_FAULT_SPEC)")
        elif self.mode == "error":
            raise FaultInjectedError(
                self.arg or f"injected error at fault point {self.site!r} "
                            f"(HOROVOD_FAULT_SPEC)")
        # "torn" only acts through corrupt()


class _FaultState:
    def __init__(self, spec: str, seed: int):
        self.spec = spec
        self.rules: dict[str, list[_Rule]] = {}
        for entry in spec.split(","):
            entry = entry.strip()
            if not entry:
                continue
            site, _, rest = entry.partition(":")
            site = site.strip()
            if not rest:
                raise ValueError(
                    f"bad HOROVOD_FAULT_SPEC entry {entry!r}: want "
                    "site:mode[=arg][@gate][#count]")
            count: Optional[int] = None
            if "#" in rest:
                rest, _, c = rest.rpartition("#")
                count = int(c)
            gate: Optional[str] = None
            if "@" in rest:
                rest, _, gate = rest.rpartition("@")
            mode, _, arg = rest.partition("=")
            self.rules.setdefault(site, []).append(
                _Rule(site, mode.strip(), arg.strip(), gate, count, seed))


_state: Optional[_FaultState] = None
_state_lock = threading.Lock()


def _active() -> Optional[_FaultState]:
    spec = os.environ.get(HOROVOD_FAULT_SPEC, "")
    if not spec:
        return None
    global _state
    st = _state
    if st is not None and st.spec == spec:
        return st
    with _state_lock:
        if _state is None or _state.spec != spec:
            try:
                _state = _FaultState(
                    spec, int(os.environ.get(HOROVOD_FAULT_SEED, "0") or 0))
            except ValueError as e:
                # a malformed spec is logged and ignored: fault injection
                # must not take the job down
                LOG.error("ignoring malformed %s=%r: %s",
                          HOROVOD_FAULT_SPEC, spec, e)
                _state = _FaultState("", 0)
                _state.spec = spec  # cache the rejection
        return _state


def reset():
    """Drop parsed spec state (test helper: re-arm trigger budgets)."""
    global _state
    with _state_lock:
        _state = None


def fault_point(site: str):
    """Chaos hook: no-op unless ``HOROVOD_FAULT_SPEC`` names ``site``.

    May sleep (``delay``) or raise (``drop`` → connection-level error,
    ``error`` → :class:`FaultInjectedError`). Call it at the top of the
    operation the fault should hit, inside any retry scope that is
    supposed to absorb it.
    """
    st = _active()
    if st is None:
        return
    for rule in st.rules.get(site, ()):
        if rule.mode != "torn" and rule.should_fire():
            rule.fire()


def torn(site: str) -> bool:
    """Whether a ``torn`` rule of ``site`` fires on this hit (counted as
    a trigger when it does): a writer then keeps half of what it wrote."""
    st = _active()
    if st is None:
        return False
    for rule in st.rules.get(site, ()):
        if rule.mode == "torn" and rule.should_fire():
            rule.record()
            LOG.debug("fault %s: torn write", site)
            return True
    return False


def corrupt(site: str, data: bytes) -> bytes:
    """Torn-write hook for payload-carrying sites: returns ``data``
    truncated to half its length when a ``torn`` rule fires (the
    half-written value a crashed writer leaves behind), else unchanged."""
    return data[: len(data) // 2] if torn(site) else data
