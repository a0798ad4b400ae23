"""Runtime lock-order / lock-hold auditor (opt-in: ``HOROVOD_LOCKCHECK=1``).

The background runtime holds a dozen locks (queue drain, controller
rounds, staging ring, tracer ring, metrics registry); a lock-order
inversion between any two of them is a deadlock that only fires under
the right thread interleaving. The auditor makes the *order* observable
without needing the unlucky schedule: every audited acquisition adds
``held-lock -> new-lock`` edges to a global name-keyed graph, and a new
edge that closes a cycle is reported immediately — with both acquisition
stacks (the one that established the reverse path and the one closing
the cycle) — even though no deadlock actually occurred on this run.

Zero-cost contract: with ``HOROVOD_LOCKCHECK`` unset, :func:`make_lock`
returns a plain ``threading.Lock`` — no wrapper, no per-acquire check,
no ``hvd_lockcheck_*`` series. With it set, each acquire costs a
thread-local stack push plus (first time an edge is seen) a graph
update; stacks are only captured for *new* edges, so steady state is
cheap enough to run the whole test suite audited (tests/conftest.py).

Deliberate limits, documented rather than papered over:

- Edges are keyed by lock *name*, so two instances sharing a name would
  alias; same-name self-edges are therefore skipped (a per-key lock
  striped N ways is not an inversion with itself).
- Metrics are synced only at moments when the releasing thread holds no
  audited lock: the registry's own lock is audited, and touching it from
  inside ``on_acquired`` (while the just-acquired lock — possibly the
  registry lock itself — is still held) would deadlock.

A copy of ``horovod_tpu/utils/lockcheck.py``: it reads the same variable,
so a test session that arms the JAX package's auditor arms the port's
too. The two packages keep separate auditors.
"""

from __future__ import annotations

import logging
import threading
import time
import traceback
from typing import Dict, List, Optional, Set, Tuple

from ..common import env as env_schema

LOG = logging.getLogger("horovod_tpu_torch")

_STACK_LIMIT = 12  # frames kept per captured acquisition stack


def enabled() -> bool:
    return env_schema.get_bool(env_schema.HOROVOD_LOCKCHECK)


def _hold_warn_s() -> float:
    return env_schema.get_float(env_schema.HOROVOD_LOCKCHECK_HOLD_MS,
                                500.0) / 1000.0


def _stack() -> str:
    # drop the two auditor-internal frames at the tail
    return "".join(traceback.format_stack(limit=_STACK_LIMIT)[:-2])


class Auditor:
    """Acquisition-graph recorder shared by a set of audited locks.

    ``self._mu`` is a plain (unaudited) leaf lock: nothing is called
    while holding it, so it cannot participate in any cycle."""

    def __init__(self, hold_warn_s: Optional[float] = None):
        self._mu = threading.Lock()
        self.hold_warn_s = hold_warn_s if hold_warn_s is not None \
            else _hold_warn_s()
        # (held_name, new_name) -> acquisition stack when first observed
        self._edges: Dict[Tuple[str, str], str] = {}
        self._succ: Dict[str, Set[str]] = {}
        self._inversions: List[dict] = []
        self._long_holds: List[dict] = []
        self._tls = threading.local()
        # mutated under _mu; synced to hvd_lockcheck_* by _publish() at
        # lock-free moments only (see module docstring). Acquires are
        # counted per-thread (no _mu on the steady-state acquire path)
        # and folded in at publish time.
        self._acquires = 0
        self._pending = {"inversions": 0, "long_holds": 0}

    # -- per-thread held stack: list of [lock_id, name, t_acquired, count]

    def _held(self) -> list:
        h = getattr(self._tls, "held", None)
        if h is None:
            h = self._tls.held = []
        return h

    def lock(self, name: str) -> "_AuditedLock":
        return _AuditedLock(self, name, threading.Lock())

    def rlock(self, name: str) -> "_AuditedLock":
        return _AuditedLock(self, name, threading.RLock())

    # -- acquisition bookkeeping ------------------------------------------

    def on_acquired(self, lock: "_AuditedLock") -> None:
        held = self._held()
        for entry in held:
            if entry[0] == id(lock):  # reentrant RLock acquire: no edges
                entry[3] += 1
                return
        new_edges = [(e[1], lock.name) for e in held
                     if e[1] != lock.name
                     and (e[1], lock.name) not in self._edges]
        if new_edges:
            stack = _stack()
            found = []
            with self._mu:
                for edge in new_edges:
                    inv = self._record_edge(edge, stack)
                    if inv is not None:
                        found.append(inv)
            for inv in found:  # log outside _mu: handlers take their own locks
                LOG.error(
                    "lock-order inversion: %s -> %s closes cycle %s\n"
                    "-- acquisition closing the cycle (thread %s):\n%s"
                    "-- first acquisition of the reverse edge %s -> %s:\n%s",
                    inv["cycle"][0], inv["cycle"][1],
                    " -> ".join(inv["path"] + [inv["path"][0]]),
                    inv["thread"], inv["stack"],
                    inv["path"][0], inv["path"][1], inv["prior_stack"])
        self._tls.acq = getattr(self._tls, "acq", 0) + 1
        held.append([id(lock), lock.name, time.monotonic(), 1])

    def _record_edge(self, edge: Tuple[str, str],
                     stack: str) -> Optional[dict]:
        """Insert ``held -> new`` (caller holds ``_mu``); a path from
        ``new`` back to ``held`` existing first means the global order is
        cyclic — returns the inversion record (with both stacks)."""
        if edge in self._edges:
            return None
        held_name, new_name = edge
        inv = None
        path = self._find_path(new_name, held_name)
        if path is not None:
            inv = {
                "cycle": [held_name, new_name],
                "path": path,
                "thread": threading.current_thread().name,
                "stack": stack,
                "prior_stack": self._edges.get((path[0], path[1]),
                                               "<unrecorded>"),
            }
            self._inversions.append(inv)
            self._pending["inversions"] += 1
        self._edges[edge] = stack
        self._succ.setdefault(held_name, set()).add(new_name)
        return inv

    def _find_path(self, src: str, dst: str) -> Optional[List[str]]:
        """Shortest existing path src -> ... -> dst in the edge graph."""
        if src == dst:
            return [src]
        seen = {src}
        frontier = [[src]]
        while frontier:
            nxt = []
            for path in frontier:
                for succ in self._succ.get(path[-1], ()):
                    if succ == dst:
                        return path + [succ]
                    if succ not in seen:
                        seen.add(succ)
                        nxt.append(path + [succ])
            frontier = nxt
        return None

    def on_releasing(self, lock: "_AuditedLock") -> Optional[float]:
        """Pop the per-thread entry; returns the acquire timestamp when
        this release drops the last reentrant hold, else None."""
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == id(lock):
                held[i][3] -= 1
                if held[i][3] <= 0:
                    t0 = held[i][2]
                    del held[i]
                    return t0
                return None
        return None  # release without recorded acquire (foreign thread)

    def on_released(self, lock: "_AuditedLock", t0: Optional[float]) -> None:
        if t0 is None:
            return
        held_s = time.monotonic() - t0
        if held_s > self.hold_warn_s:
            with self._mu:
                self._long_holds.append({
                    "lock": lock.name, "held_s": held_s,
                    "thread": threading.current_thread().name})
                self._pending["long_holds"] += 1
            LOG.warning("lock %s held %.3f s (> %.3f s threshold) by %s",
                        lock.name, held_s, self.hold_warn_s,
                        threading.current_thread().name)
        # sync metrics only at lock-free moments, and only when there is
        # something worth a registry round-trip (events, or a batch of
        # acquires) — the steady-state release path stays tls-only
        if not self._held():
            acq = getattr(self._tls, "acq", 0)
            if acq >= 256 or any(self._pending.values()):
                self._publish()

    # -- reporting --------------------------------------------------------

    def _publish(self) -> None:
        """Sync pending counts into hvd_lockcheck_* series. Only called
        when the current thread holds no audited lock (the registry lock
        is itself audited; see module docstring)."""
        acq = getattr(self._tls, "acq", 0)
        self._tls.acq = 0
        with self._mu:
            self._acquires += acq
            delta = dict(self._pending)
            for k in self._pending:
                self._pending[k] = 0
        if not acq and not any(delta.values()):
            return
        try:
            from . import metrics as metrics_mod

            reg = metrics_mod.get_registry()
            if acq:
                reg.counter("hvd_lockcheck_acquires_total",
                            "audited lock acquisitions").inc(acq)
            if delta["inversions"]:
                reg.counter("hvd_lockcheck_inversions_total",
                            "lock-order inversions detected"
                            ).inc(delta["inversions"])
            if delta["long_holds"]:
                reg.counter("hvd_lockcheck_long_holds_total",
                            "lock holds exceeding the warn threshold"
                            ).inc(delta["long_holds"])
        except Exception:  # pragma: no cover - registry import race
            pass

    def inversions(self) -> List[dict]:
        with self._mu:
            return list(self._inversions)

    def edges(self) -> List[Tuple[str, str]]:
        """Every (held, acquired) name pair observed so far, sorted.
        tests/test_hvdlint.py asserts these are a subset of the static
        lock-order graph built by tools/hvdlint's lock-order pass."""
        with self._mu:
            return sorted(self._edges)

    def long_holds(self) -> List[dict]:
        with self._mu:
            return list(self._long_holds)

    def report(self) -> dict:
        with self._mu:
            return {
                "enabled": True,
                "acquires": self._acquires,
                "edges": len(self._edges),
                "inversions": list(self._inversions),
                "long_holds": list(self._long_holds),
            }

    def reset(self) -> None:
        with self._mu:
            self._edges.clear()
            self._succ.clear()
            self._inversions.clear()
            self._long_holds.clear()
            self._acquires = 0
            for k in self._pending:
                self._pending[k] = 0


class _AuditedLock:
    """Lock/RLock wrapper reporting acquisitions to an :class:`Auditor`.

    The inner lock is acquired *before* bookkeeping (so audit state never
    describes a lock the thread does not yet hold) and released *after*
    the held-stack pop (so hold time covers the full critical section)."""

    __slots__ = ("_aud", "name", "_inner")

    def __init__(self, auditor: Auditor, name: str, inner):
        self._aud = auditor
        self.name = name
        self._inner = inner

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._aud.on_acquired(self)
        return ok

    def release(self) -> None:
        t0 = self._aud.on_releasing(self)
        self._inner.release()
        self._aud.on_released(self, t0)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


_GLOBAL: Optional[Auditor] = None
_GLOBAL_MU = threading.Lock()


def auditor() -> Auditor:
    """The process-global auditor backing :func:`make_lock`."""
    global _GLOBAL
    if _GLOBAL is None:
        with _GLOBAL_MU:
            if _GLOBAL is None:
                _GLOBAL = Auditor()
    return _GLOBAL


def make_lock(name: str):
    """A lock for runtime shared state: plain ``threading.Lock`` when the
    auditor is off (the common case — zero wrapper, zero checks), an
    audited wrapper registered under ``name`` when ``HOROVOD_LOCKCHECK=1``.
    Names are dotted ``module.role`` strings; they key the order graph."""
    if not enabled():
        return threading.Lock()
    return auditor().lock(name)


def make_rlock(name: str):
    """RLock variant of :func:`make_lock` (reentrant acquires are counted,
    not edges)."""
    if not enabled():
        return threading.RLock()
    return auditor().rlock(name)


def inversions() -> List[dict]:
    """Inversions seen by the global auditor ([] when auditing is off)."""
    if _GLOBAL is None:
        return []
    return _GLOBAL.inversions()


def edges() -> List[Tuple[str, str]]:
    """(held, acquired) pairs seen by the global auditor ([] when off)."""
    if _GLOBAL is None:
        return []
    return _GLOBAL.edges()


def report() -> dict:
    if _GLOBAL is None:
        return {"enabled": False}
    return _GLOBAL.report()
