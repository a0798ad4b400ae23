"""Postmortem diagnostics: the wedge watchdog, the bundle builder and the
crash hooks — the port of ``horovod_tpu/utils/diag.py``, with its names
and its bundle layout.

A **diagnostic bundle** answers one question: what was this rank doing
when it stopped making progress? It is a JSON document with every
thread's stack (``sys._current_frames``), the lock auditor's report
(``utils/lockcheck.py``), a metrics snapshot, the tracer's open spans, the
flight recorder's last events, the probes the runtime registered (the
cycle's state, the coordinator's missing ranks), the memory ledger's
forensics (``utils/memledger.py``) and the plan cache's table. Bundles
are made:

- by the **wedge watchdog** (``HOROVOD_WATCHDOG_SECS``): a daemon thread
  that fires when the cycle loop or a negotiation in flight has not beaten
  for the threshold, counting ``hvd_watchdog_fired_total``. An idle
  one-rank runtime beats while it waits for work (``ops/queue.py``), so
  idleness is never a wedge;
- on **SIGUSR1** (dump and go on), **SIGTERM** (dump, then the previous
  disposition: the async checkpointer's flush, installed after these hooks,
  runs first), an uncaught exception (``sys.excepthook``; an
  allocation failure gives an ``oom`` bundle) and at exit when the
  watchdog ever fired;
- on demand: ``hvd.diagnose()`` and ``hvd.maybe_dump_alloc_failure(e)``.

A bundle lands in ``HOROVOD_DIAG_DIR`` (default: the system's temporary
directory) as ``hvd_diag.rank{r}.{reason}.json`` and, under a launcher, is
pushed to its KV store as ``diag/rank{k}`` through a client of this
module's own, so the launcher's ``GET /debug`` merges the ranks' bundles
and names the wedged rank (:func:`merge_bundles`).

The port's departure: :func:`is_alloc_failure` recognises
``torch.OutOfMemoryError`` and the CUDA allocator's "out of memory" text
where the JAX package looks for XLA's ``RESOURCE_EXHAUSTED``.
"""

from __future__ import annotations

import atexit
import faulthandler
import json
import logging
import os
import signal
import socket
import sys
import tempfile
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

from ..common import env as env_schema
from ..common import util as common_util
from . import flightrec, lockcheck

LOG = logging.getLogger("horovod_tpu_torch")

#: The KV scope bundles are pushed under (key ``rank{k}``); the launcher's
#: ``GET /debug`` reads it back.
KV_SCOPE = "diag"


def watchdog_secs() -> float:
    return env_schema.get_float(env_schema.HOROVOD_WATCHDOG_SECS, 0.0)


def diag_dir() -> str:
    return env_schema.get_str(env_schema.HOROVOD_DIAG_DIR) \
        or tempfile.gettempdir()


def _rank() -> int:
    return env_schema.get_int(env_schema.HOROVOD_RANK, 0)


# Probes: the runtime and the coordinator register callables that return
# JSON-able dicts, so a bundle sees their state without this module
# importing ops/. Every probe is best effort.

_PROBES: Dict[str, Callable[[], dict]] = {}
_probes_lock = threading.Lock()


def register_probe(name: str, fn: Callable[[], dict]) -> None:
    with _probes_lock:
        _PROBES[name] = fn


def unregister_probe(name: str) -> None:
    with _probes_lock:
        _PROBES.pop(name, None)


def thread_stacks() -> List[dict]:
    """Every live thread's current stack, read from
    ``sys._current_frames()`` without stopping any thread."""
    threads = {t.ident: t for t in threading.enumerate()}
    out = []
    for ident, frame in sys._current_frames().items():
        t = threads.get(ident)
        out.append({
            "thread_id": ident,
            "name": t.name if t is not None else "?",
            "daemon": bool(t.daemon) if t is not None else None,
            "stack": "".join(traceback.format_stack(frame)),
        })
    return out


# Allocation-failure text: the CUDA caching allocator's "CUDA out of
# memory", PyTorch's CPU allocator's "can't allocate memory", and the usual
# spellings of a failed allocation, matched on the rendered exception so a
# wrapping exception type does not hide the verdict.
_ALLOC_MARKERS = ("out of memory", "Out of memory", "OutOfMemory",
                  "can't allocate memory", "failed to allocate",
                  "Allocation failure")


def is_alloc_failure(exc) -> bool:
    """Whether ``exc`` is an allocation failure: ``MemoryError``,
    ``torch.OutOfMemoryError`` or an exception whose text says so. Such an
    exception gets an ``oom`` bundle whose memory section names a suspect
    component."""
    if isinstance(exc, MemoryError):
        return True
    torch_mod = sys.modules.get("torch")
    oom = getattr(torch_mod, "OutOfMemoryError", None)
    if oom is not None and isinstance(exc, oom):
        return True
    try:
        text = f"{type(exc).__name__}: {exc}"
    except Exception:
        return False
    return any(marker in text for marker in _ALLOC_MARKERS)


def maybe_dump_alloc_failure(exc) -> str:
    """Classify and dump in one call, for code that catches its own
    exceptions: writes an ``oom`` bundle when ``exc`` is an allocation
    failure. Returns the bundle's path ("" when it is not one, or the
    write failed)."""
    if not is_alloc_failure(exc):
        return ""
    return dump_bundle("oom")


def build_bundle(reason: str, last_events: int = 200,
                 stall: Optional[dict] = None) -> dict:
    """This rank's diagnostic bundle (``hvd.diagnose()`` returns it)."""
    from . import metrics as metrics_mod

    bundle = {
        "reason": reason,
        "rank": _rank(),
        "hostname": socket.gethostname(),
        "pid": os.getpid(),
        "time_unix": time.time(),
        "time_monotonic": time.monotonic(),
        "threads": thread_stacks(),
        "lockcheck": lockcheck.report(),
        "metrics": metrics_mod.get_registry().snapshot(),
    }
    if stall:
        bundle["stall"] = stall
    recorder = flightrec.get_recorder()
    bundle["flight_events"] = [] if recorder is None \
        else recorder.events(last=last_events)
    try:
        from . import tracing as tracing_mod

        tracer = tracing_mod.get_tracer()
        if tracer is not None:
            bundle["trace"] = {"open_spans": tracer.open_spans(),
                               "report": tracer.report()}
    except Exception as e:  # tracing never blocks a dump
        bundle["trace"] = {"error": repr(e)}
    probes = {}
    with _probes_lock:
        items = list(_PROBES.items())
    for name, fn in items:
        try:
            probes[name] = fn()
        except Exception as e:
            probes[name] = {"error": repr(e)}
    bundle["probes"] = probes
    try:
        from . import memledger as memledger_mod

        bundle["memory"] = memledger_mod.forensics()
    except Exception as e:
        bundle["memory"] = {"error": repr(e)}
    try:
        from ..ops import collectives as collectives_mod

        bundle["plan_cache"] = collectives_mod.plan_cache_table()
    except Exception as e:
        bundle["plan_cache"] = [{"error": repr(e)}]
    return bundle


# The launcher KV client of the watchdog's and the crash hooks' pushes: one
# of this module's own, not the metrics dumper's, because a push fires from
# the watchdog's thread or a signal handler while the dumper pushes on its
# own, and a client's connection is per thread.
_kv_client = None


def set_kv_client(client) -> None:
    global _kv_client
    _kv_client = client


def bundle_path(reason: str, rank: Optional[int] = None) -> str:
    if rank is None:
        rank = _rank()
    return os.path.join(diag_dir(), f"hvd_diag.rank{rank}.{reason}.json")


def dump_bundle(reason: str, push: bool = True,
                stall: Optional[dict] = None) -> str:
    """Build, write (atomically) and push (best effort) one bundle.

    Returns the file's path ("" when the write failed). Never raises:
    a diagnostic must not take down the job it diagnoses."""
    try:
        bundle = build_bundle(reason, stall=stall)
    except Exception:
        LOG.exception("diag: bundle build failed")
        return ""
    path = bundle_path(reason, bundle["rank"])
    payload = json.dumps(bundle, default=repr).encode()
    try:
        common_util.atomic_write_bytes(path, payload)
    except Exception as e:
        LOG.warning("diag: bundle write to %s failed: %s", path, e)
        path = ""
    if push and _kv_client is not None:
        try:
            _kv_client.put(KV_SCOPE, f"rank{bundle['rank']}", payload)
        except Exception as e:
            LOG.debug("diag: bundle KV push failed: %s", e)
    flightrec.note("diag_dump", reason=reason, path=path)
    return path


# --------------------------------------------------------------------------
# The wedge watchdog
# --------------------------------------------------------------------------

class Watchdog(threading.Thread):
    """Daemon thread that dumps a bundle when progress stops.

    The watched loop calls :meth:`beat` once a cycle; a long blocking
    section brackets itself with :meth:`enter` and :meth:`exit_phase`, so a
    fire names the phase (``negotiate``). One fire a wedge: the latch
    clears at the next beat."""

    def __init__(self, threshold_s: float,
                 dump: Callable[..., str] = dump_bundle):
        super().__init__(daemon=True, name="hvd-watchdog")
        self.threshold_s = float(threshold_s)
        self._dump = dump
        self._stop_ev = threading.Event()
        self._lock = lockcheck.make_lock("diag.watchdog")
        self._last_beat = time.monotonic()  # guarded-by: _lock
        self._phase = ""
        self._phase_since = 0.0
        self._fired = False
        self.fired_count = 0
        self._metric = None  # made at the first fire

    def beat(self) -> None:
        with self._lock:
            self._last_beat = time.monotonic()
            self._fired = False

    def enter(self, phase: str) -> None:
        with self._lock:
            self._phase = phase
            self._phase_since = time.monotonic()
            self._last_beat = self._phase_since
            self._fired = False  # reaching enter() is progress

    def exit_phase(self, phase: str) -> None:
        with self._lock:
            if self._phase == phase:
                self._phase = ""
            self._last_beat = time.monotonic()
            self._fired = False

    def state(self) -> dict:
        """The probe's payload: the phase and the beat's age."""
        with self._lock:
            return {"phase": self._phase,
                    "age_s": time.monotonic() - self._last_beat,
                    "threshold_s": self.threshold_s,
                    "fired_count": self.fired_count}

    def run(self) -> None:
        poll = max(min(self.threshold_s / 4.0, 1.0), 0.05)
        while not self._stop_ev.wait(poll):
            with self._lock:
                age = time.monotonic() - self._last_beat
                phase = self._phase
                fire = not self._fired and age >= self.threshold_s
                if fire:
                    self._fired = True
                    self.fired_count += 1
            if fire:
                self._fire(phase, age)

    def _fire(self, phase: str, age: float) -> None:
        if self._metric is None:
            from . import metrics as metrics_mod

            self._metric = metrics_mod.get_registry().counter(
                "hvd_watchdog_fired_total",
                "wedge-watchdog diagnostics dumps")
        self._metric.inc()
        flightrec.note("watchdog", phase=phase, age_s=round(age, 3))
        LOG.warning(
            "watchdog: no progress for %.1f s (threshold %.1f s, phase %r)"
            " — dumping diagnostics", age, self.threshold_s, phase or "idle")
        try:
            self._dump("watchdog", stall={"phase": phase,
                                          "age_s": round(age, 3)})
        except Exception:
            LOG.exception("watchdog: diagnostics dump failed")

    def stop(self) -> None:
        self._stop_ev.set()
        if self.is_alive():
            self.join(timeout=5)


_WATCHDOG: Optional[Watchdog] = None


def get_watchdog() -> Optional[Watchdog]:
    return _WATCHDOG


def init_watchdog(threshold_s: Optional[float] = None) -> Optional[Watchdog]:
    """Start the process's watchdog when the threshold is above 0
    (idempotent); None when it is off."""
    global _WATCHDOG
    if threshold_s is None:
        threshold_s = watchdog_secs()
    if threshold_s <= 0:
        return _WATCHDOG
    if _WATCHDOG is None:
        _WATCHDOG = Watchdog(threshold_s)
        _WATCHDOG.start()
    return _WATCHDOG


def reset_watchdog() -> None:
    global _WATCHDOG
    wd = _WATCHDOG
    _WATCHDOG = None
    if wd is not None:
        wd.stop()


# --------------------------------------------------------------------------
# Signal, crash and exit hooks
# --------------------------------------------------------------------------

_hooks_installed = False


def install_crash_hooks() -> None:
    """Dump a bundle on SIGUSR1 (and go on), on SIGTERM (then the previous
    disposition: the job still dies), on an uncaught exception and, when
    the watchdog ever fired, at exit. ``hvd.init()`` installs them before
    the async checkpointer's SIGTERM handler, which then chains to this
    one: a preemption flushes the snapshot first and dumps second.
    Idempotent; signals are skipped off the main thread."""
    global _hooks_installed
    if _hooks_installed:
        return
    _hooks_installed = True
    try:
        faulthandler.enable()
    except Exception:  # no usable stderr
        pass

    def _handler(signum, frame, chain_prev=None):
        name = signal.Signals(signum).name.lower()
        dump_bundle(name)
        if chain_prev is None:
            return  # SIGUSR1: observe and go on
        if callable(chain_prev):
            chain_prev(signum, frame)
        elif chain_prev != signal.SIG_IGN:
            # the default disposition, delivered again: the process still
            # dies of SIGTERM after leaving its bundle
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)

    for signame, chains in (("SIGUSR1", False), ("SIGTERM", True)):
        sig = getattr(signal, signame, None)
        if sig is None:
            continue
        try:
            prev = signal.getsignal(sig)
            if chains:
                signal.signal(sig, lambda n, f, p=prev: _handler(n, f, p))
            else:
                signal.signal(sig, _handler)
        except (ValueError, OSError):  # not the main thread
            pass

    prev_hook = sys.excepthook

    def _excepthook(etype, value, tb):
        try:
            dump_bundle("oom" if is_alloc_failure(value) else "crash")
        except Exception:
            pass
        prev_hook(etype, value, tb)

    sys.excepthook = _excepthook

    def _atexit_dump():
        wd = _WATCHDOG
        if wd is not None and wd.fired_count > 0:
            # the run wedged once: leave its final state too
            dump_bundle("exit", push=False)

    atexit.register(_atexit_dump)


def hooks_installed() -> bool:
    return _hooks_installed


# --------------------------------------------------------------------------
# The cross-rank merge (the launcher's GET /debug)
# --------------------------------------------------------------------------

def merge_bundles(bundles: Dict[int, dict]) -> dict:
    """Merge the ranks' bundles into one attribution.

    The suspects, strongest signal first: (1) a rank whose bundle's reason
    is ``oom``, attributed to its memory section's dominant component;
    (2) the union of the coordinator probe's ``missing_ranks``, the ranks
    the coordinator still waited on; (3) the rank with the largest
    watchdog stall age."""
    ranks: Dict[str, dict] = {}
    missing: set = set()
    oom_ranks = []
    worst_age, worst_rank = -1.0, None
    for rank, b in sorted(bundles.items()):
        if not isinstance(b, dict):
            continue
        stall = b.get("stall") or {}
        probes = b.get("probes") or {}
        coord = probes.get("coordinator") or {}
        mem = b.get("memory") or {}
        info = {
            "reason": b.get("reason"),
            "hostname": b.get("hostname"),
            "time_unix": b.get("time_unix"),
            "stall": stall,
            "threads": len(b.get("threads") or ()),
            "flight_events": len(b.get("flight_events") or ()),
            "open_spans": (b.get("trace") or {}).get("open_spans"),
            "coordinator": coord or None,
            "memory_suspect": mem.get("suspect"),
            "peak_bytes": mem.get("peak_bytes"),
        }
        ranks[str(rank)] = info
        if b.get("reason") == "oom":
            oom_ranks.append((rank, mem.get("suspect")))
        for m in coord.get("missing_ranks") or ():
            try:
                missing.add(int(m))
            except (TypeError, ValueError):
                pass
        try:
            age = float(stall.get("age_s", -1.0))
        except (TypeError, ValueError):
            age = -1.0
        if age > worst_age:
            worst_age, worst_rank = age, rank
    if oom_ranks:
        component = next((c for _, c in oom_ranks if c), None)
        attribution = "allocation failure (oom bundle)"
        if component:
            attribution += f": dominant component {component}"
        return {"ranks": ranks, "suspects": [r for r, _ in oom_ranks],
                "attribution": attribution}
    if missing:
        return {"ranks": ranks, "suspects": sorted(missing),
                "attribution": "coordinator gather: ranks never submitted"}
    if worst_rank is not None and worst_age >= 0:
        return {"ranks": ranks, "suspects": [worst_rank],
                "attribution": "largest watchdog stall age"}
    return {"ranks": ranks, "suspects": [], "attribution": "none"}
