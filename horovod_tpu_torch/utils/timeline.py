"""Chrome-trace timeline writer — a copy of ``horovod_tpu/utils/timeline.py``
(reference ``timeline.{h,cc}``): per-tensor lanes in the Chrome
trace-event format, each tensor a ``NEGOTIATE_<OP>`` span from its enqueue
to its end and, inside it, its activity (``FUSED_ALLREDUCE``,
``QUANT_FUSED_ALLREDUCE`` or the op's name) around its dispatch, plus
``CYCLE_START`` marks on working cycles under
``HOROVOD_TIMELINE_MARK_CYCLES``. The file opens in ``chrome://tracing``
and Perfetto.

Events go from the runtime's threads to a writer thread through a
``queue.SimpleQueue`` (the JAX package's own fallback; its native SPSC
ring lives in a C++ core the port does not build), so the cycle thread
never encodes JSON or touches the file. ``HOROVOD_TIMELINE`` names the
file, which rank 0 writes; ``hvd.start_timeline``/``stop_timeline`` open
and close it at run time. A closed timeline is false in a boolean test,
so a runtime hook costs one truth test when no file is open.

Device time comes from ``torch.profiler`` (``start_torch_profiler`` /
``stop_torch_profiler``), in place of the JAX package's ``jax.profiler``
bridge.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Optional


class Timeline:
    """Per-tensor lane trace writer (chrome trace-event format)."""

    def __init__(self, filename: str = "", mark_cycles: bool = False):
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._file = None
        self._thread: Optional[threading.Thread] = None
        self._tids: dict[str, int] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.mark_cycles = mark_cycles
        self._start_ts = time.perf_counter()
        if filename:
            self._open(filename)

    # -- lifecycle ----------------------------------------------------------
    def _open(self, filename: str):
        self._file = open(filename, "w")
        self._file.write("[\n")
        self._stop.clear()
        self._thread = threading.Thread(target=self._writer, daemon=True,
                                        name="hvd-timeline")
        self._thread.start()

    def reopen(self, filename: str, mark_cycles: bool = False):
        """Runtime start/stop (reference operations.cc:738-764)."""
        self.close()
        self.mark_cycles = mark_cycles
        if filename:
            self._open(filename)

    def close(self):
        if self._thread is not None:
            self._stop.set()
            self._q.put(None)
            self._thread.join(timeout=5)
            self._thread = None
        if self._file is not None:
            self._file.write("{}]\n")
            self._file.close()
            self._file = None

    @property
    def enabled(self) -> bool:
        return self._file is not None

    __bool__ = enabled.fget

    # -- event emission -----------------------------------------------------
    def _ts_us(self) -> float:
        return (time.perf_counter() - self._start_ts) * 1e6

    def _put(self, rec):
        self._q.put(rec)

    def _tid(self, name: str) -> int:
        with self._lock:
            if name not in self._tids:
                self._tids[name] = len(self._tids) + 1
                self._put({"name": "process_name", "ph": "M", "pid": 0,
                           "tid": self._tids[name],
                           "args": {"name": name}})
            return self._tids[name]

    def _emit(self, name: str, ph: str, event: str, args=None):
        if not self.enabled:
            return
        rec = {"ph": ph, "ts": self._ts_us(), "pid": 0, "tid": self._tid(name)}
        if event:
            rec["name"] = event
        if args:
            rec["args"] = args
        self._put(rec)

    def negotiate_start(self, name: str, op_name: str):
        self._emit(name, "B", "NEGOTIATE_" + op_name)

    def negotiate_end(self, name: str):
        self._emit(name, "E", "")

    def start_activity(self, name: str, activity: str):
        self._emit(name, "B", activity)

    def end_activity(self, name: str):
        self._emit(name, "E", "")

    def mark_cycle_start(self):
        if self.enabled and self.mark_cycles:
            self._put({"ph": "i", "ts": self._ts_us(), "pid": 0, "tid": 0,
                       "name": "CYCLE_START", "s": "g"})

    # -- writer thread ------------------------------------------------------
    def _writer(self):
        """Write what the queue holds, one ``write`` and one ``flush`` a
        batch, until ``close`` puts the None that ends it."""
        while True:
            try:
                batch = [self._q.get(timeout=0.5)]
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            while batch[-1] is not None:
                try:
                    batch.append(self._q.get_nowait())
                except queue.Empty:
                    break
            done = batch[-1] is None
            recs = [r for r in batch if r is not None]
            if recs and self._file:
                self._file.write("".join(json.dumps(r) + ",\n"
                                         for r in recs))
                self._file.flush()
            if done:
                return


_PROFILER = None


def start_torch_profiler(logdir: str):
    """Device-side profiling bridge: a ``torch.profiler`` trace of the CPU
    and, where there is one, the card, written as a Chrome trace into
    ``logdir`` by ``stop_torch_profiler`` (the port's counterpart of the
    JAX package's ``start_jax_profiler``)."""
    global _PROFILER
    import torch

    if _PROFILER is not None:
        raise RuntimeError("a torch profiler trace is already running")
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    _PROFILER = (prof, logdir)


def stop_torch_profiler() -> str:
    """Stop the trace ``start_torch_profiler`` began; returns the path of
    the Chrome trace it wrote."""
    global _PROFILER
    if _PROFILER is None:
        raise RuntimeError("no torch profiler trace is running")
    prof, logdir = _PROFILER
    _PROFILER = None
    prof.stop()
    path = os.path.join(logdir, f"torch_trace.{os.getpid()}.json")
    prof.export_chrome_trace(path)
    return path
