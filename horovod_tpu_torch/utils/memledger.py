"""The device-memory and build ledger: memory samples, kernel-library
loads and plan builds, OOM forensics — the port of
``horovod_tpu/utils/memledger.py``, with its names.

- **Memory**: each sample reads ``torch.cuda.memory_stats`` of this
  process's device (allocated and reserved bytes, current and peak, the
  allocator's retries and out-of-memory count); on the CPU it falls back to
  the bytes of the live tensors. Samples are taken on the metrics dumper's
  cadence and at events: a plan build, an elastic resize
  (``elastic_resize``), a sharded layout's rebuild
  (``sharded_layout_rebuild``) and a change of the sharded optimizer
  state (``sharded_state_build``). Each carries the components: the
  runtime's fusion buffer (``fusion_buffer``, the JAX package's staging
  ring), the plan cache, the error-feedback residuals and the sharded
  optimizer state (pushed by ``opt/sharded.py`` and the whole-leaf front
  end through :func:`note_sharded_state`). Exposure: the ``hvd_mem_*``
  series, the ``mem/rank{k}`` push merged by the launcher's
  ``GET /memory``, and ``hvd.memory_report()``.
- **Builds**: the port compiles no XLA program. Its counterpart of a
  compile is loading a kernel library (``ops/_build.py``): the seconds,
  the ``.so``'s bytes and whether the library was there (a hit) or
  ``nvcc`` ran (a miss), keyed by kernel; and a plan's build at its first
  request (``ops/collectives.py``), keyed by plan kind. Both count in
  ``hvd_compile_seconds{kind}`` and ``hvd_compile_program_bytes_total``
  and take a ``plan_build`` sample.
- **Forensics**: :func:`forensics` is the memory section of a diagnostic
  bundle (``utils/diag.py``): the last samples, the components, the
  largest live blocks (``torch.cuda.memory_snapshot()``, read on this path
  only; the allocator's history is never armed here) and the suspect,
  the dominant component.

Zero-cost contract: with ``HOROVOD_MEMLEDGER`` unset no ledger exists, a
hook pays one ``is None`` check and no ``hvd_mem_*``/``hvd_compile_*``
series is registered.
"""

from __future__ import annotations

import collections
import gc
import logging
import sys
import time
from typing import List, Optional

from ..common import env as env_schema
from . import flightrec as flightrec_mod
from . import lockcheck

LOG = logging.getLogger("horovod_tpu_torch")

#: The KV scope of the dumper's per-rank pushes (``mem/rank{k}``), merged
#: by the launcher's ``GET /memory``.
KV_SCOPE = "mem"

DEFAULT_CAPACITY = 512

#: How many build records the ring keeps.
COMPILE_RING = 256

#: The components every sample carries.
COMPONENTS = ("plan_cache", "fusion_buffer", "ef_residuals",
              "sharded_state")


def _cuda_device():
    """This process's CUDA device when CUDA is already in use, else None:
    the ledger never initializes CUDA itself."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    try:
        from ..common import context as context_mod

        dev = context_mod._ctx.device
    except Exception:
        dev = None
    if dev is not None:
        return dev if dev.type == "cuda" else None
    return torch.device("cuda", torch.cuda.current_device())


def _device_memory() -> List[dict]:
    """The caching allocator's statistics of this process's device; empty
    on the CPU, where the caller falls back to the live tensors."""
    dev = _cuda_device()
    if dev is None:
        return []
    import torch

    try:
        st = torch.cuda.memory_stats(dev)
        limit = torch.cuda.get_device_properties(dev).total_memory
    except Exception:
        return []
    return [{
        "device": str(dev),
        "bytes_in_use": int(st.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak", 0)),
        "reserved_bytes": int(st.get("reserved_bytes.all.current", 0)),
        "peak_reserved_bytes": int(st.get("reserved_bytes.all.peak", 0)),
        "num_alloc_retries": int(st.get("num_alloc_retries", 0)),
        "num_ooms": int(st.get("num_ooms", 0)),
        "bytes_limit": int(limit),
    }]


def _live_tensors() -> list:
    """The distinct storages of the live tensors of this process, as
    ``(tensor, nbytes)``: the CPU's counterpart of the allocator's
    statistics (no limit, no allocator overhead)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return []
    seen, out = set(), []
    # type(), not isinstance(): the latter reads ``__class__``, which a
    # deprecated attribute object answers with a warning
    objs = [o for o in gc.get_objects()
            if issubclass(type(o), torch.Tensor)]
    for obj in objs:
        try:
            if obj.is_meta:
                continue
            st = obj.untyped_storage()
            key = (st.data_ptr(), str(obj.device))
            if key in seen or st.nbytes() == 0:
                continue
            seen.add(key)
            out.append((obj, int(st.nbytes())))
        except Exception:
            continue
    return out


def _live_tensor_bytes() -> int:
    return sum(n for _, n in _live_tensors())


def top_live_buffers(n: int = 10) -> List[dict]:
    """The ``n`` largest live blocks: the caching allocator's active blocks
    on the card (``torch.cuda.memory_snapshot()``), the live tensors'
    storages on the CPU."""
    n = max(int(n), 0)
    dev = _cuda_device()
    if dev is not None:
        import torch

        try:
            segments = torch.cuda.memory_snapshot()
        except Exception:
            return []
        blocks = []
        for seg in segments:
            if seg.get("device", dev.index) != dev.index:
                continue
            for b in seg.get("blocks", ()):
                if b.get("state") == "active_allocated":
                    blocks.append({"nbytes": int(b.get("size", 0)),
                                   "address": int(b.get("address", 0)),
                                   "segment_type": seg.get("segment_type"),
                                   "stream": seg.get("stream")})
        blocks.sort(key=lambda i: -i["nbytes"])
        return blocks[:n]
    infos = [{"shape": list(t.shape), "dtype": str(t.dtype), "nbytes": nb,
              "device": str(t.device)} for t, nb in _live_tensors()]
    infos.sort(key=lambda i: -i["nbytes"])
    return infos[:n]


class MemLedger:
    """A bounded ring of memory samples and the build records.

    ``sample()`` runs on the dumper's cadence and at rare events, never a
    cycle; ``record_compile()`` at a kernel-library load or a plan build.
    Both are safe from any thread."""

    def __init__(self, rank: int = 0, capacity: int = DEFAULT_CAPACITY):
        self.rank = rank
        self.capacity = max(int(capacity), 16)
        self._lock = lockcheck.make_lock("memledger.ring")
        self._ring = collections.deque(maxlen=self.capacity)  # guarded-by: _lock
        self._components: dict = {}  # guarded-by: _lock
        self._peak_live = 0  # guarded-by: _lock
        self._samples_total = 0  # guarded-by: _lock
        self._compiles = collections.deque(maxlen=COMPILE_RING)  # guarded-by: _lock
        self._compile_total_s = 0.0  # guarded-by: _lock
        self._compile_count = 0  # guarded-by: _lock
        self._compile_bytes = 0  # guarded-by: _lock
        from . import metrics as metrics_mod

        self._reg = metrics_mod.get_registry()
        self._m_live = self._reg.gauge(
            "hvd_mem_live_bytes",
            "live device (or host tensor) bytes at the last sample")
        self._m_peak = self._reg.gauge(
            "hvd_mem_peak_bytes",
            "high-watermark of live bytes (the allocator's peak on the "
            "card, else the largest sampled live bytes)")
        self._m_comp = {comp: self._component_gauge(comp)
                        for comp in COMPONENTS}
        self._m_samples: dict = {}
        self._m_compile_s: dict = {}
        self._m_compile_bytes: dict = {}
        self._m_persistent: dict = {}

    def _component_gauge(self, comp: str):
        return self._reg.gauge(
            "hvd_mem_component_bytes",
            "attributed bytes held by one runtime component",
            component=comp)

    # -- memory -----------------------------------------------------------

    def _pull_components(self) -> dict:
        """The components' bytes from their owners, best effort."""
        comps = {}
        try:
            from ..ops import collectives as collectives_mod

            comps["plan_cache"] = int(collectives_mod.plan_cache_bytes())
        except Exception:
            pass
        try:
            from ..common import context as context_mod

            runtime = getattr(context_mod._ctx, "runtime", None)
        except Exception:
            runtime = None
        if runtime is not None:
            try:
                comps["fusion_buffer"] = int(
                    runtime.fusion_buffer.allocated_bytes())
            except Exception:
                pass
            try:
                store = getattr(runtime, "_quant_residuals", None)
                if store is not None:
                    comps["ef_residuals"] = int(store.nbytes())
            except Exception:
                pass
        return comps

    def sample(self, event: str = "interval", **extra) -> dict:
        """Take one sample and publish the ``hvd_mem_*`` series. ``event``
        says why (``interval``, ``plan_build``, ``elastic_resize``,
        ``sharded_layout_rebuild``, ``sharded_state_build``); ``extra``
        (a plan build's ``kind``) rides in the sample."""
        devices = _device_memory()
        live = sum(d["bytes_in_use"] for d in devices)
        dev_peak = sum(d["peak_bytes_in_use"] for d in devices)
        source = "memory_stats"
        if not devices:
            live = _live_tensor_bytes()
            source = "live_tensors"
        pulled = self._pull_components()
        with self._lock:
            self._components.update(pulled)
            comps = dict(self._components)
            self._peak_live = max(self._peak_live, live, dev_peak)
            peak = self._peak_live
            self._samples_total += 1
            snap = {"ts": time.time(), "ts_mono": time.monotonic(),
                    "event": event, "source": source,
                    "live_bytes": int(live), "peak_bytes": int(peak),
                    "devices": devices, "components": comps}
            snap.update(extra)
            self._ring.append(snap)
        self._m_live.set(int(live))
        self._m_peak.set(int(peak))
        for comp, nbytes in comps.items():
            gauge = self._m_comp.get(comp)
            if gauge is None:
                gauge = self._m_comp[comp] = self._component_gauge(comp)
            gauge.set(int(nbytes))
        counter = self._m_samples.get(event)
        if counter is None:
            counter = self._m_samples[event] = self._reg.counter(
                "hvd_mem_samples_total", "memory-ledger samples taken",
                event=event)
        counter.inc()
        return snap

    def set_component(self, component: str, nbytes: int) -> None:
        """Push-style attribution, for owners that know their bytes when
        they (re)build (the sharded optimizer state)."""
        nbytes = int(nbytes)
        with self._lock:
            self._components[component] = nbytes
        gauge = self._m_comp.get(component)
        if gauge is None:
            gauge = self._m_comp[component] = self._component_gauge(
                component)
        gauge.set(nbytes)

    def components(self) -> dict:
        with self._lock:
            return dict(self._components)

    def samples(self, last: Optional[int] = None) -> List[dict]:
        """The ring, oldest first (``last``: the newest N)."""
        with self._lock:
            out = list(self._ring)
        if last is not None:
            out = out[-int(last):]
        return out

    # -- builds -----------------------------------------------------------

    def record_compile(self, kind: str, seconds: float,
                       program_bytes: int = 0,
                       persistent: Optional[str] = None,
                       **extra) -> None:
        """Account one build: a kernel library's load (``kind`` "kernel",
        ``extra`` its name, ``program_bytes`` the ``.so``'s bytes,
        ``persistent`` "hit" or "miss") or a plan's (``kind`` the plan's
        kind). Counts the ``hvd_compile_*`` series, notes a ``compile``
        flight-recorder event and takes a ``plan_build`` sample."""
        seconds = max(float(seconds), 0.0)
        program_bytes = max(int(program_bytes), 0)
        entry = {"ts": time.time(), "kind": kind,
                 "seconds": round(seconds, 6),
                 "program_bytes": program_bytes,
                 "persistent_cache": persistent}
        entry.update(extra)
        with self._lock:
            self._compiles.append(entry)
            self._compile_total_s += seconds
            self._compile_count += 1
            self._compile_bytes += program_bytes
        hist = self._m_compile_s.get(kind)
        if hist is None:
            from . import metrics as metrics_mod

            hist = self._m_compile_s[kind] = self._reg.histogram(
                "hvd_compile_seconds",
                "kernel-library load or plan build wall time",
                buckets=metrics_mod.LATENCY_BUCKETS_S, kind=kind)
        hist.observe(seconds)
        ctr = self._m_compile_bytes.get(kind)
        if ctr is None:
            ctr = self._m_compile_bytes[kind] = self._reg.counter(
                "hvd_compile_program_bytes_total",
                "kernel-library bytes loaded, by kind", kind=kind)
        ctr.inc(program_bytes)
        if persistent is not None:
            pctr = self._m_persistent.get(persistent)
            if pctr is None:
                pctr = self._m_persistent[persistent] = self._reg.counter(
                    "hvd_compile_persistent_cache_total",
                    "kernel libraries found built (hit) or built (miss)",
                    verdict=persistent)
            pctr.inc()
        flightrec_mod.note("compile", kind=kind, seconds=round(seconds, 4),
                           program_bytes=program_bytes,
                           persistent_cache=persistent, rank=self.rank,
                           **extra)
        self.sample(event="plan_build", kind=kind, **extra)

    def compile_stats(self) -> dict:
        """The builds by kind, with the kernel-library loads of the whole
        process (``ops/_build.py`` keeps them from before the ledger
        existed)."""
        with self._lock:
            entries = list(self._compiles)
            total_s = self._compile_total_s
            count = self._compile_count
            total_bytes = self._compile_bytes
        secs = sorted(e["seconds"] for e in entries)
        by_kind: dict = {}
        persistent = {"hit": 0, "miss": 0, "unknown": 0}
        for e in entries:
            k = by_kind.setdefault(e["kind"],
                                   {"compiles": 0, "seconds": 0.0,
                                    "program_bytes": 0})
            k["compiles"] += 1
            k["seconds"] = round(k["seconds"] + e["seconds"], 6)
            k["program_bytes"] += e["program_bytes"]
            verdict = e["persistent_cache"] or "unknown"
            persistent[verdict] = persistent.get(verdict, 0) + 1
        from ..ops import _build
        from .perfledger import _percentile

        return {"compiles": count,
                "compile_seconds_total": round(total_s, 6),
                "compile_seconds_p95": round(_percentile(secs, 0.95), 6),
                "compile_program_bytes_total": int(total_bytes),
                "persistent_cache": persistent,
                "by_kind": by_kind,
                "kernel_loads": _build.load_records()}

    # -- views ------------------------------------------------------------

    def suspect_component(self) -> Optional[str]:
        """The dominant component, the OOM forensics' verdict; None before
        anything is attributed."""
        with self._lock:
            comps = dict(self._components)
        comps = {k: v for k, v in comps.items() if v > 0}
        if not comps:
            return None
        return max(comps.items(), key=lambda kv: kv[1])[0]

    def forensics(self, last_samples: int = 20, buffers: int = 10) -> dict:
        """A bundle's memory section."""
        with self._lock:
            peak = self._peak_live
        return {"enabled": True,
                "peak_bytes": int(peak),
                "components": self.components(),
                "suspect": self.suspect_component(),
                "recent_samples": self.samples(last=last_samples),
                "top_live_buffers": top_live_buffers(buffers),
                "compile": self.compile_stats()}

    def snapshot(self) -> dict:
        """The ``mem/rank{k}`` push: the components, the newest samples
        and the builds."""
        with self._lock:
            total = self._samples_total
            peak = self._peak_live
        recent = self.samples()
        live = recent[-1]["live_bytes"] if recent else 0
        return {"rank": self.rank, "ts": time.time(),
                "samples": total,
                "live_bytes": int(live), "peak_bytes": int(peak),
                "components": self.components(),
                "recent": recent[-5:],
                "compile": self.compile_stats()}

    def report(self) -> dict:
        """``hvd.memory_report()`` for this rank."""
        out = self.snapshot()
        out["enabled"] = True
        out["capacity"] = self.capacity
        out["suspect"] = self.suspect_component()
        return out


# The process's ledger: get_ledger() returns None when HOROVOD_MEMLEDGER is
# off, and every hook costs one is-None check then.

_LEDGER: Optional[MemLedger] = None


def enabled() -> bool:
    return env_schema.get_bool(env_schema.HOROVOD_MEMLEDGER)


def get_ledger() -> Optional[MemLedger]:
    return _LEDGER


def init_ledger(rank: int = 0, on: Optional[bool] = None,
                capacity: Optional[int] = None) -> Optional[MemLedger]:
    """Create the process's ledger when ``on`` (default:
    ``HOROVOD_MEMLEDGER``), with a ring of ``capacity`` samples (default:
    ``HOROVOD_MEMLEDGER_BUFFER``); idempotent; None when it is off.
    ``hvd.init()`` passes its ``RuntimeConfig``'s fields."""
    global _LEDGER
    if not (enabled() if on is None else on):
        return _LEDGER
    if _LEDGER is None:
        if capacity is None:
            capacity = env_schema.get_int(
                env_schema.HOROVOD_MEMLEDGER_BUFFER, DEFAULT_CAPACITY)
        _LEDGER = MemLedger(rank=rank, capacity=capacity)
    return _LEDGER


def reset_ledger() -> None:
    """Drop the process's ledger (tests)."""
    global _LEDGER
    _LEDGER = None


def sample_event(event: str) -> None:
    """An event's sample when the ledger is on (elastic resizes, sharded
    layout rebuilds)."""
    ledger = _LEDGER
    if ledger is None:
        return
    ledger.sample(event=event)


def note_plan_build(kind: str, seconds: float) -> None:
    """A plan built at its first request (``ops/collectives.py``)."""
    ledger = _LEDGER
    if ledger is None:
        return
    ledger.record_compile(kind, seconds)


def note_kernel_load(record: dict) -> None:
    """A kernel library loaded (``ops/_build.py``)."""
    ledger = _LEDGER
    if ledger is None:
        return
    ledger.record_compile("kernel", record["seconds"], record["so_bytes"],
                          persistent=record["cache"],
                          kernel=record["kernel"])


def note_sharded_state(optimizer) -> None:
    """The sharded optimizer state's bytes (the ZeRO-1 claim, measured):
    called after a sharded step; a sample is taken when the bytes
    changed (the state is made at the first step and at a rebuild)."""
    ledger = _LEDGER
    if ledger is None:
        return
    from ..opt.sharded import optimizer_state_bytes

    total = optimizer_state_bytes(optimizer)
    if ledger.components().get("sharded_state") == total:
        return
    ledger.set_component("sharded_state", total)
    ledger.sample(event="sharded_state_build")


def forensics() -> dict:
    """A bundle's memory section: ``{"enabled": False}`` and the largest
    live blocks when the ledger is off, the whole view when it is on."""
    ledger = _LEDGER
    if ledger is None:
        return {"enabled": False, "top_live_buffers": top_live_buffers(10)}
    return ledger.forensics()


def report() -> dict:
    """``hvd.memory_report()``: ``{"enabled": False}`` when the ledger is
    off, else this rank's samples, components and builds."""
    ledger = _LEDGER
    if ledger is None:
        return {"enabled": False}
    return ledger.report()
