"""Preemption-tolerant async sharded checkpointing — counterpart of
``horovod_tpu/utils/async_ckpt.py``.

Under the ZeRO-1 engine (``opt/sharded.py``) each rank holds 1/N of the
optimizer's state, so a checkpoint can be sharded and kept off the
critical path: each rank snapshots its own shard (rank 0 also the
replicated leaves), hands the host copy to a writer thread and trains on.
The writer commits it through ``utils/checkpoint.py`` (tmp, fsync,
rename) as ``shard_rank{k}.ckpt`` and stamps ``manifest_rank{k}.json``
with the world, the step, the elastic generation, the layout's digest,
the bytes and the file's sha1.

The hot path is the snapshot's copy to the host. A CUDA tensor goes to a
pinned buffer on a side stream, after an event recorded on the current
stream, and the current stream then waits on the copy's event: the next
step's optimizer, which updates the shard in place on that stream, cannot
run before its bytes are copied. The host waits for nothing; the writer
thread waits for the copy before it serializes. The queue is depth-1 and
newest-wins: a slow disk drops a superseded snapshot
(``hvd_ckpt_dropped_total``) instead of blocking a step. Pinned buffers
are pooled by shape and dtype and come back when their snapshot is
written or dropped.

What a shard file holds is the JAX package's dict (``rank``, ``world``,
``step``, ``generation``, ``layout_digest``, ``shard_state``,
``replicated``) with numpy arrays, so each package reads the other's
directory. A torch optimizer's ``state_dict`` is stored keyed as the JAX
engine keys its combined state, ``{"state": {"rep": {"%05d" leaf index:
...}, "shard": {dtype: ...}}, "param_groups": [...]}``, so the JAX
package's ``assemble_full_state`` finds the shard leaves by the same path
rule. numpy has no bfloat16: a bf16 tensor is stored widened to float32,
exactly, and the restore's ``load_state_dict`` narrows it back to the
parameter's dtype bit for bit.

Restore (module functions, which work with the checkpointer off): the
newest consistent manifest set (every rank of one step, generation,
digest and world, checksums verified) names the snapshot; the saved
world's layout is planned again (digest-checked), each shard leaf is
concatenated over the ranks and trimmed to its group, and
``ShardedUpdateEngine.load_full_state`` cuts the current world's shard,
so the restoring world may differ (N→M). A directory the JAX package
wrote holds an optax state: its ``trace`` (SGD's momentum) and Adam's
``mu``, ``nu`` and ``count`` become the torch optimizer's
``momentum_buffer``, ``exp_avg``, ``exp_avg_sq`` and ``step``.

``HOROVOD_ASYNC_CKPT=1`` makes ``hvd.init()`` create the process's
checkpointer (``HOROVOD_ASYNC_CKPT_DIR``, default ``./horovod_ckpt``) and
install a SIGTERM handler that flushes it within the grace window
(``HOROVOD_PREEMPT_GRACE_S``), then dies of the signal as before. Unset,
no checkpointer exists and no ``hvd_ckpt_*`` series is registered. A
commit, a failed commit, a restore and a preemption each leave a
``checkpoint`` note in the flight recorder (``utils/flightrec.py``). Not
ported yet (ROADMAP.md queue 1 item 6): the launcher's ``/checkpoint``
endpoint.
"""

from __future__ import annotations

import copy
import hashlib
import json
import logging
import os
import re
import signal
import threading
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..common import env as env_schema
from ..common.exceptions import FaultInjectedError
from . import faults, flightrec, lockcheck

LOG = logging.getLogger("horovod_tpu_torch")

DEFAULT_DIR = "./horovod_ckpt"

#: The KV scope of the metrics dumper's status pushes (``ckpt/rank{k}``),
#: merged by the launcher's ``GET /checkpoint``.
KV_SCOPE = "ckpt"

_SHARD_FMT = "shard_rank{rank}.ckpt"
_MANIFEST_FMT = "manifest_rank{rank}.json"
_MANIFEST_RE = re.compile(r"manifest_rank(\d+)\.json$")


class CheckpointError(RuntimeError):
    """A checkpoint directory is unreadable, inconsistent or fails its
    checksum; a restore's caller decides whether to start cold."""


def _sha1_file(path: str) -> str:
    h = hashlib.sha1()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _rep_key(i: int) -> str:
    return f"{i:05d}"


# --------------------------------------------------------------------------
# Trees: dicts, lists, tuples and named tuples (an optax state), walked
# without JAX. A path element is ("d", key), ("a", field) or ("i", index);
# shard leaves are found by their path, as JAX's _shard_group_for does.
# --------------------------------------------------------------------------


def _map_tree(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn, path + (("d", k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map_tree(v, fn, path + (("a", f),))
                            for f, v in zip(tree._fields, tree)])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(v, fn, path + (("i", i),))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def _leaves(tree) -> list:
    out = []
    _map_tree(tree, lambda p, x: out.append((p, x)))
    return out


def _get(tree, path):
    for kind, k in path:
        tree = getattr(tree, k) if kind == "a" else tree[k]
    return tree


def _shard_dtype(path) -> Optional[str]:
    """The dtype key under a ``"shard"`` dict key, as JAX's
    ``_shard_group_for`` reads a path."""
    seen = False
    for kind, k in path:
        if kind != "d":
            continue
        if seen:
            return k
        if k == "shard":
            seen = True
    return None


def _shard_group_for(layout, path, leaf, full_extent: bool = False):
    dt = _shard_dtype(path)
    if dt is None:
        return None
    for g in layout.groups:
        if g.dtype == dt:
            want = g.total if full_extent else g.shard_elems
            shape = np.shape(leaf)
            return g if len(shape) == 1 and shape[0] == want else None
    return None


# --------------------------------------------------------------------------
# A torch optimizer's state over the engine's combined parameters, keyed
# as the JAX engine keys its combined state (module docstring).
# --------------------------------------------------------------------------


def _is_torch_state(sd) -> bool:
    return isinstance(sd, dict) and set(sd) == {"state", "param_groups"}


def keyed_state(sd: dict, layout) -> dict:
    """``sd`` (positions: the replicated leaves, then one shard a dtype
    group) with its per-parameter state keyed ``rep/<leaf>`` and
    ``shard/<dtype>``."""
    nrep = len(layout.replicated)
    rep, shard = {}, {}
    for idx, st in sd["state"].items():
        i = int(idx)
        if i < nrep:
            rep[_rep_key(layout.replicated[i])] = st
        else:
            shard[layout.groups[i - nrep].dtype] = st
    return {"state": {"rep": rep, "shard": shard},
            "param_groups": sd["param_groups"]}


def positional_state(keyed: dict, layout) -> dict:
    """The inverse of :func:`keyed_state`, with torch tensors."""
    pos = {_rep_key(i): n for n, i in enumerate(layout.replicated)}
    nrep = len(layout.replicated)
    state = {}
    for k, st in keyed["state"].get("rep", {}).items():
        state[pos[k]] = _to_torch(st)
    for n, g in enumerate(layout.groups):
        st = keyed["state"].get("shard", {}).get(g.dtype)
        if st is not None:
            state[nrep + n] = _to_torch(st)
    return {"state": state, "param_groups": copy.deepcopy(
        keyed["param_groups"])}


# optax's state fields and the torch optimizers' names for them
_OPTAX_FIELDS = {"trace": "momentum_buffer", "mu": "exp_avg",
                 "nu": "exp_avg_sq"}


def optax_to_torch_state(full, layout, param_groups) -> dict:
    """A full state the JAX package assembled from an optax state (SGD's
    ``trace``, Adam's ``mu``/``nu``/``count``) as a torch ``state_dict``
    over the engine's combined parameters."""
    pos = {_rep_key(i): n for n, i in enumerate(layout.replicated)}
    nrep = len(layout.replicated)
    npos = nrep + len(layout.groups)
    state: dict = {}
    count = None
    for path, leaf in _leaves(full):
        names = [k for kind, k in path if kind in ("a", "d")]
        if names and names[-1] == "count":
            count = leaf
            continue
        field = next((k for k in names if k in _OPTAX_FIELDS), None)
        if field is None:
            if np.size(leaf) == 0:
                continue
            raise CheckpointError(
                f"cannot map the optax state leaf at {names} onto a torch "
                "optimizer (known: trace, mu, nu, count)")
        dt = _shard_dtype(path)
        if dt is not None:
            p = nrep + [g.dtype for g in layout.groups].index(dt)
        else:
            p = pos[names[names.index("rep") + 1]]
        state.setdefault(p, {})[_OPTAX_FIELDS[field]] = _to_torch(leaf)
    if count is not None:
        for p in range(npos):
            state.setdefault(p, {})["step"] = torch.tensor(
                float(np.asarray(count)), dtype=torch.float32)
    return {"state": state, "param_groups": copy.deepcopy(param_groups)}


# --------------------------------------------------------------------------
# Host copies
# --------------------------------------------------------------------------


def _numpy_of(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()  # numpy has no bfloat16: widened, exactly
    return t.cpu().numpy()


def _to_torch(tree):
    """``tree`` with its numpy arrays as torch tensors."""
    def conv(_, x):
        if isinstance(x, np.ndarray):
            if x.dtype.kind == "V" or x.dtype.name == "bfloat16":
                x = x.astype(np.float32)  # ml_dtypes' bfloat16: exact
            return torch.from_numpy(np.array(x, copy=True))
        return copy.deepcopy(x)
    return _map_tree(tree, conv)


def _host_arrays(tree):
    """``tree``'s host tensors as numpy arrays, for the writer: views where
    the dtype allows (pickling copies them out), bf16 widened."""
    return _map_tree(tree, lambda _, x: _numpy_of(x)
                     if isinstance(x, torch.Tensor) else x)


class _Staging:
    """One snapshot's host copies: CUDA tensors into pooled pinned buffers
    on the side stream (module docstring), the rest copied now."""

    def __init__(self, ckpt: "AsyncCheckpointer"):
        self._ckpt = ckpt
        self.buffers: list = []
        self._starts: list = []
        self.events: list = []
        self.nbytes = 0
        self._started = {}

    def stage(self, tree):
        def leaf(_, x):
            if isinstance(x, torch.Tensor):
                self.nbytes += x.numel() * x.element_size()
                if x.is_cuda:
                    return self._copy_cuda(x)
                return x.detach().clone()
            if isinstance(x, np.ndarray):
                self.nbytes += x.nbytes
                return np.array(x, copy=True)
            return copy.deepcopy(x)
        return _map_tree(tree, leaf)

    def _copy_cuda(self, t: torch.Tensor):
        dev = t.device
        side = self._ckpt._side_stream(dev)
        if dev not in self._started:
            # the copies follow the work queued so far on this stream
            side.wait_stream(torch.cuda.current_stream(dev))
            self._started[dev] = side
            start = torch.cuda.Event(enable_timing=True)
            start.record(side)
            self._starts.append(start)
        buf = self._ckpt._take_buffer(tuple(t.shape), t.dtype)
        self.buffers.append(buf)
        with torch.cuda.stream(side):
            buf.copy_(t.detach(), non_blocking=True)
        t.record_stream(side)
        return buf

    def finish(self):
        """Make each device's current stream wait on its copies."""
        for dev, side in self._started.items():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(side)
            torch.cuda.current_stream(dev).wait_event(ev)
            self.events.append(ev)
        return self

    def wait(self) -> float:
        """Wait for the copies; returns their device milliseconds (the
        longest stream's; 0 when nothing went through a stream)."""
        for ev in self.events:
            ev.synchronize()
        return max((a.elapsed_time(b)
                    for a, b in zip(self._starts, self.events)), default=0.0)


class AsyncCheckpointer:
    """Per-rank async shard writer with a depth-1, newest-wins queue.

    ``snapshot()`` is the training loop's hook: host copy and enqueue,
    never the disk. The writer thread commits each accepted snapshot as a
    shard file and a manifest; ``flush()`` drains synchronously under a
    deadline (also the SIGTERM handler's body)."""

    def __init__(self, rank: int = 0, world: int = 1,
                 directory: Optional[str] = None):
        self.rank = int(rank)
        self.world = int(world)
        self.directory = (directory
                          or env_schema.get_str(
                              env_schema.HOROVOD_ASYNC_CKPT_DIR)
                          or DEFAULT_DIR)
        os.makedirs(self.directory, exist_ok=True)
        self._lock = lockcheck.make_lock("async_ckpt.state")
        self._pending: Optional[dict] = None  # guarded-by: _lock
        self._inflight = False  # guarded-by: _lock
        self._pool: dict = {}  # guarded-by: _lock
        self._streams: dict = {}
        self._wakeup = threading.Event()
        self._stop = threading.Event()
        # the freshest readings, for report()
        self.last_copy_s = 0.0  # snapshot()'s host time
        self.last_copy_device_ms = 0.0  # its copies on the side stream
        self.last_write_s = 0.0
        self.last_restore_s = 0.0
        self.last_snapshot_bytes = 0
        self.last_shard_bytes = 0
        self.last_step: Optional[int] = None
        from . import metrics as metrics_mod

        reg = metrics_mod.get_registry()
        self._m_snapshots = reg.counter(
            "hvd_ckpt_snapshots_total",
            "shard snapshots accepted by the async checkpointer")
        self._m_dropped = reg.counter(
            "hvd_ckpt_dropped_total",
            "snapshots superseded before the writer committed them")
        self._m_commits = reg.counter(
            "hvd_ckpt_commits_total",
            "shard checkpoint files committed (tmp + fsync + rename)")
        self._m_failures = reg.counter(
            "hvd_ckpt_failures_total",
            "shard checkpoint commits that failed (kept training)")
        self._m_bytes = reg.counter(
            "hvd_ckpt_bytes_total", "committed shard checkpoint bytes")
        self._m_write = reg.histogram(
            "hvd_ckpt_write_seconds",
            "background shard commit duration (shard file + manifest)",
            buckets=metrics_mod.LATENCY_BUCKETS_S)
        self._m_last_step = reg.gauge(
            "hvd_ckpt_last_step", "newest durably committed step")
        self._m_restores = reg.counter(
            "hvd_ckpt_restores_total",
            "shard-checkpoint restores served (incl. N->M re-slices)")
        self._thread = threading.Thread(
            target=self._writer_loop, daemon=True, name="hvd-async-ckpt")
        self._thread.start()

    # -- pinned buffers -----------------------------------------------------

    def _side_stream(self, dev):
        s = self._streams.get(dev)
        if s is None:
            s = self._streams[dev] = torch.cuda.Stream(dev)
        return s

    def _take_buffer(self, shape: tuple, dtype) -> torch.Tensor:
        with self._lock:
            free = self._pool.get((shape, dtype))
            if free:
                return free.pop()
        return torch.empty(shape, dtype=dtype, pin_memory=True)

    def _release(self, job: Optional[dict]):
        if job is None:
            return
        with self._lock:
            for b in job.pop("_buffers", ()):
                self._pool.setdefault((tuple(b.shape), b.dtype),
                                      []).append(b)

    # -- hot path -----------------------------------------------------------

    def snapshot(self, step: int, shard: Any, *,
                 replicated: Any = None, layout=None,
                 generation: Optional[int] = None) -> bool:
        """Accept one snapshot: ``shard`` is this rank's own state (the
        engine's ``optimizer.state_dict()`` under ZeRO-1, keyed by
        ``layout``), ``replicated`` the replicated leaves (rank 0 only).
        ``layout`` stamps the digest that ties the snapshot to its world.
        Returns False when it displaced a snapshot not yet written."""
        t0 = time.perf_counter()
        if generation is None:
            generation = env_schema.get_int(env_schema.HOROVOD_ELASTIC_GEN, 0)
        if layout is not None and _is_torch_state(shard):
            shard = keyed_state(shard, layout)
        staging = _Staging(self)
        job = {
            "rank": self.rank,
            "world": self.world,
            "step": int(step),
            "generation": int(generation),
            "layout_digest": getattr(layout, "digest", "") or "",
            "shard_state": staging.stage(shard),
            "replicated": (staging.stage(replicated)
                           if replicated is not None else None),
        }
        job["_staging"] = staging.finish()
        job["_buffers"] = staging.buffers
        self.last_copy_s = time.perf_counter() - t0
        self.last_snapshot_bytes = staging.nbytes
        with self._lock:
            displaced = self._pending
            self._pending = job
        self._release(displaced)
        self._m_snapshots.inc()
        if displaced is not None:
            self._m_dropped.inc()
        self._wakeup.set()
        return displaced is None

    # -- background writer --------------------------------------------------

    def _writer_loop(self):
        while not self._stop.is_set():
            self._wakeup.wait(timeout=0.2)
            self._wakeup.clear()
            self._drain()

    def _take(self) -> Optional[dict]:
        with self._lock:
            job = self._pending
            self._pending = None
            if job is not None:
                self._inflight = True
            return job

    def _done(self):
        with self._lock:
            self._inflight = False

    def _drain(self):
        while True:
            job = self._take()
            if job is None:
                return
            try:
                self._commit(job)
            except Exception as e:
                # opt-in durability: a failed commit is loud, never fatal
                self._m_failures.inc()
                flightrec.note("checkpoint", event="commit_failed",
                               step=job["step"], error=type(e).__name__)
                LOG.warning("async ckpt: commit of step %d failed: %s",
                            job["step"], e)
            finally:
                self._release(job)
                self._done()

    def _commit(self, job: dict):
        t0 = time.perf_counter()
        faults.fault_point("ckpt.write")
        from ..common.util import atomic_write_bytes
        from . import checkpoint as ckpt_mod

        self.last_copy_device_ms = job["_staging"].wait()
        payload = {k: (_host_arrays(v) if k in ("shard_state", "replicated")
                       else v)
                   for k, v in job.items() if not k.startswith("_")}
        shard_path = os.path.join(
            self.directory, _SHARD_FMT.format(rank=job["rank"]))
        ckpt_mod.save_pytree(shard_path, payload)
        del payload
        nbytes = os.path.getsize(shard_path)
        manifest = {
            "rank": job["rank"],
            "world": job["world"],
            "step": job["step"],
            "generation": job["generation"],
            "layout_digest": job["layout_digest"],
            "checksum": _sha1_file(shard_path),
            "bytes": nbytes,
            "ts": time.time(),
        }
        atomic_write_bytes(
            os.path.join(self.directory,
                         _MANIFEST_FMT.format(rank=job["rank"])),
            json.dumps(manifest).encode())
        dt = time.perf_counter() - t0
        self.last_write_s = dt
        self.last_shard_bytes = nbytes
        self.last_step = job["step"]
        self._m_commits.inc()
        self._m_bytes.inc(nbytes)
        self._m_write.observe(dt)
        self._m_last_step.set(job["step"])
        flightrec.note("checkpoint", event="commit", step=job["step"],
                       generation=job["generation"], bytes=nbytes,
                       digest=(job["layout_digest"] or "")[:12])

    # -- flush (SIGTERM / shutdown path) ------------------------------------

    def flush(self, deadline_s: Optional[float] = None) -> bool:
        """Drain the in-flight and the pending snapshot synchronously,
        within ``deadline_s``. True when everything accepted so far is on
        disk."""
        faults.fault_point("ckpt.flush")
        start = time.monotonic()

        def _left() -> Optional[float]:
            if deadline_s is None:
                return None
            return max(deadline_s - (time.monotonic() - start), 0.0)

        while True:  # wait out a commit the writer already started
            with self._lock:
                busy = self._inflight
            if not busy:
                break
            left = _left()
            if left is not None and left <= 0:
                return False
            time.sleep(0.01)
        job = self._take()
        if job is None:
            self._done()
            return True
        from .retry import RetryPolicy, Retrier

        policy = RetryPolicy.from_env(
            max_attempts=3, base_delay_s=0.05, deadline_s=_left(),
            retryable=lambda e: isinstance(e, (OSError, FaultInjectedError)))
        try:
            Retrier("ckpt.flush", policy).call(lambda: self._commit(job))
            return True
        except Exception as e:
            self._m_failures.inc()
            LOG.warning("async ckpt: flush of step %d failed: %s",
                        job["step"], e)
            return False
        finally:
            self._release(job)
            self._done()

    def stop(self):
        """Flush (best effort) and stop the writer."""
        self.flush(deadline_s=5.0)
        self._stop.set()
        self._wakeup.set()
        self._thread.join(timeout=5.0)

    def snapshot_status(self) -> dict:
        """The ``ckpt/rank{k}`` push: the report without its switch."""
        out = self.report()
        out.pop("enabled")
        return out

    def report(self) -> dict:
        with self._lock:
            queued = self._pending is not None
            inflight = self._inflight
        return {"enabled": True, "rank": self.rank, "world": self.world,
                "dir": self.directory, "last_step": self.last_step,
                "last_write_s": self.last_write_s,
                "last_copy_s": self.last_copy_s,
                "last_copy_device_ms": self.last_copy_device_ms,
                "last_restore_s": self.last_restore_s,
                "last_snapshot_bytes": self.last_snapshot_bytes,
                "last_shard_bytes": self.last_shard_bytes,
                "queued": queued, "inflight": inflight}


# --------------------------------------------------------------------------
# Restore
# --------------------------------------------------------------------------


def read_manifest(directory: str) -> Optional[dict]:
    """The newest consistent snapshot in ``directory``: manifests grouped
    by (step, generation, layout digest, world); a group counts only when
    every rank of its world is present. Returns ``{"step", "generation",
    "layout_digest", "world", "ranks"}`` or None."""
    try:
        names = os.listdir(directory)
    except OSError:
        return None
    entries: dict = {}
    for name in names:
        m = _MANIFEST_RE.match(name)
        if not m:
            continue
        try:
            with open(os.path.join(directory, name), "rb") as f:
                entry = json.loads(f.read())
        except (OSError, ValueError):
            continue  # a half-written manifest: its shard never committed
        if int(entry.get("rank", -1)) != int(m.group(1)):
            continue
        key = (int(entry.get("step", -1)), int(entry.get("generation", 0)),
               str(entry.get("layout_digest", "")), int(entry.get("world", 0)))
        entries.setdefault(key, {})[int(entry["rank"])] = entry
    best = None
    for (step, gen, digest, world), ranks in entries.items():
        if world <= 0 or set(ranks) != set(range(world)):
            continue  # some rank never flushed this step
        if best is None or step > best["step"]:
            best = {"step": step, "generation": gen,
                    "layout_digest": digest, "world": world, "ranks": ranks}
    return best


def load_shards(directory: str, *,
                verify: bool = True) -> Tuple[dict, List[dict]]:
    """The newest consistent snapshot's payloads in rank order, each
    file's sha1 checked against its manifest when ``verify``."""
    manifest = read_manifest(directory)
    if manifest is None:
        raise CheckpointError(
            f"no complete checkpoint in {directory!r} "
            "(missing or inconsistent per-rank manifests)")
    from . import checkpoint as ckpt_mod

    payloads: List[dict] = []
    for rank in range(manifest["world"]):
        entry = manifest["ranks"][rank]
        path = os.path.join(directory, _SHARD_FMT.format(rank=rank))
        if verify:
            digest = _sha1_file(path)
            if digest != entry["checksum"]:
                raise CheckpointError(
                    f"checksum mismatch for rank {rank} shard {path!r}: "
                    f"manifest {entry['checksum'][:12]} != file {digest[:12]}")
        payload = ckpt_mod.load_pytree(path)
        if (int(payload.get("step", -1)) != manifest["step"]
                or payload.get("layout_digest", "")
                != manifest["layout_digest"]):
            raise CheckpointError(
                f"rank {rank} shard {path!r} disagrees with its manifest "
                "(step/layout digest)")
        payloads.append(payload)
    return manifest, payloads


def assemble_full_state(manifest: dict, payloads: List[dict], params, *,
                        min_shard_elems: Optional[int] = None):
    """The unsharded state of the saved world, in the payloads' own form:
    the saved world's layout planned again over ``params`` (the leaves in
    ``jax.tree.leaves`` order) and checked against the manifest's digest;
    each shard leaf concatenated over the ranks and trimmed to its
    group's extent; every other leaf rank 0's."""
    from ..opt.sharded import plan_shard_layout

    layout = plan_shard_layout(list(params), manifest["world"],
                               min_shard_elems=min_shard_elems,
                               generation=manifest["generation"])
    if manifest["layout_digest"] and layout.digest != manifest["layout_digest"]:
        raise CheckpointError(
            f"saved layout digest {manifest['layout_digest'][:12]} does not "
            f"reproduce ({layout.digest[:12]}): params tree or shard "
            "threshold changed since the checkpoint was written")
    states = [p["shard_state"] for p in payloads]

    def leaf(path, x):
        g = _shard_group_for(layout, path, x)
        if g is None:
            return x
        full = np.concatenate([np.ravel(np.asarray(_get(s, path)))
                               for s in states])
        return full[:g.total]

    return _map_tree(states[0], leaf)


def restore_sharded(directory: str, params, engine, *,
                    verify: bool = True) -> Tuple[dict, Any, Any]:
    """Load a ZeRO-1 engine's state from a shard checkpoint of any world
    size (N→M): ``(manifest, the engine's inner optimizer, the saved
    replicated leaves or None)``."""
    t0 = time.perf_counter()
    params = list(params)
    manifest, payloads = load_shards(directory, verify=verify)
    full = assemble_full_state(manifest, payloads, params,
                               min_shard_elems=engine._mse)
    from ..opt.sharded import plan_shard_layout

    saved = plan_shard_layout(params, manifest["world"],
                              min_shard_elems=engine._mse,
                              generation=manifest["generation"])
    if isinstance(full, dict) and set(full) == {"state", "param_groups"}:
        sd = positional_state(full, saved)
    else:
        engine._ready(params)
        sd = optax_to_torch_state(
            full, saved, engine.optimizer.state_dict()["param_groups"])
    opt = engine.load_full_state(sd, params)
    ckpt = get_checkpointer()
    if ckpt is not None:
        ckpt._m_restores.inc()
        ckpt.last_restore_s = time.perf_counter() - t0
    flightrec.note("checkpoint", event="restore", step=manifest["step"],
                   saved_world=manifest["world"],
                   world=getattr(engine, "_world", None))
    return manifest, opt, payloads[0].get("replicated")


def load_own_shard(directory: str, rank: int, *,
                   verify: bool = True) -> Optional[dict]:
    """This rank's saved payload verbatim, or None when the newest
    consistent snapshot does not cover ``rank``."""
    try:
        manifest, payloads = load_shards(directory, verify=verify)
    except CheckpointError:
        return None
    if rank >= manifest["world"]:
        return None
    return payloads[rank]


# --------------------------------------------------------------------------
# SIGTERM: flush within the grace window, then the previous disposition
# --------------------------------------------------------------------------

_handler_installed = False


def install_preemption_handler(ckpt: AsyncCheckpointer) -> None:
    """Idempotent; a no-op off the main thread."""
    global _handler_installed
    if _handler_installed:
        return
    _handler_installed = True
    try:
        prev = signal.getsignal(signal.SIGTERM)

        def _handler(signum, frame):
            grace = env_schema.get_float(
                env_schema.HOROVOD_PREEMPT_GRACE_S, 15.0)
            c = get_checkpointer()
            if c is not None:
                # headroom inside the driver's window before its SIGKILL
                deadline = max(grace * 0.8, 1.0)
                flightrec.note("checkpoint", event="preempt",
                               deadline_s=round(deadline, 3))
                ok = c.flush(deadline_s=deadline)
                flightrec.note("checkpoint", event="preempt_flushed", ok=ok,
                               step=c.last_step)
            if callable(prev):
                prev(signum, frame)
            elif prev != signal.SIG_IGN:
                signal.signal(signum, signal.SIG_DFL)
                os.kill(os.getpid(), signum)

        signal.signal(signal.SIGTERM, _handler)
    except (ValueError, OSError):  # not the main thread
        pass


_CHECKPOINTER: Optional[AsyncCheckpointer] = None


def enabled() -> bool:
    return env_schema.get_bool(env_schema.HOROVOD_ASYNC_CKPT)


def get_checkpointer() -> Optional[AsyncCheckpointer]:
    return _CHECKPOINTER


def init_checkpointer(rank: int = 0,
                      world: int = 1) -> Optional[AsyncCheckpointer]:
    """The process's checkpointer when ``HOROVOD_ASYNC_CKPT`` is set (made
    once, then given the current rank and world), with the SIGTERM
    handler; None when it is off."""
    global _CHECKPOINTER
    if not enabled():
        return _CHECKPOINTER
    if _CHECKPOINTER is None:
        _CHECKPOINTER = AsyncCheckpointer(rank=rank, world=world)
        install_preemption_handler(_CHECKPOINTER)
    else:
        _CHECKPOINTER.rank, _CHECKPOINTER.world = int(rank), int(world)
    return _CHECKPOINTER


def reset_checkpointer() -> None:
    """Stop and drop the process's checkpointer."""
    global _CHECKPOINTER
    if _CHECKPOINTER is not None:
        _CHECKPOINTER.stop()
    _CHECKPOINTER = None


def report() -> dict:
    ckpt = _CHECKPOINTER
    if ckpt is None:
        return {"enabled": False}
    return ckpt.report()
