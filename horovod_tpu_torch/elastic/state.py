"""Elastic worker state: commit, restore, sync — counterpart of
``horovod_tpu/elastic/state.py`` (``State``, ``_HostUpdateListener``,
``ObjectState``; the reference Horovod's ``common/elastic.py``).

``commit()`` saves a snapshot and checks for a membership change;
``restore()`` goes back to the last snapshot after a failed collective;
``sync()`` makes every rank take rank 0's state. ``ObjectState`` keeps
picklable attributes and, under ``HOROVOD_ELASTIC_STORE``, writes each
snapshot to that file from the lowest local rank of every host, so a
relaunched worker resumes from it. The port's ``TorchState``
(``torch/__init__.py``) adds the model, the optimizer and the sampler.
The JAX package's ``JaxState`` is not ported.
"""

from __future__ import annotations

import copy
import os
import threading
from typing import Callable, Optional

from ..common import env as env_schema
from ..common.exceptions import HostsUpdatedInterrupt


class State:
    """Base elastic state (reference ``common/elastic.py:27-115``)."""

    def __init__(self, **kwargs):
        self._reset_callbacks: list[Callable] = []
        self._hm_forced = False
        # every State sees every membership change: each keeps the count
        # of the shared listener's notifications it has acknowledged
        self._hm_ack = _host_update_listener().change_count

    def register_reset_callbacks(self, callbacks):
        self._reset_callbacks.extend(callbacks)

    def on_reset(self):
        self._hm_forced = False
        self._hm_ack = _host_update_listener().change_count
        for cb in self._reset_callbacks:
            cb()

    def on_hosts_updated(self):
        self._hm_forced = True

    def commit(self):
        """Save a snapshot, then raise ``HostsUpdatedInterrupt`` if the
        membership changed."""
        self.save()
        self.check_host_updates()

    def check_host_updates(self):
        """Raise ``HostsUpdatedInterrupt`` if the membership changed (every
        worker polls the same driver epoch, so the ranks agree)."""
        if (self._hm_forced
                or _host_update_listener().change_count > self._hm_ack):
            raise HostsUpdatedInterrupt(skip_sync=False)

    def save(self):
        raise NotImplementedError

    def restore(self):
        raise NotImplementedError

    def sync(self):
        raise NotImplementedError


class _HostUpdateListener:
    """Watches the driver's discovery epoch (``elastic/epoch``) in the
    launcher's KV store from one daemon thread a process, every
    ``WATCH_INTERVAL_S``, and counts the changes it sees. A State compares
    that count with the one it acknowledged, so a commit's check is an
    integer compare and never waits on the store."""

    WATCH_INTERVAL_S = 1.0

    def __init__(self, carry: Optional[tuple] = None):
        self._seen_epoch = int(
            os.environ.get(env_schema.HOROVOD_ELASTIC_EPOCH, "0"))
        addr = os.environ.get(env_schema.HOROVOD_GLOO_RENDEZVOUS_ADDR)
        port = os.environ.get(env_schema.HOROVOD_GLOO_RENDEZVOUS_PORT)
        self.env_key = (addr, port)
        self._client = None
        self.change_count = 0
        if carry is not None:
            # a rebuilt listener keeps counting where the last one stopped
            self._seen_epoch, self.change_count = carry
        self._stop = threading.Event()
        if addr and port:
            from ..runner.http_server import KVStoreClient

            self._client = KVStoreClient(addr, int(port))
            threading.Thread(target=self._watch, daemon=True,
                             name="hvd-host-updates").start()

    def _watch(self):
        while not self._stop.is_set():
            cur = self._fetch_epoch()
            if cur is not None and cur != self._seen_epoch:
                from ..utils import flightrec

                flightrec.note("elastic_generation", epoch=cur,
                               previous=self._seen_epoch)
                self._seen_epoch = cur
                self.change_count += 1
            self._stop.wait(self.WATCH_INTERVAL_S)

    def _fetch_epoch(self) -> Optional[int]:
        if self._client is None:
            return None
        try:
            return int(self._client.get("elastic", "epoch", timeout=1.0))
        except Exception:
            return None

    def stop(self):
        self._stop.set()


_shared_listener: Optional[_HostUpdateListener] = None


def _host_update_listener() -> _HostUpdateListener:
    """The process's listener, rebuilt when the rendezvous address appears
    or changes, so no State watches a dead store."""
    global _shared_listener
    env_key = (os.environ.get(env_schema.HOROVOD_GLOO_RENDEZVOUS_ADDR),
               os.environ.get(env_schema.HOROVOD_GLOO_RENDEZVOUS_PORT))
    if _shared_listener is None or _shared_listener.env_key != env_key:
        carry = None
        if _shared_listener is not None:
            _shared_listener.stop()
            carry = (_shared_listener._seen_epoch,
                     _shared_listener.change_count)
        _shared_listener = _HostUpdateListener(carry)
    return _shared_listener


class ObjectState(State):
    """Elastic state of picklable attributes (reference ``ObjectState``).

    A store left by an earlier incarnation wins over the constructor's
    values: that is how a relaunched worker resumes."""

    def __init__(self, store_path: Optional[str] = None,
                 checkpoint_format: str = "pickle", **kwargs):
        super().__init__()
        from ..utils import checkpoint as ckpt

        self._ckpt = ckpt
        self._ckpt_format = checkpoint_format
        self._store_path = store_path or os.environ.get(
            env_schema.HOROVOD_ELASTIC_STORE, "")
        self._saved: dict = {}
        self._attrs = list(kwargs.keys())
        for k, v in kwargs.items():
            setattr(self, k, v)
        if self._store_path and ckpt.exists(self._store_path):
            self._load_store(ckpt.load_pytree(self._store_path))
            self.restore()
        else:
            self.save()

    def _snapshot(self) -> dict:
        return {k: copy.deepcopy(getattr(self, k)) for k in self._attrs}

    def _store_payload(self) -> dict:
        """What a commit writes to the store."""
        return self._saved

    def _load_store(self, payload: dict):
        """Take a store's payload as the last snapshot."""
        self._saved = payload

    def save(self):
        self._saved = self._snapshot()
        if self._store_path and self._is_store_writer():
            self._ckpt.save_pytree(self._store_path, self._store_payload(),
                                   format=self._ckpt_format)

    @staticmethod
    def _is_store_writer() -> bool:
        """One writer a host: the slots of a host share one store path,
        and ``sync`` gives every rank rank 0's state before a commit, so
        the lowest local rank's snapshot is everyone's."""
        from ..common import context

        if not context.is_initialized():
            return True  # a single process: no peer to race
        return context.local_rank() == 0

    def restore(self):
        if not self._saved and self._store_path and \
                self._ckpt.exists(self._store_path):
            self._load_store(self._ckpt.load_pytree(self._store_path))
        for k, v in self._saved.items():
            setattr(self, k, copy.deepcopy(v))

    def sync(self):
        from ..ops.collectives import broadcast_object

        for k in self._attrs:
            setattr(self, k, broadcast_object(getattr(self, k), root_rank=0))
        self.save()
