"""Elastic (fault-tolerant, resizable) training — counterpart of
``horovod_tpu/elastic`` (the reference Horovod's ``common/elastic.py``
``run_fn``)::

    @hvd.elastic.run
    def train(state):
        ...

    state = hvd.elastic.TorchState(model, optimizer, sampler=sampler,
                                   epoch=0, batch=0)
    train(state)

A ``HorovodInternalError`` (a collective that failed) restores the last
commit, re-initializes and retries; a ``HostsUpdatedInterrupt`` (the
membership changed) re-initializes and retries without a restore.

Re-initializing in the process (``_reinitialize``) bumps
``HOROVOD_ELASTIC_GEN``, stops the runtime without the shutdown drain (a
peer may be gone), synchronizes the device and tears the process group
down, drops every cached plan, tells the ZeRO-1 engines to plan their
layouts again, and runs ``init`` on the same device: a fresh NCCL
communicator on the card. A rank that missed the failure starves on its
old generation's rounds, reaches the response timeout
(``HOROVOD_RESPONSE_TIMEOUT_S``) and re-initializes too. A membership
change is the elastic driver's (``elastic/driver.py``): it relaunches the
workers, which resume from ``HOROVOD_ELASTIC_STORE``.

``TorchState`` and ``ElasticSampler`` live in the torch front end and are
reachable here, as in the reference's ``horovod.torch.elastic``.
"""

from __future__ import annotations

import functools
import os

from ..common.exceptions import HorovodInternalError, HostsUpdatedInterrupt
from .discovery import FixedHosts, HostDiscovery, HostDiscoveryScript, HostManager
from .driver import ElasticDriver
from .registration import WorkerStateRegistry
from .state import ObjectState, State

__all__ = [
    "run", "State", "ObjectState", "TorchState", "ElasticSampler",
    "ElasticDriver", "HostDiscovery", "HostDiscoveryScript", "FixedHosts",
    "HostManager", "WorkerStateRegistry", "HorovodInternalError",
    "HostsUpdatedInterrupt",
]


def __getattr__(name):
    # the torch front end imports this package: its classes load lazily
    if name in ("TorchState", "ElasticSampler"):
        from .. import torch as front

        return getattr(front, name)
    raise AttributeError(name)


def _reinitialize():
    """Re-initialize the runtime in this process under the next
    generation (module docstring)."""
    from ..common import context as ctx_mod
    from ..common import env as env_schema
    from ..ops.collectives import invalidate_fused_plans
    from ..opt import sharded as sharded_mod

    gen = int(os.environ.get(env_schema.HOROVOD_ELASTIC_GEN, "0")) + 1
    os.environ[env_schema.HOROVOD_ELASTIC_GEN] = str(gen)
    from ..utils import flightrec

    flightrec.note("elastic_generation", generation=gen, reset=True)
    device = ctx_mod._ctx.device
    ctx_mod.shutdown(drain=False)
    # the new generation's plans hold the new groups
    invalidate_fused_plans()
    sharded_mod.notify_reshard()
    ctx_mod.init(device=device)


def run(func):
    """Decorator of an elastic training function (reference
    ``elastic.py:151-175``)."""

    @functools.wraps(func)
    def wrapper(state, *args, **kwargs):
        reset_required = False
        skip_sync = False
        while True:
            if reset_required:
                _reinitialize()
                state.on_reset()
                reset_required = False
            try:
                if not skip_sync:
                    state.sync()
                skip_sync = False
                return func(state, *args, **kwargs)
            except HorovodInternalError:
                state.restore()
                reset_required = True
            except HostsUpdatedInterrupt as e:
                # a graceful change keeps the current state
                reset_required = True
                skip_sync = e.skip_sync

    return wrapper
