"""Environment knobs the port reads — the subset of
``horovod_tpu/common/env.py`` that the port needs, under the same names,
so a launcher sets one environment for either package. No knob here is
missing from the JAX package.
"""

from __future__ import annotations

import dataclasses
import os

# worker identity (the set the reference's launcher injects per slot)
HOROVOD_RANK = "HOROVOD_RANK"
HOROVOD_SIZE = "HOROVOD_SIZE"
HOROVOD_LOCAL_RANK = "HOROVOD_LOCAL_RANK"
HOROVOD_LOCAL_SIZE = "HOROVOD_LOCAL_SIZE"
HOROVOD_CROSS_RANK = "HOROVOD_CROSS_RANK"
HOROVOD_CROSS_SIZE = "HOROVOD_CROSS_SIZE"
HOROVOD_HOSTNAME = "HOROVOD_HOSTNAME"

# torch.distributed rendezvous (a TCPStore on rank 0) under a launcher
MASTER_ADDR = "MASTER_ADDR"
MASTER_PORT = "MASTER_PORT"

# the launcher's HMAC-signed KV store, which carries negotiation
HOROVOD_GLOO_RENDEZVOUS_ADDR = "HOROVOD_GLOO_RENDEZVOUS_ADDR"
HOROVOD_GLOO_RENDEZVOUS_PORT = "HOROVOD_GLOO_RENDEZVOUS_PORT"
HOROVOD_GLOO_IFACE = "HOROVOD_GLOO_IFACE"
HOROVOD_SECRET_KEY = "HOROVOD_SECRET_KEY"

# the background runtime (RuntimeConfig below)
HOROVOD_FUSION_THRESHOLD = "HOROVOD_FUSION_THRESHOLD"
HOROVOD_CYCLE_TIME = "HOROVOD_CYCLE_TIME"
HOROVOD_STALL_CHECK_TIME_SECONDS = "HOROVOD_STALL_CHECK_TIME_SECONDS"
HOROVOD_STALL_SHUTDOWN_TIME_SECONDS = "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS"
HOROVOD_RESPONSE_TIMEOUT_S = "HOROVOD_RESPONSE_TIMEOUT_S"
# negotiation-round namespace generations (ops/controller.py _ctl_prefix)
HOROVOD_ELASTIC_EPOCH = "HOROVOD_ELASTIC_EPOCH"
HOROVOD_ELASTIC_GEN = "HOROVOD_ELASTIC_GEN"

# control-plane retries (utils/retry.py) and the lock auditor
HOROVOD_RETRY_MAX_ATTEMPTS = "HOROVOD_RETRY_MAX_ATTEMPTS"
HOROVOD_RETRY_DEADLINE = "HOROVOD_RETRY_DEADLINE"
HOROVOD_RETRY_BASE_DELAY = "HOROVOD_RETRY_BASE_DELAY"
HOROVOD_LOCKCHECK = "HOROVOD_LOCKCHECK"
HOROVOD_LOCKCHECK_HOLD_MS = "HOROVOD_LOCKCHECK_HOLD_MS"


def get_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


def get_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    try:
        return int(v) if v is not None else default
    except ValueError:
        return default


def get_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    try:
        return float(v) if v is not None else default
    except ValueError:
        return default


@dataclasses.dataclass
class RuntimeConfig:
    """The knobs the background runtime reads, once, at ``hvd.init()``
    (the subset of ``horovod_tpu``'s ``RuntimeConfig``, with its defaults):

    - ``fusion_threshold_bytes``: the largest fused chunk, in bytes
      (``HOROVOD_FUSION_THRESHOLD``, raw bytes; 0 makes every tensor its
      own chunk);
    - ``cycle_time_ms``: the cycle's period: a cycle starts this long
      after the last one started;
    - the coordinator's stall warning and stall shutdown, and how long a
      worker waits for a negotiation response.
    """

    fusion_threshold_bytes: int = 128 * 1024 * 1024
    cycle_time_ms: float = 1.0
    stall_warning_time_s: float = 60.0
    stall_shutdown_time_s: float = 0.0
    response_timeout_s: float = 300.0

    @classmethod
    def from_env(cls) -> "RuntimeConfig":
        c = cls()
        nbytes = get_int(HOROVOD_FUSION_THRESHOLD, -1)
        if nbytes >= 0:
            c.fusion_threshold_bytes = nbytes
        c.cycle_time_ms = get_float(HOROVOD_CYCLE_TIME, c.cycle_time_ms)
        c.stall_warning_time_s = get_float(HOROVOD_STALL_CHECK_TIME_SECONDS,
                                           c.stall_warning_time_s)
        c.stall_shutdown_time_s = get_float(
            HOROVOD_STALL_SHUTDOWN_TIME_SECONDS, c.stall_shutdown_time_s)
        c.response_timeout_s = get_float(HOROVOD_RESPONSE_TIMEOUT_S,
                                         c.response_timeout_s)
        return c
