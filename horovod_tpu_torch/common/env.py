"""Environment knobs the port reads — the subset of
``horovod_tpu/common/env.py`` that the port needs, under the same names,
so a launcher sets one environment for either package. No knob here is
missing from the JAX package.

``UNIMPLEMENTED_KNOBS`` names the JAX package's knobs that change what a
job computes or sends and that the port does not implement yet;
``warn_unimplemented`` (called by ``hvd.init()``) warns once for each of
them that is turned on, so a job configured for the JAX package does not
run differently under the port without a word.
"""

from __future__ import annotations

import dataclasses
import os
import warnings

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

# the compressed gradient wire (ops/compression.py): none|bf16|int8|int4,
# the elements of an absmax block, error feedback, name-pattern opt-outs
# and the small-leaf threshold in elements (JAX common/env.py:103-113)
HOROVOD_COMPRESSION = "HOROVOD_COMPRESSION"
HOROVOD_QUANT_BLOCK = "HOROVOD_QUANT_BLOCK"
HOROVOD_QUANT_EF = "HOROVOD_QUANT_EF"
HOROVOD_QUANT_OPTOUT = "HOROVOD_QUANT_OPTOUT"
HOROVOD_QUANT_MIN_ELEMS = "HOROVOD_QUANT_MIN_ELEMS"
# the ZeRO-1 sharded update (opt/sharded.py), which excludes the
# compressed wire, and its replicate threshold in elements: a leaf under it
# stays on the allreduce path (JAX common/env.py:101-102)
HOROVOD_SHARDED_UPDATE = "HOROVOD_SHARDED_UPDATE"
HOROVOD_SHARDED_MIN_ELEMS = "HOROVOD_SHARDED_MIN_ELEMS"
# the control plane at scale (ops/controller.py, ops/wire.py): the
# hierarchical negotiation over wire v2, the ranks a leader's group, and
# how long a member waits on its leader before it submits flat (JAX
# common/env.py:139-141)
HOROVOD_HIER_NEGOTIATION = "HOROVOD_HIER_NEGOTIATION"
HOROVOD_HIER_GROUP_SIZE = "HOROVOD_HIER_GROUP_SIZE"
HOROVOD_HIER_FALLBACK_S = "HOROVOD_HIER_FALLBACK_S"
# whole-step megaplan capture and replay (ops/megaplan.py), and the
# identical working cycles before a capture (JAX common/env.py:163-164)
HOROVOD_MEGAPLAN = "HOROVOD_MEGAPLAN"
HOROVOD_MEGAPLAN_STABLE_ROUNDS = "HOROVOD_MEGAPLAN_STABLE_ROUNDS"

# the two-level data plane (ops/collectives.py): the allreduce as a
# reduce-scatter within a host, an allreduce across hosts and an allgather
# within the host, and the allgather's two-level flavour (JAX
# common/env.py:47-48)
HOROVOD_HIERARCHICAL_ALLREDUCE = "HOROVOD_HIERARCHICAL_ALLREDUCE"
HOROVOD_HIERARCHICAL_ALLGATHER = "HOROVOD_HIERARCHICAL_ALLGATHER"

# knobs of the JAX package that the port reads only to warn that it does
# not implement them (JAX common/env.py:25)
UNIMPLEMENTED_KNOBS = (
    "HOROVOD_AUTOTUNE",
)


def get_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


def get_str(name: str, default: str = "") -> str:
    return os.environ.get(name, default)


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


def warn_unimplemented() -> None:
    """Warn once for each of ``UNIMPLEMENTED_KNOBS`` that is turned on."""
    for k in UNIMPLEMENTED_KNOBS:
        if get_bool(k):
            warnings.warn(f"{k} is set, but horovod_tpu_torch does not "
                          "implement it yet: the job runs as if it were "
                          "unset", RuntimeWarning, stacklevel=3)


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
      worker waits for a negotiation response;
    - the compressed wire: ``compression`` (``HOROVOD_COMPRESSION``, ""
      keeps the wire uncompressed), the absmax block, error feedback, the
      opt-out patterns and the small-leaf threshold;
    - the control plane: ``hier_negotiation`` (the v2 wire through
      per-group leaders of ``hier_group_size`` ranks, a member falling
      back flat after ``hier_fallback_s``), and ``megaplan`` (capture
      after ``megaplan_stable_rounds`` identical working cycles);
    - the two-level data plane: ``hierarchical_allreduce`` and
      ``hierarchical_allgather``, taken where the topology carries them
      (``ops/collectives.py``).
    """

    fusion_threshold_bytes: int = 128 * 1024 * 1024
    cycle_time_ms: float = 1.0
    stall_warning_time_s: float = 60.0
    stall_shutdown_time_s: float = 0.0
    response_timeout_s: float = 300.0
    compression: str = ""
    quant_block: int = 256
    quant_error_feedback: bool = True
    quant_optout: str = ""
    quant_min_elems: int = 4096
    hier_negotiation: bool = False
    hier_group_size: int = 8
    hier_fallback_s: float = 5.0
    megaplan: bool = False
    megaplan_stable_rounds: int = 5
    hierarchical_allreduce: bool = False
    hierarchical_allgather: bool = False

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
        c.compression = get_str(HOROVOD_COMPRESSION).strip().lower()
        c.quant_block = get_int(HOROVOD_QUANT_BLOCK, c.quant_block)
        c.quant_error_feedback = get_bool(HOROVOD_QUANT_EF, True)
        c.quant_optout = get_str(HOROVOD_QUANT_OPTOUT)
        c.quant_min_elems = get_int(HOROVOD_QUANT_MIN_ELEMS,
                                    c.quant_min_elems)
        c.hier_negotiation = get_bool(HOROVOD_HIER_NEGOTIATION)
        c.hier_group_size = get_int(HOROVOD_HIER_GROUP_SIZE,
                                    c.hier_group_size)
        c.hier_fallback_s = get_float(HOROVOD_HIER_FALLBACK_S,
                                      c.hier_fallback_s)
        c.megaplan = get_bool(HOROVOD_MEGAPLAN)
        c.megaplan_stable_rounds = get_int(HOROVOD_MEGAPLAN_STABLE_ROUNDS,
                                           c.megaplan_stable_rounds)
        c.hierarchical_allreduce = get_bool(HOROVOD_HIERARCHICAL_ALLREDUCE)
        c.hierarchical_allgather = get_bool(HOROVOD_HIERARCHICAL_ALLGATHER)
        return c
