"""Environment knobs the port reads — the subset of
``horovod_tpu/common/env.py`` that the port needs, under the same names,
so a launcher sets one environment for either package. No knob here is
missing from the JAX package.

``UNIMPLEMENTED_KNOBS`` names the JAX package's knobs that change what a
job computes or sends and that the port does not implement yet (none
since the autotuner was ported); ``warn_unimplemented`` (called by
``hvd.init()``) warns once for each of them that is turned on, so a job
configured for the JAX package would not run differently under the port
without a word.
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
# elastic training (elastic/): the driver's discovery epoch and the
# in-process reset generation (both in the negotiation rounds' namespace,
# ops/controller.py _ctl_prefix, and in the TCPStore port's key,
# common/context.py), the flag the driver sets on its workers, the
# committed-state store a relaunched worker resumes from, and the
# respawn-before-blacklist budget with its backoff scale (JAX
# common/env.py:51, :68-76)
HOROVOD_ELASTIC = "HOROVOD_ELASTIC"
HOROVOD_ELASTIC_EPOCH = "HOROVOD_ELASTIC_EPOCH"
HOROVOD_ELASTIC_GEN = "HOROVOD_ELASTIC_GEN"
HOROVOD_ELASTIC_STORE = "HOROVOD_ELASTIC_STORE"
HOROVOD_ELASTIC_RESPAWN_ATTEMPTS = "HOROVOD_ELASTIC_RESPAWN_ATTEMPTS"
HOROVOD_ELASTIC_RESPAWN_BACKOFF = "HOROVOD_ELASTIC_RESPAWN_BACKOFF"
# fault injection at the control plane's seams (utils/faults.py; JAX
# common/env.py:59-60)
HOROVOD_FAULT_SPEC = "HOROVOD_FAULT_SPEC"
HOROVOD_FAULT_SEED = "HOROVOD_FAULT_SEED"
# the async sharded checkpointer (utils/async_ckpt.py): its switch, its
# directory, and the SIGTERM grace window in seconds, which the elastic
# driver waits before SIGKILL and a worker's final flush stays inside
# (JAX common/env.py:171-173)
HOROVOD_ASYNC_CKPT = "HOROVOD_ASYNC_CKPT"
HOROVOD_ASYNC_CKPT_DIR = "HOROVOD_ASYNC_CKPT_DIR"
HOROVOD_PREEMPT_GRACE_S = "HOROVOD_PREEMPT_GRACE_S"

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

# the runtime's instruments (JAX common/env.py:23-43, :54-56, :88-90,
# :121-132, :155-156): the timeline file rank 0 writes and its cycle marks;
# the stall inspector's switch; the metrics file, its dump interval in
# seconds and the push to the launcher; cross-rank tracing (its span
# buffer, a clock-offset override in seconds); the flight recorder and its
# ring; the perf ledger, its ring and the SLO budgets; the step anatomy
# and its ring. Each instrument exists only when its knob is set.
HOROVOD_TIMELINE = "HOROVOD_TIMELINE"
HOROVOD_TIMELINE_MARK_CYCLES = "HOROVOD_TIMELINE_MARK_CYCLES"
HOROVOD_STALL_CHECK_DISABLE = "HOROVOD_STALL_CHECK_DISABLE"
HOROVOD_METRICS_FILE = "HOROVOD_METRICS_FILE"
HOROVOD_METRICS_DUMP_INTERVAL = "HOROVOD_METRICS_DUMP_INTERVAL"
HOROVOD_METRICS_PUSH = "HOROVOD_METRICS_PUSH"
HOROVOD_TRACE = "HOROVOD_TRACE"
HOROVOD_TRACE_BUFFER = "HOROVOD_TRACE_BUFFER"
HOROVOD_TRACE_CLOCK_OFFSET = "HOROVOD_TRACE_CLOCK_OFFSET"
HOROVOD_FLIGHTREC = "HOROVOD_FLIGHTREC"
HOROVOD_FLIGHTREC_BUFFER = "HOROVOD_FLIGHTREC_BUFFER"
HOROVOD_PERFLEDGER = "HOROVOD_PERFLEDGER"
HOROVOD_PERFLEDGER_BUFFER = "HOROVOD_PERFLEDGER_BUFFER"
HOROVOD_SLO_SPEC = "HOROVOD_SLO_SPEC"
HOROVOD_ANATOMY = "HOROVOD_ANATOMY"
HOROVOD_ANATOMY_BUFFER = "HOROVOD_ANATOMY_BUFFER"
# the autotuner (utils/autotune.py): its switch, its CSV log, the warm-up
# samples, the working cycles a sample, the samples before it converges,
# the tuned file and the revert guardrail; and the most tensors a fused
# chunk, one of its knobs (0: bytes only)
HOROVOD_AUTOTUNE = "HOROVOD_AUTOTUNE"
HOROVOD_AUTOTUNE_LOG = "HOROVOD_AUTOTUNE_LOG"
HOROVOD_AUTOTUNE_WARMUP_SAMPLES = "HOROVOD_AUTOTUNE_WARMUP_SAMPLES"
HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE = "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE"
HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES = \
    "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES"
HOROVOD_AUTOTUNE_TUNED_FILE = "HOROVOD_AUTOTUNE_TUNED_FILE"
HOROVOD_AUTOTUNE_REVERT_PCT = "HOROVOD_AUTOTUNE_REVERT_PCT"
HOROVOD_AUTOTUNE_REVERT_WINDOWS = "HOROVOD_AUTOTUNE_REVERT_WINDOWS"
HOROVOD_PLAN_CHUNK_TENSORS = "HOROVOD_PLAN_CHUNK_TENSORS"

# the postmortem, memory and fleet-health layer (JAX common/env.py:92,
# :123-124, :142, :148-149, :179-182): the wedge watchdog's no-progress
# threshold in seconds (0: off) and where diagnostic bundles are written
# (utils/diag.py); the device-memory ledger's switch and its sample ring
# (utils/memledger.py); the health engine's switch, its ring a series, the
# samples before a detector's baseline freezes and the file its history is
# dumped to at shutdown (utils/health.py); the kernel-library directory
# (utils/compile_cache.py; the port caches built kernels, not XLA
# programs); and the launcher's count of KV shards (runner/http_server.py)
HOROVOD_WATCHDOG_SECS = "HOROVOD_WATCHDOG_SECS"
HOROVOD_DIAG_DIR = "HOROVOD_DIAG_DIR"
HOROVOD_MEMLEDGER = "HOROVOD_MEMLEDGER"
HOROVOD_MEMLEDGER_BUFFER = "HOROVOD_MEMLEDGER_BUFFER"
HOROVOD_HEALTH = "HOROVOD_HEALTH"
HOROVOD_HEALTH_BUFFER = "HOROVOD_HEALTH_BUFFER"
HOROVOD_HEALTH_WARMUP = "HOROVOD_HEALTH_WARMUP"
HOROVOD_HEALTH_FILE = "HOROVOD_HEALTH_FILE"
HOROVOD_COMPILE_CACHE = "HOROVOD_COMPILE_CACHE"
HOROVOD_KV_SHARDS = "HOROVOD_KV_SHARDS"

# knobs of the JAX package that change what a job computes or sends and
# that the port does not implement, which it reads only to warn (JAX
# common/env.py:25); empty since the autotuner was ported, and kept so a
# knob the port lacks is named here, never ignored without a word
UNIMPLEMENTED_KNOBS: tuple = ()


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
      (``ops/collectives.py``);
    - ``plan_chunk_tensors``: the most tensors a fused chunk (0: bounded
      by bytes only), an autotuner knob;
    - the instruments and the autotuner (the knobs above, with the JAX
      package's defaults);
    - the postmortem, memory and health layer, which ``init`` starts
      from these fields: ``watchdog_secs`` (0: no watchdog),
      ``memledger_enabled`` and its ring, ``health_enabled``, its ring,
      warmup and exit file, and ``compile_cache`` (empty: the package's
      ``_build/``). ``HOROVOD_DIAG_DIR`` is read where a bundle is
      written (an out-of-memory dump may come before ``init``) and
      ``HOROVOD_KV_SHARDS`` by the launcher's store, so neither is here.
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
    plan_chunk_tensors: int = 0
    timeline_filename: str = ""
    timeline_mark_cycles: bool = False
    stall_check_disable: bool = False
    metrics_file: str = ""
    metrics_dump_interval_s: float = 30.0
    metrics_push: bool = True
    trace_enabled: bool = False
    autotune: bool = False
    autotune_log: str = ""
    autotune_warmup_samples: int = 3
    autotune_steps_per_sample: int = 20
    autotune_max_samples: int = 20
    autotune_tuned_file: str = ""
    autotune_revert_pct: float = 20.0
    autotune_revert_windows: int = 2
    watchdog_secs: float = 0.0
    memledger_enabled: bool = False
    memledger_buffer: int = 512
    health_enabled: bool = False
    health_buffer: int = 512
    health_warmup: int = 20
    health_file: str = ""
    compile_cache: str = ""

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
        c.plan_chunk_tensors = get_int(HOROVOD_PLAN_CHUNK_TENSORS,
                                       c.plan_chunk_tensors)
        c.timeline_filename = get_str(HOROVOD_TIMELINE)
        c.timeline_mark_cycles = get_bool(HOROVOD_TIMELINE_MARK_CYCLES)
        c.stall_check_disable = get_bool(HOROVOD_STALL_CHECK_DISABLE)
        c.metrics_file = get_str(HOROVOD_METRICS_FILE)
        c.metrics_dump_interval_s = get_float(HOROVOD_METRICS_DUMP_INTERVAL,
                                              c.metrics_dump_interval_s)
        c.metrics_push = get_bool(HOROVOD_METRICS_PUSH, True)
        c.trace_enabled = get_bool(HOROVOD_TRACE)
        c.autotune = get_bool(HOROVOD_AUTOTUNE)
        c.autotune_log = get_str(HOROVOD_AUTOTUNE_LOG)
        c.autotune_warmup_samples = get_int(HOROVOD_AUTOTUNE_WARMUP_SAMPLES,
                                            c.autotune_warmup_samples)
        c.autotune_steps_per_sample = get_int(
            HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE, c.autotune_steps_per_sample)
        c.autotune_max_samples = get_int(
            HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES, c.autotune_max_samples)
        c.autotune_tuned_file = get_str(HOROVOD_AUTOTUNE_TUNED_FILE)
        c.autotune_revert_pct = get_float(HOROVOD_AUTOTUNE_REVERT_PCT,
                                          c.autotune_revert_pct)
        c.autotune_revert_windows = get_int(HOROVOD_AUTOTUNE_REVERT_WINDOWS,
                                            c.autotune_revert_windows)
        c.watchdog_secs = get_float(HOROVOD_WATCHDOG_SECS, c.watchdog_secs)
        c.memledger_enabled = get_bool(HOROVOD_MEMLEDGER)
        c.memledger_buffer = get_int(HOROVOD_MEMLEDGER_BUFFER,
                                     c.memledger_buffer)
        c.health_enabled = get_bool(HOROVOD_HEALTH)
        c.health_buffer = get_int(HOROVOD_HEALTH_BUFFER, c.health_buffer)
        c.health_warmup = get_int(HOROVOD_HEALTH_WARMUP, c.health_warmup)
        c.health_file = get_str(HOROVOD_HEALTH_FILE)
        c.compile_cache = get_str(HOROVOD_COMPILE_CACHE)
        return c
