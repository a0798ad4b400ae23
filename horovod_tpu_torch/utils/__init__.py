"""Utilities copied from ``horovod_tpu/utils``: the lock auditor, the
metrics registry, the control plane's retry policy, fault injection,
pickle checkpoints, the async sharded checkpointer, the runtime's
instruments (flight recorder, timeline, stall inspector, tracing, perf
ledger, step anatomy), the autotuner and the input pipeline
(``data``)."""
