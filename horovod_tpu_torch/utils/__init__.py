"""Utilities copied from ``horovod_tpu/utils``: the lock auditor, the
metrics registry, the control plane's retry policy, fault injection,
pickle checkpoints and the async sharded checkpointer."""
