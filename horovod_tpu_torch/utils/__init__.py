"""Leaf utilities copied from ``horovod_tpu/utils``: the lock auditor, the
metrics registry and the control plane's retry policy."""
