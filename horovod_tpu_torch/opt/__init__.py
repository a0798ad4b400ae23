"""Optimizers of the port — counterpart of ``horovod_tpu/opt``: the ZeRO-1
sharded update (``opt/sharded.py``)."""

from .sharded import (  # noqa: F401
    ShardedUpdateEngine,
    ShardGroup,
    ShardLayout,
    make_simulated_engines,
    plan_shard_layout,
    simulated_full_state,
    simulated_step,
)
