"""Parallelism strategies of the port (``horovod_tpu/parallel``): the mesh
over the job's ranks and, each over the group of one of its axes, data,
tensor, sequence, pipeline, expert and fully-sharded parallelism."""

from .mesh import (  # noqa: F401
    create_hierarchical_mesh,
    create_mesh,
    parse_mesh_spec,
)
from .dp import data_parallel_step, shard_batch  # noqa: F401
from .tp import (  # noqa: F401
    column_parallel_dense,
    parallel_attention_output,
    parallel_mlp,
    row_parallel_dense,
    shard_leading,
)
from .sp import (  # noqa: F401
    ring_attention,
    stripe_tokens,
    striped_ring_attention,
    ulysses_attention,
    unstripe_tokens,
)
from .pp import pipeline_apply, pipeline_loss  # noqa: F401
from .moe import moe_layer, top1_gating  # noqa: F401
from .fsdp import fsdp_specs, opt_state_specs, fsdp_train_step  # noqa: F401
