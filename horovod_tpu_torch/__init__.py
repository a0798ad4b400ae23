"""horovod_tpu_torch — the PyTorch and CUDA port of ``horovod_tpu``.

A package beside the JAX package, never importing it (nor JAX): its module
paths mirror ``horovod_tpu``'s so each counterpart is easy to find, and its
kernels are written by hand for Hopper (``csrc/``). Entry points run on
``cuda:<local_rank>`` unless the caller passes ``device="cpu"``.

    import horovod_tpu_torch as hvd
    hvd.init()
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(opt, named_parameters=model.named_parameters())

Elastic training: ``hvd.elastic.run``, ``hvd.elastic.TorchState`` and
``hvd.elastic.ElasticSampler`` (``elastic/``), launched with
``python -m horovod_tpu_torch.runner --min-np ... --host-discovery-script``.

The runtime's instruments: ``hvd.metrics_snapshot()``,
``hvd.trace_report()``, ``hvd.perf_report()``, ``hvd.anatomy_report()``,
``hvd.start_timeline(path)``/``hvd.stop_timeline()``, and the autotuner
under ``HOROVOD_AUTOTUNE=1`` (``utils/``).
"""

from .ops.collectives import (  # noqa: F401
    Adasum,
    Average,
    Max,
    Min,
    Product,
    ReduceOp,
    Sum,
)
from .opt import ShardedUpdateEngine, plan_shard_layout  # noqa: F401
from .torch import (  # noqa: F401  (the Horovod surface)
    Compression,
    DistributedOptimizer,
    ElasticSampler,
    HorovodInternalError,
    ProcessSet,
    add_process_set,
    allgather,
    allgather_async,
    allgather_object,
    allreduce,
    allreduce_,
    allreduce_async,
    allreduce_async_,
    alltoall,
    alltoall_async,
    barrier,
    broadcast,
    broadcast_async,
    broadcast_async_,
    broadcast_object,
    broadcast_optimizer_state,
    broadcast_parameters,
    cross_rank,
    cross_size,
    device,
    elastic,
    global_process_set,
    grouped_allreduce,
    grouped_allreduce_,
    grouped_allreduce_async,
    grouped_allreduce_async_,
    init,
    is_initialized,
    join,
    local_rank,
    local_size,
    megaplan_report,
    anatomy_report,
    metrics_snapshot,
    perf_report,
    poll,
    rank,
    reducescatter,
    reducescatter_async,
    remove_process_set,
    shutdown,
    size,
    sparse_allreduce_async,
    start_timeline,
    stop_timeline,
    synchronize,
    SyncBatchNorm,
    TorchState,
    trace_report,
)
