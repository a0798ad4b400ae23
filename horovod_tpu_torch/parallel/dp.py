"""The data-parallel training step — counterpart of
``horovod_tpu/parallel/dp.py``.

The Horovod loop shape: each rank runs the same step on its own shard of
the batch, and the gradients are averaged over the data axis. The JAX
package compiles that step into one SPMD program over a mesh axis; the
port's step is the per-rank function itself, and the axis it names
resolves to the axis's process set (``Mesh.process_set``). The step's
gradients go one of two ways:

- in the step, as the JAX package's loop averages them
  (``bench.py::bench_resnet``): ``hvd.opt.DistributedOptimizer(
  optimizer_fn, params, group=step.group)`` issues one fused collective
  a dtype on the axis's group from the caller's thread, with no runtime
  (``opt/__init__.py``);
- through the background runtime, the reference's hooks (K1 pack,
  NCCL, K1 unpack on the cycle thread): ``hvd.DistributedOptimizer(opt,
  ..., process_set=step.process_set)``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..common import context
from .mesh import Mesh

DEFAULT_AXIS = "hvd"  # the global process set's axis


def _resolve(mesh: Optional[Mesh], axis_name: str):
    if mesh is None:
        if axis_name != DEFAULT_AXIS:
            raise ValueError(f"axis {axis_name!r} names no axis without a "
                             "mesh; pass mesh=")
        return context.global_process_set()
    if axis_name not in mesh.shape:
        raise ValueError(f"axis {axis_name!r} is not one of the mesh's "
                         f"{mesh.axis_names}")
    return mesh.process_set(axis_name)


class DataParallelStep:
    """``step_fn`` over the data axis: calling it places the batch
    arguments (this rank's shard) on ``hvd.device()`` and runs
    ``step_fn(*args)``. ``process_set`` is the axis's set, for the
    runtime's collectives; ``group`` its caller-side group, for the
    in-step ones (``hvd.opt``)."""

    def __init__(self, step_fn: Callable, mesh: Optional[Mesh],
                 axis_name: str, batch_argnums: tuple):
        self.step_fn = step_fn
        self.mesh = mesh
        self.axis_name = axis_name
        self.batch_argnums = tuple(batch_argnums)
        self.process_set = _resolve(mesh, axis_name)
        self.group = self.process_set.group

    def __call__(self, *args):
        args = tuple(shard_batch(a, self.mesh, self.axis_name)
                     if i in self.batch_argnums else a
                     for i, a in enumerate(args))
        return self.step_fn(*args)


def data_parallel_step(step_fn: Callable, *, mesh: Optional[Mesh] = None,
                       axis_name: str = DEFAULT_AXIS,
                       batch_argnums: tuple[int, ...] = (2,)
                       ) -> DataParallelStep:
    """``step_fn(model, optimizer, batch, ...)`` data-parallel over
    ``axis_name`` of ``mesh`` (no mesh: the global set).

    ``step_fn`` is written per rank: it sees this rank's batch shard (the
    arguments at ``batch_argnums``) and averages its gradients over the
    returned step's axis: in the step through
    ``hvd.opt.DistributedOptimizer(..., group=step.group)``, or through
    the runtime with ``hvd.DistributedOptimizer(...,
    process_set=step.process_set)``.
    """
    return DataParallelStep(step_fn, mesh, axis_name, batch_argnums)


def shard_batch(batch, mesh: Optional[Mesh] = None,
                axis_name: str = DEFAULT_AXIS):
    """Place this process's batch (a tensor, numpy array or a tree of them,
    leading dim = the rank's share of the global batch) on
    ``hvd.device()``: as with Horovod's per-rank dataset sharding, each
    process passes only its own slice."""
    _resolve(mesh, axis_name)
    dev = context.device()

    def place(x):
        if isinstance(x, dict):
            return {k: place(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(place(v) for v in x)
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(dev) if isinstance(x, torch.Tensor) else x

    return place(batch)
