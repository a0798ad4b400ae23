"""Eager collectives over ``torch.distributed`` — the eager subset of
``horovod_tpu/ops/collectives.py``.

``allreduce`` keeps the JAX package's contract (``_allreduce_body``
:570-597): prescale, then reduce, then postscale; SUM and PRODUCT keep the
caller's dtype; AVERAGE of an integer tensor raises ``ValueError``
(``_check_average_dtype`` :75-80); a zero-element tensor makes no call and
is still scaled (:654-662). Every other tensor goes through the process
group, a group of one included, so a single-GPU run still drives NCCL.

Each collective starts as a ``Pending``: the ``torch.distributed`` work
runs asynchronously (NCCL on its own stream, gloo on its own thread), and
``Pending.wait`` finishes it. The Horovod front end (``torch/__init__.py``)
builds its blocking, grouped and handle-based calls on these. The
negotiated, fused background runtime of the JAX package (``ops/queue.py``)
is ROADMAP.md queue 1 item 6; here each call goes to ``torch.distributed``
directly.
"""

from __future__ import annotations

from enum import IntEnum
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..common import context as ctx_mod
from ..common.context import ProcessSet


class ReduceOp(IntEnum):
    """Reduction ops (the JAX package's numbering, ``collectives.py:45``)."""

    AVERAGE = 0
    SUM = 1
    ADASUM = 2
    MIN = 3
    MAX = 4
    PRODUCT = 5


# Horovod-compatible aliases
Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Adasum = ReduceOp.ADASUM
Min = ReduceOp.MIN
Max = ReduceOp.MAX
Product = ReduceOp.PRODUCT

_DIST_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT}


def _resolve_op(op, average) -> ReduceOp:
    if average is not None:  # legacy kwarg
        return ReduceOp.AVERAGE if average else ReduceOp.SUM
    return ReduceOp(op) if op is not None else ReduceOp.AVERAGE


def _check_average_dtype(t: torch.Tensor, op: ReduceOp):
    if op == ReduceOp.AVERAGE and not (t.is_floating_point()
                                       or t.is_complex()):
        raise ValueError(
            "ReduceOp.AVERAGE is not supported for integer tensors; use SUM "
            "(matches reference torch/mpi_ops.py behavior)")


def _ps(process_set: Optional[ProcessSet]) -> ProcessSet:
    return process_set or ctx_mod.global_process_set()


class Pending:
    """An in-flight collective: ``done()`` polls, ``wait()`` completes it
    and returns the result."""

    def __init__(self, work, finish: Callable[[], torch.Tensor]):
        self._work = work
        self._finish = finish

    def done(self) -> bool:
        return self._work is None or self._work.is_completed()

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
        return self._finish()


def _scaled(t: torch.Tensor, factor: float) -> torch.Tensor:
    return t * factor if factor != 1.0 else t


def allreduce_start(tensor: torch.Tensor, op=None, average=None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0,
                    process_set: Optional[ProcessSet] = None,
                    inplace: bool = False) -> Pending:
    """Start an allreduce. With ``inplace`` the result is written into
    ``tensor`` (whose dtype it then keeps)."""
    op = _resolve_op(op, average)
    _check_average_dtype(tensor, op)
    if op == ReduceOp.ADASUM:
        raise NotImplementedError(
            "Adasum is not ported yet (ROADMAP.md queue 1 item 13)")
    ps = _ps(process_set)

    def finish(buf):
        out = _scaled(buf, postscale_factor)
        if inplace:
            if out is not tensor:
                tensor.copy_(out)
            return tensor
        return out

    buf = _scaled(tensor, prescale_factor)
    if tensor.numel() == 0:
        # zero-element reduction: no call, still scaled
        return Pending(None, lambda: finish(buf))
    if buf is tensor and not inplace:
        buf = tensor.clone()
    buf = buf.contiguous()
    if op == ReduceOp.AVERAGE and dist.get_backend(ps.group) == "nccl":
        work = dist.all_reduce(buf, dist.ReduceOp.AVG, group=ps.group,
                               async_op=True)
        return Pending(work, lambda: finish(buf))
    if op == ReduceOp.AVERAGE:
        # gloo has no AVG: sum, then divide by the contributors
        work = dist.all_reduce(buf, dist.ReduceOp.SUM, group=ps.group,
                               async_op=True)
        return Pending(work, lambda: finish(buf.div_(ps.size)))
    work = dist.all_reduce(buf, _DIST_OPS[op], group=ps.group, async_op=True)
    return Pending(work, lambda: finish(buf))


def broadcast_start(tensor: torch.Tensor, root_rank: int,
                    process_set: Optional[ProcessSet] = None,
                    inplace: bool = False) -> Pending:
    """Start a broadcast of ``tensor`` from ``root_rank`` (a rank of the
    process set)."""
    ps = _ps(process_set)
    buf = tensor if inplace else tensor.clone()
    if tensor.numel() == 0:
        return Pending(None, lambda: buf)
    src = dist.get_global_rank(ps.group, root_rank)
    if buf.is_contiguous():
        work = dist.broadcast(buf, src, group=ps.group, async_op=True)
        return Pending(work, lambda: buf)
    flat = buf.contiguous()
    work = dist.broadcast(flat, src, group=ps.group, async_op=True)
    return Pending(work, lambda: buf.copy_(flat))


def broadcast_object(obj, root_rank: int = 0, process_set=None):
    """Pickle-broadcast a Python object from ``root_rank``. Only objects
    this job's own ranks sent are unpickled."""
    ps = _ps(process_set)
    box = [obj]
    dist.broadcast_object_list(box, dist.get_global_rank(ps.group, root_rank),
                               group=ps.group)
    return box[0]


def barrier(process_set: Optional[ProcessSet] = None):
    dist.barrier(group=_ps(process_set).group)
