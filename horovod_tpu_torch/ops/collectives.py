"""Collectives over ``torch.distributed`` — the eager half of
``horovod_tpu/ops/collectives.py`` that the background runtime
(``ops/queue.py``) dispatches.

- ``_eager_allreduce`` (:651) and ``_eager_broadcast`` (:1408): one
  tensor, one collective. ``allreduce`` keeps the JAX package's contract
  (``_allreduce_body`` :570-597): prescale, then reduce, then postscale;
  SUM and PRODUCT keep the caller's dtype; a zero-element tensor makes no
  call and is still scaled (:654-662).
- ``fused_chunk_plan`` and ``FusedChunkPlan`` (:707-874): a chunk of
  same-dtype SUM/AVERAGE allreduces as pack → one collective → unpack, the
  pack and unpack in the K1 kernel (``ops/fused_pack.py``) with the
  prescale fused into the pack and the postscale (and, where the backend
  has no average, the 1/n of AVERAGE) into the unpack. A chunk of one
  tensor is reduced in place, with no pack. Plans are cached by the JAX
  package's key (:853-856), the elastic generation included.
- ``unpack_flat`` (:475): a flat result split back into per-tensor views.

One deliberate departure, which changes no result: at a world of one the
JAX plan skips pack and unpack (:749-767), while here a group of one still
goes through the communicator, so a single-GPU run drives the same
pack → NCCL → unpack chain that a multi-GPU run takes.

``broadcast_object`` and ``barrier`` are called on the caller's thread, on
the world group; the runtime runs its collectives on a group of its own,
so the two never interleave on one communicator.
"""

from __future__ import annotations

import collections
from enum import IntEnum
from typing import Optional

import torch
import torch.distributed as dist

from ..common import context as ctx_mod
from ..common import env as env_schema
from ..common.context import ProcessSet
from ..utils import metrics as metrics_mod
from . import fused_pack


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


def _has_avg(group) -> bool:
    return dist.get_backend(group) == "nccl"


def _scaled(t: torch.Tensor, factor: float) -> torch.Tensor:
    return t * factor if factor != 1.0 else t


def _eager_allreduce(x: torch.Tensor, op, group, prescale_factor: float,
                     postscale_factor: float) -> torch.Tensor:
    """Allreduce one tensor into a new one. Scaling follows PyTorch's type
    promotion, as JAX's weak typing does for a Python float: an integer
    tensor with a factor other than 1 comes back as float32."""
    op = ReduceOp(op)
    buf = x * prescale_factor if prescale_factor != 1.0 else x.clone()
    if x.numel() == 0:
        # zero-element reduction: no call, still scaled
        return _scaled(buf, postscale_factor)
    buf = buf.contiguous()
    if op == ReduceOp.AVERAGE and _has_avg(group):
        dist.all_reduce(buf, dist.ReduceOp.AVG, group=group)
    elif op == ReduceOp.AVERAGE:
        # gloo has no AVG: sum, then divide by the contributors
        dist.all_reduce(buf, dist.ReduceOp.SUM, group=group)
        buf.div_(dist.get_world_size(group))
    elif op in _DIST_OPS:
        dist.all_reduce(buf, _DIST_OPS[op], group=group)
    else:
        raise ValueError(f"unsupported op {op!r}")
    return _scaled(buf, postscale_factor)


def _eager_broadcast(x: torch.Tensor, root_rank: int, group,
                     out: torch.Tensor) -> torch.Tensor:
    """Broadcast ``x`` from ``root_rank`` (a rank of ``group``) into
    ``out``, which may be ``x`` itself."""
    if out is not x:
        out.copy_(x)
    if x.numel() == 0:
        return out
    src = dist.get_global_rank(group, root_rank)
    flat = out if out.is_contiguous() else out.contiguous()
    dist.broadcast(flat, src, group=group)
    if flat is not out:
        out.copy_(flat)
    return out


def unpack_flat(red: torch.Tensor, sizes: tuple, shapes: tuple) -> list:
    """Split a flat result back into per-tensor views."""
    return [p.view(s) for p, s in zip(torch.split(red, list(sizes)), shapes)]


# ===========================================================================
# Fused-chunk plans: the whole pack → reduce → unpack chain of one chunk
# ===========================================================================


def _plan_epoch() -> int:
    """The elastic generation, folded into every plan key: a resize may
    keep the set's name and change its size, and a plan keyed on the name
    alone would replay the old topology."""
    return env_schema.get_int(env_schema.HOROVOD_ELASTIC_GEN, 0)


class FusedChunkPlan:
    """One chunk's steady-state dispatch: its layout, its collective and
    the factors the pack and the unpack apply."""

    __slots__ = ("group", "nproc", "dist_op", "pre", "unpack_factor",
                 "sizes", "shapes", "dtype", "total")

    def __init__(self, group, nproc: int, op, pre: float, post: float,
                 sizes: tuple, shapes: tuple, dtype: torch.dtype):
        self.group = group
        self.nproc = nproc
        self.pre = pre
        self.sizes = sizes
        self.shapes = shapes
        self.dtype = dtype
        self.total = sum(sizes)
        if op == ReduceOp.AVERAGE and _has_avg(group):
            self.dist_op, self.unpack_factor = dist.ReduceOp.AVG, post
        elif op == ReduceOp.AVERAGE:
            # the 1/n rides the unpack: one fp32 (fp64) factor post / n
            self.dist_op, self.unpack_factor = dist.ReduceOp.SUM, post / nproc
        else:
            self.dist_op, self.unpack_factor = dist.ReduceOp.SUM, post

    def execute(self, inputs: list, outputs: list, fusion_buffer):
        """Reduce ``inputs`` into ``outputs`` (which may be the inputs
        themselves) on PyTorch's current stream, through the fusion
        buffer; a chunk of one tensor is reduced in place in its output,
        with no pack."""
        if len(inputs) == 1:
            x, out = inputs[0].view(-1), outputs[0].view(-1)
            if self.pre != 1.0 or out.data_ptr() != x.data_ptr():
                fused_pack.pack([x], out, self.pre)
            dist.all_reduce(out, self.dist_op, group=self.group)
            if self.unpack_factor != 1.0:
                fused_pack.unpack(out, [out], self.unpack_factor)
            return
        flat = fusion_buffer.lease(self.dtype, self.total)
        fused_pack.pack(inputs, flat, self.pre)
        dist.all_reduce(flat, self.dist_op, group=self.group)
        fused_pack.unpack(flat, outputs, self.unpack_factor)


_PLANS: "collections.OrderedDict[tuple, FusedChunkPlan]" = \
    collections.OrderedDict()
_PLAN_CAPACITY = 1024
_plan_metric_handles = None


def _plan_metrics():
    """(hits, misses) of the plan cache, resolved once."""
    global _plan_metric_handles
    if _plan_metric_handles is None:
        reg = metrics_mod.get_registry()
        _plan_metric_handles = (
            reg.counter("hvd_fused_plan_hits_total",
                        "fused-chunk plan cache hits"),
            reg.counter("hvd_fused_plan_misses_total",
                        "fused-chunk plans built (cache misses)"))
    return _plan_metric_handles


def invalidate_fused_plans() -> int:
    """Drop every cached plan (chunk boundaries moved); returns how many."""
    n = len(_PLANS)
    _PLANS.clear()
    return n


def fused_chunk_plan(ps: ProcessSet, group, op, prescale_factor: float,
                     postscale_factor: float, names, sizes, shapes,
                     dtype: torch.dtype, device_type: str
                     ) -> Optional[FusedChunkPlan]:
    """The cached plan of one chunk, keyed by the full chunk signature —
    ordered names, shapes, dtype, op, factors, set and its size, the
    elastic generation and the device type. None for a chunk of no
    elements, which the runtime reduces tensor by tensor."""
    sizes = tuple(int(s) for s in sizes)
    if sum(sizes) == 0:
        return None
    nproc = ps.size
    key = ("fused_plan", "allreduce", ps.name, nproc, _plan_epoch(),
           tuple(names), tuple(shapes), str(dtype), int(op),
           float(prescale_factor), float(postscale_factor), device_type)
    hits, misses = _plan_metrics()
    plan = _PLANS.get(key)
    if plan is not None:
        _PLANS.move_to_end(key)
        hits.inc()
        return plan
    misses.inc()
    plan = FusedChunkPlan(group, nproc, ReduceOp(op), float(prescale_factor),
                          float(postscale_factor), sizes, tuple(shapes),
                          dtype)
    _PLANS[key] = plan
    while len(_PLANS) > _PLAN_CAPACITY:
        _PLANS.popitem(last=False)
    return plan


def _ps(process_set: Optional[ProcessSet]) -> ProcessSet:
    return process_set or ctx_mod.global_process_set()


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
