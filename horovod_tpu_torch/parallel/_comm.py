"""The exchanges the parallelism strategies make over a ``torch.distributed``
group, each a differentiable op with its JAX transpose as its backward.

A JAX strategy is a per-chip function inside ``shard_map`` that names a
mesh axis; its port is a per-rank function that takes the group of that
axis (``Mesh.group(axis)``). ``group=None`` is a group of one: nothing is
exchanged. A process set's ``runtime_group`` belongs to the background
runtime's cycle thread and is refused.

- ``copy_to_group`` / ``reduce_from_group``: Megatron's f/g pair. f is the
  identity forward and sums the gradient over the group backward; g sums
  forward and is the identity backward. A column-parallel layer's
  replicated input passes f, a row-parallel layer's partial sum passes g,
  so the gradients are the dense model's on every rank.
- ``mean_over_group``: the mean forward; backward the mean of the
  cotangents (``lax.pmean``'s transpose inside ``shard_map``), the
  gradient of the sum of every rank's loss. ``sum_over_group`` is the
  same for ``lax.psum``: the sum forward, the sum of the cotangents
  backward.
- ``all_to_all``: ``lax.all_to_all(x, split_axis, concat_axis,
  tiled=True)``: ``split_axis`` cut into n pieces, piece j to rank j, the
  pieces received concatenated along ``concat_axis`` in source order; one
  ``all_to_all_single`` of equal splits. Its backward is the inverse
  exchange (the axes swapped).
- ``shift``: ``lax.ppermute`` of a list of tensors by ``step`` places round
  the ring, in one ``batch_isend_irecv`` on global ranks; backward the
  reverse shift.
- ``anchor``: the identity on one tensor that ties others into the graph
  with zero cotangents, so that a rank whose loss does not reach an
  exchange still runs its backward (JAX transposes every ``ppermute``
  whatever its cotangent; autograd runs only the nodes the loss reaches).

``exchanges`` counts the exchanges made over ``torch.distributed``, by
kind, forward and backward, for every strategy.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

exchanges = {"all_reduce": 0, "all_to_all": 0, "ppermute": 0, "all_gather": 0,
             "reduce_scatter": 0}


def group_size_rank(group):
    """(n, i): the group's size and this rank's place in it. ``None`` is a
    group of one; a process set's runtime group is refused."""
    if group is None:
        return 1, 0
    from ..common.context import is_runtime_group

    if is_runtime_group(group):
        raise ValueError(
            "the parallelism strategies run on a process set's `group`, not "
            "its `runtime_group`: that communicator belongs to the "
            "background runtime's cycle thread")
    return dist.get_world_size(group), dist.get_rank(group)


def _all_reduce(x, group):
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    exchanges["all_reduce"] += 1
    return out


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MeanOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _all_reduce(x, group) / n

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group) / ctx.n, None, None


class _SumOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def copy_to_group(x, group):
    """Megatron's f: the identity, whose backward sums over ``group``."""
    if group_size_rank(group)[0] == 1:
        return x
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x, group):
    """Megatron's g: the sum over ``group``, whose backward is the
    identity."""
    if group_size_rank(group)[0] == 1:
        return x
    return _ReduceFromGroup.apply(x, group)


def mean_over_group(x, group):
    """``lax.pmean`` over ``group``, differentiable as JAX transposes it."""
    n, _ = group_size_rank(group)
    if n == 1:
        return x
    return _MeanOverGroup.apply(x, group, n)


def sum_over_group(x, group):
    """``lax.psum`` over ``group``, differentiable as JAX transposes it
    inside ``shard_map``: the backward sums the cotangents."""
    if group_size_rank(group)[0] == 1:
        return x
    return _SumOverGroup.apply(x, group)


def _a2a(x, split_axis: int, concat_axis: int, group):
    n = dist.get_world_size(group)
    xs = x.movedim(split_axis, 0)
    xs = xs.reshape(n, xs.shape[0] // n, *xs.shape[1:]).contiguous()
    out = torch.empty_like(xs)
    dist.all_to_all_single(out, xs, group=group)
    exchanges["all_to_all"] += 1
    out = out.movedim(1, split_axis + 1).movedim(0, concat_axis)
    shape = list(x.shape)
    shape[split_axis] //= n
    shape[concat_axis] *= n
    return out.reshape(shape)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_axis, concat_axis, group):
        ctx.axes = (split_axis, concat_axis, group)
        return _a2a(x, split_axis, concat_axis, group)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis, group = ctx.axes
        return _a2a(g, concat_axis, split_axis, group), None, None, None


def all_to_all(x, group, split_axis: int = 0, concat_axis: int = 0):
    """Tiled all-to-all over ``group``: ``x``'s ``split_axis`` cut into n
    pieces, piece j to rank j, the received pieces concatenated along
    ``concat_axis`` in source-rank order."""
    n, _ = group_size_rank(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all needs dim {split_axis} of "
                         f"{tuple(x.shape)} to divide by {n}")
    if n == 1:
        return x
    return _AllToAll.apply(x, split_axis, concat_axis, group)


def _send_recv(tensors, group, step: int):
    n, i = dist.get_world_size(group), dist.get_rank(group)
    dst = dist.get_global_rank(group, (i + step) % n)
    src = dist.get_global_rank(group, (i - step) % n)
    tensors = [t.contiguous() for t in tensors]
    outs = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, o in zip(tensors, outs):
        ops += [dist.P2POp(dist.isend, t, dst, group),
                dist.P2POp(dist.irecv, o, src, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    exchanges["ppermute"] += 1
    return outs


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, step, *tensors):
        ctx.group, ctx.step = group, step
        return tuple(_send_recv(tensors, group, step))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *_send_recv(grads, ctx.group, -ctx.step))


def shift(tensors, group, step: int = 1) -> list:
    """Each tensor to the rank ``step`` places on in the ring, the one
    ``step`` places back's in return (``lax.ppermute`` with ``(i, (i +
    step) % n)``), all in one exchange."""
    if group_size_rank(group)[0] == 1:
        return list(tensors)
    return list(_Shift.apply(group, step, *tensors))


class _Anchor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, *tied):
        ctx.tied = [(t.shape, t.dtype, t.device) for t in tied]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g, *[torch.zeros(s, dtype=dt, device=dv)
                     for s, dt, dv in ctx.tied])


def anchor(out, *tied):
    """``out``, with ``tied`` on the graph behind it: their cotangents are
    zeros, so their backward exchanges run whatever the loss uses."""
    return _Anchor.apply(out, *tied)
