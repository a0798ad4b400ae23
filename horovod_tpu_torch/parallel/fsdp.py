"""ZeRO-3 / FSDP: fully-sharded data parallelism — counterpart of
``horovod_tpu/parallel/fsdp.py``.

Every large parameter leaf is sharded over the data axis on its largest
dimension that the axis divides (``fsdp_specs``, through
``sharding_policy.shard_dim``, the JAX package's choice for the same
shapes), and the optimizer state follows the parameters it mirrors
(``opt_state_specs``), so parameters, gradients and optimizer state are
1/N a rank at rest. Leaves under ``min_shard_elems`` stay replicated.

The JAX package leaves the gather and scatter schedule to XLA; the port's
step gathers the whole model once (``all_gather`` of each sharded leaf
into the model's parameters), runs forward and backward, reduce-scatters
each sharded gradient into its shard and all-reduces the replicated ones,
averaging over the axis, steps the optimizer on the shards and frees the
gathered parameters. A leaf sharded on a dim other than 0 (the largest
dim wins: ``w1 (d, d_ff)`` shards dim 1) is moved to the front for the
exchange and back: the gathered ``[n, ..., s, ...]`` is transposed to
``[..., n, s, ...]``, and the gradient ``[..., n, s, ...]`` to
``[n, ..., s, ...]`` before its reduce-scatter.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..ops.collectives import _all_gather, _reduce_scatter
from ._comm import exchanges, group_size_rank
from .sharding_policy import DEFAULT_MIN_SHARD_ELEMS, shard_dim


def fsdp_specs(params, min_shard_elems: int = DEFAULT_MIN_SHARD_ELEMS,
               axis_size=None) -> dict:
    """``{name: shard dim or None}`` for a mapping of names to tensors
    (``named_parameters()``, a ``state_dict``). ``axis_size``: when given,
    only dims it divides are sharded; a leaf with none replicates."""
    return {k: shard_dim(tuple(v.shape), min_shard_elems=min_shard_elems,
                         axis_size=axis_size)
            for k, v in dict(params).items()}


def opt_state_specs(opt_state, params, pspecs):
    """Shard dims for optimizer-state leaves, like the params they mirror:
    any tensor whose shape matches a param's (Adam's moments, momentum
    buffers) gets that param's dim, the first param of that shape's;
    everything else (step counters, scalars) None. ``opt_state``: a tree
    of dicts, lists and tuples (``optimizer.state_dict()["state"]``)."""
    by_shape = {}
    for name, p in dict(params).items():
        by_shape.setdefault(tuple(p.shape), pspecs[name])

    def spec(x):
        if isinstance(x, dict):
            return {k: spec(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(spec(v) for v in x)
        if isinstance(x, torch.Tensor):
            return by_shape.get(tuple(x.shape))
        return None

    return spec(opt_state)


def _gather(shard, dim: int, group, n: int):
    # the ranks' shards end to end on dim 0, then each moved to its place
    shape = tuple(shard.shape)
    buf = torch.empty((n * shape[0],) + shape[1:], dtype=shard.dtype,
                      device=shard.device)
    _all_gather(buf, shard.contiguous(), group=group)
    exchanges["all_gather"] += 1
    full = list(shape)
    full[dim] *= n
    return buf.view((n,) + shape).movedim(0, dim).reshape(full)


def _scatter_mean(grad, dim: int, group, n: int):
    s = grad.shape[dim] // n
    parts = grad.unflatten(dim, (n, s)).movedim(dim, 0).contiguous()
    out = torch.empty(parts.shape[1:], dtype=grad.dtype, device=grad.device)
    _reduce_scatter(out, parts.flatten(0, 1), dist.ReduceOp.SUM,
                    group=group)
    exchanges["reduce_scatter"] += 1
    return out.div_(n)


class FSDPState:
    """One rank's state: ``shards`` (each sharded leaf's slice, a
    Parameter the optimizer steps), the replicated leaves (the model's own
    Parameters), ``specs`` and the optimizer. Between steps the model's
    sharded Parameters hold no storage."""

    def __init__(self, model, optimizer_fn: Callable, group, specs: dict):
        self.model, self.group, self.specs = model, group, specs
        self.n, self.rank = group_size_rank(group)
        self.params = dict(model.named_parameters())
        self.shards = {}
        with torch.no_grad():
            for name, p in self.params.items():
                dim = specs[name]
                if dim is not None:
                    s = p.shape[dim] // self.n
                    self.shards[name] = torch.nn.Parameter(
                        p.narrow(dim, self.rank * s, s).clone())
        self._release()
        self.optimizer = optimizer_fn(
            [self.shards.get(k, p) for k, p in self.params.items()])

    def _release(self):
        for name in self.shards:
            self.params[name].data = torch.empty(
                0, dtype=self.params[name].dtype,
                device=self.params[name].device)

    def gather(self):
        """Every sharded leaf whole again in the model (collective)."""
        with torch.no_grad():
            for name, shard in self.shards.items():
                self.params[name].data = _gather(shard, self.specs[name],
                                                 self.group, self.n)

    def full_state_dict(self) -> dict:
        """Every parameter whole, cloned (collective)."""
        self.gather()
        out = {k: p.detach().clone() for k, p in self.params.items()}
        self._release()
        return out

    def bytes_a_rank(self) -> dict:
        """Parameter and optimizer-state bytes this rank holds at rest."""
        held = [self.shards.get(k, p) for k, p in self.params.items()]
        state = [t for st in self.optimizer.state.values()
                 for t in st.values() if isinstance(t, torch.Tensor)]
        return {"params": sum(t.numel() * t.element_size() for t in held),
                "optimizer_state": sum(t.numel() * t.element_size()
                                       for t in state)}

    def step(self, loss_fn: Callable, batch):
        """Gather, forward and backward on this rank's ``batch``, reduce
        the gradients into the shards (the mean over the axis), step the
        optimizer on the shards, free the gathered leaves. Returns the
        loss averaged over the axis."""
        self.gather()
        for p in self.params.values():
            p.grad = None
        loss = loss_fn(self.model, batch)
        loss.backward()
        for name, p in self.params.items():
            dim = self.specs[name]
            if dim is not None:
                self.shards[name].grad = _scatter_mean(p.grad, dim,
                                                       self.group, self.n)
                p.grad = None
            elif self.n > 1:
                dist.all_reduce(p.grad, group=self.group)
                exchanges["all_reduce"] += 1
                p.grad.div_(self.n)
        self._release()
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        mean = loss.detach().clone()
        if self.n > 1:
            dist.all_reduce(mean, group=self.group)
            mean.div_(self.n)
        return mean


def fsdp_train_step(loss_fn: Callable, optimizer_fn: Callable, mesh,
                    axis: str = "dp",
                    min_shard_elems: int = DEFAULT_MIN_SHARD_ELEMS):
    """A ZeRO-3 train step over ``axis`` of ``mesh``.

    ``loss_fn(model, batch) -> scalar``: the loss of this rank's batch
    shard (the mean over its examples; the step averages the gradients
    over the axis, so equal shards give the global batch's gradient).
    ``optimizer_fn(params) -> torch.optim.Optimizer``. Returns
    ``make(model) -> (state, step)``: ``make`` shards the model's
    parameters (every rank holds the same initial model) and builds the
    optimizer on the shards; ``step(batch)`` runs one update and returns
    the loss averaged over the axis.
    """
    group = mesh.group(axis)
    n = mesh.size(axis)

    def make(model):
        specs = fsdp_specs(model.named_parameters(), min_shard_elems, n)
        state = FSDPState(model, optimizer_fn, group, specs)

        def step(batch):
            return state.step(loss_fn, batch)

        return state, step

    return make
