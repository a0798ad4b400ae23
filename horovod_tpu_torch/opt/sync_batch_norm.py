"""Batch normalization over a group, in the step — counterpart of
``horovod_tpu/opt/sync_batch_norm.py``.

The JAX module hands ``axis_name`` to flax's ``BatchNorm``, whose
statistics are a ``pmean`` over the mesh axis inside the compiled step,
differentiable by construction. Here the same arithmetic runs over a
``torch.distributed`` group on the caller's thread (``group=None``: the
global set's caller group), with autograd through the exchanges
(``parallel/_comm.py``): the mean over the group has the mean of the
cotangents as its backward and the sum the sum, as JAX transposes
``pmean`` and ``psum`` inside ``shard_map``.

- ``SyncBatchNorm``: flax's ``BatchNorm(axis_name=...)`` (momentum 0.9,
  epsilon 1e-5) over the features of dim 1 (NCHW, the port's layout):
  each rank's batch mean and mean of squares in fp32, averaged over the
  group in one ``all_reduce``, the biased variance
  ``max(0, E[x^2] - E[x]^2)``, flax's normalization op for op, and the
  running statistics as ``0.9·running + 0.1·batch``.
- ``moments_sync``: the group's mean and variance of ``x`` over ``axes``,
  count-weighted (the sums of x and of x² and the element count, summed
  over the group).
- ``sync_batch_stats``: running statistics averaged over the group, the
  fold before a checkpoint.

``hvd.SyncBatchNorm`` (``torch/sync_batch_norm.py``) stays the
reference's module over the background runtime.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import collectives as C
from ..parallel import _comm


class SyncBatchNorm(nn.Module):
    """flax's ``BatchNorm`` with ``axis_name``: batch statistics over the
    whole batch of ``group`` in training, the running statistics in
    evaluation (``use_running_average``, or ``not self.training`` when
    None). The output keeps the input's dtype."""

    def __init__(self, num_features: int, group=None,
                 use_running_average=None, momentum: float = 0.9,
                 epsilon: float = 1e-5, device=None):
        super().__init__()
        self.group = group
        self.use_running_average = use_running_average
        self.momentum, self.epsilon = momentum, epsilon
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(num_features, device=device))
        self.register_buffer("running_var",
                             torch.ones(num_features, device=device))

    def _shape(self, x) -> tuple:
        return (1, -1) + (1,) * (x.dim() - 2)

    def forward(self, x, use_running_average=None):
        if use_running_average is None:
            use_running_average = self.use_running_average
        if use_running_average is None:
            use_running_average = not self.training
        xf = x.float()
        shape = self._shape(x)
        if use_running_average:
            mean, var = self.running_mean, self.running_var
        else:
            axes = [d for d in range(x.dim()) if d != 1]
            moments = torch.stack([xf.mean(axes), (xf * xf).mean(axes)])
            mean, meansq = _comm.mean_over_group(
                moments, C.spmd_group(self.group)).unbind(0)
            var = (meansq - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var
                                       + (1.0 - m) * var)
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


def moments_sync(x: torch.Tensor, group=None, axes=(0,)) -> tuple:
    """The mean and variance of ``x`` over ``axes`` and every rank of
    ``group``: the element count and the sums of x and x² summed over the
    group (the count in fp32, the sums in one call), ``mean = s1 / n``,
    ``var = s2 / n - mean²``. Differentiable."""
    group = C.spmd_group(group)
    n_local = 1
    for a in axes:
        n_local *= x.shape[a]
    n = _comm.sum_over_group(
        torch.tensor([float(n_local)], dtype=torch.float32,
                     device=x.device), group)[0]
    sums = _comm.sum_over_group(
        torch.stack([x.sum(dim=tuple(axes)), (x * x).sum(dim=tuple(axes))]),
        group)
    mean = sums[0] / n
    return mean, sums[1] / n - mean * mean


def sync_batch_stats(batch_stats, group=None):
    """Running statistics (a tensor, or dicts, lists and tuples of them)
    averaged over ``group``, one call a dtype."""
    from . import tree_flatten, tree_unflatten

    _, leaves, spec = tree_flatten(batch_stats)
    return tree_unflatten(spec, C.spmd_fused_allreduce(
        leaves, C.ReduceOp.AVERAGE, group))
