"""Batch normalization with statistics over every rank — counterpart of
``horovod_tpu/torch/sync_batch_norm.py`` (reference
horovod/torch/sync_batch_norm.py).

``SyncBatchNorm`` is a drop-in for ``torch.nn.BatchNorm1d/2d/3d`` in
data-parallel training. In training each rank's batch mean and mean of
squares (one stacked ``[2, C]`` fp32 tensor) go through the runtime as a
named AVERAGE allreduce, so every rank normalizes with the global batch's
mean and biased variance ``max(0, E[x^2] - E[x]^2)``; equal batches on
every rank, the data-parallel contract, make the average of the moments
exact. The backward (``_SyncBatchNormFn``, written by hand) averages each
rank's ``mean(dy)`` and ``mean(dy * xhat)`` the same way; the weight and
bias gradients stay local, for ``DistributedOptimizer`` to reduce. The
running statistics follow torch's ``_BatchNorm``: momentum (or the
cumulative average when it is None) and the unbiased global variance.

Unlike the JAX module the moments stay on the device: nothing goes
through numpy. The allreduce's names come from a construction counter
(``torch.sync_bn.<n>``), so every rank must build its layers in the same
order, as it builds its model. At one rank nothing is exchanged (the JAX
module's ``cross_size() > 1`` counts processes, the port's ``size()``
does).
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

from ..common.context import size
from . import allreduce_async, synchronize

_bn_counter = itertools.count()


def _average_moments(a: torch.Tensor, b: torch.Tensor, name: str):
    """The ranks' average of two ``[C]`` fp32 tensors, by one allreduce of
    their stack."""
    out = synchronize(allreduce_async(torch.stack([a, b]).detach(),
                                      average=True, name=name))
    return out[0], out[1]


class _SyncBatchNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, input, weight, bias, eps, name):
        dims = [0] + list(range(2, input.dim()))
        mean = input.mean(dim=dims)
        meansq = (input * input).mean(dim=dims)
        if size() > 1:
            mean, meansq = _average_moments(mean.float(), meansq.float(),
                                            f"{name}.fwd_moments")
            mean, meansq = mean.to(input.dtype), meansq.to(input.dtype)
        var = (meansq - mean * mean).clamp_(min=0.0)
        invstd = torch.rsqrt(var + eps)
        shape = [1, -1] + [1] * (input.dim() - 2)
        out = (input - mean.view(shape)) * invstd.view(shape)
        if weight is not None:
            out = out * weight.view(shape) + bias.view(shape)
        ctx.save_for_backward(input, mean, invstd, weight)
        ctx.bn_name = name
        ctx.dims = dims
        # the statistics leave only for the module's running update
        mean_out, var_out = mean.detach(), var.detach()
        ctx.mark_non_differentiable(mean_out, var_out)
        return out, mean_out, var_out

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        input, mean, invstd, weight = ctx.saved_tensors
        dims = ctx.dims
        shape = [1, -1] + [1] * (input.dim() - 2)
        xhat = (input - mean.view(shape)) * invstd.view(shape)
        # the global batch's per-feature means of dy and dy * xhat: the
        # ranks' means averaged (equal batches)
        mean_dy = dy.mean(dim=dims)
        mean_dy_xhat = (dy * xhat).mean(dim=dims)
        if size() > 1:
            a, b = _average_moments(mean_dy.float(), mean_dy_xhat.float(),
                                    f"{ctx.bn_name}.bwd_moments")
            mean_dy, mean_dy_xhat = a.to(dy.dtype), b.to(dy.dtype)
        gx = invstd.view(shape) * (
            dy - mean_dy.view(shape) - xhat * mean_dy_xhat.view(shape))
        if weight is not None:
            gx = gx * weight.view(shape)
            gw = (dy * xhat).sum(dim=dims)
            gb = dy.sum(dim=dims)
        else:
            gw = gb = None
        return gx, gw, gb, None, None


class SyncBatchNorm(torch.nn.modules.batchnorm._BatchNorm):
    """Drop-in for ``torch.nn.BatchNorm1d/2d/3d`` in data-parallel
    training: batch statistics over every rank."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._hvd_name = f"torch.sync_bn.{next(_bn_counter)}"

    def _check_input_dim(self, input):
        if input.dim() < 2:
            raise ValueError(f"expected at least 2D input, got {input.dim()}D")

    def forward(self, input):
        self._check_input_dim(input)
        if not self.training:
            if self.running_mean is None:
                # track_running_stats=False: batch statistics in eval, as
                # torch's BatchNorm
                return F.batch_norm(input, None, None, self.weight,
                                    self.bias, True, 0.0, self.eps)
            return F.batch_norm(
                input, self.running_mean, self.running_var, self.weight,
                self.bias, False, 0.0, self.eps)
        # torch's _BatchNorm: momentum None is the cumulative average
        if self.track_running_stats and self.num_batches_tracked is not None:
            self.num_batches_tracked.add_(1)
            eaf = (1.0 / float(self.num_batches_tracked)
                   if self.momentum is None else self.momentum)
        else:
            eaf = 0.0 if self.momentum is None else self.momentum
        out, mean, var = _SyncBatchNormFn.apply(
            input, self.weight, self.bias, self.eps, self._hvd_name)
        if self.track_running_stats:
            n_global = (input.numel() // input.shape[1]) * max(size(), 1)
            unbiased = var * (n_global / max(n_global - 1, 1))
            with torch.no_grad():
                self.running_mean.mul_(1 - eaf).add_(mean * eaf)
                self.running_var.mul_(1 - eaf).add_(unbiased * eaf)
        return out

    @classmethod
    def convert_sync_batchnorm(cls, module):
        """Every ``_BatchNorm`` in ``module`` replaced by a ``SyncBatchNorm``
        with its parameters and buffers (torch DDP's convention)."""
        out = module
        if isinstance(module, torch.nn.modules.batchnorm._BatchNorm) and \
                not isinstance(module, cls):
            ref = next(itertools.chain(module.parameters(recurse=False),
                                       module.buffers(recurse=False)), None)
            out = cls(module.num_features, module.eps, module.momentum,
                      module.affine, module.track_running_stats,
                      device=None if ref is None else ref.device)
            if module.affine:
                with torch.no_grad():
                    out.weight.copy_(module.weight)
                    out.bias.copy_(module.bias)
            out.running_mean = module.running_mean
            out.running_var = module.running_var
            out.num_batches_tracked = module.num_batches_tracked
        for name, child in module.named_children():
            out.add_module(name, cls.convert_sync_batchnorm(child))
        return out
