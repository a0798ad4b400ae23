"""Pipeline parallelism over the pp group — counterpart of
``horovod_tpu/parallel/pp.py``.

The GPipe schedule as one SPMD loop (fill, steady, drain): every rank runs
the same ``n_micro + n - 1`` ticks. At each tick each stage runs
``stage_fn`` on its input (microbatch t on stage 0, the received
activation elsewhere), the last stage records its output for microbatch
``t - (n - 1)``, and a cyclic shift to ``(i + 1) % n`` hands every output
on (``_comm.shift``: backward, the reverse shift, as ``ppermute``'s
transpose). Autograd then differentiates straight through the schedule.

Autograd runs only the nodes a rank's loss reaches, where JAX transposes
every ``ppermute``: the ranks must still make the same exchanges, in the
same order, backward. So every shift of a rank lies on one chain to its
output: stage 0 takes the received tensor into its input with a zero
cotangent (``_comm.anchor``, JAX's ``where(idx == 0, x0, recv)``), and
the last tick's received tensor is tied to the outputs the same way. Each
rank's backward then runs its ticks' shifts in reverse tick order,
matching its neighbours'.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from ._comm import anchor, group_size_rank, reduce_from_group, shift


class _Zero(torch.autograd.Function):
    """Zeros forward, a zero cotangent backward: a non-last stage's share
    of the loss, kept on the graph so its backward runs."""

    @staticmethod
    def forward(ctx, x):
        return torch.zeros_like(x)

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g)


def pipeline_apply(stage_fn: Callable, stage_params, inputs, *, group=None,
                   n_micro: int | None = None, remat_stage: bool = False):
    """Run a pipelined forward pass.

    Args:
      stage_fn: ``stage_fn(stage_params, x) -> y``, one pipeline stage,
        the same on every rank (this rank's ``stage_params`` hold its
        stage's weights); it must keep the microbatch shape.
      stage_params: this rank's stage weights.
      inputs: [n_micro, mb, ...] microbatched inputs (replicated; only
        stage 0 reads them).
      group: the pp group (``None``: one stage).
      n_micro: number of microbatches (defaults to inputs.shape[0]).
      remat_stage: recompute the stage in the backward
        (``torch.utils.checkpoint``): each tick keeps only its stage input.

    Returns: [n_micro, mb, ...] outputs, valid on the last stage; other
      stages return zeros.
    """
    n, idx = group_size_rank(group)
    if n_micro is None:
        n_micro = inputs.shape[0]
    mb_shape = inputs.shape[1:]
    if remat_stage:
        fn = stage_fn

        def stage_fn(p, x):
            return checkpoint(fn, p, x, use_reentrant=False)

    outs = [None] * n_micro
    recv = torch.zeros(mb_shape, dtype=inputs.dtype, device=inputs.device)
    for t in range(n_micro + n - 1):
        if idx == 0:
            # stage 0 consumes microbatch t (clamped past n_micro)
            x = inputs[min(t, n_micro - 1)]
            if t > 0 and n > 1:
                x = anchor(x, recv)
        else:
            x = recv
        y = stage_fn(stage_params, x)
        if y.shape != mb_shape:
            raise ValueError(
                f"stage_fn must preserve the microbatch shape for pipelining "
                f"(got {tuple(mb_shape)} -> {tuple(y.shape)})")
        t_out = t - (n - 1)
        if t_out >= 0 and idx == n - 1:
            outs[t_out] = y
        recv, = shift([y], group)
    zeros = torch.zeros(mb_shape, dtype=inputs.dtype, device=inputs.device)
    outputs = torch.stack([zeros if o is None else o for o in outs])
    if n > 1:
        outputs = anchor(outputs, recv)
    return outputs


def pipeline_loss(stage_fn: Callable, loss_fn: Callable, stage_params, inputs,
                  targets, *, group=None, n_micro: int | None = None,
                  remat_stage: bool = False):
    """Pipelined loss: forward through the stages, ``loss_fn(outputs,
    targets)`` on the last stage, summed over the group so every stage
    returns the same scalar. The sum's backward is the identity: each rank
    starts its backward from that one replicated loss, and the gradients
    are the sequential model's (the last stage's loss parameters get
    theirs, the others' zeros)."""
    n, idx = group_size_rank(group)
    outputs = pipeline_apply(stage_fn, stage_params, inputs, group=group,
                             n_micro=n_micro, remat_stage=remat_stage)
    per_micro = loss_fn(outputs, targets)
    local = per_micro if idx == n - 1 else _Zero.apply(per_micro)
    return reduce_from_group(local, group)
