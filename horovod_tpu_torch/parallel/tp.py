"""Tensor (model) parallelism building blocks — counterpart of
``horovod_tpu/parallel/tp.py``.

Megatron's column/row pair over the tp group (``Mesh.group("tp")``):
column-parallel weights are sharded on the output dim and take a
replicated input, row-parallel weights on the input dim and take the
column layer's sharded activation, closing the pair with one sum over the
group. The JAX helpers run inside ``shard_map``, where only the forward is
their contract; the port's are autograd ops whose gradients are the dense
model's (``_comm``'s f/g pair):

- ``column_parallel_dense`` passes its replicated input through f (the
  identity; backward, the sum of the input's gradient over the group: each
  rank's product gives only its shard's part of it);
- ``row_parallel_dense`` and ``parallel_attention_output`` close with g
  (the sum; backward, the identity: the output's gradient is replicated).

``group=None`` is a tp of one, where each is the plain product.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._comm import copy_to_group, group_size_rank, reduce_from_group


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def column_parallel_dense(x, w_local, b_local=None, group=None):
    """y_local = x @ W[:, shard]: weights sharded on the output dim, input
    replicated over ``group``. No communication forward."""
    y = torch.einsum("...d,df->...f", copy_to_group(x, group), w_local)
    if b_local is not None:
        y = y + b_local
    return y


def row_parallel_dense(x_local, w_local, group=None, b=None):
    """y = sum over ``group`` of x[:, shard] @ W[shard, :]: weights sharded
    on the input dim, activations sharded from a preceding column-parallel
    layer. One sum over the group closes the pair."""
    y = reduce_from_group(torch.einsum("...f,fd->...d", x_local, w_local),
                          group)
    if b is not None:
        y = y + b
    return y


def parallel_mlp(x, w1_local, w2_local, group=None, act=_gelu):
    """Column → act → row parallel MLP: the canonical Megatron block
    shape."""
    return row_parallel_dense(act(column_parallel_dense(x, w1_local,
                                                        group=group)),
                              w2_local, group)


def parallel_attention_output(o_heads_local, wo_local, group=None):
    """Attention output projection with heads sharded over ``group``:
    o ``[..., h_local, hd]``, wo_local ``[h_local, hd, d]``, summed over
    the group."""
    return reduce_from_group(
        torch.einsum("...hk,hkd->...d", o_heads_local, wo_local), group)


def shard_leading(x, group=None):
    """This rank's shard of a replicated tensor's leading dim."""
    n, i = group_size_rank(group)
    chunk = x.shape[0] // n
    return x[i * chunk:(i + 1) * chunk]
