"""Expert parallelism (MoE) over the ep group — counterpart of
``horovod_tpu/parallel/moe.py``.

Top-k gating with per-expert capacity, a dual all-to-all dispatch and
combine over the ep group (``Mesh.group("ep")``), and the uneven split
problem solved by capacity padding, as the JAX package does it: every
exchange has a static shape. Each rank hosts ``n_experts / ep`` experts
and a token shard ``[t_local, d]``.

The gating and the dense ``[t, e, c]`` dispatch and combine products are
the JAX package's operations in fp32 (``torch.argmax`` takes the first of
equal maxima, as ``jnp.argmax`` does). The exchanges are ``_comm``'s
``all_to_all`` (one ``all_to_all_single``; backward the inverse exchange
of the cotangents) and ``aux``'s mean over the group (``lax.pmean``, whose
backward is the mean of the cotangents), so a rank's gradients are those
of the sum of every rank's loss, as ``jax.grad`` inside ``shard_map``
gives them: a replicated leaf's (``gate_w``) is this rank's part of it,
before any data-parallel average. The local experts run as one call over
``e_local`` (``torch.func.vmap(expert_fn)``, as ``jax.vmap``).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from ._comm import all_to_all, group_size_rank, mean_over_group


def _one_hot(idx, n: int):
    return F.one_hot(idx, n).to(torch.float32)


def _capacity_slots(onehot, pos, capacity: int):
    """The ``[t, e, c]`` one-hot of each routed token's queue slot; tokens
    past ``capacity`` (and unrouted entries, pos -1) get none."""
    in_cap = (pos < capacity) & (pos >= 0) & (onehot > 0)
    pos = torch.where(in_cap, pos, 0.0)
    cap = _one_hot(pos.to(torch.int64), capacity) * in_cap[..., None]
    return onehot[..., None] * cap


def top1_gating(gate_logits, n_experts: int, capacity: int):
    """Switch-style top-1 gating with per-expert capacity.

    Returns (dispatch [t, e, c] one-hot, combine [t, e, c] weights,
    aux_loss): the standard load-balancing auxiliary loss.
    """
    probs = torch.softmax(gate_logits.float(), dim=-1)
    expert = torch.argmax(probs, dim=-1)  # [t]
    gate = torch.gather(probs, -1, expert[:, None])[:, 0]
    onehot = _one_hot(expert, n_experts)  # [t, e]
    # position of each token within its expert's queue
    pos = torch.cumsum(onehot, dim=0) * onehot - 1.0  # -1 where not routed
    dispatch = _capacity_slots(onehot, pos, capacity)
    combine = dispatch * gate[:, None, None]
    # load-balancing loss (Switch Transformer eq. 4)
    density = onehot.mean(dim=0)
    density_proxy = probs.mean(dim=0)
    aux = (density * density_proxy).sum() * n_experts
    return dispatch, combine, aux


def topk_gating(gate_logits, n_experts: int, capacity: int, k: int = 2,
                normalize: bool = True):
    """GShard-style top-k gating with per-expert capacity.

    Picks experts greedily (k rounds of masked argmax); each pick's queue
    position counts the slots earlier picks took. With ``normalize`` the
    dispatched picks' gate values are renormalized to sum to 1 per token
    (GShard top-2). Returns (dispatch, combine, aux_loss) like
    ``top1_gating``, the aux loss on the first pick.
    """
    probs = torch.softmax(gate_logits.float(), dim=-1)
    t = probs.shape[0]
    remaining = probs
    used = torch.zeros((1, n_experts), dtype=torch.float32,
                       device=probs.device)
    dispatch = torch.zeros((t, n_experts, capacity), dtype=torch.float32,
                           device=probs.device)
    gates_raw = torch.zeros_like(dispatch)
    first_onehot = None
    for _ in range(k):
        expert = torch.argmax(remaining, dim=-1)
        onehot = _one_hot(expert, n_experts)
        if first_onehot is None:
            first_onehot = onehot
        gate = torch.gather(probs, -1, expert[:, None])[:, 0]
        pos = torch.cumsum(onehot, dim=0) * onehot - 1.0 + used * onehot
        d_i = _capacity_slots(onehot, pos, capacity)
        dispatch = dispatch + d_i
        gates_raw = gates_raw + d_i * gate[:, None, None]
        used = used + onehot.sum(dim=0, keepdim=True)
        remaining = remaining * (1.0 - onehot)
    if normalize:
        # renormalize over the *dispatched* picks only (GShard top-2)
        denom = gates_raw.sum(dim=(1, 2), keepdim=True)
        combine = gates_raw / torch.clamp(denom, min=1e-9)
    else:
        combine = gates_raw
    density = first_onehot.mean(dim=0)
    density_proxy = probs.mean(dim=0)
    aux = (density * density_proxy).sum() * n_experts
    return dispatch, combine, aux


def capacity_for(t_local: int, n_experts: int,
                 capacity_factor: float) -> int:
    """Slots an expert keeps for each source rank's tokens."""
    return max(1, int(capacity_factor * t_local / n_experts))


def moe_layer(x, gate_w, expert_fn: Callable, expert_params, *, group=None,
              capacity_factor: float = 1.25, k: int = 1):
    """Expert-parallel MoE layer, this rank's view.

    Args:
      x: [t_local, d] this rank's tokens.
      gate_w: [d, n_experts_total] router weights (replicated).
      expert_fn: ``expert_fn(params, x) -> y`` for one expert, applied to
        this rank's experts at once; ``expert_params`` leaves have leading
        dim n_local_experts.
      group: the ep group (``None``: every expert on this rank).
      capacity_factor: capacity = factor * t_local / n_experts_total.

    Returns (y [t_local, d], aux_loss).
    """
    n, _ = group_size_rank(group)
    t_local, d = x.shape
    n_experts = gate_w.shape[-1]
    if n_experts % n:
        raise ValueError(f"experts ({n_experts}) must divide by ep={n}")
    e_local = n_experts // n
    capacity = capacity_for(t_local, n_experts, capacity_factor)

    gate_logits = x.float() @ gate_w.float()
    if k <= 1:
        dispatch, combine, aux = top1_gating(gate_logits, n_experts, capacity)
    else:
        dispatch, combine, aux = topk_gating(gate_logits, n_experts,
                                             capacity, k=k)

    # the experts' slots [e, c, d] as [n (owner), e_local, c, d]; after the
    # exchange this rank holds, for each source rank, its experts' slots
    expert_in = torch.einsum("tec,td->ecd", dispatch, x.float())
    expert_in = all_to_all(expert_in.reshape(n, e_local, capacity, d), group)
    # fold the source rank into the capacity dim and run the local experts
    expert_in = expert_in.transpose(0, 1).reshape(e_local, n * capacity, d)
    expert_out = torch.func.vmap(expert_fn)(expert_params,
                                            expert_in.to(x.dtype))
    # reverse the exchange
    expert_out = expert_out.reshape(e_local, n, capacity, d).transpose(0, 1)
    expert_out = all_to_all(expert_out, group).reshape(n_experts, capacity, d)
    y = torch.einsum("tec,ecd->td", combine, expert_out.float())
    return y.to(x.dtype), mean_over_group(aux, group)
