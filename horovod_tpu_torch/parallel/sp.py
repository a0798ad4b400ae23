"""Sequence parallelism: ring attention (block-sharded and striped) and
Ulysses — counterpart of ``horovod_tpu/parallel/sp.py``.

Inputs are per-rank blocks ``[batch, s_local, heads, head_dim]`` of one
sequence split over the ranks of a ``torch.distributed`` group:

- **Ring attention** (``ring_attention``, ``striped_ring_attention``): K/V
  blocks rotate around the ring, one neighbour exchange a round, while an
  online softmax combines each round's normalized ``(o, m, l)`` block stats
  exactly (``_ring_scan`` :34-71). Each round's stats come from the flash
  kernel (``ops.flash_attention.attention_stats``) on the card and from its
  blockwise plain version (``scan_stats``) on the CPU. The two layouts
  differ only in ``round_stats``: block-sharded (rank i holds tokens
  ``[i*s, (i+1)*s)``) computes the causal diagonal, full blocks from
  earlier ranks and skips later ones; striped (rank i holds tokens i, i+n,
  …; ``stripe_tokens``) computes a triangular block every round, inclusive
  when the source rank is not after this one and strict (``causal_offset
  = 1``) when it is, so every rank does equal work.
- **Ulysses** (``ulysses_attention``): two tiled all-to-alls trade the
  sequence sharding for a head sharding around a full-sequence attention
  core and back.

The ring's rotation is an argument of the scaffold: across ranks it is a
differentiable neighbour exchange (``_RingShift``: ``batch_isend_irecv``
on the caller's group; its backward is the same exchange in reverse, the
transpose of JAX's ``ppermute``); ``_simulated_ring`` runs all ``n``
ranks' shards in one process with the rotation a list roll, through the
same round and combine code (the CPU tests and the one-card phase of
``chip_smoke.py`` drive it). Ulysses' exchange is likewise an argument
(``_AllToAll`` over ``all_to_all_single``, or ``_simulated_all_to_all``).

Groups: ``group=None`` is a ring of one, whatever the world size (a
data-parallel job that passes ``ring_attention`` as ``attn_fn`` stays data
parallel). A multi-rank caller passes a process set's ``group`` (e.g.
``hvd.global_process_set().group``); a set's ``runtime_group`` belongs to
the background runtime's cycle thread and is refused. Under ``remat`` the
block's recompute repeats its exchanges, as ``jax.checkpoint`` repeats
``ppermute``.

Departures from the JAX package, neither changing a result: after the last
round nothing rotates (JAX's scan rotates once more and drops the result);
Ulysses' default core on the card is the flash kernel through
``ring_attention`` at a ring of one, since no plain path runs there (JAX
takes ``causal_attention`` everywhere; the port does on the CPU).
``exchanges`` counts the exchanges made over ``torch.distributed`` by kind,
forward and backward.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.flash_attention import NEG_INF, attention_stats, scan_stats

# exchanges over torch.distributed, by kind, forward and backward (read and
# reset by chip_smoke.py and sp_probe.py)
exchanges = {"ppermute": 0, "all_to_all": 0}


def _to_flat(x):  # kernel layout: [B=b*h, s, d]
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d).contiguous()


def _combine(acc, stats):
    """One step of the ring's online-softmax combine (``_ring_scan``
    :54-61): the round's normalized ``o`` is un-normalized by ``l * beta``
    and merged into the running (m, l, o); ``acc=None`` starts from
    (NEG_INF, 0, 0)."""
    o_r, m_r, l_r = stats
    if acc is None:
        acc = (torch.full_like(m_r, NEG_INF), torch.zeros_like(l_r),
               torch.zeros(o_r.shape, dtype=torch.float32,
                           device=o_r.device))
    m_acc, l_acc, o_acc = acc
    m_new = torch.maximum(m_acc, m_r)
    alpha = torch.exp(m_acc - m_new)
    beta = torch.exp(m_r - m_new)
    l_acc = l_acc * alpha + l_r * beta
    o_acc = o_acc * alpha[..., None] + o_r.float() * (l_r * beta)[..., None]
    return m_new, l_acc, o_acc


def _finish(acc, shape, dtype):
    """The combined sum normalized once (``_ring_scan`` :70-71), back in
    the ``[b, s, h, d]`` layout and the input dtype."""
    b, s, h, d = shape
    _, l_acc, o_acc = acc
    out = o_acc / torch.where(l_acc == 0.0, 1.0, l_acc)[..., None]
    return out.reshape(b, h, s, d).transpose(1, 2).to(dtype)


def _ring_scan(qs, ks, vs, ranks, n: int, rotate, round_stats):
    """The ring scaffold. ``qs``, ``ks``, ``vs``: the blocks this process
    holds, one for each ring position in ``ranks``. Round r gives position
    i the K/V of source ``j = (i - r) % n``; ``round_stats(qf, kf, vf, r,
    i, j)`` makes its stats in the kernel layout, then ``rotate(kfs, vfs)``
    hands every block to the next position (not after the last round).
    Returns the outputs and the K/V blocks held at the end."""
    qfs = [_to_flat(q) for q in qs]
    kfs = [_to_flat(k) for k in ks]
    vfs = [_to_flat(v) for v in vs]
    accs = [None] * len(ranks)
    for r in range(n):
        for x, i in enumerate(ranks):
            accs[x] = _combine(accs[x], round_stats(qfs[x], kfs[x], vfs[x],
                                                    r, i, (i - r) % n))
        if r < n - 1:
            kfs, vfs = rotate(kfs, vfs)
    return ([_finish(a, q.shape, q.dtype) for a, q in zip(accs, qs)],
            (kfs, vfs))


def _stats_fn(q, use_flash, block_q: int, block_k: int):
    """``stats(qf, kf, vf, causal, offset)``: the flash kernel's dispatch
    (the kernel on the card, raising where the blocks do not tile the
    sequence; ``lax_stats`` on the CPU) or, with ``use_flash=False`` and by
    default on the CPU, the blockwise ``scan_stats``."""
    if use_flash is None:
        use_flash = q.device.type != "cpu"

    def stats(qf, kf, vf, causal, offset):
        if use_flash:
            return attention_stats(qf, kf, vf, causal, block_q, block_k,
                                   offset)
        return scan_stats(qf, kf, vf, causal, offset, block_k)

    return stats


def _blocked_rounds(stats):
    """Block-sharded causal rounds (``ring_attention`` :105-124): round 0
    is the causal diagonal, a source before this rank a full block, a
    source after it masked out entirely (skipped: nothing is computed, the
    round contributes m = NEG_INF, l = 0). Round 0 comes first, so every
    row has a real entry before any skip and the combine stays finite."""

    def round_stats(qf, kf, vf, r, i, j):
        if r == 0:
            return stats(qf, kf, vf, True, 0)
        if j < i:
            return stats(qf, kf, vf, False, 0)
        B, s = qf.shape[0], qf.shape[1]
        return (torch.zeros_like(qf),
                torch.full((B, s), NEG_INF, dtype=torch.float32,
                           device=qf.device),
                torch.zeros((B, s), dtype=torch.float32, device=qf.device))

    return round_stats


def _striped_rounds(stats):
    """Striped causal rounds (``striped_ring_attention`` :155-165): a
    source not after this rank gives the inclusive triangle, one after it
    the strict one (its row 0 sees no key: m = NEG_INF there, which the
    combine weighs by 0)."""

    def round_stats(qf, kf, vf, r, i, j):
        return stats(qf, kf, vf, True, 0 if j <= i else 1)

    return round_stats


def _group_ring(group):
    """(n, i): the ring's size and this rank's position. ``None`` is a ring
    of one; a process set's runtime group is refused."""
    if group is None:
        return 1, 0
    from ..common.context import is_runtime_group

    if is_runtime_group(group):
        raise ValueError(
            "sequence parallelism runs on a process set's `group`, not its "
            "`runtime_group`: that communicator belongs to the background "
            "runtime's cycle thread")
    return dist.get_world_size(group), dist.get_rank(group)


def _shift(tensors, group, step: int):
    """Each tensor to the rank ``step`` places on in the ring, the
    neighbour's from ``step`` places back, in one ``batch_isend_irecv``."""
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


class _RingShift(torch.autograd.Function):
    """K and V to the next rank, from the previous one; the backward sends
    their cotangents the other way (the transpose of ``ppermute``)."""

    @staticmethod
    def forward(ctx, group, kf, vf):
        ctx.group = group
        return tuple(_shift([kf, vf], group, 1))

    @staticmethod
    def backward(ctx, gk, gv):
        return (None, *_shift([gk, gv], ctx.group, -1))


class _Anchor(torch.autograd.Function):
    """The identity on ``out`` that ties the last rotation's K/V into the
    graph with zero cotangents. Autograd runs only the nodes the loss
    reaches, and a rank whose last rounds were skipped uses no rotated
    block: without this it would skip its rotations' backward exchanges
    while its neighbours wait in theirs (JAX's scan transposes every
    ``ppermute`` whatever its cotangent)."""

    @staticmethod
    def forward(ctx, out, kf, vf):
        ctx.kv = [(t.shape, t.dtype, t.device) for t in (kf, vf)]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g, *[torch.zeros(s, dtype=dt, device=dv)
                     for s, dt, dv in ctx.kv])


def _distributed_ring(q, k, v, group, round_stats):
    n, i = _group_ring(group)
    if n == 1:
        outs, _ = _ring_scan([q], [k], [v], [0], 1, None, round_stats)
        return outs[0]

    def rotate(kfs, vfs):
        kf, vf = _RingShift.apply(group, kfs[0], vfs[0])
        return [kf], [vf]

    outs, (kfs, vfs) = _ring_scan([q], [k], [v], [i], n, rotate,
                                  round_stats)
    out = outs[0]
    if torch.is_grad_enabled() and kfs[0].requires_grad:
        out = _Anchor.apply(out, kfs[0], vfs[0])
    return out


def ring_attention(q, k, v, group=None, use_flash=None, block_q: int = 512,
                   block_k: int = 512):
    """Causal ring attention over ``group`` (a ``torch.distributed`` group;
    ``None`` is a ring of one), the sequence block-sharded: rank i holds
    tokens ``[i*s_local, (i+1)*s_local)``. Returns the attention output for
    the local Q block, same shape and dtype as q ``[batch, s_local, heads,
    head_dim]``.

    ``use_flash=None`` takes the flash kernel for any tensor off the CPU,
    which raises ``ValueError`` when the block sizes do not tile the local
    sequence: on the card there is no plain path to give way to. CPU
    tensors, and ``use_flash=False``, take the blockwise plain path.
    """
    stats = _stats_fn(q, use_flash, block_q, block_k)
    return _distributed_ring(q, k, v, group, _blocked_rounds(stats))


def striped_ring_attention(q, k, v, group=None, use_flash=None,
                           block_q: int = 512, block_k: int = 512):
    """Causal ring attention over ``group`` with the STRIPED token layout:
    rank i holds global tokens i, i+n, i+2n, … (``stripe_tokens``), so
    every round is a triangular block of equal work on every rank (Striped
    Attention, arXiv:2311.09431). Outputs stay striped (invert with
    ``unstripe_tokens`` after gathering). Dispatch as ``ring_attention``.
    """
    stats = _stats_fn(q, use_flash, block_q, block_k)
    return _distributed_ring(q, k, v, group, _striped_rounds(stats))


def _roll(kfs, vfs):
    """The simulated ring's rotation: position x takes position x-1's."""
    n = len(kfs)
    return ([kfs[(x - 1) % n] for x in range(n)],
            [vfs[(x - 1) % n] for x in range(n)])


def _simulated_ring(q, k, v, n: int, striped: bool = False, use_flash=None,
                    block_q: int = 512, block_k: int = 512):
    """All ``n`` ranks of a ring in one process: q, k, v ``[b, n*s_local,
    h, d]`` are the ranks' shards laid end to end in rank order (for the
    striped layout, a sequence put through ``stripe_tokens``); returns the
    ranks' outputs laid out the same way. Rank i's rounds are the same
    calls on the same tensors as in a job of ``n`` ranks."""
    stats = _stats_fn(q, use_flash, block_q, block_k)
    rounds = _striped_rounds(stats) if striped else _blocked_rounds(stats)
    shards = [list(x.chunk(n, dim=1)) for x in (q, k, v)]
    outs, _ = _ring_scan(*shards, list(range(n)), n, _roll, rounds)
    return torch.cat(outs, dim=1)


def _stripe_index(S: int, n: int, inverse: bool):
    if S % n:
        raise ValueError(f"sequence length {S} must divide by {n}")
    idx = torch.arange(S)
    if inverse:
        return idx.reshape(n, S // n).T.reshape(-1)
    return idx.reshape(S // n, n).T.reshape(-1)


def stripe_tokens(x, n: int, axis: int = 1):
    """Reorder a GLOBAL sequence so block-sharding over ``n`` ranks gives
    the striped layout: rank i receives global tokens i, i+n, i+2n, …
    (a gather with ``arange(S).reshape(S//n, n).T.ravel()``)."""
    idx = _stripe_index(x.shape[axis], n, inverse=False)
    return torch.index_select(x, axis, idx.to(x.device))


def unstripe_tokens(x, n: int, axis: int = 1):
    """Inverse of ``stripe_tokens``: a gather with the transposed
    reshape."""
    idx = _stripe_index(x.shape[axis], n, inverse=True)
    return torch.index_select(x, axis, idx.to(x.device))


def _a2a(x, split_axis: int, concat_axis: int, group):
    """A tiled all-to-all of ``x`` (``lax.all_to_all(..., tiled=True)``):
    ``split_axis`` cut into n pieces, piece r to rank r, the pieces
    received concatenated along ``concat_axis`` in source-rank order."""
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
    """The tiled all-to-all; its backward is the inverse exchange (the
    axes swapped)."""

    @staticmethod
    def forward(ctx, x, split_axis, concat_axis, group):
        ctx.axes = (split_axis, concat_axis, group)
        return _a2a(x, split_axis, concat_axis, group)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis, group = ctx.axes
        return _a2a(g, concat_axis, split_axis, group), None, None, None


def _simulated_all_to_all(xs, split_axis: int, concat_axis: int):
    """The tiled all-to-all among the ``len(xs)`` ranks of one process."""
    n = len(xs)
    parts = [x.chunk(n, dim=split_axis) for x in xs]  # parts[src][dst]
    return [torch.cat([parts[src][dst] for src in range(n)], dim=concat_axis)
            for dst in range(n)]


def _default_core(q):
    """Ulysses' attention core: the plain causal attention on the CPU, the
    flash kernel (through a ring of one) anywhere else."""
    if q.device.type == "cpu":
        from ..models.transformer import causal_attention

        return causal_attention
    return ring_attention


def _ulysses(qs, ks, vs, n: int, exchange, attn_fn):
    """Ulysses' scaffold (``ulysses_attention`` :190-218) over the blocks
    ``qs``, ``ks``, ``vs`` this process holds; ``exchange(blocks,
    split_axis, concat_axis)`` is the tiled all-to-all."""
    h = qs[0].shape[2]
    if h % n:
        raise ValueError(f"heads ({h}) must divide by sp={n}")
    attn_fn = attn_fn or _default_core(qs[0])

    def scatter_heads(xs):  # [b, s_loc, h, hd] -> [b, s, h/n, hd]
        return exchange(xs, 2, 1)

    def gather_heads(xs):  # [b, s, h/n, hd] -> [b, s_loc, h, hd]
        return exchange(xs, 1, 2)

    outs = [attn_fn(q, k, v) for q, k, v in
            zip(scatter_heads(qs), scatter_heads(ks), scatter_heads(vs))]
    return gather_heads(outs)


def ulysses_attention(q, k, v, group=None, attn_fn=None):
    """Ulysses SP over ``group``: all-to-all seq⇄heads around a full
    attention core ``attn_fn(q, k, v)`` (default: ``causal_attention`` on
    the CPU, the flash kernel on the card). Requires heads % n == 0. Each
    rank computes full-sequence attention for its head shard — good when
    the sequence is long but heads are plentiful; ring attention covers the
    opposite regime."""
    n, _ = _group_ring(group)

    def exchange(xs, split_axis, concat_axis):
        if n == 1:
            return xs
        return [_AllToAll.apply(xs[0], split_axis, concat_axis, group)]

    return _ulysses([q], [k], [v], n, exchange, attn_fn)[0]


def _simulated_ulysses(q, k, v, n: int, attn_fn=None):
    """Ulysses over ``n`` ranks in one process: q, k, v ``[b, n*s_local,
    h, d]`` are the ranks' shards laid end to end; returns their outputs
    laid out the same way."""
    shards = [list(x.chunk(n, dim=1)) for x in (q, k, v)]
    return torch.cat(_ulysses(*shards, n, _simulated_all_to_all, attn_fn),
                     dim=1)
