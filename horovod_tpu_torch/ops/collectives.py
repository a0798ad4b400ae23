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
- ``CastFusedChunkPlan`` and ``QuantFusedChunkPlan`` (:899-1116): a
  chunk on the compressed wire (``HOROVOD_COMPRESSION`` or a
  ``Compression.int8``/``int4`` marker): K2's cast or K3's quantize packs
  this rank's row ``[payload | scales]``, one ``all_gather_into_tensor``
  gathers every rank's row, and one reduce-unpack dequantizes, reduces in
  rank order, scales and writes the outputs (``ops/quant_wire.py``).
  ``fused_chunk_plan(..., quant=spec)`` builds them for more than one
  process, SUM or AVERAGE and a float chunk; their key is the plain key
  with the spec's signature appended. ``quant_sim_chunk_plan`` drives N
  virtual ranks in one process (``execute_simulated``). The JAX package's
  ``_eager_quantized_allreduce`` (:1119-1167) has no counterpart: every
  allreduce of the port goes through the runtime, which owns the wire's
  fallbacks (``ops/queue.py`` ``_quant_split``).
- ``unpack_flat`` (:475): a flat result split back into per-tensor views.
- ``_eager_allgather`` (:1302-1358): a ragged first dimension. The
  first-dimension sizes are exchanged; even sizes take one
  ``all_gather_single`` with no pad; ragged ones pad this rank's rows to
  the largest (K1 packs them into the front of the padded buffer, the
  tail is zeroed), gather, and compact the ``nproc`` row slices
  ``gathered[i*maxn : i*maxn + size_i]`` into the output in one K1 pack.
- ``_eager_alltoall`` (:1465-1512): explicit or even splits, validated as
  in the JAX package; the split matrix is an allgather of the splits, and
  one ``all_to_all_single`` moves the data with its input and output
  split sizes. Returns (output, received splits). The JAX package's
  choice between a per-edge and a dense exchange (``_edge_limit``) is how
  XLA does it, not the contract, and is not ported; the results are the
  same bit for bit.
- ``_eager_reducescatter`` (:1767-1779): an allreduce, then this rank's
  slice, which keeps the JAX result at every size.
- Adasum (``ReduceOp.ADASUM``, :580-597, :660-669): at a world of one the
  prescaled and postscaled identity; otherwise one ``all_gather`` of every
  rank's prescaled row and ``adasum_tree_reduce`` over K4
  (``ops/adasum.py``) on every rank, then the postscale. The factors follow
  K1's rule (a half-precision factor is rounded to the dtype first). The
  runtime groups Adasum tensors into chunks (``AdasumChunkPlan``, cached
  by ``fused_chunk_plan`` under the fused plans' key with the op): one
  K1 pack, one ``all_gather`` and one K4a and one K4b launch a round of
  the tree for the whole chunk, each tensor with its own coefficients.
  The JAX package reduces Adasum tensors one at a time; a tensor's
  result agrees with its per-tensor result within fp32 rounding.
- The two-level data plane (``HOROVOD_HIERARCHICAL_ALLREDUCE``/
  ``_ALLGATHER``, :551-648, :1360-1400) over the global set's
  ``Hierarchy`` (``common/context.py``), where ``allreduce_hierarchy`` and
  ``allgather_hierarchy`` say it applies (the JAX ``_allreduce_hier`` with
  the port's topology for ``mesh_2d``): SUM and AVERAGE as a
  ``reduce_scatter`` within the host of the padded, prescaled flat, an
  ``all_reduce`` across hosts, AVERAGE's division by ``size()`` (the
  contributions) and the postscale, then an ``all_gather`` within the
  host, eager and in the fused chunk plans between K1's pack and unpack
  (the compressed plans stay flat, :846-849); Adasum as Adasum of the
  hosts' means (``adasum.hierarchical_allreduce``, a power-of-two number
  of hosts); the allgather of equal first dimensions as an ``all_gather``
  across hosts, then one within the host, then K1's pack of the rows into
  rank order. The two-level sums add in another order than the flat
  ones: the same within fp32 rounding, and bitwise on every rank.
- The ZeRO-1 shard plans (:1170-1300), for ``opt/sharded.py``:
  ``sharded_pack_plan`` (K1 packs a dtype group's leaves into one flat
  buffer of ``world * shard_elems``, a zero pad after them),
  ``sharded_reduce_scatter_plan`` (one ``reduce_scatter`` in place on
  that buffer, where the JAX plan allreduces and slices: only (n-1)/n of
  it crosses the wire) and ``sharded_allgather_plan`` (one
  ``all_gather`` in place into the same buffer, then K1's unpack into the
  leaves), cached in the fused plans' LRU under keys with the layout's
  digest and counted by ``hvd_sharded_plan_hits_total`` and
  ``_misses_total``. ``sim_reduce`` is the JAX reduce as XLA computes it,
  for a simulated world.

One deliberate departure, which changes no result: at a world of one the
JAX package skips the exchange (the fused plan's pack and unpack,
:749-767, and allgather, alltoall and reducescatter, which return their
input), while here a group of one still goes through the communicator, so
a single-GPU run drives the NCCL calls and K1 launches that a multi-GPU
run makes.

``broadcast_object``, ``allgather_object`` and ``barrier`` are called on
the caller's thread, on the set's caller group; the runtime runs its
collectives on groups of its own, so the two never interleave on one
communicator. ``dist_calls`` counts the calls the runtime's bodies make
into the communicator.
"""

from __future__ import annotations

import collections
import math
from enum import IntEnum
from typing import Optional

import torch
import torch.distributed as dist

from ..common import context as ctx_mod
from ..common import env as env_schema
from ..common.context import ProcessSet
from ..utils import metrics as metrics_mod
from . import adasum
from . import compression as comp
from . import fused_pack, quant_wire
from . import megaplan as megaplan_mod


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


# calls into the communicator made by the runtime's bodies below (the
# runtime reads the difference across each op it dispatches)
dist_calls = 0

# torch names the one-tensor allgather all_gather_single, and the
# one-tensor reduce-scatter reduce_scatter_single, from 2.13 on
_all_gather = (getattr(dist, "all_gather_single", None)
               or dist.all_gather_into_tensor)
_reduce_scatter = (getattr(dist, "reduce_scatter_single", None)
                   or dist.reduce_scatter_tensor)


def _count_call():
    global dist_calls
    dist_calls += 1


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


def allreduce_hierarchy(ps: Optional[ProcessSet], op):
    """The global set's two levels an allreduce of ``op`` on ``ps`` takes,
    on the runtime's groups, or None for the flat path (JAX
    ``_allreduce_hier``, :560-567): ``HOROVOD_HIERARCHICAL_ALLREDUCE``,
    SUM, AVERAGE or ADASUM, a hierarchy (more than one rank a host) and,
    for ADASUM, a power-of-two number of hosts."""
    cfg = ctx_mod._ctx.config
    h = getattr(ps, "runtime_hierarchy", None)
    if (h is None or cfg is None or not cfg.hierarchical_allreduce
            or op not in (ReduceOp.SUM, ReduceOp.AVERAGE, ReduceOp.ADASUM)):
        return None
    if op == ReduceOp.ADASUM and h.cross_size & (h.cross_size - 1):
        return None
    return h


def allgather_hierarchy(ps: Optional[ProcessSet]):
    """The two levels an allgather on ``ps`` takes, or None (JAX
    ``_eager_allgather_fixed``'s verdict, :1360-1364)."""
    cfg = ctx_mod._ctx.config
    h = getattr(ps, "runtime_hierarchy", None)
    if h is None or cfg is None or not cfg.hierarchical_allgather:
        return None
    return h


def hierarchy_verdicts() -> tuple:
    """The two knobs as the runtime reads them: a change invalidates a
    captured megaplan."""
    cfg = ctx_mod._ctx.config
    return (bool(cfg and cfg.hierarchical_allreduce),
            bool(cfg and cfg.hierarchical_allgather))


def _padded_flat(t: torch.Tensor, nl: int) -> torch.Tensor:
    """``t`` flattened into a new buffer padded with zeros to a multiple
    of ``nl`` (JAX pads the same way, :609-613)."""
    n = t.numel()
    flat = torch.empty(n + (-n) % nl, dtype=t.dtype, device=t.device)
    flat[:n].copy_(t.reshape(-1))
    flat[n:].zero_()
    return flat


def _hier_sum(flat: torch.Tensor, hier):
    """SUM of every rank's ``flat`` (padded to a multiple of the host's
    ranks) in place: a ``reduce_scatter`` within the host, an
    ``all_reduce`` of this rank's shard across hosts. Returns the shard, a
    view of ``flat``; ``_hier_gather`` fills the rest."""
    cs = flat.numel() // hier.local_size
    shard = flat[hier.local_rank * cs:(hier.local_rank + 1) * cs]
    _count_call()
    _reduce_scatter(shard, flat, dist.ReduceOp.SUM, group=hier.local_group)
    _count_call()
    dist.all_reduce(shard, dist.ReduceOp.SUM, group=hier.cross_group)
    return shard


def _hier_gather(flat: torch.Tensor, shard: torch.Tensor, hier):
    _count_call()
    _all_gather(flat, shard, group=hier.local_group)


def _k1_scaled(x: torch.Tensor, factor: float) -> torch.Tensor:
    """A contiguous copy of ``x`` times ``factor`` by K1's rule (the
    torch rule for a dtype K1 does not scale)."""
    if factor != 1.0 and not fused_pack.can_scale(x.dtype):
        return (x * factor).contiguous()
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel():
        fused_pack.pack([x.contiguous().view(-1)], out.view(-1), factor)
    return out


def _eager_adasum(x: torch.Tensor, group, pre: float, post: float,
                  hier=None) -> torch.Tensor:
    """Adasum of every rank's ``x`` into a new tensor (JAX
    ``_allreduce_body``'s ADASUM branch, and the single-process identity);
    a factor of 1 costs no pass."""
    nproc = dist.get_world_size(group)
    if x.numel() == 0 or (nproc == 1 and hier is None):
        # Adasum over a single contributor is the identity
        return _k1_scaled(_k1_scaled(x, pre), post)
    buf = _k1_scaled(x, pre) if pre != 1.0 else x.contiguous()
    if hier is not None:
        red = adasum.hierarchical_allreduce(buf.view(-1), hier, _count_call)
    else:
        rows = torch.empty((nproc, buf.numel()), dtype=buf.dtype,
                           device=buf.device)
        _count_call()
        _all_gather(rows.view(-1), buf.view(-1), group=group)
        red = adasum.adasum_tree_reduce_(rows)
    red = red.view(x.shape)
    return red if post == 1.0 else _k1_scaled(red, post)


def _eager_allreduce(x: torch.Tensor, op, group, prescale_factor: float,
                     postscale_factor: float, hier=None) -> torch.Tensor:
    """Allreduce one tensor into a new one. Scaling follows PyTorch's type
    promotion, as JAX's weak typing does for a Python float: an integer
    tensor with a factor other than 1 comes back as float32. ``hier`` (a
    ``Hierarchy``, ``allreduce_hierarchy``) takes the two-level path."""
    op = ReduceOp(op)
    if op == ReduceOp.ADASUM:
        return _eager_adasum(x, group, prescale_factor, postscale_factor,
                             hier)
    buf = x * prescale_factor if prescale_factor != 1.0 else x.clone()
    if x.numel() == 0:
        # zero-element reduction: no call, still scaled
        return _scaled(buf, postscale_factor)
    buf = buf.contiguous()
    if hier is not None:  # SUM or AVERAGE (allreduce_hierarchy)
        flat = _padded_flat(buf, hier.local_size)
        shard = _hier_sum(flat, hier)
        if op == ReduceOp.AVERAGE:
            shard.div_(hier.size)  # the contributions, one a rank
        if postscale_factor != 1.0:
            shard.mul_(postscale_factor)
        _hier_gather(flat, shard, hier)
        return flat[:buf.numel()].view(buf.shape)
    _count_call()
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
    _count_call()
    dist.broadcast(flat, src, group=group)
    if flat is not out:
        out.copy_(flat)
    return out


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host. A device tensor is copied on the current stream
    (the runtime's comm stream), and only that stream is waited on."""
    if t.device.type != "cuda":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))
    done.synchronize()
    return host


def _exchange_ints(values: list, group, device) -> list:
    """Every rank's ``values`` (one int64 vector each, all of one length),
    as ``nproc`` lists, by one allgather on ``group``."""
    nproc = dist.get_world_size(group)
    mine = torch.tensor(values, dtype=torch.int64)
    if device.type == "cuda":
        mine = mine.pin_memory().to(device, non_blocking=True)
    every = torch.empty(nproc * len(values), dtype=torch.int64,
                        device=device)
    _count_call()
    _all_gather(every, mine, group=group)
    flat = _to_host(every).tolist()
    return [flat[i * len(values):(i + 1) * len(values)]
            for i in range(nproc)]


def _rows(x: torch.Tensor, op: str):
    if x.dim() == 0:
        raise ValueError(f"{op} needs a tensor with a first dimension")
    return int(x.shape[0]), tuple(int(n) for n in x.shape[1:])


def allgather_sizes(x: torch.Tensor, group) -> list:
    """Every rank's first-dimension size, in rank order."""
    n, _ = _rows(x, "allgather")
    return [v[0] for v in _exchange_ints([n], group, x.device)]


def compact_rows(gathered: torch.Tensor, sizes, maxn: int, row: int,
                 out: torch.Tensor):
    """K1's pack of the row slices ``gathered[i*maxn : i*maxn + size_i]``
    (in elements of ``row`` each) into ``out``, back to back; slices of no
    rows are left out of the table."""
    flat = gathered.view(-1)
    parts = [flat[i * maxn * row:(i * maxn + s) * row]
             for i, s in enumerate(sizes) if s]
    fused_pack.pack(parts, out.view(-1))


def _hier_allgather(xf: torch.Tensor, hier, out: torch.Tensor):
    """The two-level allgather of equal rows (JAX :1360-1400): this rank's
    row gathered across hosts, those rows gathered within the host (every
    rank then holds every row, host-major), and K1's pack of the rows into
    rank order ``cross_rank * local_size + local_rank``."""
    nl, nx, m = hier.local_size, hier.cross_size, xf.numel()
    across = torch.empty(nx * m, dtype=xf.dtype, device=xf.device)
    _count_call()
    _all_gather(across, xf, group=hier.cross_group)
    both = torch.empty(nl * nx * m, dtype=xf.dtype, device=xf.device)
    _count_call()
    _all_gather(both, across, group=hier.local_group)
    # both[l][c] is rank c * nl + l's row
    fused_pack.pack([both[(l * nx + c) * m:(l * nx + c + 1) * m]
                     for c in range(nx) for l in range(nl)], out.view(-1))


def _eager_allgather(x: torch.Tensor, group, sizes=None,
                     hier=None) -> torch.Tensor:
    """Allgather ``x`` along its first dimension, which may differ across
    ranks; ``sizes`` are the ranks' first dimensions when already
    exchanged (``allgather_sizes``). ``hier`` (``allgather_hierarchy``)
    takes the two-level path when every rank's first dimension is the
    same; a ragged allgather stays flat."""
    n, rest = _rows(x, "allgather")
    if sizes is None:
        sizes = allgather_sizes(x, group)
    nproc, maxn, row = len(sizes), max(sizes), math.prod(rest)
    out = torch.empty((sum(sizes),) + rest, dtype=x.dtype, device=x.device)
    if maxn == 0 or row == 0:
        return out  # no element moves
    xf = x.contiguous().view(-1)
    if min(sizes) == maxn and hier is not None:
        _hier_allgather(xf, hier, out)
        return out
    if min(sizes) == maxn:
        _count_call()
        _all_gather(out.view(-1), xf, group=group)
        return out
    if n < maxn:
        pad = torch.empty(maxn * row, dtype=x.dtype, device=x.device)
        if n:
            fused_pack.pack([xf], pad)
        pad[n * row:].zero_()
        xf = pad
    gathered = torch.empty(nproc * maxn * row, dtype=x.dtype,
                           device=x.device)
    _count_call()
    _all_gather(gathered, xf, group=group)
    compact_rows(gathered, sizes, maxn, row, out)
    return out


def alltoall_split_matrix(x: torch.Tensor, splits, group) -> tuple:
    """Validate ``splits`` as the JAX package does (None asks for an even
    split of the first dimension) and exchange them: returns this rank's
    splits and the ``nproc x nproc`` split matrix (row = sender)."""
    n, _ = _rows(x, "alltoall")
    nproc = dist.get_world_size(group)
    if splits is None:
        if n % max(nproc, 1):
            raise ValueError(
                "tensor not evenly divisible; pass explicit splits")
        splits = [n // nproc] * nproc
    s = torch.as_tensor(splits).to(torch.int64)
    if tuple(s.shape) != (nproc,):
        raise ValueError(f"splits must have length {nproc}")
    if int(s.sum()) != n:
        raise ValueError("splits must sum to the first dimension")
    splits = s.tolist()
    return splits, _exchange_ints(splits, group, x.device)


def _eager_alltoall(x: torch.Tensor, splits, group, mat=None) -> tuple:
    """Send ``splits[j]`` rows of ``x`` to rank j; returns the rows
    received, in rank order, and the received splits (a CPU int32 tensor,
    as the reference's and the JAX package's)."""
    if mat is None:
        splits, mat = alltoall_split_matrix(x, splits, group)
    me = dist.get_rank(group)
    recv = [row[me] for row in mat]
    _, rest = _rows(x, "alltoall")
    out = torch.empty((sum(recv),) + rest, dtype=x.dtype, device=x.device)
    recv_t = torch.tensor(recv, dtype=torch.int32)
    if max(max(r) for r in mat) == 0 or math.prod(rest) == 0:
        return out, recv_t  # all splits zero: nothing moves
    _count_call()
    dist.all_to_all_single(out, x.contiguous(), output_split_sizes=recv,
                           input_split_sizes=splits, group=group)
    return out, recv_t


def _eager_reducescatter(x: torch.Tensor, op, group) -> torch.Tensor:
    """Reduce across the group, keep this rank's equal share of the first
    dimension."""
    nproc = dist.get_world_size(group)
    if x.dim() == 0 or x.shape[0] % nproc:
        raise ValueError(
            "first dim must be divisible by the number of processes")
    red = _eager_allreduce(x, op, group, 1.0, 1.0)
    if nproc == 1:
        return red
    chunk = int(x.shape[0]) // nproc
    me = dist.get_rank(group)
    return red[me * chunk:(me + 1) * chunk].clone()


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
    the factors the pack and the unpack apply. With ``hier`` (a
    ``Hierarchy``) the collective is the two-level one: K1 packs the chunk
    into a flat padded to a multiple of the host's ranks, ``_hier_sum``
    and ``_hier_gather`` reduce it, and K1's unpack applies the postscale
    and AVERAGE's 1/n."""

    __slots__ = ("group", "nproc", "dist_op", "pre", "unpack_factor",
                 "sizes", "shapes", "dtype", "total", "hier")

    def __init__(self, group, nproc: int, op, pre: float, post: float,
                 sizes: tuple, shapes: tuple, dtype: torch.dtype,
                 hier=None):
        self.group = group
        self.nproc = nproc
        self.pre = pre
        self.sizes = sizes
        self.shapes = shapes
        self.dtype = dtype
        self.total = sum(sizes)
        self.hier = hier
        if hier is not None:
            # two levels of sums: the 1/n rides the unpack
            self.dist_op = dist.ReduceOp.SUM
            self.unpack_factor = (post / nproc if op == ReduceOp.AVERAGE
                                  else post)
        elif op == ReduceOp.AVERAGE and _has_avg(group):
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
        if self.hier is not None:
            return self._execute_hier(inputs, outputs, fusion_buffer)
        if len(inputs) == 1:
            x, out = inputs[0].view(-1), outputs[0].view(-1)
            if self.pre != 1.0 or out.data_ptr() != x.data_ptr():
                fused_pack.pack([x], out, self.pre)
            _count_call()
            dist.all_reduce(out, self.dist_op, group=self.group)
            if self.unpack_factor != 1.0:
                fused_pack.unpack(out, [out], self.unpack_factor)
            return
        flat = fusion_buffer.lease(self.dtype, self.total)
        fused_pack.pack(inputs, flat, self.pre)
        _count_call()
        dist.all_reduce(flat, self.dist_op, group=self.group)
        fused_pack.unpack(flat, outputs, self.unpack_factor)

    def _execute_hier(self, inputs: list, outputs: list, fusion_buffer):
        nl = self.hier.local_size
        padded = self.total + (-self.total) % nl
        nbytes = padded * torch.empty((), dtype=self.dtype).element_size()
        if nbytes <= fusion_buffer.capacity:
            flat = fusion_buffer.lease(self.dtype, padded)
        else:  # one tensor larger than the buffer is a chunk alone
            flat = torch.empty(padded, dtype=self.dtype,
                               device=inputs[0].device)
        fused_pack.pack(inputs, flat, self.pre)
        if padded > self.total:
            flat[self.total:].zero_()
        shard = _hier_sum(flat, self.hier)
        _hier_gather(flat, shard, self.hier)
        fused_pack.unpack(flat, outputs, self.unpack_factor)


class AdasumChunkPlan:
    """One chunk of Adasum allreduces of one dtype, factors and set
    (the reference fuses Adasum tensors into one buffer and keeps each
    tensor's own coefficients, ``adasum.h:101``, ``:124``). Flat: K1 packs
    the prescaled tensors into this rank's row, one ``all_gather`` fills
    the ``[nproc, total]`` rows, the tree's rounds run on them (one K4a and
    one K4b launch a round over every (pair, tensor) item, into the left
    row, ``adasum.tree_items``), and K1 unpacks row 0 with the postscale.
    With ``hier`` (a ``Hierarchy``, a power-of-two number of hosts) the
    two-level path over the same packed chunk
    (``adasum.hierarchical_allreduce``: one reduce-scatter over the host,
    a ``batch_isend_irecv`` pair, K4a, one allreduce of an fp32[tensors,
    3] and K4b a cross round, one allgather over the host). Each tensor's
    result is the per-tensor Adasum within fp32 rounding (a tensor sits
    at another alignment in the packed row than alone), bitwise the same
    on every rank."""

    __slots__ = ("group", "nproc", "pre", "post", "sizes", "dtype", "total",
                 "hier", "rounds", "items", "padded")

    def __init__(self, group, nproc: int, pre: float, post: float,
                 sizes: tuple, dtype: torch.dtype, hier=None):
        self.group = group
        self.nproc = nproc
        self.pre = pre
        self.post = post
        self.sizes = sizes
        self.dtype = dtype
        self.total = sum(sizes)
        self.hier = hier
        self.rounds = self.items = None
        if hier is None:
            self.padded = self.total
            self.rounds = adasum.tree_items(nproc, sizes)
        else:
            nl = hier.local_size
            self.padded = self.total + (-self.total) % nl
            cs = self.padded // nl
            self.items = adasum.slice_items(sizes, hier.local_rank * cs,
                                            (hier.local_rank + 1) * cs)

    def _flat(self, fusion_buffer, device) -> torch.Tensor:
        nbytes = self.padded * torch.empty((), dtype=self.dtype
                                           ).element_size()
        if fusion_buffer is not None and nbytes <= fusion_buffer.capacity:
            return fusion_buffer.lease(self.dtype, self.padded)
        return torch.empty(self.padded, dtype=self.dtype, device=device)

    def execute(self, inputs: list, outputs: list, fusion_buffer=None):
        """Reduce ``inputs`` into ``outputs`` (which may be the inputs
        themselves) on PyTorch's current stream."""
        flat = self._flat(fusion_buffer, inputs[0].device)
        fused_pack.pack(inputs, flat, self.pre)
        if self.hier is not None:
            if self.padded > self.total:
                flat[self.total:].zero_()
            red = adasum.hierarchical_allreduce(flat, self.hier, _count_call,
                                                self.sizes, self.items)
        else:
            rows = torch.empty((self.nproc, self.total), dtype=self.dtype,
                               device=flat.device)
            _count_call()
            _all_gather(rows.view(-1), flat, group=self.group)
            red = adasum.adasum_tree_reduce_(rows, rounds=self.rounds)
        fused_pack.unpack(red, outputs, self.post)


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
    """Drop every cached plan (chunk boundaries moved); returns how many.
    A captured megaplan holds the dropped plans, so it goes the same way
    (``horovod_tpu/ops/collectives.py:466-471``)."""
    n = len(_PLANS)
    _PLANS.clear()
    if n:
        from ..utils import flightrec

        flightrec.note("plan_cache_invalidated", count=n)
    megaplan_mod.invalidate_megaplan("plan_cache")
    return n


def _insert_plan(key: tuple, build, counters=_plan_metrics):
    """The cached plan of ``key``, built by ``build`` on a miss; a hit or
    a miss counts on ``counters()``."""
    hits, misses = counters()
    plan = _PLANS.get(key)
    if plan is not None:
        _PLANS.move_to_end(key)
        hits.inc()
        return plan
    misses.inc()
    plan = _PLANS[key] = build()
    while len(_PLANS) > _PLAN_CAPACITY:
        _PLANS.popitem(last=False)
    return plan


def fused_chunk_plan(ps: ProcessSet, group, op, prescale_factor: float,
                     postscale_factor: float, names, sizes, shapes,
                     dtype: torch.dtype, device_type: str, quant=None):
    """The cached plan of one chunk, keyed by the full chunk signature —
    ordered names, shapes, dtype, op, factors, set and its size, the
    elastic generation, the device type and the hierarchical verdict
    (``allreduce_hierarchy``). None for a chunk of no elements, which the
    runtime reduces tensor by tensor.

    ``quant`` (a ``compression.QuantSpec``) asks for the compressed wire,
    which exists for more than one process, SUM or AVERAGE and a float
    chunk; the spec's signature is then appended to the key, so the plain
    key stays as it was. Otherwise the plain plan is returned (the caller
    counts the fallback)."""
    sizes = tuple(int(s) for s in sizes)
    if sum(sizes) == 0:
        return None
    nproc = ps.size
    op = ReduceOp(op)
    wire = (quant is not None and nproc > 1
            and op in (ReduceOp.SUM, ReduceOp.AVERAGE)
            and dtype in quant_wire.DTYPES)
    # the compressed plans stay flat (JAX :846-849)
    hier = None if wire else allreduce_hierarchy(ps, op)
    key = ("fused_plan", "allreduce", ps.name, nproc, _plan_epoch(),
           tuple(names), tuple(shapes), str(dtype), int(op),
           float(prescale_factor), float(postscale_factor), device_type,
           hier is not None)
    if op == ReduceOp.ADASUM:
        return _insert_plan(key, lambda: AdasumChunkPlan(
            group, nproc, float(prescale_factor), float(postscale_factor),
            sizes, dtype, hier))
    if wire:
        key = key + (quant.signature(),)
        return _insert_plan(key, lambda: _wire_plan(
            group, nproc, op, prescale_factor, postscale_factor, sizes,
            shapes, dtype, quant))
    return _insert_plan(key, lambda: FusedChunkPlan(
        group, nproc, op, float(prescale_factor), float(postscale_factor),
        sizes, tuple(shapes), dtype, hier))


# ===========================================================================
# The compressed wire: the bf16 cast plan and the blockwise int8/int4 plan
# ===========================================================================


class _WireChunkPlan:
    """One compressed chunk: this rank's row ``[payload | scales]`` packed
    by ``_pack``, the rows of every rank gathered by one collective, and
    one reduce-unpack into the outputs. ``group`` None is a simulated
    world (``quant_sim_chunk_plan``)."""

    __slots__ = ("group", "nproc", "average", "pre", "post", "sizes",
                 "shapes", "dtype", "spec", "flat_size", "padded",
                 "n_blocks", "row_bytes", "wire_bytes", "pre_bytes")

    def __init__(self, group, nproc: int, op, pre: float, post: float,
                 sizes: tuple, shapes: tuple, dtype: torch.dtype,
                 spec: comp.QuantSpec):
        self.group = group
        self.nproc = nproc
        self.average = op == ReduceOp.AVERAGE
        self.pre = float(pre)
        self.post = float(post)
        self.sizes = sizes
        self.shapes = tuple(shapes)
        self.dtype = dtype
        self.spec = spec
        self.flat_size = sum(sizes)
        if spec.bits == 16:
            self.padded, self.n_blocks = self.flat_size, 0
        else:
            self.padded, self.n_blocks, _, _ = comp.quant_wire_layout(
                self.flat_size, spec)
        self.row_bytes = quant_wire.row_bytes(self.flat_size, spec)
        # the bytes one rank puts on the wire, and the chunk's own
        self.wire_bytes = self.row_bytes
        self.pre_bytes = self.flat_size * torch.empty(
            (), dtype=dtype).element_size()

    def _pack(self, inputs, row, residual):
        raise NotImplementedError

    def _reduce(self, gathered, outputs):
        quant_wire.reduce_unpack(gathered, outputs, self.spec, self.nproc,
                                 self.average, self.post)

    def _execute(self, inputs: list, outputs: list, residual=None):
        """Reduce ``inputs`` into ``outputs`` (which may be the inputs) on
        PyTorch's current stream; returns the new residual or None."""
        dev = inputs[0].device
        row = torch.empty(self.row_bytes, dtype=torch.uint8, device=dev)
        new_res = self._pack(inputs, row, residual)
        gathered = torch.empty(self.nproc * self.row_bytes,
                               dtype=torch.uint8, device=dev)
        _count_call()
        _all_gather(gathered, row, group=self.group)
        self._reduce(gathered, outputs)
        return new_res

    def _simulate(self, rank_inputs, residuals=None, outputs=None):
        """One process stands in for ``len(rank_inputs)`` ranks: each
        virtual rank packs its row of a stacked buffer in place of the
        gather, and one reduce-unpack follows."""
        dev = rank_inputs[0][0].device
        gathered = torch.empty(self.nproc * self.row_bytes,
                               dtype=torch.uint8, device=dev)
        new_rs = []
        for r, inputs in enumerate(rank_inputs):
            row = gathered[r * self.row_bytes:(r + 1) * self.row_bytes]
            new_rs.append(self._pack(
                inputs, row, None if residuals is None else residuals[r]))
        if outputs is None:
            outputs = [torch.empty(s, dtype=self.dtype, device=dev)
                       for s in self.shapes]
        self._reduce(gathered, outputs)
        return outputs, new_rs


class CastFusedChunkPlan(_WireChunkPlan):
    """The bf16 cast wire (``HOROVOD_COMPRESSION=bf16``): K2's cast pack,
    no scales and no residual."""

    __slots__ = ()

    def _pack(self, inputs, row, residual):
        quant_wire.cast_pack(inputs, row, self.pre)
        return None

    def execute(self, inputs: list, outputs: list):
        self._execute(inputs, outputs)

    def execute_simulated(self, rank_inputs, outputs=None) -> list:
        return self._simulate(rank_inputs, outputs=outputs)[0]


class QuantFusedChunkPlan(_WireChunkPlan):
    """The blockwise int8/int4 wire: K3's quantize pack, with the
    error-feedback residual in and out. The caller owns the residual:
    it passes the last one in (one fp32 tensor or None a tensor, a flat
    one of the chunk, or None for zeros) and commits the returned one
    (flat, in chunk order) only after ``execute`` returned."""

    __slots__ = ()

    def _pack(self, inputs, row, residual):
        new_res = None
        if self.spec.error_feedback:
            new_res = torch.empty(self.flat_size, dtype=torch.float32,
                                  device=row.device)
        quant_wire.quantize_pack(inputs, row, self.spec, self.pre, residual,
                                 new_res)
        return new_res

    def execute(self, inputs: list, outputs: list, residual=None):
        """Returns the new residual (None without error feedback)."""
        return self._execute(inputs, outputs, residual)

    def execute_simulated(self, rank_inputs, residuals=None,
                          outputs=None) -> tuple:
        """Returns (outputs, the ranks' new residuals)."""
        return self._simulate(rank_inputs, residuals, outputs)


def _wire_plan(group, nproc, op, pre, post, sizes, shapes, dtype, spec):
    cls = CastFusedChunkPlan if spec.bits == 16 else QuantFusedChunkPlan
    return cls(group, nproc, op, pre, post, tuple(sizes), tuple(shapes),
               dtype, spec)


def quant_sim_chunk_plan(world: int, op, prescale_factor: float,
                         postscale_factor: float, names, sizes, shapes,
                         dtype: torch.dtype, quant):
    """The compressed plan of a simulated world of ``world`` ranks, cached
    under the JAX package's key: the CPU tests and the card's compression
    check drive it through ``execute_simulated``."""
    sizes = tuple(int(s) for s in sizes)
    if sum(sizes) == 0:
        return None
    op = ReduceOp(op)
    key = ("fused_plan", "allreduce", "quant_sim", int(world),
           _plan_epoch(), tuple(names), tuple(shapes), str(dtype), int(op),
           float(prescale_factor), float(postscale_factor), True, False,
           quant.signature())
    return _insert_plan(key, lambda: _wire_plan(
        None, int(world), op, prescale_factor, postscale_factor, sizes,
        shapes, dtype, quant))


# ===========================================================================
# Sharded-update plans (ZeRO-1, opt/sharded.py): pack → reduce-scatter →
# sharded step → allgather → unpack
# ===========================================================================
#
# One plan of each kind per dtype group, in the fused plans' LRU (so
# invalidate_fused_plans() and the capacity drop them alike) under keys
# that hold the set, its size, the elastic generation and the layout's
# digest: a rebuilt layout misses onto fresh plans. ``ps=None`` is the
# simulated world (one process driving N virtual ranks). The flat buffer of
# a group is ``world * shard_elems`` long, its leaves back to back and a
# zero pad after them: the reduce-scatter runs in place, leaving this
# rank's reduced shard at its place in the flat, and the allgather lands
# in the same flat, so a step holds one padded buffer a group.

_sharded_metric_handles = None


def _sharded_metrics():
    """(hits, misses) of the sharded plans, resolved at their first
    lookup, so a job that never shards registers no series."""
    global _sharded_metric_handles
    if _sharded_metric_handles is None:
        reg = metrics_mod.get_registry()
        _sharded_metric_handles = (
            reg.counter("hvd_sharded_plan_hits_total",
                        "sharded-update plan cache hits"),
            reg.counter("hvd_sharded_plan_misses_total",
                        "sharded-update plans built (cache misses)"))
    return _sharded_metric_handles


def _sharded_ps_name(ps: Optional[ProcessSet]) -> str:
    return "simulated" if ps is None else ps.name


def _as_flat_input(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    t = t.detach()
    return (t if t.dtype == dtype else t.to(dtype)).contiguous()


def _f32(v: float) -> float:
    return float(torch.tensor(v, dtype=torch.float32))


def sim_reduce(rows, op, prescale_factor: float = 1.0,
               postscale_factor: float = 1.0) -> torch.Tensor:
    """The JAX package's ``_allreduce_body`` (:570-597) over ``rows``, one
    tensor a rank in rank order, as XLA computes it for fp32: ``rows[0] *
    pre``, then each later row added in one FMA, ``row * pre + acc`` (XLA
    contracts the prescale into the sum); then AVERAGE times
    ``fp32(fp32(1/n) * fp32(post))`` and SUM times ``post``. The FMA is
    taken in fp64, exact for the product. Other float dtypes are computed
    in fp32 and rounded once at the end."""
    op = ReduceOp(op)
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError(f"the simulated reduce runs SUM and AVERAGE, not "
                         f"{op!r}")
    dtype = rows[0].dtype
    work = torch.float64 if dtype == torch.float64 else torch.float32
    pre = float(prescale_factor)
    acc = rows[0].to(work) * pre if pre != 1.0 else rows[0].to(work)
    for row in rows[1:]:
        if pre == 1.0:
            acc = acc + row.to(work)
        elif work == torch.float32:
            acc = (row.double() * _f32(pre) + acc.double()).float()
        else:
            acc = acc + row * pre
    if op == ReduceOp.AVERAGE:
        n = len(rows)
        acc = acc * (_f32(_f32(1.0 / n) * _f32(postscale_factor))
                     if work == torch.float32
                     else postscale_factor / n)
    elif postscale_factor != 1.0:
        acc = acc * float(postscale_factor)
    return acc if acc.dtype == dtype else acc.to(dtype)


class ShardedPackPlan:
    """A group's leaves into its padded flat buffer, and this rank's shard
    of them (JAX ``sharded_pack_plan``, :1220-1242), in K1's pack."""

    __slots__ = ("sizes", "dtype", "shard_elems", "total", "padded",
                 "offsets")

    def __init__(self, world: int, sizes: tuple, dtype: torch.dtype,
                 shard_elems: int):
        self.sizes = sizes
        self.dtype = dtype
        self.shard_elems = shard_elems
        self.total = sum(sizes)
        self.padded = world * shard_elems
        self.offsets = [sum(sizes[:i]) for i in range(len(sizes))]

    def execute(self, leaves, flat: Optional[torch.Tensor] = None,
                factor: float = 1.0) -> torch.Tensor:
        """``flat[world * shard_elems]``: the leaves, cast to the group's
        dtype, back to back, each times ``factor``, then zeros."""
        if flat is None:
            flat = torch.empty(self.padded, dtype=self.dtype,
                               device=leaves[0].device)
        fused_pack.pack([_as_flat_input(t, self.dtype) for t in leaves],
                        flat, factor)
        if self.padded > self.total:
            flat[self.total:].zero_()
        return flat

    def pack_shard(self, leaves, rank: int, out: torch.Tensor):
        """Write elements ``[rank * shard_elems, (rank + 1) *
        shard_elems)`` of the leaves' concatenation into ``out``, zeros
        past their end: one K1 pack over the slices of the leaves that the
        shard covers."""
        lo = rank * self.shard_elems
        hi = lo + self.shard_elems
        parts = []
        for t, off, n in zip(leaves, self.offsets, self.sizes):
            a, b = max(lo, off), min(hi, off + n)
            if a < b:
                parts.append(_as_flat_input(t, self.dtype).view(-1)
                             [a - off:b - off])
        fused_pack.pack(parts, out)
        used = sum(p.numel() for p in parts)
        if used < self.shard_elems:
            out[used:].zero_()
        return out


class ShardedReduceScatterPlan:
    """A group's flat buffer reduced across the set, this rank's shard kept
    (JAX ``sharded_reduce_scatter_plan``, :1245-1270, which reduces and
    slices): one ``reduce_scatter`` in place, so only (n-1)/n of the
    buffer crosses the wire. AVERAGE and the postscale follow
    ``FusedChunkPlan``: the backend's AVG where it has one, else SUM and
    one factor ``post / n`` applied by K1 to the shard in place; the
    prescale rides the pack (``pack_factor``). A simulated plan (``group``
    None) reduces the ranks' flats by ``sim_reduce``, which applies both
    factors, so its pack runs at 1."""

    __slots__ = ("group", "rank", "op", "shard_elems", "pre", "post",
                 "dist_op", "pack_factor", "unpack_factor")

    def __init__(self, group, world: int, rank: int, op, shard_elems: int,
                 pre: float, post: float):
        self.group = group
        self.rank = rank
        self.op = ReduceOp(op)
        self.shard_elems = shard_elems
        self.pre = pre
        self.post = post
        self.dist_op = dist.ReduceOp.SUM
        self.pack_factor, self.unpack_factor = 1.0, 1.0
        if group is None:
            return
        self.pack_factor = pre
        if self.op == ReduceOp.AVERAGE and _has_avg(group):
            self.dist_op, self.unpack_factor = dist.ReduceOp.AVG, post
        elif self.op == ReduceOp.AVERAGE:
            self.unpack_factor = post / world
        else:
            self.unpack_factor = post

    def execute(self, flat: torch.Tensor) -> torch.Tensor:
        """Reduce-scatter ``flat`` (packed at ``pack_factor``) in place;
        returns this rank's reduced shard, a view of ``flat``."""
        lo = self.rank * self.shard_elems
        shard = flat[lo:lo + self.shard_elems]
        _count_call()
        _reduce_scatter(shard, flat, self.dist_op, group=self.group)
        if self.unpack_factor != 1.0:
            fused_pack.unpack(shard, [shard], self.unpack_factor)
        return shard

    def simulate(self, flats) -> torch.Tensor:
        """This rank's reduced shard of every simulated rank's flat."""
        lo = self.rank * self.shard_elems
        return sim_reduce([f[lo:lo + self.shard_elems] for f in flats],
                          self.op, self.pre, self.post)


class ShardedAllgatherPlan:
    """The updated shards back into the full leaves (JAX
    ``sharded_allgather_plan``, :1273-1300): K1 packs this rank's shard
    into its place in the flat, one ``all_gather`` in place fills the
    other ranks' places, and K1 unpacks the flat into the leaves."""

    __slots__ = ("group", "dtype", "shard_elems", "padded")

    def __init__(self, group, world: int, dtype: torch.dtype,
                 shard_elems: int):
        self.group = group
        self.dtype = dtype
        self.shard_elems = shard_elems
        self.padded = world * shard_elems

    def execute(self, flat: torch.Tensor, rank: int, shard: torch.Tensor,
                outputs):
        """``flat`` is the group's buffer (the reduce-scatter's), reused;
        ``outputs`` the leaves, written in place."""
        lo = rank * self.shard_elems
        mine = flat[lo:lo + self.shard_elems]
        fused_pack.pack([shard.detach()], mine)
        _count_call()
        _all_gather(flat, mine, group=self.group)
        fused_pack.unpack(flat, [o.detach() for o in outputs])

    def simulate(self, shards, outputs):
        """Every simulated rank's shard, in rank order, packed by K1 into
        one flat (the gather), then unpacked into ``outputs``."""
        flat = torch.empty(self.padded, dtype=self.dtype,
                           device=shards[0].device)
        fused_pack.pack([s.detach() for s in shards], flat)
        fused_pack.unpack(flat, [o.detach() for o in outputs])


def _dims(sizes, shapes) -> tuple:
    return (tuple(int(s) for s in sizes),
            tuple(tuple(int(d) for d in s) for s in shapes))


def sharded_pack_plan(ps: Optional[ProcessSet], world: int, sizes, shapes,
                      dtype: torch.dtype, shard_elems: int, digest: str):
    """The cached pack plan of one dtype group (``ps`` None: simulated)."""
    sizes, shapes = _dims(sizes, shapes)
    key = ("fused_plan", "sharded_pack", _sharded_ps_name(ps), int(world),
           _plan_epoch(), sizes, shapes, str(dtype), int(shard_elems),
           digest)
    return _insert_plan(key, lambda: ShardedPackPlan(
        int(world), sizes, dtype, int(shard_elems)), _sharded_metrics)


def sharded_reduce_scatter_plan(ps: Optional[ProcessSet], world: int,
                                rank: int, op, shard_elems: int,
                                dtype: torch.dtype, digest: str,
                                prescale_factor: float = 1.0,
                                postscale_factor: float = 1.0):
    """The cached reduce-scatter plan of one dtype group and rank."""
    key = ("fused_plan", "sharded_rs", _sharded_ps_name(ps), int(world),
           _plan_epoch(), int(rank), int(op), int(shard_elems), str(dtype),
           float(prescale_factor), float(postscale_factor), digest)
    return _insert_plan(key, lambda: ShardedReduceScatterPlan(
        None if ps is None else ps.group, int(world), int(rank), op,
        int(shard_elems), float(prescale_factor),
        float(postscale_factor)), _sharded_metrics)


def sharded_allgather_plan(ps: Optional[ProcessSet], world: int, sizes,
                           shapes, dtype: torch.dtype, shard_elems: int,
                           digest: str):
    """The cached allgather-and-unpack plan of one dtype group."""
    sizes, shapes = _dims(sizes, shapes)
    key = ("fused_plan", "sharded_ag", _sharded_ps_name(ps), int(world),
           _plan_epoch(), sizes, shapes, str(dtype), int(shard_elems),
           digest)
    return _insert_plan(key, lambda: ShardedAllgatherPlan(
        None if ps is None else ps.group, int(world), dtype,
        int(shard_elems)), _sharded_metrics)


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


def allgather_object(obj, process_set=None) -> list:
    """Every rank's pickled ``obj``, in rank order (JAX
    ``allgather_object`` :2065-2080)."""
    ps = _ps(process_set)
    out = [None] * ps.size
    dist.all_gather_object(out, obj, group=ps.group)
    return out


def barrier(process_set: Optional[ProcessSet] = None):
    dist.barrier(group=_ps(process_set).group)
