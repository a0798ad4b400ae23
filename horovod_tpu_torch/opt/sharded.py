"""ZeRO-1 sharded weight update — counterpart of
``horovod_tpu/opt/sharded.py``: reduce-scatter, a sharded optimizer step,
allgather.

The replicated update (allreduce every gradient, every rank repeats the
whole optimizer step) moves 2(n-1)/n of the gradients' bytes a rank and
keeps n copies of the optimizer state. Here the allreduce is split around
the update:

1. **reduce-scatter** each dtype group's fused gradients: every rank
   receives its contiguous 1/n of the reduced buffer, (n-1)/n of it on
   the wire, half the replicated path's gradient bytes;
2. **the optimizer's step on the owned shard only**: its state (momentum,
   Adam's moments) exists for 1/n of the elements a rank;
3. **allgather** the updated parameter shards back into the full
   parameters.

The layout (:func:`plan_shard_layout`) is the JAX package's, decision for
decision and digest for digest: the shardable leaves grouped by dtype in
leaf order, each group flattened into one buffer padded to a multiple of
the world and cut into contiguous shards; leaves under the replicate
threshold (``HOROVOD_SHARDED_MIN_ELEMS``, ``parallel/sharding_policy.py``)
stay on the allreduce path. The digest is in every shard plan's key
(``ops/collectives.py`` ``sharded_*_plan``), so a rebuilt layout misses
onto fresh plans.

:class:`ShardedUpdateEngine` is the eager per-process engine. Where the
JAX engine wraps an optax transformation, this one wraps a torch optimizer
built over the **combined parameters**: the replicated leaves, plus one
persistent flat shard tensor a dtype group, so the optimizer's state
exists for this rank's shard only::

    engine = ShardedUpdateEngine(
        lambda params: torch.optim.SGD(params, lr=1e-3, momentum=0.9),
        process_set=hvd.global_process_set())
    engine.init(params)
    ...
    loss.backward()
    engine.step(params)          # reads and releases each p.grad

A step packs each group's gradients into one padded flat buffer in K1
(``ops/fused_pack.py``) and drops each gradient once it is packed; one
``reduce_scatter`` runs in place on the flat, leaving this rank's reduced
shard at its place; the shard of the parameters is packed afresh from the
parameters (so a ``broadcast_parameters`` or a load between steps is
honoured), the optimizer steps, K1 writes the updated shard back into its
place in the same flat, one ``all_gather`` in place fills the rest, and K1
unpacks the flat into the parameters. The replicated leaves go through the
background runtime as one grouped allreduce with the engine's op and
factors. A single process drives n virtual ranks in lockstep through
:func:`simulated_step` (tests, the card's one-GPU check).

:class:`ShardedDistributedOptimizer` is the in-step flavour (JAX's
traced one, ``horovod_tpu/opt/sharded.py:239-354``): the same layout
over a ``torch.distributed`` group, on the caller's thread, with no
runtime. The leaves under the threshold are allreduced whole in the step
(``ops/collectives.py`` ``spmd_fused_allreduce``); each dtype group is
K1-packed with the prescale into its padded flat, reduce-scattered in
place (a SUM, then JAX's ``/ n`` and postscale), stepped on the shard and
allgathered back into the parameters through ``ShardedAllgatherPlan``.
``opt.cross_replica_sharded_optimizer`` is the same object with every
non-scalar leaf sharded.

Exact for elementwise optimizers (SGD, momentum, Adam, AdamW); an
optimizer that couples the elements of a leaf (LARS, Adafactor) sees
shards, not leaves. The memory ledger (``HOROVOD_MEMLEDGER``) takes a
sample at each layout rebuild and holds the inner optimizer's state bytes
after each step (``memledger.note_sharded_state``): the 1/n claim,
measured.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..common import env as env_schema
from ..ops import collectives as C
from ..ops import fused_pack
from ..ops.collectives import ReduceOp
from ..parallel.sharding_policy import DEFAULT_MIN_SHARD_ELEMS, should_shard
from ..utils import memledger
from ..utils import metrics as metrics_mod

_SUPPORTED_OPS = (ReduceOp.AVERAGE, ReduceOp.SUM)


def _resolve_min_shard_elems(min_shard_elems: Optional[int]) -> int:
    if min_shard_elems is not None:
        return int(min_shard_elems)
    return env_schema.get_int(env_schema.HOROVOD_SHARDED_MIN_ELEMS,
                              DEFAULT_MIN_SHARD_ELEMS)


def sharded_update_enabled() -> bool:
    """The ``HOROVOD_SHARDED_UPDATE`` knob, which ``DistributedOptimizer``
    reads when the caller passes ``sharded_update=None``. With the
    compressed wire also set it raises: the reduce-scatter's shard is
    never a whole tensor to compress, and a quantized shard would
    desynchronize the replicated allgather's result."""
    enabled = env_schema.get_bool(env_schema.HOROVOD_SHARDED_UPDATE)
    if enabled:
        mode = env_schema.get_str(env_schema.HOROVOD_COMPRESSION) \
            .strip().lower()
        if mode not in ("", "none", "0", "off"):
            raise ValueError(
                f"{env_schema.HOROVOD_SHARDED_UPDATE} and "
                f"{env_schema.HOROVOD_COMPRESSION}={mode!r} are mutually "
                "exclusive: the sharded update path cannot run the "
                "quantized wire (see docs/sharded_optimizer.md)")
    return enabled


def dtype_name(dtype: torch.dtype) -> str:
    """``dtype`` as numpy and ml_dtypes spell it (``"float32"``,
    ``"bfloat16"``): the layout's group names and digest use it."""
    return str(dtype).rsplit(".", 1)[-1]


# ===========================================================================
# Layout planner
# ===========================================================================


@dataclasses.dataclass(frozen=True)
class ShardGroup:
    """One dtype's fused buffer and its cut into per-rank shards."""

    dtype: str
    indices: Tuple[int, ...]            # leaf positions, leaf order
    sizes: Tuple[int, ...]              # elements a leaf
    shapes: Tuple[Tuple[int, ...], ...]
    total: int                          # sum(sizes)
    shard_elems: int                    # ceil(total / world)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """The layout of one (leaves, world, threshold, generation). Every rank
    computes the same layout from the same inputs, without negotiation;
    ``digest`` goes into every shard plan's key."""

    world_size: int
    generation: int
    min_shard_elems: int
    num_leaves: int
    groups: Tuple[ShardGroup, ...]
    replicated: Tuple[int, ...]         # leaf positions on the allreduce path
    replicated_elems: int
    replicated_bytes: int               # one full replica, for accounting
    digest: str

    @property
    def sharded_elems(self) -> int:
        return sum(g.total for g in self.groups)

    @property
    def shard_elems(self) -> int:
        """The elements a rank owns under this layout, over the groups."""
        return sum(g.shard_elems for g in self.groups)

    @property
    def total_elems(self) -> int:
        return self.sharded_elems + self.replicated_elems

    @property
    def shard_fraction(self) -> float:
        total = self.total_elems
        return (self.sharded_elems / total) if total else 0.0

    def group_padded(self, group: ShardGroup) -> int:
        return group.shard_elems * self.world_size


def _shape(t) -> Tuple[int, ...]:
    return tuple(int(d) for d in t.shape)


def plan_shard_layout(leaves: Sequence[torch.Tensor], world_size: int, *,
                      min_shard_elems: Optional[int] = None,
                      generation: Optional[int] = None) -> ShardLayout:
    """The ZeRO-1 layout of ``leaves`` (an ordered list of tensors: the
    JAX package's ``jax.tree.leaves`` order, dict keys sorted, for the
    same digest).

    Groups the shardable leaves by dtype in leaf order (the groups sorted
    by dtype name), computes the padded per-rank cut, and fingerprints the
    whole decision. Leaves under the threshold, and scalars, go to
    ``replicated``.
    """
    world_size = max(int(world_size), 1)
    mse = _resolve_min_shard_elems(min_shard_elems)
    if generation is None:
        generation = env_schema.get_int(env_schema.HOROVOD_ELASTIC_GEN, 0)
    leaves = list(leaves)
    by_dtype: Dict[str, List[int]] = {}
    replicated: List[int] = []
    rep_elems = 0
    rep_bytes = 0
    for i, leaf in enumerate(leaves):
        shape = _shape(leaf)
        if should_shard(shape, min_shard_elems=mse):
            by_dtype.setdefault(dtype_name(leaf.dtype), []).append(i)
        else:
            replicated.append(i)
            n = 1
            for d in shape:
                n *= d
            rep_elems += n
            rep_bytes += n * leaf.dtype.itemsize
    groups = []
    for dt in sorted(by_dtype):
        idxs = tuple(by_dtype[dt])
        shapes = tuple(_shape(leaves[i]) for i in idxs)
        sizes = tuple(int(leaves[i].numel()) for i in idxs)
        total = sum(sizes)
        groups.append(ShardGroup(dtype=dt, indices=idxs, sizes=sizes,
                                 shapes=shapes, total=total,
                                 shard_elems=-(-total // world_size)))
    payload = repr((world_size, generation, mse,
                    tuple((g.dtype, g.indices, g.sizes, g.shapes)
                          for g in groups), tuple(replicated)))
    return ShardLayout(
        world_size=world_size, generation=int(generation),
        min_shard_elems=mse, num_leaves=len(leaves),
        groups=tuple(groups), replicated=tuple(replicated),
        replicated_elems=rep_elems, replicated_bytes=rep_bytes,
        digest=hashlib.sha1(payload.encode()).hexdigest())


def named_leaves(params) -> tuple:
    """(names, tensors) of ``named_parameters()`` pairs, a dict of tensors
    or a list of tensors (named by their index)."""
    if isinstance(params, dict):
        items = list(params.items())
    else:
        items = list(params)
        if items and isinstance(items[0], torch.Tensor):
            items = [(str(i), p) for i, p in enumerate(items)]
    return [str(k) for k, _ in items], [p for _, p in items]


def optimizer_state_bytes(optimizer: torch.optim.Optimizer) -> int:
    """Bytes of the tensors in ``optimizer.state``: the ZeRO-1 ledger."""
    return sum(v.numel() * v.element_size()
               for st in optimizer.state.values() for v in st.values()
               if isinstance(v, torch.Tensor))


# ===========================================================================
# The eager engine
# ===========================================================================

# live engines, for elastic's reshard notification (weak: an engine dies
# with its owner, the registry must not keep it)
_ENGINES: "weakref.WeakSet" = weakref.WeakSet()


def notify_reshard() -> None:
    """Elastic hook: a generation change invalidates every engine's
    layout; the next step replans (a new digest, fresh plans)."""
    for eng in list(_ENGINES):
        eng.invalidate_layout()


class ShardedUpdateEngine:
    """Eager ZeRO-1 update over the shard plans.

    Real mode (``process_set=``): each process brings its local
    gradients; a step runs the pack → reduce-scatter → sharded step →
    allgather → unpack chain on the set's caller group (module
    docstring). Simulated mode (``world_size=`` and ``rank=``, no set):
    n engines in one process, driven in lockstep by
    :func:`simulated_step`, for tests and the card's one-GPU check.

    ``optimizer_fn(params)`` builds the inner torch optimizer over the
    combined parameters: the replicated leaves (the parameters themselves
    in real mode, copies in simulated mode, where n engines share one set
    of parameters) and one flat shard tensor a dtype group. Its state
    exists for this rank's shard only; the parameters stay whole (they
    are gathered every step).
    """

    def __init__(self, optimizer_fn: Callable[[list], torch.optim.Optimizer],
                 *, process_set=None, world_size: Optional[int] = None,
                 rank: Optional[int] = None,
                 min_shard_elems: Optional[int] = None,
                 op: ReduceOp = ReduceOp.AVERAGE,
                 prescale_factor: float = 1.0,
                 postscale_factor: float = 1.0):
        op = ReduceOp(op)
        if op not in _SUPPORTED_OPS:
            raise ValueError(
                f"sharded update supports AVERAGE/SUM, got {op!r}")
        self._opt_fn = optimizer_fn
        self._ps = process_set
        if process_set is not None:
            self._world = int(process_set.size)
            self._rank = int(process_set.rank)
        else:
            if world_size is None or rank is None:
                raise ValueError(
                    "simulated engine needs world_size= and rank=")
            self._world = int(world_size)
            self._rank = int(rank)
        self._mse = _resolve_min_shard_elems(min_shard_elems)
        self._op = op
        self._pre = float(prescale_factor)
        self._post = float(postscale_factor)
        self._layout: Optional[ShardLayout] = None
        self._opt: Optional[torch.optim.Optimizer] = None
        self._opt_digest: Optional[str] = None
        self._rep: Dict[int, torch.Tensor] = {}   # leaf index -> stepped
        self._shards: Dict[str, torch.Tensor] = {}  # dtype -> param shard
        reg = metrics_mod.get_registry()
        wire = "hvd_sharded_update_wire_bytes_total"
        wire_help = ("sharded-update wire bytes by phase (ring accounting: "
                     "(N-1)/N of the buffer per RS or AG pass)")
        self._m_rs = reg.counter(wire, wire_help, phase="reduce_scatter")
        self._m_ag = reg.counter(wire, wire_help, phase="allgather")
        self._m_rep = reg.counter(wire, wire_help, phase="allreduce")
        self._m_shard = reg.gauge(
            "hvd_sharded_update_shard_elems",
            "per-rank owned elements under the current shard layout")
        self._m_frac = reg.gauge(
            "hvd_sharded_update_shard_fraction",
            "fraction of elements on the sharded path (rest replicate)")
        _ENGINES.add(self)

    # -- layout -------------------------------------------------------------

    @property
    def layout(self) -> Optional[ShardLayout]:
        return self._layout

    @property
    def optimizer(self) -> Optional[torch.optim.Optimizer]:
        """The inner optimizer over the combined parameters."""
        return self._opt

    def invalidate_layout(self) -> None:
        # the digest is a literal part of every shard plan's key, so a
        # rebuilt layout can never replay a stale plan
        self._layout = None

    def ensure_layout(self, params) -> ShardLayout:
        """The layout of ``params``, planned again when the elastic
        generation (``HOROVOD_ELASTIC_GEN``) changed or after
        :meth:`invalidate_layout`."""
        gen = env_schema.get_int(env_schema.HOROVOD_ELASTIC_GEN, 0)
        if self._layout is not None and self._layout.generation == gen:
            return self._layout
        layout = plan_shard_layout(params, self._world,
                                   min_shard_elems=self._mse, generation=gen)
        self._layout = layout
        self._m_shard.set(layout.shard_elems)
        self._m_frac.set(round(layout.shard_fraction, 6))
        from ..utils import flightrec

        flightrec.note("reshard", generation=layout.generation,
                       world=layout.world_size, rank=self._rank,
                       digest=layout.digest[:12],
                       groups=len(layout.groups),
                       replicated_leaves=len(layout.replicated))
        memledger.sample_event("sharded_layout_rebuild")
        return layout

    # -- state --------------------------------------------------------------

    def init(self, params) -> torch.optim.Optimizer:
        """Build the inner optimizer over this rank's shard of ``params``
        (packed from them) and the replicated leaves; returns it."""
        params = list(params)
        self._build(self.ensure_layout(params), params)
        return self._opt

    def _build(self, layout: ShardLayout, params: list):
        dev = params[0].device
        with torch.no_grad():
            self._rep = {i: (params[i] if self._ps is not None
                             else params[i].detach().clone())
                         for i in layout.replicated}
            self._shards = {}
            for g in layout.groups:
                shard = torch.empty(g.shard_elems, dtype=g.torch_dtype,
                                    device=dev)
                self._pack_plan(layout, g).pack_shard(
                    [params[i] for i in g.indices], self._rank, shard)
                self._shards[g.dtype] = shard
        self._opt = self._opt_fn(
            [self._rep[i] for i in layout.replicated]
            + [self._shards[g.dtype] for g in layout.groups])
        self._opt_digest = layout.digest

    def _ready(self, params: list) -> ShardLayout:
        """The layout, with the inner optimizer built for it: a layout
        rebuilt since (a resize) starts the optimizer afresh; carrying its
        state over goes through :meth:`full_state` and
        :meth:`load_full_state`."""
        layout = self.ensure_layout(params)
        if self._opt is None or self._opt_digest != layout.digest:
            self._build(layout, params)
        return layout

    # -- plans --------------------------------------------------------------

    def _pack_plan(self, layout: ShardLayout, g: ShardGroup):
        return C.sharded_pack_plan(self._ps, layout.world_size, g.sizes,
                                   g.shapes, g.torch_dtype, g.shard_elems,
                                   layout.digest)

    def _rs_plan(self, layout: ShardLayout, g: ShardGroup):
        return C.sharded_reduce_scatter_plan(
            self._ps, layout.world_size, self._rank, self._op,
            g.shard_elems, g.torch_dtype, layout.digest, self._pre,
            self._post)

    def _ag_plan(self, layout: ShardLayout, g: ShardGroup):
        return C.sharded_allgather_plan(self._ps, layout.world_size,
                                        g.sizes, g.shapes, g.torch_dtype,
                                        g.shard_elems, layout.digest)

    # -- the step's phases (shared by step() and simulated_step()) ----------

    def _local_update(self, layout: ShardLayout, params: list,
                      red_shards: dict, red_rep: dict):
        """The sharded optimizer step: the shards packed afresh from
        ``params``, the reduced gradients attached, one step of the inner
        optimizer over the combined parameters."""
        for i in layout.replicated:
            slot = self._rep[i]
            if slot is not params[i]:
                slot.copy_(params[i])
            slot.grad = red_rep[i]
        for g in layout.groups:
            shard = self._shards[g.dtype]
            self._pack_plan(layout, g).pack_shard(
                [params[i] for i in g.indices], self._rank, shard)
            shard.grad = red_shards[g.dtype]
        self._opt.step()
        for t in list(self._rep.values()) + list(self._shards.values()):
            t.grad = None

    def _account_step(self, layout: ShardLayout) -> None:
        """Ring-accounted wire bytes of one step: (n-1)/n of each padded
        buffer a reduce-scatter or allgather pass, twice that for the
        replicated leaves' allreduce."""
        w = layout.world_size
        scale = (w - 1) / w if w > 1 else 0.0
        for g in layout.groups:
            b = layout.group_padded(g) * g.torch_dtype.itemsize
            self._m_rs.inc(int(b * scale))
            self._m_ag.inc(int(b * scale))
        self._m_rep.inc(int(2 * scale * layout.replicated_bytes))

    # -- the real (process-backed) step ------------------------------------

    def step(self, params, grads=None):
        """One sharded update across the process set; updates ``params``
        in place and returns them. ``grads=None`` reads each parameter's
        ``.grad`` and releases it once it is packed (the saving is real
        only so); given ``grads``, the caller keeps them. The replicated
        leaves' ``.grad`` is None afterwards either way: the inner
        optimizer steps them through it."""
        if self._ps is None:
            raise ValueError(
                "simulated engines step through simulated_step()")
        # the front end imports this module: import it at the call
        from ..torch import grouped_allreduce_async, synchronize

        params = list(params)
        layout = self._ready(params)
        release = grads is None
        grads = [p.grad for p in params] if release else list(grads)
        # a leaf the backward did not reach contributes zeros, so every
        # rank makes the same collectives
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        handles = []
        if layout.replicated:
            handles = grouped_allreduce_async(
                [grads[i].detach() for i in layout.replicated],
                name="sharded_update.replicated", op=self._op,
                prescale_factor=self._pre, postscale_factor=self._post,
                process_set=self._ps)
        with torch.no_grad():
            plans, flats = {}, {}
            for g in layout.groups:
                plans[g.dtype] = self._rs_plan(layout, g)
                flats[g.dtype] = self._pack_plan(layout, g).execute(
                    [grads[i] for i in g.indices],
                    factor=plans[g.dtype].pack_factor)
                for i in g.indices:
                    grads[i] = None
                    if release:
                        params[i].grad = None
            # the runtime's allreduce and the reduce-scatter run on two
            # communicators: one at a time, in one order on every rank
            red_rep = dict(zip(layout.replicated,
                               [synchronize(h) for h in handles]))
            red_shards = {dt: plans[dt].execute(flat)
                          for dt, flat in flats.items()}
            self._local_update(layout, params, red_shards, red_rep)
            del red_shards, red_rep
            for g in layout.groups:
                self._ag_plan(layout, g).execute(
                    flats.pop(g.dtype), self._rank, self._shards[g.dtype],
                    [params[i] for i in g.indices])
        self._account_step(layout)
        memledger.note_sharded_state(self._opt)
        return params

    # -- elastic ------------------------------------------------------------

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        out = torch.empty(self._world * t.numel(), dtype=t.dtype,
                          device=t.device)
        C._count_call()
        C._all_gather(out, t.contiguous(), group=self._ps.group)
        return out

    def full_state(self, gather=None) -> dict:
        """The inner optimizer's ``state_dict`` with every shard's state
        gathered over the set and trimmed to its group's ``total``: the
        elastic commit payload, which any rank can load under any later
        layout. Replicated leaves' state and scalars pass through."""
        layout = self._layout
        if layout is None or self._opt is None:
            raise ValueError("no layout yet — run init()/step() first")
        if gather is None:
            if self._ps is None:
                raise ValueError(
                    "simulated engines use simulated_full_state()")
            gather = self._gather
        return _map_shard_state(self._opt.state_dict(), layout, False,
                                lambda g, t, idx, name: gather(t)[:g.total])

    def load_full_state(self, full: dict, params) -> torch.optim.Optimizer:
        """Load this rank's shard of ``full`` (a :meth:`full_state`
        payload, possibly from another world size) under the current
        layout; returns the inner optimizer."""
        params = list(params)
        layout = self._ready(params)

        def cut(g: ShardGroup, t: torch.Tensor, idx, name) -> torch.Tensor:
            flat = t.reshape(-1)
            padded = layout.group_padded(g)
            if padded > flat.numel():
                flat = torch.cat([flat, flat.new_zeros(padded
                                                       - flat.numel())])
            lo = self._rank * g.shard_elems
            return flat[lo:lo + g.shard_elems].clone()

        self._opt.load_state_dict(_map_shard_state(full, layout, True, cut))
        return self._opt


def _map_shard_state(sd: dict, layout: ShardLayout, full_extent: bool,
                     fn) -> dict:
    """``sd`` (an optimizer ``state_dict`` over the combined parameters)
    with ``fn(group, tensor, index, name)`` applied to every shard's state tensor: the
    1-D tensors of a shard's position whose length is the shard's (or, for
    a full payload, the group's total). Every other tensor is cloned, so
    no two optimizers share a state tensor."""
    nrep = len(layout.replicated)
    state = {}
    for idx, st in sd["state"].items():
        k = int(idx) - nrep
        g = layout.groups[k] if 0 <= k < len(layout.groups) else None
        want = None if g is None else (g.total if full_extent
                                       else g.shard_elems)
        out = {}
        for name, v in st.items():
            if isinstance(v, torch.Tensor):
                if g is not None and v.dim() == 1 and v.numel() == want:
                    v = fn(g, v, idx, name)
                else:
                    v = v.clone()
            out[name] = v
        state[idx] = out
    return {"state": state, "param_groups": sd["param_groups"]}


# ===========================================================================
# The in-step flavour: over a group, on the caller's thread
# ===========================================================================


class ShardedDistributedOptimizer:
    """ZeRO-1 in the step (JAX ``ShardedDistributedOptimizer``): the
    leaves under the threshold are allreduced whole; every other leaf
    sits in its dtype group's padded flat, which is reduce-scattered over
    ``group``, stepped by the inner optimizer on this rank's shard (its
    state 1/n of the replicated path's) and allgathered back into the
    parameters. ``optimizer_fn(params)`` builds the inner optimizer over
    the replicated parameters and one flat shard a group; ``num_shards``,
    when given, must equal the group's size. The layout is
    ``plan_shard_layout``'s at generation 0, the JAX flavour's digest for
    the same leaves in the same order. The gradients are grouped by the
    parameters' dtypes: bf16 gradients of fp32 parameters are cast up
    before the step (master weights)."""

    def __init__(self, optimizer_fn: Callable, params, *,
                 num_shards: Optional[int] = None, group=None,
                 op: ReduceOp = ReduceOp.AVERAGE,
                 min_shard_elems: Optional[int] = None,
                 prescale_factor: float = 1.0,
                 postscale_factor: float = 1.0,
                 _who: str = "ShardedDistributedOptimizer"):
        import torch.distributed as dist

        op = ReduceOp(op)
        if op not in _SUPPORTED_OPS:
            raise ValueError(
                f"sharded update supports AVERAGE/SUM, got {op!r}")
        self.group = C.spmd_group(group)
        self.world = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        if num_shards is not None and int(num_shards) != self.world:
            raise ValueError(
                f"{_who}(num_shards={num_shards}) used over a "
                f"{self.world}-rank group — gradient scaling would be "
                "silently wrong")
        self.op = op
        self.pre, self.post = float(prescale_factor), float(postscale_factor)
        self.names, self.params = named_leaves(params)
        self.layout = plan_shard_layout(self.params, self.world,
                                        min_shard_elems=min_shard_elems,
                                        generation=0)
        self._packs, self._gathers, self.shards = {}, {}, {}
        with torch.no_grad():
            for g in self.layout.groups:
                dt = g.torch_dtype
                self._packs[g.dtype] = C.ShardedPackPlan(
                    self.world, g.sizes, dt, g.shard_elems)
                self._gathers[g.dtype] = C.ShardedAllgatherPlan(
                    self.group, self.world, dt, g.shard_elems)
                shard = torch.empty(g.shard_elems, dtype=dt,
                                    device=self.params[0].device)
                self._packs[g.dtype].pack_shard(
                    [self.params[i] for i in g.indices], self.rank, shard)
                self.shards[g.dtype] = shard
        self.optimizer = optimizer_fn(
            [self.params[i] for i in self.layout.replicated]
            + [self.shards[g.dtype] for g in self.layout.groups])

    @torch.no_grad()
    def step(self, grads=None) -> bool:
        """One sharded update with this step's gradients (each parameter's
        ``.grad``, or ``grads`` in parameter order); the sharded leaves'
        ``.grad`` is released once packed, the replicated leaves' holds
        their reduced gradient. Returns True."""
        layout, params = self.layout, self.params
        release = grads is None
        grads = [p.grad for p in params] if release else list(grads)
        grads = [torch.zeros_like(p) if g is None else g.detach()
                 for p, g in zip(params, grads)]
        rep = layout.replicated
        if rep:
            outs = [params[i].grad if release else None for i in rep]
            red = C.spmd_fused_allreduce([grads[i] for i in rep], self.op,
                                         self.group, self.pre, self.post,
                                         outs)
            for i, r in zip(rep, red):
                params[i].grad = r
        flats = {}
        for g in layout.groups:
            flat = self._packs[g.dtype].execute(
                [grads[i] for i in g.indices], factor=self.pre)
            for i in g.indices:
                grads[i] = None
                if release:
                    params[i].grad = None
            lo = self.rank * g.shard_elems
            red = flat[lo:lo + g.shard_elems]
            C.spmd_calls["reduce_scatter"] += 1
            C._reduce_scatter(red, flat, torch.distributed.ReduceOp.SUM,
                              group=self.group)
            factor = C._post_factor(red, self.op == ReduceOp.AVERAGE,
                                    self.world, self.post)
            if factor != 1.0:
                fused_pack.unpack(red, [red], factor)
            shard = self.shards[g.dtype]
            # the parameters may have been loaded or broadcast since
            self._packs[g.dtype].pack_shard(
                [params[i] for i in g.indices], self.rank, shard)
            shard.grad = red
            flats[g.dtype] = flat
        self.optimizer.step()
        for g in layout.groups:
            shard = self.shards[g.dtype]
            shard.grad = None
            self._gathers[g.dtype].execute(
                flats.pop(g.dtype), self.rank, shard,
                [params[i] for i in g.indices],
                count=C._spmd_counter("all_gather"))
        memledger.note_sharded_state(self.optimizer)
        return True

    def zero_grad(self, set_to_none: bool = True):
        for p in self.params:
            if p.grad is not None:
                if set_to_none:
                    p.grad = None
                else:
                    p.grad.zero_()

    def state_dict(self) -> dict:
        """The inner optimizer's state: this rank's shard of it."""
        return copy.deepcopy(self.optimizer.state_dict())

    def load_state_dict(self, sd: dict):
        self.optimizer.load_state_dict(sd)


# ===========================================================================
# A simulated lockstep world (tests, the card's one-GPU check)
# ===========================================================================


def make_simulated_engines(optimizer_fn, world: int,
                           **kw) -> List[ShardedUpdateEngine]:
    """``world`` virtual-rank engines in one process (one plan cache)."""
    return [ShardedUpdateEngine(optimizer_fn, world_size=world, rank=r, **kw)
            for r in range(world)]


def simulated_step(engines: Sequence[ShardedUpdateEngine], params,
                   grads_per_rank: Sequence):
    """Drive n simulated engines through one lockstep sharded update.

    ``params`` is the replicated list of leaves (the same on every rank by
    contract), updated in place and returned; ``grads_per_rank[r]`` is
    rank r's local gradients. Each virtual rank's gradients go through
    K1's pack into its flat, each rank's shard is reduced from every
    rank's flat in rank order (``ops.collectives.sim_reduce``), each
    engine steps its shard, and K1 packs the ranks' updated shards into
    one flat (the gather) and unpacks it into ``params``.
    """
    world = len(engines)
    params = list(params)
    layout = engines[0]._ready(params)
    for e in engines[1:]:
        e._ready(params)
    e0 = engines[0]
    with torch.no_grad():
        red_rep = {i: C.sim_reduce([grads_per_rank[r][i]
                                    for r in range(world)],
                                   e0._op, e0._pre, e0._post)
                   for i in layout.replicated}
        red_shards: List[dict] = [{} for _ in range(world)]
        for g in layout.groups:
            pack = e0._pack_plan(layout, g)
            # factor 1: the simulated reduce applies the prescale
            flats = [pack.execute([grads_per_rank[r][i] for i in g.indices])
                     for r in range(world)]
            for r, e in enumerate(engines):
                red_shards[r][g.dtype] = e._rs_plan(layout, g).simulate(
                    flats)
            del flats
        for r, e in enumerate(engines):
            e._local_update(layout, params, red_shards[r], red_rep)
        del red_shards
        for g in layout.groups:
            e0._ag_plan(layout, g).simulate(
                [e._shards[g.dtype] for e in engines],
                [params[i] for i in g.indices])
        for i in layout.replicated:
            params[i].copy_(e0._rep[i])
    for e in engines:
        e._account_step(layout)
    return params


def simulated_full_state(engines: Sequence[ShardedUpdateEngine]) -> dict:
    """:meth:`ShardedUpdateEngine.full_state` for a simulated world: each
    shard's state concatenated over the engines in rank order."""
    layout = engines[0]._layout
    if layout is None or engines[0]._opt is None:
        raise ValueError("no layout yet — run init()/step() first")
    sds = [e._opt.state_dict() for e in engines]
    return _map_shard_state(
        sds[0], layout, False, lambda g, t, idx, name: torch.cat(
            [sd["state"][idx][name] for sd in sds])[:g.total])
