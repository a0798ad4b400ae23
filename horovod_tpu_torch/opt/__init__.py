"""The in-step optimizer layer — counterpart of ``horovod_tpu/opt``.

The JAX package's ``hvd.DistributedOptimizer`` (``horovod_tpu/opt``,
exported at ``horovod_tpu/__init__.py:354-361``) is an optax
transformation used inside ``shard_map``: every gradient is averaged by
one fused collective a dtype, compiled into the step, with no tensor
queue, no cycle thread and no negotiation. Its port here runs on the
caller's thread over a ``torch.distributed`` group (``group=``; the
global set's caller group by default, a mesh axis's through
``Mesh.group(axis)`` or ``DataParallelStep.group``), each collective
issued in program order as every rank does in SPMD
(``ops/collectives.py``, "In-step (SPMD) collectives"). It never enqueues
on the runtime.

- ``fused_tree_allreduce`` (JAX :182-212): one flat a dtype through K1's
  pack, one call, K1's unpack; with ``Compression.bf16`` the float leaves
  go on one bf16 flat through K2's cast pack. ``_tree_allreduce``
  (:50-71) picks the flavour, ``fuse_buckets=False`` one call a leaf.
- ``quantized_tree_allreduce`` (:100-167) and ``quant_residual_init``
  (:170-179): the guardrails' fallback leaves (``_quant_partition``,
  :74-97, the rules of ``ops/compression.py``) on the plain fused call,
  the rest one EQuARX allreduce a dtype (``collectives
  .quantized_allreduce``: K3, ``all_to_all_single``, the reduce-unpack,
  K3 again, ``all_gather``, the reduce-unpack), residuals keyed by the
  dtype's numpy name.
- ``DistributedGradientTransformation`` (:229-342), alias
  ``DistributedOptimizer``: a torch optimizer is an object with state, not
  an optax pair, so the inner optimizer comes as a factory
  ``optimizer_fn(params)`` (as ``ShardedUpdateEngine``'s), and one shape
  serves the plain, aggregated, quantized and sharded flavours::

      opt = hvd.opt.DistributedOptimizer(
          lambda ps: torch.optim.SGD(ps, lr=0.05, momentum=0.9),
          model.named_parameters(), group=step.group)
      loss.backward()
      opt.step()          # reduce every .grad in the step, then the inner step
      opt.zero_grad()

  ``backward_passes_per_step`` accumulates into the wrapper's own buffers
  (JAX's ``_AggState``; ``.grad`` is the user's to zero); a skipped step
  leaves the parameters and the inner state alone. Error feedback keeps
  its residuals in the wrapper (JAX's ``_QuantEFState``). ``state_dict``
  holds the inner optimizer's and the wrapper's state.
  ``sharded_update=True`` (or ``HOROVOD_SHARDED_UPDATE``) returns the
  ZeRO-1 flavour, ``ShardedDistributedOptimizer`` (``opt/sharded.py``).
- ``distributed_grad`` and ``distributed_value_and_grad`` (:348-398), over
  ``torch.func.grad`` and ``torch.func.grad_and_value``.
- ``cross_replica_sharded_optimizer`` (:405-507): every non-scalar leaf
  sharded, one padded flat a parameter dtype.

``hvd.DistributedOptimizer`` stays the reference's hook wrapper over the
background runtime; the in-step one is ``hvd.opt.DistributedOptimizer``.
Unlike XLA, nothing here overlaps the reduction with the backward: it
starts when ``step()`` is called.
"""

from __future__ import annotations

import copy
from typing import Callable, Optional

import torch

from ..ops import collectives as C
from ..ops import compression as comp
from ..ops.compression import Compression  # noqa: F401  (bf16, int8, int4)
from ..ops import fused_pack
from ..ops.collectives import ReduceOp
from .sharded import (  # noqa: F401
    ShardedDistributedOptimizer,
    ShardedUpdateEngine,
    ShardGroup,
    ShardLayout,
    dtype_name,
    make_simulated_engines,
    named_leaves,
    optimizer_state_bytes,
    plan_shard_layout,
    sharded_update_enabled,
    simulated_full_state,
    simulated_step,
)

# --- trees ------------------------------------------------------------------


def tree_flatten(tree) -> tuple:
    """(names, leaves, spec) of a tensor, or of dicts, lists and tuples of
    them (None leaves kept): the leaves in the tree's own order (dicts as
    they iterate; JAX sorts dict keys, so a parity test passes the port's
    tensors in JAX's order), each named by its path joined with ``.``."""
    names, leaves = [], []

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, f"{path}.{k}" if path else str(k))
                    for k, v in t.items()}
        if type(t) in (list, tuple):
            return type(t)(walk(v, f"{path}.{i}" if path else str(i))
                           for i, v in enumerate(t))
        names.append(path)
        leaves.append(t)
        return len(leaves) - 1

    return names, leaves, walk(tree, "")


def tree_unflatten(spec, leaves):
    if isinstance(spec, dict):
        return {k: tree_unflatten(v, leaves) for k, v in spec.items()}
    if type(spec) in (list, tuple):
        return type(spec)(tree_unflatten(v, leaves) for v in spec)
    return leaves[spec]


def _quant_spec(compression):
    return (getattr(compression, "quant_spec", None)
            if compression is not None else None)


# --- the tree allreduces ----------------------------------------------------


def _fused_leaves(leaves, op, group, compression, pre: float, post: float,
                  outputs=None) -> list:
    """``fused_tree_allreduce`` over a list of tensors (None passes)."""
    live = [i for i, t in enumerate(leaves) if t is not None]
    out = [None] * len(leaves)
    ts = [leaves[i] for i in live]
    outs = None if outputs is None else [outputs[i] for i in live]
    op = ReduceOp(op)
    fl = [k for k, t in enumerate(ts) if t.dtype.is_floating_point]
    if (getattr(compression, "wire_dtype", None) == torch.bfloat16
            and _quant_spec(compression) is None and fl
            and op in (ReduceOp.SUM, ReduceOp.AVERAGE)):
        # the bf16 cast wire: the float leaves on one bf16 flat through K2
        got = [None] * len(ts)
        red = C.spmd_cast_allreduce(
            [ts[k] for k in fl], op, group, pre, post,
            None if outs is None else _contiguous_like(
                [outs[k] for k in fl], [ts[k] for k in fl]))
        rest = [k for k in range(len(ts)) if k not in set(fl)]
        red += C.spmd_fused_allreduce([ts[k] for k in rest], op, group, pre,
                                      post)
        for k, r in zip(fl + rest, red):
            got[k] = r
    elif compression is not None:
        # any other compressor: each leaf compressed, reduced and restored
        wired = [compression.compress(t) for t in ts]
        red = C.spmd_fused_allreduce([w for w, _ in wired], op, group, pre,
                                     post)
        got = [compression.decompress(r, c) for r, (_, c) in zip(red, wired)]
    else:
        got = C.spmd_fused_allreduce(ts, op, group, pre, post, outs)
    for i, r in zip(live, got):
        out[i] = r
    return out


def _contiguous_like(outs, like) -> list:
    return [o if o is not None and o.is_contiguous() and o.dtype == t.dtype
            else torch.empty_like(t, memory_format=torch.contiguous_format)
            for o, t in zip(outs, like)]


def fused_tree_allreduce(tree, *, op=ReduceOp.AVERAGE, group=None,
                         compression=None, prescale_factor: float = 1.0,
                         postscale_factor: float = 1.0):
    """The tree's leaves allreduced over ``group`` as one flat a dtype
    (one collective each), returned in the tree's structure: tensor
    fusion in the step. ``compression`` is a cast compressor
    (``Compression.bf16``: one bf16 flat for the float leaves, through
    K2)."""
    _, leaves, spec = tree_flatten(tree)
    return tree_unflatten(spec, _fused_leaves(
        leaves, op, group, compression, float(prescale_factor),
        float(postscale_factor)))


def _leaves_allreduce(names, leaves, op, group, compression, pre, post,
                      fuse_buckets: bool, outputs=None,
                      partition=None) -> list:
    qspec = _quant_spec(compression)
    if qspec is not None:
        # stateless: persistent error feedback lives in the optimizer
        red, _ = _quantized_leaves(names, leaves, qspec, op, group, pre,
                                   post, None, outputs, partition)
        return red
    if fuse_buckets:
        return _fused_leaves(leaves, op, group, compression, pre, post,
                             outputs)
    out = []
    for t in leaves:
        if t is None:
            out.append(None)
            continue
        w, ctx = (compression.compress(t) if compression is not None
                  else (t, None))
        r = C.spmd_allreduce(w, op, group, pre, post)
        out.append(compression.decompress(r, ctx)
                   if compression is not None else r)
    return out


def _tree_allreduce(grads, op, group, compression, prescale: float,
                    postscale: float, fuse_buckets: bool):
    """JAX ``_tree_allreduce``: the quantized, fused or per-leaf flavour."""
    names, leaves, spec = tree_flatten(grads)
    return tree_unflatten(spec, _leaves_allreduce(
        names, leaves, op, group, compression, float(prescale),
        float(postscale), fuse_buckets))


def _quant_partition(names, leaves) -> tuple:
    """(eligible, fallback) leaf positions under the compressed wire's
    guardrails (``ops/compression.py``): non-float dtypes, leaves under
    ``HOROVOD_QUANT_MIN_ELEMS`` and names matching the opt-out patterns
    stay on the plain call; each fallback counts once on
    ``hvd_quant_fallback_total{reason}``. JAX names a leaf by its
    ``keystr`` path, the port by its parameter name. The port takes bf16
    as a float, where the JAX package's numpy kind test does not
    (ROADMAP.md queue 3)."""
    pats = comp.quant_optout_patterns()
    mn = comp.quant_min_elems()
    elig, plain = [], []
    for i, (name, t) in enumerate(zip(names, leaves)):
        if t is None:
            continue
        reason = comp.quant_fallback_reason(name, t.numel(), t.dtype, pats,
                                            mn)
        if reason is None:
            elig.append(i)
        else:
            comp.quant_fallback_counter(reason).inc()
            plain.append(i)
    return elig, plain


def _by_dtype(leaves, idxs) -> dict:
    groups: dict = {}
    for i in idxs:
        groups.setdefault(dtype_name(leaves[i].dtype), []).append(i)
    return dict(sorted(groups.items()))


def _quantized_leaves(names, leaves, spec, op, group, pre, post, residuals,
                      outputs=None, partition=None) -> tuple:
    elig, plain = (partition if partition is not None
                   else _quant_partition(names, leaves))
    out = [None] * len(leaves)
    new_res: dict = {}
    for _, idxs in _by_dtype(leaves, plain).items():
        red = C.spmd_fused_allreduce(
            [leaves[i] for i in idxs], op, group, pre, post,
            None if outputs is None else [outputs[i] for i in idxs])
        for i, r in zip(idxs, red):
            out[i] = r
    for dt, idxs in _by_dtype(leaves, elig).items():
        ts = [leaves[i].detach().contiguous() for i in idxs]
        res = residuals.get(dt) if residuals else None
        if res is not None and res.numel() != sum(t.numel() for t in ts):
            res = None  # the layout moved: a clean reset
        outs = (None if outputs is None
                else _contiguous_like([outputs[i] for i in idxs], ts))
        red, err = C.quantized_allreduce(
            ts, group, spec, op=op, prescale_factor=pre,
            postscale_factor=post, residual=res, outputs=outs)
        if err is not None:
            new_res[dt] = err
        for i, r in zip(idxs, red):
            out[i] = r
    return out, new_res


def quantized_tree_allreduce(tree, spec, *, op=ReduceOp.AVERAGE, group=None,
                             prescale_factor: float = 1.0,
                             postscale_factor: float = 1.0, residuals=None):
    """The tree on the blockwise-quantized wire in the step: eligible
    leaves one EQuARX allreduce a dtype, the guardrails' leaves the plain
    fused call. Returns ``(reduced_tree, new_residuals)``, the residuals
    keyed by the dtype's numpy name (``"float32"``); pass them back as
    ``residuals`` next step for error feedback, as
    ``DistributedGradientTransformation`` does."""
    names, leaves, tspec = tree_flatten(tree)
    red, new_res = _quantized_leaves(
        names, leaves, spec, op, group, float(prescale_factor),
        float(postscale_factor), residuals)
    return tree_unflatten(tspec, red), new_res


def quant_residual_init(params, spec=None) -> dict:
    """Zero error-feedback carries in the layout ``quantized_tree_allreduce``
    uses for this tree: one fp32 flat a dtype of the eligible leaves."""
    names, leaves, _ = tree_flatten(params)
    return _residual_zeros(leaves, _quant_partition(names, leaves)[0])


def _residual_zeros(leaves, elig) -> dict:
    return {dt: torch.zeros(sum(leaves[i].numel() for i in idxs),
                            dtype=torch.float32, device=leaves[idxs[0]].device)
            for dt, idxs in _by_dtype(leaves, elig).items()}


# --- the wrapper --------------------------------------------------------------


class InStepOptimizer:
    """The replicated flavours of ``DistributedGradientTransformation``:
    plain, aggregated over ``backward_passes_per_step`` and quantized with
    error feedback (built by that function, not directly)."""

    def __init__(self, optimizer_fn, names, params, *, op, group,
                 compression, prescale_factor, postscale_factor,
                 backward_passes_per_step, fuse_buckets,
                 average_aggregated_gradients):
        self.names, self.params = names, params
        self.op = ReduceOp(op)
        self.group = C.spmd_group(group)
        self.compression = compression
        self.pre, self.post = float(prescale_factor), float(postscale_factor)
        self.passes = int(backward_passes_per_step)
        self.fuse_buckets = fuse_buckets
        self.average_aggregated = average_aggregated_gradients
        self.optimizer = optimizer_fn(params)
        qspec = _quant_spec(compression)
        self._partition = (_quant_partition(names, params)
                           if qspec is not None else None)
        self._ef = qspec if qspec is not None and qspec.error_feedback \
            else None
        self.residuals = (_residual_zeros(params, self._partition[0])
                          if self._ef is not None else None)
        self.acc = None
        self.counter = 0

    def _grads(self, grads) -> list:
        grads = [p.grad for p in self.params] if grads is None \
            else list(grads)
        return [torch.zeros_like(p) if g is None else g.detach()
                for p, g in zip(self.params, grads)]

    def _reduce(self, grads) -> list:
        outs = [p.grad if p.grad is not None and p.grad.is_contiguous()
                and p.grad.dtype == g.dtype else None
                for p, g in zip(self.params, grads)]
        if self._ef is not None:
            red, new_res = _quantized_leaves(
                self.names, grads, self._ef, self.op, self.group, self.pre,
                self.post, self.residuals, outs, self._partition)
            self.residuals = new_res or self.residuals
            return red
        return _leaves_allreduce(self.names, grads, self.op, self.group,
                                 self.compression, self.pre, self.post,
                                 self.fuse_buckets, outs, self._partition)

    @torch.no_grad()
    def step(self, grads=None) -> bool:
        """Reduce this step's gradients (each parameter's ``.grad``, or
        ``grads`` in parameter order) over the group and take the inner
        optimizer's step with them; returns whether it stepped. With
        ``backward_passes_per_step`` n > 1 the gradients are added to the
        wrapper's accumulator, and only every n-th call reduces the
        accumulated sum (divided by n with
        ``average_aggregated_gradients``) and steps."""
        grads = self._grads(grads)
        if self.passes > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(p) for p in self.params]
            for a, g in zip(self.acc, grads):
                a.add_(g)
            self.counter += 1
            if self.counter < self.passes:
                return False
            scale = 1.0 / self.passes if self.average_aggregated else 1.0
            grads = [fused_pack.scaled(a, scale) for a in self.acc]
        for p, r in zip(self.params, self._reduce(grads)):
            p.grad = r
        self.optimizer.step()
        if self.passes > 1:
            for a in self.acc:
                a.zero_()
            self.counter = 0
        return True

    def zero_grad(self, set_to_none: bool = True):
        self.optimizer.zero_grad(set_to_none=set_to_none)

    def state_dict(self) -> dict:
        return {"inner": copy.deepcopy(self.optimizer.state_dict()),
                "counter": self.counter,
                "acc": None if self.acc is None
                else [a.clone() for a in self.acc],
                "residuals": None if self.residuals is None
                else {k: v.clone() for k, v in self.residuals.items()}}

    def load_state_dict(self, sd: dict):
        self.optimizer.load_state_dict(sd["inner"])
        self.counter = int(sd["counter"])
        # a state saved before any accumulation or feedback resets them
        self.acc = None if sd["acc"] is None else [
            a.to(p.device).clone() for a, p in zip(sd["acc"], self.params)]
        if sd["residuals"] is not None:
            dev = self.params[0].device
            self.residuals = {k: v.to(dev).clone()
                              for k, v in sd["residuals"].items()}
        elif self._ef is not None:
            self.residuals = _residual_zeros(self.params, self._partition[0])


def DistributedGradientTransformation(
    optimizer_fn: Callable,
    params,
    *,
    op: ReduceOp = ReduceOp.AVERAGE,
    group=None,
    compression=None,
    prescale_factor: float = 1.0,
    postscale_factor: float = 1.0,
    backward_passes_per_step: int = 1,
    fuse_buckets: bool = True,
    average_aggregated_gradients: bool = True,
    sharded_update: Optional[bool] = None,
    num_shards: Optional[int] = None,
    min_shard_elems: Optional[int] = None,
):
    """An optimizer that reduces every gradient over ``group`` inside the
    step before ``optimizer_fn(params)``'s update (JAX
    ``DistributedGradientTransformation``). ``params``: a module's
    ``named_parameters()`` (the names feed the compressed wire's
    opt-outs), a list of tensors or a dict of them.

    ``sharded_update`` (ZeRO-1): reduce-scatter, the inner step on this
    rank's shard, allgather (``ShardedDistributedOptimizer``); None reads
    ``HOROVOD_SHARDED_UPDATE``. It composes with neither
    ``backward_passes_per_step > 1`` nor compression, and error feedback
    does not compose with ``backward_passes_per_step > 1``: each raises
    JAX's refusal."""
    if sharded_update is None:
        sharded_update = sharded_update_enabled()
    if sharded_update:
        if backward_passes_per_step > 1:
            raise ValueError(
                "sharded_update does not compose with "
                "backward_passes_per_step > 1 — accumulate outside the "
                "optimizer (or run the replicated path)")
        if compression is not None:
            raise ValueError(
                "sharded_update does not compose with gradient "
                "compression (the reduce-scatter shard is never "
                "materialized as a full tensor to compress)")
        return ShardedDistributedOptimizer(
            optimizer_fn, params, num_shards=num_shards, group=group, op=op,
            min_shard_elems=min_shard_elems,
            prescale_factor=prescale_factor,
            postscale_factor=postscale_factor)
    qspec = _quant_spec(compression)
    if (qspec is not None and qspec.error_feedback
            and backward_passes_per_step > 1):
        raise ValueError(
            "quantized compression with error feedback does not "
            "compose with backward_passes_per_step > 1 — accumulate "
            "outside the optimizer, or disable error feedback "
            "(Compression.int8.with_options(error_feedback=False))")
    names, params = named_leaves(params)
    return InStepOptimizer(
        optimizer_fn, names, params, op=op, group=group,
        compression=compression, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor,
        backward_passes_per_step=backward_passes_per_step,
        fuse_buckets=fuse_buckets,
        average_aggregated_gradients=average_aggregated_gradients)


# Horovod-style name (the in-step one; hvd.DistributedOptimizer is the
# hook wrapper over the runtime)
DistributedOptimizer = DistributedGradientTransformation


def distributed_grad(fun: Callable, *, op: ReduceOp = ReduceOp.AVERAGE,
                     group=None, compression=None, fuse_buckets: bool = True,
                     has_aux: bool = False, argnums=0):
    """``torch.func.grad`` whose gradients come back already reduced over
    ``group`` (JAX ``distributed_grad``, the reference's
    ``DistributedGradientTape``)."""
    gfun = torch.func.grad(fun, argnums=argnums, has_aux=has_aux)

    def wrapped(*args, **kwargs):
        if has_aux:
            g, aux = gfun(*args, **kwargs)
            return _tree_allreduce(g, op, group, compression, 1.0, 1.0,
                                   fuse_buckets), aux
        return _tree_allreduce(gfun(*args, **kwargs), op, group,
                               compression, 1.0, 1.0, fuse_buckets)

    return wrapped


def distributed_value_and_grad(fun: Callable, *,
                               op: ReduceOp = ReduceOp.AVERAGE, group=None,
                               compression=None, fuse_buckets: bool = True,
                               has_aux: bool = False,
                               average_loss: bool = True, argnums=0):
    """``(value, grads)`` as JAX's ``value_and_grad`` orders them (torch's
    ``grad_and_value`` returns them the other way round), the gradients
    reduced over ``group`` and the loss averaged over it."""
    gvfun = torch.func.grad_and_value(fun, argnums=argnums, has_aux=has_aux)

    def wrapped(*args, **kwargs):
        g, val = gvfun(*args, **kwargs)
        g = _tree_allreduce(g, op, group, compression, 1.0, 1.0,
                            fuse_buckets)
        if average_loss:
            if has_aux:
                loss, aux = val
                val = (C.spmd_allreduce(loss, ReduceOp.AVERAGE, group), aux)
            else:
                val = C.spmd_allreduce(val, ReduceOp.AVERAGE, group)
        return val, g

    return wrapped


def cross_replica_sharded_optimizer(optimizer_fn: Callable, num_shards: int,
                                    params, group=None):
    """ZeRO-1 over ``group`` as JAX's ``cross_replica_sharded_optimizer``
    (arXiv:2004.13336): every non-scalar leaf in one padded flat a
    parameter dtype, ``reduce_scatter`` divided by ``num_shards``, the
    inner step on this rank's shard (bf16 gradients cast up to an fp32
    parameter's dtype), an allgather back into the parameters.
    ``num_shards`` must equal the group's size."""
    return ShardedDistributedOptimizer(
        optimizer_fn, params, num_shards=num_shards, group=group,
        op=ReduceOp.AVERAGE, min_shard_elems=0,
        _who="cross_replica_sharded_optimizer")


from .sync_batch_norm import (  # noqa: E402,F401  (after the tree helpers)
    SyncBatchNorm,
    moments_sync,
    sync_batch_stats,
)
