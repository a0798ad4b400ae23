"""The Horovod PyTorch front end of the port — counterpart of
``horovod_tpu/torch/__init__.py``, re-exported from the package top level.

    import horovod_tpu_torch as hvd
    hvd.init()
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    optimizer = hvd.DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters())

Every collective is a named ``TensorEntry`` enqueued on the background
runtime (``ops/queue.py``), as ``horovod_tpu/__init__.py`` :226-330 does:
the runtime negotiates the names across ranks, fuses allreduces into
chunks and runs them on its cycle thread, so the ranks need not issue
their collectives in one order. A handle is an ``int``; ``synchronize``
returns the result, ready on the caller's current stream. Tensors stay on
their device: nothing goes through numpy (unlike the JAX shim's
``_to_np``). ``DistributedOptimizer``'s gradient hooks enqueue
``allreduce.<param name>``.

Not ported in this slice, and raising ``NotImplementedError``: the ZeRO-1
sharded update (ROADMAP.md queue 1 item 12), Adasum and sparse gradients
(item 13).
"""
from __future__ import annotations

import contextlib
import itertools

import torch

from ..common.context import (  # noqa: F401  (topology + lifecycle)
    ProcessSet,
    cross_rank,
    cross_size,
    device,
    global_process_set,
    init,
    is_initialized,
    local_rank,
    local_size,
    rank,
    shutdown,
    size,
)
from ..common.context import runtime as _runtime
from ..common.exceptions import HorovodInternalError  # noqa: F401
from ..ops import collectives as _coll
from ..ops.queue import TensorEntry
from ..ops.collectives import (  # noqa: F401
    Adasum,
    Average,
    Max,
    Min,
    Product,
    ReduceOp,
    Sum,
)


class Compression:
    """fp16-on-the-wire compression (reference torch/compression.py)."""

    class none:
        @staticmethod
        def compress(t):
            return t, None

        @staticmethod
        def decompress(t, ctx):
            return t

    class fp16:
        @staticmethod
        def compress(t):
            if t.dtype in (torch.float32, torch.float64):
                return t.half(), t.dtype
            return t, None

        @staticmethod
        def decompress(t, ctx):
            return t.to(ctx) if ctx is not None else t


# handle -> (tensor the caller passed, its contiguous stand-in): an
# in-place op on a non-contiguous tensor runs on a contiguous copy, which
# synchronize writes back
_write_back: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
_group_counter = itertools.count()


def _default_name(prefix: str) -> str:
    return f"{prefix}.noname.{_runtime().handles._next}"


def _enqueue_all(op: str, tensors, names, inplace: bool, **kw) -> list:
    """Enqueue one entry per tensor at once: one cycle drains them all."""
    rt = _runtime()
    entries, targets = [], []
    for tensor, name in zip(tensors, names):
        t = tensor.detach()
        work = t if t.is_contiguous() else t.contiguous()
        out = work if inplace else torch.empty_like(work)
        entries.append(TensorEntry(name=name or _default_name(op), op=op,
                                   tensor=work, output=out, **kw))
        targets.append(t if inplace and work is not t else None)
    hs = rt.enqueue_group(entries)
    for h, e, t in zip(hs, entries, targets):
        if t is not None:
            _write_back[h] = (t, e.tensor)
    return hs


def _enqueue(op: str, tensor, name, inplace: bool, **kw) -> int:
    return _enqueue_all(op, [tensor], [name], inplace, **kw)[0]


def _allreduce_kw(tensors, average, op, prescale_factor, postscale_factor,
                  process_set) -> dict:
    op = _coll._resolve_op(op, average)
    for t in tensors:
        _coll._check_average_dtype(t, op)
    if op == Adasum:
        raise NotImplementedError(
            "Adasum is not ported yet (ROADMAP.md queue 1 item 13)")
    return dict(reduce_op=op, prescale_factor=float(prescale_factor),
                postscale_factor=float(postscale_factor),
                process_set=process_set)


def allreduce_async(tensor, average=None, name=None, op=None,
                    prescale_factor=1.0, postscale_factor=1.0,
                    process_set=None) -> int:
    return _enqueue("allreduce", tensor, name, False, **_allreduce_kw(
        [tensor], average, op, prescale_factor, postscale_factor,
        process_set))


def allreduce_async_(tensor, average=None, name=None, op=None,
                     prescale_factor=1.0, postscale_factor=1.0,
                     process_set=None) -> int:
    """In place: the result lands in ``tensor`` (in its dtype)."""
    return _enqueue("allreduce", tensor, name, True, **_allreduce_kw(
        [tensor], average, op, prescale_factor, postscale_factor,
        process_set))


def _group_base(name):
    # unique per unnamed call: two pending unnamed groups must not collide
    # on the in-flight name guard
    return name or f"grouped_allreduce.noname.{next(_group_counter)}"


def grouped_allreduce_async(tensors, average=None, name=None, op=None,
                            prescale_factor=1.0, postscale_factor=1.0,
                            process_set=None) -> list:
    """One logical op over a list, named ``<name>.<i>``, enqueued at once:
    one cycle drains the whole group and fuses it (reference
    torch/mpi_ops.py:345)."""
    base = _group_base(name)
    return _enqueue_all("allreduce", tensors,
                        [f"{base}.{i}" for i in range(len(tensors))], False,
                        **_allreduce_kw(tensors, average, op,
                                        prescale_factor, postscale_factor,
                                        process_set))


def grouped_allreduce_async_(tensors, average=None, name=None, op=None,
                             prescale_factor=1.0, postscale_factor=1.0,
                             process_set=None) -> list:
    base = _group_base(name)
    return _enqueue_all("allreduce", tensors,
                        [f"{base}.{i}" for i in range(len(tensors))], True,
                        **_allreduce_kw(tensors, average, op,
                                        prescale_factor, postscale_factor,
                                        process_set))


def _check_root(root_rank, process_set):
    ps = process_set or global_process_set()
    if not 0 <= int(root_rank) < ps.size:
        # synchronous, like the reference's rank check
        raise ValueError(f"root_rank {root_rank} out of range for process "
                         f"set of size {ps.size}")


def broadcast_async(tensor, root_rank, name=None, process_set=None) -> int:
    _check_root(root_rank, process_set)
    return _enqueue("broadcast", tensor, name, False,
                    root_rank=int(root_rank), process_set=process_set)


def broadcast_async_(tensor, root_rank, name=None, process_set=None) -> int:
    _check_root(root_rank, process_set)
    return _enqueue("broadcast", tensor, name, True,
                    root_rank=int(root_rank), process_set=process_set)


def poll(handle: int) -> bool:
    return _runtime().handles.poll(handle)


def synchronize(handle: int):
    try:
        result = _runtime().handles.wait(handle)
    finally:
        target = _write_back.pop(handle, None)
    if target is not None:
        target[0].copy_(result)
        return target[0]
    return result


# --- differentiable sync ops ------------------------------------------------
# allreduce backpropagates an allreduce of the cotangent with the same op;
# broadcast backpropagates the averaged cotangent to the root, zeros
# elsewhere (the JAX package's torch shim, :302-404).

def _grad_wanted(tensor) -> bool:
    return torch.is_grad_enabled() and tensor.requires_grad


class _AllreduceOp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, average, name, op, prescale, postscale, ps):
        ctx.meta = (average, name, op, prescale, postscale, ps)
        return synchronize(allreduce_async(tensor, average, name, op,
                                           prescale, postscale, ps))

    @staticmethod
    def backward(ctx, dy):
        average, name, op, prescale, postscale, ps = ctx.meta
        red = allreduce(dy, average=average,
                        name=f"{name}.grad" if name else None, op=op,
                        prescale_factor=prescale, postscale_factor=postscale,
                        process_set=ps)
        return red, None, None, None, None, None, None


class _GroupedAllreduceOp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, average, name, op, prescale, postscale, ps, *tensors):
        ctx.meta = (average, name, op, prescale, postscale, ps)
        hs = grouped_allreduce_async(list(tensors), average, name, op,
                                     prescale, postscale, ps)
        return tuple(synchronize(h) for h in hs)

    @staticmethod
    def backward(ctx, *dys):
        average, name, op, prescale, postscale, ps = ctx.meta
        red = grouped_allreduce(
            [d.contiguous() for d in dys], average=average,
            name=f"{name}.grad" if name else None, op=op,
            prescale_factor=prescale, postscale_factor=postscale,
            process_set=ps)
        return (None,) * 6 + tuple(red)


class _BroadcastOp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, root_rank, name, ps):
        ctx.meta = (root_rank, name, ps)
        return synchronize(broadcast_async(tensor, root_rank, name, ps))

    @staticmethod
    def backward(ctx, dy):
        root_rank, name, ps = ctx.meta
        red = allreduce(dy, average=True,
                        name=f"{name}.grad" if name else None,
                        process_set=ps)
        pset = ps or global_process_set()
        return (red if pset.rank == root_rank else red * 0), None, None, None


# --- sync wrappers ----------------------------------------------------------

def allreduce(tensor, average=None, name=None, op=None,
              compression=Compression.none,
              prescale_factor=1.0, postscale_factor=1.0, process_set=None):
    t, ctx = compression.compress(tensor)
    if _grad_wanted(t):
        out = _AllreduceOp.apply(t, average, name, op, prescale_factor,
                                 postscale_factor, process_set)
    else:
        out = synchronize(allreduce_async(t, average, name, op,
                                          prescale_factor, postscale_factor,
                                          process_set))
    return compression.decompress(out, ctx)


def allreduce_(tensor, average=None, name=None, op=None,
               prescale_factor=1.0, postscale_factor=1.0, process_set=None):
    return synchronize(allreduce_async_(tensor, average, name, op,
                                        prescale_factor, postscale_factor,
                                        process_set))


def grouped_allreduce(tensors, average=None, name=None, op=None,
                      compression=Compression.none,
                      prescale_factor=1.0, postscale_factor=1.0,
                      process_set=None):
    comp = [compression.compress(t) for t in tensors]
    if any(_grad_wanted(c[0]) for c in comp):
        outs = _GroupedAllreduceOp.apply(
            average, name, op, prescale_factor, postscale_factor,
            process_set, *[c[0] for c in comp])
    else:
        hs = grouped_allreduce_async([c[0] for c in comp], average, name, op,
                                     prescale_factor, postscale_factor,
                                     process_set)
        outs = [synchronize(h) for h in hs]
    return [compression.decompress(o, c[1]) for o, c in zip(outs, comp)]


def grouped_allreduce_(tensors, average=None, name=None, op=None,
                       prescale_factor=1.0, postscale_factor=1.0,
                       process_set=None):
    hs = grouped_allreduce_async_(tensors, average, name, op,
                                  prescale_factor, postscale_factor,
                                  process_set)
    return [synchronize(h) for h in hs]


def broadcast(tensor, root_rank, name=None, process_set=None):
    if _grad_wanted(tensor):
        return _BroadcastOp.apply(tensor, root_rank, name, process_set)
    return synchronize(broadcast_async(tensor, root_rank, name, process_set))


def barrier(process_set=None):
    _coll.barrier(process_set)


# --- parameter/optimizer broadcast (reference torch/functions.py) -----------

def broadcast_parameters(params, root_rank: int = 0):
    """Broadcast a state_dict or an iterable of (name, tensor) in place,
    in name order (reference functions.py:29)."""
    items = sorted(params.items()) if isinstance(params, dict) \
        else sorted(dict(params).items())
    handles = [broadcast_async_(p.data, root_rank, f"bcast.{name}")
               for name, p in items if isinstance(p, torch.Tensor)]
    for h in handles:
        synchronize(h)


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def broadcast_optimizer_state(optimizer, root_rank: int = 0):
    """Broadcast the full optimizer state from the root (reference
    functions.py:61). The state travels pickled on the CPU;
    ``load_state_dict`` moves it onto each parameter's device."""
    state = broadcast_object(_to_cpu(optimizer.state_dict()), root_rank)
    optimizer.load_state_dict(state)


def broadcast_object(obj, root_rank: int = 0, name=None):
    return _coll.broadcast_object(obj, root_rank)


# --- DistributedOptimizer (reference torch/optimizer.py) --------------------

class _DistributedMixin:
    """Methods grafted onto the wrapped optimizer's own class: per-parameter
    post-accumulate hooks launch async in-place allreduces, step()
    synchronizes (reference optimizer.py:35, hooks :219-247, synchronize
    :249-286). Swapping ``__class__`` in place keeps isinstance checks (LR
    schedulers, GradScaler) working and preserves optimizer state."""

    def _hvd_setup(self, named_parameters, compression, op,
                   backward_passes_per_step, prescale_factor,
                   postscale_factor, gradient_predivide_factor=1.0,
                   sparse_as_dense=False, process_set=None):
        self._process_set = process_set
        if gradient_predivide_factor != 1.0:
            if op != Average:
                # predivide splits an Average into Sum with pre/postscale —
                # meaningless for other ops
                raise ValueError(
                    "gradient_predivide_factor requires op=Average")
            op = Sum
            prescale_factor = prescale_factor / gradient_predivide_factor
            n = process_set.size if process_set is not None else size()
            postscale_factor = (postscale_factor * gradient_predivide_factor
                                / max(n, 1))
        self._compression = compression
        self._op = op
        self._bpps = backward_passes_per_step
        self._prescale = prescale_factor
        self._postscale = postscale_factor
        self._sparse_as_dense = sparse_as_dense
        self._handles: dict[torch.Tensor, tuple[int, object]] = {}
        self._passes: dict[torch.Tensor, int] = {}
        self._should_sync = True
        self._hook_handles = []
        self._names = _build_param_names(self, named_parameters, "allreduce")
        for p in self._names:
            if p.requires_grad:
                self._passes[p] = 0
                self._hook_handles.append(
                    p.register_post_accumulate_grad_hook(self._hook))

    # fired when a parameter's gradient is fully accumulated; with
    # backward_passes_per_step > 1 the accumulated sum is reduced unscaled
    def _hook(self, p):
        self._passes[p] += 1
        if self._passes[p] < self._bpps:
            return
        self._passes[p] = 0
        self._launch_reduce(p, p.grad)

    def _launch_reduce(self, p, grad):
        if grad.is_sparse:
            if not self._sparse_as_dense:
                raise NotImplementedError(
                    "sparse gradients are not ported yet (ROADMAP.md queue 1 "
                    "item 13); pass sparse_as_dense=True")
            grad = grad.to_dense()
        comp, ctx = self._compression.compress(grad)
        h = allreduce_async_(comp, name=self._names[p], op=self._op,
                             prescale_factor=self._prescale,
                             postscale_factor=self._postscale,
                             process_set=self._process_set)
        self._handles[p] = (h, ctx)

    def synchronize(self):
        # every tracked param without a pending handle is reduced now —
        # hooks that never fired (unused params) contribute zeros, so all
        # ranks issue the same collectives — and pass counters reset
        for p in self._names:
            if not p.requires_grad or p in self._handles:
                continue
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            self._launch_reduce(p, p.grad)
        for p in self._passes:
            self._passes[p] = 0
        for p, (h, ctx) in list(self._handles.items()):
            reduced = synchronize(h)
            p.grad = self._compression.decompress(
                reduced, ctx).reshape(p.shape).to(p.grad.dtype)
        self._handles.clear()

    def set_backward_passes_per_step(self, passes: int):
        """Change the local gradient-accumulation window; resets pass
        counters."""
        self._bpps = int(passes)
        for p in self._passes:
            self._passes[p] = 0

    @contextlib.contextmanager
    def skip_synchronize(self):
        """Suppress the implicit synchronize in the next step() (used with
        gradient clipping after a manual synchronize())."""
        self._should_sync = False
        try:
            yield
        finally:
            self._should_sync = True

    def step(self, closure=None):
        if self._should_sync:
            self.synchronize()
        return self._hvd_base.step(self, closure)


def _build_param_names(optimizer, named_parameters, noname_prefix):
    """Duplicate names would mis-pair collectives across ranks; uncovered
    params would silently never reduce."""
    if named_parameters is not None:
        seen, dups = set(), set()
        for n, _ in named_parameters:
            if n in seen:
                dups.add(n)
            seen.add(n)
        if dups:
            raise ValueError(
                "named_parameters contains duplicate names: "
                f"{sorted(dups)}")
        names = {p: n for n, p in named_parameters}
        all_params = {p for g in optimizer.param_groups for p in g["params"]}
        missing = all_params - names.keys()
        if missing:
            raise ValueError(
                "named_parameters does not cover all optimizer "
                f"parameters ({len(missing)} uncovered)")
        return names
    names = {}
    for gi, group in enumerate(optimizer.param_groups):
        for pi, p in enumerate(group["params"]):
            names[p] = f"{noname_prefix}.noname.{gi}.{pi}"
    return names


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters=None,
                         compression=Compression.none,
                         op=Average,
                         backward_passes_per_step: int = 1,
                         prescale_factor: float = 1.0,
                         postscale_factor: float = 1.0,
                         gradient_predivide_factor: float = 1.0,
                         sparse_as_dense: bool = False,
                         process_set=None,
                         sharded_update: bool = False):
    if hasattr(optimizer, "_hvd_base"):
        # re-wrapping would make the grafted step() re-enter itself and
        # register every hook twice
        raise ValueError(
            "optimizer is already wrapped by DistributedOptimizer")
    if sharded_update:
        raise NotImplementedError(
            "the ZeRO-1 sharded update is not ported yet (ROADMAP.md queue 1 "
            "item 12)")
    if op == Adasum:
        raise NotImplementedError(
            "the Adasum optimizer is not ported yet (ROADMAP.md queue 1 "
            "item 13)")
    base = optimizer.__class__
    body = {k: v for k, v in _DistributedMixin.__dict__.items()
            if not k.startswith("__")}
    body["_hvd_base"] = base
    optimizer.__class__ = type("Distributed" + base.__name__, (base,), body)
    optimizer._hvd_setup(
        list(named_parameters) if named_parameters is not None else None,
        compression, op, backward_passes_per_step,
        prescale_factor, postscale_factor, gradient_predivide_factor,
        sparse_as_dense, process_set)
    return optimizer
