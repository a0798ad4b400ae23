"""The in-step optimizer layer across processes: two gloo jobs through the
port's ``hvdrun``, one of 2 ranks and one of 4, started together once for
the file, against the JAX package's in-step functions under ``shard_map``
over 2 or 4 of the session's virtual CPU devices (computed while the jobs
run). Every input is drawn from one numpy seed and saved for the jobs;
each rank saves what it computed.

Cases, each at both worlds unless named:

- ``fused``: ``fused_tree_allreduce`` of two fp32 and two bf16 leaves for
  SUM, AVERAGE, MIN, MAX and PRODUCT, without factors and with
  prescale 0.7 and postscale 1.3; on the bf16 cast wire (K2) for SUM and
  AVERAGE; one call a leaf (``fuse_buckets=False``) for AVERAGE with the
  factors; ADASUM of the fp32 leaves;
- ``quant``: ``quantized_tree_allreduce`` on the int8 and the int4 wire
  with error feedback over 3 steps (an opt-out leaf, a small leaf and two
  eligible ones), the residuals carried from step to step;
- ``dgt``: ``DistributedOptimizer`` over SGD 0.05 with momentum 0.9
  against ``optax.sgd(0.05, momentum=0.9)`` under the JAX wrapper, the
  same given gradients: plain, ``backward_passes_per_step=3`` averaged and
  summed, the bf16 and the int8 wire;
- ``zero``: ``sharded_update=True``, ``cross_replica_sharded_optimizer``
  and the replicated wrapper, 2 steps; JAX's mixed-precision case (bf16
  gradients of fp32 parameters); the inner optimizers' state bytes;
- ``dgrad``: ``distributed_grad`` and ``distributed_value_and_grad``;
- ``bn``: ``moments_sync``, ``sync_batch_stats`` and ``SyncBatchNorm``'s
  outputs, input gradients and running statistics against flax's
  ``BatchNorm(axis_name=...)``;
- ``resnet`` (2 ranks): the reduced ResNet (one block a stage, 8
  filters, 10 classes, batch 4 a rank, 32², fp32, the resnet test's
  random weights through ``params_from_jax``), 2 steps of
  ``bench.py::bench_resnet``'s loop: ``data_parallel_step`` and the
  in-step ``DistributedOptimizer(SGD(0.05, momentum=0.9))``;
- ``runtime``: the runtime's chunk, call and collective counters do not
  move across an in-step step.

Tolerances. At 2 ranks the fused and quantized reductions are bitwise
JAX's (gloo adds two rows as XLA does, and the port follows XLA's
in-step rounding: a separate prescale, the sum, ``/ n``, the postscale;
bf16 prescaled products summed in fp32). At 4 ranks gloo's order of
summation is not rank order (ROADMAP.md queue 3): fp32 within 2^-21 of
each tensor's largest magnitude, bf16 within 2^-7; MIN and MAX bitwise;
the quantized leaves bitwise (EQuARX sums no row through gloo: an
``all_to_all``, the local reduce-unpack in rank order, an ``all_gather``),
the opt-out and small leaves of that call as the fused fp32 ones, the
residuals (each rank's own contribution error) bitwise; the bf16 wire within 2^-7 (gloo rounds each partial bf16 sum, XLA sums
in fp32 and rounds once). Parameters after optimizer steps within 2^-20
of each tensor's largest magnitude (2^-8 for the bf16 wire at 4 ranks,
whose gradients differ by a bf16 rounding there): torch's SGD writes
``p.add_(buf, alpha=-lr)``, optax ``p + (-lr * m)``, which round
differently. ADASUM and the gradients of
computed losses within 1e-5 relative (the two libraries' own fp32
arithmetic). The ResNet (at 33², where the reduced model's fp32
gradients agree to 2e-5 between torch and XLA,
``tests/test_torch_port_resnet.py``): the loss and the parameters after
the first step within 1e-5 (of each tensor's largest magnitude; 1.2e-6
read), after the second within 2e-3 (8.3e-4 read): the first step's
last-bit differences reach the second step's gradients through batch
norms over 16 values a channel in the last stage, which amplify them
about a thousandfold (at 64² one rank's batch alone gives 10 %
differences between the two libraries' gradients of the same weights).
"""

import os
import signal
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import PartitionSpec as P

import horovod_tpu.opt as jopt
from horovod_tpu.models import resnet as R
from horovod_tpu.ops import collectives as jcoll
from horovod_tpu.ops import compression as jcomp
from horovod_tpu.ops.collectives import ReduceOp
from horovod_tpu.opt import sync_batch_norm as jbn
from horovod_tpu.parallel import data_parallel_step
from horovod_tpu_torch.models import resnet as PR
from torch_port_spmd_support import bf16_exact, mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
LR, MOMENTUM = 0.05, 0.9
FUSED = {"a": ((37,), "float32"), "b": ((5, 7), "bfloat16"),
         "c": ((3, 4, 5), "float32"), "d": ((11,), "bfloat16")}
OPS = ("SUM", "AVERAGE", "MIN", "MAX", "PRODUCT")
FACTORS = ((1.0, 1.0), (0.7, 1.3))
QUANT = {"conv.kernel": (64, 80), "dense.bias": (4500,),
         "dense.kernel": (96, 50), "small": (100,)}
QUANT_STEPS, BLOCK = 3, 256
DGT = {"b": (80,), "w": (64, 80)}
DGT_CASES = {"plain": (3, 1, True, None), "bpps_avg": (6, 3, True, None),
             "bpps_sum": (6, 3, False, None), "bf16": (3, 1, True, "bf16"),
             "int8": (3, 1, True, "int8")}
ZERO = {"b": (5,), "w": (13, 5)}
ZERO_STEPS, MIN_SHARD = 2, 16
DGRAD = {"b": (4,), "w": (6, 4)}
BN_SHAPE = (3, 4, 5, 6)
SMALL = dict(stage_sizes=[1, 1, 1, 1], num_filters=8, num_classes=10)
RESNET_BATCH, RESNET_HW, RESNET_STEPS = 4, 33, 2
RESNET_TOL = (1e-5, 2e-3)  # after the first step, after the second
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}

JOB = """
    import sys
    sys.modules["jax"] = None
    sys.modules["horovod_tpu"] = None
    import numpy as np
    import torch
    import torch.nn.functional as F
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import opt as O
    from horovod_tpu_torch.common import context
    from horovod_tpu_torch.models import resnet as PR
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.ops import compression as comp
    from horovod_tpu_torch.parallel import data_parallel_step
    torch.set_num_threads(1)
    hvd.init(device="cpu")
    r, n = hvd.rank(), hvd.size()
    inp = dict(np.load(IN))
    res = {}
    DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def mine(key, *idx, dtype=torch.float32):
        return torch.from_numpy(inp[key][(r,) + idx]).to(dtype)

    def save(key, v):
        res[key] = (v.detach().float().numpy().copy() if torch.is_tensor(v)
                    else np.asarray(v))

    def sgd(lr=LR):
        return lambda ps: torch.optim.SGD(ps, lr=lr, momentum=MOMENTUM)

    def sgd0(lr):
        return lambda ps: torch.optim.SGD(ps, lr=lr)

    # fused
    tree = {k: mine("fused." + k, dtype=DT[dt]) for k, (_, dt) in
            FUSED.items()}
    for op in OPS:
        for pre, post in FACTORS:
            out = O.fused_tree_allreduce(
                tree, op=getattr(hvd.ReduceOp, op), prescale_factor=pre,
                postscale_factor=post)
            for k, v in out.items():
                assert v.dtype == tree[k].dtype
                save(f"fused.{op}.{pre}.{k}", v)
    for op in ("SUM", "AVERAGE"):
        out = O.fused_tree_allreduce(tree, op=getattr(hvd.ReduceOp, op),
                                     compression=O.Compression.bf16)
        for k, v in out.items():
            assert v.dtype == tree[k].dtype
            save(f"fused.cast.{op}.{k}", v)
    out = O._tree_allreduce(tree, hvd.ReduceOp.AVERAGE, None, None, 0.7,
                            1.3, False)
    for k, v in out.items():
        save(f"fused.unfused.{k}", v)
    out = O.fused_tree_allreduce({"a": tree["a"], "c": tree["c"]},
                                 op=hvd.ReduceOp.ADASUM)
    for k, v in out.items():
        save(f"fused.adasum.{k}", v)

    # the thin in-step collectives
    x, xs = mine("coll.x"), mine("coll.xs")
    save("coll.allgather", C.spmd_allgather(x))
    save("coll.broadcast", C.spmd_broadcast(x, 1))
    save("coll.rs_sum", C.spmd_reducescatter(xs))
    save("coll.rs_avg", C.spmd_reducescatter(xs, hvd.ReduceOp.AVERAGE))

    # quant
    for bits in (8, 4):
        spec = comp.make_quant_spec(bits, BLOCK, True)
        residuals = None
        for s in range(QUANT_STEPS):
            g = {k: mine("quant." + k, s) for k in QUANT}
            red, residuals = O.quantized_tree_allreduce(
                g, spec, residuals=residuals)
            for k, v in red.items():
                save(f"quant.{bits}.{s}.{k}", v)
            save(f"quant.{bits}.{s}.res", residuals["float32"])

    # dgt
    names = list(DGT)
    for case, (steps, passes, avg, wire) in DGT_CASES.items():
        ps = [torch.nn.Parameter(torch.from_numpy(inp["dgt.p." + k]).clone())
              for k in names]
        opt = O.DistributedOptimizer(
            sgd(), list(zip(names, ps)),
            compression=None if wire is None else getattr(O.Compression,
                                                          wire),
            backward_passes_per_step=passes,
            average_aggregated_gradients=avg)
        for s in range(steps):
            opt.step([mine("dgt.g." + k, s) for k in names])
            for k, p in zip(names, ps):
                save(f"dgt.{case}.{s}.{k}", p)

    # zero
    names = list(ZERO)

    def zparams():
        return [torch.nn.Parameter(torch.from_numpy(inp["zero.p." + k])
                                   .clone()) for k in names]

    arms = {}
    ps = zparams()
    arms["sharded"] = (ps, O.DistributedOptimizer(
        sgd(), list(zip(names, ps)), sharded_update=True,
        min_shard_elems=MIN_SHARD))
    ps = zparams()
    arms["cross"] = (ps, O.cross_replica_sharded_optimizer(
        sgd(), n, list(zip(names, ps))))
    ps = zparams()
    arms["replicated"] = (ps, O.DistributedOptimizer(sgd(),
                                                     list(zip(names, ps))))
    for s in range(ZERO_STEPS):
        for arm, (ps, opt) in arms.items():
            opt.step([mine("zero.g." + k, s) for k in names])
            for k, p in zip(names, ps):
                save(f"zero.{arm}.{s}.{k}", p)
    for arm, (ps, opt) in arms.items():
        save(f"zero.{arm}.state_bytes", O.optimizer_state_bytes(
            opt.optimizer))
    w = torch.nn.Parameter(torch.ones(9))
    opt = O.cross_replica_sharded_optimizer(sgd0(0.1), n, [("w", w)])
    opt.step([torch.ones(9, dtype=torch.bfloat16)])
    assert w.dtype == torch.float32
    save("zero.mixed", w)

    # dgrad
    params = {k: torch.from_numpy(inp["dgrad.p." + k]) for k in DGRAD}

    def loss_fn(p, x, y):
        return ((x @ p["w"] + p["b"] - y) ** 2).mean()

    x, y = mine("dgrad.x"), mine("dgrad.y")
    g = O.distributed_grad(loss_fn)(params, x, y)
    val, g2 = O.distributed_value_and_grad(loss_fn)(params, x, y)
    for k in DGRAD:
        save("dgrad.g." + k, g[k])
        save("dgrad.vg." + k, g2[k])
    save("dgrad.loss", val)

    # bn
    x = mine("bn.x")
    mean, var = O.moments_sync(x, axes=(0, 2, 3))
    save("bn.moments_mean", mean)
    save("bn.moments_var", var)
    st = O.sync_batch_stats({"mean": mine("bn.stat_mean"),
                             "var": mine("bn.stat_var")})
    save("bn.stats_mean", st["mean"])
    save("bn.stats_var", st["var"])
    bn = O.SyncBatchNorm(BN_SHAPE[1])
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inp["bn.scale"]))
        bn.bias.copy_(torch.from_numpy(inp["bn.bias"]))
    x.requires_grad_()
    yb = bn(x)
    (yb * mine("bn.co")).sum().backward()
    save("bn.y", yb)
    save("bn.dx", x.grad)
    save("bn.running_mean", bn.running_mean)
    save("bn.running_var", bn.running_var)

    # runtime: an in-step step moves none of the runtime's counters
    rt = context.runtime()
    w = torch.nn.Parameter(torch.ones(8))
    opt = O.DistributedOptimizer(sgd(), [("w", w)])
    before = (rt.chunks, rt.work_cycles, rt.collective_calls, C.dist_calls)
    calls = dict(C.spmd_calls)
    w.grad = torch.full((8,), float(r))
    opt.step()
    after = (rt.chunks, rt.work_cycles, rt.collective_calls, C.dist_calls)
    res["runtime.same"] = np.array(before == after)
    res["runtime.spmd_all_reduce"] = np.array(
        C.spmd_calls["all_reduce"] - calls["all_reduce"])

    # resnet (2 ranks): bench_resnet's loop through data_parallel_step
    if n == 2:
        tree = {}
        for key, v in inp.items():
            if key.startswith("resnet.v."):
                node = tree
                *path, leaf = key[len("resnet.v."):].split("/")
                for p in path:
                    node = node.setdefault(p, {})
                node[leaf] = v
        model = PR.ResNet(**SMALL, dtype=torch.float32, device="cpu")
        model.load_state_dict(PR.params_from_jax(tree["params"],
                                                 tree["batch_stats"]))

        def train_step(model, opt, images, labels):
            opt.zero_grad()
            loss = F.cross_entropy(model(images), labels)
            loss.backward()
            opt.step()
            return C.spmd_allreduce(loss.detach(), hvd.ReduceOp.AVERAGE,
                                    step.group)

        step = data_parallel_step(train_step, batch_argnums=(2, 3))
        opt = hvd.opt.DistributedOptimizer(
            sgd(), model.named_parameters(), group=step.group)
        images = torch.from_numpy(
            inp["resnet.images"][r]).permute(0, 3, 1, 2)
        labels = torch.from_numpy(inp["resnet.labels"][r])
        for s in range(RESNET_STEPS):
            save(f"resnet.loss.{s}", step(model, opt, images, labels))
            for k, p in model.named_parameters():
                save(f"resnet.{s}.{k}", p)

    np.savez(OUT.format(r), **res)
    hvd.shutdown()
    print("JOB_OK", r)
"""


def _inputs(n: int) -> dict:
    rs = np.random.RandomState(n)
    inp = {}
    for k, (shape, dt) in FUSED.items():
        x = 1.0 + 0.5 * rs.randn(n, *shape)
        inp["fused." + k] = bf16_exact(x) if dt == "bfloat16" else x
    inp["coll.x"] = rs.randn(n, 6, 3)
    inp["coll.xs"] = rs.randn(n, 2 * n, 3)
    for k, shape in QUANT.items():
        inp["quant." + k] = rs.randn(n, QUANT_STEPS, *shape)
    for k, shape in DGT.items():
        inp["dgt.p." + k] = 0.1 * rs.randn(*shape)
        inp["dgt.g." + k] = rs.randn(n, 6, *shape)
    for k, shape in ZERO.items():
        inp["zero.p." + k] = 0.1 * rs.randn(*shape)
        inp["zero.g." + k] = rs.randn(n, ZERO_STEPS, *shape)
    for k, shape in DGRAD.items():
        inp["dgrad.p." + k] = rs.randn(*shape)
    inp["dgrad.x"] = rs.randn(n, 5, 6)
    inp["dgrad.y"] = rs.randn(n, 5, 4)
    inp["bn.x"] = 2.0 + rs.randn(n, *BN_SHAPE)
    inp["bn.co"] = rs.randn(n, *BN_SHAPE)
    inp["bn.scale"] = 1.0 + 0.2 * rs.randn(BN_SHAPE[1])
    inp["bn.bias"] = 0.1 * rs.randn(BN_SHAPE[1])
    inp["bn.stat_mean"] = rs.randn(n, BN_SHAPE[1])
    inp["bn.stat_var"] = 0.5 + rs.rand(n, BN_SHAPE[1])
    inp = {k: v.astype(np.float32) for k, v in inp.items()}
    if n == 2:
        inp.update(_resnet_inputs(n))
    return inp


def _resnet_variables():
    model = R.ResNet(**SMALL, dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda x: model.init(jax.random.PRNGKey(0), x, train=True),
        jax.ShapeDtypeStruct((RESNET_BATCH, RESNET_HW, RESNET_HW, 3),
                             jnp.float32))
    rs = np.random.RandomState(0)

    def leaf(path, s):  # as tests/test_torch_port_resnet.py draws them
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rs.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if "scale" in name:
            return (1.0 + 0.2 * rs.randn(*s.shape)).astype(np.float32)
        if "var" in name:
            return (0.5 + rs.rand(*s.shape)).astype(np.float32)
        return (0.1 * rs.randn(*s.shape)).astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(leaf, shapes)


def _resnet_inputs(n: int) -> dict:
    _, variables = _resnet_variables()
    rs = np.random.RandomState(7)
    inp = {"resnet.images": rs.randn(n, RESNET_BATCH, RESNET_HW, RESNET_HW,
                                     3).astype(np.float32),
           "resnet.labels": rs.randint(0, SMALL["num_classes"],
                                       (n, RESNET_BATCH))}
    for path, v in jax.tree_util.tree_flatten_with_path(variables)[0]:
        key = "/".join(p.key for p in path)
        inp["resnet.v." + key] = np.asarray(v)
    return inp


def _jax_tree(inp, prefix, names, dtypes=None, idx=()):
    """{name: jnp array} of ``inp[prefix + name]`` (sharded arrays keep
    their rank axis)."""
    out = {}
    for k in names:
        x = inp[prefix + k][idx] if idx else inp[prefix + k]
        dt = (dtypes or {}).get(k, "float32")
        out[k] = jnp.asarray(x, jnp.bfloat16 if dt == "bfloat16"
                             else jnp.float32)
    return out


def _shard_map(f, n, in_specs, out_specs):
    return jax.jit(jax.shard_map(f, mesh=mesh(n), in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _references(inp, n: int) -> dict:
    ref = {}
    ops = {o: getattr(ReduceOp, o) for o in OPS}

    # fused
    def fused(tree):
        tree = {k: v[0] for k, v in tree.items()}
        out = {}
        for op in OPS:
            for pre, post in FACTORS:
                out[f"{op}.{pre}"] = jopt.fused_tree_allreduce(
                    tree, op=ops[op], axis_name="hvd", prescale_factor=pre,
                    postscale_factor=post)
        for op in ("SUM", "AVERAGE"):
            out[f"cast.{op}"] = jopt.fused_tree_allreduce(
                tree, op=ops[op], axis_name="hvd",
                compression=jcomp.Compression.bf16)
        out["unfused"] = jopt._tree_allreduce(tree, ReduceOp.AVERAGE, "hvd",
                                              None, 0.7, 1.3, False)
        out["adasum"] = jopt.fused_tree_allreduce(
            {"a": tree["a"], "c": tree["c"]}, op=ReduceOp.ADASUM,
            axis_name="hvd")
        return out

    tree = _jax_tree(inp, "fused.", FUSED, {k: dt for k, (_, dt) in
                                            FUSED.items()})
    ref["fused"] = _np(_shard_map(fused, n, (P("hvd"),), P())(tree))

    # the thin collectives
    def coll(x, xs):
        return ({"allgather": jcoll.allgather(x[0], axis_name="hvd"),
                 "broadcast": jcoll.broadcast(x[0], 1, axis_name="hvd")},
                {"rs_sum": jcoll.reducescatter(xs[0], axis_name="hvd")[None],
                 "rs_avg": jcoll.reducescatter(xs[0], op=ReduceOp.AVERAGE,
                                               axis_name="hvd")[None]})

    ref["coll"], ref["coll_rank"] = _np(_shard_map(
        coll, n, (P("hvd"), P("hvd")), (P(), P("hvd")))(
            jnp.asarray(inp["coll.x"]), jnp.asarray(inp["coll.xs"])))

    # quant
    def quant(g):
        out = {}
        for bits in (8, 4):
            spec = jcomp.make_quant_spec(bits, BLOCK, True)
            res = None
            for s in range(QUANT_STEPS):
                red, res = jopt.quantized_tree_allreduce(
                    {k: v[0, s] for k, v in g.items()}, spec,
                    axis_name="hvd", residuals=res)
                out[f"{bits}.{s}"] = red
                out[f"{bits}.{s}.res"] = res["float32"][None]
        return ({k: v for k, v in out.items() if not k.endswith(".res")},
                {k: v for k, v in out.items() if k.endswith(".res")})

    red, res = _shard_map(quant, n, (P("hvd"),), (P(), P("hvd")))(
        _jax_tree(inp, "quant.", QUANT))
    ref["quant"], ref["quant_res"] = _np(red), _np(res)

    # dgt
    def dgt(p0, g):
        out = {}
        for case, (steps, passes, avg, wire) in DGT_CASES.items():
            opt = jopt.DistributedOptimizer(
                optax.sgd(LR, momentum=MOMENTUM), axis_name="hvd",
                compression=None if wire is None
                else getattr(jcomp.Compression, wire),
                backward_passes_per_step=passes,
                average_aggregated_gradients=avg)
            p, state = p0, opt.init(p0)
            for s in range(steps):
                u, state = opt.update({k: v[0, s] for k, v in g.items()},
                                      state, p)
                p = optax.apply_updates(p, u)
                out[f"{case}.{s}"] = p
        return out

    ref["dgt"] = _np(_shard_map(dgt, n, (P(), P("hvd")), P())(
        _jax_tree(inp, "dgt.p.", DGT), _jax_tree(inp, "dgt.g.", DGT)))

    # zero
    def zero(p0, g):
        out = {}
        opts = {"sharded": jopt.ShardedDistributedOptimizer(
                    optax.sgd(LR, momentum=MOMENTUM), num_shards=n,
                    axis_name="hvd", min_shard_elems=MIN_SHARD),
                "cross": jopt.cross_replica_sharded_optimizer(
                    optax.sgd(LR, momentum=MOMENTUM), n, "hvd")}
        for arm, opt in opts.items():
            p, state = p0, opt.init(p0)
            for s in range(ZERO_STEPS):
                u, state = opt.update({k: v[0, s] for k, v in g.items()},
                                      state, p)
                p = optax.apply_updates(p, u)
                out[f"{arm}.{s}"] = p
        mixed = jopt.cross_replica_sharded_optimizer(optax.sgd(0.1), n,
                                                     "hvd")
        w = {"w": jnp.ones((9,), jnp.float32)}
        u, _ = mixed.update({"w": jnp.ones((9,), jnp.bfloat16)},
                            mixed.init(w), w)
        out["mixed"] = optax.apply_updates(w, u)
        return out

    ref["zero"] = _np(_shard_map(zero, n, (P(), P("hvd")), P())(
        _jax_tree(inp, "zero.p.", ZERO), _jax_tree(inp, "zero.g.", ZERO)))

    # dgrad
    def loss_fn(p, x, y):
        return jnp.mean((x @ p["w"] + p["b"] - y) ** 2)

    def dgrad(p, x, y):
        g = jopt.distributed_grad(loss_fn, axis_name="hvd")(p, x[0], y[0])
        val, g2 = jopt.distributed_value_and_grad(loss_fn, axis_name="hvd")(
            p, x[0], y[0])
        return g, g2, val

    ref["dgrad"] = _np(_shard_map(dgrad, n, (P(), P("hvd"), P("hvd")),
                                  P())(_jax_tree(inp, "dgrad.p.", DGRAD),
                                       jnp.asarray(inp["dgrad.x"]),
                                       jnp.asarray(inp["dgrad.y"])))

    # bn: flax's BatchNorm over NHWC under shard_map
    m = jbn.SyncBatchNorm(axis_name="hvd")
    c = BN_SHAPE[1]
    variables = {"params": {"sync_bn": {"scale": jnp.asarray(inp["bn.scale"]),
                                        "bias": jnp.asarray(inp["bn.bias"])}},
                 "batch_stats": {"sync_bn": {"mean": jnp.zeros(c),
                                             "var": jnp.ones(c)}}}

    def bn(x, co, sm, sv):
        def loss(xh):
            y, upd = m.apply(variables, xh, use_running_average=False,
                             mutable=["batch_stats"])
            return jnp.sum(y * co[0].transpose(0, 2, 3, 1)), (y, upd)

        xh = x[0].transpose(0, 2, 3, 1)
        (_, (y, upd)), dx = jax.value_and_grad(loss, has_aux=True)(xh)
        mean, var = jbn.moments_sync(x[0], "hvd", axes=(0, 2, 3))
        st = jbn.sync_batch_stats({"mean": sm[0], "var": sv[0]}, "hvd")
        return ({"y": y.transpose(0, 3, 1, 2)[None],
                 "dx": dx.transpose(0, 3, 1, 2)[None]},
                {"mean": mean, "var": var, "stats": st,
                 "running": upd["batch_stats"]["sync_bn"]})

    ref["bn"], ref["bn_rep"] = _np(_shard_map(
        bn, n, (P("hvd"),) * 4, (P("hvd"), P()))(
            *(jnp.asarray(inp["bn." + k]) for k in ("x", "co", "stat_mean",
                                                     "stat_var"))))

    if n == 2:
        ref["resnet"] = _resnet_reference(inp, n)
    return ref


def _resnet_reference(inp, n: int) -> dict:
    """bench_resnet's one_step at fp32 over a mesh of n: the pmean'd loss
    and the parameters after each step, as the port's state_dict names."""
    model, variables = _resnet_variables()
    opt = jopt.DistributedOptimizer(optax.sgd(LR, momentum=MOMENTUM),
                                    axis_name="hvd")

    def step(state, opt_state, images, labels):
        params, batch_stats = state

        def loss_fn(p):
            logits, upd = model.apply({"params": p,
                                       "batch_stats": batch_stats}, images,
                                      train=True, mutable=["batch_stats"])
            onehot = jax.nn.one_hot(labels, SMALL["num_classes"])
            loss = -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * onehot,
                                     -1))
            return loss, upd["batch_stats"]

        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return (params, stats), opt_state, jax.lax.pmean(loss, "hvd")

    f = data_parallel_step(step, mesh=mesh(n), axis_name="hvd",
                           batch_argnums=(2, 3), donate_argnums=())
    images = jnp.asarray(inp["resnet.images"].reshape(
        (-1,) + inp["resnet.images"].shape[2:]))
    labels = jnp.asarray(inp["resnet.labels"].reshape(-1))
    state = (variables["params"], variables["batch_stats"])
    opt_state = opt.init(variables["params"])
    args = (state, opt_state, images, labels)
    compiled = f.lower(*args).compile(FAST_COMPILE)
    out = {}
    for s in range(RESNET_STEPS):
        state, opt_state, loss = compiled(state, opt_state, images, labels)
        out[f"loss.{s}"] = float(loss)
        sd = PR.params_from_jax(_np(state[0]), _np(variables["batch_stats"]))
        out[f"params.{s}"] = {k: v.numpy() for k, v in sd.items()
                              if "running" not in k}
    return out


def _start(tmp, n: int, inp: dict):
    d = tmp / f"np{n}"
    d.mkdir()
    np.savez(d / "in.npz", **inp)
    script = d / "spmd_cases.py"
    script.write_text(
        f"IN = {str(d / 'in.npz')!r}\nOUT = {str(d / 'out.{}.npz')!r}\n"
        f"FUSED = {FUSED!r}\nOPS = {OPS!r}\nFACTORS = {FACTORS!r}\n"
        f"QUANT = {QUANT!r}\nQUANT_STEPS, BLOCK = {QUANT_STEPS}, {BLOCK}\n"
        f"DGT = {DGT!r}\nDGT_CASES = {DGT_CASES!r}\nZERO = {ZERO!r}\n"
        f"ZERO_STEPS, MIN_SHARD = {ZERO_STEPS}, {MIN_SHARD}\n"
        f"DGRAD = {DGRAD!r}\nBN_SHAPE = {BN_SHAPE!r}\nSMALL = {SMALL!r}\n"
        f"RESNET_STEPS = {RESNET_STEPS}\nLR, MOMENTUM = {LR}, {MOMENTUM}\n"
        + textwrap.dedent(JOB))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.Popen([sys.executable, "-m", "horovod_tpu_torch.runner",
                          "-np", str(n), sys.executable, str(script)],
                         cwd=REPO, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True,
                         start_new_session=True)
    return d, p


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Each world's inputs, each rank's results and the JAX references,
    computed while both jobs run."""
    tmp = tmp_path_factory.mktemp("spmd_jobs")
    inps = {n: _inputs(n) for n in WORLDS}
    started = {n: _start(tmp, n, inps[n]) for n in WORLDS}
    try:
        refs = {n: _references(inps[n], n) for n in WORLDS}
        outs = {}
        for n, (d, p) in started.items():
            try:
                outs[n] = p.communicate(timeout=240)[0]
            except subprocess.TimeoutExpired:
                os.killpg(p.pid, signal.SIGKILL)
                raise AssertionError(
                    f"the {n}-rank job timed out:\n{p.communicate()[0]}")
    finally:
        for _, p in started.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
    for n, (d, p) in started.items():
        assert p.returncode == 0, f"the {n}-rank job failed:\n{outs[n]}"
    return {n: (inps[n], [dict(np.load(started[n][0] / f"out.{r}.npz"))
                          for r in range(n)], refs[n]) for n in WORLDS}


def _within(got, want, tol: float, what: str):
    np.testing.assert_allclose(
        got, want, rtol=0, atol=tol * max(float(np.abs(want).max()), 1e-30),
        err_msg=what)


def _bitwise(got, want, what: str):
    assert np.array_equal(np.asarray(got, np.float32).view(np.int32),
                          np.asarray(want, np.float32).view(np.int32)), \
        f"{what}: max |diff| {np.abs(got - want).max()}"


def _fused_check(n, got, want, op, k, what, wire="float32"):
    if n == 2 or op in ("MIN", "MAX"):
        _bitwise(got, want, what)
    else:
        _within(got, want, 2.0 ** -21 if FUSED[k][1] == wire == "float32"
                else 2.0 ** -7, what)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("op", OPS)
def test_fused_tree_allreduce_matches_jax(jobs, n, op):
    """Every op, with and without factors, over fp32 and bf16 leaves:
    bitwise at 2 ranks, MIN and MAX bitwise at 4."""
    _, res, ref = jobs[n]
    for pre, _ in FACTORS:
        want = ref["fused"][f"{op}.{pre}"]
        for r, out in enumerate(res):
            for k in FUSED:
                _fused_check(n, out[f"fused.{op}.{pre}.{k}"], want[k], op,
                             k, f"rank {r} {op} pre {pre} {k}")


@pytest.mark.parametrize("n", WORLDS)
def test_cast_wire_unfused_and_adasum_match_jax(jobs, n):
    """The bf16 cast wire (K2) for SUM and AVERAGE, one call a leaf, and
    ADASUM of the fp32 leaves."""
    _, res, ref = jobs[n]
    for r, out in enumerate(res):
        for op in ("SUM", "AVERAGE"):
            for k in FUSED:
                _fused_check(n, out[f"fused.cast.{op}.{k}"],
                             ref["fused"][f"cast.{op}"][k], op, k,
                             f"rank {r} cast {op} {k}", "bfloat16")
        for k in FUSED:
            _fused_check(n, out[f"fused.unfused.{k}"],
                         ref["fused"]["unfused"][k], "AVERAGE", k,
                         f"rank {r} unfused {k}")
        for k in ("a", "c"):
            np.testing.assert_allclose(out[f"fused.adasum.{k}"],
                                       ref["fused"]["adasum"][k], rtol=1e-5,
                                       atol=1e-6, err_msg=f"adasum {k}")


@pytest.mark.parametrize("n", WORLDS)
def test_allgather_broadcast_reducescatter_match_jax(jobs, n):
    """The thin in-step collectives: JAX's traced allgather, broadcast
    (its masked psum) and reducescatter, SUM and AVERAGE (``/ n``)."""
    _, res, ref = jobs[n]
    for r, out in enumerate(res):
        for k in ("allgather", "broadcast"):
            _bitwise(out["coll." + k], ref["coll"][k], f"rank {r} {k}")
        for k in ("rs_sum", "rs_avg"):
            got, want = out["coll." + k], ref["coll_rank"][k][r]
            if n == 2:
                _bitwise(got, want, f"rank {r} {k}")
            else:
                _within(got, want, 2.0 ** -21, f"rank {r} {k}")


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("bits", (8, 4))
def test_quantized_tree_allreduce_matches_jax(jobs, n, bits):
    """EQuARX with error feedback over 3 steps: the quantized leaves and
    each rank's residual bitwise at both worlds, the leaves that bypass
    the wire as the fused fp32 reduction (bitwise at 2 ranks)."""
    _, res, ref = jobs[n]
    for s in range(QUANT_STEPS):
        want = ref["quant"][f"{bits}.{s}"]
        for r, out in enumerate(res):
            for k in QUANT:
                got = out[f"quant.{bits}.{s}.{k}"]
                what = f"rank {r} int{bits} step {s} {k}"
                if k in ("dense.bias", "small"):
                    _fused_check(n, got, want[k], "SUM", "a", what)
                else:
                    _bitwise(got, want[k], what)
            _bitwise(out[f"quant.{bits}.{s}.res"],
                     ref["quant_res"][f"{bits}.{s}.res"][r],
                     f"rank {r} int{bits} step {s} residual")


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("case", list(DGT_CASES))
def test_distributed_optimizer_matches_optax(jobs, n, case):
    """SGD with momentum through the in-step wrapper against optax's under
    the JAX wrapper, the parameters after every step; a skipped step of
    ``backward_passes_per_step`` leaves them as they were."""
    inp, res, ref = jobs[n]
    steps, passes, _, wire = DGT_CASES[case]
    tol = 2.0 ** -8 if wire == "bf16" and n > 2 else 2.0 ** -20
    for r, out in enumerate(res):
        for s in range(steps):
            for k in DGT:
                got = out[f"dgt.{case}.{s}.{k}"]
                _within(got, ref["dgt"][f"{case}.{s}"][k], tol,
                        f"rank {r} {case} step {s} {k}")
                _bitwise(got, res[0][f"dgt.{case}.{s}.{k}"],
                         f"rank {r} against rank 0, {case} step {s} {k}")
                if passes > 1 and (s + 1) % passes:
                    prev = (out[f"dgt.{case}.{s - 1}.{k}"] if s
                            else inp["dgt.p." + k])
                    _bitwise(got, prev, f"{case} skipped step {s} {k}")


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_flavours_match_jax_and_the_replicated_path(jobs, n):
    """``sharded_update=True`` and ``cross_replica_sharded_optimizer``
    against JAX's after each of 2 steps, and against the port's replicated
    in-step wrapper (bitwise at 2 ranks); JAX's mixed-precision case; the
    inner optimizer's state a rank is the shard's."""
    _, res, ref = jobs[n]
    for r, out in enumerate(res):
        for arm in ("sharded", "cross"):
            for s in range(ZERO_STEPS):
                for k in ZERO:
                    got = out[f"zero.{arm}.{s}.{k}"]
                    _within(got, ref["zero"][f"{arm}.{s}"][k], 2.0 ** -20,
                            f"rank {r} {arm} step {s} {k}")
                    rep = out[f"zero.replicated.{s}.{k}"]
                    if n == 2:
                        _bitwise(got, rep, f"rank {r} {arm} vs replicated")
                    else:
                        _within(got, rep, 2.0 ** -20, f"{arm} vs replicated")
        np.testing.assert_array_equal(out["zero.mixed"],
                                      ref["zero"]["mixed"]["w"])
        np.testing.assert_allclose(out["zero.mixed"], 0.9, rtol=1e-6)
        total = sum(int(np.prod(s)) for s in ZERO.values())
        assert out["zero.replicated.state_bytes"] == 4 * total
        # b (5 elements) stays replicated under MIN_SHARD, w's 65 shard
        assert out["zero.sharded.state_bytes"] == 4 * (5 + -(-65 // n))
        assert out["zero.cross.state_bytes"] == 4 * -(-total // n)


@pytest.mark.parametrize("n", WORLDS)
def test_distributed_grad_and_value_and_grad(jobs, n):
    _, res, ref = jobs[n]
    g, g2, val = ref["dgrad"]
    for r, out in enumerate(res):
        for k in DGRAD:
            np.testing.assert_allclose(out["dgrad.g." + k], g[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
            np.testing.assert_allclose(out["dgrad.vg." + k], g2[k],
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(out["dgrad.loss"], val, rtol=1e-6)


@pytest.mark.parametrize("n", WORLDS)
def test_sync_batch_norm_matches_flax(jobs, n):
    """``moments_sync``, ``sync_batch_stats`` and the module's outputs,
    input gradients and running statistics against flax's BatchNorm with
    ``axis_name`` under ``shard_map``."""
    _, res, ref = jobs[n]
    per_rank, rep = ref["bn"], ref["bn_rep"]
    for r, out in enumerate(res):
        tol = dict(rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out["bn.moments_mean"], rep["mean"], **tol)
        np.testing.assert_allclose(out["bn.moments_var"], rep["var"], **tol)
        np.testing.assert_allclose(out["bn.stats_mean"],
                                   rep["stats"]["mean"], **tol)
        np.testing.assert_allclose(out["bn.stats_var"], rep["stats"]["var"],
                                   **tol)
        np.testing.assert_allclose(out["bn.y"], per_rank["y"][r], **tol)
        np.testing.assert_allclose(out["bn.dx"], per_rank["dx"][r], **tol)
        np.testing.assert_allclose(out["bn.running_mean"],
                                   rep["running"]["mean"], **tol)
        np.testing.assert_allclose(out["bn.running_var"],
                                   rep["running"]["var"], **tol)


def test_resnet_bench_loop_matches_jax(jobs):
    """The slice as a whole: bench_resnet's loop on the reduced ResNet at 2
    ranks, losses and parameters after each of 2 steps (``RESNET_TOL``),
    every rank's parameters bitwise rank 0's."""
    _, res, ref = jobs[2]
    want = ref["resnet"]
    for r, out in enumerate(res):
        for s in range(RESNET_STEPS):
            np.testing.assert_allclose(float(out[f"resnet.loss.{s}"]),
                                       want[f"loss.{s}"],
                                       rtol=RESNET_TOL[s])
            for k, w in want[f"params.{s}"].items():
                _within(out[f"resnet.{s}.{k}"], w, RESNET_TOL[s],
                        f"rank {r} step {s} {k}")
                _bitwise(out[f"resnet.{s}.{k}"], res[0][f"resnet.{s}.{k}"],
                         f"rank {r} against rank 0, step {s} {k}")


@pytest.mark.parametrize("n", WORLDS)
def test_in_step_path_never_enqueues_on_the_runtime(jobs, n):
    for out in jobs[n][1]:
        assert out["runtime.same"]
        assert int(out["runtime.spmd_all_reduce"]) == 1
