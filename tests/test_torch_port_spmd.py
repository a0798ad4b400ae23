"""The in-step optimizer layer in one process (``horovod_tpu_torch/opt``,
the in-step collectives of ``horovod_tpu_torch/ops/collectives.py``),
against the JAX package's ``horovod_tpu/opt`` on the CPU. The
multi-process cases are in ``test_torch_port_spmd_jobs.py``.

- EQuARX's schedule at 2, 3 and 4 virtual ranks (the phases of
  ``collectives.quantized_allreduce`` with the exchanges as list
  operations, ``torch_port_spmd_support.simulate_equarx``) against JAX's
  ``quantized_allreduce`` under ``shard_map``, int8 and int4, with a
  prescale, a postscale and a residual: the outputs and every rank's
  residual bitwise at 2 and 4 ranks (the prescale and the residual are one
  FMA in both, the mean of a power-of-two n one product); at 3 the mean
  is ``sum * fp32(1/3)`` against XLA's ``sum / 3``, so the outputs within
  one quantization step of the largest block, the residuals bitwise;
- ``quant_residual_init`` and the partition of ResNet-50's full-width
  parameters (names and shapes only, ``device="meta"``) against JAX's
  ``_quant_partition`` of the flax model's ``jax.eval_shape``: the same
  leaves on the wire, for the same reasons;
- the refusals with JAX's messages, ``HOROVOD_SHARDED_UPDATE``, the
  runtime group refused, and the sharded flavour's layout digest equal to
  JAX's planner's;
- at a world of one (gloo): the plain, int8 (no wire at one rank, as
  JAX) and sharded flavours bitwise plain SGD; ``backward_passes_per_step``
  leaving the parameters and the inner state alone on skipped steps;
  ``state_dict`` round trips; the runtime's counters unmoved;
  ``DataParallelStep.group``; the trees' names and structure.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import horovod_tpu.opt as jopt
import horovod_tpu_torch as hvd
from horovod_tpu.models import resnet as R
from horovod_tpu.ops import collectives as JC
from horovod_tpu.ops import compression as jcomp
from horovod_tpu_torch import opt as O
from horovod_tpu_torch.common import context
from horovod_tpu_torch.models import resnet as PR
from horovod_tpu_torch.ops import collectives as C
from horovod_tpu_torch.ops import compression as comp
from horovod_tpu_torch.parallel import data_parallel_step
from torch_port_spmd_support import mesh, simulate_equarx

LR, MOMENTUM = 0.05, 0.9


@pytest.fixture(scope="module")
def port():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    hvd.init(device="cpu")
    yield
    hvd.shutdown()
    torch.set_num_threads(n)


def _sgd(ps):
    return torch.optim.SGD(ps, lr=LR, momentum=MOMENTUM)


# --- EQuARX, simulated -------------------------------------------------------


@pytest.mark.parametrize("n", (2, 3, 4))
@pytest.mark.parametrize("bits", (8, 4))
def test_equarx_schedule_matches_jax(n, bits):
    rs = np.random.RandomState(10 * n + bits)
    sizes = (3000, 1000, 777)
    size = sum(sizes)
    xs = rs.randn(n, size).astype(np.float32)
    res = (0.01 * rs.randn(n, size)).astype(np.float32)
    pre, post = 0.7, 1.3
    jspec = jcomp.make_quant_spec(bits, 256, True)

    def per_rank(x, r):
        red, err = JC.quantized_allreduce(x[0], "hvd", jspec,
                                          prescale_factor=pre,
                                          postscale_factor=post,
                                          residual=r[0])
        return red, err[None]

    want, want_err = jax.jit(jax.shard_map(
        per_rank, mesh=mesh(n), in_specs=(P("hvd"), P("hvd")),
        out_specs=(P(), P("hvd")), check_vma=False))(jnp.asarray(xs),
                                                     jnp.asarray(res))
    spec = comp.make_quant_spec(bits, 256, True)
    rank_tensors = [list(torch.split(torch.from_numpy(x), sizes))
                    for x in xs]
    outs, errs = simulate_equarx(rank_tensors, spec, True, pre, post,
                                 [torch.from_numpy(r) for r in res])
    want = np.asarray(want)
    for r in range(n):
        got = torch.cat(outs[r]).numpy()
        if n & (n - 1):
            scale = np.abs(want).max() / spec.qmax
            np.testing.assert_allclose(got, want, rtol=0, atol=scale)
        else:
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))
        np.testing.assert_array_equal(errs[r].numpy().view(np.int32),
                                      np.asarray(want_err)[r].view(np.int32))


# --- the partition and the residuals ----------------------------------------


def _jax_reasons(tree) -> dict:
    """JAX's fallback reason (None: on the wire) of every leaf of a tree of
    shapes, by keystr: ``_quant_partition``'s rule (``opt/__init__.py``
    :74-97) without the arrays it would build."""
    pats, mn = jcomp.quant_optout_patterns(), jcomp.quant_min_elems()
    return {jax.tree_util.keystr(p): jcomp.quant_fallback_reason(
        jax.tree_util.keystr(p), int(np.prod(s.shape)), s.dtype, pats, mn)
        for p, s in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_resnet50_partition_matches_jax():
    """ResNet-50 at full width: the port's parameter names and JAX's
    ``keystr`` paths put the same leaves on the wire, each fallback for
    the same reason."""
    model = R.ResNet50(num_classes=1000)
    shapes = jax.eval_shape(
        lambda x: model.init(jax.random.PRNGKey(0), x, train=True),
        jax.ShapeDtypeStruct((1, 224, 224, 3), jnp.float32))
    reasons = _jax_reasons(shapes["params"])
    codes = {None: 0, "small_leaf": 1, "optout_match": 2, "non_float": 3}
    # JAX's reason of each leaf carried to the port's name by the loader
    coded = jax.tree_util.tree_map_with_path(
        lambda p, s: np.full(s.shape, codes[reasons[
            jax.tree_util.keystr(p)]], np.float32), shapes["params"])
    stats = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                         shapes["batch_stats"])
    want = {k: int(v.reshape(-1)[0]) for k, v in
            PR.params_from_jax(coded, stats).items() if "running" not in k}
    port = PR.ResNet([3, 4, 6, 3], num_classes=1000, device="meta")
    names, leaves = zip(*port.named_parameters())
    elig, plain = O._quant_partition(names, leaves)
    pats, mn = comp.quant_optout_patterns(), comp.quant_min_elems()
    got = {}
    for i, (k, t) in enumerate(zip(names, leaves)):
        reason = None if i in elig else comp.quant_fallback_reason(
            k, t.numel(), t.dtype, pats, mn)
        got[k] = codes[reason]
    assert got == want
    assert len(elig) == sum(v == 0 for v in want.values()) > 0
    assert len(elig) + len(plain) == 161


def test_quant_residual_init_matches_jax():
    rs = np.random.RandomState(0)
    shapes = {"conv.kernel": (64, 80), "dense.bias": (5000,),
              "dense.kernel": (96, 50), "small": (100,), "step": (5000,)}
    tree = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    tree["step"] = np.arange(5000, dtype=np.int32)
    spec = jcomp.make_quant_spec(8, 256, True)
    want = jopt.quant_residual_init({k: jnp.asarray(v) for k, v in
                                     tree.items()}, spec)
    got = O.quant_residual_init({k: torch.from_numpy(v) for k, v in
                                 tree.items()})
    assert {k: (v.shape, str(v.dtype)) for k, v in want.items()} == \
        {k: (tuple(v.shape), str(v.dtype).rsplit(".")[-1])
         for k, v in got.items()}
    assert got["float32"].abs().sum() == 0


def test_fallbacks_count_once_a_leaf(port):
    from horovod_tpu_torch.utils import metrics

    reg = metrics.get_registry()

    def counts():
        return {r: reg.counter_value("hvd_quant_fallback_total", reason=r)
                for r in ("small_leaf", "optout_match", "non_float")}

    before = counts()
    ps = [("w", torch.nn.Parameter(torch.zeros(5000))),
          ("layer.bias", torch.nn.Parameter(torch.zeros(5000))),
          ("tiny", torch.nn.Parameter(torch.zeros(10)))]
    opt = O.DistributedOptimizer(_sgd, ps, compression=O.Compression.int8)
    for _ in range(3):
        opt.step([torch.ones(5000), torch.ones(5000), torch.ones(10)])
    after = counts()
    assert {r: after[r] - before[r] for r in after} == {
        "small_leaf": 1, "optout_match": 1, "non_float": 0}


# --- refusals -----------------------------------------------------------------


def _jax_refusal(**kw) -> str:
    with pytest.raises(ValueError) as e:
        jopt.DistributedGradientTransformation(optax.sgd(0.1), **kw)
    return str(e.value)


@pytest.mark.parametrize("kw", [
    dict(sharded_update=True, backward_passes_per_step=2),
    dict(sharded_update=True, compression="bf16"),
    dict(compression="int8", backward_passes_per_step=2)],
    ids=["sharded-bpps", "sharded-compression", "ef-bpps"])
def test_refusals_match_jax(port, kw):
    jkw, pkw = dict(kw), dict(kw)
    if "compression" in kw:
        jkw["compression"] = getattr(jcomp.Compression, kw["compression"])
        pkw["compression"] = getattr(O.Compression, kw["compression"])
    want = _jax_refusal(**jkw)
    with pytest.raises(ValueError) as e:
        O.DistributedGradientTransformation(
            _sgd, [("w", torch.nn.Parameter(torch.zeros(4)))], **pkw)
    assert str(e.value) == want


def test_sharded_update_reads_the_knob(port, monkeypatch):
    ps = [("w", torch.nn.Parameter(torch.zeros(40)))]
    monkeypatch.setenv("HOROVOD_SHARDED_UPDATE", "1")
    assert isinstance(O.DistributedOptimizer(_sgd, ps),
                      O.ShardedDistributedOptimizer)
    monkeypatch.setenv("HOROVOD_SHARDED_UPDATE", "0")
    assert isinstance(O.DistributedOptimizer(_sgd, ps), O.InStepOptimizer)


def test_runtime_group_is_refused(port):
    with pytest.raises(ValueError, match="runtime_group"):
        C.spmd_allreduce(torch.ones(3),
                         group=hvd.global_process_set().runtime_group)


# --- a world of one -------------------------------------------------------------


def _model(seed=0):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(70, 80), torch.nn.Tanh(),
                               torch.nn.Linear(80, 3))


def _batches(k):
    g = torch.Generator().manual_seed(1)
    return [(torch.randn(6, 70, generator=g), torch.randn(6, 3, generator=g))
            for _ in range(k)]


def _loss(m, batch):
    x, y = batch
    return ((m(x) - y) ** 2).mean()


def _run(make, steps=3):
    m = _model()
    opt = make(m)
    for b in _batches(steps):
        opt.zero_grad()
        _loss(m, b).backward()
        opt.step()
    return [p.detach().clone() for p in m.parameters()]


@pytest.mark.parametrize("flavour", ["plain", "int8", "int4", "bf16",
                                     "sharded", "cross"])
def test_world_of_one_is_plain_sgd(port, flavour):
    """At one rank every flavour is the inner optimizer's own step, bit
    for bit (AVERAGE over one is the identity; the quantized wire sends
    nothing at one rank, as JAX's; the bf16 cast wire rounds the
    gradients to bf16, so it is held against SGD on bf16-rounded
    gradients)."""
    want = (_run(lambda m: _sgd(m.parameters())) if flavour != "bf16"
            else None)
    kw = {"plain": {}, "int8": dict(compression=O.Compression.int8),
          "int4": dict(compression=O.Compression.int4),
          "bf16": dict(compression=O.Compression.bf16),
          "sharded": dict(sharded_update=True, min_shard_elems=100)}
    if flavour == "cross":
        got = _run(lambda m: O.cross_replica_sharded_optimizer(
            _sgd, 1, m.named_parameters()))
    else:
        got = _run(lambda m: O.DistributedOptimizer(
            _sgd, m.named_parameters(), **kw[flavour]))
    if flavour == "bf16":
        class Rounded:
            def __init__(self, m):
                self.inner = _sgd(m.parameters())
                self.m = m

            def zero_grad(self):
                self.inner.zero_grad()

            def step(self):
                for p in self.m.parameters():
                    p.grad = p.grad.bfloat16().float()
                self.inner.step()

        want = _run(Rounded)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("average", [True, False])
def test_backward_passes_per_step(port, average):
    """Two passes accumulate in the wrapper: the first step leaves the
    parameters and the inner state alone, the second applies the summed
    (or averaged) gradients; ``.grad`` is the user's to zero."""
    m = _model()
    opt = O.DistributedOptimizer(_sgd, m.named_parameters(),
                                 backward_passes_per_step=2,
                                 average_aggregated_gradients=average)
    ref = _model()
    ref_opt = _sgd(ref.parameters())
    b1, b2 = _batches(2)
    p0 = [p.detach().clone() for p in m.parameters()]
    opt.zero_grad()
    _loss(m, b1).backward()
    assert opt.step() is False
    assert all(torch.equal(p, q) for p, q in zip(m.parameters(), p0))
    assert not opt.optimizer.state
    opt.zero_grad()
    _loss(m, b2).backward()
    assert opt.step() is True
    ref_opt.zero_grad()
    _loss(ref, b1).backward()
    _loss(ref, b2).backward()
    if average:
        for p in ref.parameters():
            p.grad = p.grad * 0.5
    ref_opt.step()
    for p, q in zip(m.parameters(), ref.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=1e-7)
    assert opt.counter == 0


def test_state_dict_round_trip(port):
    """A wrapper loaded from another's ``state_dict`` mid-run (inner
    momentum, the accumulator and its counter, the residuals) continues
    bitwise as the original; one loaded from a fresh state drops its
    partial sums and residuals."""
    batches = _batches(5)
    for kw in (dict(compression=O.Compression.int8),
               dict(backward_passes_per_step=2)):
        a, b = _model(), _model()
        oa = O.DistributedOptimizer(_sgd, a.named_parameters(), **kw)
        for bt in batches[:3]:
            oa.zero_grad()
            _loss(a, bt).backward()
            oa.step()
        b.load_state_dict(a.state_dict())
        ob = O.DistributedOptimizer(_sgd, b.named_parameters(), **kw)
        ob.load_state_dict(oa.state_dict())
        for bt in batches[3:]:
            for m, o in ((a, oa), (b, ob)):
                o.zero_grad()
                _loss(m, bt).backward()
                o.step()
        assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                     b.parameters()))
    # a fresh state (no accumulator) loaded partway through an
    # accumulation continues as a fresh wrapper
    kw = dict(backward_passes_per_step=2)
    a = _model()
    oa = O.DistributedOptimizer(_sgd, a.named_parameters(), **kw)
    oa.zero_grad()
    _loss(a, batches[0]).backward()
    assert not oa.step()
    fresh = O.DistributedOptimizer(_sgd, _model().named_parameters())
    oa.load_state_dict(fresh.state_dict())
    b = _model()
    b.load_state_dict(a.state_dict())
    ob = O.DistributedOptimizer(_sgd, b.named_parameters(), **kw)
    for bt in batches[1:]:
        for m, o in ((a, oa), (b, ob)):
            o.zero_grad()
            _loss(m, bt).backward()
            o.step()
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))
    # and one without residuals zeroes the feedback (a world of one puts
    # nothing on the wire, so the residuals are set by hand)
    oa = O.DistributedOptimizer(_sgd, _model().named_parameters(),
                                compression=O.Compression.int8)
    shapes = {k: v.shape for k, v in oa.residuals.items()}
    assert shapes
    for v in oa.residuals.values():
        v.fill_(1.0)
    oa.load_state_dict(fresh.state_dict())
    assert {k: v.shape for k, v in oa.residuals.items()} == shapes
    assert all(not v.any() for v in oa.residuals.values())


def test_in_step_step_never_enqueues(port):
    rt = context.runtime()
    m = _model()
    opt = O.DistributedOptimizer(_sgd, m.named_parameters())
    calls = dict(C.spmd_calls)
    before = (rt.chunks, rt.work_cycles, rt.collective_calls, C.dist_calls)
    _loss(m, _batches(1)[0]).backward()
    opt.step()
    assert (rt.chunks, rt.work_cycles, rt.collective_calls,
            C.dist_calls) == before
    assert C.spmd_calls["all_reduce"] == calls["all_reduce"] + 1


def test_data_parallel_step_exposes_the_group(port):
    step = data_parallel_step(lambda *a: None)
    assert step.group is hvd.global_process_set().group
    assert step.process_set is hvd.global_process_set()


def test_tree_helpers():
    t = {"a": torch.ones(2), "b": [torch.zeros(3), {"c": torch.ones(1)}],
         "d": (torch.ones(4), None)}
    names, leaves, spec = O.tree_flatten(t)
    assert names == ["a", "b.0", "b.1.c", "d.0", "d.1"]
    back = O.tree_unflatten(spec, leaves)
    assert back["b"][1]["c"] is t["b"][1]["c"] and back["d"][1] is None
    assert isinstance(back["d"], tuple)


def test_sharded_layout_digest_is_the_jax_planners(port):
    """``ShardedDistributedOptimizer``'s layout is JAX's traced flavour's
    (``plan_shard_layout`` at generation 0), digest for digest, for the
    same leaves in the same order."""
    from horovod_tpu.opt import sharded as jsharded

    shapes = {"a": (300,), "b": (7,), "c": (40, 50)}
    ps = [(k, torch.nn.Parameter(torch.zeros(s))) for k, s in shapes.items()]
    opt = O.DistributedOptimizer(_sgd, ps, sharded_update=True,
                                 min_shard_elems=64)
    want = jsharded.plan_shard_layout(
        {k: jnp.zeros(s) for k, s in shapes.items()}, 1, min_shard_elems=64,
        generation=0)
    assert opt.layout.digest == want.digest
    assert opt.layout.replicated == want.replicated == (1,)
