"""The port's ZeRO-1 sharded update against the JAX package's, on the CPU:

- the sharding policy (``shard_dim``, ``should_shard``,
  ``assign_owners``) on the JAX test's ``SHAPE_GRID`` and on random sizes;
- ``plan_shard_layout``: every field and the digest string-equal to the
  JAX planner's for fp32, bf16 and mixed pytrees (the port given the JAX
  pytree's leaves in ``jax.tree.leaves`` order), worlds 1-5, two
  thresholds, and the threshold read from ``HOROVOD_SHARDED_MIN_ELEMS``;
- the shard plans: the pack and the allgather-unpack bitwise the JAX
  plans', the simulated reduce-scatter's shards bitwise
  ``sharded_reduce_scatter_plan(None, ...)``'s at worlds 2-4, SUM and
  AVERAGE, with and without factors (XLA contracts the prescale into the
  sum and folds AVERAGE's 1/n into the postscale: ``sim_reduce``);
- simulated engines (``make_simulated_engines``, ``simulated_step``)
  bitwise equal to the port's replicated update over the same reduce, in
  fp32 with SGD and momentum and with Adam, at worlds 2 and 3; bf16 within
  a stated tolerance;
- the port's ``simulated_step`` within a stated tolerance of the JAX
  ``simulated_step`` (optax ``sgd(momentum=0.9)`` and ``adam`` against
  torch's ``SGD`` and ``Adam``: the same updates, rounded otherwise);
- the ZeRO-1 ledger (state bytes under 0.62 of the replicated state at
  world 2), a plan hit rate of 1.0 in the steady state, plan keys that
  change with the elastic generation and the digest, the wire-byte
  counters by phase;
- a simulated 2 -> 3 resize through ``simulated_full_state`` and
  ``load_full_state``, bitwise the replicated run;
- the front end at world 1: ``DistributedOptimizer(sharded_update=True)``
  bitwise the plain wrapper, its class name, and its owners equal to the
  JAX ``assign_owners`` and to the JAX shim's own table.

Mirrors ``tests/test_sharded_update.py``. The multi-process jobs are in
``tests/test_torch_port_sharded_jobs.py``.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.ops import collectives as jcoll
from horovod_tpu.opt import sharded as jsharded
from horovod_tpu.parallel import sharding_policy as jpolicy
from horovod_tpu_torch.ops import collectives as pcoll
from horovod_tpu_torch.opt import sharded as psharded
from horovod_tpu_torch.parallel import sharding_policy as ppolicy
from horovod_tpu_torch.utils import metrics as pmetrics


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_knobs(monkeypatch):
    for k in ("HOROVOD_SHARDED_UPDATE", "HOROVOD_SHARDED_MIN_ELEMS",
              "HOROVOD_ELASTIC_GEN", "HOROVOD_COMPRESSION"):
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(scope="module")
def port():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def _to_np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _from_np(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[a.itemsize])


def _same_bits(a, b) -> bool:
    return a.shape == b.shape and np.array_equal(_bits(a), _bits(b))


# --- the sharding policy ------------------------------------------------------

SHAPE_GRID = [
    (), (1,), (37,), (2048,), (16384,), (128, 128), (128, 129),
    (256, 256), (3, 3, 64, 64), (7, 11), (8, 2048), (5, 3, 2),
]


@pytest.mark.parametrize("mse", [None, 50, 2 ** 10])
@pytest.mark.parametrize("axis_size", [None, 2, 8])
def test_shard_dim_and_should_shard_match_jax(axis_size, mse):
    kw = {} if mse is None else {"min_shard_elems": mse}
    for shape in SHAPE_GRID:
        assert (ppolicy.shard_dim(shape, axis_size=axis_size, **kw)
                == jpolicy.shard_dim(shape, axis_size=axis_size, **kw)), shape
        assert (ppolicy.should_shard(shape, **kw)
                == jpolicy.should_shard(shape, **kw)), shape
    assert ppolicy.DEFAULT_MIN_SHARD_ELEMS == jpolicy.DEFAULT_MIN_SHARD_ELEMS


@pytest.mark.parametrize("seed", range(4))
def test_assign_owners_matches_jax_on_random_sizes(seed):
    rs = np.random.RandomState(seed)
    sizes = [int(s) for s in rs.choice(
        [0, 1, 5, 2048, 16383, 16384, 16385, 65536, 4096 * 4096],
        size=rs.randint(1, 40))]
    sizes += [int(s) for s in rs.randint(1, 200000, size=20)]
    for world in range(1, 6):
        for mse in (None, 1000, 2 ** 14):
            kw = {} if mse is None else {"min_shard_elems": mse}
            assert (ppolicy.assign_owners(sizes, world, **kw)
                    == jpolicy.assign_owners(sizes, world, **kw))


# --- the layout planner ---------------------------------------------------------

def _pytree(kind: str):
    """A JAX pytree (numpy leaves) with shardable and small leaves."""
    r = np.random.RandomState(0)
    bf = ml_dtypes.bfloat16
    if kind == "fp32":
        dt = {k: np.float32 for k in "abcdef"}
    elif kind == "bf16":
        dt = {k: bf for k in "abcdef"}
    else:  # mixed, dtype groups out of leaf order
        dt = {"a": bf, "b": np.float32, "c": np.float16, "d": bf,
              "e": np.float32, "f": np.float32}
    return {
        "w1": r.randn(256, 256).astype(dt["a"]),
        "b1": r.randn(256).astype(dt["b"]),
        "blocks": [{"w": r.randn(64, 300).astype(dt["c"]),
                    "scale": np.asarray(1.5, dt["d"])},
                   {"w": r.randn(130, 129).astype(dt["d"]),
                    "scale": r.randn(64).astype(dt["e"])}],
        "big": r.randn(16385).astype(dt["e"]),
        "emb": r.randn(40, 1000).astype(dt["f"]),
    }


def _port_leaves(tree):
    return [_from_np(x) for x in jax.tree.leaves(tree)]


def _layout_fields(lay) -> tuple:
    return (lay.world_size, lay.generation, lay.min_shard_elems,
            lay.num_leaves,
            tuple((g.dtype, g.indices, g.sizes, g.shapes, g.total,
                   g.shard_elems, lay.group_padded(g)) for g in lay.groups),
            lay.replicated, lay.replicated_elems, lay.replicated_bytes,
            lay.sharded_elems, lay.shard_elems, lay.total_elems,
            lay.shard_fraction, lay.digest)


@pytest.mark.parametrize("mse", [2 ** 14, 5000])
@pytest.mark.parametrize("kind", ["fp32", "bf16", "mixed"])
def test_layout_and_digest_match_jax(kind, mse):
    tree = _pytree(kind)
    leaves = _port_leaves(tree)
    for world in range(1, 6):
        for gen in (0, 3):
            want = jsharded.plan_shard_layout(tree, world,
                                              min_shard_elems=mse,
                                              generation=gen)
            got = psharded.plan_shard_layout(leaves, world,
                                             min_shard_elems=mse,
                                             generation=gen)
            assert _layout_fields(got) == _layout_fields(want), (world, gen)
    if kind == "mixed":
        assert [g.dtype for g in got.groups] == sorted(
            {"bfloat16", "float32", "float16"})


def test_layout_reads_threshold_and_generation_from_env(monkeypatch):
    tree = _pytree("fp32")
    leaves = _port_leaves(tree)
    monkeypatch.setenv("HOROVOD_SHARDED_MIN_ELEMS", "300")
    monkeypatch.setenv("HOROVOD_ELASTIC_GEN", "4")
    got = psharded.plan_shard_layout(leaves, 3)
    want = jsharded.plan_shard_layout(tree, 3, min_shard_elems=300,
                                      generation=4)
    assert got.min_shard_elems == 300 and got.generation == 4
    assert got.digest == want.digest
    # every layout input is digest-visible
    base = psharded.plan_shard_layout(leaves, 2, generation=0)
    for other in (psharded.plan_shard_layout(leaves, 4, generation=0),
                  psharded.plan_shard_layout(leaves, 2, generation=1),
                  psharded.plan_shard_layout(leaves, 2, generation=0,
                                             min_shard_elems=2 ** 10)):
        assert other.digest != base.digest


# --- the shard plans ---------------------------------------------------------------

@pytest.mark.parametrize("world", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", ["fp32", "bf16"])
def test_pack_and_allgather_plans_match_jax(kind, world):
    tree = _pytree(kind)
    jleaves = jax.tree.leaves(tree)
    leaves = _port_leaves(tree)
    lay = psharded.plan_shard_layout(leaves, world, generation=0)
    for g in lay.groups:
        jpack = jcoll.sharded_pack_plan(None, world, g.sizes, g.shapes,
                                        g.dtype, g.shard_elems, lay.digest)
        want = np.asarray(jpack(*[jleaves[i] for i in g.indices]))
        pack = pcoll.sharded_pack_plan(None, world, g.sizes, g.shapes,
                                       g.torch_dtype, g.shard_elems,
                                       lay.digest)
        flat = pack.execute([leaves[i] for i in g.indices])
        assert _same_bits(_to_np(flat), want)
        # each rank's shard of the leaves is its slice of the flat
        for r in range(world):
            shard = torch.full((g.shard_elems,), 7.0, dtype=g.torch_dtype)
            pack.pack_shard([leaves[i] for i in g.indices], r, shard)
            lo = r * g.shard_elems
            assert torch.equal(shard, flat[lo:lo + g.shard_elems])
        jag = jcoll.sharded_allgather_plan(None, world, g.sizes, g.shapes,
                                           g.dtype, g.shard_elems,
                                           lay.digest)
        parts = jag(jnp.asarray(want).reshape(world, g.shard_elems))
        ag = pcoll.sharded_allgather_plan(None, world, g.sizes, g.shapes,
                                          g.torch_dtype, g.shard_elems,
                                          lay.digest)
        outs = [torch.empty(s, dtype=g.torch_dtype) for s in g.shapes]
        ag.simulate([flat[r * g.shard_elems:(r + 1) * g.shard_elems]
                     for r in range(world)], outs)
        for o, p in zip(outs, parts):
            assert _same_bits(_to_np(o), np.asarray(p))


RS_FACTORS = [(1.0, 1.0), (0.7, 1.0), (1.0, 0.3), (0.7, 0.3), (2.0, 0.5)]


@pytest.mark.parametrize("pre,post", RS_FACTORS)
@pytest.mark.parametrize("op", [pcoll.ReduceOp.SUM, pcoll.ReduceOp.AVERAGE],
                         ids=["SUM", "AVERAGE"])
@pytest.mark.parametrize("world", [2, 3, 4])
def test_reduce_scatter_plan_matches_jax_bitwise(world, op, pre, post):
    S = 1537
    G = np.random.RandomState(world * 10 + int(op)).randn(
        world, world * S).astype(np.float32)
    flats = [torch.from_numpy(G[r].copy()) for r in range(world)]
    for rank in range(world):
        jrs = jcoll.sharded_reduce_scatter_plan(None, world, rank, op, S,
                                                "float32", "d", pre, post)
        want = np.asarray(jrs(jnp.asarray(G)))
        rs = pcoll.sharded_reduce_scatter_plan(None, world, rank, op, S,
                                               torch.float32, "d", pre,
                                               post)
        assert rs.pack_factor == 1.0  # the simulated reduce applies it
        got = rs.simulate(flats)
        assert _same_bits(got.numpy(), want), rank


def test_sharded_plans_hit_and_key_on_generation_and_digest(monkeypatch):
    reg = pmetrics.get_registry()

    def counts():
        return (reg.counter_value("hvd_sharded_plan_hits_total"),
                reg.counter_value("hvd_sharded_plan_misses_total"))

    monkeypatch.setenv("HOROVOD_ELASTIC_GEN", "0")
    args = (None, 2, (16384,), ((16384,),), torch.float32, 8192,
            "deadbeef")
    pcoll.sharded_pack_plan(*args)
    h0, m0 = counts()
    pcoll.sharded_pack_plan(*args)
    h1, m1 = counts()
    assert (h1 - h0, m1 - m0) == (1, 0)
    monkeypatch.setenv("HOROVOD_ELASTIC_GEN", "7")
    pcoll.sharded_pack_plan(*args)
    h2, m2 = counts()
    assert (h2 - h1, m2 - m1) == (0, 1)
    pcoll.sharded_pack_plan(*args[:-1], "cafef00d")
    pcoll.sharded_allgather_plan(*args[:-1], "cafef00d")
    pcoll.sharded_reduce_scatter_plan(None, 2, 0, pcoll.ReduceOp.AVERAGE,
                                      8192, torch.float32, "cafef00d")
    h3, m3 = counts()
    assert (h3 - h2, m3 - m2) == (0, 3)
    # the plain fused plans' counters do not move
    assert reg.counter_value("hvd_sharded_plan_hits_total") == h3


# --- simulated engines --------------------------------------------------------------

def _params(dtype=torch.float32):
    """A mixed list of leaves: two shardable matrices and one shardable
    vector, with a bias, a small matrix and a scalar on the allreduce
    path (the JAX test's ``_params``, in its leaf order)."""
    r = np.random.RandomState(0)
    tree = {"w1": r.randn(256, 256), "b1": r.randn(256),
            "w2": r.randn(64, 64), "big": r.randn(16384),
            "scale": np.asarray(1.5)}
    return [torch.from_numpy(np.asarray(x, np.float32)).to(dtype)
            for x in jax.tree.leaves(tree)]


def _grads(params, world, step):
    return [[torch.from_numpy(np.random.RandomState(97 * step + r)
                              .standard_normal(tuple(p.shape))
                              .astype(np.float32)).to(p.dtype)
             for p in params] for r in range(world)]


SGD = lambda ps: torch.optim.SGD(ps, lr=1e-2, momentum=0.9)  # noqa: E731
ADAM = lambda ps: torch.optim.Adam(ps, lr=1e-3)  # noqa: E731


class _Replicated:
    """The port's replicated update: every leaf's gradients reduced by
    the same ``sim_reduce``, then the whole optimizer step."""

    def __init__(self, make, params):
        self.params = [p.clone() for p in params]
        self.opt = make(self.params)

    def step(self, grads_per_rank, op=pcoll.ReduceOp.AVERAGE, pre=1.0,
             post=1.0):
        for i, p in enumerate(self.params):
            p.grad = pcoll.sim_reduce([g[i] for g in grads_per_rank], op,
                                      pre, post)
        self.opt.step()


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("make", [SGD, ADAM], ids=["sgd_momentum", "adam"])
def test_simulated_engines_bitwise_replicated_fp32(make, world):
    params = _params()
    engines = psharded.make_simulated_engines(make, world)
    sp = [p.clone() for p in params]
    for e in engines:
        e.init(sp)
    rep = _Replicated(make, params)
    for step in range(5):
        gs = _grads(params, world, step)
        psharded.simulated_step(engines, sp, gs)
        rep.step(gs)
        for i, (a, b) in enumerate(zip(sp, rep.params)):
            assert torch.equal(a, b), (step, i)


def test_simulated_engines_with_factors_and_sum_bitwise_replicated():
    params = _params()
    kw = dict(op=pcoll.ReduceOp.SUM, prescale_factor=0.7,
              postscale_factor=0.3)
    engines = psharded.make_simulated_engines(SGD, 3, **kw)
    sp = [p.clone() for p in params]
    for e in engines:
        e.init(sp)
    rep = _Replicated(SGD, params)
    for step in range(3):
        gs = _grads(params, 3, step)
        psharded.simulated_step(engines, sp, gs)
        rep.step(gs, pcoll.ReduceOp.SUM, 0.7, 0.3)
    assert all(torch.equal(a, b) for a, b in zip(sp, rep.params))


# bf16 leaves: the reduce and the step round to bf16 in other places than
# an fp32 replica would; the JAX test's band
BF16_TOL = 0.05


def test_simulated_engines_bf16_within_tolerance():
    params = _params(torch.bfloat16)
    engines = psharded.make_simulated_engines(SGD, 2)
    sp = [p.clone() for p in params]
    for e in engines:
        e.init(sp)
    rep = _Replicated(SGD, params)
    for step in range(3):
        gs = _grads(params, 2, step)
        psharded.simulated_step(engines, sp, gs)
        rep.step(gs)
    assert all(p.dtype == torch.bfloat16 for p in sp)
    for a, b in zip(sp, rep.params):
        torch.testing.assert_close(a.float(), b.float(), rtol=BF16_TOL,
                                   atol=BF16_TOL)


# torch's SGD and Adam against optax's: the same updates, rounded in
# another order (torch adds ``-lr * buf`` in one FMA, optax scales the
# update first; Adam's bias corrections are applied in another order), so
# parameters part by a few fp32 ulps a step
OPTAX_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("name", ["sgd_momentum", "adam"])
def test_simulated_step_within_tolerance_of_jax(name, world):
    jopt, make = {"sgd_momentum": (optax.sgd(1e-2, momentum=0.9), SGD),
                  "adam": (optax.adam(1e-3), ADAM)}[name]
    r = np.random.RandomState(0)
    tree = {"w1": r.randn(256, 256), "b1": r.randn(256),
            "w2": r.randn(64, 64), "big": r.randn(16384),
            "scale": np.asarray(1.5)}
    tree = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), tree)
    jengines = jsharded.make_simulated_engines(jopt, world)
    jstates = [e.init(tree) for e in jengines]
    engines = psharded.make_simulated_engines(make, world)
    sp = [torch.from_numpy(np.array(x)) for x in jax.tree.leaves(tree)]
    for e in engines:
        e.init(sp)
    jp = tree
    for step in range(4):
        gs = _grads(sp, world, step)
        jgs = [jax.tree.unflatten(jax.tree.structure(tree),
                                  [jnp.asarray(t.numpy()) for t in g])
               for g in gs]
        jp, jstates = jsharded.simulated_step(jengines, jp, jgs, jstates)
        psharded.simulated_step(engines, sp, gs)
    assert engines[0].layout.digest == jengines[0].layout.digest
    for a, b in zip(sp, jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **OPTAX_TOL)


def test_state_is_sharded_and_plans_hit_in_steady_state():
    params = _params()
    engines = psharded.make_simulated_engines(ADAM, 2)
    sp = [p.clone() for p in params]
    for e in engines:
        e.init(sp)
    rep = _Replicated(ADAM, params)
    reg = pmetrics.get_registry()

    def counts():
        return (reg.counter_value("hvd_sharded_plan_hits_total"),
                reg.counter_value("hvd_sharded_plan_misses_total"))

    def wire():
        return {ph: reg.counter_value("hvd_sharded_update_wire_bytes_total",
                                      phase=ph)
                for ph in ("reduce_scatter", "allgather", "allreduce")}

    for step in range(2):  # warm-up: builds the plans
        gs = _grads(params, 2, step)
        psharded.simulated_step(engines, sp, gs)
        rep.step(gs)
    (h0, m0), w0 = counts(), wire()
    for step in range(2, 5):
        psharded.simulated_step(engines, sp, _grads(params, 2, step))
    (h1, m1), w1 = counts(), wire()
    assert m1 == m0 and h1 > h0
    assert (h1 - h0) / ((h1 - h0) + (m1 - m0)) == 1.0
    lay = engines[0].layout
    assert lay.shard_fraction > 0.9
    state = psharded.optimizer_state_bytes(engines[0].optimizer)
    full = psharded.optimizer_state_bytes(rep.opt)
    assert state < 0.62 * full, (state, full)
    # ring accounting: 3 steps x 2 engines, (n-1)/n of each padded buffer
    padded = sum(lay.group_padded(g) * 4 for g in lay.groups)
    assert w1["reduce_scatter"] - w0["reduce_scatter"] == 6 * padded // 2
    assert w1["allgather"] - w0["allgather"] == 6 * padded // 2
    assert (w1["allreduce"] - w0["allreduce"]
            == 6 * int(lay.replicated_bytes))
    assert reg.gauge("hvd_sharded_update_shard_elems").value \
        == lay.shard_elems


def test_simulated_resize_2_to_3_bitwise_replicated(monkeypatch):
    params = _params()
    monkeypatch.setenv("HOROVOD_ELASTIC_GEN", "0")
    engines = psharded.make_simulated_engines(ADAM, 2)
    sp = [p.clone() for p in params]
    for e in engines:
        e.init(sp)
    rep = _Replicated(ADAM, params)
    for step in range(3):
        gs = _grads(params, 2, step)
        psharded.simulated_step(engines, sp, gs)
        rep.step(gs)
    digest = engines[0].layout.digest
    full = psharded.simulated_full_state(engines)
    g = engines[0].layout.groups[0]
    assert full["state"][len(engines[0].layout.replicated)][
        "exp_avg"].shape == (g.total,)
    # the resize: a new generation, a new world, the state re-cut
    monkeypatch.setenv("HOROVOD_ELASTIC_GEN", "1")
    psharded.notify_reshard()
    assert engines[0].layout is None
    engines3 = psharded.make_simulated_engines(ADAM, 3)
    for e in engines3:
        e.load_full_state(full, sp)
    assert engines3[0].layout.generation == 1
    assert engines3[0].layout.digest != digest
    for step in range(3, 6):
        gs = _grads(params, 3, step)
        psharded.simulated_step(engines3, sp, gs)
        rep.step(gs)
    assert all(torch.equal(a, b) for a, b in zip(sp, rep.params))


def test_engine_refuses_other_ops_and_simulated_real_step():
    with pytest.raises(ValueError, match="AVERAGE/SUM"):
        psharded.ShardedUpdateEngine(SGD, world_size=2, rank=0,
                                     op=pcoll.ReduceOp.MAX)
    with pytest.raises(ValueError, match="world_size= and rank="):
        psharded.ShardedUpdateEngine(SGD)
    e = psharded.ShardedUpdateEngine(SGD, world_size=2, rank=0)
    with pytest.raises(ValueError, match="simulated_step"):
        e.step(_params())
    with pytest.raises(ValueError, match="simulated_full_state"):
        e.init(_params())
        e.full_state()


def test_engine_real_mode_at_world_one(port):
    """The engine at a world of one over gloo: reduce-scatter and
    allgather on a group of one, the replicated leaves through the
    runtime; bitwise the replicated update, each ``.grad`` released."""
    params = [p.clone() for p in _params()]
    engine = psharded.ShardedUpdateEngine(
        SGD, process_set=hvd.global_process_set())
    engine.init(params)
    rep = _Replicated(SGD, params)
    for step in range(3):
        gs = _grads(params, 1, step)
        for p, g in zip(params, gs[0]):
            p.grad = g.clone()
        out = engine.step(params)
        assert out == params
        assert all(p.grad is None for i, p in enumerate(params)
                   if i not in engine.layout.replicated)
        rep.step(gs)
        assert all(torch.equal(a, b) for a, b in zip(params, rep.params))
    full = engine.full_state()
    assert len(full["state"]) == len(params) - len(
        [i for g in engine.layout.groups for i in g.indices]) + len(
        engine.layout.groups)


# --- the front end at world 1 --------------------------------------------------------

def _mlp(seed):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(200, 100),
                               torch.nn.Linear(100, 1))


def test_front_end_world1_bitwise_plain_and_owners_match_jax(port):
    import horovod_tpu.torch as jshim

    m1, m2, m3 = _mlp(0), _mlp(0), _mlp(0)
    o1 = hvd.DistributedOptimizer(
        torch.optim.Adam(m1.parameters(), lr=1e-2),
        named_parameters=m1.named_parameters())
    o2 = hvd.DistributedOptimizer(
        torch.optim.Adam(m2.parameters(), lr=1e-2),
        named_parameters=m2.named_parameters(),
        sharded_update=True, min_shard_elems=2 ** 10)
    assert type(o2).__name__ == "ShardedDistributedAdam"
    assert isinstance(o2, torch.optim.Adam)
    owners = [o2._owners[p] for g in o2.param_groups for p in g["params"]]
    sizes = [p.numel() for p in m2.parameters()]
    assert owners == jpolicy.assign_owners(sizes, 1, min_shard_elems=2 ** 10)
    assert 0 in owners and None in owners
    o3 = jshim.DistributedOptimizer(
        torch.optim.Adam(m3.parameters(), lr=1e-2),
        named_parameters=m3.named_parameters(),
        sharded_update=True, min_shard_elems=2 ** 10)
    assert type(o3).__name__ == type(o2).__name__
    assert [o3._owners[p] for p in m3.parameters()] == owners
    x = torch.randn(16, 200, generator=torch.Generator().manual_seed(1))
    for _ in range(3):
        for m, o in ((m1, o1), (m2, o2)):
            o.zero_grad()
            m(x).pow(2).mean().backward()
            o.step()
        assert all(torch.equal(a, b)
                   for a, b in zip(m1.parameters(), m2.parameters()))
    reg = pmetrics.get_registry()
    assert reg.gauge("hvd_sharded_update_shard_fraction").value > 0.9


def test_front_end_env_knob_and_threshold(port, monkeypatch):
    monkeypatch.setenv("HOROVOD_SHARDED_UPDATE", "1")
    monkeypatch.setenv("HOROVOD_SHARDED_MIN_ELEMS", "150")
    m = _mlp(0)
    o = hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(), lr=0.1))
    assert type(o).__name__ == "ShardedDistributedSGD"
    sizes = [p.numel() for p in m.parameters()]
    assert list(o._owners.values()) == jpolicy.assign_owners(
        sizes, 1, min_shard_elems=150)
    # Adasum at a world of one is the regular wrapper, here the sharded
    # one, as the JAX shim's cross_size() > 1 guard makes it
    o = hvd.DistributedOptimizer(torch.optim.SGD(_mlp(0).parameters(),
                                                 lr=0.1),
                                 op=hvd.Adasum, sharded_update=True)
    assert type(o).__name__ == "ShardedDistributedSGD"
