"""Adasum in the port (``ops/adasum.py``: K4's plain versions and what is
built on them) against the JAX package's ``horovod_tpu/ops/adasum.py``, on
the CPU, on the same numpy inputs.

- ``adasum_combine`` and ``adasum_tree_reduce`` at n = 1, 2, 3, 4 and 8
  rows, fp32, bf16 and fp16: random rows, a zero-norm side, identical rows
  (the mean), orthogonal rows (the sum), scaled rows (scale invariance).
  fp32 within 1e-6 of the result's largest magnitude (the fp32 dots add in
  another order than XLA's); bf16 and fp16 within one ulp of the output
  dtype at each element, plus 2^-20 of the largest magnitude where a
  cancellation leaves an element near zero (after the first round the
  fp32 dots of rounded rows add in another order). Half-precision rows are
  drawn on a grid of 1/16 whose fp32 dots are exact, so one round is held
  to the ulp alone.
- The simulated two-level Adasum (``simulated_hierarchical``) of four
  ranks as 2 x 2 and of eight as 2 x 4 and 4 x 2 (local x cross) against
  ``adasum_allreduce_hierarchical`` under ``jax.shard_map`` on the
  session's virtual CPU devices, within 1e-6 of the largest magnitude.
- The world of one: ``hvd.allreduce(op=hvd.Adasum)`` is the JAX package's
  prescaled and postscaled identity, and ``DistributedOptimizer(op=Adasum)``
  is the regular wrapper, bitwise a plain step.
- The wrappers' contract: shapes and dtypes checked, other devices
  refused.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu as jhvd
import horovod_tpu_torch as hvd
from horovod_tpu.ops import adasum as jada
from horovod_tpu_torch.ops import adasum as pada

DTYPES = {"float32": (torch.float32, np.float32),
          "bfloat16": (torch.bfloat16, ml_dtypes.bfloat16),
          "float16": (torch.float16, np.float16)}
F32_TOL = 1e-6
HALF_FLOOR = 2.0 ** -20


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(n, size, dtype, seed, grid=False):
    rs = np.random.RandomState(seed)
    if grid:  # multiples of 1/16 up to 4: exact fp32 dots
        a = rs.randint(-64, 65, (n, size)).astype(np.float32) / 16.0
    else:
        a = rs.randn(n, size).astype(np.float32)
    return a.astype(DTYPES[dtype][1])


def _torch(a):
    a = np.ascontiguousarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _np(t):
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _ulp(x: np.ndarray, dtype: str) -> np.ndarray:
    """The spacing of ``dtype`` at each |x| (its smallest normal's below
    it)."""
    mant = {"bfloat16": 7, "float16": 10}[dtype]
    tiny = {"bfloat16": 2.0 ** -126, "float16": 2.0 ** -14}[dtype]
    mag = np.maximum(np.abs(x.astype(np.float64)), tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - mant)


def _assert_close(got, want, dtype, exact_dots=False):
    g = np.asarray(got).astype(np.float64)
    w = np.asarray(want).astype(np.float64)
    assert g.shape == w.shape
    scale = np.abs(w).max() if w.size else 0.0
    err = np.abs(g - w)
    if dtype == "float32":
        assert err.max(initial=0.0) <= F32_TOL * scale, (err.max(), scale)
        return
    bound = _ulp(np.maximum(np.abs(g), np.abs(w)), dtype)
    if not exact_dots:
        bound = bound + HALF_FLOOR * scale
    assert (err <= bound).all(), (err.max(), scale)


_jcombine = jax.jit(jada.adasum_combine)
_jtree = jax.jit(jada.adasum_tree_reduce)


CASES = ["random", "zero_a", "zero_b", "zero_both", "identical",
         "orthogonal", "scaled"]


def _pair(case, dtype, size=257, seed=0):
    grid = dtype != "float32"
    a, b = _rows(2, size, dtype, seed, grid=grid)
    if case == "zero_a":
        a = np.zeros_like(a)
    elif case == "zero_b":
        b = np.zeros_like(b)
    elif case == "zero_both":
        a, b = np.zeros_like(a), np.zeros_like(b)
    elif case == "identical":
        b = a.copy()
    elif case == "orthogonal":
        a = a.copy()
        b = b.copy()
        a[size // 2:] = 0
        b[:size // 2] = 0
    elif case == "scaled":
        b = (a.astype(np.float32) * 4.0).astype(a.dtype)
    return a, b


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_combine_matches_jax(case, dtype):
    a, b = _pair(case, dtype)
    got = pada.adasum_combine(_torch(a), _torch(b))
    want = np.asarray(_jcombine(a, b))
    assert _np(got).dtype == want.dtype
    _assert_close(_np(got), want, dtype, exact_dots=True)
    if case == "identical":  # the mean of two equal rows is the row
        assert np.array_equal(_np(got).view(np.uint8), a.view(np.uint8))
    if case in ("orthogonal", "zero_a", "zero_b", "zero_both"):
        # disjoint supports: coefficients 1 (or 0 for a zero side), the sum
        s = (a.astype(np.float32) + b.astype(np.float32)).astype(a.dtype)
        assert np.array_equal(_np(got).view(np.uint8), s.view(np.uint8))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_tree_reduce_matches_jax(n, dtype):
    g = _rows(n, 1000, dtype, seed=n, grid=dtype != "float32")
    got = pada.adasum_tree_reduce(_torch(g))
    want = np.asarray(_jtree(g))
    _assert_close(_np(got), want, dtype, exact_dots=n <= 2)
    # the list form and the plain entry point are the same reduction
    rows = [_torch(r) for r in g]
    assert torch.equal(pada.adasum_tree_reduce_plain(rows), got)


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_tree_is_scale_invariant(n):
    """Adasum of c * rows is c times Adasum of the rows (c a power of two,
    exact), in the port as in the JAX package."""
    g = _rows(n, 300, "float32", seed=10 + n)
    base = pada.adasum_tree_reduce(_torch(g))
    scaled = pada.adasum_tree_reduce(_torch(g * 8.0))
    torch.testing.assert_close(scaled, base * 8.0, rtol=0, atol=0)
    _assert_close(_np(scaled), np.asarray(_jtree(g * 8.0)), "float32")


def test_identical_rows_give_the_mean_and_orthogonal_the_sum():
    a = _rows(1, 64, "float32", seed=3)[0]
    same = np.stack([a] * 4)
    assert np.array_equal(_np(pada.adasum_tree_reduce(_torch(same))), a)
    eye = np.eye(4, dtype=np.float32) * np.arange(1, 5, dtype=np.float32)
    got = _np(pada.adasum_tree_reduce(_torch(eye)))
    assert np.array_equal(got, eye.sum(0))
    np.testing.assert_array_equal(np.asarray(_jtree(eye)), got)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dot_norms_and_scaled_add_are_the_jax_arithmetic(dtype):
    a, b = _pair("random", dtype, size=513, seed=7)
    sums = pada.dot_norms(_torch(a), _torch(b))
    af, bf = a.astype(np.float64), b.astype(np.float64)
    want = np.array([af @ bf, af @ af, bf @ bf])
    if dtype == "float32":  # fp32 sums in another order than fp64's
        np.testing.assert_allclose(sums.numpy(), want,
                                   atol=F32_TOL * np.sqrt(want[1] * want[2]))
    else:  # exact on the grid
        np.testing.assert_array_equal(sums.numpy(), want.astype(np.float32))
    out = torch.empty(513, dtype=DTYPES[dtype][0])
    assert pada.scaled_add(_torch(a), _torch(b), sums, out) is out
    _assert_close(_np(out), np.asarray(_jcombine(a, b)), dtype,
                  exact_dots=True)


# --- two levels: the hosts' means, then the hypercube across hosts ----------

@pytest.mark.parametrize("local,cross", [(2, 2), (2, 4), (4, 2)])
def test_simulated_hierarchical_matches_jax_shard_map(local, cross):
    n_ranks, size = local * cross, 1001  # not a multiple of local: a pad
    g = _rows(n_ranks, size, "float32", seed=local * 10 + cross)
    got = pada.simulated_hierarchical([_torch(r) for r in g], local)
    devs = np.array(jax.devices()[:n_ranks]).reshape(cross, local)
    mesh = Mesh(devs, ("cross", "local"))
    spec = P(("cross", "local"))
    f = jax.jit(jax.shard_map(
        lambda x: jada.adasum_allreduce_hierarchical(x, "local", "cross"),
        mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False))
    want = np.asarray(f(jnp.asarray(g)))
    for r in range(n_ranks):
        _assert_close(_np(got[r]), want[r], "float32")
        # every rank of the simulated world holds the same bits
        assert torch.equal(got[r], got[0])
    # two levels are Adasum of the hosts' means, not flat Adasum
    means = [_torch(g[c * local:(c + 1) * local].mean(0))
             for c in range(cross)]
    _assert_close(_np(got[0]), _np(pada.adasum_tree_reduce(means)),
                  "float32")


def test_simulated_hierarchical_refuses_a_world_it_cannot_split():
    xs = [torch.ones(4)] * 6
    with pytest.raises(ValueError, match="power-of-two"):
        pada.simulated_hierarchical(xs, 2)  # three hosts


# --- the world of one -------------------------------------------------------

@pytest.fixture(scope="module")
def port():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [(1.0, 1.0), (2.0, 0.25), (0.7, 3.0)])
def test_world_of_one_adasum_is_the_scaled_identity(port, dtype, scale):
    """fp32: the JAX package's identity times both factors. bf16: K1's
    factor rule bit for bit (each factor rounded to bf16, each product
    rounded once); the JAX package's world-of-one shortcut returns fp32
    there (ROADMAP.md queue 3), held within two bf16 roundings and the
    factors' own."""
    pre, post = scale
    x = _rows(1, 33, dtype, seed=4)[0].reshape(3, 11)
    got = hvd.allreduce(_torch(x), op=hvd.Adasum, prescale_factor=pre,
                        postscale_factor=post)
    want = np.asarray(jhvd.allreduce(x, op=jhvd.Adasum, prescale_factor=pre,
                                     postscale_factor=post))
    assert got.shape == want.shape == x.shape
    if dtype == "float32":
        assert _np(got).dtype == want.dtype
        np.testing.assert_allclose(_np(got), want, rtol=1e-6)
        return
    bf = ml_dtypes.bfloat16
    rule = ((x.astype(np.float32) * np.float32(bf(pre))).astype(bf)
            .astype(np.float32) * np.float32(bf(post))).astype(bf)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(_np(got).view(np.uint16), rule.view(np.uint16))
    np.testing.assert_allclose(_np(got).astype(np.float32), want,
                               rtol=2.0 ** -6)


def _mlp(seed):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.Tanh(),
                               torch.nn.Linear(5, 2))


def test_world_of_one_adasum_optimizer_is_the_plain_step(port):
    m1, m2 = _mlp(0), _mlp(0)
    o1 = hvd.DistributedOptimizer(
        torch.optim.SGD(m1.parameters(), lr=0.1, momentum=0.9),
        named_parameters=m1.named_parameters(), op=hvd.Adasum)
    assert type(o1).__name__ == "DistributedSGD"
    o2 = torch.optim.SGD(m2.parameters(), lr=0.1, momentum=0.9)
    x = torch.from_numpy(np.random.RandomState(0).randn(8, 6)
                         .astype(np.float32))
    for _ in range(3):
        for m, o in ((m1, o1), (m2, o2)):
            o.zero_grad()
            m(x).square().mean().backward()
            o.step()
    for a, b in zip(m1.parameters(), m2.parameters()):
        assert torch.equal(a, b)


def test_world_of_one_adasum_with_sharded_update_builds_the_sharded_wrapper(
        port):
    """As the JAX shim's ``cross_size() > 1`` guard: at one rank Adasum is
    the regular (here sharded) wrapper."""
    o = hvd.DistributedOptimizer(torch.optim.SGD(_mlp(0).parameters(),
                                                 lr=0.1),
                                 op=hvd.Adasum, sharded_update=True)
    assert type(o).__name__ == "ShardedDistributedSGD"


# --- the wrappers' contract -------------------------------------------------

def test_wrappers_check_their_arguments():
    a = torch.ones(4)
    with pytest.raises(ValueError, match="one shape and dtype"):
        pada.dot_norms(a, torch.ones(5))
    with pytest.raises(ValueError, match="K4 takes"):
        pada.dot_norms(a.double(), a.double())
    with pytest.raises(ValueError, match="fp32\\[3\\]"):
        pada.scaled_add(a, a, torch.ones(2))
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        pada.dot_norms(torch.ones(4, device="meta"),
                       torch.ones(4, device="meta"))
    with pytest.raises(ValueError, match="no rows"):
        pada.adasum_tree_reduce([])
    # a zero-length pair: zero sums, an empty result
    e = torch.empty(0)
    assert pada.dot_norms(e, e).tolist() == [0.0, 0.0, 0.0]
    assert pada.adasum_combine(e, e).numel() == 0


def test_a_flip_of_a_hierarchical_knob_drops_a_captured_megaplan(
        port, monkeypatch):
    """A captured chain holds the chunk plans of one verdict: flipping
    ``HOROVOD_HIERARCHICAL_ALLREDUCE`` (the config the runtime reads)
    invalidates it, counted under reason ``hierarchical``, and the next
    cycles capture anew."""
    from horovod_tpu_torch.common import context as pctx
    from horovod_tpu_torch.common.env import RuntimeConfig
    from horovod_tpu_torch.ops import megaplan as pmp
    from horovod_tpu_torch.ops import queue as pq
    from horovod_tpu_torch.utils import metrics as pmetrics

    monkeypatch.setenv("HOROVOD_MEGAPLAN", "1")
    monkeypatch.setenv("HOROVOD_MEGAPLAN_STABLE_ROUNDS", "2")
    pmp.reset_manager()
    pmp.init_manager(rank=0)
    cfg = pctx._ctx.config
    try:
        ps = pctx.global_process_set()
        rt = pq.BackgroundRuntime(ps, RuntimeConfig(), torch.device("cpu"),
                                  ps.runtime_group)
        mgr = pmp.get_manager()

        def cycle():
            ts = [torch.full((16,), float(i)) for i in range(3)]
            hs = rt.enqueue_group([pq.TensorEntry(
                name=f"hier.mp.{i}", op="allreduce", tensor=t,
                output=torch.empty_like(t), reduce_op=hvd.Sum)
                for i, t in enumerate(ts)])
            rt.run_cycle()
            return [rt.handles.wait(h) for h in hs]

        for _ in range(3):
            cycle()
        assert mgr.plan is not None

        def inval():
            return pmetrics.get_registry().counter_value(
                "hvd_megaplan_invalidations_total", reason="hierarchical")

        before = inval()
        monkeypatch.setattr(cfg, "hierarchical_allreduce", True)
        outs = cycle()
        assert inval() == before + 1
        assert [o.tolist() for o in outs] == [[float(i)] * 16
                                              for i in range(3)]
        for _ in range(2):
            cycle()
        assert mgr.plan is not None  # captured again under the new verdict
    finally:
        pmp.reset_manager()
