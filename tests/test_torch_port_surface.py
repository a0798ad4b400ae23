"""The rest of Horovod's collective surface in the port against the JAX
package's, on the CPU (gloo):

- in process, at a world of one (``hvd.init(device="cpu")``): allgather,
  alltoall (with its received splits) and reducescatter, their autograd,
  ``sparse_allreduce_async``, ``allgather_object``, ``join`` and
  ``DistributedOptimizer`` over a sparse embedding, each against
  ``horovod_tpu.torch`` on the same seeded numpy inputs, and every
  validation error with the JAX package's message;
- K1's plain compaction of a ragged allgather (the row slices
  ``gathered[i*maxn : i*maxn + size_i]`` packed back to back) against
  ``torch.cat``, in the layouts the card's K1 phase holds the kernel to;
- one 2-process job through the JAX package's ``hvdrun`` and one through
  the port's, running the same script of cases (``CASES``): allgather
  even, ragged and with a rank of no rows in fp32, bf16, int32 and uint8;
  alltoall even, uneven and all-zero with the received splits;
  reducescatter SUM and AVERAGE; sets {0}, {1} and {0, 1} whose tensors
  are all named ``x``, like the global set's; rank 1 joining while rank 0
  runs an allreduce and an allgather; ``allgather_object``; sparse
  allreduce; the gradients of allgather and alltoall; and
  ``DistributedOptimizer`` over ``nn.Embedding(sparse=True)``, globally
  and with ``process_set=``. The results are compared bit for bit.

The 2-process jobs give each JAX worker one CPU device, so the JAX
package's set of chips ``[1]`` is the port's set of ranks ``{1}`` and a
set's rank, size, cross rank and cross size are compared as they are.
Where the two differ the difference is pinned, not hidden: the JAX
package's ``reducescatter_async`` reads ``op=Average`` (``ReduceOp`` 0)
through ``op or ReduceOp.SUM`` and sums, while the port averages; the
port's AVERAGE is held to the JAX multi-rank rule (``_allreduce_body``)
instead (ROADMAP.md queue 3).
"""

import os
import pickle
import signal
import subprocess
import sys
import textwrap

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import horovod_tpu.torch as jhvd
import horovod_tpu_torch as hvd
from horovod_tpu.ops import collectives as jcoll
from horovod_tpu_torch.ops import collectives as pcoll

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def _data(rows, rest, dtype, seed):
    a = np.random.RandomState(seed).uniform(-4, 4, (rows,) + rest)
    t = torch.from_numpy(a.astype(np.float32))
    if dtype in (torch.int32, torch.uint8):
        t = (t * 30).abs()
    return t.to(dtype)


def _bits(t):
    t = t.detach().contiguous()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _same(p, j):
    """Bit for bit, with the same dtype and shape."""
    assert p.dtype == j.dtype and p.shape == j.shape, (p, j)
    assert torch.equal(_bits(p), _bits(j)), (p, j)


DTYPES = [torch.float32, torch.bfloat16, torch.int32, torch.uint8]
SHAPES = [(3, 2), (0, 3), (5,), (2, 1, 4)]


# --- world of one, in process -------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
def test_allgather_matches_jax_at_size_one(port, dtype, shape):
    x = _data(shape[0], shape[1:], dtype, 1)
    _same(hvd.allgather(x, name="ag"), jhvd.allgather(x, name="ag"))


@pytest.mark.parametrize("rows,splits", [(4, None), (4, [4]), (0, [0]),
                                         (3, torch.tensor([3]))],
                         ids=["even", "explicit", "zero", "tensor"])
def test_alltoall_matches_jax_at_size_one(port, rows, splits):
    x = _data(rows, (2,), torch.float32, 2)
    p_out, p_recv = hvd.alltoall(x, splits=splits, name="a2a")
    # the JAX package's shim takes splits as a tensor only
    j_out, j_recv = jhvd.alltoall(
        x, splits=None if splits is None else torch.as_tensor(splits),
        name="a2a")
    _same(p_out, j_out)
    _same(p_recv, j_recv)


@pytest.mark.parametrize("op", [hvd.Sum, hvd.Average], ids=["sum", "avg"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=lambda d: str(d)[6:])
def test_reducescatter_matches_jax_at_size_one(port, dtype, op):
    x = _data(4, (3,), dtype, 3)
    _same(hvd.reducescatter(x, name="rs", op=op),
          jhvd.reducescatter(x, name="rs", op=op))


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 (the type is compared)
        return type(e).__name__, str(e)
    raise AssertionError("expected an error")


class _PairSet:
    """A set of two ranks, as far as the front ends' synchronous checks
    read it."""

    name, size, cross_size = "pair", 2, 2


@pytest.mark.parametrize("case", ["length", "sum", "scatter-scalar",
                                  "scatter-divisible"])
def test_validation_errors_match_jax(port, case):
    """The same error type and message in both packages; alltoall's are
    raised by the cycle thread and reach ``synchronize`` as
    ``HorovodInternalError``, reducescatter's at the call."""
    x = torch.arange(6.0).view(3, 2)
    call = {"length": lambda m: m.alltoall(x, splits=torch.tensor([1, 2]),
                                           name="e"),
            "sum": lambda m: m.alltoall(x, splits=torch.tensor([2]),
                                        name="e"),
            "scatter-scalar": lambda m: m.reducescatter(torch.tensor(1.0)),
            "scatter-divisible": lambda m: m.reducescatter(
                x, process_set=_PairSet())}[case]
    assert _error(lambda: call(hvd)) == _error(lambda: call(jhvd))


@pytest.mark.parametrize("rows", [3, 1])
def test_allgather_gradient_matches_jax(port, rows):
    w = _data(rows, (2,), torch.float32, 9)
    grads = []
    for m in (hvd, jhvd):
        x = _data(rows, (2,), torch.float32, 8).requires_grad_()
        (m.allgather(x, name="agg") * w).sum().backward()
        grads.append(x.grad)
    _same(*grads)


def test_alltoall_gradient_matches_jax(port):
    w = _data(4, (3,), torch.float32, 11)
    grads = []
    for m in (hvd, jhvd):
        x = _data(4, (3,), torch.float32, 10).requires_grad_()
        out, recv = m.alltoall(x, splits=torch.tensor([4]), name="a2ag")
        assert not recv.requires_grad
        (out * w).sum().backward()
        grads.append(x.grad)
    _same(*grads)


@pytest.mark.parametrize("op,pre,post", [(hvd.Sum, 1.0, 1.0),
                                         (hvd.Average, 1.0, 1.0),
                                         (hvd.Sum, 0.5, 3.0)],
                         ids=["sum", "avg", "scaled"])
def test_sparse_allreduce_matches_jax(port, op, pre, post):
    idx = torch.tensor([[4, 0, 4, 2]])
    sp = torch.sparse_coo_tensor(idx, _data(4, (3,), torch.float32, 12),
                                 (6, 3))
    p = hvd.sparse_allreduce_async(sp, "sp", op=op, prescale_factor=pre,
                                   postscale_factor=post)()
    j = jhvd.sparse_allreduce_async(sp, "sp", op=op, prescale_factor=pre,
                                    postscale_factor=post)()
    assert p.is_sparse and j.is_sparse
    _same(p.indices(), j.indices())
    _same(p.values(), j.values())


def test_allgather_object_and_join_match_jax(port):
    obj = {"loss": 1.5, "tokens": [1, 2, 3]}
    assert hvd.allgather_object(obj) == jhvd.allgather_object(obj) == [obj]
    assert hvd.join() == jhvd.join() == 0
    # the runtime still serves collectives after a join
    _same(hvd.allreduce(torch.ones(2), op=hvd.Sum, name="after"),
          torch.ones(2))


def _sparse_model_step(m, ps=None):
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Embedding(12, 4, sparse=True),
                                torch.nn.Linear(4, 1))
    opt = m.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                                 named_parameters=model.named_parameters(),
                                 process_set=ps)
    for step in range(2):
        tok = torch.from_numpy(np.random.RandomState(step).randint(0, 12, 6))
        opt.zero_grad()
        model(tok).pow(2).sum().backward()
        assert model[0].weight.grad.is_sparse
        opt.step()
    return model.state_dict()


def test_distributed_optimizer_sparse_embedding_matches_jax(port):
    p, j = _sparse_model_step(hvd), _sparse_model_step(jhvd)
    for k in p:
        _same(p[k], j[k])


# --- K1's compaction ----------------------------------------------------------

COMPACT_SIZES = {2: [3, 0], 4: [5, 0, 1, 2], 8: [1, 0, 4, 0, 1, 3, 2, 0]}
COMPACT_CASES = [(nproc, rest, dtype, mis)
                 for nproc in COMPACT_SIZES
                 for rest in ((2048,), (3,), ())
                 for dtype in DTYPES
                 for mis in (0, 1)]


@pytest.mark.parametrize(
    "nproc,rest,dtype,mis", COMPACT_CASES,
    ids=[f"n{c[0]}-rest{list(c[1])}-{str(c[2])[6:]}-mis{c[3]}"
         for c in COMPACT_CASES])
def test_ragged_compaction_plain_matches_cat(nproc, rest, dtype, mis):
    """``compact_rows`` on CPU tensors is K1's plain version over the table
    of row slices: ``torch.cat`` of the slices, rows of zero size left out.
    ``mis`` starts the gathered buffer one element past its allocation."""
    sizes = COMPACT_SIZES[nproc]
    maxn, row = max(sizes), int(np.prod(rest, dtype=np.int64))
    buf = _data(nproc * maxn * row + mis, (), dtype, nproc)
    gathered = buf[mis:].view((nproc * maxn,) + rest)
    out = torch.empty((sum(sizes),) + rest, dtype=dtype)
    pcoll.compact_rows(gathered, sizes, maxn, row, out)
    want = torch.cat([gathered[i * maxn:i * maxn + s]
                      for i, s in enumerate(sizes)])
    _same(out, want)


def test_compaction_takes_k1_on_cuda_tensors_only():
    """A CPU table takes the plain version; any other device launches the
    kernel or raises (no quiet fallback)."""
    gathered = torch.empty(8, 2, dtype=torch.uint8, device="meta")
    out = torch.empty(5, 2, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        pcoll.compact_rows(gathered, [4, 1], 4, 2, out)


# --- two processes: the port's hvdrun against the JAX package's ---------------

PORT_HEAD = """
    import sys
    sys.modules["jax"] = None
    sys.modules["horovod_tpu"] = None
    import torch
    import horovod_tpu_torch as hvd
    torch.set_num_threads(1)
    hvd.init(device="cpu")
    core = None
"""

# one CPU device a worker: the JAX package's sets count chips
JAX_HEAD = """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch
    import horovod_tpu as core
    import horovod_tpu.torch as hvd
    torch.set_num_threads(1)
    hvd.init()
"""

CASES = """
    import pickle
    import numpy as np

    r = hvd.rank()
    assert hvd.size() == 2
    res = {}
    rs = np.random.RandomState(10 + r)


    def put(key, t):
        if isinstance(t, torch.Tensor):
            t = t.detach()
            t = (t.to_dense() if t.is_sparse else t).contiguous()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            t = t.numpy()
        res[key] = np.asarray(t)


    def data(rows, rest, dtype):
        t = torch.from_numpy(
            rs.uniform(-4, 4, (rows,) + rest).astype(np.float32))
        if dtype in (torch.int32, torch.uint8):
            t = (t * 30).abs()
        return t.to(dtype)


    DT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32, "uint8": torch.uint8}
    # allgather: even, ragged, a rank with no rows, one dimension
    for dn, dt in DT.items():
        for label, rows, rest in (("even", (3, 3), (2,)),
                                  ("ragged", (2, 5), (2,)),
                                  ("zero", (4, 0), (3,)),
                                  ("flat", (1, 6), ())):
            put(f"ag.{dn}.{label}", hvd.allgather(
                data(rows[r], rest, dt), name=f"ag.{dn}.{label}"))
    # alltoall: even, uneven, all-zero splits
    for label, rows, splits in (("even", (4, 4), None),
                                ("uneven", (3, 3), ([1, 2], [3, 0])),
                                ("zero", (0, 0), ([0, 0], [0, 0]))):
        sp = None if splits is None else torch.tensor(splits[r])
        out, recv = hvd.alltoall(data(rows[r], (2,), torch.float32),
                                 splits=sp, name=f"a2a.{label}")
        put(f"a2a.{label}", out)
        put(f"a2a.{label}.recv", recv)
    # reducescatter: SUM and AVERAGE
    for dn in ("float32", "bfloat16"):
        x = data(6, (3,), DT[dn])
        put(f"rs.{dn}.in", x)
        for opn, op in (("sum", hvd.Sum), ("avg", hvd.Average)):
            put(f"rs.{dn}.{opn}",
                hvd.reducescatter(x, name=f"rs.{dn}.{opn}", op=op))
    # sets {0}, {1}, {0, 1}, created on every rank in one order; every
    # set's tensor is named "x", as the global set's is
    add = getattr(hvd, "add_process_set", None) or core.add_process_set
    members = {"zero": [0], "one": [1], "both": [0, 1]}
    sets = {nm: add(ranks, name=nm) for nm, ranks in members.items()}
    for nm, ps in sets.items():
        put(f"ps.{nm}.topo",
            [ps.rank, ps.size, ps.cross_rank, ps.cross_size]
            if r in members[nm] else [-1, ps.size, -1, ps.cross_size])
    x = torch.full((4,), float(r + 1))
    put("ps.global.x", hvd.allreduce(x, name="x", op=hvd.Sum))
    # the one-member sets at once, one on each rank, both named "x"
    own = sets["zero"] if r == 0 else sets["one"]
    put("ps.own.x", hvd.allreduce(x * 3, name="x", op=hvd.Sum,
                                  process_set=own))
    put("ps.both.x", hvd.allreduce(x * 5, name="x", op=hvd.Sum,
                                   process_set=sets["both"]))
    put("ps.both.ag", hvd.allgather(data(r + 1, (2,), torch.float32),
                                    name="x", process_set=sets["both"]))
    put("ps.both.grouped", torch.cat(hvd.grouped_allreduce(
        [x, x * 2], name="g", op=hvd.Average, process_set=sets["both"])))
    # the gradients of allgather (ragged) and alltoall (uneven)
    xg = data(r + 2, (3,), torch.float32).requires_grad_()
    w = torch.from_numpy(np.random.RandomState(5).uniform(
        -1, 1, (5, 3)).astype(np.float32))
    (hvd.allgather(xg, name="agg") * w).sum().backward()
    put("grad.ag", xg.grad)
    xg = data(3, (2,), torch.float32).requires_grad_()
    out, recv = hvd.alltoall(xg, splits=torch.tensor([[1, 2], [2, 1]][r]),
                             name="a2ag")
    w = torch.from_numpy(np.random.RandomState(6).uniform(
        -1, 1, (out.shape[0], 2)).astype(np.float32))
    (out * w).sum().backward()
    put("grad.a2a", xg.grad)
    put("obj", np.frombuffer(pickle.dumps(hvd.allgather_object(
        {"rank": r, "v": [r] * 3})), np.uint8))
    # sparse allreduce, rows 3 on both ranks
    idx = torch.tensor([[0, 3, 5] if r == 0 else [3, 6]])
    sp = torch.sparse_coo_tensor(
        idx, data(idx.shape[1], (3,), torch.float32), (8, 3))
    for opn, op in (("sum", hvd.Sum), ("avg", hvd.Average)):
        put(f"sparse.{opn}",
            hvd.sparse_allreduce_async(sp, f"sp.{opn}", op=op)())
    # DistributedOptimizer over a sparse embedding, globally and on a set
    for label, ps in (("global", None), ("set", sets["both"])):
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Embedding(16, 4, sparse=True),
                                    torch.nn.Linear(4, 1))
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters(), process_set=ps)
        for step in range(2):
            tok = torch.from_numpy(np.random.RandomState(
                20 + 2 * step + r).randint(0, 16, (5,)))
            opt.zero_grad()
            model(tok).pow(2).sum().backward()
            opt.step()
        for k, v in model.state_dict().items():
            put(f"opt.{label}.{k}", v)
    # rank 1 joins first; rank 0 runs an allreduce and an allgather, to
    # which rank 1 contributes zeros and no rows, then joins
    if r == 0:
        put("join.ar", hvd.allreduce(torch.full((3,), 7.0), name="j.ar",
                                     op=hvd.Sum))
        put("join.ag", hvd.allgather(data(2, (2,), torch.float32),
                                     name="j.ag"))
    put("join.last", [hvd.join()])
    put("after.join", hvd.allreduce(torch.full((2,), float(r)),
                                    name="after", op=hvd.Sum))
    np.savez(OUT.format(r), **res)
    hvd.shutdown()
    print("CASES_OK", r)
"""


def _start(cmd: list):
    """``cmd`` from the repository in a session of its own, over one
    thread; stdout and stderr together."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


def _wait(p, what: str, timeout: float) -> str:
    """``p``'s output; at the timeout its whole session is killed."""
    try:
        return p.communicate(timeout=timeout)[0]
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out = p.communicate()[0]
        raise AssertionError(f"{what} timed out:\n{out}")


@pytest.fixture(scope="module")
def procs(tmp_path_factory):
    """This file's processes, all started at once: each package's
    two-rank job of ``CASES`` and ``collectives_probe.py`` at four gloo
    ranks. Name -> the process; ``"dir"`` -> where the jobs write."""
    tmp = tmp_path_factory.mktemp("surface")
    started = {"dir": tmp}
    for pkg, head, runner in (("port", PORT_HEAD, "horovod_tpu_torch"),
                              ("jax", JAX_HEAD, "horovod_tpu")):
        out = str(tmp / (pkg + ".{}.npz"))
        script = tmp / f"{pkg}_cases.py"
        script.write_text(textwrap.dedent(head) + f"OUT = {out!r}\n"
                          + textwrap.dedent(CASES))
        started[pkg] = _start([sys.executable, "-m", f"{runner}.runner",
                               "-np", "2", sys.executable, str(script)])
    started["probe"] = _start([sys.executable,
                               os.path.join(REPO, "collectives_probe.py"),
                               "-np", "4", "--device", "cpu", "--timeout",
                               "120"])
    yield started
    for name, p in started.items():
        if name != "dir" and p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.communicate()


@pytest.fixture(scope="module")
def jobs(procs):
    """Each package's dump of ``CASES``, by rank: {"port": [...], "jax":
    [...]}."""
    got = {}
    for pkg in ("port", "jax"):
        p = procs[pkg]
        log = _wait(p, f"{pkg} hvdrun job", 150.0)
        assert (p.returncode == 0 and "CASES_OK 0" in log
                and "CASES_OK 1" in log), log
        out = str(procs["dir"] / (pkg + ".{}.npz"))
        got[pkg] = [dict(np.load(out.format(r))) for r in range(2)]
    return got


GROUPS = ["ag.", "a2a.", "rs.", "ps.", "grad.", "obj", "sparse.", "opt.",
          "join.", "after."]


@pytest.mark.parametrize("prefix", GROUPS, ids=[g.rstrip(".")
                                                 for g in GROUPS])
def test_two_processes_match_jax_package(jobs, prefix):
    """Every case of the group, on both ranks, bit for bit (dtype and shape
    included), but the AVERAGE reducescatter (below)."""
    for r in range(2):
        p, j = jobs["port"][r], jobs["jax"][r]
        keys = sorted(k for k in p if k.startswith(prefix))
        assert keys and keys == sorted(k for k in j if k.startswith(prefix))
        for k in keys:
            if k.startswith("rs.") and k.endswith(".avg"):
                continue
            assert p[k].dtype == j[k].dtype and p[k].shape == j[k].shape, k
            np.testing.assert_array_equal(p[k], j[k], err_msg=k)


def _from_bits(a, dtype):
    if dtype == "bfloat16":
        return a.view(ml_dtypes.bfloat16)
    return a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_process_reducescatter_average_holds_the_multi_rank_rule(
        jobs, dtype):
    """The port's AVERAGE reducescatter is this rank's slice of the JAX
    multi-rank rule (``_allreduce_body``, op by op) on both ranks' inputs,
    bit for bit. The JAX package's job returns the SUM: its
    ``reducescatter_async`` takes ``op or ReduceOp.SUM``, and AVERAGE is
    ``ReduceOp`` 0 (pinned here; ROADMAP.md queue 3)."""
    p, j = jobs["port"], jobs["jax"]
    g = jax.numpy.asarray(np.stack(
        [_from_bits(p[r][f"rs.{dtype}.in"], dtype) for r in range(2)]))
    body = jcoll._allreduce_body(None, jcoll.ReduceOp.AVERAGE, 1.0, 1.0,
                                 False)
    rule = np.asarray(body(g))
    for r in range(2):
        want = rule[3 * r:3 * r + 3]
        if dtype == "bfloat16":
            want = want.view(np.int16)
        np.testing.assert_array_equal(p[r][f"rs.{dtype}.avg"], want)
        np.testing.assert_array_equal(j[r][f"rs.{dtype}.avg"],
                                      j[r][f"rs.{dtype}.sum"])
        assert not np.array_equal(p[r][f"rs.{dtype}.avg"],
                                  p[r][f"rs.{dtype}.sum"])


def test_two_process_cases_read_as_expected(jobs):
    """What the cases must give whatever the reference says: the join
    returns the last rank to join, rank 1 contributed zeros and no rows,
    the sets' topology, ``allgather_object`` in rank order."""
    for r in range(2):
        p = jobs["port"][r]
        assert p["join.last"].tolist() == [0]
        assert p["after.join"].tolist() == [1.0, 1.0]
        assert p["ps.global.x"].tolist() == [3.0] * 4
        assert p["ps.own.x"].tolist() == [3.0 * (r + 1)] * 4
        assert p["ps.both.x"].tolist() == [15.0] * 4
        assert p["ps.one.topo"].tolist() == ([-1, 1, -1, 1] if r == 0
                                             else [0, 1, 0, 1])
        assert p["ps.both.topo"].tolist() == [r, 2, r, 2]
        assert pickle.loads(p["obj"].tobytes()) == [
            {"rank": 0, "v": [0] * 3}, {"rank": 1, "v": [1] * 3}]
        assert p["a2a.uneven.recv"].tolist() == [[1, 3], [2, 0]][r]
    p0 = jobs["port"][0]
    assert p0["join.ar"].tolist() == [7.0] * 3
    assert p0["join.ag"].shape == (2, 2)


# --- more than two ranks ------------------------------------------------------

def test_collectives_probe_at_four_ranks_on_the_cpu(procs):
    """``collectives_probe.py`` at four gloo ranks: a ragged allgather
    with ranks of 0 and 1 rows, uneven alltoall, reducescatter, sets of
    the even, the odd and the last rank, sparse allreduce, join, objects,
    each checked exactly by every rank against inputs it makes from
    seeds (integer-valued, so sums of four ranks are exact)."""
    p = procs["probe"]
    out = _wait(p, "collectives_probe.py -np 4", 180.0)
    assert p.returncode == 0, out
    assert "4 ranks on cpu, every case exact" in out
