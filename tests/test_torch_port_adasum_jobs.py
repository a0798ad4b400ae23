"""Adasum and the two-level data plane across processes, on the CPU (gloo),
through each package's ``hvdrun``. Three jobs start at once:

- ``ADASUM_CASES`` in a 2-process job of the port and one of the JAX
  package's torch shim (one CPU device a JAX worker, so its processes are
  the port's ranks), with the same seeds: the eager Adasum allreduce of
  one fp32 tensor a rank (without and with factors), and 3 steps of
  ``DistributedOptimizer(SGD(0.1, momentum=0.9), op=Adasum)`` on a small
  MLP, each rank on its own batch. Within a package every rank's results
  are bitwise equal; across packages they agree within 1e-6 of the
  largest magnitude (eager) and 1e-5 of the largest parameter (after 3
  steps): the fp32 dots add in another order (torch's against XLA's).
- ``HIER_CASES`` in a 4-process job of the port, ``-H
  localhost:2,127.0.0.1:2`` (two hosts of two: ``HOROVOD_LOCAL_SIZE=2``,
  ``HOROVOD_CROSS_SIZE=2`` a rank) with ``HOROVOD_HIERARCHICAL_ALLREDUCE``
  and ``_ALLGATHER`` set, each case run two-level, then flat (the knobs
  turned off in the running config): SUM and AVERAGE through fused chunks
  (``grouped_allreduce``, with factors), a chunk of one, the eager
  ``_eager_allreduce`` on the caller's groups, the allgather of equal
  rows, a ragged allgather (flat either way), and Adasum. Two-level sums
  are bitwise equal on every rank and within fp32 rounding of the flat
  ones (1e-6 of the largest magnitude); the allgathers are bitwise the
  flat ones; two-level Adasum matches JAX's
  ``adasum_allreduce_hierarchical`` under ``shard_map`` (2 x 2 on four
  CPU devices) and flat Adasum JAX's ``adasum_tree_reduce``, within 1e-6
  of the largest magnitude.
- A grouped case in both: twelve Adasum tensors of mixed sizes
  (``GROUP_SIZES``) enqueued together with ``grouped_allreduce``. The
  port runs them as one chunk: one allgather (flat), or one
  reduce-scatter, one send/recv pair and one allreduce of an fp32[12, 3]
  a cross round, then one allgather (two levels); each tensor agrees
  with the JAX package's per-tensor Adasum within ``TOL`` and every rank
  holds rank 0's bits.
- ``adasum_probe.py -np 4 -H localhost:2,127.0.0.1:2 --device cpu`` at
  the tiny ResNet, every arm: the probe's own checks (parameters bitwise
  on every rank after every step, the Average arms' losses, the two-level
  calls) must pass. It starts with the other jobs.
"""

import os
import signal
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.ops import adasum as jada

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL, OPT_TOL = 1e-6, 1e-5

PORT_HEAD = """
    import sys
    sys.modules["jax"] = None
    sys.modules["horovod_tpu"] = None
    import torch
    import horovod_tpu_torch as hvd
    torch.set_num_threads(1)
    hvd.init(device="cpu")
"""

JAX_HEAD = """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch
    import horovod_tpu.torch as hvd
    torch.set_num_threads(1)
    hvd.init()
"""

# the grouped Adasum case's tensor sizes
GROUP_SIZES = (1, 3, 7, 64, 100, 257, 1000, 1024, 2, 33, 4097, 5000)

ADASUM_CASES = f"""
    GROUP_SIZES = {GROUP_SIZES!r}
""" + """
    import numpy as np

    r = hvd.rank()
    assert hvd.size() == 2
    res = {}
    x = torch.from_numpy(np.random.RandomState(100 + r).randn(37)
                         .astype(np.float32))
    res["eager"] = hvd.allreduce(x, op=hvd.Adasum, name="ada.eager").numpy()
    res["scaled"] = hvd.allreduce(x, op=hvd.Adasum, name="ada.scaled",
                                  prescale_factor=0.5,
                                  postscale_factor=2.0).numpy()
    # twelve Adasum tensors of mixed sizes enqueued together: the port
    # runs them as one chunk (one allgather), the JAX package one by one
    grp = [torch.from_numpy(np.random.RandomState(400 + 10 * i + r)
                            .randn(n).astype(np.float32))
           for i, n in enumerate(GROUP_SIZES)]
    port = hvd.__name__ == "horovod_tpu_torch"
    if port:
        from horovod_tpu_torch.common import context
        rt = context.runtime()
        c0, k0 = rt.chunks, rt.collective_calls
    outs = hvd.grouped_allreduce(grp, op=hvd.Adasum, name="ada.group",
                                 prescale_factor=0.5, postscale_factor=4.0)
    # the JAX package's runtime has no such counters: -1
    res["group.chunks"] = np.array(rt.chunks - c0 if port else -1)
    res["group.calls"] = np.array(rt.collective_calls - k0 if port else -1)
    for i, o in enumerate(outs):
        res[f"group.{i}"] = o.numpy()
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.Tanh(),
                                torch.nn.Linear(5, 2))
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters(), op=hvd.Adasum)
    res["class"] = np.array(type(opt).__name__)
    data = torch.from_numpy(np.random.RandomState(200 + r).randn(8, 6)
                            .astype(np.float32))
    for step in range(3):
        opt.zero_grad()
        model(data).square().mean().backward()
        opt.step()
        for name, p in model.named_parameters():
            res[f"opt.{step}.{name}"] = p.detach().numpy().copy()
    try:
        with opt.skip_synchronize():
            pass
        res["skip_raises"] = np.array(False)
    except AssertionError:
        res["skip_raises"] = np.array(True)
    np.savez(OUT.format(r), **res)
    hvd.shutdown()
    print("CASES_OK", r)
"""

HIER_CASES = f"""
    GROUP_SIZES = {GROUP_SIZES!r}
""" + """
    import numpy as np
    from horovod_tpu_torch.common import context
    from horovod_tpu_torch.ops import collectives as C

    r = hvd.rank()
    ps = hvd.global_process_set()
    assert (hvd.size(), hvd.local_size(), hvd.cross_size()) == (4, 2, 2)
    assert r == hvd.cross_rank() * 2 + hvd.local_rank()
    assert ps.hierarchy is not None and ps.runtime_hierarchy is not None
    cfg = context._ctx.config
    assert cfg.hierarchical_allreduce and cfg.hierarchical_allgather
    rs = np.random.RandomState(300 + r)
    xs = [torch.from_numpy(rs.randn(n).astype(np.float32))
          for n in (1, 7, 1000, 4097)]
    even = torch.from_numpy(rs.randn(3, 5).astype(np.float32))
    ragged = torch.from_numpy(rs.randn(r + 1, 3).astype(np.float32))
    grp = [torch.from_numpy(np.random.RandomState(500 + 10 * i + r)
                            .randn(n).astype(np.float32))
           for i, n in enumerate(GROUP_SIZES)]
    res = {f"in.{i}": x.numpy() for i, x in enumerate(xs)}
    seen = []  # (kind, shape) of the runtime's calls into the communicator
    _dist = torch.distributed

    def _spy(fn, kind):
        def spied(*a, **kw):
            t = a[0] if a and isinstance(a[0], torch.Tensor) else None
            seen.append((kind, tuple(t.shape) if t is not None else ()))
            return fn(*a, **kw)
        return spied

    _dist.all_reduce = _spy(_dist.all_reduce, "all_reduce")
    _dist.batch_isend_irecv = _spy(_dist.batch_isend_irecv,
                                   "batch_isend_irecv")
    C._all_gather = _spy(C._all_gather, "all_gather")
    C._reduce_scatter = _spy(C._reduce_scatter, "reduce_scatter")

    def run(tag, hier):
        calls0 = context.runtime().collective_calls
        for op, kw in (("sum", dict(op=hvd.Sum, prescale_factor=0.5,
                                    postscale_factor=3.0)),
                       ("avg", dict(op=hvd.Average))):
            outs = hvd.grouped_allreduce(xs, name=f"g.{op}.{tag}", **kw)
            for i, o in enumerate(outs):
                res[f"{tag}.fused.{op}.{i}"] = o.numpy()
        res[f"{tag}.one"] = hvd.allreduce(xs[2], op=hvd.Average,
                                          name=f"one.{tag}").numpy()
        h = ps.hierarchy if hier else None
        res[f"{tag}.eager.sum"] = C._eager_allreduce(
            xs[3], hvd.Sum, ps.group, 1.0, 1.0, h).numpy()
        res[f"{tag}.eager.avg"] = C._eager_allreduce(
            xs[3], hvd.Average, ps.group, 2.0, 0.5, h).numpy()
        res[f"{tag}.gather"] = hvd.allgather(even, name=f"ag.{tag}").numpy()
        res[f"{tag}.ragged"] = hvd.allgather(ragged,
                                             name=f"agr.{tag}").numpy()
        res[f"{tag}.adasum"] = hvd.allreduce(xs[2], op=hvd.Adasum,
                                             name=f"ada.{tag}").numpy()
        res[f"{tag}.calls"] = np.array(context.runtime().collective_calls
                                       - calls0)
        # the grouped Adasum chunk: the calls into torch.distributed by
        # kind, and the shapes of its allreduces
        seen.clear()
        rt = context.runtime()
        c0 = rt.chunks
        outs = hvd.grouped_allreduce(grp, op=hvd.Adasum,
                                     name=f"ada.group.{tag}")
        res[f"{tag}.group.chunks"] = np.array(rt.chunks - c0)
        for kind in ("reduce_scatter", "all_gather", "all_reduce",
                     "batch_isend_irecv"):
            res[f"{tag}.group.{kind}"] = np.array(
                sum(1 for k, _ in seen if k == kind))
        res[f"{tag}.group.allreduce_shapes"] = np.array(
            [shape for k, shape in seen if k == "all_reduce"]).reshape(-1, 2)
        for i, o in enumerate(outs):
            res[f"{tag}.group.{i}"] = o.numpy()

    run("hier", True)
    plans = [p for p in C._PLANS.values() if isinstance(p, C.FusedChunkPlan)]
    res["hier.plans"] = np.array(sum(p.hier is not None for p in plans))
    cfg.hierarchical_allreduce = cfg.hierarchical_allgather = False
    run("flat", False)
    np.savez(OUT.format(r), **res)
    hvd.shutdown()
    print("CASES_OK", r)
"""


def _launch(package: str, script, np_: int, hosts=None, env=None):
    e = dict(os.environ, OMP_NUM_THREADS="1", **(env or {}))
    e["PYTHONPATH"] = REPO + os.pathsep + e.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", f"{package}.runner", "-np", str(np_)]
    if hosts:
        cmd += ["-H", hosts]
    return subprocess.Popen(cmd + [sys.executable, str(script)], cwd=REPO,
                            env=e, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Each job's dumps by rank: {"port": [...], "jax": [...], "hier":
    [...]}; the three jobs run at once."""
    tmp = tmp_path_factory.mktemp("adasum_jobs")
    specs = {"port": ("horovod_tpu_torch", PORT_HEAD, ADASUM_CASES, 2, None,
                      None),
             "jax": ("horovod_tpu", JAX_HEAD, ADASUM_CASES, 2, None, None),
             "hier": ("horovod_tpu_torch", PORT_HEAD, HIER_CASES, 4,
                      "localhost:2,127.0.0.1:2",
                      {"HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
                       "HOROVOD_HIERARCHICAL_ALLGATHER": "1"})}
    procs, outs = {}, {}
    probe_env = dict(os.environ, OMP_NUM_THREADS="1")
    probe = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "adasum_probe.py"), "-np", "4",
         "-H", "localhost:2,127.0.0.1:2", "--device", "cpu", "--depth",
         "tiny", "--image", "32", "--batch", "2", "--steps", "3"],
        cwd=REPO, env=probe_env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    procs["probe"] = (probe, None, 4)
    for name, (pkg, head, cases, n, hosts, env) in specs.items():
        out = str(tmp / (name + ".{}.npz"))
        script = tmp / f"{name}_cases.py"
        script.write_text(textwrap.dedent(head) + f"OUT = {out!r}\n"
                          + textwrap.dedent(cases))
        procs[name] = (_launch(pkg, script, n, hosts, env), out, n)
    logs = {}
    try:
        for name, (p, out, n) in procs.items():
            try:
                logs[name] = p.communicate(timeout=150)[0]
            except subprocess.TimeoutExpired:
                os.killpg(p.pid, signal.SIGKILL)
                raise AssertionError(f"{name} job timed out:\n"
                                     f"{p.communicate()[0]}")
            if out is None:  # the probe: its exit code and its log
                outs[name] = (p.returncode, logs[name])
                continue
            assert p.returncode == 0 and all(
                f"CASES_OK {r}" in logs[name] for r in range(n)), logs[name]
            outs[name] = [dict(np.load(out.format(r))) for r in range(n)]
    finally:
        for p, _, _ in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    return outs


def _bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind == "U":
        return a.dtype == b.dtype and a.tolist() == b.tolist()
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8))


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max(initial=0.0)
    assert err <= tol * np.abs(want).max(initial=0.0), err


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_two_processes_adasum_is_the_same_on_both_ranks(jobs, pkg):
    r0, r1 = jobs[pkg]
    assert sorted(r0) == sorted(r1)
    for k in r0:
        assert _bitwise(r0[k], r1[k]), (pkg, k)
    assert str(r0["class"]) == "DistributedAdasumSGD"
    assert bool(r0["skip_raises"])


def test_two_processes_adasum_matches_the_jax_package(jobs):
    for r in range(2):
        p, j = jobs["port"][r], jobs["jax"][r]
        assert sorted(p) == sorted(j)
        for k in ("eager", "scaled"):
            _close(p[k], j[k], TOL)
        opt = [k for k in p if k.startswith("opt.")]
        assert len(opt) == 3 * 4
        for k in opt:
            _close(p[k], j[k], OPT_TOL)
        # the committed step moved every parameter
        assert not np.array_equal(p["opt.2.0.weight"], p["opt.0.0.weight"])


def test_two_processes_adasum_eager_against_the_tree(jobs):
    """The eager result is JAX's ``adasum_tree_reduce`` of both ranks'
    prescaled rows, postscaled."""
    xs = [np.random.RandomState(100 + r).randn(37).astype(np.float32)
          for r in range(2)]
    tree = np.asarray(jada.adasum_tree_reduce(jnp.stack(xs)))
    _close(jobs["port"][0]["eager"], tree, TOL)
    scaled = np.asarray(jada.adasum_tree_reduce(jnp.stack(xs) * 0.5)) * 2.0
    _close(jobs["port"][0]["scaled"], scaled, TOL)


_jtree = jax.jit(jada.adasum_tree_reduce)


def _group_rows(seed0, nranks):
    return [np.stack([np.random.RandomState(seed0 + 10 * i + r).randn(n)
                      .astype(np.float32) for r in range(nranks)])
            for i, n in enumerate(GROUP_SIZES)]


def test_two_processes_grouped_adasum_is_one_chunk(jobs):
    """Twelve Adasum tensors enqueued together: one chunk, one allgather
    in the port; each tensor JAX's per-tensor Adasum (the JAX package's
    job and ``adasum_tree_reduce`` of the prescaled rows, postscaled)
    within ``TOL``, bitwise the same on both ranks."""
    p0, p1 = jobs["port"]
    assert int(p0["group.chunks"]) == 1 and int(p0["group.calls"]) == 1
    for i, rows in enumerate(_group_rows(400, 2)):
        key = f"group.{i}"
        assert _bitwise(p0[key], p1[key]), key
        _close(p0[key], jobs["jax"][0][key], TOL)
        want = np.asarray(_jtree(rows * 0.5))
        _close(p0[key], want * 4.0, TOL)


HIER_KEYS = ["fused.sum.0", "fused.sum.1", "fused.sum.2", "fused.sum.3",
             "fused.avg.0", "fused.avg.1", "fused.avg.2", "fused.avg.3",
             "one", "eager.sum", "eager.avg"]


@pytest.mark.parametrize("key", HIER_KEYS)
def test_two_level_sums_bitwise_on_every_rank_and_close_to_flat(jobs, key):
    ranks = jobs["hier"]
    for r in ranks[1:]:
        assert _bitwise(r[f"hier.{key}"], ranks[0][f"hier.{key}"]), key
        assert _bitwise(r[f"flat.{key}"], ranks[0][f"flat.{key}"]), key
    _close(ranks[0][f"hier.{key}"], ranks[0][f"flat.{key}"], TOL)
    # and both against the sum of the inputs in fp64
    i = int(key[-1]) if key.startswith("fused") else (2 if key == "one"
                                                      else 3)
    rows = np.stack([r[f"in.{i}"] for r in ranks]).astype(np.float64)
    pre, post = {"fused.sum": (0.5, 3.0), "eager.avg": (2.0, 0.5)}.get(
        key.rsplit(".", 1)[0] if key.startswith("fused") else key, (1, 1))
    avg = "avg" in key or key == "one"
    want = (rows * pre).sum(0) * post / (4 if avg else 1)
    _close(ranks[0][f"hier.{key}"], want, TOL)


def test_two_level_plans_and_calls(jobs):
    """The fused chunks ran two-level plans, and two levels make more
    calls into the communicator than one."""
    r0 = jobs["hier"][0]
    assert int(r0["hier.plans"]) >= 2
    assert int(r0["hier.calls"]) > int(r0["flat.calls"])


@pytest.mark.parametrize("key", ["gather", "ragged"])
def test_two_level_allgather_is_bitwise_the_flat_one(jobs, key):
    ranks = jobs["hier"]
    for r in ranks:
        assert _bitwise(r[f"hier.{key}"], r[f"flat.{key}"])
        assert _bitwise(r[f"hier.{key}"], ranks[0][f"hier.{key}"])
    assert ranks[0][f"hier.{key}"].shape[0] == (12 if key == "gather"
                                                 else 1 + 2 + 3 + 4)


def test_two_level_adasum_matches_jax_hierarchical(jobs):
    ranks = jobs["hier"]
    g = np.stack([r["in.2"] for r in ranks])
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("cross", "local"))
    spec = P(("cross", "local"))
    f = jax.jit(jax.shard_map(
        lambda x: jada.adasum_allreduce_hierarchical(x, "local", "cross"),
        mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False))
    want = np.asarray(f(jnp.asarray(g)))
    for r, got in enumerate(ranks):
        assert _bitwise(got["hier.adasum"], ranks[0]["hier.adasum"])
        assert _bitwise(got["flat.adasum"], ranks[0]["flat.adasum"])
        _close(got["hier.adasum"], want[r], TOL)
    # flat Adasum is the tree over the four ranks, another result
    tree = np.asarray(jada.adasum_tree_reduce(jnp.asarray(g)))
    _close(ranks[0]["flat.adasum"], tree, TOL)
    assert not np.allclose(ranks[0]["flat.adasum"], want[0])


@pytest.mark.parametrize("tag", ["hier", "flat"])
def test_grouped_adasum_chunk_at_four_ranks(jobs, tag):
    """Twelve Adasum tensors enqueued together as one chunk. Two levels:
    one reduce-scatter, one send/recv pair and one allreduce of an
    fp32[12, 3] (the round across the two hosts), one allgather; each
    tensor JAX's ``adasum_allreduce_hierarchical`` within ``TOL``. Flat:
    one allgather; each tensor JAX's ``adasum_tree_reduce`` within
    ``TOL``. Every rank holds rank 0's bits."""
    ranks = jobs["hier"]
    r0 = ranks[0]
    calls = {k: int(r0[f"{tag}.group.{k}"]) for k in (
        "reduce_scatter", "all_gather", "all_reduce", "batch_isend_irecv")}
    assert int(r0[f"{tag}.group.chunks"]) == 1
    if tag == "hier":
        assert calls == {"reduce_scatter": 1, "all_gather": 1,
                         "all_reduce": 1, "batch_isend_irecv": 1}, calls
        assert r0["hier.group.allreduce_shapes"].tolist() == [
            [len(GROUP_SIZES), 3]]
    else:
        assert calls == {"reduce_scatter": 0, "all_gather": 1,
                         "all_reduce": 0, "batch_isend_irecv": 0}, calls
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                ("cross", "local"))
    spec = P(("cross", "local"))
    hier = jax.jit(jax.shard_map(
        lambda x: jada.adasum_allreduce_hierarchical(x, "local", "cross"),
        mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False))
    for i, rows in enumerate(_group_rows(500, 4)):
        key = f"{tag}.group.{i}"
        for r in ranks[1:]:
            assert _bitwise(r[key], r0[key]), key
        if tag == "hier":
            want = np.asarray(hier(jnp.asarray(rows)))[0]
        else:
            want = np.asarray(_jtree(rows))
        _close(r0[key], want, TOL)


def test_adasum_probe_at_four_ranks_on_the_cpu(jobs):
    rc, log = jobs["probe"]
    assert rc == 0, log
    assert "2 hosts of 2" in log and "parameters bitwise equal on every " \
        "rank after every step" in log, log
    for arm in ("average", "average_hier", "adasum", "adasum_hier",
                "average_syncbn"):
        assert f"  {arm}: step ms" in log, arm
