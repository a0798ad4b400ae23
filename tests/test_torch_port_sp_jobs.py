"""Sequence parallelism across processes: the port's ring, striped ring and
Ulysses over ``torch.distributed`` (gloo) in a 2-process and a 4-process
job through the port's ``hvdrun``, held against the simulated rings of
``parallel.sp`` (all ranks in one process, the rotation a list roll), which
``tests/test_torch_port_sp.py`` holds against the JAX package; and
``sp_probe.py --device cpu``, which trains the LM with ``remat``, the
chunked loss and ``DistributedOptimizer``'s hooks on, each layout's
parameters bitwise equal on every rank after every step. All three jobs
start at once.

Each rank draws the same global q, k, v and cotangent from one seed, runs
its shard through the real exchange and the whole sequence through the
simulated ring, and saves both. The forward must agree bit for bit: rank
i's rounds are the same calls on the same tensors. The gradients reach a
block through other ranks' exchanges and are summed in another order:
within 1e-6 of the largest gradient, fp32 summation order.
"""

import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUTS = ("ring", "ring_flash", "striped", "striped_flash", "ulysses")
SIZES = (2, 4)

JOB = """
    import sys
    sys.modules["jax"] = None
    sys.modules["horovod_tpu"] = None
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import sp
    torch.set_num_threads(1)
    hvd.init(device="cpu")
    r, n = hvd.rank(), hvd.size()
    group = hvd.global_process_set().group
    rs = np.random.RandomState(0)
    b, S, h, d = 1, 32, 4, 8
    q, k, v, co = (torch.from_numpy(rs.randn(b, S, h, d).astype(np.float32))
                   for _ in range(4))
    real = {"ring": sp.ring_attention, "striped": sp.striped_ring_attention,
            "ulysses": sp.ulysses_attention}
    res = {}
    for layout in LAYOUTS:
        base, flash = layout.split("_")[0], layout.endswith("_flash")
        ins = [x.clone().requires_grad_() for x in (q, k, v)]
        c = co
        if base == "striped":
            ins = [sp.stripe_tokens(x, n) for x in ins]
            c = sp.stripe_tokens(co, n)
        kw = {} if base == "ulysses" else {"use_flash": flash}
        if base == "ulysses":
            sim = sp._simulated_ulysses(*ins, n)
        else:
            sim = sp._simulated_ring(*ins, n, striped=base == "striped", **kw)
        sim_grads = torch.autograd.grad((sim * c).sum(), ins)
        sl = slice(r * S // n, (r + 1) * S // n)
        loc = [x[:, sl].detach().clone().requires_grad_() for x in ins]
        out = real[base](*loc, group=group, **kw)
        grads = torch.autograd.grad((out * c[:, sl]).sum(), loc)
        res[layout + ".out"] = out.detach().numpy()
        res[layout + ".sim_out"] = sim[:, sl].detach().numpy()
        for name, g, s in zip("qkv", grads, sim_grads):
            res[layout + ".d" + name] = g.numpy()
            res[layout + ".sim_d" + name] = s[:, sl].numpy()
    res["exchanges"] = np.array([sp.exchanges["ppermute"],
                                 sp.exchanges["all_to_all"]])
    np.savez(OUT.format(r), **res)
    hvd.shutdown()
    print("JOB_OK", r)
"""


def _start(cmd, env):
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


def _finish(p, what: str, timeout: float) -> str:
    try:
        out = p.communicate(timeout=timeout)[0]
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out = p.communicate()[0]
        raise AssertionError(f"{what} timed out:\n{out}")
    assert p.returncode == 0, f"{what} failed:\n{out}"
    return out


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """The saved results of the 2- and 4-process jobs by size and rank,
    and ``sp_probe.py``'s output; all started at once."""
    tmp = tmp_path_factory.mktemp("sp_jobs")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = {}
    for n in SIZES:
        script = tmp / f"sp_job_{n}.py"
        script.write_text(f"OUT = {str(tmp / f'{n}.{{}}.npz')!r}\n"
                          f"LAYOUTS = {LAYOUTS!r}\n" + textwrap.dedent(JOB))
        procs[n] = _start([sys.executable, "-m", "horovod_tpu_torch.runner",
                           "-np", str(n), sys.executable, str(script)], env)
    procs["probe"] = _start([sys.executable, os.path.join(REPO, "sp_probe.py"),
                             "-np", "4", "--device", "cpu", "--steps", "2",
                             "--timeout", "200"], env)
    try:
        outs = {key: _finish(p, f"job {key}", 300.0)
                for key, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
    res = {n: [dict(np.load(tmp / f"{n}.{r}.npz")) for r in range(n)]
           for n in SIZES}
    return res, outs["probe"]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n", SIZES)
def test_real_exchange_matches_the_simulated_ring(jobs, n, layout):
    for r, res in enumerate(jobs[0][n]):
        np.testing.assert_array_equal(res[layout + ".out"],
                                      res[layout + ".sim_out"],
                                      err_msg=f"rank {r}")
        for name in "qkv":
            got, want = res[f"{layout}.d{name}"], res[f"{layout}.sim_d{name}"]
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=f"rank {r} d{name}")


@pytest.mark.parametrize("n", SIZES)
def test_exchanges_counted_on_every_rank(jobs, n):
    """Two rings of n-1 rotations each way per flash setting, and four
    all-to-alls each way for Ulysses."""
    for res in jobs[0][n]:
        assert list(res["exchanges"]) == [4 * 2 * (n - 1), 2 * 4]


def test_sp_probe_at_four_ranks_on_the_cpu(jobs):
    """``sp_probe.py -np 4 --device cpu --steps 2``: the LM trained with
    remat, the chunked loss and the optimizer's hooks in every layout,
    parameters equal on every rank after every step, first losses within
    fp32 summation order of the one-rank run's."""
    out = jobs[1]
    assert ("sp_probe: 4 ranks on cpu, layouts ring,striped,ulysses, "
            "parameters equal on every rank after every step") in out, out
    # remat recomputes each block's exchanges: 3 a layer each way
    assert "'ppermute': 18" in out and "'all_to_all': 24" in out, out
