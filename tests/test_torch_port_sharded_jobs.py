"""The ZeRO-1 sharded update across processes, over gloo through the
port's ``hvdrun``: one 2-process and one 3-process job of the port, one
2-process job of the JAX package's torch shim, and ``zero_probe.py -np 2
--device cpu``, all started at once.

Each port job trains a 2-layer LM of width 32 (replicate threshold 1000
elements, so most leaves shard) 3 steps on a batch of its own a rank:

- through ``DistributedOptimizer(sharded_update=True)`` (whole-leaf
  owners) and through the plain wrapper, from the same weights: the
  parameters must be bitwise equal after every step, and equal on every
  rank;
- through ``ShardedUpdateEngine`` in real mode (K1's pack, one
  reduce-scatter in place, the step on the shard, one allgather in place,
  K1's unpack; the small leaves through the runtime): the parameters must
  be bitwise equal on every rank after every step, and at two ranks
  bitwise the plain wrapper's (a sum of two is order-free); the plan hit
  rate after the first step is 1.0;
- ``sharded_update=True`` with ``op=Adasum`` raises the JAX package's
  ``ValueError``.

The 3-process job sets ``HOROVOD_FUSION_THRESHOLD=0``: at three ranks the
allreduce's order of summation follows each element's place in its fused
chunk, and the runtime forms chunks from what its cycle finds ready, so
two wrappers compare bitwise only with one chunk a tensor. The JAX job
runs the JAX package's sharded torch wrapper on the same model and
batches; its parameters must equal the port's sharded front end's, bit
for bit, after every step.
"""

import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3

MODEL = """
    import numpy as np
    from horovod_tpu_torch.models import transformer as PT
    from horovod_tpu_torch.parallel import ring_attention

    CFG = PT.TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                               n_layers=2, d_ff=64, max_seq=16,
                               dtype=torch.float32)

    def batch(step):
        return torch.from_numpy(np.random.RandomState(
            100 + 10 * r + step).randint(0, 64, (2, 17)))

    def sgd(ps):
        return torch.optim.SGD(ps, lr=0.05, momentum=0.9)

    def train(opt, model, step):
        opt.zero_grad()
        loss = PT.lm_loss(model, batch(step), attn_fn=ring_attention)
        loss.backward()
        opt.step()
        return loss.item()
"""

PORT_JOB = """
    import sys
    sys.modules["jax"] = None
    sys.modules["horovod_tpu"] = None
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.opt.sharded import ShardedUpdateEngine
    from horovod_tpu_torch.utils import metrics
    torch.set_num_threads(1)
    hvd.init(device="cpu")
    r, n = hvd.rank(), hvd.size()
    MODEL_CODE
    MSE = 1000

    def same_on_every_rank(params):
        flat = torch.cat([p.detach().reshape(-1) for p in params])
        ref = flat.clone()
        dist.broadcast(ref, 0)
        return torch.equal(flat.view(torch.int32), ref.view(torch.int32))

    res = {}
    m_plain = PT.TransformerLM(CFG, device="cpu", seed=0)
    m_sh = PT.TransformerLM(CFG, device="cpu", seed=0)
    m_eng = PT.TransformerLM(CFG, device="cpu", seed=0)
    o_plain = hvd.DistributedOptimizer(
        sgd(m_plain.parameters()), named_parameters=m_plain.named_parameters())
    o_sh = hvd.DistributedOptimizer(
        sgd(m_sh.parameters()), named_parameters=m_sh.named_parameters(),
        sharded_update=True, min_shard_elems=MSE)
    assert type(o_sh).__name__ == "ShardedDistributedSGD"
    owned = sorted({o for o in o_sh._owners.values() if o is not None})
    assert owned == list(range(n)), owned
    params = list(m_eng.parameters())
    engine = ShardedUpdateEngine(sgd, process_set=hvd.global_process_set(),
                                 min_shard_elems=MSE)
    engine.init(params)
    reg = metrics.get_registry()
    for step in range(STEPS):
        res[f"loss.plain.{step}"] = train(o_plain, m_plain, step)
        res[f"loss.sharded.{step}"] = train(o_sh, m_sh, step)
        for p in params:
            p.grad = None
        loss = PT.lm_loss(m_eng, batch(step), attn_fn=ring_attention)
        loss.backward()
        if step == 1:
            h0 = reg.counter_value("hvd_sharded_plan_hits_total")
            m0 = reg.counter_value("hvd_sharded_plan_misses_total")
        engine.step(params)
        res[f"loss.engine.{step}"] = loss.item()
        assert all(p.grad is None for i, p in enumerate(params)
                   if i not in engine.layout.replicated)
        for name, model in (("plain", m_plain), ("sharded", m_sh),
                            ("engine", m_eng)):
            assert same_on_every_rank(list(model.parameters())), (name, step)
            for i, p in enumerate(model.parameters()):
                res[f"{name}.{step}.{i}"] = p.detach().numpy().copy()
    hits = reg.counter_value("hvd_sharded_plan_hits_total") - h0
    misses = reg.counter_value("hvd_sharded_plan_misses_total") - m0
    res["engine_hit_rate"] = np.array(hits / (hits + misses))
    res["owners"] = np.array([-1 if o is None else o
                              for o in o_sh._owners.values()])
    res["state.plain"] = np.array(sum(
        v.numel() for st in o_plain.state.values() for v in st.values()
        if isinstance(v, torch.Tensor)))
    res["state.sharded"] = np.array(sum(
        v.numel() for st in o_sh.state.values() for v in st.values()
        if isinstance(v, torch.Tensor)))
    res["state.engine"] = np.array(sum(
        v.numel() for st in engine.optimizer.state.values()
        for v in st.values() if isinstance(v, torch.Tensor)))
    try:
        hvd.DistributedOptimizer(sgd(PT.TransformerLM(
            CFG, device="cpu").parameters()), op=hvd.Adasum,
            sharded_update=True)
        res["adasum_error"] = np.array("")
    except ValueError as e:
        res["adasum_error"] = np.array(str(e))
    np.savez(OUT.format(r), **res)
    hvd.shutdown()
    print("JOB_OK", r)
"""

JAX_JOB = """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch
    import horovod_tpu.torch as hvd
    torch.set_num_threads(1)
    hvd.init()
    r = hvd.cross_rank()
    MODEL_CODE
    res = {}
    m_sh = PT.TransformerLM(CFG, device="cpu", seed=0)
    o_sh = hvd.DistributedOptimizer(
        sgd(m_sh.parameters()), named_parameters=m_sh.named_parameters(),
        sharded_update=True, min_shard_elems=1000)
    for step in range(STEPS):
        res[f"loss.sharded.{step}"] = train(o_sh, m_sh, step)
        for i, p in enumerate(m_sh.parameters()):
            res[f"sharded.{step}.{i}"] = p.detach().numpy().copy()
    res["owners"] = np.array([-1 if o is None else o
                              for o in o_sh._owners.values()])
    np.savez(OUT.format(r), **res)
    hvd.shutdown()
    print("JOB_OK", r)
"""


def _script(tmp, name: str, body: str, out: str):
    code = textwrap.dedent(body).replace("MODEL_CODE\n",
                                         textwrap.dedent(MODEL))
    path = tmp / f"{name}.py"
    path.write_text(f"OUT = {out!r}\nSTEPS = {STEPS}\n" + code)
    return path


def _finish(p, timeout: float, what: str) -> str:
    try:
        out = p.communicate(timeout=timeout)[0]
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out = p.communicate()[0]
        raise AssertionError(f"{what} timed out:\n{out}")
    assert p.returncode == 0, f"{what}:\n{out}"
    return out


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Every job's dump by name and rank, and the probe's output."""
    tmp = tmp_path_factory.mktemp("zero_jobs")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for k in ("HOROVOD_SHARDED_UPDATE", "HOROVOD_SHARDED_MIN_ELEMS",
              "HOROVOD_COMPRESSION", "HOROVOD_FUSION_THRESHOLD"):
        env.pop(k, None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    specs = {"port2": ("horovod_tpu_torch", 2, PORT_JOB, {}),
             "port3": ("horovod_tpu_torch", 3, PORT_JOB,
                       {"HOROVOD_FUSION_THRESHOLD": "0"}),
             "jax2": ("horovod_tpu", 2, JAX_JOB, {})}
    procs = {}
    for name, (pkg, np_, body, extra) in specs.items():
        script = _script(tmp, name, body, str(tmp / f"{name}.{{}}.npz"))
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", f"{pkg}.runner", "-np", str(np_),
             sys.executable, str(script)], cwd=REPO, env=dict(env, **extra),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True)
    procs["probe"] = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "zero_probe.py"), "-np", "2",
         "--device", "cpu", "--steps", "3"], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    outs = {}
    try:
        for name, p in procs.items():
            outs[name] = _finish(p, 240.0, name)
    finally:
        for p in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
    dumps = {name: [dict(np.load(tmp / f"{name}.{r}.npz"))
                    for r in range(specs[name][1])] for name in specs}
    return dumps, outs


@pytest.mark.parametrize("job", ["port2", "port3"])
def test_front_end_bitwise_plain_wrapper(jobs, job):
    for d in jobs[0][job]:
        for key, v in d.items():
            if key.startswith("plain."):
                assert np.array_equal(v.view(np.uint32),
                                      d["sharded" + key[5:]].view(np.uint32)
                                      ), (job, key)
        for step in range(STEPS):
            assert d[f"loss.plain.{step}"] == d[f"loss.sharded.{step}"]
        # whole-leaf ownership keeps each rank's state to its own leaves
        assert d["state.sharded"] < d["state.plain"]


@pytest.mark.parametrize("job", ["port2", "port3"])
def test_engine_real_mode_equal_on_every_rank(jobs, job):
    """Equality on every rank is asserted inside the job after every step;
    here the engine's trajectory against the plain wrapper's (bitwise at
    two ranks), its plan hits and its state."""
    dumps = jobs[0][job]
    for d in dumps:
        assert float(d["engine_hit_rate"]) == 1.0
        n = len(dumps)
        assert d["state.engine"] < 0.7 * d["state.plain"] * 2 / n
        for step in range(STEPS):
            for i in range(len([k for k in d if k.startswith(
                    f"plain.{step}.")])):
                a, b = d[f"engine.{step}.{i}"], d[f"plain.{step}.{i}"]
                if n == 2:
                    assert np.array_equal(a.view(np.uint32),
                                          b.view(np.uint32)), (step, i)
                else:
                    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        assert d["loss.engine.0"] == d["loss.plain.0"]


def test_front_end_bitwise_the_jax_shim(jobs):
    port, jax_ = jobs[0]["port2"], jobs[0]["jax2"]
    for r in range(2):
        keys = [k for k in jax_[r] if k.startswith("sharded.")]
        assert len(keys) == STEPS * len([k for k in port[r]
                                         if k.startswith("sharded.0.")])
        assert np.array_equal(port[r]["owners"], jax_[r]["owners"])
        for k in keys:
            assert np.array_equal(port[r][k].view(np.uint32),
                                  jax_[r][k].view(np.uint32)), (r, k)
        for step in range(STEPS):
            assert port[r][f"loss.sharded.{step}"] \
                == jax_[r][f"loss.sharded.{step}"]


@pytest.mark.parametrize("job", ["port2", "port3"])
def test_sharded_adasum_raises_the_jax_error(jobs, job):
    for d in jobs[0][job]:
        assert str(d["adasum_error"]) == (
            "sharded_update is not supported with op=Adasum")


def test_zero_probe_at_two_gloo_ranks(jobs):
    out = jobs[1]["probe"]
    assert "zero_probe: 2 ranks on cpu, 3 arms" in out, out
    assert "whole_leaf: loss gaps" in out and "engine: loss gaps" in out
