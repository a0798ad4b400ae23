"""The compressed wire across two processes: one gloo job per wire mode
(``HOROVOD_COMPRESSION`` bf16, int8, int4) through the port's ``hvdrun``
and the same job through the JAX package's (``horovod_tpu.torch``), all
six started at once. Each job reduces a fused chunk with an opt-out name
(``layer.bias``) and a small leaf (``tiny``), sends one tensor over the
int8 or int4 wire (the port through its front end, ``hvd.allreduce``
with the ``Compression`` marker, the runtime's path; the JAX package
through its eager ``_eager_quantized_allreduce``), and takes two
``DistributedOptimizer`` steps of a tiny LM, error feedback carried from
the first to the second; every result, the wire bytes and the fallbacks
counted must be bitwise equal between the packages, and the reduced
values equal on both ranks. ``wire_probe.py`` is smoked at two gloo
ranks.

A rank holds its cycle's drain while it enqueues (the chunk and each
backward's gradients), so that each rank's cycle takes all of it at once:
the JAX runtime wakes its cycle on every enqueue, and a block of the
quantized wire spans tensor boundaries, so chunks formed by timing would
differ between the packages and from run to run.
"""

import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("bf16", "int8", "int4")


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[a.itemsize])


PORT_HEAD = """
    import sys
    sys.modules["jax"] = None
    sys.modules["horovod_tpu"] = None
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import context
    from horovod_tpu_torch.ops import compression as comp
    from horovod_tpu_torch.utils import metrics
    torch.set_num_threads(1)
    hvd.init(device="cpu")
    r = hvd.rank()
    RT = context.runtime()
    REG = metrics.get_registry()

    def eager_q(x, spec):
        marker = hvd.Compression.int8 if spec.bits == 8 \
            else hvd.Compression.int4
        return hvd.allreduce(x, name="eager.q", op=hvd.Sum,
                             compression=marker)

    def fallbacks():
        return {k: REG.counter_value("hvd_quant_fallback_total", reason=k)
                for k in ("optout_match", "small_leaf", "non_float")}
"""

JAX_HEAD = """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import torch
    import horovod_tpu as core
    import horovod_tpu.torch as hvd
    from horovod_tpu.ops import collectives as C
    from horovod_tpu.ops import compression as comp
    from horovod_tpu.utils import metrics
    torch.set_num_threads(1)
    hvd.init()
    r = hvd.cross_rank()
    RT = core._runtime()
    REG = metrics.get_registry()

    def eager_q(x, spec):
        out = C._eager_quantized_allreduce(
            x.numpy(), C.ReduceOp.SUM, core.global_process_set(), 1.0, 1.0,
            spec, name="eager.q")
        return torch.from_numpy(np.asarray(out))

    def fallbacks():
        got = dict.fromkeys(("optout_match", "small_leaf", "non_float"), 0)
        for c in REG.snapshot()["counters"]:
            if c["name"] == "hvd_quant_fallback_total":
                got[c["labels"]["reason"]] = got.get(
                    c["labels"]["reason"], 0) + c["value"]
        return {k: got[k] for k in ("optout_match", "small_leaf",
                                    "non_float")}
"""

JOB_BODY = """
    import threading
    import numpy as np
    from horovod_tpu_torch.models import transformer as PT
    from horovod_tpu_torch.parallel import ring_attention

    # hold the cycle's drain while a rank enqueues, so that each rank's
    # cycle takes all of it at once: the chunks do not depend on timing
    hold = threading.Event()
    real_drain = RT.queue.drain
    RT.queue.drain = lambda: [] if hold.is_set() else real_drain()
    res = {}
    rs = np.random.RandomState(20 + r)
    ts = {"layer.weight": rs.randn(300, 40), "layer.bias": rs.randn(5000),
          "tiny": rs.randn(30), "head.weight": rs.randn(6000)}
    ts = {k: torch.from_numpy(v.astype(np.float32)) for k, v in ts.items()}
    hold.set()
    hs = {k: hvd.allreduce_async(v, name=k, op=hvd.Average)
          for k, v in ts.items()}
    hold.clear()
    for k, h in hs.items():
        res["chunk." + k] = hvd.synchronize(h).numpy()
    spec = comp.resolve_quant_spec()
    if spec.bits != 16:
        res["eager"] = eager_q(ts["head.weight"], spec).numpy()
    cfg = PT.TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                               n_layers=2, d_ff=64, max_seq=16,
                               dtype=torch.float32)
    model = PT.TransformerLM(cfg, device="cpu", seed=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9),
        named_parameters=model.named_parameters())
    for step in range(2):
        tokens = torch.from_numpy(
            np.random.RandomState(100 + 10 * r + step).randint(0, 64, (2, 17)))
        opt.zero_grad()
        hold.set()
        loss = PT.lm_loss(model, tokens, attn_fn=ring_attention)
        loss.backward()
        hold.clear()
        opt.step()
        res[f"loss{step}"] = np.array(loss.item())
    for n, p in model.named_parameters():
        res["param." + n] = p.detach().numpy()
    res["wire_bytes"] = np.array(float(REG.counter_value(
        "hvd_quant_wire_bytes_total")))
    res["blocks"] = np.array(float(REG.counter_value(
        "hvd_quant_blocks_total")))
    for k, v in fallbacks().items():
        res["fallback." + k] = np.array(float(v))
    np.savez(OUT.format(r), **res)
    hvd.shutdown()
    print("JOB_OK", r)
"""


def _start(package: str, script, env):
    return subprocess.Popen(
        [sys.executable, "-m", f"{package}.runner", "-np", "2",
         sys.executable, str(script)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)


def _finish(p, package: str, timeout: float):
    try:
        out = p.communicate(timeout=timeout)[0]
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out = p.communicate()[0]
        raise AssertionError(f"{package} hvdrun job timed out:\n{out}")
    assert p.returncode == 0, out
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every job's dump by package and rank: {mode: {"port": [...], "jax":
    [...]}}; the six jobs run at once."""
    tmp = tmp_path_factory.mktemp("wire_jobs")
    procs = []
    for mode in MODES:
        env = dict(os.environ, OMP_NUM_THREADS="1", HOROVOD_COMPRESSION=mode,
                   HOROVOD_QUANT_MIN_ELEMS="100")
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        for pkg, head, runner in (("port", PORT_HEAD, "horovod_tpu_torch"),
                                  ("jax", JAX_HEAD, "horovod_tpu")):
            out = str(tmp / f"{mode}.{pkg}.{{}}.npz")
            script = tmp / f"{mode}_{pkg}_job.py"
            script.write_text(f"OUT = {out!r}\n" + textwrap.dedent(head)
                              + textwrap.dedent(JOB_BODY))
            procs.append((runner, _start(runner, script, env)))
    try:
        for runner, p in procs:
            _finish(p, runner, 240.0)
    finally:
        for _, p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
    return {mode: {pkg: [dict(np.load(tmp / f"{mode}.{pkg}.{r}.npz"))
                         for r in (0, 1)] for pkg in ("port", "jax")}
            for mode in MODES}


@pytest.mark.parametrize("mode", MODES)
def test_two_process_wire_matches_jax_package(results, mode):
    got = results[mode]
    for r in (0, 1):
        port, jax_ = got["port"][r], got["jax"][r]
        assert sorted(port) == sorted(jax_)
        for k in port:
            np.testing.assert_array_equal(_bits(port[k]), _bits(jax_[k]),
                                          err_msg=k)
        assert port["wire_bytes"] > 0
        assert port["fallback.optout_match"] >= 1
        assert port["fallback.small_leaf"] >= 1
        assert ("eager" in port) == (mode != "bf16")
    for k in got["port"][0]:
        if k.startswith(("chunk.", "param.", "eager")):
            # the ranks agree on every reduced value
            np.testing.assert_array_equal(got["port"][0][k],
                                          got["port"][1][k], err_msg=k)


def test_wire_probe_at_two_ranks_on_the_cpu():
    """``wire_probe.py -np 2 --device cpu``: a tiny LM trained with the
    wire off and with int4, parameters equal on both ranks after every
    step, the first losses equal, the later ones in the band."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, os.path.join(REPO, "wire_probe.py"),
                        "-np", "2", "--device", "cpu", "--steps", "2",
                        "--modes", "off,int4", "--timeout", "120"],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "2 ranks on cpu, 2 wire modes, parameters equal on every rank" \
        in p.stdout
