"""Synchronized batch norm in the port against the JAX package, on the CPU.

- ``hvd.SyncBatchNorm`` at one process against
  ``horovod_tpu.torch.SyncBatchNorm`` on the same seeded inputs: the
  output, the input and weight gradients and the running statistics, over
  two training steps and one eval step, bit for bit (at one process
  neither exchanges anything and both are the same torch arithmetic);
  ``convert_sync_batchnorm`` keeps the parameters and buffers.
- One 2-process job through the port's ``hvdrun`` (gloo), which runs:
  ``hvd.SyncBatchNorm`` on each rank's half of one batch, against the JAX
  module at one process on the concatenated batch (output and input
  gradient of each half, the weight gradients summed over the ranks, the
  running statistics), within 1e-5 of each tensor's largest magnitude
  (the moments averaged over two ranks instead of taken at once); and a
  small ResNet (one block a stage, 8 filters, 10 classes, fp32, 64^2
  images, 2 a rank) with ``sync_bn_group`` over the two ranks, one
  training forward and backward, against the flax ResNet with
  ``axis_name`` under ``shard_map`` on two CPU devices from the same
  weights: logits, each rank's gradients and the running statistics within
  ``RESNET_TOL`` of each tensor's largest magnitude (fp32 summation order,
  as ``tests/test_torch_port_resnet_jobs.py``).
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
import torch
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu.torch as jhvd
import horovod_tpu_torch as hvd
from horovod_tpu.models import resnet as R
from horovod_tpu_torch.models import resnet as PR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import resnet_probe as probe  # noqa: E402
from test_torch_port_resnet_jobs import _to_flax  # noqa: E402

BN_TOL, RESNET_TOL = 1e-5, 1e-4
C, HALF, IMAGE = 4, 3, 64


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(n, seed, shape=(5, 2)):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, C, *shape).astype(np.float32) * 2 + 0.5
    cot = rs.randn(n, C, *shape).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(cot)


def _run_bn(bn, x, cot):
    x = x.clone().requires_grad_()
    bn.zero_grad()
    out = bn(x)
    (out * cot).sum().backward()
    return out.detach(), x.grad, bn.weight.grad.clone(), bn.bias.grad.clone()


@pytest.fixture(scope="module")
def port():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


@pytest.mark.parametrize("momentum", [0.1, None])
def test_one_process_matches_the_jax_module(port, momentum):
    torch.manual_seed(0)
    mine = hvd.SyncBatchNorm(C, momentum=momentum)
    ref = jhvd.SyncBatchNorm(C, momentum=momentum)
    with torch.no_grad():
        for bn in (mine, ref):
            bn.weight.copy_(torch.linspace(0.5, 1.5, C))
            bn.bias.copy_(torch.linspace(-0.2, 0.3, C))
    for step in range(2):
        x, cot = _batch(6, seed=step)
        for a, b in zip(_run_bn(mine, x, cot), _run_bn(ref, x, cot)):
            assert torch.equal(a, b)
        for name in ("running_mean", "running_var", "num_batches_tracked"):
            assert torch.equal(getattr(mine, name), getattr(ref, name))
    mine.eval()
    ref.eval()
    x, _ = _batch(6, seed=9)
    assert torch.equal(mine(x), ref(x))


def test_one_process_agrees_with_torch_batch_norm(port):
    x, cot = _batch(8, seed=3)
    mine, ref = hvd.SyncBatchNorm(C), torch.nn.BatchNorm2d(C)
    for a, b in zip(_run_bn(mine, x, cot), _run_bn(ref, x, cot)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(mine.running_var, ref.running_var)


def test_convert_sync_batchnorm_keeps_parameters_and_buffers(port):
    model = torch.nn.Sequential(torch.nn.Conv2d(2, C, 1),
                                torch.nn.BatchNorm2d(C),
                                torch.nn.Sequential(torch.nn.BatchNorm1d(3)))
    with torch.no_grad():
        model[1].weight.fill_(2.0)
        model[1].running_mean.fill_(0.5)
    conv = hvd.SyncBatchNorm.convert_sync_batchnorm(model)
    assert isinstance(conv[1], hvd.SyncBatchNorm)
    assert isinstance(conv[2][0], hvd.SyncBatchNorm)
    assert conv[1].weight.tolist() == [2.0] * C
    assert conv[1].running_mean.tolist() == [0.5] * C
    assert conv[1]._hvd_name != conv[2][0]._hvd_name
    assert conv[1]._hvd_name.startswith("torch.sync_bn.")


# --- two processes ----------------------------------------------------------

JOB = """
    import sys
    sys.modules["jax"] = None
    sys.modules["horovod_tpu"] = None
    import numpy as np
    import torch
    import torch.nn.functional as F
    import horovod_tpu_torch as hvd
    import resnet_probe as probe
    torch.set_num_threads(1)
    hvd.init(device="cpu")
    r = hvd.rank()
    res = {}
    # hvd.SyncBatchNorm on this rank's half of the batch
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(2 * HALF, C, 5, 2).astype(np.float32)
                         * 2 + 0.5)[r * HALF:(r + 1) * HALF]
    cot = torch.from_numpy(rs.randn(2 * HALF, C, 5, 2).astype(np.float32)
                           )[r * HALF:(r + 1) * HALF]
    bn = hvd.SyncBatchNorm(C)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, C))
        bn.bias.copy_(torch.linspace(-0.2, 0.3, C))
    x.requires_grad_()
    out = bn(x)
    (out * cot).sum().backward()
    res.update(bn_out=out.detach().numpy(), bn_gx=x.grad.numpy(),
               bn_gw=bn.weight.grad.numpy(), bn_gb=bn.bias.grad.numpy(),
               bn_rm=bn.running_mean.numpy(), bn_rv=bn.running_var.numpy())
    # the small ResNet with its batch norms synchronized over the ranks
    from horovod_tpu_torch.models.resnet import ResNet
    stages, filters, classes = probe.CONFIGS["tiny"]
    model = ResNet(stages, num_classes=classes, num_filters=filters,
                   dtype=torch.float32, device="cpu", seed=0,
                   sync_bn_group=hvd.global_process_set().group)
    images, labels = probe.synthetic_batch(0, 2, 2, IMAGE, classes, r,
                                           torch.device("cpu"))
    logits = model(images)
    F.cross_entropy(logits, labels).backward()
    res["logits"] = logits.detach().numpy()
    for k, p in model.named_parameters():
        res["grad." + k] = p.grad.numpy()
    for k, b in model.named_buffers():
        res["buf." + k] = b.numpy()
    np.savez(OUT.format(r), **res)
    hvd.shutdown()
    print("JOB_OK", r)
"""


def _flax_reference():
    """Logits, per-device gradients and batch statistics of the flax
    ResNet with ``axis_name`` under ``shard_map`` on two CPU devices, from
    the port's initial weights, as ``state_dict`` arrays a device."""
    stages, filters, classes = probe.CONFIGS["tiny"]
    model = R.ResNet(stage_sizes=stages, num_filters=filters,
                     num_classes=classes, dtype=jnp.float32,
                     axis_name="batch")
    shapes = jax.eval_shape(
        lambda x: R.ResNet(stage_sizes=stages, num_filters=filters,
                           num_classes=classes, dtype=jnp.float32).init(
            jax.random.PRNGKey(0), x, train=True),
        jax.ShapeDtypeStruct((2, IMAGE, IMAGE, 3), jnp.float32))
    init = probe.build("tiny", torch.device("cpu"), 0).state_dict()
    variables = _to_flax(init, shapes)
    batches = [probe.synthetic_batch(0, 2, 2, IMAGE, classes, r,
                                     torch.device("cpu")) for r in range(2)]
    x = np.concatenate([b[0].permute(0, 2, 3, 1).numpy() for b in batches])
    y = np.concatenate([b[1].numpy() for b in batches])

    def per_device(params, stats, xb, yb):
        def loss_fn(p):
            logits, upd = model.apply({"params": p, "batch_stats": stats},
                                      xb, train=True,
                                      mutable=["batch_stats"])
            loss = optax.softmax_cross_entropy_with_integer_labels(
                logits, yb).mean()
            return loss, (logits, upd["batch_stats"])

        g, (logits, new) = jax.grad(loss_fn, has_aux=True)(params)
        lead = lambda t: jax.tree_util.tree_map(lambda a: a[None], t)
        return lead(g), logits, lead(new)

    mesh = Mesh(np.array(jax.devices()[:2]), ("batch",))
    f = jax.jit(jax.shard_map(
        per_device, mesh=mesh,
        in_specs=(P(), P(), P("batch"), P("batch")),
        out_specs=(P("batch"), P("batch"), P("batch")), check_vma=False))
    grads, logits, stats = f(variables["params"], variables["batch_stats"],
                             jnp.asarray(x), jnp.asarray(y))
    out = []
    for r in range(2):
        g = jax.tree_util.tree_map(lambda a: np.asarray(a[r]), grads)
        s = jax.tree_util.tree_map(lambda a: np.asarray(a[r]), stats)
        sd = {k: v.numpy() for k, v in PR.params_from_jax(g, s).items()}
        out.append((np.asarray(logits)[2 * r:2 * r + 2], sd))
    return out


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sync_bn_job")
    out = str(tmp / "rank{}.npz")
    script = tmp / "sync_bn_worker.py"
    script.write_text(textwrap.dedent(JOB).replace(
        "import numpy as np\n",
        f"import numpy as np\nOUT = {out!r}\nHALF, C, IMAGE = {HALF}, {C}, "
        f"{IMAGE}\n", 1))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         sys.executable, str(script)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        ref = _flax_reference()  # while the job runs
        log = p.communicate(timeout=180)[0]
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.communicate()
    assert p.returncode == 0 and "JOB_OK 0" in log and "JOB_OK 1" in log, log
    return [dict(np.load(out.format(r))) for r in range(2)], ref


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max(initial=0.0)
    assert err <= tol * np.abs(want).max(initial=0.0) + 1e-9, err


def test_two_processes_match_the_jax_module_on_the_whole_batch(job):
    ranks, _ = job
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(2 * HALF, C, 5, 2).astype(np.float32)
                         * 2 + 0.5)
    cot = torch.from_numpy(rs.randn(2 * HALF, C, 5, 2).astype(np.float32))
    ref = jhvd.SyncBatchNorm(C)
    with torch.no_grad():
        ref.weight.copy_(torch.linspace(0.5, 1.5, C))
        ref.bias.copy_(torch.linspace(-0.2, 0.3, C))
    out, gx, gw, gb = _run_bn(ref, x, cot)
    for r, got in enumerate(ranks):
        half = slice(r * HALF, (r + 1) * HALF)
        _close(got["bn_out"], out[half].numpy(), BN_TOL)
        _close(got["bn_gx"], gx[half].numpy(), BN_TOL)
        _close(got["bn_rm"], ref.running_mean.numpy(), BN_TOL)
        _close(got["bn_rv"], ref.running_var.numpy(), BN_TOL)
    _close(ranks[0]["bn_gw"] + ranks[1]["bn_gw"], gw.numpy(), BN_TOL)
    _close(ranks[0]["bn_gb"] + ranks[1]["bn_gb"], gb.numpy(), BN_TOL)


def test_two_processes_resnet_sync_bn_matches_flax_axis_name(job):
    ranks, ref = job
    for r, got in enumerate(ranks):
        logits, sd = ref[r]
        _close(got["logits"], logits, RESNET_TOL)
        for k, want in sd.items():
            kind = "buf." if "running" in k else "grad."
            _close(got[kind + k], want, RESNET_TOL)
    # the statistics are the two ranks' batch: the same on both
    for k in ranks[0]:
        if k.startswith("buf."):
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k])


def test_resnet_without_a_group_is_unchanged(port):
    """``sync_bn_group`` over a world of one agrees with the unsynchronized
    path within fp32 rounding (the variance from E[x^2] - E[x]^2 against
    torch's kernel), and without a group nothing changes."""
    stages, filters, classes = probe.CONFIGS["tiny"]
    images, labels = probe.synthetic_batch(0, 1, 4, 32, classes, 0,
                                           torch.device("cpu"))
    outs = []
    for group in (None, hvd.global_process_set().group):
        m = PR.ResNet(stages, num_classes=classes, num_filters=filters,
                   dtype=torch.float32, device="cpu", seed=0,
                   sync_bn_group=group)
        logits = m(images)
        torch.nn.functional.cross_entropy(logits, labels).backward()
        outs.append((logits.detach(), {k: p.grad for k, p in
                                       m.named_parameters()},
                     dict(m.named_buffers())))
    (l0, g0, b0), (l1, g1, b1) = outs
    torch.testing.assert_close(l1, l0, rtol=1e-4, atol=1e-4)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-3,
                                   atol=1e-4 * g0[k].abs().max().item())
    for k in b0:
        torch.testing.assert_close(b1[k], b0[k], rtol=1e-4, atol=1e-5)
