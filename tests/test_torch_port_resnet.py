"""Parity of the port's ResNet (``horovod_tpu_torch/models/resnet.py``)
with the JAX package's flax model, on the CPU.

- ``params_from_jax`` covers ResNet-50/101/152 at full width exactly,
  checked against ``jax.eval_shape`` of the flax model (no weights on the
  JAX side);
- a reduced ResNet (one block a stage, 8 filters, 10 classes, batch 4) in
  fp32 at 32² and 33² and in bf16 at 32², with the same random parameters
  and batch statistics (numpy from a seed; the zero-initialized third BN
  scale would zero most gradients) in both: the train-mode logits, loss
  and every gradient, the updated batch statistics, and the eval-mode
  logits against flax's ``apply(..., mutable=["batch_stats"])`` and
  ``jax.value_and_grad``;
- one ``DistributedOptimizer`` SGD step with momentum against
  ``optax.sgd(0.05, momentum=0.9)``;
- the two traps of a naive port, each with a check that the naive version
  fails: flax's "SAME" stride-2 padding is (0, 1) on even inputs, and its
  running variance is the biased one.

Tolerances (``FP32_TOL``, ``BF16_FLOOR``). fp32 covers summation order:
each tensor within a bound relative to its largest magnitude, 1e-4 for
logits, loss and eval logits, 2e-5 for the statistics, 1e-3 for the
gradients (at 32² the last stage normalizes over four values a channel,
which amplifies rounding: torch's and XLA's gradients differ by up to 3e-4
there, by 2e-5 at 33²). bf16 at this size is far from its fp32 result in
flax itself (BN over four values in bf16: flax's bf16 gradients are 47 %
off its fp32 ones, as a norm), so the port's bf16 results are held against
flax's fp32 ones: each group's error, as a norm over its tensors, at most
twice flax's own bf16 error plus 2^-6 (bf16 keeps 8 significant bits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

import horovod_tpu_torch as hvd
from horovod_tpu.models import resnet as R
from horovod_tpu_torch.models import resnet as PR

SMALL = dict(stage_sizes=[1, 1, 1, 1], num_filters=8, num_classes=10)
BATCH = 4
FP32_TOL = {"logits": 1e-4, "loss": 1e-4, "eval": 1e-4, "grads": 1e-3,
            "stats": 2e-5}
BF16_FLOOR = 2.0 ** -6
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# fp32 at an even and an odd size (the "SAME" pads differ), bf16 at the
# even one
CASES = [("float32", 32), ("float32", 33), ("bfloat16", 32)]
# XLA's CPU backend without its costly passes: these programs run once,
# and compiling them dominates the test's time
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # tiny shapes: one intra-op thread is enough, and leaves the cores to
    # the suite's other workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _random_variables(shapes, seed: int = 0):
    """Random flax variables of the given shapes: lecun-scaled kernels,
    BN scales near 1, small biases and means, variances in [0.5, 1.5]."""
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rs.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if "scale" in name:
            return (1.0 + 0.2 * rs.randn(*s.shape)).astype(np.float32)
        if "var" in name:
            return (0.5 + rs.rand(*s.shape)).astype(np.float32)
        return (0.1 * rs.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def small():
    """The reduced flax model per dtype, random variables, and a cache of
    reference results by case."""
    model = {d: R.ResNet(**SMALL, dtype=jd) for d, (jd, _) in DTYPES.items()}
    shapes = jax.eval_shape(
        lambda x: model["float32"].init(jax.random.PRNGKey(0), x,
                                        train=True),
        jax.ShapeDtypeStruct((BATCH, 32, 32, 3), jnp.float32))
    variables = _random_variables(shapes)
    return model, variables, {}


def _batch(hw: int):
    rs = np.random.RandomState(hw)
    return (rs.randn(BATCH, hw, hw, 3).astype(np.float32),
            rs.randint(0, SMALL["num_classes"], (BATCH,)))


def _reference(small, dtype: str, hw: int) -> dict:
    """flax's results for one case by group (computed once): the
    train-mode ``logits``, ``loss``, ``grads`` and updated ``stats``, and
    the eval-mode logits (``eval``), each a dict of state_dict names (or
    the group's own name) to numpy arrays; and the gradients' flax tree
    (``grad_tree``)."""
    model, variables, cache = small
    if (dtype, hw) in cache:
        return cache[dtype, hw]
    m = model[dtype]

    def ref(params, stats, x, y):
        def loss_fn(p):
            logits, upd = m.apply({"params": p, "batch_stats": stats}, x,
                                  train=True, mutable=["batch_stats"])
            loss = optax.softmax_cross_entropy_with_integer_labels(
                logits, y).mean()
            return loss, (logits, upd["batch_stats"])

        (loss, (logits, new_stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        eval_logits = m.apply({"params": params, "batch_stats": stats}, x,
                              train=False)
        return loss, logits, new_stats, grads, eval_logits

    x, y = _batch(hw)
    args = (variables["params"], variables["batch_stats"], x, y)
    out = jax.jit(ref).lower(*args).compile(FAST_COMPILE)(*args)
    loss, logits, new_stats, grads, eval_logits = _np(out)
    sd = {k: v.numpy() for k, v in PR.params_from_jax(grads,
                                                       new_stats).items()}
    cache[dtype, hw] = {
        "logits": {"logits": logits}, "loss": {"loss": np.float32(loss)},
        "grads": {k: v for k, v in sd.items() if "running" not in k},
        "stats": {k: v for k, v in sd.items() if "running" in k},
        "eval": {"eval": eval_logits}, "grad_tree": grads}
    return cache[dtype, hw]


def _port_model(small, dtype: str):
    _, variables, _ = small
    m = PR.ResNet(**SMALL, dtype=DTYPES[dtype][1], device="cpu")
    m.load_state_dict(PR.params_from_jax(variables["params"],
                                         variables["batch_stats"]))
    return m


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _port_train(small, dtype: str, hw: int) -> dict:
    """The port's train-mode groups for one case, as ``_reference``."""
    m = _port_model(small, dtype)
    x, y = _batch(hw)
    logits = m(_nchw(x))
    loss = F.cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    return {"logits": {"logits": logits.detach().numpy()},
            "loss": {"loss": np.float32(loss.item())},
            "grads": {k: p.grad.numpy() for k, p in m.named_parameters()},
            "stats": {k: t.numpy() for k, t in m.state_dict().items()
                      if "running" in k}}


def _norm_err(got: dict, want: dict) -> float:
    """|got - want| / |want| over the group's tensors together."""
    g = np.concatenate([np.ravel(got[k]).astype(np.float64) for k in want])
    w = np.concatenate([np.ravel(want[k]).astype(np.float64) for k in want])
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def _assert_group(small, dtype: str, hw: int, group: str, got: dict):
    """fp32: every tensor within ``FP32_TOL[group]`` of flax's, relative
    to its largest magnitude. bf16: against flax's fp32 result, the group's
    error (norm over its tensors) at most twice flax's own bf16 error plus
    ``BF16_FLOOR``."""
    truth = _reference(small, "float32", hw)[group]
    assert got.keys() == truth.keys()
    if dtype == "float32":
        for k, want in truth.items():
            scale = float(np.abs(want).max(initial=0.0)) or 1.0
            err = float(np.abs(np.asarray(got[k], np.float64)
                               - want).max(initial=0.0))
            assert err <= FP32_TOL[group] * scale, (group, k, err, scale)
        return
    flax_err = _norm_err(_reference(small, dtype, hw)[group], truth)
    err = _norm_err(got, truth)
    assert err <= 2.0 * flax_err + BF16_FLOOR, (group, err, flax_err)


@pytest.mark.parametrize("depth,tensors,elements", [
    ("ResNet50", 161, 25_557_032), ("ResNet101", 314, 44_549_160),
    ("ResNet152", 467, 60_192_808)])
def test_params_from_jax_covers_full_width_models(depth, tensors, elements):
    shapes = jax.eval_shape(
        lambda x: getattr(R, depth)().init(jax.random.PRNGKey(0), x,
                                           train=True),
        jax.ShapeDtypeStruct((1, 224, 224, 3), jnp.float32))
    # zero-strided stand-ins: nothing of the size of the model is drawn
    zeros = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    sd = PR.params_from_jax(zeros["params"], zeros["batch_stats"])
    model = getattr(PR, depth)(device="meta")
    want = model.state_dict()
    assert sd.keys() == want.keys()
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    params = dict(model.named_parameters())
    assert len(params) == tensors
    assert sum(p.numel() for p in params.values()) == elements
    assert sum(x.size for x in jax.tree_util.tree_leaves(
        shapes["params"])) == elements
    n_bn = sum(k.endswith(".running_mean") for k in want)
    assert len(want) - len(params) == 2 * n_bn  # no num_batches_tracked


def test_init_follows_flax():
    """lecun-normal kernels (truncated at two standard deviations, variance
    1/fan_in), zero dense bias, BN scale 1 but the third of each block 0,
    BN bias 0, running mean 0 and variance 1; seeded."""
    m = PR.ResNet(**SMALL, dtype=torch.float32, device="cpu", seed=3)
    again = PR.ResNet(**SMALL, dtype=torch.float32, device="cpu", seed=3)
    for (k, a), b in zip(m.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k
    w = m.blocks[3].conv2.weight  # 64 x 64 x 3 x 3
    std = (1.0 / w[0].numel()) ** 0.5
    assert abs(w.std().item() / std - 1.0) < 0.03
    assert w.abs().max().item() <= 2.0 * std / 0.87962566103423978
    for name, bn in m.named_modules():
        if isinstance(bn, PR.BatchNorm):
            scale = 0.0 if name.endswith("bn3") else 1.0
            assert torch.equal(bn.weight, torch.full_like(bn.weight, scale))
            assert torch.equal(bn.running_var, torch.ones_like(bn.bias))
            assert not bn.bias.any() and not bn.running_mean.any()
    assert not m.head.bias.any()


@pytest.mark.parametrize("dtype,hw", CASES)
def test_train_logits_loss_and_grads_match_flax(small, dtype, hw):
    got = _port_train(small, dtype, hw)
    for group in ("logits", "loss", "grads"):
        _assert_group(small, dtype, hw, group, got[group])


@pytest.mark.parametrize("dtype,hw", CASES)
def test_updated_batch_stats_match_flax(small, dtype, hw):
    _assert_group(small, dtype, hw, "stats",
                  _port_train(small, dtype, hw)["stats"])


@pytest.mark.parametrize("dtype,hw", CASES)
def test_eval_logits_match_flax(small, dtype, hw):
    m = _port_model(small, dtype).eval()
    before = {k: v.clone() for k, v in m.state_dict().items()}
    with torch.no_grad():
        logits = m(_nchw(_batch(hw)[0]))
    _assert_group(small, dtype, hw, "eval", {"eval": logits.numpy()})
    for k, v in m.state_dict().items():  # eval leaves the statistics
        assert torch.equal(v, before[k]), k


def test_distributed_optimizer_step_matches_optax(port, small):
    """One ``DistributedOptimizer(SGD(0.05, momentum=0.9))`` step at a
    world of one against ``optax.sgd(0.05, momentum=0.9)`` on flax's
    gradients; the BN buffers against flax's updated statistics."""
    _, variables, _ = small
    want = _reference(small, "float32", 33)
    opt_j = optax.sgd(0.05, momentum=0.9)

    @jax.jit
    def step(params, grads):
        updates, _ = opt_j.update(grads, opt_j.init(params), params)
        return optax.apply_updates(params, updates)

    stepped = {k: v.numpy() for k, v in PR.params_from_jax(
        _np(step(variables["params"], want["grad_tree"])),
        variables["batch_stats"]).items()}
    stepped.update(want["stats"])

    m = _port_model(small, "float32")
    hvd.broadcast_parameters(m.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(m.parameters(), lr=0.05, momentum=0.9),
        named_parameters=m.named_parameters())
    x, y = _batch(33)
    opt.zero_grad()
    F.cross_entropy(m(_nchw(x)), torch.from_numpy(y)).backward()
    opt.step()
    for name, t in m.state_dict().items():
        np.testing.assert_allclose(t.numpy(), stepped[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_stride2_same_padding_is_flax_asymmetric():
    """flax's "SAME" pads a 3x3 stride-2 convolution on an even input by
    (0, 1); the port's ``Conv`` matches flax, ``padding=1`` does not."""
    rs = np.random.RandomState(0)
    x = rs.randn(2, 8, 8, 4).astype(np.float32)
    conv = nn.Conv(5, (3, 3), strides=(2, 2), use_bias=False)
    variables = {"params": {"kernel": rs.randn(3, 3, 4, 5).astype(
        np.float32)}}
    want = np.asarray(conv.apply(variables, x)).transpose(0, 3, 1, 2)
    port = PR.Conv(4, 5, 3, 2, "cpu")
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(
            variables["params"]["kernel"].transpose(3, 2, 0, 1)))
        got = port(_nchw(x), torch.float32)
        naive = F.conv2d(_nchw(x), port.weight, stride=2, padding=1)
    assert got.shape == naive.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert np.abs(naive.numpy() - want).max() > 0.1


def test_running_variance_is_flax_biased():
    """flax's running update is ``0.9 running + 0.1 batch`` with the biased
    batch variance; the port's ``BatchNorm`` matches it, torch's
    ``BatchNorm2d`` (the unbiased variance) does not."""
    rs = np.random.RandomState(1)
    x = (2.0 + 3.0 * rs.randn(2, 3, 3, 6)).astype(np.float32)  # 18 a channel
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), x)
    y_j, upd = bn.apply(variables, x, mutable=["batch_stats"])
    want_var = np.asarray(upd["batch_stats"]["var"])
    port = PR.BatchNorm(6, "cpu")
    torch_bn = torch.nn.BatchNorm2d(6, eps=1e-5, momentum=0.1)
    with torch.no_grad():
        y = port(_nchw(x))
        torch_bn(_nchw(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j).transpose(
        0, 3, 1, 2), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(), want_var,
                               rtol=1e-6, atol=1e-6)
    assert np.abs(torch_bn.running_var.numpy() - want_var).max() > 1e-2


def test_channels_last_gradient_through_distributed_optimizer(port):
    """A ``channels_last`` conv weight's gradient (not contiguous in the
    default order, which K1 refuses) goes through ``DistributedOptimizer``
    on a contiguous copy that is written back: the step equals the plain
    optimizer's, and the weight keeps its layout."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4, 6, 6, generator=g).to(
        memory_format=torch.channels_last)
    w0 = torch.randn(5, 4, 3, 3, generator=g)
    results = []
    for wrapped in (False, True):
        w = torch.nn.Parameter(w0.clone().to(
            memory_format=torch.channels_last))
        opt = torch.optim.SGD([w], lr=0.05, momentum=0.9)
        if wrapped:
            opt = hvd.DistributedOptimizer(
                opt, named_parameters=[("conv.weight", w)])
        for _ in range(2):
            opt.zero_grad()
            F.conv2d(x, w, padding=1).square().sum().backward()
            assert not w.grad.is_contiguous()
            opt.step()
        assert w.is_contiguous(memory_format=torch.channels_last)
        results.append(w.detach().clone())
    assert torch.equal(results[0], results[1])


def test_broadcast_parameters_sends_every_buffer_once(port, monkeypatch):
    """``broadcast_parameters(model.state_dict())`` broadcasts each
    parameter and each BN running buffer once, by its state_dict name."""
    import horovod_tpu_torch.torch as front

    sent = []
    real = front.broadcast_async_

    def record(tensor, root_rank, name=None, process_set=None):
        sent.append(name)
        return real(tensor, root_rank, name, process_set)

    monkeypatch.setattr(front, "broadcast_async_", record)
    m = PR.ResNet(**SMALL, dtype=torch.float32, device="cpu")
    sd = m.state_dict()
    hvd.broadcast_parameters(sd, root_rank=0)
    assert sorted(sent) == sorted(f"bcast.{k}" for k in sd)
    assert sum(".running_" in k for k in sent) == 2 * sum(
        isinstance(x, PR.BatchNorm) for x in m.modules())
