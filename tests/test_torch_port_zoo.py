"""Parity of the port's model zoo (``horovod_tpu_torch/models/{vgg,
inception,vit,mlp}.py``) with the JAX package's flax models, on the CPU
(Inception V3's reduced model: ``test_torch_port_inception.py``).

- ``params_from_jax`` covers VGG-16, Inception V3 and ViT-B/16 at full
  width exactly, checked against ``jax.eval_shape`` of the flax models;
- reduced models with the same random weights (numpy from a seed) on the
  same numpy batch (``torch_port_zoo_support.py``): VGG-16 at 64² (the
  last map 2×2×512, so the flatten order before ``fc6`` matters), ViT at
  patch 4, width 32, 2 layers of 4 heads on 16², ``MLP`` and
  ``MnistConvNet`` at 28²; batch 2, 10 classes, dropout 0: the train-mode
  logits, loss and every gradient against flax's ``jax.value_and_grad``,
  in fp32, and ViT's in bf16;
- one ``DistributedOptimizer`` SGD step with momentum on ``MnistConvNet``
  against ``optax.sgd``;
- the traps of a naive port, each with a check that the naive version
  fails: VGG's flatten in NCHW order, torch's erf GELU;
- the dropout masks: drawn from the caller's generator, the same for two
  generators in the same state.

Tolerances. fp32 (``FP32_TOL``) covers summation order: each tensor within
1e-4 of its largest magnitude (logits, loss, gradients). bf16 is held
against flax's fp32 result: each group's error, as a norm over its
tensors, at most twice flax's own bf16 error plus 2^-6 (bf16 keeps 8
significant bits).
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
from horovod_tpu.models import inception as JI
from horovod_tpu.models import vgg as JV
from horovod_tpu.models import vit as JT
from horovod_tpu_torch.models import _layers
from horovod_tpu_torch.models import inception as PI
from horovod_tpu_torch.models import mlp as PM
from horovod_tpu_torch.models import vgg as PV
from horovod_tpu_torch.models import vit as PT
from torch_port_zoo_support import (CLASSES, FAST_COMPILE, assert_close,
                                    batch_of, convert, flax_variables, nchw,
                                    norm_err, np_tree, port_model, port_run,
                                    reference)

FP32_TOL = {"logits": 1e-4, "loss": 1e-4, "grads": 1e-4}
BF16_FLOOR = 2.0 ** -6
CASES = [("vgg16", "float32"), ("vgg16", "bfloat16"), ("vit", "float32"),
         ("vit", "bfloat16"), ("mnist_conv", "float32"), ("mlp", "float32")]
# VGG-16 under the benchmark's SGD on one repeated batch
VGG_STEPS, VGG_CLASSES, LR, MOMENTUM = 10, 1000, 0.05, 0.9


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # small shapes: one intra-op thread, leaving the cores to the suite's
    # other workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def zoo():
    """A cache of each model's random variables, compiled flax programs
    and results."""
    return {}


@pytest.mark.parametrize("name,jax_fn,port_fn,image,tensors,elements", [
    ("vgg16", JV.VGG16, PV.VGG16, 224, 32, 138_357_544),
    ("inception3", JI.InceptionV3, PI.InceptionV3, 299, 284, 23_834_568),
    ("vit", JT.ViT_B16, PT.ViT_B16, 224, 152, 86_567_656)])
def test_params_from_jax_covers_full_width_models(name, jax_fn, port_fn,
                                                  image, tensors, elements):
    shapes = jax.eval_shape(
        lambda x: jax_fn().init(jax.random.PRNGKey(0), x, train=False),
        jax.ShapeDtypeStruct((1, image, image, 3), jnp.float32))
    # zero-strided stand-ins: nothing of the size of the model is drawn
    zeros = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    sd = convert(name, zeros["params"], zeros.get("batch_stats"))
    model = port_fn(device="meta")
    want = model.state_dict()
    assert sd.keys() == want.keys()
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    params = dict(model.named_parameters())
    assert len(params) == tensors
    assert sum(p.numel() for p in params.values()) == elements
    assert sum(x.size for x in jax.tree_util.tree_leaves(
        shapes["params"])) == elements


@pytest.mark.parametrize("name,dtype", CASES)
def test_train_logits_loss_and_grads_match_flax(zoo, name, dtype):
    """fp32: every tensor within ``FP32_TOL``. bf16: against flax's fp32
    result, each group's error at most twice flax's own bf16 error plus
    ``BF16_FLOOR``."""
    got = port_run(zoo, name, dtype)
    truth = reference(zoo, name, "float32")
    for group in ("logits", "loss", "grads"):
        if dtype == "float32":
            assert_close(got[group], truth[group], FP32_TOL[group],
                          (name, group))
            continue
        flax_err = norm_err(reference(zoo, name, dtype)[group],
                             truth[group])
        err = norm_err(got[group], truth[group])
        assert err <= 2.0 * flax_err + BF16_FLOOR, (name, group, err,
                                                    flax_err)


def test_distributed_optimizer_step_matches_optax(zoo):
    """One ``DistributedOptimizer(SGD(0.05, momentum=0.9))`` step of
    ``MnistConvNet`` at a world of one against ``optax.sgd(0.05,
    momentum=0.9)`` on flax's gradients."""
    variables = flax_variables(zoo, "mnist_conv")
    want = reference(zoo, "mnist_conv", "float32")
    opt_j = optax.sgd(0.05, momentum=0.9)
    updates, _ = opt_j.update(want["grad_tree"],
                              opt_j.init(variables["params"]),
                              variables["params"])
    stepped = {k: v.numpy() for k, v in PM.params_from_jax(np_tree(
        optax.apply_updates(variables["params"], updates))).items()}
    hvd.init(device="cpu")
    try:
        m = port_model(zoo, "mnist_conv", "float32")
        hvd.broadcast_parameters(m.state_dict(), root_rank=0)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(m.parameters(), lr=0.05, momentum=0.9),
            named_parameters=m.named_parameters())
        x, y = batch_of("mnist_conv")
        opt.zero_grad()
        F.cross_entropy(m(nchw(x)), torch.from_numpy(y)).backward()
        opt.step()
        for k, t in m.state_dict().items():
            np.testing.assert_allclose(t.numpy(), stepped[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    finally:
        hvd.shutdown()


def test_vgg16_sgd_diverges_as_flax_does():
    """VGG-16 at 64² (1000 classes, batch 2, dropout 0, fp32) from flax's
    own initialization in both packages, ``SGD(0.05, momentum=0.9)`` (the
    benchmark's, ``optax.sgd`` in flax) on one repeated batch for
    ``VGG_STEPS`` steps: the losses agree within 1e-4 relative while they
    stay under ten times the first; both first pass it at the same step,
    and both end non-finite. The model has no batch norm, and this rate
    makes flax's VGG-16 diverge as it does the port's."""
    rs = np.random.RandomState(64)
    x = rs.randn(2, 64, 64, 3).astype(np.float32)
    y = rs.randint(0, VGG_CLASSES, 2)
    jm = JV.VGG16(num_classes=VGG_CLASSES, dtype=jnp.float32,
                  dropout_rate=0.0)
    init = jax.jit(lambda x: jm.init(jax.random.PRNGKey(0), x,
                                     train=False)["params"])
    params = np_tree(init.lower(x).compile(FAST_COMPILE)(x))
    opt_j = optax.sgd(LR, momentum=MOMENTUM)

    def step_j(p, s):
        loss, g = jax.value_and_grad(
            lambda p: optax.softmax_cross_entropy_with_integer_labels(
                jm.apply({"params": p}, x, train=True), y).mean())(p)
        u, s = opt_j.update(g, s, p)
        return optax.apply_updates(p, u), s, loss

    state = opt_j.init(params)
    step_j = jax.jit(step_j).lower(params, state).compile(FAST_COMPILE)
    m = PV.VGG16(num_classes=VGG_CLASSES, dtype=torch.float32, image=64,
                 dropout_rate=0.0, device="meta")
    m.load_state_dict(PV.params_from_jax(params), assign=True)
    opt = torch.optim.SGD(m.parameters(), lr=LR, momentum=MOMENTUM)
    xt, yt = nchw(x), torch.from_numpy(y)
    flax_losses, port_losses = [], []
    for _ in range(VGG_STEPS):
        params, state, loss = step_j(params, state)
        flax_losses.append(float(loss))
        opt.zero_grad()
        loss = F.cross_entropy(m(xt), yt)
        loss.backward()
        opt.step()
        port_losses.append(loss.item())
    print("flax", flax_losses, "port", port_losses)

    def blown(losses):
        return next(i for i, v in enumerate(losses)
                    if not v < 10 * losses[0])

    assert blown(port_losses) == blown(flax_losses)
    n = blown(flax_losses)
    np.testing.assert_allclose(port_losses[:n], flax_losses[:n], rtol=1e-4)
    assert not np.isfinite(flax_losses[-1])
    assert not np.isfinite(port_losses[-1])


def test_vgg_flatten_is_nhwc(zoo, monkeypatch):
    """At 64² the last map is 2×2×512: flattening it in NCHW order puts
    ``fc6``'s rows out of line with the converted kernel."""
    want = reference(zoo, "vgg16", "float32")["logits"]["logits"]
    x, _ = batch_of("vgg16")
    m = port_model(zoo, "vgg16", "float32")
    with torch.no_grad():
        got = m(nchw(x)).numpy()
        monkeypatch.setattr(PV, "nhwc_flatten", lambda t: t.flatten(1))
        naive = m(nchw(x)).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= FP32_TOL["logits"] * scale
    assert np.abs(naive - want).max() > 1e-2 * scale


def test_vit_gelu_is_flax_tanh_approximation():
    """flax's ``nn.gelu`` is the tanh approximation; torch's default GELU
    (erf) is not it."""
    x = np.linspace(-4, 4, 101).astype(np.float32)
    want = np.asarray(nn.gelu(x))
    np.testing.assert_allclose(F.gelu(torch.from_numpy(x),
                                      approximate="tanh").numpy(), want,
                               rtol=1e-6, atol=1e-6)
    assert np.abs(F.gelu(torch.from_numpy(x)).numpy() - want).max() > 1e-4


def test_dropout_masks_come_from_the_callers_generator():
    """A VGG given generators in the same state draws the same masks (equal
    train-mode logits), in another state others; a model's own generator
    is seeded from its ``seed``; the kept elements are divided by the keep
    probability and eval mode drops nothing."""
    x = torch.randn(2, 3, 8, 8, generator=torch.Generator().manual_seed(1))
    m = PV.VGG(stages=((1, 4),), num_classes=CLASSES, image=8,
               dtype=torch.float32, device="cpu", seed=0)
    # the model's own generator: seed + 1
    assert torch.equal(m.generator.get_state(),
                       torch.Generator().manual_seed(1).get_state())

    def logits(seed):
        m.generator = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return m(x)

    assert torch.equal(logits(5), logits(5))
    assert not torch.equal(logits(5), logits(6))
    with torch.no_grad():
        assert torch.equal(m.eval()(x), m(x))
    y = _layers.dropout(torch.ones(4096), 0.5,
                        torch.Generator().manual_seed(0), True)
    assert set(y.unique().tolist()) == {0.0, 2.0}
    assert abs(y.mean().item() - 1.0) < 0.05
    assert torch.equal(_layers.dropout(y, 0.5, None, False), y)
