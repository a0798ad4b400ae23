"""Parity of the port's Inception V3 (``horovod_tpu_torch/models/
inception.py``) with the JAX package's flax model, on the CPU.

The reduced model (``torch_port_zoo_support.py``: 75² images, batch 2, 10
classes, dropout 0; every block, down to a 1×1 map) with the same random
weights and batch statistics (numpy from a seed) in both packages:

- eval mode, which normalizes with the running statistics (epsilon 1e-3):
  the logits, loss and every gradient against flax's ``train=False``
  within ``FP32_TOL``, each tensor against its largest magnitude; the
  statistics unchanged;
- train mode (batch statistics, the running update at momentum 0.9 with
  the biased variance): logits, loss and the updated statistics. The
  whole model in train mode is chaotic in flax itself, at any batch this
  test can afford: a rounding difference grows about 1.5x a block through
  the eleven blocks, and at the last blocks' ReLUs it flips elements
  between kept and dropped, each flip moving its tensor's gradient by a
  whole sample's share. Moving every parameter of flax's own fp32 model by
  one ulp moves its logits 2.5 % and its gradients 81 % (as norms) at
  batch 2, its gradients 5.0 % at batch 8, 3.2 % at batch 16 and 2.7 % at
  batch 8 on 107² (2×2 last maps), with single tensors up to 40 %: no
  per-tensor gradient tolerance holds there. Each group is held to
  ``CHAOS_FACTOR`` times that sensitivity of flax's, measured in the test,
  plus ``CHAOS_FLOOR``;
- so the train mode's gradients are held block by block: each block type
  alone (``InceptionA/B/C``, ``ReductionA/B`` at their published widths,
  batch 8 on a small map, a ReLU'd random input), in train mode: the
  output, the updated statistics and every gradient (the parameters' and
  the input's, of the output against a fixed random cotangent) per tensor
  within ``FP32_TOL`` in fp32; in bf16, against flax's fp32 result, each
  group within twice flax's own bf16 error plus ``BF16_FLOOR``;
- the trap of a naive port: the branches' average pool counts the padded
  zeros, as flax's does; ``count_include_pad=False`` fails.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from horovod_tpu.models import inception as JI
from horovod_tpu_torch.models import inception as PI
from torch_port_zoo_support import (FAST_COMPILE, JDT, TDT, assert_close,
                                    flax_variables, nchw, norm_err, np_tree,
                                    one_ulp, port_run, random_variables,
                                    reference)

FP32_TOL = {"logits": 1e-4, "loss": 1e-4, "grads": 1e-4, "out": 1e-4,
            "stats": 1e-4}
CHAOS_FACTOR, CHAOS_FLOOR = 4.0, 1e-5
BF16_FLOOR = 2.0 ** -6
BLOCK_BATCH = 8
# block -> (flax block by dtype, port block on a device, input channels,
# input side): the published widths, the first of each kind
BLOCKS = {
    "InceptionA": (lambda d: JI.InceptionA(32, dtype=d),
                   lambda dev: PI.InceptionA(192, 32, dev), 192, 7),
    "ReductionA": (lambda d: JI.ReductionA(dtype=d),
                   lambda dev: PI.ReductionA(288, dev), 288, 7),
    "InceptionB": (lambda d: JI.InceptionB(128, dtype=d),
                   lambda dev: PI.InceptionB(768, 128, dev), 768, 7),
    "ReductionB": (lambda d: JI.ReductionB(dtype=d),
                   lambda dev: PI.ReductionB(768, dev), 768, 7),
    "InceptionC": (lambda d: JI.InceptionC(dtype=d),
                   lambda dev: PI.InceptionC(1280, dev), 1280, 3),
}


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
    """A cache of the random variables, compiled flax programs and
    results."""
    return {}


def test_inception_eval_mode_matches_flax(zoo):
    """Eval mode normalizes with the running statistics (epsilon 1e-3),
    which the train-mode chaos does not reach: the logits and every
    gradient against flax's ``train=False`` within ``FP32_TOL``; the
    statistics stay as they were."""
    want = reference(zoo, "inception3", "float32", train=False)
    got = port_run(zoo, "inception3", "float32", train=False)
    for group in ("logits", "loss", "grads"):
        assert_close(got[group], want[group], FP32_TOL[group], group)
    assert_close(got["stats"], want["stats"], 0.0, "stats")


def test_inception_train_mode_within_flax_sensitivity(zoo):
    """Train mode (batch statistics, the running update at momentum 0.9
    with the biased variance, epsilon 1e-3): logits, loss and the updated
    statistics, each group's error at most ``CHAOS_FACTOR`` times how far
    flax's own result moves when every parameter moves one ulp, plus
    ``CHAOS_FLOOR``."""
    truth = reference(zoo, "inception3", "float32", grads=False)
    moved = reference(zoo, "inception3", "float32", grads=False,
                      params=one_ulp(flax_variables(zoo, "inception3")[
                          "params"]))
    got = port_run(zoo, "inception3", "float32")
    for group in ("logits", "loss", "stats"):
        bound = (CHAOS_FACTOR * norm_err(moved[group], truth[group])
                 + CHAOS_FLOOR)
        err = norm_err(got[group], truth[group])
        assert err <= bound, (group, err, bound)


def _block_case(zoo, name: str):
    """The block's random flax variables, its input (ReLU'd, as every
    block's is) and the cotangent of its output, cached."""
    key = ("block", name)
    if key not in zoo:
        jblock, _, cin, side = BLOCKS[name]
        rs = np.random.RandomState(cin + side)
        x = np.maximum(rs.randn(BLOCK_BATCH, side, side, cin), 0).astype(
            np.float32)
        shapes = jax.eval_shape(
            lambda x: jblock(jnp.float32).init(jax.random.PRNGKey(0), x,
                                               train=True), x)
        out = jax.eval_shape(
            lambda v, x: jblock(jnp.float32).apply(
                v, x, train=True, mutable=["batch_stats"])[0], shapes, x)
        cot = rs.randn(*out.shape).astype(np.float32)
        zoo[key] = random_variables(shapes), x, cot
    return zoo[key]


def _block_groups(out, stats, grads, gx) -> dict:
    """A block's results as groups of state_dict names to numpy arrays."""
    sd = {k: v.numpy() for k, v in PI.block_params_from_jax(
        grads, stats).items()}
    return {"out": {"out": np.asarray(out)},
            "stats": {k: v for k, v in sd.items() if "running" in k},
            "grads": {**{k: v for k, v in sd.items() if "running" not in k},
                      "input": np.asarray(gx)}}


def flax_block(zoo, name: str, dtype: str) -> dict:
    """flax's train-mode block: its output, updated statistics and the
    gradients of ``sum(out * cot)`` (parameters and input)."""
    key = ("block result", name, dtype)
    if key in zoo:
        return zoo[key]
    variables, x, cot = _block_case(zoo, name)
    m = BLOCKS[name][0](JDT[dtype])

    def loss_fn(params, x):
        out, upd = m.apply({"params": params,
                            "batch_stats": variables["batch_stats"]},
                           x.astype(JDT[dtype]), train=True,
                           mutable=["batch_stats"])
        out = out.astype(jnp.float32)
        return jnp.sum(out * cot), (out, upd["batch_stats"])

    fn = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))
    (_, (out, stats)), (gp, gx) = np_tree(fn.lower(
        variables["params"], x).compile(FAST_COMPILE)(variables["params"],
                                                      x))
    zoo[key] = _block_groups(out, stats, gp, gx)
    return zoo[key]


def port_block(zoo, name: str, dtype: str) -> dict:
    variables, x, cot = _block_case(zoo, name)
    blk = BLOCKS[name][1]("meta")
    blk.load_state_dict(PI.block_params_from_jax(
        variables["params"], variables["batch_stats"]), assign=True)
    blk.train(True)
    xt = nchw(x).requires_grad_(True)
    out = blk(xt.to(dtype=TDT[dtype], memory_format=torch.channels_last),
              TDT[dtype]).float()
    (out * nchw(cot)).sum().backward()
    grads = {k: p.grad.numpy() for k, p in blk.named_parameters()}
    grads["input"] = xt.grad.permute(0, 2, 3, 1).numpy()
    return {"out": {"out": out.detach().permute(0, 2, 3, 1).numpy()},
            "stats": {k: t.numpy() for k, t in blk.state_dict().items()
                      if "running" in k},
            "grads": grads}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_inception_block_train_mode_matches_flax(zoo, name, dtype):
    """One block in train mode: fp32 per tensor within ``FP32_TOL``; bf16
    against flax's fp32 result, each group at most twice flax's own bf16
    error plus ``BF16_FLOOR``."""
    truth = flax_block(zoo, name, "float32")
    got = port_block(zoo, name, dtype)
    for group in ("out", "stats", "grads"):
        if dtype == "float32":
            assert_close(got[group], truth[group], FP32_TOL[group],
                         (name, group))
            continue
        flax_err = norm_err(flax_block(zoo, name, dtype)[group],
                            truth[group])
        err = norm_err(got[group], truth[group])
        assert err <= 2.0 * flax_err + BF16_FLOOR, (name, group, err,
                                                    flax_err)


def test_average_pool_counts_the_padding():
    """flax's ``avg_pool(..., "SAME")`` divides by 9 at the borders too;
    torch's ``count_include_pad=False`` would not."""
    x = np.random.RandomState(3).randn(2, 5, 5, 4).astype(np.float32)
    want = np.asarray(nn.avg_pool(x, (3, 3), strides=(1, 1),
                                  padding="SAME")).transpose(0, 3, 1, 2)
    got = PI._avg_pool(nchw(x)).numpy()
    naive = F.avg_pool2d(nchw(x), 3, 1, padding=1,
                         count_include_pad=False).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.abs(naive - want).max() > 1e-2
