"""One two-process gloo job of ``resnet_probe.py`` against the JAX
package's flax model, on the CPU.

``resnet_probe.py -np 2 --device cpu --depth tiny`` (one block a stage, 8
filters, 10 classes, 64² images, fp32) takes one ``hooks`` step:
``hvd.broadcast_parameters`` of rank 0's model (rank 1 builds its own from
another seed) and ``DistributedOptimizer(SGD(0.05, momentum=0.9))`` over a
half-batch of 2 images a rank; each rank dumps its ``state_dict``. The
parameters must be bitwise equal on both ranks, and match the reference:
flax's gradients of each half-batch from rank 0's initial weights,
averaged, then one ``optax.sgd(0.05, momentum=0.9)`` step; the BN running
statistics are each rank's own, against flax's for its half-batch.
Tolerances: fp32 summation order (``UPDATE_TOL``, ``STATS_TOL``). The JAX
reference is computed while the job runs.
"""

import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.models import resnet as R
from horovod_tpu_torch.models import resnet as PR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import resnet_probe as probe  # noqa: E402

RANKS, BATCH, IMAGE, SEED = 2, 2, 64, 0
# fp32 summation order: torch's and XLA's gradients of the model agree to
# about 2e-5 of each tensor's largest magnitude (at 32² images, where the
# last stage normalizes over two values a channel, only to 5e-3)
UPDATE_TOL, STATS_TOL = 1e-3, 2e-5


def _to_flax(sd: dict, shapes) -> dict:
    """``params_from_jax`` inverted: the flax variables of a ``state_dict``.
    Each element of ``shapes`` is numbered; ``params_from_jax`` of the
    numbers says where each ``state_dict`` element goes."""
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    offs = np.cumsum([0] + [leaf.size for leaf in leaves])
    numbered = jax.tree_util.tree_unflatten(treedef, [
        np.arange(o, o + leaf.size, dtype=np.float64).reshape(leaf.shape)
        for o, leaf in zip(offs, leaves)])
    where = PR.params_from_jax(numbered["params"], numbered["batch_stats"])
    assert offs[-1] < 2 ** 24  # the numbers are exact in fp32
    flat = np.full(offs[-1], np.nan, np.float32)
    for k, pos in where.items():
        flat[pos.numpy().astype(np.int64).ravel()] = sd[k].numpy().ravel()
    assert not np.isnan(flat).any()
    return jax.tree_util.tree_unflatten(treedef, [
        flat[o:o + leaf.size].reshape(leaf.shape)
        for o, leaf in zip(offs, leaves)])


def _reference():
    """The initial ``state_dict`` and, per rank, the parameters after one
    step and the rank's BN statistics, as ``state_dict`` arrays, from the
    JAX package's model."""
    stages, filters, classes = probe.CONFIGS["tiny"]
    model = R.ResNet(stage_sizes=stages, num_filters=filters,
                     num_classes=classes, dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda x: model.init(jax.random.PRNGKey(0), x, train=True),
        jax.ShapeDtypeStruct((BATCH, IMAGE, IMAGE, 3), jnp.float32))
    init = probe.build("tiny", torch.device("cpu"), SEED).state_dict()
    variables = _to_flax(init, shapes)

    @jax.jit
    def grads(params, x, y):
        def loss_fn(p):
            logits, upd = model.apply(
                {"params": p, "batch_stats": variables["batch_stats"]}, x,
                train=True, mutable=["batch_stats"])
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, y).mean(), upd["batch_stats"]

        return jax.grad(loss_fn, has_aux=True)(params)

    per_rank = []
    for r in range(RANKS):
        x, y = probe.synthetic_batch(SEED, RANKS, BATCH, IMAGE, classes, r,
                                     torch.device("cpu"))
        per_rank.append(grads(variables["params"],
                              x.permute(0, 2, 3, 1).numpy(), y.numpy()))
    mean = jax.tree_util.tree_map(lambda *g: sum(g) / RANKS,
                                  *[g for g, _ in per_rank])

    @jax.jit
    def step(params, grads):
        opt = optax.sgd(probe.LR, momentum=probe.MOMENTUM)
        updates, _ = opt.update(grads, opt.init(params), params)
        return optax.apply_updates(params, updates)

    params = jax.tree_util.tree_map(np.asarray,
                                    step(variables["params"], mean))
    return {k: v.numpy() for k, v in init.items()}, [
        {k: v.numpy() for k, v in PR.params_from_jax(
            params, jax.tree_util.tree_map(np.asarray, stats)).items()}
        for _, stats in per_rank]


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    dump = tmp_path_factory.mktemp("resnet_job") / "state.npz"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for k in ("HOROVOD_COMPRESSION", "HOROVOD_FUSION_THRESHOLD"):
        env.pop(k, None)
    p = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "resnet_probe.py"), "-np",
         str(RANKS), "--device", "cpu", "--depth", "tiny", "--batch",
         str(BATCH), "--image", str(IMAGE), "--steps", "1", "--arms",
         "hooks", "--wires", "off", "--seed", str(SEED), "--dump",
         str(dump)], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
    try:
        ref = _reference()  # while the job runs
        out = p.communicate(timeout=240)[0]
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.communicate()
    assert p.returncode == 0, out
    states = [dict(np.load(dump.with_name(f"state.rank{r}.npz")))
              for r in range(RANKS)]
    return states, ref, out


def test_parameters_bitwise_equal_on_both_ranks(job):
    states, _, out = job
    params = [k for k in states[0] if "running" not in k]
    assert len(params) == len(dict(probe.build(
        "tiny", torch.device("meta"), SEED).named_parameters()))
    for k in params:
        assert np.array_equal(states[0][k].view(np.int32),
                              states[1][k].view(np.int32)), k
    # the BN statistics are each rank's own
    assert any(not np.array_equal(states[0][k], states[1][k])
               for k in states[0] if "running" in k)
    assert "parameters bitwise equal on every rank after every step: " \
        "True" in out, out


def test_parameters_and_statistics_match_the_jax_reference(job):
    """Each parameter within ``UPDATE_TOL`` of the reference step's largest
    change of that tensor; each rank's statistics within ``STATS_TOL`` of
    their largest magnitude."""
    states, (init, ref), _ = job
    for r in range(RANKS):
        assert states[r].keys() == ref[r].keys()
        for k, want in ref[r].items():
            scale = (np.abs(want).max() * STATS_TOL if "running" in k else
                     np.abs(want - init[k]).max() * UPDATE_TOL)
            err = np.abs(states[r][k] - want).max()
            assert err <= scale + 1e-7, (r, k, err, scale)


def test_flop_counts_agree_with_bench():
    """The shape count of the forward FLOPs against ``bench.py:92-94``'s
    ResNet-50 and ResNet-101 constants (2 x 4.09 and 2 x 7.8 GMACs)."""
    for depth, want in probe.FWD_FLOP_PER_IMG_224.items():
        assert abs(probe.fwd_flops(depth, 224) / want - 1.0) < 1e-3, depth
