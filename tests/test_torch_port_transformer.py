"""Parity of the port's transformer LM slice with the JAX package's, on the
CPU: the same parameters (``params_from_jax`` of a small ``T.init``) and
the same tokens go through both.

- the loss and every gradient with ring attention through the flash path
  (JAX: the Pallas kernel in interpret mode under a 1-device 'sp'
  shard_map, as ``tests/test_models.py`` runs it; port: the kernel's plain
  version on the CPU);
- three ``DistributedOptimizer(SGD(momentum=0.9))`` steps against
  ``optax.sgd(momentum=0.9)``, whose update rule is the same.

fp32 throughout; the tolerances cover summation order only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu_torch as hvd
from horovod_tpu.models import transformer as T
from horovod_tpu.parallel import ring_attention as jax_ring_attention
from horovod_tpu_torch.models import transformer as PT
from horovod_tpu_torch.parallel import ring_attention

CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_seq=16)


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


@pytest.fixture(scope="module")
def setup():
    cfg = T.TransformerConfig(**CFG, dtype=jnp.float32)
    params = T.init(jax.random.PRNGKey(0), cfg)
    tokens = np.random.RandomState(0).randint(0, 64, (2, 17))
    pcfg = PT.TransformerConfig(**CFG, dtype=torch.float32)
    model = PT.TransformerLM(pcfg, device="cpu")
    model.load_state_dict(PT.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return cfg, params, tokens, model


def _flat(tree):
    """JAX pytree -> {state_dict key: numpy}."""
    return {k: np.asarray(v) for k, v in
            PT.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                      tree)).items()}


def test_params_from_jax_covers_the_model(setup):
    _, params, _, model = setup
    sd = PT.params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    assert sd.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy())
    assert model.blocks[0].wq.shape == (32, 4, 8)
    assert model.blocks[0].wo.shape == (4, 8, 32)


def test_forward_matches_jax(setup):
    cfg, params, tokens, model = setup
    logits_j = T.apply(params, jnp.asarray(tokens[:, :-1]), cfg,
                       use_constraints=False)
    logits_t = model(torch.as_tensor(tokens[:, :-1]))
    np.testing.assert_allclose(logits_t.detach().numpy(),
                               np.asarray(logits_j), rtol=1e-5, atol=1e-5)


def test_lm_loss_and_grads_with_ring_flash_match_jax(setup):
    cfg, params, tokens, model = setup
    mesh = Mesh(np.array(jax.devices()[:1], dtype=object), ("sp",))

    def loss_j(params, tokens):
        def f(tokens):
            return T.lm_loss(
                params, tokens, cfg, use_constraints=False,
                attn_fn=lambda q, k, v: jax_ring_attention(
                    q, k, v, "sp", use_flash=True))

        return jax.shard_map(f, mesh=mesh, in_specs=P(), out_specs=P(),
                             check_vma=False)(tokens)

    loss_jv, grads_j = jax.jit(jax.value_and_grad(loss_j))(
        params, jnp.asarray(tokens))
    model.zero_grad(set_to_none=True)
    loss_t = PT.lm_loss(model, torch.as_tensor(tokens),
                        attn_fn=lambda q, k, v: ring_attention(
                            q, k, v, use_flash=True))
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_jv), rtol=1e-6,
                               atol=1e-6)
    gj = _flat(grads_j)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), gj[name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_distributed_optimizer_matches_optax(port, setup):
    cfg, params, tokens, _ = setup
    lr = 0.05
    opt_j = optax.sgd(lr, momentum=0.9)
    state = opt_j.init(params)
    grad_fn = jax.jit(jax.grad(
        lambda p, t: T.lm_loss(p, t, cfg, use_constraints=False)))
    p_j = params
    for _ in range(3):
        updates, state = opt_j.update(grad_fn(p_j, jnp.asarray(tokens)),
                                      state, p_j)
        p_j = optax.apply_updates(p_j, updates)

    model = PT.TransformerLM(PT.TransformerConfig(**CFG,
                                                  dtype=torch.float32),
                             device="cpu")
    model.load_state_dict(PT.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9),
        named_parameters=model.named_parameters())
    for _ in range(3):
        opt.zero_grad()
        PT.lm_loss(model, torch.as_tensor(tokens)).backward()
        opt.step()
    want = _flat(p_j)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name],
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_bf16_compute_stays_close_to_fp32(setup):
    """bf16 compute over fp32 weights (the chip's configuration) against
    the fp32 loss: the casts at use, fp32 RMSNorm and fp32 logits keep the
    loss within bf16 rounding."""
    _, _, tokens, model = setup
    bf = PT.TransformerLM(PT.TransformerConfig(**CFG, dtype=torch.bfloat16),
                          device="cpu")
    bf.load_state_dict(model.state_dict())
    t = torch.as_tensor(tokens)
    l32 = PT.lm_loss(model, t, attn_fn=ring_attention).item()
    l16 = PT.lm_loss(bf, t, attn_fn=ring_attention).item()
    assert abs(l32 - l16) < 2e-2, (l32, l16)


def test_distributed_optimizer_is_freed_with_its_model(port):
    """Dropping a ``DistributedOptimizer`` and its model frees both, with
    their gradients and optimizer state: the gradient hooks hold the
    optimizer weakly (a bound method in each parameter's hook table kept
    everything alive after ``gc.collect()``, a model's whole footprint a
    wrapped optimizer). A model kept for a new optimizer carries only the
    new one's hooks, so its gradients are reduced once a step."""
    import gc
    import weakref

    def step(model, opt):
        opt.zero_grad()
        PT.lm_loss(model, torch.randint(0, 64, (2, 17))).backward()
        opt.step()

    def wrapped(model):
        return hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9),
            named_parameters=model.named_parameters())

    cfg = PT.TransformerConfig(**CFG, dtype=torch.float32)
    model = PT.TransformerLM(cfg, device="cpu")
    opt = wrapped(model)
    step(model, opt)
    refs = weakref.ref(model.embed), weakref.ref(opt)
    del model, opt
    gc.collect()
    assert refs[0]() is None and refs[1]() is None

    model = PT.TransformerLM(cfg, device="cpu")
    step(model, wrapped(model))
    gc.collect()
    opt = wrapped(model)
    assert all(len(p._post_accumulate_grad_hooks) == 1
               for p in model.parameters())
    step(model, opt)
