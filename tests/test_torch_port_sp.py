"""Parity of the port's sequence parallelism
(``horovod_tpu_torch.parallel.sp``) with the JAX package's, in one process
on the CPU.

The port's rings run here as ``_simulated_ring`` and ``_simulated_ulysses``:
all ``n`` ranks' shards in one process, the rotation a list roll and the
all-to-all a list exchange, through the same round and combine code the
multi-rank path runs (``tests/test_torch_port_sp_jobs.py`` holds that path
against these). JAX runs its functions under ``shard_map`` over the
conftest's virtual CPU devices, where its rounds take ``scan_stats``; the
port's take ``scan_stats`` too, or with ``use_flash=True`` the flash
kernel's plain version (``lax_stats``), the dispatch the card runs. The
same seeded numpy inputs go to both, and the same cotangent for the
gradients. fp32 throughout: the tolerances cover summation order only.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu_torch as hvd
from horovod_tpu.models import transformer as T
from horovod_tpu.parallel import sp as jsp
from horovod_tpu_torch.models import transformer as PT
from horovod_tpu_torch.parallel import sp

CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_seq=16)
TOL = dict(rtol=1e-5, atol=1e-5)  # fp32, another summation order


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n], dtype=object), ("sp",))


def _inputs(seed, b=1, s=32, h=2, d=8):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, s, h, d).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("axis", [0, 1])
def test_stripe_tokens_bitwise_against_jax(n, axis):
    x = np.random.RandomState(n).randn(24, 24, 3).astype(np.float32)
    for fn, jfn in ((sp.stripe_tokens, jsp.stripe_tokens),
                    (sp.unstripe_tokens, jsp.unstripe_tokens)):
        got = fn(torch.from_numpy(x), n, axis=axis).numpy()
        np.testing.assert_array_equal(got, np.asarray(jfn(jnp.asarray(x), n,
                                                          axis=axis)))
    ids = torch.arange(24)
    assert torch.equal(sp.unstripe_tokens(sp.stripe_tokens(ids, n, 0), n, 0),
                       ids)
    with pytest.raises(ValueError, match="must divide by 5"):
        sp.stripe_tokens(torch.zeros(1, 24), 5)


_JAX_RESULTS = {}


def _jax_sharded(fn, n, q, k, v, co):
    """JAX's ``fn`` under shard_map over n devices: output and the
    gradients of sum(out * co), differentiated from outside the map (one
    compile a function and n, shared by the tests' parameters)."""
    key = (fn.__name__, n, q.tobytes(), co.tobytes())
    if key not in _JAX_RESULTS:
        _JAX_RESULTS[key] = _jax_run(fn, n, q, k, v, co)
    return _JAX_RESULTS[key]


def _jax_run(fn, n, q, k, v, co):
    ring = jax.shard_map(lambda q, k, v: fn(q, k, v, "sp"), mesh=_mesh(n),
                         in_specs=(P(None, "sp"),) * 3,
                         out_specs=P(None, "sp"))

    def loss(q, k, v):
        out = ring(q, k, v)
        return jnp.sum(out * co), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port(fn, q, k, v, co):
    ins = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fn(*ins)
    grads = torch.autograd.grad((out * torch.from_numpy(co)).sum(), ins)
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("use_flash", [None, True])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_simulated_ring_matches_jax_ring(n, use_flash):
    """Block-sharded ring, outputs and gradients, at n = 2, 4, 8; the
    blocks the port's rank 0 skips contribute nothing in either."""
    q, k, v, co = _inputs(10 + n)
    want, wgrads = _jax_sharded(jsp.ring_attention, n, q, k, v, co)
    got, grads = _port(lambda q, k, v: sp._simulated_ring(
        q, k, v, n, use_flash=use_flash), q, k, v, co)
    np.testing.assert_allclose(got, want, **TOL)
    for g, w, name in zip(grads, wgrads, "qkv"):
        np.testing.assert_allclose(g, w, err_msg="d" + name, **TOL)


@pytest.mark.parametrize("use_flash", [None, True])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_simulated_striped_ring_matches_jax(n, use_flash):
    """Striped ring on striped inputs, outputs and gradients; with
    ``use_flash=True`` the strict rounds go through the kernel's plain
    version, whose fully masked row 0 returns m = NEG_INF."""
    q, k, v, co = _inputs(20 + n)
    q, k, v, co = (np.array(jsp.stripe_tokens(jnp.asarray(x), n))
                   for x in (q, k, v, co))
    want, wgrads = _jax_sharded(jsp.striped_ring_attention, n, q, k, v, co)
    got, grads = _port(lambda q, k, v: sp._simulated_ring(
        q, k, v, n, striped=True, use_flash=use_flash), q, k, v, co)
    np.testing.assert_allclose(got, want, **TOL)
    for g, w, name in zip(grads, wgrads, "qkv"):
        np.testing.assert_allclose(g, w, err_msg="d" + name, **TOL)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("n", [2, 4])
def test_simulated_ulysses_matches_jax(n):
    """Ulysses with the default core (``causal_attention`` on the CPU in
    both packages), outputs and gradients."""
    q, k, v, co = _inputs(30 + n, h=8, d=4, s=16)
    want, wgrads = _jax_sharded(jsp.ulysses_attention, n, q, k, v, co)
    got, grads = _port(lambda q, k, v: sp._simulated_ulysses(q, k, v, n),
                       q, k, v, co)
    np.testing.assert_allclose(got, want, **TOL)
    for g, w, name in zip(grads, wgrads, "qkv"):
        np.testing.assert_allclose(g, w, err_msg="d" + name, **TOL)


def test_ulysses_refuses_heads_that_do_not_divide_with_jax_message():
    q = _inputs(0, h=3, s=8)[0]
    with pytest.raises(ValueError) as jerr:
        jax.shard_map(lambda q: jsp.ulysses_attention(q, q, q, "sp"),
                      mesh=_mesh(2), in_specs=P(None, "sp"),
                      out_specs=P(None, "sp"))(jnp.asarray(q))
    t = torch.from_numpy(q)
    with pytest.raises(ValueError) as err:
        sp._simulated_ulysses(t, t, t, 2)
    assert str(err.value) == str(jerr.value) == "heads (3) must divide by sp=2"


@pytest.fixture(scope="module")
def lm():
    cfg = T.TransformerConfig(**CFG, dtype=jnp.float32)
    params = T.init(jax.random.PRNGKey(0), cfg)
    model = PT.TransformerLM(PT.TransformerConfig(**CFG, dtype=torch.float32),
                             device="cpu")
    model.load_state_dict(PT.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return cfg, params, model


@pytest.mark.parametrize("striped", [False, True])
@pytest.mark.parametrize("n", [2, 4])
def test_lm_logits_under_the_simulated_rings_match_jax_full(lm, n, striped):
    """``tests/test_models.py:51-111`` for the port: the LM with a
    (striped) ring inside every block, tokens and positions striped for the
    striped ring and the logits unstriped, equals ``T.apply`` at full
    sequence."""
    cfg, params, model = lm
    tokens = np.random.RandomState(1).randint(0, 64, (2, 16))
    want = np.asarray(T.apply(params, jnp.asarray(tokens), cfg,
                              use_constraints=False))
    t = torch.from_numpy(tokens)
    pos = torch.arange(16)
    if striped:
        t, pos = sp.stripe_tokens(t, n), sp.stripe_tokens(pos, n, axis=0)
    with torch.no_grad():
        logits = model(t, positions=pos, attn_fn=lambda q, k, v:
                       sp._simulated_ring(q, k, v, n, striped=striped))
    if striped:
        logits = sp.unstripe_tokens(logits, n)
    np.testing.assert_allclose(logits.numpy(), want, rtol=1e-4, atol=1e-4)


def _loss_and_grads(model, tokens, **kw):
    model.zero_grad(set_to_none=True)
    loss = PT.lm_loss(model, tokens, **kw)
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in
                         model.named_parameters()}


@pytest.mark.parametrize("ring", [False, True])
def test_remat_matches_no_remat_and_jax(lm, ring):
    """``tests/test_models.py:172-190`` for the port: ``remat=True``
    (each block under ``torch.utils.checkpoint``) changes memory, not the
    loss or gradients, here also with a simulated ring of 4 inside the
    recomputed blocks; both agree with the JAX package's remat loss."""
    cfg, params, model = lm
    tokens = torch.from_numpy(np.random.RandomState(0).randint(0, 64, (2, 17)))
    kw = {"attn_fn": lambda q, k, v: sp._simulated_ring(q, k, v, 4)} \
        if ring else {}
    l1, g1 = _loss_and_grads(model, tokens, **kw)
    rm = PT.TransformerLM(dataclasses.replace(model.cfg, remat=True),
                          device="cpu")
    rm.load_state_dict(model.state_dict())
    l2, g2 = _loss_and_grads(rm, tokens, **kw)
    np.testing.assert_allclose(l1, l2, rtol=1e-6)
    for name in g1:
        np.testing.assert_allclose(g1[name].numpy(), g2[name].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    jcfg = dataclasses.replace(cfg, remat=True, dp_axis=None, tp_axis=None,
                               sp_axis=None)
    lj = T.lm_loss(params, jnp.asarray(tokens.numpy()), jcfg,
                   use_constraints=False)
    np.testing.assert_allclose(l2, float(lj), rtol=1e-5)


@pytest.fixture(scope="module")
def port():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


@pytest.mark.parametrize("fn", [sp.ring_attention, sp.striped_ring_attention,
                                sp.ulysses_attention])
def test_group_none_is_a_ring_of_one(port, fn):
    """``group=None``, and a world of one's group, compute attention at
    full length on this rank alone: a data-parallel job that passes the
    function as ``attn_fn`` stays data parallel."""
    q, k, v, _ = _inputs(40, h=4)
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    want = PT.causal_attention(q, k, v)
    for group in (None, hvd.global_process_set().group):
        np.testing.assert_allclose(fn(q, k, v, group=group).numpy(),
                                   want.numpy(), **TOL)
    assert sp.exchanges == {"ppermute": 0, "all_to_all": 0}


@pytest.mark.parametrize("fn", [sp.ring_attention, sp.striped_ring_attention,
                                sp.ulysses_attention])
def test_runtime_group_is_refused(port, fn):
    q = torch.zeros(1, 8, 2, 4)
    with pytest.raises(ValueError, match="runtime_group"):
        fn(q, q, q, group=hvd.global_process_set().runtime_group)
