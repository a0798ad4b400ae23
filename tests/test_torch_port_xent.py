"""Parity of the port's chunked softmax cross-entropy (``ops/xent.py``, K5's
plain version on the CPU) with the JAX package's ``chunked_softmax_xent``,
and of the LM's chunked loss with its dense one (``tests/test_xent.py`` for
the port). The same seeded numpy inputs go to both packages.

Tolerances: fp32 inputs 1e-5 (the same algorithm, sums in another order).
bf16 inputs are widened to fp32 before any arithmetic in both packages, so
the loss holds to 1e-5 as well; dx and dW are rounded to bf16 at the end,
where a last-bit difference in fp32 can flip one rounding: 2^-7 relative,
twice bf16's unit roundoff.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as T
from horovod_tpu.ops.xent import chunked_softmax_xent as jax_xent
from horovod_tpu_torch.models import transformer as PT
from horovod_tpu_torch.ops import xent

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(x, w, t, chunk, jdt=jnp.float32, tdt=torch.float32,
          wdt=None):
    """(loss, dx, dW) from the JAX package and from the port, as fp32
    numpy, plus the port's gradient dtypes."""
    wj, wt = (wdt or (jdt, tdt))
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, wj)
    lj, (gxj, gwj) = jax.jit(jax.value_and_grad(
        lambda a, b: jax_xent(a, b, jnp.asarray(t), chunk),
        argnums=(0, 1)))(jx, jw)
    px = torch.from_numpy(x).to(tdt).requires_grad_()
    pw = torch.from_numpy(w).to(wt).requires_grad_()
    lt = xent.chunked_softmax_xent(px, pw, torch.from_numpy(t), chunk)
    gx, gw = torch.autograd.grad(lt, (px, pw))
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    return ((float(lj), f32(gxj), f32(gwj)),
            (lt.item(), gx.float().numpy(), gw.float().numpy()),
            (gx.dtype, gw.dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("chunk", [16, 64, 256])
def test_chunked_xent_matches_jax(dtype, chunk):
    rng = np.random.RandomState(0)
    N, d, V = 48, 32, 256
    x = rng.randn(N, d).astype(np.float32)
    w = (rng.randn(V, d) * 0.1).astype(np.float32)
    t = rng.randint(0, V, (N,))
    jdt, tdt = DTYPES[dtype]
    want, got, dtypes = _both(x, w, t, chunk, jdt, tdt)
    assert dtypes == (tdt, tdt)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    tol = (dict(rtol=1e-5, atol=1e-7) if dtype == "float32"
           else dict(rtol=2 ** -7, atol=1e-6))
    np.testing.assert_allclose(got[1], want[1], err_msg="dx", **tol)
    np.testing.assert_allclose(got[2], want[2], err_msg="dW", **tol)


def test_mixed_dtypes_keep_each_input_dtype():
    """The LM's case: bf16 hidden states against the fp32 embedding; dx
    comes back in bf16 and dW in fp32, as in the JAX package."""
    rng = np.random.RandomState(5)
    x = rng.randn(32, 16).astype(np.float32)
    w = (rng.randn(128, 16) * 0.1).astype(np.float32)
    t = rng.randint(0, 128, (32,))
    want, got, dtypes = _both(x, w, t, 32, jnp.bfloat16, torch.bfloat16,
                              wdt=(jnp.float32, torch.float32))
    assert dtypes == (torch.bfloat16, torch.float32)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=2 ** -7, atol=1e-6)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-7)


def test_out_of_range_targets_are_clipped_as_in_jax():
    """-1 padding hits class 0 and ids past V the last class, in the loss
    and in both gradients, as the JAX package's clip does."""
    rng = np.random.RandomState(3)
    x = rng.randn(8, 16).astype(np.float32)
    w = (rng.randn(64, 16) * 0.1).astype(np.float32)
    t = np.array([-1, 0, 5, 63, 64, 200, -7, 1])
    want, got, _ = _both(x, w, t, 16)
    for g, w_, name in zip(got, want, ("loss", "dx", "dW")):
        np.testing.assert_allclose(g, w_, rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    clipped = _both(x, w, np.clip(t, 0, 63), 16)[1]
    for g, c in zip(got, clipped):
        np.testing.assert_array_equal(g, c)


def test_chunk_must_divide_vocab_with_jax_message():
    with pytest.raises(ValueError) as jerr:
        jax_xent(jnp.zeros((4, 8)), jnp.zeros((100, 8)),
                 jnp.zeros((4,), jnp.int32), 33)
    with pytest.raises(ValueError) as err:
        xent.chunked_softmax_xent(torch.zeros(4, 8), torch.zeros(100, 8),
                                  torch.zeros(4, dtype=torch.int64), 33)
    assert str(err.value) == str(jerr.value)
    assert "divisible" in str(err.value)


def test_only_lse_is_kept_between_the_passes():
    """The autograd node keeps x, w, the clipped targets and lse [N]:
    no [N, chunk] or [N, V] block survives the forward."""
    N, d, V = 24, 8, 96
    x = torch.randn(N, d, requires_grad=True)
    w = torch.randn(V, d, requires_grad=True)
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = xent.chunked_softmax_xent(x, w, torch.randint(0, V, (N,)), 32)
    assert sorted(shapes) == sorted([(N, d), (V, d), (N,), (N,)])
    loss.backward()
    assert x.grad.shape == (N, d) and w.grad.shape == (V, d)


def test_plain_chunk_passes_match_the_jax_scan_bodies():
    """K5's two plain passes over one chunk against the JAX bodies written
    out (``_forward`` :65-78, ``_bwd`` :106-113), chunk 1 of 3, targets in
    and out of it."""
    rng = np.random.RandomState(7)
    N, C, base = 16, 32, 32
    logits = rng.randn(N, C).astype(np.float32)
    t = rng.randint(0, 96, (N,))
    m0 = rng.randn(N).astype(np.float32)
    l0 = rng.rand(N).astype(np.float32) + 0.5
    g0 = rng.randn(N).astype(np.float32)
    # JAX's body
    lj = jnp.asarray(logits)
    m_new = jnp.maximum(m0, lj.max(axis=-1))
    l_new = l0 * jnp.exp(m0 - m_new) + jnp.exp(lj - m_new[:, None]).sum(-1)
    local = t - base
    inc = (local >= 0) & (local < C)
    picked = jnp.take_along_axis(lj, jnp.clip(local, 0, C - 1)[:, None],
                                 axis=1)[:, 0]
    tgt = jnp.where(inc, picked, g0)
    m, l, g = (torch.from_numpy(a.copy()) for a in (m0, l0, g0))
    xent.xent_fwd_chunk(torch.from_numpy(logits), torch.from_numpy(t), base,
                        m, l, g)
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_new))
    np.testing.assert_allclose(l.numpy(), np.asarray(l_new), rtol=1e-6)
    np.testing.assert_array_equal(g.numpy(), np.asarray(tgt))
    assert inc.any() and not inc.all()

    lse = (m0 + 2.0).astype(np.float32)
    scale = np.float32(0.7) / N
    p = jnp.exp(lj - lse[:, None])
    onehot = jnp.where(inc, local, -1)[:, None] == jnp.arange(C)[None, :]
    want = (p - onehot.astype(jnp.float32)) * scale
    got = torch.from_numpy(logits.copy())
    xent.xent_bwd_chunk(got, torch.from_numpy(t), base, torch.from_numpy(lse),
                        torch.tensor([0.7]) / N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-9)


def _lm_cfgs():
    base = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                max_seq=16)
    return (base, T.TransformerConfig(**base, dtype=jnp.float32, dp_axis=None,
                                      tp_axis=None, sp_axis=None,
                                      xent_chunk=16))


def test_lm_loss_chunked_matches_dense_and_jax_with_grads():
    """``TransformerConfig(xent_chunk=16)``: the port's chunked LM loss
    and its gradients against its dense loss (``tests/test_xent.py``'s
    tolerances) and against the JAX package's chunked loss."""
    base, jcfg = _lm_cfgs()
    params = T.init(jax.random.PRNGKey(0), jcfg)
    tokens = np.random.RandomState(2).randint(0, 64, (2, 17))
    sd = PT.params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    models = {}
    for chunk in (None, 16):
        m = PT.TransformerLM(PT.TransformerConfig(
            **base, dtype=torch.float32, xent_chunk=chunk), device="cpu")
        m.load_state_dict(sd)
        loss = PT.lm_loss(m, torch.from_numpy(tokens))
        loss.backward()
        models[chunk] = (loss.item(), {n: p.grad.numpy() for n, p in
                                       m.named_parameters()})
    (ld, gd), (lc, gc) = models[None], models[16]
    np.testing.assert_allclose(lc, ld, rtol=1e-5)
    for n in gd:
        np.testing.assert_allclose(gc[n], gd[n], rtol=2e-4, atol=1e-5,
                                   err_msg=n)
    lj, gj = jax.jit(jax.value_and_grad(lambda p: T.lm_loss(
        p, jnp.asarray(tokens), jcfg, use_constraints=False)))(params)
    np.testing.assert_allclose(lc, float(lj), rtol=1e-5)
    gj = {k: v.numpy() for k, v in PT.params_from_jax(
        jax.tree_util.tree_map(np.asarray, gj)).items()}
    for n in gj:
        np.testing.assert_allclose(gc[n], gj[n], rtol=1e-4, atol=1e-6,
                                   err_msg=n)


def test_kernel_wrappers_refuse_other_devices():
    """K5's wrappers take the plain version for CPU tensors only; any other
    device raises rather than fall back."""
    logits = torch.empty((4, 8), device="meta")
    t = torch.empty((4,), dtype=torch.int64, device="meta")
    rows = [torch.empty((4,), device="meta") for _ in range(3)]
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        xent.xent_fwd_chunk(logits, t, 0, *rows)
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        xent.xent_bwd_chunk(logits, t, 0, rows[0],
                            torch.empty((1,), device="meta"))
