"""Parity of the port's flash attention (``horovod_tpu_torch.ops.
flash_attention``) with the JAX package's, on the CPU.

Mirrors ``tests/test_pallas_flash.py``: the same numpy inputs go through the
JAX package (the Pallas kernel in interpret mode, ``_lax_stats``,
``scan_stats``) and through the port, whose CPU path is the kernel's plain
version ``lax_stats`` forward and the blockwise ``scan_stats`` backward. The
CUDA kernel itself is held against ``lax_stats`` on the card by
``chip_smoke.py``. Tolerances are the JAX tests' own.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import flash_attention as fa

# the module, not the function that horovod_tpu.ops.pallas re-exports
jfa = importlib.import_module("horovod_tpu.ops.pallas.flash_attention")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # tiny shapes: one intra-op thread is enough, and leaves the cores to
    # the suite's other workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def qkv_np():
    rng = np.random.RandomState(0)
    B, s, d = 2, 256, 64
    return [rng.randn(B, s, d).astype(np.float32) for _ in range(3)]


def _jx(arrs, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrs]


def _pt(arrs, dtype=torch.float32, grad=False):
    return [torch.tensor(a, dtype=dtype, requires_grad=grad) for a in arrs]


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_jax(qkv_np, causal):
    o_j = jfa.flash_attention(*_jx(qkv_np), causal, 128, 128)
    o_t = fa.flash_attention(*_pt(qkv_np), causal, 128, 128)
    np.testing.assert_allclose(_np(o_t), np.asarray(o_j), atol=1e-4)
    ref = fa.reference_attention(*_pt(qkv_np), causal)
    np.testing.assert_allclose(_np(o_t), _np(ref), atol=1e-4)


def test_flash_gradients_match_jax(qkv_np):
    def loss_j(q, k, v):
        return (jfa.flash_attention(q, k, v, True, 128, 128) ** 2).sum()

    g_j = jax.grad(loss_j, argnums=(0, 1, 2))(*_jx(qkv_np))
    q, k, v = _pt(qkv_np, grad=True)
    (fa.flash_attention(q, k, v, True, 128, 128) ** 2).sum().backward()
    for a, b in zip((q.grad, k.grad, v.grad), g_j):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=2e-3)


def test_attention_stats_contract(qkv_np):
    """(o, m, l) against the Pallas kernel and ``_lax_stats``."""
    o_j, m_j, l_j = jfa.attention_stats(*_jx(qkv_np), False, 128, 128)
    o_t, m_t, l_t = fa.attention_stats(*_pt(qkv_np), False, 128, 128)
    np.testing.assert_allclose(_np(o_t), np.asarray(o_j), atol=1e-4)
    np.testing.assert_allclose(_np(m_t), np.asarray(m_j), atol=1e-5)
    np.testing.assert_allclose(_np(l_t), np.asarray(l_j), rtol=1e-5)
    o_x, m_x, l_x = jfa._lax_stats(*_jx(qkv_np), False)
    np.testing.assert_allclose(_np(l_t), np.asarray(l_x), rtol=1e-5)


def test_attention_stats_differentiable(qkv_np):
    """Cotangents flow through o, m and l (the ring combine uses all
    three); the port's blockwise backward equals JAX's custom VJP."""
    def loss_j(q, k, v):
        o, m, l = jfa.attention_stats(q, k, v, True, 128, 128)
        return (o ** 2).sum() + (m * 0.1).sum() + (l * 0.01).sum()

    g_j = jax.grad(loss_j, argnums=(0, 1, 2))(*_jx(qkv_np))
    q, k, v = _pt(qkv_np, grad=True)
    o, m, l = fa.attention_stats(q, k, v, True, 128, 128)
    ((o ** 2).sum() + (m * 0.1).sum() + (l * 0.01).sum()).backward()
    for a, b in zip((q.grad, k.grad, v.grad), g_j):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=2e-3)


def test_flash_bf16():
    rng = np.random.RandomState(1)
    arrs = [rng.randn(1, 128, 64).astype(np.float32) for _ in range(3)]
    o_j = jfa.flash_attention(*_jx(arrs, jnp.bfloat16), True, 128, 128)
    o_t = fa.flash_attention(*_pt(arrs, torch.bfloat16), True, 128, 128)
    assert o_t.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(o_t), np.asarray(o_j, np.float32),
                               atol=3e-2)


def test_strict_causal_offset_matches_jax(qkv_np):
    """causal_offset=1 (strict: row > col). Row 0 is fully masked: there
    the contract is m = NEG_INF only."""
    o_j, m_j, l_j = jfa.attention_stats(*_jx(qkv_np), True, 128, 128, 1)
    o_t, m_t, l_t = fa.attention_stats(*_pt(qkv_np), True, 128, 128, 1)
    np.testing.assert_allclose(_np(o_t)[:, 1:], np.asarray(o_j)[:, 1:],
                               atol=1e-4)
    np.testing.assert_allclose(_np(m_t), np.asarray(m_j), atol=1e-4)
    np.testing.assert_allclose(_np(l_t)[:, 1:], np.asarray(l_j)[:, 1:],
                               rtol=1e-5, atol=1e-5)
    assert np.all(_np(m_t)[:, 0] == fa.NEG_INF)
    assert np.all(np.isfinite(_np(o_t))) and np.all(np.isfinite(_np(l_t)))
    ref = fa.reference_attention(*_pt(qkv_np), True, 1)
    np.testing.assert_allclose(_np(o_t)[:, 1:], _np(ref)[:, 1:], atol=1e-4)


@pytest.mark.parametrize("offset", [0, 1])
def test_scan_stats_matches_jax(qkv_np, offset):
    """Blockwise scan_stats against the JAX package's, for several block
    widths, forward and gradients."""
    for bk in (64, 128, 256):
        o_j, m_j, l_j = jfa.scan_stats(*_jx(qkv_np), True, offset, bk)
        o_t, m_t, l_t = fa.scan_stats(*_pt(qkv_np), True, offset, bk)
        np.testing.assert_allclose(_np(o_t)[:, offset:],
                                   np.asarray(o_j)[:, offset:], atol=1e-4)
        np.testing.assert_allclose(_np(m_t), np.asarray(m_j), atol=1e-4)
        np.testing.assert_allclose(_np(l_t)[:, offset:],
                                   np.asarray(l_j)[:, offset:],
                                   rtol=1e-4, atol=1e-4)

    def loss_j(q, k, v):
        o, m, l = jfa.scan_stats(q, k, v, True, offset, 64)
        return (o.astype(jnp.float32) ** 2).sum() + (m * l).sum()

    g_j = jax.grad(loss_j, argnums=(0, 1, 2))(*_jx(qkv_np))
    q, k, v = _pt(qkv_np, grad=True)
    o, m, l = fa.scan_stats(q, k, v, True, offset, 64)
    ((o.float() ** 2).sum() + (m * l).sum()).backward()
    for a, b in zip((q.grad, k.grad, v.grad), g_j):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=2e-3,
                                   atol=2e-3)


def test_scan_stats_largest_divisor_fallback(qkv_np):
    """A length the block does not divide shrinks the block to its largest
    divisor (96 with block 64 -> 48), never to the dense path."""
    arrs = [a[:, :96] for a in qkv_np]
    o_j, m_j, l_j = jfa.scan_stats(*_jx(arrs), True, 0, 64)
    o_t, m_t, l_t = fa.scan_stats(*_pt(arrs), True, 0, 64)
    np.testing.assert_allclose(_np(o_t), np.asarray(o_j), atol=1e-4)
    np.testing.assert_allclose(_np(l_t), np.asarray(l_j), rtol=1e-4,
                               atol=1e-4)
    o_d, _, l_d = fa.lax_stats(*_pt(arrs), True, 0)
    np.testing.assert_allclose(_np(o_t), _np(o_d), atol=1e-4)


def test_flash_backward_is_blockwise_in_memory():
    """Neither direction keeps a [B, sq, sk] tensor: every tensor autograd
    saves, in the forward and in the backward's recompute, is at most one
    [B, sq, block_k] score block. The dense plain version, as a control,
    saves the full score matrix."""
    B, s, d, bk = 1, 512, 32, 64
    q, k, v = _pt([np.random.RandomState(7).randn(B, s, d)
                   .astype(np.float32)] * 3, grad=True)
    sizes = []

    def pack(t):
        sizes.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        (fa.flash_attention(q, k, v, True, 256, bk) ** 2).sum().backward()
    assert sizes and max(sizes) <= B * s * max(bk, d), max(sizes)
    sizes.clear()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        (fa.lax_stats(q, k, v, True)[0] ** 2).sum().backward()
    assert max(sizes) >= B * s * s


@pytest.mark.parametrize("sq,sk,bq,bk", [(256, 256, 96, 128),
                                        (256, 200, 128, 128)])
def test_non_dividing_lengths_raise(qkv_np, sq, sk, bq, bk):
    q, k, v = _pt(qkv_np)
    with pytest.raises(ValueError, match="divisible"):
        fa.attention_stats(q[:, :sq], k[:, :sk], v[:, :sk], True, bq, bk)
    with pytest.raises(ValueError, match="divisible"):
        jfa.attention_stats(*_jx([q[:, :sq].numpy(), k[:, :sk].numpy(),
                                  v[:, :sk].numpy()]), True, bq, bk)
