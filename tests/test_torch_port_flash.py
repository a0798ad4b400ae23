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


@pytest.mark.parametrize("case", ["inputs need no gradient", "no_grad"])
def test_attention_stats_without_gradient_records_no_node(qkv_np, case):
    """Where no gradient can flow, the forward runs without an autograd
    node and gives the recorded path's (o, m, l), which match the JAX
    package's."""
    o_j, m_j, l_j = jfa.attention_stats(*_jx(qkv_np), True, 128, 128)
    recorded = fa.attention_stats(*_pt(qkv_np, grad=True), True, 128, 128)
    assert all(t.grad_fn is not None for t in recorded)
    if case == "no_grad":
        with torch.no_grad():
            outs = fa.attention_stats(*_pt(qkv_np, grad=True), True, 128, 128)
    else:
        outs = fa.attention_stats(*_pt(qkv_np), True, 128, 128)
    for t, r in zip(outs, recorded):
        assert t.grad_fn is None and not t.requires_grad
        np.testing.assert_array_equal(_np(t), _np(r))
    np.testing.assert_allclose(_np(outs[0]), np.asarray(o_j), atol=1e-4)
    np.testing.assert_allclose(_np(outs[1]), np.asarray(m_j), atol=1e-5)
    np.testing.assert_allclose(_np(outs[2]), np.asarray(l_j), rtol=1e-5)


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


# --- the bf16 tensor-core kernel's arithmetic, rehearsed on the CPU ---------
#
# csrc/flash_attention_sm90.cu cannot run here, so this emulates its
# arithmetic tile by tile in plain PyTorch (fp32 S, exp2 with the scale and
# log2 e folded into one FMA, p rounded to bf16 before P V, l summing the
# fp32 p, finite-NEG_INF masking only on tiles that cross the diagonal or
# the ragged end, fully masked K tiles never visited) and holds it against
# both packages' plain stats attention at the tolerances chip_smoke.py
# holds the kernel to on the card.

_BQ, _BK, _ROWS = 128, 128, 64   # Q tile, K tile, rows per warpgroup
_LOG2E = 1.4426950408889634
_U_BF16 = 2.0 ** -8
NEG_INF_F32 = float(np.float32(fa.NEG_INF))


def _emulate_tiled(q, k, v, causal, offset, bk, mm_s, mm_pv):
    """(o, m, l) in fp32 as the Hopper kernels compute them, tile by tile:
    128-row Q tiles in two 64-row warpgroups, ``bk``-key K tiles, S =
    ``mm_s(q, k^T)``, O += ``mm_pv(p, v)``; q, k, v fp32."""
    B, sq, d = q.shape
    sk = k.shape[1]
    f32 = torch.float32
    scale = torch.tensor(d ** -0.5, dtype=f32)
    sl2 = (scale * torch.tensor(_LOG2E, dtype=f32)).double()
    o = torch.zeros((B, sq, d), dtype=f32)
    m_out = torch.zeros((B, sq), dtype=f32)
    l_out = torch.zeros((B, sq), dtype=f32)
    for q0 in range(0, sq, _BQ):
        q_last = min(q0 + _BQ, sq) - 1
        k_end = min(sk, q_last - offset + 1) if causal else sk
        n_k = -(-k_end // bk) if k_end > 0 else 0
        for row0 in range(q0, min(q0 + _BQ, sq), _ROWS):   # warpgroups
            rows = torch.arange(row0, min(row0 + _ROWS, sq))
            m = torch.full((B, len(rows)), NEG_INF_F32, dtype=f32)
            l = torch.zeros((B, len(rows)), dtype=f32)
            acc = torch.zeros((B, len(rows), d), dtype=f32)
            for j in range(n_k):
                k0 = j * bk
                cols = torch.arange(k0, min(k0 + bk, sk))  # -inf past sk
                s = mm_s(q[:, rows], k[:, cols].transpose(1, 2))
                masked = causal and k0 + bk - 1 + offset > row0
                keep = (rows[:, None] >= cols[None] + offset
                        if masked else torch.ones((), dtype=torch.bool))
                s = torch.where(keep, s, -torch.inf)
                m_new = torch.maximum(m, s.amax(-1) * scale)
                alpha = torch.exp2((m - m_new) * _LOG2E)
                ml = (m_new * _LOG2E).double()
                p = torch.exp2((s.double() * sl2 - ml[..., None]).to(f32))
                # a causally masked score is NEG_INF: p = exp(NEG_INF - m)
                p = torch.where(keep, p, (m_new == NEG_INF_F32).to(f32)
                                [..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + mm_pv(p, v[:, cols])
                m = m_new
            o[:, rows] = acc / torch.where(l == 0, 1.0, l)[..., None]
            m_out[:, rows], l_out[:, rows] = m, l
    return o, m_out, l_out


def _emulate_sm90(q, k, v, causal, offset):
    """(o bf16, m, l) as the sm90 kernel computes them; q, k, v bf16."""
    o, m, l = _emulate_tiled(
        q.float(), k.float(), v.float(), causal, offset, _BK, torch.matmul,
        lambda p, vj: p.to(torch.bfloat16).float() @ vj)
    return o.to(torch.bfloat16), m, l


@pytest.mark.parametrize("B,sq,sk,d,causal,offset", [
    (2, 256, 256, 64, False, 0),
    (2, 256, 256, 64, True, 0),
    (2, 256, 256, 32, True, 1),
    (3, 200, 200, 128, True, 0),     # ragged Q and K tiles
    (3, 200, 200, 128, True, 1),
    (2, 64, 64, 128, True, 0),       # below one Q tile
    (1, 256, 512, 64, False, 0),     # sq < sk
])
def test_sm90_tiled_emulation_matches_plain(B, sq, sk, d, causal, offset):
    rng = np.random.RandomState(sq + sk + d + offset)
    arrs = [rng.randn(B, n, d).astype(np.float32) for n in (sq, sk, sk)]
    q, k, v = _pt(arrs, torch.bfloat16)
    o, m, l = _emulate_sm90(q, k, v, causal, offset)
    # the plain versions on the same (bf16-valued) inputs in fp32
    q32, k32, v32 = q.float(), k.float(), v.float()
    o_p, m_p, l_p = fa.lax_stats(q32, k32, v32, causal, offset)
    o_j, m_j, l_j = jfa._lax_stats(*_jx([_np(q), _np(k), _np(v)]), causal,
                                   offset)
    r0 = offset if causal else 0
    o_abs = fa.lax_stats(q32, k32, v32.abs(), causal, offset)[0]
    tol_o = 1.01 * _U_BF16 * (o_p.abs() + o_abs) + 1e-5
    jax_out = [torch.tensor(np.asarray(x)) for x in (o_j, m_j, l_j)]
    for o_ref, m_ref, l_ref in ((o_p, m_p, l_p), jax_out):
        assert ((o.float() - o_ref)[:, r0:].abs()
                <= tol_o[:, r0:]).all()
        np.testing.assert_allclose(_np(m)[:, r0:], _np(m_ref)[:, r0:],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(_np(l)[:, r0:], _np(l_ref)[:, r0:],
                                   rtol=1e-5, atol=0)
    if r0:
        assert (m[:, :r0] == NEG_INF_F32).all()
        assert torch.isfinite(o.float()).all() and torch.isfinite(l).all()


def test_sm90_emulation_rounds_p_before_pv():
    """The emulation is not the fp32 algorithm: keeping p in fp32 before
    P V moves o by more than fp32 order, so the test above exercises the
    bf16 rounding of p that the bound allows for."""
    rng = np.random.RandomState(5)
    q, k, v = _pt([rng.randn(1, 128, 64).astype(np.float32)
                   for _ in range(3)], torch.bfloat16)
    o, _, _ = _emulate_sm90(q, k, v, True, 0)
    o32 = fa.lax_stats(q.float(), k.float(), v.float(), True)[0]
    assert (o.float() - o32).abs().max() > 1e-4


# --- the fp32 kernel's 3xTF32 arithmetic, rehearsed on the CPU ------------
#
# csrc/flash_attention_tf32.cu runs both products on the TF32 tensor cores,
# which read an fp32 operand as TF32 by ignoring its 13 low mantissa bits.
# Each operand is split as x = hi + lo with hi = x itself (read as
# trunc(x)) and lo = x - trunc(x) (exact in fp32, read as trunc(lo)), and a
# product is hi*lo + lo*hi + hi*hi in fp32; 32-key K tiles; P V takes the
# keys of each group of 8 in the order [0,2,4,6,1,3,5,7], in p's columns
# and V's rows alike. This emulates that arithmetic and holds it against
# both packages' plain stats attention at chip_smoke.py's fp32 tolerances
# (o 1e-4, m 1e-5, l 1e-5 relative).

_TF32_BK = 32
_TF32_PERM = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])


def _tf32(x):
    """fp32 as the TF32 tensor cores read it: the 13 low mantissa bits
    cleared (toward zero), by bit operations."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm_tf32(a, b, products=3):
    """a @ b on TF32 tensor cores: hi*lo + lo*hi + hi*hi (3xTF32), or the
    one product hi*hi, with hi = x and lo = x - trunc(x) as the kernel
    passes them and each read through tf32()."""
    ah, bh = _tf32(a), _tf32(b)
    if products == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (ah @ bl + al @ bh) + ah @ bh


def _pv_permuted(p, vj, products=3):
    """P V with the keys of each group of 8 permuted, in p and V alike; a
    ragged last tile pads p and V with zeros (the kernel's p = 0 and the
    zero rows TMA reads past sk)."""
    n = p.shape[-1]
    pad = -n % 8
    p = torch.nn.functional.pad(p, (0, pad))
    vj = torch.nn.functional.pad(vj, (0, 0, 0, pad))
    idx = (torch.arange(0, n + pad, 8)[:, None] + _TF32_PERM).reshape(-1)
    return _mm_tf32(p[..., idx], vj[:, idx], products)


def _emulate_tf32(q, k, v, causal, offset, products=3):
    return _emulate_tiled(
        q, k, v, causal, offset, _TF32_BK,
        lambda a, b: _mm_tf32(a, b, products),
        lambda p, vj: _pv_permuted(p, vj, products))


TF32_CASES = [(2, 256, 256, d, causal, offset) for d in (32, 64, 128)
              for causal, offset in ((False, 0), (True, 0), (True, 1))]
TF32_CASES += [(2, 200, 200, 64, True, 0),    # ragged Q and K tiles
               (3, 200, 200, 128, True, 1),
               (1, 256, 512, 64, False, 0)]   # sq < sk


@pytest.mark.parametrize("B,sq,sk,d,causal,offset", TF32_CASES)
def test_tf32_tiled_emulation_matches_plain(B, sq, sk, d, causal, offset):
    rng = np.random.RandomState(sq + sk + d + offset + 7)
    arrs = [rng.randn(B, n, d).astype(np.float32) for n in (sq, sk, sk)]
    q, k, v = _pt(arrs)
    o, m, l = _emulate_tf32(q, k, v, causal, offset)
    o_p, m_p, l_p = fa.lax_stats(q, k, v, causal, offset)
    o_j, m_j, l_j = jfa._lax_stats(*_jx(arrs), causal, offset)
    r0 = offset if causal else 0
    jax_out = [torch.tensor(np.asarray(x)) for x in (o_j, m_j, l_j)]
    for o_ref, m_ref, l_ref in ((o_p, m_p, l_p), jax_out):
        np.testing.assert_allclose(_np(o)[:, r0:], _np(o_ref)[:, r0:],
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(_np(m)[:, r0:], _np(m_ref)[:, r0:],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(_np(l)[:, r0:], _np(l_ref)[:, r0:],
                                   rtol=1e-5, atol=0)
    if r0:
        assert (m[:, :r0] == NEG_INF_F32).all()
        assert torch.isfinite(o).all() and torch.isfinite(l).all()


def test_tf32_rounding_and_split():
    """tf32() keeps 10 mantissa bits, truncating toward zero, x - trunc(x)
    is exact in fp32, and hi + lo as read holds 21 or more bits of x."""
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -10 + 2.0 ** -11, -(1.0 + 2.0 ** -10),
                      3.0], dtype=torch.float32)
    assert _tf32(x).tolist() == [1.0, -1.0, 1.0 + 2.0 ** -10,
                                 -(1.0 + 2.0 ** -10), 3.0]
    y = torch.tensor(np.random.RandomState(3).randn(4096), dtype=torch.float32)
    hi = _tf32(y)
    lo = y - hi
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert torch.equal(hi.double() + lo.double(), y.double())
    assert ((hi + _tf32(lo) - y).abs() <= 2.0 ** -21 * y.abs()).all()


def test_tf32_single_product_misses_fp32_tolerance():
    """One TF32 product (hi*hi) moves o by more than the 1e-4 that the
    three products hold: why the kernel needs 3xTF32."""
    rng = np.random.RandomState(11)
    q, k, v = _pt([rng.randn(2, 256, 128).astype(np.float32)
                   for _ in range(3)])
    o1, _, _ = _emulate_tf32(q, k, v, True, 0, products=1)
    o3, _, _ = _emulate_tf32(q, k, v, True, 0)
    o_p = fa.lax_stats(q, k, v, True, 0)[0]
    assert (o1 - o_p).abs().max() > 1e-4
    assert (o3 - o_p).abs().max() <= 1e-4


# --- _kernel_fwd's argument checks, before any build -----------------------

def _no_build(monkeypatch):
    from horovod_tpu_torch.ops import _build

    def refuse(name):
        raise AssertionError(f"a build of {name} was tried")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(fa, "_fns", {})


def _bad_args():
    q = torch.zeros((2, 64, 64), dtype=torch.bfloat16)
    wide = torch.zeros((2, 64, 128), dtype=torch.bfloat16)
    return {
        "d48": ([torch.zeros((2, 64, 48), dtype=torch.bfloat16)] * 3,
                "head dim"),
        "fp16": ([q.half()] * 3, "dtypes"),
        "non-contiguous q": ([wide[..., :64], q, q], "contiguous"),
        "k/v shape mismatch": ([q, q, q[:, :32]], "expected q"),
        "cpu tensors": ([q, q, q], "CUDA tensors"),
    }


@pytest.mark.parametrize("case", list(_bad_args()))
def test_kernel_fwd_argument_checks_raise_before_build(monkeypatch, case):
    _no_build(monkeypatch)
    args, match = _bad_args()[case]
    launches = sum(fa.kernel_launches.values())
    with pytest.raises(ValueError, match=match):
        fa._kernel_fwd(*args, True, 0)
    assert sum(fa.kernel_launches.values()) == launches


@pytest.mark.parametrize("dtype,source,symbol", [
    (torch.bfloat16, "flash_attention_sm90", "hvd_flash_fwd_sm90"),
    (torch.float32, "flash_attention_tf32", "hvd_flash_fwd_tf32"),
])
def test_kernel_dispatch_by_dtype(monkeypatch, dtype, source, symbol):
    """bf16 loads the bf16 tensor-core kernel, fp32 the 3xTF32 one."""
    from horovod_tpu_torch.ops import _build

    loaded = []

    class _Lib:
        def __getattr__(self, name):
            loaded.append(name)
            return lambda *a: 0

    monkeypatch.setattr(fa, "_fns", {})
    monkeypatch.setattr(_build, "load",
                        lambda name: loaded.append(name) or _Lib())
    fa._kernel_fn(dtype)
    assert loaded == [source, symbol]
    assert fa.KERNELS[dtype][1:] == (source, symbol)
