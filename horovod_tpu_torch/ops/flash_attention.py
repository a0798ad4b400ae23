"""Flash attention: the hand-written Hopper forward kernels and their
plain PyTorch versions — counterpart of
``horovod_tpu/ops/pallas/flash_attention.py``.

The forward replaces the Pallas kernel launched at ``flash_attention.py:122``:
q ``[B, sq, d]``, k/v ``[B, sk, d]`` → normalized o ``[B, sq, d]`` plus the
fp32 online-softmax stats m (running max) and l (running sum) ``[B, sq]``,
which ring attention combines exactly across rounds. Two CUDA kernels
serve it, by input dtype:

- bf16 (the main path): ``csrc/flash_attention_sm90.cu``, on the tensor
  cores (``wgmma``, TMA, an mbarrier pipeline);
- fp32: ``csrc/flash_attention_tf32.cu``, on the same skeleton in 3xTF32
  (each operand split into two TF32 parts, three products summed in fp32),
  since one TF32 product cannot hold fp32's tolerance.

The backward is not a kernel, as in the JAX package (``_stats_bwd``/``_bwd``
:263-286): it recomputes through ``scan_stats``, a blockwise loop over K/V
blocks with each block under ``torch.utils.checkpoint``, so neither
direction keeps a ``[B, sq, sk]`` score tensor. Only q, k and v are saved.

Dispatch: a CPU tensor takes the plain ``lax_stats`` path; a CUDA tensor
launches its dtype's kernel or raises. ``kernel_launches`` counts each
kernel's launches by name.
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30

_KERNEL_D = (32, 64, 128)
# input dtype -> (kernel name, csrc/ source, C function); both functions
# take (q, k, v, o, m, l, B, sq, sk, d, causal, causal_offset, scale, device,
# stream)
KERNELS = {
    torch.bfloat16: ("flash_attention_fwd", "flash_attention_sm90",
                     "hvd_flash_fwd_sm90"),
    torch.float32: ("flash_attention_fwd_fp32", "flash_attention_tf32",
                    "hvd_flash_fwd_tf32"),
}
ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]

# kernel launches made by _kernel_fwd, by kernel name, and by mask: causal
# with offset 0 (a ring's diagonal), none (a full block), causal with offset
# 1 (the striped ring's strict triangle) (read and reset by chip_smoke.py)
kernel_launches = {name: 0 for name, _, _ in KERNELS.values()}
mask_launches = {"diagonal": 0, "full": 0, "strict": 0}

_fns: dict = {}


def _kernel_fn(dtype):
    fn = _fns.get(dtype)
    if fn is None:
        from . import _build

        _, source, symbol = KERNELS[dtype]
        fn = getattr(_build.load(source), symbol)
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return fn


def _check_blocks(sq: int, sk: int, block_q: int, block_k: int):
    bq, bk = min(block_q, sq), min(block_k, sk)
    if sq % bq or sk % bk:
        raise ValueError(
            f"sequence lengths ({sq}, {sk}) must be divisible by the block "
            f"sizes ({bq}, {bk}); pick block_q/block_k that tile the "
            "sequence or use the blockwise fallback (scan_stats / "
            "use_flash=False)")


def _kernel_fwd(q, k, v, causal: bool, causal_offset: int):
    """Launch q's dtype's CUDA forward on q's device and PyTorch's current
    stream there. The C function makes q's device current for the launch."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"expected q [B, sq, d] and k, v [B, sk, d]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, sq, d = q.shape
    if k.shape[0] != B or k.shape[2] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch or head dim")
    if d not in _KERNEL_D:
        raise ValueError(f"head dim {d} not supported by the kernel "
                         f"({_KERNEL_D})")
    if q.dtype not in KERNELS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: the "
                         "kernels take one of bfloat16, float32")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one CUDA device")
    if q.numel() == 0 or k.numel() == 0:
        raise ValueError("flash attention needs non-empty q and k")
    # TMA takes 16-byte-aligned bases and row strides (d * 2 >= 64 bytes)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if q.device.type != "cuda":
        raise ValueError(f"the kernels take CUDA tensors, not {q.device}")
    fn = _kernel_fn(q.dtype)
    dev = q.device
    o = torch.empty_like(q)
    m = torch.empty((B, sq), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             m.data_ptr(), l.data_ptr(), B, sq, k.shape[1], d, int(causal),
             int(causal_offset), d ** -0.5, dev.index,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: error "
                           f"{err} (a cudaError_t, or 10000 + the CUresult "
                           "of a failed tensor-map encode)")
    kernel_launches[KERNELS[q.dtype][0]] += 1
    mask_launches[("strict" if causal_offset else "diagonal") if causal
                  else "full"] += 1
    return o, m, l


def _flash_fwd(q, k, v, causal: bool, block_q: int, block_k: int,
               causal_offset: int = 0):
    """(o, m, l) from the kernel on CUDA, from ``lax_stats`` on the CPU."""
    _check_blocks(q.shape[1], k.shape[1], block_q, block_k)
    if q.device.type == "cuda":
        return _kernel_fwd(q, k, v, causal, causal_offset)
    if q.device.type == "cpu":
        return lax_stats(q, k, v, causal, causal_offset)
    raise ValueError(f"flash attention runs on CUDA or the CPU, not "
                     f"{q.device}")


def _mask(sq: int, sk: int, causal_offset: int, device):
    # keep row >= col + causal_offset (jnp.tril(k=-causal_offset))
    return torch.ones((sq, sk), dtype=torch.bool,
                      device=device).tril(-causal_offset)


def reference_attention(q, k, v, causal: bool, causal_offset: int = 0):
    """Plain attention, the numerics oracle (``_reference_attention``
    :150). q/k/v: [B, s, d]."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q, k).float() * scale
    if causal:
        s = torch.where(_mask(q.shape[1], k.shape[1], causal_offset,
                              q.device), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p.to(v.dtype), v)


def lax_stats(q, k, v, causal: bool, causal_offset: int = 0):
    """Plain stats attention (``_lax_stats`` :177-193): normalized o,
    running max m and sum l in the kernel's contract — the kernel's plain
    version."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q, k).float() * scale
    if causal:
        s = torch.where(_mask(q.shape[1], k.shape[1], causal_offset,
                              q.device), s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bqk,bkd->bqd", p.to(v.dtype), v).float()
    o = (o / torch.where(l == 0.0, 1.0, l)[..., None]).to(q.dtype)
    return o, m, l


def _scan_block(m, l, acc, qf, kj, vj, col0: int, causal: bool,
                causal_offset: int, scale: float):
    s = torch.einsum("bqd,bkd->bqk", qf, kj.float()) * scale
    if causal:
        rows = torch.arange(qf.shape[1], device=qf.device)[:, None]
        cols = col0 + torch.arange(kj.shape[1], device=qf.device)[None]
        s = torch.where(rows >= cols + causal_offset, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l = l * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.einsum("bqk,bkd->bqd", p,
                                                vj.float())
    return m_new, l, acc


def scan_stats(q, k, v, causal: bool = True, causal_offset: int = 0,
               block_k: int = 512):
    """Blockwise stats attention (``scan_stats`` :196-245): the (o, m, l)
    contract as a loop over K/V blocks, each block checkpointed, so both
    autograd directions hold one ``[B, sq, block_k]`` score block and never
    the full ``[B, sq, sk]`` matrix."""
    B, sq, d = q.shape
    sk = k.shape[1]
    bk = min(block_k, sk)
    if sk % bk:
        # largest divisor of sk that is <= block_k: stays blockwise for any
        # length without degenerating to tiny blocks
        bk = max(x for x in range(1, bk + 1) if sk % x == 0)
    scale = d ** -0.5
    qf = q.float()
    m = torch.full((B, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, sq, d), dtype=torch.float32, device=q.device)
    for c0 in range(0, sk, bk):
        m, l, acc = checkpoint(_scan_block, m, l, acc, qf,
                               k[:, c0:c0 + bk], v[:, c0:c0 + bk], c0,
                               causal, causal_offset, scale,
                               use_reentrant=False)
    o = (acc / torch.where(l == 0.0, 1.0, l)[..., None]).to(q.dtype)
    return o, m, l


class _AttentionStats(torch.autograd.Function):
    """Kernel forward, blockwise-recompute backward (``attention_stats``
    with ``_stats_fwd``/``_stats_bwd``): cotangents of o, m and l all flow,
    since the ring combine makes m and l real outputs."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k, causal_offset):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v)
        ctx.cfg = (causal, block_k, causal_offset)
        return _flash_fwd(q, k, v, causal, block_q, block_k, causal_offset)

    @staticmethod
    def backward(ctx, do, dm, dl):
        q, k, v = ctx.saved_tensors
        causal, block_k, causal_offset = ctx.cfg
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in (q, k, v)]
            outs = scan_stats(*ins, causal, causal_offset, block_k)
        pairs = [(o, g) for o, g in zip(outs, (do, dm, dl)) if g is not None]
        if not pairs:
            return (None,) * 7
        # v does not reach m or l: its gradient is None without do
        grads = torch.autograd.grad([o for o, _ in pairs], ins,
                                    [g for _, g in pairs], allow_unused=True)
        return (*grads, None, None, None, None)


def attention_stats(q, k, v, causal: bool = True, block_q: int = 512,
                    block_k: int = 512, causal_offset: int = 0):
    """Differentiable stats attention: (o, m, l), kernel forward on CUDA.
    An autograd node is recorded only where a gradient can flow, as
    PyTorch's own operators do; otherwise the forward runs alone."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _AttentionStats.apply(q, k, v, causal, block_q, block_k,
                                     causal_offset)
    return _flash_fwd(q, k, v, causal, block_q, block_k, causal_offset)


def flash_attention_stats(q, k, v, causal: bool = True, block_q: int = 512,
                          block_k: int = 512):
    """Forward returning (o, m, l) for cross-device (ring) combination."""
    return attention_stats(q, k, v, causal, block_q, block_k, 0)


def flash_attention(q, k, v, causal: bool = True, block_q: int = 512,
                    block_k: int = 512):
    """Fused attention: q [B, sq, d] × k/v [B, sk, d] → [B, sq, d]."""
    return attention_stats(q, k, v, causal, block_q, block_k, 0)[0]
