"""Sequence parallelism: ring attention — counterpart of
``horovod_tpu/parallel/sp.py`` (``ring_attention`` :83-124 over the
``_ring_scan`` scaffold :34-71).

Inputs are per-rank blocks ``[batch, s_local, heads, head_dim]``; each round
produces normalized ``(o, m, l)`` block stats in the kernel layout
``[batch*heads, s, head_dim]`` and an online softmax combines them exactly.

This slice runs a ring of one: round 0 is the causal diagonal block through
``attention_stats`` (the flash kernel on CUDA). The K/V rotation over
``torch.distributed`` point-to-point for a ring larger than one, and the
striped variant, are ROADMAP.md queue 1 item 15.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.flash_attention import NEG_INF, attention_stats, scan_stats


def _to_flat(x):  # kernel layout: [B=b*h, s, d]
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d).contiguous()


def _combine(rounds, shape, dtype):
    """The ring's online-softmax combine (``_ring_scan`` :54-70): each
    round's normalized ``o`` is un-normalized by ``l * beta`` and merged
    into running (m, l, o); the sum is normalized once at the end."""
    b, s, h, d = shape
    m_acc = l_acc = o_acc = None
    for o_r, m_r, l_r in rounds:
        if m_acc is None:
            m_acc = torch.full_like(m_r, NEG_INF)
            l_acc = torch.zeros_like(l_r)
            o_acc = torch.zeros(o_r.shape, dtype=torch.float32,
                                device=o_r.device)
        m_new = torch.maximum(m_acc, m_r)
        alpha = torch.exp(m_acc - m_new)
        beta = torch.exp(m_r - m_new)
        l_acc = l_acc * alpha + l_r * beta
        o_acc = (o_acc * alpha[..., None]
                 + o_r.float() * (l_r * beta)[..., None])
        m_acc = m_new
    out = o_acc / torch.where(l_acc == 0.0, 1.0, l_acc)[..., None]
    return out.reshape(b, h, s, d).transpose(1, 2).to(dtype)


def ring_attention(q, k, v, group=None, use_flash=None, block_q: int = 512,
                   block_k: int = 512):
    """Causal ring attention over ``group`` (a ``torch.distributed`` group;
    ``None`` is a ring of one). Returns the attention output for the local
    Q block, same shape and dtype as q ``[batch, s_local, heads, head_dim]``.

    ``use_flash=None`` takes the flash kernel for any tensor off the CPU,
    which raises ``ValueError`` when the block sizes do not tile the
    sequence: on the card there is no plain path to give way to. CPU
    tensors, and ``use_flash=False``, take the blockwise plain path.
    """
    n = 1 if group is None else dist.get_world_size(group)
    if n > 1:
        raise NotImplementedError(
            f"ring_attention over {n} ranks: the K/V rotation is not ported "
            "yet (ROADMAP.md queue 1 item 15); this slice runs a ring of one")
    if use_flash is None:
        use_flash = q.device.type != "cpu"
    qf, kf, vf = _to_flat(q), _to_flat(k), _to_flat(v)
    # round 0 is the diagonal block: causal
    if use_flash:
        stats = attention_stats(qf, kf, vf, True, block_q, block_k)
    else:
        stats = scan_stats(qf, kf, vf, True, 0, block_k)
    return _combine([stats], q.shape, q.dtype)
