"""Decoder-only transformer LM — counterpart of
``horovod_tpu/models/transformer.py``.

The parameters keep the JAX package's layouts and names, so a JAX parameter
pytree maps one to one onto ``state_dict`` keys (``params_from_jax``):

  embed (V, d)   pos (max_seq, d)   ln_f.scale (d,)
  blocks.<i>.ln1.scale, blocks.<i>.ln2.scale (d,)
  blocks.<i>.wq / wk / wv (d, h, hd)   blocks.<i>.wo (h, hd, d)
  blocks.<i>.w1 (d, d_ff)   blocks.<i>.w2 (d_ff, d)

Parameters are fp32 and cast to ``cfg.dtype`` at use; RMSNorm runs in fp32
and the logits are ``x.float() @ embed.T`` in fp32, as in the JAX model.
The ``attn_fn(q, k, v)`` hook (q/k/v ``[b, s, h, hd]``) lets
``parallel.sp`` (ring, striped ring, Ulysses) replace the plain
``causal_attention``; under sequence parallelism the caller passes each
rank's global ``positions``. ``cfg.remat`` recomputes each block in the
backward (``torch.utils.checkpoint``, as ``jax.checkpoint(_block)``), and
``cfg.xent_chunk`` makes ``lm_loss`` stream the classifier over vocabulary
chunks (``ops/xent.py``, K5) instead of materializing fp32 logits
``[tokens, vocab]``. The matrix products of the model are plain
``torch.einsum``, as XLA computed them outside any kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..common.context import default_device


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 2048
    max_seq: int = 2048
    dtype: torch.dtype = torch.bfloat16
    # recompute each block in the backward pass: activation memory drops
    # from O(layers) to O(1) blocks for about a third more FLOPs
    remat: bool = False
    # lm_loss streams the classifier over vocab chunks of this size
    # (ops/xent.py) instead of materializing fp32 logits [tokens, vocab].
    # None = dense.
    xent_chunk: Optional[int] = None

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


class _Scale(nn.Module):
    def __init__(self, d: int, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device))


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        d, h, hd, f = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff

        def p(*shape):
            return nn.Parameter(torch.empty(shape, device=device))

        self.ln1 = _Scale(d, device)
        self.ln2 = _Scale(d, device)
        self.wq, self.wk, self.wv = p(d, h, hd), p(d, h, hd), p(d, h, hd)
        self.wo = p(h, hd, d)
        self.w1 = p(d, f)
        self.w2 = p(f, d)

    def forward(self, x, dtype, attn_fn):
        h = _rmsnorm(x, self.ln1.scale)
        q = torch.einsum("bsd,dhk->bshk", h, self.wq.to(dtype))
        k = torch.einsum("bsd,dhk->bshk", h, self.wk.to(dtype))
        v = torch.einsum("bsd,dhk->bshk", h, self.wv.to(dtype))
        o = attn_fn(q, k, v)
        x = x + torch.einsum("bshk,hkd->bsd", o, self.wo.to(dtype))
        h = _rmsnorm(x, self.ln2.scale)
        # jax.nn.gelu defaults to the tanh approximation
        ff = F.gelu(torch.einsum("bsd,df->bsf", h, self.w1.to(dtype)),
                    approximate="tanh")
        return x + torch.einsum("bsf,fd->bsd", ff, self.w2.to(dtype))


class TransformerLM(nn.Module):
    """The LM with random weights drawn from ``seed`` on ``device``
    (normal, std 0.02; norm scales 1, as ``transformer.init``).
    ``device=None`` is ``hvd.device()``, or ``cuda:<local_rank>`` before
    ``hvd.init()``; without CUDA it raises unless ``device="cpu"``."""

    def __init__(self, cfg: TransformerConfig, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        device = (torch.device(device) if device is not None
                  else default_device())
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model,
                                              device=device))
        self.pos = nn.Parameter(torch.empty(cfg.max_seq, cfg.d_model,
                                            device=device))
        self.ln_f = _Scale(cfg.d_model, device)
        self.blocks = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.n_layers))
        gen = torch.Generator(device=self.embed.device).manual_seed(seed)
        with torch.no_grad():
            for name, prm in self.named_parameters():
                if not name.endswith(".scale"):
                    prm.normal_(0.0, 0.02, generator=gen)

    def forward(self, tokens, attn_fn=None, positions=None,
                return_hidden: bool = False):
        """tokens [b, s] → fp32 logits [b, s, V], or with
        ``return_hidden=True`` the final hidden states [b, s, d] in
        ``cfg.dtype`` (for the chunked loss). ``positions`` [s]: the
        tokens' global position ids (a rank's shard under sequence
        parallelism); by default 0..s-1."""
        dtype = self.cfg.dtype
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = self.embed[tokens].to(dtype) + self.pos[positions].to(dtype)[None]
        attn_fn = attn_fn or causal_attention
        for blk in self.blocks:
            if self.cfg.remat and torch.is_grad_enabled():
                # the whole block again in the backward, exchanges included,
                # on every rank alike: no early stop partway through it
                x = checkpoint(blk, x, dtype, attn_fn, use_reentrant=False,
                               early_stop=False)
            else:
                x = blk(x, dtype, attn_fn)
        x = _rmsnorm(x, self.ln_f.scale)
        if return_hidden:
            return x
        return x.float() @ self.embed.T


def _rmsnorm(x, scale):
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + 1e-6)
    return (y * scale).to(x.dtype)


def causal_attention(q, k, v):
    """Plain causal attention, [b, s, h, hd] layout, fp32 softmax."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bshk,bthk->bhst", q, k).float() * scale
    s, t = logits.shape[-2], logits.shape[-1]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device).tril()
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthk->bshk", probs, v)


def lm_loss(model: TransformerLM, tokens, **kw):
    """Next-token cross-entropy, mean over tokens. With
    ``cfg.xent_chunk`` the classifier streams over vocabulary chunks
    (``ops.xent.chunked_softmax_xent``, K5) and the fp32 logits
    [tokens, vocab] never exist."""
    chunk = model.cfg.xent_chunk
    if chunk:
        from ..ops.xent import chunked_softmax_xent

        h = model(tokens[:, :-1], return_hidden=True, **kw)
        b, s, d = h.shape
        return chunked_softmax_xent(h.reshape(b * s, d), model.embed,
                                    tokens[:, 1:].reshape(-1), chunk)
    logits = model(tokens[:, :-1], **kw)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1))


def params_from_jax(params) -> dict:
    """A ``state_dict`` for ``TransformerLM`` from the JAX package's
    parameter pytree (``transformer.init``), given as numpy arrays."""
    out = {"embed": params["embed"], "pos": params["pos"],
           "ln_f.scale": params["ln_f"]["scale"]}
    for i, blk in enumerate(params["blocks"]):
        for key in ("wq", "wk", "wv", "wo", "w1", "w2"):
            out[f"blocks.{i}.{key}"] = blk[key]
        for key in ("ln1", "ln2"):
            out[f"blocks.{i}.{key}.scale"] = blk[key]["scale"]
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in out.items()}
