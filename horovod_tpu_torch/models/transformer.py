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

Tensor parallelism (``TransformerLM(cfg, tp_group=mesh.group("tp"))``):
each block holds its ``h/tp`` heads of wq/wk/wv/wo and its ``d_ff/tp``
slice of w1/w2, sharded on the dims of the JAX package's ``param_specs``
(``transformer.py:85-104``; here ``param_specs(cfg)``, the shard dim of
each ``state_dict`` key). The attention output and w2 close with
``parallel.tp``'s sum over the group; the norms' output enters the
column-parallel products through its conjugate (the identity, whose
backward sums the gradient), so every rank's gradients are the dense
model's: its slice of a sharded leaf's, the whole of a replicated one's.
The attention runs on the local heads. The weights are drawn as the
dense model's from ``seed`` and sliced, so a tp rank holds its slice of
the tp-1 model's. Without a group (tp 1) the model is the dense one.
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
from ..parallel._comm import copy_to_group, group_size_rank
from ..parallel.tp import (column_parallel_dense, parallel_attention_output,
                           row_parallel_dense)


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
    def __init__(self, cfg: TransformerConfig, device, tp_group=None):
        super().__init__()
        tp, _ = group_size_rank(tp_group)
        if cfg.n_heads % tp or cfg.d_ff % tp:
            raise ValueError(f"n_heads ({cfg.n_heads}) and d_ff ({cfg.d_ff}) "
                             f"must divide by tp={tp}")
        d, h, hd, f = cfg.d_model, cfg.n_heads // tp, cfg.head_dim, \
            cfg.d_ff // tp
        self.tp_group = tp_group

        def p(*shape):
            return nn.Parameter(torch.empty(shape, device=device))

        self.ln1 = _Scale(d, device)
        self.ln2 = _Scale(d, device)
        self.wq, self.wk, self.wv = p(d, h, hd), p(d, h, hd), p(d, h, hd)
        self.wo = p(h, hd, d)
        self.w1 = p(d, f)
        self.w2 = p(f, d)

    def forward(self, x, dtype, attn_fn):
        g = self.tp_group
        h = copy_to_group(_rmsnorm(x, self.ln1.scale), g)
        q = torch.einsum("bsd,dhk->bshk", h, self.wq.to(dtype))
        k = torch.einsum("bsd,dhk->bshk", h, self.wk.to(dtype))
        v = torch.einsum("bsd,dhk->bshk", h, self.wv.to(dtype))
        o = attn_fn(q, k, v)
        x = x + parallel_attention_output(o, self.wo.to(dtype), g)
        h = _rmsnorm(x, self.ln2.scale)
        # jax.nn.gelu defaults to the tanh approximation
        ff = F.gelu(column_parallel_dense(h, self.w1.to(dtype), group=g),
                    approximate="tanh")
        return x + row_parallel_dense(ff, self.w2.to(dtype), g)


class TransformerLM(nn.Module):
    """The LM with random weights drawn from ``seed`` on ``device``
    (normal, std 0.02; norm scales 1, as ``transformer.init``).
    ``device=None`` is ``hvd.device()``, or ``cuda:<local_rank>`` before
    ``hvd.init()``; without CUDA it raises unless ``device="cpu"``.
    ``tp_group``: the tensor-parallel group (``None``: tp 1); a rank holds
    its slice of each sharded leaf of the dense model drawn from
    ``seed``."""

    def __init__(self, cfg: TransformerConfig, device=None, seed: int = 0,
                 tp_group=None):
        super().__init__()
        self.cfg = cfg
        device = (torch.device(device) if device is not None
                  else default_device())
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model,
                                              device=device))
        self.pos = nn.Parameter(torch.empty(cfg.max_seq, cfg.d_model,
                                            device=device))
        self.ln_f = _Scale(cfg.d_model, device)
        self.blocks = nn.ModuleList(Block(cfg, device, tp_group)
                                    for _ in range(cfg.n_layers))
        tp, tp_rank = group_size_rank(tp_group)
        specs = param_specs(cfg)
        gen = torch.Generator(device=self.embed.device).manual_seed(seed)
        with torch.no_grad():
            for name, prm in self.named_parameters():
                if name.endswith(".scale"):
                    continue
                dim = specs[name]
                if tp == 1 or dim is None:
                    prm.normal_(0.0, 0.02, generator=gen)
                    continue
                # the dense leaf's draw, then this rank's slice of it
                shape = list(prm.shape)
                shape[dim] *= tp
                full = torch.empty(shape, device=prm.device)
                full.normal_(0.0, 0.02, generator=gen)
                prm.copy_(tp_slice(full, dim, tp_rank, tp))

    def forward(self, tokens, attn_fn=None, positions=None,
                return_hidden: bool = False):
        """tokens [b, s] → fp32 logits [b, s, V], or with
        ``return_hidden=True`` the final hidden states [b, s, d] in
        ``cfg.dtype`` (for the chunked loss). ``positions`` [s]: the
        tokens' global position ids (a rank's shard under sequence
        parallelism); by default 0..s-1."""
        dtype = self.cfg.dtype
        x = self.embed_tokens(tokens, positions)
        attn_fn = attn_fn or causal_attention
        for blk in self.blocks:
            if self.cfg.remat and torch.is_grad_enabled():
                # the whole block again in the backward, exchanges included,
                # on every rank alike: no early stop partway through it
                x = checkpoint(blk, x, dtype, attn_fn, use_reentrant=False,
                               early_stop=False)
            else:
                x = blk(x, dtype, attn_fn)
        return self.head(x, return_hidden)

    def embed_tokens(self, tokens, positions=None):
        """The blocks' input: token and position embeddings in
        ``cfg.dtype`` (a pipeline's first stage input)."""
        dtype = self.cfg.dtype
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
        return (self.embed[tokens].to(dtype)
                + self.pos[positions].to(dtype)[None])

    def head(self, x, return_hidden: bool = False):
        """The final norm and the tied classifier: fp32 logits, or the
        normed hidden states with ``return_hidden``."""
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


# the dim tensor parallelism shards a block's leaves on (None: replicated)
_BLOCK_SPECS = {"ln1.scale": None, "ln2.scale": None, "wq": 1, "wk": 1,
                "wv": 1, "wo": 0, "w1": 1, "w2": 0}


def param_specs(cfg: TransformerConfig) -> dict:
    """The dim tensor parallelism shards each ``state_dict`` key on, or
    None for a replicated leaf: the JAX package's ``param_specs``
    (``P(None, tp, None)`` for wq/wk/wv is dim 1, and so on)."""
    out = {"embed": None, "pos": None, "ln_f.scale": None}
    for i in range(cfg.n_layers):
        out.update({f"blocks.{i}.{k}": v for k, v in _BLOCK_SPECS.items()})
    return out


def tp_slice(x, dim, tp_rank: int, tp_size: int):
    """Rank ``tp_rank``'s slice of a dense leaf sharded on ``dim`` over
    ``tp_size`` ranks (the whole leaf where ``dim`` is None)."""
    if dim is None or tp_size == 1:
        return x
    n = x.shape[dim] // tp_size
    return x.narrow(dim, tp_rank * n, n)


def params_from_jax(params, tp_rank: int = 0, tp_size: int = 1) -> dict:
    """A ``state_dict`` for ``TransformerLM`` from the JAX package's
    parameter pytree (``transformer.init``), given as numpy arrays; with
    ``tp_size`` > 1, rank ``tp_rank``'s slices of the leaves
    ``param_specs`` shards."""
    out = {"embed": params["embed"], "pos": params["pos"],
           "ln_f.scale": params["ln_f"]["scale"]}
    for i, blk in enumerate(params["blocks"]):
        for key in ("wq", "wk", "wv", "wo", "w1", "w2"):
            out[f"blocks.{i}.{key}"] = blk[key]
        for key in ("ln1", "ln2"):
            out[f"blocks.{i}.{key}.scale"] = blk[key]["scale"]

    def dim(key):
        return (_BLOCK_SPECS[key.split(".", 2)[2]]
                if key.startswith("blocks.") else None)

    return {k: tp_slice(torch.from_numpy(np.array(v, dtype=np.float32)),
                        dim(k), tp_rank, tp_size).contiguous()
            for k, v in out.items()}
