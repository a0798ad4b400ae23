"""Vision Transformer — counterpart of ``horovod_tpu/models/vit.py``.

The JAX package's flax model in PyTorch, layer for layer:

- patchify as a stride-``p`` ``p``×``p`` convolution with bias, its tokens
  in row-major (h, w) order, a zero-initialized class token in front and a
  learned position embedding added, all in ``dtype``;
- pre-LN encoder blocks: flax's ``LayerNorm`` (epsilon 1e-6, statistics
  and normalization in fp32, the result in ``dtype``), flax's
  ``MultiHeadDotProductAttention`` as plain products and a softmax as
  flax computes it (the query divided by √head_dim rounded to ``dtype``,
  the softmax taken in ``dtype``), the residual add, the MLP block
  (dense, tanh-approximate GELU — flax's ``nn.gelu`` — dense);
- the final LayerNorm, then an fp32 head on the class token.

The attention is flax's, not the Pallas kernel's: this model has no
kernel of its own. ``qkv`` holds flax's ``query``, ``key`` and ``value``
kernels ([d, heads, head_dim] each) as one [3·d, d] weight; ``out`` holds
``out``'s [heads, head_dim, d] kernel as [d, d].
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..common.context import default_device
from ._layers import (Dense, as_state_dict, conv_kernel, dense_kernel,
                      flax_init_)
from .resnet import IN_CHANNELS, Conv

LN_EPSILON = 1e-6  # flax's LayerNorm default
IMAGE = 224        # the published input side


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm(dtype=dtype)``: fp32 statistics and
    normalization, the result in ``dtype``."""

    def __init__(self, d: int, device):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d, device=device))
        self.bias = nn.Parameter(torch.zeros(d, device=device))

    def forward(self, x, dtype):
        return F.layer_norm(x.float(), self.weight.shape, self.weight,
                            self.bias, LN_EPSILON).to(dtype)


class EncoderBlock(nn.Module):
    def __init__(self, d: int, n_heads: int, mlp_dim: int, device):
        super().__init__()
        self.n_heads = n_heads
        self.ln1 = LayerNorm(d, device)
        self.qkv = Dense(d, 3 * d, device)
        self.out = Dense(d, d, device)
        self.ln2 = LayerNorm(d, device)
        self.fc1 = Dense(d, mlp_dim, device)
        self.fc2 = Dense(mlp_dim, d, device)

    def attention(self, y, dtype):
        b, n, d = y.shape
        h = self.n_heads
        hd = d // h
        q, k, v = self.qkv(y, dtype).view(b, n, 3, h, hd).permute(
            2, 0, 3, 1, 4)                                # [b, h, n, hd]
        q = q / torch.tensor(math.sqrt(hd)).to(dtype)
        p = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        o = (p @ v).transpose(1, 2).reshape(b, n, d)
        return self.out(o, dtype)

    def forward(self, x, dtype):
        x = x + self.attention(self.ln1(x, dtype), dtype)
        y = F.gelu(self.fc1(self.ln2(x, dtype), dtype), approximate="tanh")
        return x + self.fc2(y, dtype)


class ViT(nn.Module):
    """ViT classifier over square NCHW images of side ``image`` (default
    ``IMAGE``; it fixes the position embedding's length), random
    weights drawn from ``seed`` on ``device`` (flax's init: lecun-normal
    kernels, zero biases and class token, position embedding normal with
    standard deviation 0.02, LayerNorm scale 1). ``device=None`` is
    ``hvd.device()``, or ``cuda:<local_rank>`` before ``hvd.init()``;
    without CUDA it raises unless ``device="cpu"`` (or ``"meta"``)."""

    def __init__(self, num_classes: int = 1000, patch_size: int = 16,
                 d_model: int = 768, n_layers: int = 12, n_heads: int = 12,
                 mlp_dim: int = 3072, image: int = None,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 seed: int = 0):
        super().__init__()
        device = (torch.device(device) if device is not None
                  else default_device())
        self.dtype, self.d_model = dtype, d_model
        self.image = image or IMAGE
        p = patch_size
        self.embedding = Conv(IN_CHANNELS, d_model, p, p, device, bias=True)
        tokens = (self.image // p) ** 2 + 1
        self.cls = nn.Parameter(torch.zeros(1, 1, d_model, device=device))
        self.pos_embedding = nn.Parameter(torch.empty(1, tokens, d_model,
                                                      device=device))
        self.blocks = nn.ModuleList(EncoderBlock(d_model, n_heads, mlp_dim,
                                                 device)
                                    for _ in range(n_layers))
        self.norm = LayerNorm(d_model, device)
        self.head = Dense(d_model, num_classes, device)
        gen = flax_init_(self, device, seed)
        if gen is not None:  # the meta device draws nothing
            with torch.no_grad():
                self.pos_embedding.normal_(0.0, 0.02, generator=gen)

    def forward(self, images):
        """Images [n, 3, h, w] → fp32 logits [n, num_classes]."""
        dtype = self.dtype
        b = images.shape[0]
        x = self.embedding(images.to(dtype), dtype)          # [b, d, h, w]
        x = x.permute(0, 2, 3, 1).reshape(b, -1, self.d_model)  # [b, hw, d]
        cls = self.cls.to(dtype).expand(b, 1, self.d_model)
        x = torch.cat([cls, x], 1) + self.pos_embedding.to(dtype)
        for blk in self.blocks:
            x = blk(x, dtype)
        x = self.norm(x, dtype)
        return self.head(x[:, 0], torch.float32)


def ViT_S16(**kw) -> ViT:
    return ViT(patch_size=16, d_model=384, n_layers=12, n_heads=6,
               mlp_dim=1536, **kw)


def ViT_B16(**kw) -> ViT:
    return ViT(patch_size=16, d_model=768, n_layers=12, n_heads=12,
               mlp_dim=3072, **kw)


def ViT_L16(**kw) -> ViT:
    return ViT(patch_size=16, d_model=1024, n_layers=24, n_heads=16,
               mlp_dim=4096, **kw)


def params_from_jax(params) -> dict:
    """A ``state_dict`` for ``ViT`` from the JAX model's ``params`` (numpy
    arrays)."""
    out = {"embedding.weight": conv_kernel(params["embedding"]["kernel"]),
           "embedding.bias": params["embedding"]["bias"],
           "cls": params["cls"], "pos_embedding": params["pos_embedding"]}

    def norm(prefix, p):
        out[f"{prefix}.weight"] = p["scale"]
        out[f"{prefix}.bias"] = p["bias"]

    def dense(prefix, p):
        out[f"{prefix}.weight"] = dense_kernel(p["kernel"])
        out[f"{prefix}.bias"] = p["bias"]

    n = sum(k.startswith("block_") for k in params)
    for i in range(n):
        p, pre = params[f"block_{i}"], f"blocks.{i}"
        norm(f"{pre}.ln1", p["LayerNorm_0"])
        norm(f"{pre}.ln2", p["LayerNorm_1"])
        att = p["MultiHeadDotProductAttention_0"]
        d = att["query"]["kernel"].shape[0]
        out[f"{pre}.qkv.weight"] = np.concatenate(
            [np.reshape(att[k]["kernel"], (d, -1)).T
             for k in ("query", "key", "value")])
        out[f"{pre}.qkv.bias"] = np.concatenate(
            [np.reshape(att[k]["bias"], -1) for k in ("query", "key",
                                                      "value")])
        out[f"{pre}.out.weight"] = np.reshape(att["out"]["kernel"],
                                              (-1, d)).T
        out[f"{pre}.out.bias"] = att["out"]["bias"]
        dense(f"{pre}.fc1", p["MlpBlock_0"]["Dense_0"])
        dense(f"{pre}.fc2", p["MlpBlock_0"]["Dense_1"])
    norm("norm", params["LayerNorm_0"])
    dense("head", params["head"])
    return as_state_dict(out)
