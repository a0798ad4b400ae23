"""Inception V3 (Szegedy et al., arXiv:1512.00567) — counterpart of
``horovod_tpu/models/inception.py``, the reference's first headline
benchmark model. The auxiliary classifier is left out, as there.

The JAX package's flax model in PyTorch, layer for layer:

- ``ConvBN``: a bias-free convolution in ``dtype``, flax's BatchNorm
  (``models/resnet.py``'s ``BatchNorm`` with epsilon 1e-3, momentum 0.9:
  fp32 statistics, the biased variance in the running update), ReLU, the
  result in ``dtype``;
- ``"SAME"`` padding is TF's rule per axis (the 1×7 and 7×1 convolutions
  pad one axis only); the stride-2 reductions are ``"VALID"``;
- the branches' 3×3 average pools pad ``"SAME"`` and count the padded
  zeros (flax's ``count_include_pad=True``);
- branches concatenate on the channel axis (flax's last axis, dim 1 here);
- the spatial mean is taken in ``dtype``, then dropout (0.2, masks from a
  ``torch.Generator``, as ``models/vgg.py``), then an fp32 dense head.

Each block keeps its ``ConvBN`` layers in ``convs`` in flax's call order
(``ConvBN_0``, ``ConvBN_1``, … across the branches), which is how
``params_from_jax`` finds them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..common.context import default_device
from ._layers import (Dense, as_state_dict, batch_norm_params, conv_kernel,
                      dense_kernel, dropout, dropout_generator, flax_init_)
from .resnet import IN_CHANNELS, BatchNorm, Conv

BN_EPSILON = 1e-3
IMAGE = 299  # the published input side
VALID = ((0, 0), (0, 0))

# forward FLOPs of an image at 299² (2 x 5.7e9 MACs), the JAX package's
INCEPTION3_FWD_FLOP_PER_IMG = 2 * 5.7e9


class ConvBN(nn.Module):
    def __init__(self, cin: int, ch: int, kernel=(3, 3), strides=(1, 1),
                 padding: str = "SAME", device=None):
        super().__init__()
        self.conv = Conv(cin, ch, kernel, strides, device,
                         pads=VALID if padding == "VALID" else None)
        self.bn = BatchNorm(ch, device, eps=BN_EPSILON)

    def forward(self, x, dtype):
        return F.relu(self.bn(self.conv(x, dtype)))


class _Block(nn.Module):
    """A block's ``ConvBN`` layers, added branch by branch in call order."""

    def __init__(self, device):
        super().__init__()
        self.convs = nn.ModuleList()
        self._device = device

    def _branch(self, cin: int, specs) -> tuple:
        """Adds a branch's layers; returns their slice and its width."""
        start = len(self.convs)
        for ch, kernel, strides, padding in specs:
            self.convs.append(ConvBN(cin, ch, kernel, strides, padding,
                                     self._device))
            cin = ch
        return slice(start, len(self.convs)), cin

    def _run(self, x, part: slice, dtype):
        for layer in self.convs[part]:
            x = layer(x, dtype)
        return x


def _avg_pool(x):
    """flax's ``avg_pool(x, (3, 3), (1, 1), "SAME")``: the padded zeros
    count."""
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=True)


def _max_pool(x):
    return F.max_pool2d(x, 3, 2)


def _s(ch, k=(1, 1), s=(1, 1), p="SAME"):
    return ch, k, s, p


class InceptionA(_Block):
    def __init__(self, cin: int, pool_ch: int, device):
        super().__init__(device)
        self.b1, c1 = self._branch(cin, [_s(64)])
        self.b2, c2 = self._branch(cin, [_s(48), _s(64, (5, 5))])
        self.b3, c3 = self._branch(cin, [_s(64), _s(96, (3, 3)),
                                         _s(96, (3, 3))])
        self.b4, c4 = self._branch(cin, [_s(pool_ch)])
        self.cout = c1 + c2 + c3 + c4

    def forward(self, x, dtype):
        return torch.cat([self._run(x, self.b1, dtype),
                          self._run(x, self.b2, dtype),
                          self._run(x, self.b3, dtype),
                          self._run(_avg_pool(x), self.b4, dtype)], 1)


class ReductionA(_Block):
    def __init__(self, cin: int, device):
        super().__init__(device)
        self.b1, c1 = self._branch(cin, [_s(384, (3, 3), (2, 2), "VALID")])
        self.b2, c2 = self._branch(cin, [_s(64), _s(96, (3, 3)),
                                         _s(96, (3, 3), (2, 2), "VALID")])
        self.cout = c1 + c2 + cin

    def forward(self, x, dtype):
        return torch.cat([self._run(x, self.b1, dtype),
                          self._run(x, self.b2, dtype), _max_pool(x)], 1)


class InceptionB(_Block):
    def __init__(self, cin: int, c7: int, device):
        super().__init__(device)
        self.b1, _ = self._branch(cin, [_s(192)])
        self.b2, _ = self._branch(cin, [_s(c7), _s(c7, (1, 7)),
                                        _s(192, (7, 1))])
        self.b3, _ = self._branch(cin, [_s(c7), _s(c7, (7, 1)),
                                        _s(c7, (1, 7)), _s(c7, (7, 1)),
                                        _s(192, (1, 7))])
        self.b4, _ = self._branch(cin, [_s(192)])
        self.cout = 4 * 192

    def forward(self, x, dtype):
        return torch.cat([self._run(x, self.b1, dtype),
                          self._run(x, self.b2, dtype),
                          self._run(x, self.b3, dtype),
                          self._run(_avg_pool(x), self.b4, dtype)], 1)


class ReductionB(_Block):
    def __init__(self, cin: int, device):
        super().__init__(device)
        self.b1, c1 = self._branch(cin, [_s(192),
                                         _s(320, (3, 3), (2, 2), "VALID")])
        self.b2, c2 = self._branch(cin, [_s(192), _s(192, (1, 7)),
                                         _s(192, (7, 1)),
                                         _s(192, (3, 3), (2, 2), "VALID")])
        self.cout = c1 + c2 + cin

    def forward(self, x, dtype):
        return torch.cat([self._run(x, self.b1, dtype),
                          self._run(x, self.b2, dtype), _max_pool(x)], 1)


class InceptionC(_Block):
    def __init__(self, cin: int, device):
        super().__init__(device)
        self.b1, _ = self._branch(cin, [_s(320)])
        self.b2, c2 = self._branch(cin, [_s(384)])
        self.b2a, _ = self._branch(c2, [_s(384, (1, 3))])
        self.b2b, _ = self._branch(c2, [_s(384, (3, 1))])
        self.b3, c3 = self._branch(cin, [_s(448), _s(384, (3, 3))])
        self.b3a, _ = self._branch(c3, [_s(384, (1, 3))])
        self.b3b, _ = self._branch(c3, [_s(384, (3, 1))])
        self.b4, _ = self._branch(cin, [_s(192)])
        self.cout = 320 + 2 * 384 + 2 * 384 + 192

    def forward(self, x, dtype):
        b2 = self._run(x, self.b2, dtype)
        b3 = self._run(x, self.b3, dtype)
        return torch.cat([self._run(x, self.b1, dtype),
                          self._run(b2, self.b2a, dtype),
                          self._run(b2, self.b2b, dtype),
                          self._run(b3, self.b3a, dtype),
                          self._run(b3, self.b3b, dtype),
                          self._run(_avg_pool(x), self.b4, dtype)], 1)


class InceptionV3(nn.Module):
    """Inception V3 with random weights drawn from ``seed`` on ``device``
    (lecun-normal kernels, BN scale 1 and bias 0, zero dense bias).
    ``device=None`` is ``hvd.device()``, or ``cuda:<local_rank>`` before
    ``hvd.init()``; without CUDA it raises unless ``device="cpu"`` (or
    ``"meta"``). ``generator`` draws the dropout masks (default: the
    model's own, seeded from ``seed``). ``image`` is the input's side
    (default ``IMAGE``), kept as ``self.image``: the spatial mean takes
    any from 75 up."""

    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16,
                 dropout_rate: float = 0.2, device=None, seed: int = 0,
                 generator: torch.Generator = None, image: int = None):
        super().__init__()
        device = (torch.device(device) if device is not None
                  else default_device())
        self.dtype, self.dropout_rate = dtype, dropout_rate
        self.image = image or IMAGE
        self.stem = nn.ModuleList([
            ConvBN(IN_CHANNELS, 32, (3, 3), (2, 2), "VALID", device),
            ConvBN(32, 32, (3, 3), (1, 1), "VALID", device),
            ConvBN(32, 64, (3, 3), (1, 1), "SAME", device),
            ConvBN(64, 80, (1, 1), (1, 1), "VALID", device),
            ConvBN(80, 192, (3, 3), (1, 1), "VALID", device)])
        blocks, cin = [], 192
        for make in ([lambda c, p=p: InceptionA(c, p, device)
                      for p in (32, 64, 64)]
                     + [lambda c: ReductionA(c, device)]
                     + [lambda c, c7=c7: InceptionB(c, c7, device)
                        for c7 in (128, 160, 160, 192)]
                     + [lambda c: ReductionB(c, device)]
                     + [lambda c: InceptionC(c, device)] * 2):
            blocks.append(make(cin))
            cin = blocks[-1].cout
        self.blocks = nn.ModuleList(blocks)
        self.head = Dense(cin, num_classes, device)
        flax_init_(self, device, seed)
        self.generator = dropout_generator(generator, device, seed)

    def forward(self, x):
        """Images [n, 3, h, w] → fp32 logits [n, num_classes]."""
        dtype = self.dtype
        x = x.to(dtype=dtype, memory_format=torch.channels_last)
        for i, layer in enumerate(self.stem):
            x = layer(x, dtype)
            if i in (2, 4):  # 299² → 35² × 192
                x = _max_pool(x)
        for blk in self.blocks:
            x = blk(x, dtype)
        x = x.mean((2, 3))
        x = dropout(x, self.dropout_rate, self.generator, self.training)
        return self.head(x, torch.float32)


# flax's names of the top-level blocks, in order
_BLOCK_NAMES = (["InceptionA_0", "InceptionA_1", "InceptionA_2",
                 "ReductionA_0"]
                + [f"InceptionB_{i}" for i in range(4)]
                + ["ReductionB_0", "InceptionC_0", "InceptionC_1"])


def block_params_from_jax(params, batch_stats) -> dict:
    """A ``state_dict`` for one block (or the stem's scope) from its flax
    scope's ``params`` and ``batch_stats``: each ``ConvBN_i`` → ``convs.i``
    (``Conv_0``'s kernel HWIO → OIHW; ``BatchNorm_0``'s scale, bias, mean
    and var → weight, bias and the running buffers)."""
    out = {}
    n = sum(k.startswith("ConvBN_") for k in params)
    for i in range(n):
        p, s = params[f"ConvBN_{i}"], batch_stats[f"ConvBN_{i}"]
        out[f"convs.{i}.conv.weight"] = conv_kernel(p["Conv_0"]["kernel"])
        batch_norm_params(out, f"convs.{i}.bn", p["BatchNorm_0"],
                          s["BatchNorm_0"])
    return as_state_dict(out)


def params_from_jax(params, batch_stats) -> dict:
    """A ``state_dict`` for ``InceptionV3`` from the JAX model's
    ``variables["params"]`` and ``variables["batch_stats"]`` (numpy
    arrays): the stem's ``ConvBN_i`` → ``stem.i`` and each block's
    through ``block_params_from_jax``; ``Dense_0`` → ``head``."""
    out = {k.replace("convs.", "stem.", 1): v for k, v in
           block_params_from_jax(params, batch_stats).items()}
    for i, name in enumerate(_BLOCK_NAMES):
        out.update({f"blocks.{i}.{k}": v for k, v in block_params_from_jax(
            params[name], batch_stats[name]).items()})
    out.update(as_state_dict({
        "head.weight": dense_kernel(params["Dense_0"]["kernel"]),
        "head.bias": params["Dense_0"]["bias"]}))
    return out
