"""VGG (Simonyan & Zisserman) — counterpart of
``horovod_tpu/models/vgg.py``, the reference's third headline benchmark
model and its communication-heavy one: VGG-16 holds 138,357,544
parameters, 553 MB of fp32 gradients a step, 411 MB of them in ``fc6``.

The JAX package's flax model in PyTorch, layer for layer:

- parameters are fp32; the input is cast to ``dtype`` and each layer casts
  its weight and bias to ``dtype`` at call time; the last dense layer runs
  in fp32 and returns fp32 logits;
- NCHW images in, ``torch.channels_last`` activations; 3×3 ``"SAME"``
  convolutions with bias, ReLU after each, 2×2 max pooling after each
  stage;
- the flatten before ``fc6`` is in (h, w, c) order (flax's NHWC
  reshape), so ``fc6``'s rows line up with the converted kernel;
- dropout (0.5) after ``fc6`` and ``fc7`` in training, its masks drawn
  from a ``torch.Generator`` (``generator``; the model's own, seeded from
  ``seed``, unless the caller gives one), not from flax's RNG streams.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..common.context import default_device
from ._layers import (Dense, as_state_dict, conv_kernel, dense_kernel,
                      dropout, dropout_generator, flax_init_, nhwc_flatten)
from .resnet import IN_CHANNELS, Conv

# conv plan: (convs per stage, channels)
VGG16_STAGES: Sequence[tuple[int, int]] = (
    (2, 64), (2, 128), (3, 256), (3, 512), (3, 512))
VGG19_STAGES: Sequence[tuple[int, int]] = (
    (2, 64), (2, 128), (4, 256), (4, 512), (4, 512))
WIDTH = 4096  # the classifier's two hidden layers
IMAGE = 224   # the published input side

# forward FLOPs of an image at 224² (2 x 15.5e9 MACs: convolutions about
# 15.3e9, the classifier 0.12e9), the JAX package's figure
VGG16_FWD_FLOP_PER_IMG = 2 * 15.5e9


class VGG(nn.Module):
    """VGG over ``stages`` with random weights drawn from ``seed`` on
    ``device`` (flax's init: lecun-normal kernels, zero biases).
    ``device=None`` is ``hvd.device()``, or ``cuda:<local_rank>`` before
    ``hvd.init()``; without CUDA it raises unless ``device="cpu"`` (or
    ``"meta"``, for the shapes alone). ``image`` is the input's side
    (default ``IMAGE``), which fixes ``fc6``'s width."""

    def __init__(self, stages: Sequence[tuple[int, int]],
                 num_classes: int = 1000, dtype: torch.dtype = torch.bfloat16,
                 dropout_rate: float = 0.5, image: int = None, device=None,
                 seed: int = 0, generator: torch.Generator = None):
        super().__init__()
        device = (torch.device(device) if device is not None
                  else default_device())
        self.dtype, self.dropout_rate = dtype, dropout_rate
        self.image = image or IMAGE
        convs, cin, side = [], IN_CHANNELS, self.image
        self.stage_sizes = [n for n, _ in stages]
        for n, ch in stages:
            for _ in range(n):
                convs.append(Conv(cin, ch, 3, 1, device, bias=True))
                cin = ch
            side //= 2
        self.convs = nn.ModuleList(convs)
        self.fc6 = Dense(cin * side * side, WIDTH, device)
        self.fc7 = Dense(WIDTH, WIDTH, device)
        self.fc8 = Dense(WIDTH, num_classes, device)
        flax_init_(self, device, seed)
        self.generator = dropout_generator(generator, device, seed)

    def forward(self, x):
        """Images [n, 3, h, w] → fp32 logits [n, num_classes]."""
        dtype = self.dtype
        x = x.to(dtype=dtype, memory_format=torch.channels_last)
        convs = iter(self.convs)
        for n in self.stage_sizes:
            for _ in range(n):
                x = F.relu(next(convs)(x, dtype))
            x = F.max_pool2d(x, 2, 2)
        x = nhwc_flatten(x)
        for fc in (self.fc6, self.fc7):
            x = dropout(F.relu(fc(x, dtype)), self.dropout_rate,
                        self.generator, self.training)
        return self.fc8(x, torch.float32)


def VGG16(**kw) -> VGG:
    return VGG(stages=VGG16_STAGES, **kw)


def VGG19(**kw) -> VGG:
    return VGG(stages=VGG19_STAGES, **kw)


def params_from_jax(params) -> dict:
    """A ``state_dict`` for ``VGG`` from the JAX model's ``params`` (numpy
    arrays): ``Conv_i`` → ``convs.i`` (HWIO → OIHW), ``Dense_0..2`` →
    ``fc6``, ``fc7``, ``fc8`` ((in, out) → (out, in))."""
    out = {}
    n = sum(k.startswith("Conv_") for k in params)
    for i in range(n):
        out[f"convs.{i}.weight"] = conv_kernel(params[f"Conv_{i}"]["kernel"])
        out[f"convs.{i}.bias"] = params[f"Conv_{i}"]["bias"]
    for i, fc in enumerate(("fc6", "fc7", "fc8")):
        out[f"{fc}.weight"] = dense_kernel(params[f"Dense_{i}"]["kernel"])
        out[f"{fc}.bias"] = params[f"Dense_{i}"]["bias"]
    return as_state_dict(out)
