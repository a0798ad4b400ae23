"""Small MLP and convnet for MNIST-scale examples — counterpart of
``horovod_tpu/models/mlp.py`` (the reference's
``examples/pytorch/pytorch_mnist.py`` ``Net``: two convolutions and two
dense layers).

Both take NCHW images (or, for ``MLP``, flat rows) and flatten in flax's
(h, w, c) order, so ``params_from_jax`` carries the JAX package's weights
across one to one. ``MnistConvNet``'s 5×5 convolutions pad ``"SAME"``
(flax's default), unlike the reference's ``Net``; and, as in flax, its
layers take no ``dtype`` of their own, so after the input's cast to
``dtype`` they compute in ``dtype`` promoted with the fp32 parameters.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..common.context import default_device
from ._layers import (Dense, as_state_dict, conv_kernel, dense_kernel,
                      flax_init_, nhwc_flatten)
from .resnet import Conv

MNIST_PIXELS = 28 * 28


def _flat(x):
    return nhwc_flatten(x) if x.dim() == 4 else x.reshape(x.shape[0], -1)


class MLP(nn.Module):
    """ReLU dense layers of ``features`` widths over flattened inputs of
    ``in_features``; the hidden layers in ``dtype``, the last in fp32."""

    def __init__(self, features: Sequence[int] = (128, 10),
                 in_features: int = MNIST_PIXELS,
                 dtype: torch.dtype = torch.float32, device=None,
                 seed: int = 0):
        super().__init__()
        device = (torch.device(device) if device is not None
                  else default_device())
        self.dtype = dtype
        widths = [in_features] + list(features)
        self.layers = nn.ModuleList(Dense(a, b, device)
                                    for a, b in zip(widths, widths[1:]))
        flax_init_(self, device, seed)

    def forward(self, x):
        x = _flat(x).to(self.dtype)
        for layer in self.layers[:-1]:
            x = F.relu(layer(x, self.dtype))
        return self.layers[-1](x, torch.float32)


class MnistConvNet(nn.Module):
    """The reference MNIST net's shape: conv 5×5 to 10, 2×2 max pool, ReLU;
    conv 5×5 to 20, pool, ReLU; dense 50, ReLU; dense 10 (fp32 logits)."""

    def __init__(self, image: int = 28, in_channels: int = 1,
                 dtype: torch.dtype = torch.float32, device=None,
                 seed: int = 0):
        super().__init__()
        device = (torch.device(device) if device is not None
                  else default_device())
        self.dtype = dtype
        self.conv1 = Conv(in_channels, 10, 5, 1, device, bias=True)
        self.conv2 = Conv(10, 20, 5, 1, device, bias=True)
        side = image // 2 // 2
        self.fc1 = Dense(20 * side * side, 50, device)
        self.fc2 = Dense(50, 10, device)
        flax_init_(self, device, seed)

    def forward(self, x):
        # flax's layers promote the input's dtype with their fp32 parameters
        dt = torch.promote_types(self.dtype, torch.float32)
        x = x.to(self.dtype).to(dt)
        x = F.relu(F.max_pool2d(self.conv1(x, dt), 2, 2))
        x = F.relu(F.max_pool2d(self.conv2(x, dt), 2, 2))
        x = F.relu(self.fc1(nhwc_flatten(x), dt))
        return self.fc2(x, torch.float32)


def mlp_params_from_jax(params) -> dict:
    """A ``state_dict`` for ``MLP`` from the JAX model's ``params``."""
    n = sum(k.startswith("Dense_") for k in params)
    out = {}
    for i in range(n):
        out[f"layers.{i}.weight"] = dense_kernel(params[f"Dense_{i}"][
            "kernel"])
        out[f"layers.{i}.bias"] = params[f"Dense_{i}"]["bias"]
    return as_state_dict(out)


def params_from_jax(params) -> dict:
    """A ``state_dict`` for ``MnistConvNet`` from the JAX model's
    ``params`` (numpy arrays)."""
    out = {}
    for ours, theirs in (("conv1", "Conv_0"), ("conv2", "Conv_1")):
        out[f"{ours}.weight"] = conv_kernel(params[theirs]["kernel"])
        out[f"{ours}.bias"] = params[theirs]["bias"]
    for ours, theirs in (("fc1", "Dense_0"), ("fc2", "Dense_1")):
        out[f"{ours}.weight"] = dense_kernel(params[theirs]["kernel"])
        out[f"{ours}.bias"] = params[theirs]["bias"]
    return as_state_dict(out)
