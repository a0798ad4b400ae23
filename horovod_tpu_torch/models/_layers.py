"""What the port's models share besides ``resnet.py``'s ``Conv`` and
``BatchNorm``: flax's default init, ``Dense`` and ``Dropout`` over torch
tensors, the NHWC flatten, and the conversion of flax variables."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F


def lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator):
    """flax's default kernel init: a normal truncated at two standard
    deviations, widened so that its variance is 1/fan_in. Drawn by
    rejection: a standard normal, its draws beyond ±2 drawn again."""
    w.normal_(generator=gen)
    while True:
        out = w.abs() > 2.0
        n = int(out.sum())
        if not n:
            break
        w[out] = torch.randn(n, generator=gen, device=w.device)
    w.mul_(math.sqrt(1.0 / fan_in) / 0.87962566103423978)


def flax_init_(model: nn.Module, device, seed: int):
    """Every layer of ``model`` that has an ``init_`` (``Conv``,
    ``Dense``) drawn in module order from a generator on ``device`` seeded
    with ``seed``, which is returned for the model's other draws; on the
    meta device (shapes only) nothing is drawn and None is returned."""
    if device.type == "meta":
        return None
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if hasattr(m, "init_"):
                m.init_(gen)
    return gen


class Dense(nn.Module):
    """flax's ``nn.Dense``: ``weight`` (out, in), ``bias`` (out); the input,
    the weight and the bias are cast to ``dtype`` at call time, so the
    product and the bias add run in it."""

    def __init__(self, cin: int, cout: int, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, device=device))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))

    def init_(self, gen: torch.Generator):
        """flax's default: lecun-normal kernel, zero bias."""
        lecun_normal_(self.weight, self.weight.shape[1], gen)
        self.bias.zero_()

    def forward(self, x, dtype):
        return F.linear(x.to(dtype), self.weight.to(dtype),
                        self.bias.to(dtype))


def dropout(x, rate: float, generator, training: bool):
    """flax's ``nn.Dropout``: keep each element with probability
    ``1 - rate``, drawn from ``generator`` (a ``torch.Generator`` on
    ``x``'s device), and divide the kept ones by it."""
    if not training or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def dropout_generator(generator, device, seed: int):
    """The generator a model's dropout draws from: the caller's, so that
    two runs given generators in the same state draw the same masks, else
    the model's own on ``device`` seeded with ``seed + 1`` (none on the
    meta device)."""
    if generator is not None or device.type == "meta":
        return generator
    return torch.Generator(device=device).manual_seed(seed + 1)


def nhwc_flatten(x):
    """Flatten [n, c, h, w] activations in (h, w, c) order, as flax's
    ``x.reshape((n, -1))`` flattens NHWC: the order the converted dense
    kernels' rows are in."""
    return x.permute(0, 2, 3, 1).flatten(1)


def conv_kernel(k) -> np.ndarray:
    """A flax conv kernel HWIO as torch's OIHW."""
    return np.transpose(k, (3, 2, 0, 1))


def dense_kernel(k) -> np.ndarray:
    """A flax dense kernel (in, out) as torch's (out, in)."""
    return np.transpose(k)


def batch_norm_params(out: dict, prefix: str, p, s):
    """flax's BatchNorm ``scale``, ``bias`` and batch statistics ``mean``,
    ``var`` as ``BatchNorm``'s weight, bias and running buffers."""
    out[f"{prefix}.weight"] = p["scale"]
    out[f"{prefix}.bias"] = p["bias"]
    out[f"{prefix}.running_mean"] = s["mean"]
    out[f"{prefix}.running_var"] = s["var"]


def as_state_dict(out: dict) -> dict:
    """numpy arrays (or anything ``np.array`` takes) as fp32 tensors."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in out.items()}
