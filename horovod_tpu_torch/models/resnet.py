"""ResNet v1.5 family — counterpart of ``horovod_tpu/models/resnet.py``.

The reference benchmarks Horovod with ResNet-50/101 synthetic throughput
(``examples/pytorch_synthetic_benchmark.py``). This is the JAX package's
flax model in PyTorch, layer for layer, so its parameters convert one to
one (``params_from_jax``):

- parameters are fp32; the input is cast to ``dtype`` at the stem and each
  convolution casts its weight to ``dtype`` at call time; the spatial mean
  is taken in fp32 and rounded to ``dtype``; the head runs in fp32 and
  returns fp32 logits;
- the API takes NCHW images; the input and every activation are
  ``torch.channels_last`` (NHWC in memory, the layout cuDNN's tensor-core
  convolutions read). The parameters stay contiguous, so their gradients
  are too and the runtime packs them without a copy;
- padding follows flax: ``"SAME"`` is TF's rule (``_same_pads``), which on
  an even input pads a 3×3 stride-2 convolution (0, 1), not (1, 1);
- BatchNorm follows flax (``BatchNorm``): per GPU, statistics in fp32,
  the biased batch variance both for normalizing and for the running
  update ``0.9·running + 0.1·batch``.

``sync_bn_group`` (a ``torch.distributed`` group, say
``hvd.global_process_set().group``) is flax's ``axis_name``
(``horovod_tpu/models/resnet.py:129``, :148-150): every ``BatchNorm`` then
takes the batch mean and the mean of squares in fp32, averages the two
over the group with one ``dist.all_reduce`` on the caller's thread
(``_GroupMean``, differentiable: its backward averages the cotangent the
same way), and normalizes with ``max(0, E[x^2] - E[x]^2)``, flax's
``_compute_stats`` and ``_normalize``, op for op; the running update is
flax's with those statistics. Without a group the path is unchanged.

Left out: the TPU-only ``space_to_depth`` stem and ``conv_impl``
(``Im2ColConv``). The convolutions are ``F.conv2d`` (cuDNN) and the
normalization torch's batch-norm kernel, as XLA ran both outside any
Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..common.context import default_device

MOMENTUM = 0.9    # flax's decay of the running statistics (resnet.py:146)
EPSILON = 1e-5
IN_CHANNELS = 3   # RGB images


def _same_pads(size: int, k: int, s: int) -> tuple:
    """TF-'SAME' padding for one spatial dim."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator):
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


class Conv(nn.Module):
    """A bias-free k×k convolution, flax's ``nn.Conv`` with ``"SAME"``
    padding unless ``pads`` ((top, bottom), (left, right)) are given."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, device,
                 pads=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k,
                                               device=device))
        self.k, self.stride, self.pads = k, stride, pads

    def forward(self, x, dtype):
        ph, pw = self.pads or (_same_pads(x.shape[2], self.k, self.stride),
                               _same_pads(x.shape[3], self.k, self.stride))
        if ph[0] == ph[1] and pw[0] == pw[1]:
            padding = (ph[0], pw[0])
        else:  # cuDNN pads both sides alike: pad first, then none
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            padding = 0
        w = self.weight.to(dtype=dtype, memory_format=torch.channels_last)
        return F.conv2d(x, w, stride=self.stride, padding=padding)


class _GroupMean(torch.autograd.Function):
    """The mean of ``t`` over the ranks of ``group`` (flax's ``lax.pmean``):
    one ``all_reduce`` of the sum, divided by the group's size. Its
    backward is the same mean of the cotangent, pmean's transpose."""

    @staticmethod
    def _mean(t, group):
        out = t.clone()
        dist.all_reduce(out, dist.ReduceOp.SUM, group=group)
        return out.div_(dist.get_world_size(group))

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _GroupMean._mean(t.contiguous(), group)

    @staticmethod
    def backward(ctx, dy):
        return _GroupMean._mean(dy.contiguous(), ctx.group), None


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW.

    Training normalizes with the batch's biased variance and updates the
    running statistics as ``0.9·running + 0.1·batch`` with it: not
    ``nn.BatchNorm2d``'s unbiased variance. The batch's statistics are the
    ones torch's batch-norm kernel computes for the normalization, in fp32
    for half inputs as flax takes them: its mean, and its
    ``1/sqrt(var + eps)``, from which the variance comes back to within
    fp32 rounding of ``var + eps`` (a second pass over the activations
    for them cost a third of a ResNet-50 step's device time on an H100).
    Eval normalizes with the running statistics. The output keeps the
    input's dtype. No ``num_batches_tracked``: flax has none. With
    ``group`` the statistics are the group's (``_synced``)."""

    def __init__(self, c: int, device, zero_scale: bool = False,
                 group=None):
        super().__init__()
        self.group = group
        init = torch.zeros if zero_scale else torch.ones
        self.weight = nn.Parameter(init(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer("running_mean", torch.zeros(c, device=device))
        self.register_buffer("running_var", torch.ones(c, device=device))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, EPSILON)
        if self.group is not None:
            return self._synced(x)
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, EPSILON)
        with torch.no_grad():
            var = (invstd.pow(-2) - EPSILON).clamp_min(0.0)
            self.running_mean.copy_(MOMENTUM * self.running_mean
                                    + (1.0 - MOMENTUM) * mean)
            self.running_var.copy_(MOMENTUM * self.running_var
                                   + (1.0 - MOMENTUM) * var)
        return y

    def _synced(self, x):
        """flax's ``BatchNorm`` with ``axis_name``: the statistics of the
        group's whole batch, in fp32."""
        xf = x.float()
        moments = torch.stack([xf.mean((0, 2, 3)),
                               (xf * xf).mean((0, 2, 3))])
        mean, meansq = _GroupMean.apply(moments, self.group).unbind(0)
        var = (meansq - mean * mean).clamp_min(0.0)
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(var + EPSILON) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        with torch.no_grad():
            self.running_mean.copy_(MOMENTUM * self.running_mean
                                    + (1.0 - MOMENTUM) * mean)
            self.running_var.copy_(MOMENTUM * self.running_var
                                   + (1.0 - MOMENTUM) * var)
        return y.to(x.dtype)


class BottleneckBlock(nn.Module):
    """1×1, 3×3 (stride ``stride``), 1×1 to ``4·filters``, a norm after
    each, the last one's scale zero at init; ``conv_proj`` and
    ``norm_proj`` on the residual where the shapes differ."""

    def __init__(self, cin: int, filters: int, stride: int, device,
                 group=None):
        super().__init__()
        cout = 4 * filters
        self.conv1 = Conv(cin, filters, 1, 1, device)
        self.bn1 = BatchNorm(filters, device, group=group)
        self.conv2 = Conv(filters, filters, 3, stride, device)
        self.bn2 = BatchNorm(filters, device, group=group)
        self.conv3 = Conv(filters, cout, 1, 1, device)
        self.bn3 = BatchNorm(cout, device, zero_scale=True, group=group)
        self.proj = cin != cout or stride != 1
        if self.proj:
            self.conv_proj = Conv(cin, cout, 1, stride, device)
            self.norm_proj = BatchNorm(cout, device, group=group)

    def forward(self, x, dtype):
        y = F.relu(self.bn1(self.conv1(x, dtype)))
        y = F.relu(self.bn2(self.conv2(y, dtype)))
        y = self.bn3(self.conv3(y, dtype))
        residual = self.norm_proj(self.conv_proj(x, dtype)) if self.proj \
            else x
        return F.relu(residual + y)


class ResNet(nn.Module):
    """ResNet v1.5 with random weights drawn from ``seed`` on ``device``
    (lecun-normal kernels, zero biases, BN scale 1 and bias 0 but the
    zero scale above). ``device=None`` is ``hvd.device()``, or
    ``cuda:<local_rank>`` before ``hvd.init()``; without CUDA it raises
    unless ``device="cpu"`` (or ``"meta"``, for the shapes alone).
    ``train()``/``eval()`` is flax's ``train``; ``sync_bn_group`` is flax's
    ``axis_name`` (the module docstring)."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 num_filters: int = 64, dtype: torch.dtype = torch.bfloat16,
                 device=None, seed: int = 0, sync_bn_group=None):
        super().__init__()
        device = (torch.device(device) if device is not None
                  else default_device())
        self.dtype = dtype
        self.conv_init = Conv(IN_CHANNELS, num_filters, 7, 2, device,
                              pads=((3, 3), (3, 3)))
        self.bn_init = BatchNorm(num_filters, device, group=sync_bn_group)
        blocks, cin = [], num_filters
        for i, block_count in enumerate(stage_sizes):
            for j in range(block_count):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(BottleneckBlock(cin, num_filters * 2 ** i,
                                              stride, device, sync_bn_group))
                cin = 4 * num_filters * 2 ** i
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes, device=device)
        if device.type == "meta":  # shapes only: no values to draw
            return
        gen = torch.Generator(device=device).manual_seed(seed)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, Conv):
                    _lecun_normal_(m.weight, m.weight[0].numel(), gen)
            _lecun_normal_(self.head.weight, cin, gen)
            self.head.bias.zero_()

    def forward(self, x):
        """Images [n, 3, h, w] → fp32 logits [n, num_classes]."""
        dtype = self.dtype
        x = x.to(dtype=dtype, memory_format=torch.channels_last)
        x = F.relu(self.bn_init(self.conv_init(x, dtype)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for blk in self.blocks:
            x = blk(x, dtype)
        x = x.mean((2, 3), dtype=torch.float32).to(dtype)
        return F.linear(x.float(), self.head.weight, self.head.bias)


def ResNet50(**kw) -> ResNet:
    return ResNet(stage_sizes=[3, 4, 6, 3], **kw)


def ResNet101(**kw) -> ResNet:
    return ResNet(stage_sizes=[3, 4, 23, 3], **kw)


def ResNet152(**kw) -> ResNet:
    return ResNet(stage_sizes=[3, 8, 36, 3], **kw)


# the flax scope of each layer of a block, in the JAX model's order
_BLOCK_LAYERS = (("conv1", "Conv_0"), ("bn1", "BatchNorm_0"),
                 ("conv2", "Conv_1"), ("bn2", "BatchNorm_1"),
                 ("conv3", "Conv_2"), ("bn3", "BatchNorm_2"),
                 ("conv_proj", "conv_proj"), ("norm_proj", "norm_proj"))


def params_from_jax(params, batch_stats) -> dict:
    """A ``state_dict`` for ``ResNet`` from the JAX package's flax trees
    (``variables["params"]`` and ``variables["batch_stats"]``), given as
    numpy arrays: conv kernels HWIO → OIHW, the dense kernel (in, out) →
    (out, in), ``scale``/``bias`` → ``weight``/``bias``, ``mean``/``var``
    → the running buffers."""
    out = {}

    def conv(prefix, p):
        out[f"{prefix}.weight"] = np.transpose(p["kernel"], (3, 2, 0, 1))

    def norm(prefix, p, s):
        out[f"{prefix}.weight"] = p["scale"]
        out[f"{prefix}.bias"] = p["bias"]
        out[f"{prefix}.running_mean"] = s["mean"]
        out[f"{prefix}.running_var"] = s["var"]

    conv("conv_init", params["conv_init"])
    norm("bn_init", params["bn_init"], batch_stats["bn_init"])
    n_blocks = sum(k.startswith("BottleneckBlock_") for k in params)
    for i in range(n_blocks):
        p, s = params[f"BottleneckBlock_{i}"], batch_stats[
            f"BottleneckBlock_{i}"]
        for ours, theirs in _BLOCK_LAYERS:
            if theirs not in p:
                continue
            if ours.startswith("conv"):
                conv(f"blocks.{i}.{ours}", p[theirs])
            else:
                norm(f"blocks.{i}.{ours}", p[theirs], s[theirs])
    out["head.weight"] = np.transpose(params["head"]["kernel"])
    out["head.bias"] = params["head"]["bias"]
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in out.items()}
