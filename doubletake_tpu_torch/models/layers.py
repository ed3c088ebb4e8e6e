"""Basic neural blocks (torch.nn, NCHW inside the blocks).

Parity targets in the reference, with the reference's state_dict names so a
Lightning checkpoint loads without renaming:
  * BasicBlock — norm-free residual block with LeakyReLU(0.2) and bias=True
    (reference: src/doubletake/modules/layers.py:33-94);
  * MLP — Linear+LeakyReLU stack with the final activation disabled; the
    MLPs use torch's default slope 0.01 (reference: modules/networks.py:120-135);
  * BlurPool — antialiased_cnns.BlurPool(filt_size=4, stride=2);
  * Conv2dSame — timm's TF-"SAME" conv (asymmetric padding for stride 2).

Slopes differ by module: 0.2 in the conv blocks and encoders, 0.01 in the
two MLPs.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def conv(cin: int, cout: int, kernel: int, stride: int = 1, padding: int = 0,
         bias: bool = True, groups: int = 1, padding_mode: str = "zeros"):
    """torch conv with symmetric integer padding (the JAX package's ``conv``)."""
    return nn.Conv2d(cin, cout, kernel, stride, padding, bias=bias, groups=groups,
                     padding_mode=padding_mode)


class BasicBlock(nn.Module):
    """Norm-free residual block, LeakyReLU(0.2), bias convs.

    Downsample path: 1x1 conv when stride==1 but channels change, 3x3 conv
    when stride!=1 (reference modules/layers.py:67-74); stored as
    ``downsample.0`` like the reference's Sequential(conv, Identity).
    """

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = conv(inplanes, planes, 3, stride, 1)
        self.conv2 = conv(planes, planes, 3, 1, 1)
        if inplanes == planes and stride == 1:
            self.downsample = None
        else:
            ds = (conv(inplanes, planes, 1, 1, 0) if stride == 1
                  else conv(inplanes, planes, 3, stride, 1))
            self.downsample = nn.Sequential(ds, nn.Identity())

    def forward(self, x):
        out = F.leaky_relu(self.conv1(x), 0.2)
        out = self.conv2(out)
        identity = x if self.downsample is None else self.downsample(x)
        return F.leaky_relu(out + identity, 0.2)


class MLP(nn.Module):
    """Linear + LeakyReLU(0.01) stack, final activation disabled.

    Stored as ``net.{0,2,4}`` like the reference's nn.Sequential.
    """

    def __init__(self, channel_list: Sequence[int]):
        super().__init__()
        layers = []
        for i in range(len(channel_list) - 1):
            layers.append(nn.Linear(channel_list[i], channel_list[i + 1]))
            layers.append(nn.LeakyReLU(0.01))
        self.net = nn.Sequential(*layers[:-1])

    def forward(self, x):
        return self.net(x)

    def linears(self):
        return [m for m in self.net if isinstance(m, nn.Linear)]


def _blurpool_filter(filt_size: int) -> np.ndarray:
    rows = {
        2: np.array([1.0, 1.0]),
        3: np.array([1.0, 2.0, 1.0]),
        4: np.array([1.0, 3.0, 3.0, 1.0]),
        5: np.array([1.0, 4.0, 6.0, 4.0, 1.0]),
    }[filt_size]
    f = np.outer(rows, rows)
    return f / f.sum()


def blurpool_filter(channels: int, filt_size: int = 4) -> torch.Tensor:
    """The (channels, 1, k, k) binomial filter BlurPool stores as ``filt``."""
    filt = torch.from_numpy(_blurpool_filter(filt_size).astype(np.float32))
    return filt[None, None].repeat(channels, 1, 1, 1)


class BlurPool(nn.Module):
    """antialiased_cnns BlurPool: reflect pad then strided binomial depthwise
    conv. For filt_size=4 the pad is (1 left/top, 2 right/bottom). The
    filter is a buffer named ``filt``, as in the reference checkpoints."""

    def __init__(self, channels: int, filt_size: int = 4, stride: int = 2):
        super().__init__()
        self.channels, self.stride = channels, stride
        self.pad_l = (filt_size - 1) // 2
        self.pad_r = int(np.ceil((filt_size - 1) / 2.0))
        self.register_buffer("filt", blurpool_filter(channels, filt_size))

    def forward(self, x):
        xp = F.pad(x, (self.pad_l, self.pad_r, self.pad_l, self.pad_r), mode="reflect")
        return F.conv2d(xp, self.filt, stride=self.stride, groups=self.channels)


class Conv2dSame(nn.Conv2d):
    """timm Conv2dSame: TF-style asymmetric SAME padding, no bias."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, groups: int = 1):
        super().__init__(cin, cout, kernel, stride, 0, groups=groups, bias=False)

    def forward(self, x):
        ih, iw = x.shape[-2:]
        kh, kw = self.kernel_size
        s = self.stride[0]
        pad_h = max((-(-ih // s) - 1) * s + kh - ih, 0)
        pad_w = max((-(-iw // s) - 1) * s + kw - iw, 0)
        if pad_h or pad_w:
            x = F.pad(x, [pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2])
        return F.conv2d(x, self.weight, None, self.stride, 0, 1, self.groups)


def instance_norm(x_nchw, eps: float = 1e-5):
    """nn.InstanceNorm2d(affine=False): per-sample, per-channel, biased var."""
    return F.instance_norm(x_nchw, eps=eps)


def init_parameters(module: nn.Module, generator: torch.Generator):
    """Seeded initialisation with the JAX package's initializers.

    Conv and linear weights: lecun-normal (truncated normal, std
    1/sqrt(fan_in), flax's default); biases zero; batch norm scale 1,
    bias 0, running mean 0, running var 1. Random draws come from
    ``generator`` only, so one seed gives one model.
    """
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            # flax variance_scaling(1, fan_in, truncated_normal): the std of
            # a unit normal truncated to [-2, 2] is 0.8796...
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            with torch.no_grad():
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            with torch.no_grad():
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
