"""Basic neural blocks (torch.nn, NCHW inside the blocks).

Parity targets in the reference, with the reference's state_dict names so a
Lightning checkpoint loads without renaming:
  * BasicBlock — norm-free residual block with LeakyReLU(0.2) and bias=True
    (reference: src/doubletake/modules/layers.py:33-94);
  * MLP — Linear+LeakyReLU stack with the final activation disabled; the
    MLPs use torch's default slope 0.01 (reference: modules/networks.py:120-135);
  * BlurPool — antialiased_cnns.BlurPool(filt_size=4, stride=2);
  * Conv2dSame — timm's TF-"SAME" conv (asymmetric padding for stride 2);
  * BatchNorm2d — flax ``BatchNorm`` semantics (below);
  * max_pool / avg_pool — the JAX package's pools (ResNet18D).

Slopes differ by module: 0.2 in the conv blocks and encoders, 0.01 in the
two MLPs.

Mixed types follow flax's promotion, as the JAX package's bf16 compute
relies on: ``Conv2d`` and ``Linear`` compute in the promoted type of their
input and weights (bf16 weights on a float32 input compute in float32, with
the weights' bf16 values), and ``BatchNorm2d`` returns the promoted type of
its input, scale and bias.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def promoted(*tensors):
    """The tensors (None kept) in their promoted floating type."""
    dt = None
    for t in tensors:
        if t is not None:
            dt = t.dtype if dt is None else torch.promote_types(dt, t.dtype)
    return [None if t is None else t.to(dt) for t in tensors]


class Conv2d(nn.Conv2d):
    """nn.Conv2d in the promoted type of its input and weights. Below
    float32 the bias is added after the convolution's result is rounded, as
    the JAX package's conv adds it."""

    def forward(self, x):
        if x.dtype == self.weight.dtype == torch.float32:
            return self._conv_forward(x, self.weight, self.bias)
        x, w, b = promoted(x, self.weight, self.bias)
        out = self._conv_forward(x, w, None)
        return out if b is None else out + b.reshape(1, -1, 1, 1)


class Linear(nn.Linear):
    """nn.Linear in the promoted type of its input and weights."""

    def forward(self, x):
        if x.dtype == self.weight.dtype:
            return F.linear(x, self.weight, self.bias)
        return F.linear(*promoted(x, self.weight, self.bias))


def leaky_relu(x, negative_slope: float = 0.2):
    """LeakyReLU. Below float32 the slope is rounded to the input's type
    before the product, as JAX multiplies by a weakly typed scalar."""
    if x.dtype == torch.float32:
        return F.leaky_relu(x, negative_slope)
    return torch.where(x >= 0, x, x * _rounded(negative_slope, x.dtype))


def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float (no device copy)."""
    return float(torch.tensor(value, dtype=dtype))


class LeakyReLU(nn.LeakyReLU):
    """nn.LeakyReLU through ``leaky_relu``."""

    def forward(self, x):
        return leaky_relu(x, self.negative_slope)


def silu(x):
    """SiLU. Below float32 as flax's x * sigmoid(x): the sigmoid rounds to
    the input's type before the product."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * torch.sigmoid(x)


class BatchNorm2d(nn.BatchNorm2d):
    """Batch norm with flax ``BatchNorm``'s semantics, as the JAX package's
    ``batch_norm`` (layers.py:254-258) builds it, under the reference's
    state_dict names.

    In train mode the batch's mean and variance are taken in float32 (at
    least), the variance biased (E[x^2] - E[x]^2, flax's fast variance),
    and the running statistics move by ``momentum`` toward them, in the
    buffers' own type: torch's BatchNorm2d would move the running variance
    toward the unbiased one. The output normalises with the batch
    statistics and has the promoted type of input, scale and bias; so bf16
    weights beside float32 running statistics (the train step at precision
    16) normalise a bf16 input to bf16. In eval mode the running statistics
    normalise; below float32 (bf16 compute) flax's formula runs op by op,
    each op rounding to its type as the JAX package's does:
    (x - mean) * (rsqrt(var + eps) * scale) + bias.
    """

    def forward(self, x):
        if not self.training and x.dtype == self.weight.dtype == torch.float32:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        if not self.training and x.dtype != torch.float32:
            out_dtype = promoted(x, self.weight, self.bias)[0].dtype
            shape = (1, -1, 1, 1)
            var = self.running_var + self.eps
            # rsqrt in float32, then rounded (torch's bf16 rsqrt is not)
            mul = torch.rsqrt(var.float()).to(var.dtype) * self.weight
            y = (x - self.running_mean.reshape(shape)) * mul.reshape(shape)
            return (y + self.bias.reshape(shape)).to(out_dtype)
        x, w, b = promoted(x, self.weight, self.bias)
        if not self.training:
            return F.batch_norm(x, self.running_mean.to(x.dtype), self.running_var.to(x.dtype),
                                w, b, False, 0.0, self.eps)
        with torch.no_grad():
            xf = x.float()
            mean = xf.mean((0, 2, 3))
            var = ((xf * xf).mean((0, 2, 3)) - mean * mean).clamp(min=0.0)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_((m * mean).to(self.running_mean.dtype))
            self.running_var.mul_(1.0 - m).add_((m * var).to(self.running_var.dtype))
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, w, b, True, 0.0, self.eps)


def conv(cin: int, cout: int, kernel: int, stride: int = 1, padding: int = 0,
         bias: bool = True, groups: int = 1, padding_mode: str = "zeros"):
    """torch conv with symmetric integer padding (the JAX package's ``conv``)."""
    return Conv2d(cin, cout, kernel, stride, padding, bias=bias, groups=groups,
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
        out = leaky_relu(self.conv1(x), 0.2)
        out = self.conv2(out)
        identity = x if self.downsample is None else self.downsample(x)
        return leaky_relu(out + identity, 0.2)


class MLP(nn.Module):
    """Linear + LeakyReLU(0.01) stack, final activation disabled.

    Stored as ``net.{0,2,4}`` like the reference's nn.Sequential.
    """

    def __init__(self, channel_list: Sequence[int]):
        super().__init__()
        layers = []
        for i in range(len(channel_list) - 1):
            layers.append(Linear(channel_list[i], channel_list[i + 1]))
            layers.append(LeakyReLU(0.01))
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
        return F.conv2d(xp, self.filt.to(x.dtype), stride=self.stride, groups=self.channels)


class Conv2dSame(Conv2d):
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
        w = self.weight
        if x.dtype != w.dtype:
            x, w = promoted(x, w)
        return F.conv2d(x, w, None, self.stride, 0, 1, self.groups)


def max_pool(x_nchw, window: int, stride: int, padding: int = 0):
    """Max pool with -inf padding (the JAX package's ``max_pool``)."""
    return F.max_pool2d(x_nchw, window, stride, padding)


def avg_pool(x_nchw, window: int, stride: int):
    """Average pool without padding, the window's sum over ``window**2``
    (the JAX package's ``avg_pool``); on odd sizes the last row and column
    are dropped, where timm's ``AvgPool2d(ceil_mode=True,
    count_include_pad=False)`` would average a partial window. Below
    float32 the window is summed in the input's type, one element at a
    time in row-major order, as XLA's ``reduce_window`` adds."""
    if x_nchw.dtype == torch.float32:
        return F.avg_pool2d(x_nchw, window, stride)
    h, w = x_nchw.shape[-2:]
    ho, wo = (h - window) // stride + 1, (w - window) // stride + 1
    total = None
    for i in range(window):
        for j in range(window):
            piece = x_nchw[..., i:i + (ho - 1) * stride + 1:stride,
                           j:j + (wo - 1) * stride + 1:stride]
            total = piece if total is None else total + piece
    return total / (window * window)


class AvgPool(nn.Module):
    """``avg_pool`` as a module (no parameters), for Sequential layouts."""

    def __init__(self, window: int, stride: int):
        super().__init__()
        self.window, self.stride = window, stride

    def forward(self, x_nchw):
        return avg_pool(x_nchw, self.window, self.stride)


def instance_norm(x_nchw, eps: float = 1e-5):
    """nn.InstanceNorm2d(affine=False): per-sample, per-channel, biased var.
    Below float32 the statistics are taken in float32 and rounded to the
    input's type, and (x - mean) * rsqrt(var + eps) runs op by op in it, as
    the JAX package's ``instance_norm`` computes."""
    if x_nchw.dtype == torch.float32:
        return F.instance_norm(x_nchw, eps=eps)
    xf = x_nchw.float()
    mean = xf.mean((2, 3), keepdim=True).to(x_nchw.dtype)
    var = xf.var((2, 3), unbiased=False, keepdim=True).to(x_nchw.dtype)
    var = var + eps
    return (x_nchw - mean) * torch.rsqrt(var.float()).to(var.dtype)


class InstanceNorm2d(nn.Module):
    """``instance_norm`` as a module (no parameters, no state)."""

    def forward(self, x_nchw):
        return instance_norm(x_nchw)


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
