"""Plain float32 layers of the reference model (eval mode only).

A frozen copy of the float32 inference path of the port's
``models/layers.py``, ``ops/resize.py``, ``ops/grid_sample.py`` and
``utils/geometry.py``, with the same module and parameter names so that a
state dict passes between the two. Nothing here imports the port.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def to_nchw(x):
    return x.permute(0, 3, 1, 2)


def to_nhwc(x):
    return x.permute(0, 2, 3, 1)


def interpolate_nearest(x_nhwc, out_hw):
    """F.interpolate(mode="nearest") index rule, tables in float64."""
    n, h, w, c = x_nhwc.shape
    oh, ow = out_hw
    out = x_nhwc
    if oh != h:
        ys = np.clip(np.floor(np.arange(oh) * (h / oh)).astype(np.int64), 0, h - 1)
        out = out[:, torch.as_tensor(ys, device=x_nhwc.device)]
    if ow != w:
        xs = np.clip(np.floor(np.arange(ow) * (w / ow)).astype(np.int64), 0, w - 1)
        out = out[:, :, torch.as_tensor(xs, device=x_nhwc.device)]
    return out


def upsample2x(x_nchw):
    return F.interpolate(x_nchw, scale_factor=2, mode="bilinear", align_corners=False)


def grid_sample_2d(input_nhwc, grid_nhw2):
    """Bilinear, zeros padding, align_corners=False; NHWC in and out."""
    out = F.grid_sample(to_nchw(input_nhwc), grid_nhw2, mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return to_nhwc(out)


def linspace01(num: int, device=None):
    """[0, 1] in ``num`` float32 steps: i * float32(1 / (num - 1)), last 1."""
    if num == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    ramp = torch.arange(num, dtype=torch.float32) * torch.tensor(1.0 / (num - 1),
                                                                  dtype=torch.float32)
    ramp[-1] = 1.0
    return ramp.to(device)


def pixel_grid(height: int, width: int, device=None):
    """(3, H*W) pixel centres (x + 0.5, y + 0.5, 1) in raster order."""
    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=device),
                            torch.arange(width, dtype=torch.float32, device=device),
                            indexing="ij")
    return torch.stack([xs + 0.5, ys + 0.5, torch.ones_like(xs)], 0).reshape(3, -1)


def normalize(v, dim: int, eps: float = 1e-12):
    return v / torch.clamp(torch.linalg.norm(v, dim=dim, keepdim=True), min=eps)


def pose_distance(pose_b44):
    """DVMVS pose distance: (combined, rotation measure, translation measure)."""
    trace = pose_b44[:, :3, :3].diagonal(dim1=-2, dim2=-1).sum(-1)
    r = torch.sqrt(torch.clamp(2.0 * (1.0 - torch.clamp(trace, max=3.0) / 3.0), min=0.0))
    t = torch.linalg.norm(pose_b44[:, :3, 3], dim=-1)
    return torch.sqrt(t ** 2 + r ** 2), r, t


def leaky(x, slope: float = 0.2):
    return F.leaky_relu(x, slope)


def conv(cin, cout, kernel, stride=1, padding=0, bias=True, groups=1, padding_mode="zeros"):
    return nn.Conv2d(cin, cout, kernel, stride, padding, bias=bias, groups=groups,
                     padding_mode=padding_mode)


class BasicBlock(nn.Module):
    """Norm-free residual block, LeakyReLU(0.2), bias convs; the shortcut
    (1x1 at stride 1, 3x3 at stride 2) stored as ``downsample.0``."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = conv(inplanes, planes, 3, stride, 1)
        self.conv2 = conv(planes, planes, 3, 1, 1)
        self.downsample = None
        if inplanes != planes or stride != 1:
            ds = (conv(inplanes, planes, 1, 1, 0) if stride == 1
                  else conv(inplanes, planes, 3, stride, 1))
            self.downsample = nn.Sequential(ds, nn.Identity())

    def forward(self, x):
        out = self.conv2(leaky(self.conv1(x)))
        identity = x if self.downsample is None else self.downsample(x)
        return leaky(out + identity)


class MLP(nn.Module):
    """Linear + LeakyReLU(0.01), no final activation; ``net.{0,2,4}``."""

    def __init__(self, channels: Sequence[int]):
        super().__init__()
        layers = []
        for a, b in zip(channels[:-1], channels[1:]):
            layers += [nn.Linear(a, b), nn.LeakyReLU(0.01)]
        self.net = nn.Sequential(*layers[:-1])

    def forward(self, x):
        return self.net(x)


def blur_filter(channels: int, filt_size: int = 4):
    row = {3: [1.0, 2.0, 1.0], 4: [1.0, 3.0, 3.0, 1.0]}[filt_size]
    f = np.outer(row, row)
    f = torch.from_numpy((f / f.sum()).astype(np.float32))
    return f[None, None].repeat(channels, 1, 1, 1)


class BlurPool(nn.Module):
    """Reflect pad (1, 2) and a stride-2 binomial depthwise conv (``filt``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.channels = channels
        self.register_buffer("filt", blur_filter(channels))

    def forward(self, x):
        x = F.pad(x, (1, 2, 1, 2), mode="reflect")
        return F.conv2d(x, self.filt, stride=2, groups=self.channels)


class Conv2dSame(nn.Conv2d):
    """TF "SAME" padding (asymmetric at stride 2), no bias."""

    def __init__(self, cin, cout, kernel, stride=1, groups=1):
        super().__init__(cin, cout, kernel, stride, 0, groups=groups, bias=False)

    def forward(self, x):
        ih, iw = x.shape[-2:]
        kh, kw = self.kernel_size
        s = self.stride[0]
        ph = max((-(-ih // s) - 1) * s + kh - ih, 0)
        pw = max((-(-iw // s) - 1) * s + kw - iw, 0)
        if ph or pw:
            x = F.pad(x, [pw // 2, pw - pw // 2, ph // 2, ph - ph // 2])
        return F.conv2d(x, self.weight, None, self.stride, 0, 1, self.groups)


class InstanceNorm(nn.Module):
    def forward(self, x):
        return F.instance_norm(x, eps=1e-5)


class AvgPool(nn.Module):
    def __init__(self, window: int, stride: int):
        super().__init__()
        self.window, self.stride = window, stride

    def forward(self, x):
        return F.avg_pool2d(x, self.window, self.stride)
