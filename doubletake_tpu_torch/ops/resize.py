"""Image resize / pyramid ops with the JAX package's NHWC interface.

  * nearest   — ``F.interpolate(mode="nearest")`` index rule
                src = floor(dst * in / out);
  * bilinear  — ``F.interpolate(mode="bilinear", align_corners=False)``;
  * blur_pool — kornia ``blur_pool2d(kernel_size=3)``: reflect pad, 3x3
                binomial blur, stride 2.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def to_nchw(x_nhwc):
    return x_nhwc.permute(0, 3, 1, 2)


def to_nhwc(x_nchw):
    return x_nchw.permute(0, 2, 3, 1)


def interpolate_nearest(x_nhwc, out_hw):
    """torch F.interpolate(mode="nearest"): src = floor(dst * in/out).

    Index tables are built in float64 like the JAX package's, so ratios that
    are not integers pick the same source rows.
    """
    n, h, w, c = x_nhwc.shape
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return x_nhwc
    out = x_nhwc
    if oh != h:
        ys = np.clip(np.floor(np.arange(oh) * (h / oh)).astype(np.int64), 0, h - 1)
        out = out[:, torch.as_tensor(ys, device=x_nhwc.device)]
    if ow != w:
        xs = np.clip(np.floor(np.arange(ow) * (w / ow)).astype(np.int64), 0, w - 1)
        out = out[:, :, torch.as_tensor(xs, device=x_nhwc.device)]
    return out


def interpolate_bilinear(x_nhwc, out_hw):
    """torch F.interpolate(mode="bilinear", align_corners=False), no antialias."""
    if tuple(out_hw) == tuple(x_nhwc.shape[1:3]):
        return x_nhwc
    return to_nhwc(F.interpolate(to_nchw(x_nhwc), size=tuple(out_hw),
                               mode="bilinear", align_corners=False))


def upsample2x_bilinear_nchw(x_nchw):
    """2x bilinear upsample, align_corners=False (decoder skip upsampling)."""
    return F.interpolate(x_nchw, scale_factor=2, mode="bilinear", align_corners=False)


def upsample2x_bilinear(x_nhwc):
    return to_nhwc(upsample2x_bilinear_nchw(to_nchw(x_nhwc)))


def blur_pool_2x(x_nhwc):
    """kornia blur_pool2d(kernel_size=3): reflect-pad 1, 3x3 binomial blur,
    stride-2 subsample."""
    c = x_nhwc.shape[-1]
    k = torch.tensor([1.0, 2.0, 1.0], dtype=x_nhwc.dtype, device=x_nhwc.device)
    k2 = (torch.outer(k, k) / 16.0)[None, None].repeat(c, 1, 1, 1)
    xp = F.pad(to_nchw(x_nhwc), (1, 1, 1, 1), mode="reflect")
    return to_nhwc(F.conv2d(xp, k2, stride=2, groups=c))


def pyrdown(x_nhwc, num_scales: int = 4):
    """Blur-pool pyramid: [x, bp(x), bp(bp(x)), ...] with num_scales levels."""
    out = [x_nhwc]
    for _ in range(num_scales - 1):
        out.append(blur_pool_2x(out[-1]))
    return out


def reflect_pad(x_nhwc, pad_h, pad_w):
    """Reflection padding (torch ReflectionPad2d)."""
    return to_nhwc(F.pad(to_nchw(x_nhwc), (pad_w[0], pad_w[1], pad_h[0], pad_h[1]),
                       mode="reflect"))


def replicate_pad(x_nhwc, pad_h, pad_w):
    """Replication (edge) padding (torch padding_mode="replicate")."""
    return to_nhwc(F.pad(to_nchw(x_nhwc), (pad_w[0], pad_w[1], pad_h[0], pad_h[1]),
                       mode="replicate"))
