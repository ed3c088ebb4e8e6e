"""The U-Net / FPN matching encoder (torch.nn; NHWC at the interface).

Counterpart of ``doubletake_tpu.models.unet_encoder``, the reference's
alternative matching encoder (src/doubletake/modules/networks.py:192-213):
a timm ``mnasnet_100`` backbone (features_only, 5 scales) feeding a
torchvision ``FeaturePyramidNetwork(out_channels=32)``, of which only the
stride-4 level is used, then LeakyReLU(0.2) -> 1x1 conv -> InstanceNorm.

State names are the reference's: ``encoder.*`` as timm's mnasnet_100,
``decoder.{inner,layer}_blocks.{i}.0`` as torchvision's FPN (the layout of
torchvision 0.13 on; ``checkpoints.convert.load_weights`` renames the older
``{inner,layer}_blocks.{i}``) and ``outconv.1``. The JAX package's
``MatmulConv`` is a TPU lowering of an ordinary convolution with the same
parameters, so the port uses ``Conv2d``.
"""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from doubletake_tpu_torch.models.layers import BatchNorm2d, Conv2d, InstanceNorm2d, LeakyReLU
from doubletake_tpu_torch.ops.resize import to_nchw, to_nhwc


class DepthwiseSeparable(nn.Module):
    """timm DepthwiseSeparableConv (mnasnet stage 0): dw 3x3 -> BN -> ReLU
    -> pw 1x1 -> BN."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv_dw = Conv2d(cin, cin, 3, 1, 1, groups=cin, bias=False)
        self.bn1 = BatchNorm2d(cin)
        self.conv_pw = Conv2d(cin, cout, 1, bias=False)
        self.bn2 = BatchNorm2d(cout)

    def forward(self, x):
        return self.bn2(self.conv_pw(F.relu(self.bn1(self.conv_dw(x)))))


class InvertedResidual(nn.Module):
    """timm InvertedResidual without squeeze-excite (mnasnet_100 'ir'):
    pw expand -> dw k x k -> pw project, ReLU, skip where the shape holds
    unless ``noskip``."""

    def __init__(self, cin: int, cout: int, exp_ratio: float, kernel: int = 3,
                 stride: int = 1, noskip: bool = False):
        super().__init__()
        mid = int(cin * exp_ratio)
        self.conv_pw = Conv2d(cin, mid, 1, bias=False)
        self.bn1 = BatchNorm2d(mid)
        self.conv_dw = Conv2d(mid, mid, kernel, stride, kernel // 2, groups=mid, bias=False)
        self.bn2 = BatchNorm2d(mid)
        self.conv_pwl = Conv2d(mid, cout, 1, bias=False)
        self.bn3 = BatchNorm2d(cout)
        self.has_skip = not noskip and stride == 1 and cin == cout

    def forward(self, x):
        y = F.relu(self.bn1(self.conv_pw(x)))
        y = F.relu(self.bn2(self.conv_dw(y)))
        y = self.bn3(self.conv_pwl(y))
        return y + x if self.has_skip else y


# (repeats, kernel, first-stride, exp_ratio, out_chs) per mnasnet_100 stage 1..6
MNASNET_STAGES = (
    (3, 3, 2, 3.0, 24),
    (3, 5, 2, 3.0, 40),
    (3, 5, 2, 6.0, 80),
    (2, 3, 1, 6.0, 96),
    (4, 5, 2, 6.0, 192),
    (1, 3, 1, 6.0, 320),
)


class MnasNet100(nn.Module):
    """timm mnasnet_100 features_only(5): channels [16, 24, 40, 96, 320] at
    strides 2, 4, 8, 16, 32. The last stage's first block has no skip."""

    feature_channels = (16, 24, 40, 96, 320)

    def __init__(self):
        super().__init__()
        self.conv_stem = Conv2d(3, 32, 3, 2, 1, bias=False)
        self.bn1 = BatchNorm2d(32)
        stages = [nn.Sequential(DepthwiseSeparable(32, 16))]
        cin = 16
        for si, (repeats, k, stride0, exp, cout) in enumerate(MNASNET_STAGES):
            last = si == len(MNASNET_STAGES) - 1
            stages.append(nn.Sequential(*[
                InvertedResidual(cin if bi == 0 else cout, cout, exp, k,
                                 stride0 if bi == 0 else 1, noskip=last and bi == 0)
                for bi in range(repeats)]))
            cin = cout
        self.blocks = nn.Sequential(*stages)

    def forward_nchw(self, x):
        x = F.relu(self.bn1(self.conv_stem(x)))
        feats = []
        for si, stage in enumerate(self.blocks):
            x = stage(x)
            if si in (0, 1, 2, 4, 6):
                feats.append(x)
        return feats


class FeaturePyramid(nn.Module):
    """torchvision FeaturePyramidNetwork: 1x1 laterals, top-down adds, 3x3
    output convs; all levels, finest first. The top-down step is a 2x
    nearest repeat cropped to the finer level, as the JAX package computes
    it (``F.interpolate(size=...)``, torchvision's, differs on odd sizes)."""

    def __init__(self, in_channels, out_channels: int = 32):
        super().__init__()
        self.inner_blocks = nn.ModuleList(
            nn.Sequential(Conv2d(c, out_channels, 1)) for c in in_channels)
        self.layer_blocks = nn.ModuleList(
            nn.Sequential(Conv2d(out_channels, out_channels, 3, 1, 1)) for _ in in_channels)

    def forward(self, feats):
        laterals = [blk(f) for blk, f in zip(self.inner_blocks, feats)]
        merged = laterals[-1:]
        for lat in reversed(laterals[:-1]):
            up = merged[0].repeat_interleave(2, 2).repeat_interleave(2, 3)
            merged.insert(0, lat + up[:, :, :lat.shape[2], :lat.shape[3]])
        return [blk(m) for blk, m in zip(self.layer_blocks, merged)]


class UNetMatchingEncoder(nn.Module):
    """mnasnet_100 + FPN matching encoder: the FPN's stride-4 level ->
    LeakyReLU(0.2) -> 1x1 conv to ``num_ch_out`` -> InstanceNorm."""

    def __init__(self, num_ch_out: int = 16):
        super().__init__()
        self.encoder = MnasNet100()
        self.decoder = FeaturePyramid(MnasNet100.feature_channels, 32)
        self.outconv = nn.Sequential(LeakyReLU(0.2), Conv2d(32, num_ch_out, 1), InstanceNorm2d())

    def forward(self, x_nhwc):
        fpn = self.decoder(self.encoder.forward_nchw(to_nchw(x_nhwc)))
        return to_nhwc(self.outconv(fpn[1]))
