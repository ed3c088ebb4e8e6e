"""Backbone encoders: the matching encoder and the image-prior encoders.

Counterparts of ``doubletake_tpu.models.backbones``, with the reference's
(timm / antialiased_cnns) state_dict names:

  * ``ResnetMatchingEncoder`` — antialiased ResNet18 stem + layer1 and a
    conv/InstanceNorm head: 16-ch matching features at stride 4, stored as
    the reference's ``matching_model.net.{0..9}`` Sequential
    (networks.py:166-186).
  * ``ResNet18D`` — timm "resnet18d" features_only(5): a deep 3-conv stem
    and resnet-d blocks (an average-pool shortcut where the stride changes).
  * ``EfficientNetV2S`` — timm "tf_efficientnetv2_s" features_only(5): TF
    SAME padding, BN eps 1e-3, SiLU, fused MBConv early, SE-MBConv later.
  * ``UNetMatchingEncoder`` (``models/unet_encoder.py``) — the "fpn" /
    "unet" matching encoder.
  * ``TinyEncoder`` / ``TinyMatchingEncoder`` — the small CI configs.

Every encoder takes and returns NHWC tensors; the layers run NCHW inside.
"""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from doubletake_tpu_torch.models.layers import (
    AvgPool,
    BatchNorm2d,
    BlurPool,
    Conv2d,
    Conv2dSame,
    InstanceNorm2d,
    LeakyReLU,
    conv,
    instance_norm,
    leaky_relu,
    max_pool,
    silu,
)
from doubletake_tpu_torch.ops.resize import to_nchw, to_nhwc


class BNBasicBlock(nn.Module):
    """torchvision / timm ResNet BasicBlock (BN + ReLU). Where the stride or
    the width changes, the shortcut is timm's resnet-d ``downsample``:
    Sequential(avg-pool over the stride (Identity at stride 1), 1x1 conv,
    BN), stored as ``downsample.{1,2}``."""

    def __init__(self, inplanes: int = 64, planes: int = 64, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = None
        if inplanes != planes or stride != 1:
            self.downsample = nn.Sequential(
                AvgPool(stride, stride) if stride != 1 else nn.Identity(),
                Conv2d(inplanes, planes, 1, bias=False), BatchNorm2d(planes))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResnetMatchingEncoder(nn.Module):
    """conv1 7x7 s2 -> bn -> relu -> MaxPool(k2, s1) -> BlurPool(filt4, s2)
    -> layer1 (2 BN BasicBlocks, 64ch) -> 1x1 conv 128 -> InstanceNorm ->
    LeakyReLU(0.2) -> 3x3 conv (replicate pad) num_ch_out -> InstanceNorm."""

    def __init__(self, num_ch_out: int = 16):
        super().__init__()
        self.net = nn.Sequential(
            Conv2d(3, 64, 7, 2, 3, bias=False),                   # 0
            BatchNorm2d(64),                                       # 1
            nn.ReLU(),                                                # 2
            nn.Sequential(nn.MaxPool2d(2, 1), BlurPool(64)),          # 3
            nn.Sequential(BNBasicBlock(), BNBasicBlock()),            # 4
            Conv2d(64, 128, 1),                                    # 5
            InstanceNorm2d(),                                         # 6
            LeakyReLU(0.2),                                           # 7
            Conv2d(128, num_ch_out, 3, padding=1, padding_mode="replicate"),  # 8
            InstanceNorm2d(),                                         # 9
        )

    def forward(self, x_nhwc):
        return to_nhwc(self.net(to_nchw(x_nhwc)))


class ResNet18D(nn.Module):
    """timm resnet18d features_only(5): the deep stem (three 3x3 convs,
    ``conv1.{0,3,6}`` with BN ``conv1.{1,4}`` and ``bn1``) at stride 2, a
    3/2/1 max pool, then ``layer1..4`` of two blocks each, the first block
    of layers 2-4 at stride 2 with the resnet-d shortcut."""

    feature_channels = (64, 64, 128, 256, 512)

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Sequential(
            Conv2d(3, 32, 3, 2, 1, bias=False), BatchNorm2d(32), nn.ReLU(),
            Conv2d(32, 32, 3, 1, 1, bias=False), BatchNorm2d(32), nn.ReLU(),
            Conv2d(32, 64, 3, 1, 1, bias=False))
        self.bn1 = BatchNorm2d(64)
        cin = 64
        for li, (planes, stride) in enumerate(((64, 1), (128, 2), (256, 2), (512, 2))):
            setattr(self, f"layer{li + 1}", nn.Sequential(BNBasicBlock(cin, planes, stride),
                                                          BNBasicBlock(planes, planes)))
            cin = planes

    def forward_nchw(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        feats = [x]                                            # stride 2
        x = max_pool(x, 3, 2, 1)
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
            feats.append(x)
        return feats

    def forward(self, x_nhwc):
        return [to_nhwc(f) for f in self.forward_nchw(to_nchw(x_nhwc))]


def _bn(c, eps):
    return BatchNorm2d(c, eps=eps)


class SqueezeExcite(nn.Module):
    """timm SqueezeExcite: mean-pool -> 1x1 reduce -> SiLU -> 1x1 expand -> sigmoid."""

    def __init__(self, chs: int, rd: int):
        super().__init__()
        self.conv_reduce = Conv2d(chs, rd, 1)
        self.conv_expand = Conv2d(rd, chs, 1)

    def forward(self, x):
        s = x.mean((2, 3), keepdim=True)
        s = silu(self.conv_reduce(s))
        return x * self.conv_expand(s).sigmoid()


class ConvBnAct(nn.Module):
    """timm ConvBnAct ('cn'): conv k3 -> BN -> SiLU, with skip."""

    def __init__(self, cin, cout, stride, eps):
        super().__init__()
        self.conv = Conv2dSame(cin, cout, 3, stride)
        self.bn1 = _bn(cout, eps)
        self.has_skip = stride == 1 and cin == cout

    def forward(self, x):
        y = silu(self.bn1(self.conv(x)))
        return y + x if self.has_skip else y


class EdgeResidual(nn.Module):
    """timm EdgeResidual / FusedMBConv ('er'): k3 expand -> pw project."""

    def __init__(self, cin, cout, exp, stride, eps):
        super().__init__()
        mid = int(cin * exp)
        self.conv_exp = Conv2dSame(cin, mid, 3, stride)
        self.bn1 = _bn(mid, eps)
        self.conv_pwl = Conv2dSame(mid, cout, 1, 1)
        self.bn2 = _bn(cout, eps)
        self.has_skip = stride == 1 and cin == cout

    def forward(self, x):
        y = silu(self.bn1(self.conv_exp(x)))
        y = self.bn2(self.conv_pwl(y))
        return y + x if self.has_skip else y


class InvertedResidual(nn.Module):
    """timm InvertedResidual / MBConv ('ir') with SE; the SE width comes from
    the block INPUT channels (timm: rd = in_chs * se_ratio)."""

    def __init__(self, cin, cout, exp, stride, se_ratio, eps):
        super().__init__()
        mid = int(cin * exp)
        self.conv_pw = Conv2dSame(cin, mid, 1, 1)
        self.bn1 = _bn(mid, eps)
        self.conv_dw = Conv2dSame(mid, mid, 3, stride, groups=mid)
        self.bn2 = _bn(mid, eps)
        self.se = SqueezeExcite(mid, max(1, int(cin * se_ratio)))
        self.conv_pwl = Conv2dSame(mid, cout, 1, 1)
        self.bn3 = _bn(cout, eps)
        self.has_skip = stride == 1 and cin == cout

    def forward(self, x):
        y = silu(self.bn1(self.conv_pw(x)))
        y = silu(self.bn2(self.conv_dw(y)))
        y = self.se(y)
        y = self.bn3(self.conv_pwl(y))
        return y + x if self.has_skip else y


# (block type, repeats, out_chs, exp_ratio, first-stride, se_ratio)
_EFFNETV2_S_ARCH = (
    ("cn", 2, 24, 1.0, 1, 0.0),
    ("er", 4, 48, 4.0, 2, 0.0),
    ("er", 4, 64, 4.0, 2, 0.0),
    ("ir", 6, 128, 4.0, 2, 0.25),
    ("ir", 9, 160, 6.0, 1, 0.25),
    ("ir", 15, 256, 6.0, 2, 0.25),
)


class EfficientNetV2S(nn.Module):
    """tf_efficientnetv2_s features_only(5): channels [24, 48, 64, 160, 256],
    taps after stages 0, 1, 2, 4, 5 (strides 2, 4, 8, 16, 32)."""

    feature_channels = (24, 48, 64, 160, 256)

    def __init__(self, eps: float = 1e-3):
        super().__init__()
        self.conv_stem = Conv2dSame(3, 24, 3, 2)
        self.bn1 = _bn(24, eps)
        stages = []
        cin = 24
        for btype, repeats, cout, exp, stride0, se in _EFFNETV2_S_ARCH:
            stage = []
            for bi in range(repeats):
                stride = stride0 if bi == 0 else 1
                if btype == "cn":
                    stage.append(ConvBnAct(cin, cout, stride, eps))
                elif btype == "er":
                    stage.append(EdgeResidual(cin, cout, exp, stride, eps))
                else:
                    stage.append(InvertedResidual(cin, cout, exp, stride, se, eps))
                cin = cout
            stages.append(nn.Sequential(*stage))
        self.blocks = nn.Sequential(*stages)

    def forward_nchw(self, x):
        x = silu(self.bn1(self.conv_stem(x)))
        feats = []
        for si, stage in enumerate(self.blocks):
            x = stage(x)
            if si in (0, 1, 2, 4, 5):
                feats.append(x)
        return feats

    def forward(self, x_nhwc):
        return [to_nhwc(f) for f in self.forward_nchw(to_nchw(x_nhwc))]


class TinyEncoder(nn.Module):
    """Toy 5-scale image encoder for CI configs: stride-2 conv + BN + ReLU
    per scale. State names ``conv{i}`` / ``bn{i}`` follow the JAX module."""

    feature_channels = (8, 8, 16, 16, 16)

    def __init__(self):
        super().__init__()
        cin = 3
        for si, ch in enumerate(self.feature_channels):
            setattr(self, f"conv{si}", conv(cin, ch, 3, 2, 1, bias=False))
            setattr(self, f"bn{si}", BatchNorm2d(ch))
            cin = ch

    def forward_nchw(self, x):
        feats = []
        for si in range(len(self.feature_channels)):
            x = F.relu(getattr(self, f"bn{si}")(getattr(self, f"conv{si}")(x)))
            feats.append(x)
        return feats

    def forward(self, x_nhwc):
        return [to_nhwc(f) for f in self.forward_nchw(to_nchw(x_nhwc))]


class TinyMatchingEncoder(nn.Module):
    """Toy stride-4 matching encoder for CI configs."""

    def __init__(self, num_ch_out: int = 16):
        super().__init__()
        self.conv0 = conv(3, 16, 3, 2, 1)
        self.conv1 = conv(16, num_ch_out, 3, 2, 1)

    def forward(self, x_nhwc):
        x = leaky_relu(self.conv0(to_nchw(x_nhwc)), 0.2)
        return to_nhwc(instance_norm(self.conv1(x)))


def get_matching_encoder(matching_encoder_type: str, num_ch_out: int = 16) -> nn.Module:
    if matching_encoder_type == "resnet":
        return ResnetMatchingEncoder(num_ch_out)
    if matching_encoder_type in ("fpn", "unet"):
        from doubletake_tpu_torch.models.unet_encoder import UNetMatchingEncoder

        return UNetMatchingEncoder(num_ch_out)
    if matching_encoder_type == "tiny":
        return TinyMatchingEncoder(num_ch_out)
    raise ValueError(f"Unrecognized matching encoder: {matching_encoder_type}")


def get_image_encoder(name: str) -> nn.Module:
    """The image-prior encoder; its ``feature_channels`` give the widths."""
    if "efficientnet" in name:
        return EfficientNetV2S()
    if "resnet18d" in name:
        return ResNet18D()
    if "tiny" in name:
        return TinyEncoder()
    raise ValueError(f"Unrecognized image encoder: {name}")
