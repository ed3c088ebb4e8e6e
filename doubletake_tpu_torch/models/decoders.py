"""Cost-volume encoder and depth decoders (torch.nn, NCHW inside).

Counterparts of ``doubletake_tpu.models.decoders`` with the reference's
state_dict names (src/doubletake/modules/networks.py:20-117 for CVEncoder
and DepthDecoderPP, networks_fast.py for the skip decoder). ``forward``
takes and returns NHWC tensors; ``forward_nchw`` is the internal path the
depth model uses.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from doubletake_tpu_torch.models.layers import BasicBlock, conv
from doubletake_tpu_torch.ops.resize import to_nchw, to_nhwc, upsample2x_bilinear_nchw

_DEC_CHANNELS = (64, 64, 128, 256)


class CVEncoder(nn.Module):
    """First half of the U-Net: fuse the cost volume with image-prior
    features. Block i downsamples (stride 2, except block 0), concatenates
    the matching-scale image feature, and refines."""

    def __init__(self, num_ch_cv: int, num_ch_enc: Sequence[int],
                 num_ch_outs: Sequence[int] = (64, 128, 256, 384)):
        super().__init__()
        self.convs = nn.ModuleDict()
        self.num_blocks = len(num_ch_outs)
        for i, ch in enumerate(num_ch_outs):
            cin = num_ch_cv if i == 0 else num_ch_outs[i - 1]
            self.convs[f"ds_conv_{i}"] = BasicBlock(cin, ch, stride=1 if i == 0 else 2)
            self.convs[f"conv_{i}"] = nn.Sequential(
                BasicBlock(num_ch_enc[i] + ch, ch), BasicBlock(ch, ch)
            )

    def forward_nchw(self, x, img_feats):
        outputs = []
        for i in range(self.num_blocks):
            x = self.convs[f"ds_conv_{i}"](x)
            x = torch.cat([x, img_feats[i]], dim=1)
            x = self.convs[f"conv_{i}"](x)
            outputs.append(x)
        return outputs

    def forward(self, cost_volume_nhwc, img_feats_nhwc):
        outs = self.forward_nchw(to_nchw(cost_volume_nhwc), [to_nchw(f) for f in img_feats_nhwc])
        return [to_nhwc(o) for o in outs]


class DepthDecoderPP(nn.Module):
    """U-Net++ grid decoder with log-depth heads at scales s0..s3.

    Node X(i, j) (i encoder depth, j decoder column) takes right(X(i, j-1)),
    up2(diag(X(i+1, j-1))) and, when i + j != 4, up2(up(X(i+1, j))). Only
    the last column's heads survive (networks.py:60-85).
    """

    def __init__(self, num_ch_enc: Sequence[int]):
        super().__init__()
        dec = _DEC_CHANNELS
        self.convs = nn.ModuleDict()
        for j in range(1, 5):
            for i in range(4 - j, -1, -1):
                ch = dec[i]
                total = 0
                nin = num_ch_enc[i + 1] if j == 1 else dec[i + 1]
                self.convs[f"diag_conv_{i + 1}{j - 1}"] = BasicBlock(nin, ch)
                total += ch
                nin = num_ch_enc[i] if j == 1 else dec[i]
                self.convs[f"right_conv_{i}{j - 1}"] = BasicBlock(nin, ch)
                total += ch
                if i + j != 4:
                    self.convs[f"up_conv_{i + 1}{j}"] = BasicBlock(dec[i + 1], ch)
                    total += ch
                block = nn.Sequential(BasicBlock(total, ch))
                block.add_module("conv_0", BasicBlock(ch, ch))
                self.convs[f"in_conv_{i}{j}"] = block
                self.convs[f"output_{i}"] = nn.Sequential(
                    BasicBlock(ch, ch) if i != 0 else nn.Identity(),
                    conv(ch, 1, 1),
                )

    def forward_nchw(self, input_features):
        grid = {(i, 0): f for i, f in enumerate(input_features)}
        outputs = {}
        for j in range(1, 5):
            for i in range(4 - j, -1, -1):
                inputs = [self.convs[f"right_conv_{i}{j - 1}"](grid[(i, j - 1)])]
                inputs.append(upsample2x_bilinear_nchw(
                    self.convs[f"diag_conv_{i + 1}{j - 1}"](grid[(i + 1, j - 1)])))
                if i + j != 4:
                    inputs.append(upsample2x_bilinear_nchw(
                        self.convs[f"up_conv_{i + 1}{j}"](grid[(i + 1, j)])))
                x = self.convs[f"in_conv_{i}{j}"](torch.cat(inputs, dim=1))
                grid[(i, j)] = x
                if i + j == 4:
                    outputs[f"log_depth_pred_s{i}_bhw1"] = self.convs[f"output_{i}"](x)
        return outputs

    def forward(self, input_features_nhwc):
        outs = self.forward_nchw([to_nchw(f) for f in input_features_nhwc])
        return {k: to_nhwc(v) for k, v in outs.items()}


class _SkipConvBlock(nn.Module):
    """Two 3x3 convs with ELU (reference networks_fast.py:6-24)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = conv(cin, cout, 3, 1, 1)
        self.conv2 = conv(cout, cout, 3, 1, 1)

    def forward(self, x):
        return F.elu(self.conv2(F.elu(self.conv1(x))))


class _SkipBlock(nn.Module):
    """ConvUpsampleAndConcat: pre-conv, nearest 2x, concat skip, post-conv."""

    def __init__(self, cin: int, cout: int, skip_ch: int):
        super().__init__()
        self.pre_concat_conv = _SkipConvBlock(cin, cout)
        self.post_concat_conv = _SkipConvBlock(cout + skip_ch, cout)

    def forward(self, x, skip):
        x = self.pre_concat_conv(x)
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        return self.post_concat_conv(torch.cat([x, skip], dim=1))


class SkipDecoderRegression(nn.Module):
    """Lightweight skip-connection decoder ("small" model): four upsampling
    blocks with 1x1 regression heads (128 -> 128 -> 1, ELU) at each scale
    (reference networks_fast.py:27-141)."""

    def __init__(self, num_ch_enc: Sequence[int],
                 output_channels: Sequence[int] = (256, 128, 64, 64)):
        super().__init__()
        cin = num_ch_enc[-1]
        for bi, out_ch in enumerate(output_channels):
            setattr(self, f"block{bi + 1}", _SkipBlock(cin, out_ch, num_ch_enc[-(bi + 2)]))
            setattr(self, f"out{bi + 1}", nn.Sequential(
                conv(out_ch, 128, 1), nn.ELU(), conv(128, 128, 1), nn.ELU(), conv(128, 1, 1)
            ))
            cin = out_ch
        self.num_blocks = len(output_channels)

    def forward_nchw(self, input_features):
        feats = list(input_features)
        x = feats[-1]
        outputs = {}
        for bi in range(self.num_blocks):
            x = getattr(self, f"block{bi + 1}")(x, feats[-(bi + 2)])
            outputs[f"log_depth_pred_s{3 - bi}_bhw1"] = getattr(self, f"out{bi + 1}")(x)
        return outputs

    def forward(self, input_features_nhwc):
        outs = self.forward_nchw([to_nchw(f) for f in input_features_nhwc])
        return {k: to_nhwc(v) for k, v in outs.items()}
