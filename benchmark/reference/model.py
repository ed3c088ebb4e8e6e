"""The plain float32 DoubleTake model: encoders, hint feature volume,
cost-volume encoder and decoders, in eval mode.

A frozen copy of the float32 inference path of the port's ``models/``
(``backbones.py``, ``cost_volume.py``, ``decoders.py``, ``depth_model.py``)
and of ``ops/fused_volume.py``'s plain volume, with the port's state-dict
names. The volume is the plain chunked path: per chunk of planes, the
source features warped with ``grid_sample``, the 202 metadata channels in
the checkpoint's order, the matching MLP [202, 128, 128, 1] and the hint
MLP [3, 12, 12, 1]. Nothing here imports the port.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.layers import (
    MLP,
    AvgPool,
    BasicBlock,
    BlurPool,
    Conv2dSame,
    InstanceNorm,
    conv,
    grid_sample_2d,
    interpolate_nearest,
    linspace01,
    normalize,
    pixel_grid,
    pose_distance,
    to_nchw,
    to_nhwc,
    upsample2x,
)

# ------------------------------------------------------------------ encoders


class BNBasicBlock(nn.Module):
    """ResNet BasicBlock (BN + ReLU) with the resnet-d shortcut."""

    def __init__(self, inplanes: int = 64, planes: int = 64, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = None
        if inplanes != planes or stride != 1:
            self.downsample = nn.Sequential(
                AvgPool(stride, stride) if stride != 1 else nn.Identity(),
                nn.Conv2d(inplanes, planes, 1, bias=False), nn.BatchNorm2d(planes))

    def forward(self, x):
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResnetMatchingEncoder(nn.Module):
    """16-channel matching features at stride 4."""

    def __init__(self, num_ch_out: int = 16):
        super().__init__()
        self.net = nn.Sequential(
            nn.Conv2d(3, 64, 7, 2, 3, bias=False), nn.BatchNorm2d(64), nn.ReLU(),
            nn.Sequential(nn.MaxPool2d(2, 1), BlurPool(64)),
            nn.Sequential(BNBasicBlock(), BNBasicBlock()),
            nn.Conv2d(64, 128, 1), InstanceNorm(), nn.LeakyReLU(0.2),
            nn.Conv2d(128, num_ch_out, 3, padding=1, padding_mode="replicate"), InstanceNorm())

    def forward(self, x_nhwc):
        return to_nhwc(self.net(to_nchw(x_nhwc)))


class ResNet18D(nn.Module):
    feature_channels = (64, 64, 128, 256, 512)

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Sequential(
            nn.Conv2d(3, 32, 3, 2, 1, bias=False), nn.BatchNorm2d(32), nn.ReLU(),
            nn.Conv2d(32, 32, 3, 1, 1, bias=False), nn.BatchNorm2d(32), nn.ReLU(),
            nn.Conv2d(32, 64, 3, 1, 1, bias=False))
        self.bn1 = nn.BatchNorm2d(64)
        cin = 64
        for li, (planes, stride) in enumerate(((64, 1), (128, 2), (256, 2), (512, 2))):
            setattr(self, f"layer{li + 1}", nn.Sequential(BNBasicBlock(cin, planes, stride),
                                                          BNBasicBlock(planes, planes)))
            cin = planes

    def forward_nchw(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        feats = [x]
        x = F.max_pool2d(x, 3, 2, 1)
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
            feats.append(x)
        return feats


class SqueezeExcite(nn.Module):
    def __init__(self, chs: int, rd: int):
        super().__init__()
        self.conv_reduce = nn.Conv2d(chs, rd, 1)
        self.conv_expand = nn.Conv2d(rd, chs, 1)

    def forward(self, x):
        s = F.silu(self.conv_reduce(x.mean((2, 3), keepdim=True)))
        return x * self.conv_expand(s).sigmoid()


class ConvBnAct(nn.Module):
    def __init__(self, cin, cout, stride, eps):
        super().__init__()
        self.conv = Conv2dSame(cin, cout, 3, stride)
        self.bn1 = nn.BatchNorm2d(cout, eps=eps)
        self.has_skip = stride == 1 and cin == cout

    def forward(self, x):
        y = F.silu(self.bn1(self.conv(x)))
        return y + x if self.has_skip else y


class EdgeResidual(nn.Module):
    def __init__(self, cin, cout, exp, stride, eps):
        super().__init__()
        mid = int(cin * exp)
        self.conv_exp = Conv2dSame(cin, mid, 3, stride)
        self.bn1 = nn.BatchNorm2d(mid, eps=eps)
        self.conv_pwl = Conv2dSame(mid, cout, 1, 1)
        self.bn2 = nn.BatchNorm2d(cout, eps=eps)
        self.has_skip = stride == 1 and cin == cout

    def forward(self, x):
        y = self.bn2(self.conv_pwl(F.silu(self.bn1(self.conv_exp(x)))))
        return y + x if self.has_skip else y


class InvertedResidual(nn.Module):
    def __init__(self, cin, cout, exp, stride, se_ratio, eps):
        super().__init__()
        mid = int(cin * exp)
        self.conv_pw = Conv2dSame(cin, mid, 1, 1)
        self.bn1 = nn.BatchNorm2d(mid, eps=eps)
        self.conv_dw = Conv2dSame(mid, mid, 3, stride, groups=mid)
        self.bn2 = nn.BatchNorm2d(mid, eps=eps)
        self.se = SqueezeExcite(mid, max(1, int(cin * se_ratio)))
        self.conv_pwl = Conv2dSame(mid, cout, 1, 1)
        self.bn3 = nn.BatchNorm2d(cout, eps=eps)
        self.has_skip = stride == 1 and cin == cout

    def forward(self, x):
        y = F.silu(self.bn1(self.conv_pw(x)))
        y = self.se(F.silu(self.bn2(self.conv_dw(y))))
        y = self.bn3(self.conv_pwl(y))
        return y + x if self.has_skip else y


# (block type, repeats, out channels, expansion, first stride, SE ratio)
EFFNETV2_S = (
    ("cn", 2, 24, 1.0, 1, 0.0),
    ("er", 4, 48, 4.0, 2, 0.0),
    ("er", 4, 64, 4.0, 2, 0.0),
    ("ir", 6, 128, 4.0, 2, 0.25),
    ("ir", 9, 160, 6.0, 1, 0.25),
    ("ir", 15, 256, 6.0, 2, 0.25),
)


class EfficientNetV2S(nn.Module):
    """tf_efficientnetv2_s, features after stages 0, 1, 2, 4 and 5."""

    feature_channels = (24, 48, 64, 160, 256)

    def __init__(self, eps: float = 1e-3):
        super().__init__()
        self.conv_stem = Conv2dSame(3, 24, 3, 2)
        self.bn1 = nn.BatchNorm2d(24, eps=eps)
        stages, cin = [], 24
        for btype, repeats, cout, exp, stride0, se in EFFNETV2_S:
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
        x = F.silu(self.bn1(self.conv_stem(x)))
        feats = []
        for si, stage in enumerate(self.blocks):
            x = stage(x)
            if si in (0, 1, 2, 4, 5):
                feats.append(x)
        return feats


IMAGE_ENCODERS = {"efficientnet": EfficientNetV2S, "resnet18d": ResNet18D}

# ------------------------------------------------------------------ decoders

DEC_CHANNELS = (64, 64, 128, 256)


class CVEncoder(nn.Module):
    def __init__(self, num_ch_cv, num_ch_enc, num_ch_outs=(64, 128, 256, 384)):
        super().__init__()
        self.convs = nn.ModuleDict()
        self.num_blocks = len(num_ch_outs)
        for i, ch in enumerate(num_ch_outs):
            cin = num_ch_cv if i == 0 else num_ch_outs[i - 1]
            self.convs[f"ds_conv_{i}"] = BasicBlock(cin, ch, stride=1 if i == 0 else 2)
            self.convs[f"conv_{i}"] = nn.Sequential(BasicBlock(num_ch_enc[i] + ch, ch),
                                                    BasicBlock(ch, ch))

    def forward(self, x, img_feats):
        outputs = []
        for i in range(self.num_blocks):
            x = self.convs[f"ds_conv_{i}"](x)
            x = self.convs[f"conv_{i}"](torch.cat([x, img_feats[i]], 1))
            outputs.append(x)
        return outputs


class DepthDecoderPP(nn.Module):
    """U-Net++ decoder; log-depth heads of the last column at s0..s3."""

    def __init__(self, num_ch_enc):
        super().__init__()
        dec = DEC_CHANNELS
        self.convs = nn.ModuleDict()
        for j in range(1, 5):
            for i in range(4 - j, -1, -1):
                ch, total = dec[i], 0
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
                    BasicBlock(ch, ch) if i != 0 else nn.Identity(), conv(ch, 1, 1))

    def forward(self, feats):
        grid = {(i, 0): f for i, f in enumerate(feats)}
        outputs = {}
        for j in range(1, 5):
            for i in range(4 - j, -1, -1):
                inputs = [self.convs[f"right_conv_{i}{j - 1}"](grid[(i, j - 1)]),
                          upsample2x(self.convs[f"diag_conv_{i + 1}{j - 1}"](grid[(i + 1, j - 1)]))]
                if i + j != 4:
                    inputs.append(upsample2x(self.convs[f"up_conv_{i + 1}{j}"](grid[(i + 1, j)])))
                grid[(i, j)] = self.convs[f"in_conv_{i}{j}"](torch.cat(inputs, 1))
                if i + j == 4:
                    outputs[f"s{i}"] = self.convs[f"output_{i}"](grid[(i, j)])
        return outputs


class SkipConvBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = conv(cin, cout, 3, 1, 1)
        self.conv2 = conv(cout, cout, 3, 1, 1)

    def forward(self, x):
        return F.elu(self.conv2(F.elu(self.conv1(x))))


class SkipBlock(nn.Module):
    def __init__(self, cin, cout, skip_ch):
        super().__init__()
        self.pre_concat_conv = SkipConvBlock(cin, cout)
        self.post_concat_conv = SkipConvBlock(cout + skip_ch, cout)

    def forward(self, x, skip):
        x = F.interpolate(self.pre_concat_conv(x), scale_factor=2, mode="nearest")
        return self.post_concat_conv(torch.cat([x, skip], 1))


class SkipDecoderRegression(nn.Module):
    """The small model's decoder: four upsampling blocks, 1x1 heads."""

    def __init__(self, num_ch_enc, output_channels=(256, 128, 64, 64)):
        super().__init__()
        cin = num_ch_enc[-1]
        for bi, out_ch in enumerate(output_channels):
            setattr(self, f"block{bi + 1}", SkipBlock(cin, out_ch, num_ch_enc[-(bi + 2)]))
            setattr(self, f"out{bi + 1}", nn.Sequential(
                conv(out_ch, 128, 1), nn.ELU(), conv(128, 128, 1), nn.ELU(), conv(128, 1, 1)))
            cin = out_ch
        self.num_blocks = len(output_channels)

    def forward(self, feats):
        x, outputs = feats[-1], {}
        for bi in range(self.num_blocks):
            x = getattr(self, f"block{bi + 1}")(x, feats[-(bi + 2)])
            outputs[f"s{3 - bi}"] = getattr(self, f"out{bi + 1}")(x)
        return outputs


DECODERS = {"unet_pp": DepthDecoderPP, "skip": SkipDecoderRegression}

# -------------------------------------------------------------------- volume


def depth_planes(min_depth, max_depth, num, device):
    lo = torch.log(torch.tensor(min_depth, dtype=torch.float32))
    span = torch.log(torch.tensor(max_depth / min_depth, dtype=torch.float32))
    return torch.exp(lo + span * linspace01(num)).to(device)


class HintFeatureVolume(nn.Module):
    """The mesh-hint feature volume (``mlp_mesh_hint_feature_volume``)."""

    def __init__(self, num_depth_bins=64, num_views=7, matching_feature_dims=16,
                 plane_chunk=16):
        super().__init__()
        self.num_depth_bins = num_depth_bins
        self.plane_chunk = plane_chunk
        nin = num_views * matching_feature_dims + matching_feature_dims + 10 * num_views + 4
        self.mlp = MLP((nin, 128, 128, 1))
        self.hint_mlp = MLP((3, 12, 12, 1))

    def forward(self, cur, src, src_T_cur, cur_T_src, src_K, cur_invK, min_depth, max_depth,
                hint):
        b, h, w, c = cur.shape
        k = src.shape[1]
        n = h * w
        planes = depth_planes(min_depth, max_depth, self.num_depth_bins, cur.device)
        P = torch.matmul(src_K, src_T_cur)[:, :, :3, :]                     # (B, k, 3, 4)
        rays = torch.einsum("bij,jn->bin", cur_invK[:, :3, :3], pixel_grid(h, w, cur.device))
        pd, rm, tm = pose_distance(cur_T_src.reshape(b * k, 4, 4))
        pose_meta = torch.cat([pd.reshape(b, k), rm.reshape(b, k), tm.reshape(b, k)], -1)
        centers = cur_T_src[:, :, :3, 3]

        hd = interpolate_nearest(hint["depth_hint_bhw1"], (h, w))[..., 0].reshape(b, n)
        hv = interpolate_nearest(hint["hint_mask_bhw1"].float(), (h, w))[..., 0].reshape(b, n) != 0
        hw = interpolate_nearest(hint["sampled_weights_bhw1"], (h, w))[..., 0].reshape(b, n)
        hw = torch.where(hv, hw, torch.zeros_like(hw))
        cur_n = cur.reshape(b, n, c)

        scores = []
        for s in range(0, planes.shape[0], self.plane_chunk):
            pc = planes[s:s + self.plane_chunk]
            dc = pc.shape[0]
            pts = pc[None, :, None, None] * rays[:, None]                     # (B, Dc, 3, N)
            cam = (torch.einsum("bkij,bdjn->bkdin", P[..., :3], pts)
                   + P[..., 3][:, :, None, :, None])                          # (B, k, Dc, 3, N)
            z = cam[:, :, :, 2] + 1e-8
            scale = torch.where(cam[:, :, :, 2].abs() > 1e-8, 1.0 / z, torch.ones_like(z))
            gx = 2.0 * (cam[:, :, :, 0] * scale) / w - 1.0
            gy = 2.0 * (cam[:, :, :, 1] * scale) / h - 1.0
            grid = torch.stack([gx, gy], -1).reshape(b * k, dc * h, w, 2)
            warped = grid_sample_2d(src.reshape(b * k, h, w, c), grid).reshape(b, k, dc, n, c)
            mask = (z > 0).float()
            dot = (warped * cur_n[:, None, None]).sum(-1) * mask
            cur_rays = normalize(pts, 2)
            src_rays = normalize(pts[:, None] - centers[:, :, None, :, None], 3)
            angle = (cur_rays[:, None] * src_rays).sum(3)

            def per_view(x):
                return x.permute(0, 2, 3, 1)

            rays_all = torch.cat([cur_rays[:, None], src_rays], 1)
            meta = torch.cat([
                warped.permute(0, 2, 3, 1, 4).reshape(b, dc, n, k * c),
                cur_n[:, None].expand(b, dc, n, c),
                per_view(mask), per_view(z),
                pc[None, :, None, None].expand(b, dc, n, 1),
                per_view(dot), per_view(angle),
                rays_all.permute(0, 2, 4, 1, 3).reshape(b, dc, n, (1 + k) * 3),
                pose_meta[:, None, None].expand(b, dc, n, 3 * k),
            ], -1)
            score = self.mlp(meta)[..., 0]                                      # (B, Dc, N)
            diff = torch.where(hv[:, None], (hd[:, None] - pc[None, :, None]).abs(),
                               torch.full((), -1.0, device=cur.device))
            wts = hw[:, None].expand(b, dc, n)
            scores.append(self.hint_mlp(torch.stack([score, diff, wts], -1))[..., 0])
        volume = torch.cat(scores, 1).reshape(b, -1, h, w)                      # (B, D, h, w)
        return volume, planes


# --------------------------------------------------------------------- model


class DepthModelCVHint(nn.Module):
    """DoubleTake in float32: image encoder, matching encoder, hint feature
    volume, CVEncoder and decoder; returns the s0 depth (B, H/2, W/2, 1)
    and the current view's matching features."""

    def __init__(self, image_encoder_name="efficientnet", depth_decoder_name="unet_pp",
                 matching_num_depth_bins=64, matching_feature_dims=16, model_num_views=8,
                 min_matching_depth=0.25, max_matching_depth=5.0, plane_chunk=16):
        super().__init__()
        self.min_depth, self.max_depth = min_matching_depth, max_matching_depth
        self.encoder = IMAGE_ENCODERS[image_encoder_name]()
        self.matching_model = ResnetMatchingEncoder(matching_feature_dims)
        self.cost_volume = HintFeatureVolume(matching_num_depth_bins, model_num_views - 1,
                                             matching_feature_dims, plane_chunk)
        enc_ch = list(self.encoder.feature_channels)
        cv_outs = (64, 128, 256, 384)
        self.cost_volume_net = CVEncoder(matching_num_depth_bins, enc_ch[1:], cv_outs)
        self.depth_decoder = DECODERS[depth_decoder_name](enc_ch[:1] + list(cv_outs))

    def forward(self, cur, src, hint, src_matching_feats=None):
        image = cur["image_bhw3"]
        src_T_cur = torch.einsum("bkij,bjl->bkil", src["cam_T_world_bk44"], cur["world_T_cam_b44"])
        cur_T_src = torch.einsum("bij,bkjl->bkil", cur["cam_T_world_b44"], src["world_T_cam_bk44"])
        feats = self.encoder.forward_nchw(to_nchw(image))
        b, k = src["world_T_cam_bk44"].shape[:2]
        if src_matching_feats is None:
            images = torch.cat([image[:, None], src["image_bkhw3"]], 1)
            allf = self.matching_model(images.reshape((b * (k + 1),) + images.shape[2:]))
            allf = allf.reshape((b, k + 1) + allf.shape[1:])
            match_cur, match_src = allf[:, 0], allf[:, 1:]
        else:
            match_cur, match_src = self.matching_model(image), src_matching_feats
        volume, _ = self.cost_volume(match_cur, match_src, src_T_cur, cur_T_src,
                                     src["K_s1_bk44"], cur["invK_s1_b44"], self.min_depth,
                                     self.max_depth, hint)
        cv_feats = self.cost_volume_net(volume, feats[1:])
        log_depth = self.depth_decoder(feats[:1] + cv_feats)["s0"]
        return {"depth_s0_bhw1": torch.exp(to_nhwc(log_depth)), "matching_feats_bhwc": match_cur}
