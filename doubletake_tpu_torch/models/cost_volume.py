"""Plane-sweep feature volumes (torch.nn; NHWC at the interface).

Counterparts of ``doubletake_tpu.models.cost_volume``:
  * simple dot-product cost volume (reference:
    src/doubletake/modules/cost_volume.py) — plain torch, as the JAX
    package has no kernel for it;
  * metadata "feature volume" — per-plane warped features + geometric
    metadata (202 channels at 7 views) reduced by an MLP [202, 128, 128, 1]
    (reference: src/doubletake/modules/feature_volume.py);
  * mesh-hint volume — feature volume + a hint MLP [3, 12, 12, 1] mixing
    the plane-sweep score with |hint_depth - plane_depth| and the sampled
    TSDF confidence (reference: src/doubletake/modules/mesh_hint_volume.py).

Scores come from ``ops.fused_volume``: the CUDA kernel when the module is
built with ``fast_cost_volume``, is in eval mode and gets CUDA tensors (the
JAX package's Pallas gate, cost_volume.py:235-250); otherwise the plain
chunked path, which is the JAX XLA path. Training always takes the plain
path (the kernel has no backward, as the Pallas kernel has no VJP).

The volume runs in the features' type. With bf16 features the kernel's
bf16 mode gives float32 scores that are cast to bf16, as the JAX fast path
casts them (cost_volume.py:388); the plain path's scores stay float32, as
the XLA path's do (its metadata concatenates float32 depths, so its MLP
computes in float32).

Metadata channel order (the checkpoint MLP depends on it):
  [src_feats (k*c), cur_feats (c), mask (k), src depths (k), plane depth (1),
   dot (k), ray angle (k), rays ((1+k)*3, cur first), pose dist (k),
   R measure (k), t measure (k)]
"""

from __future__ import annotations

import torch
import torch.nn as nn

from doubletake_tpu_torch.models.layers import MLP
from doubletake_tpu_torch.ops.fused_volume import (
    feature_volume_plain,
    fused_feature_volume,
    mlp_in_channels,
    volume_geometry,
    warp_planes,
)
from doubletake_tpu_torch.ops.resize import interpolate_nearest
from doubletake_tpu_torch.utils.geometry import device_constant, linspace01


def generate_depth_planes(min_depth: float, max_depth: float, num_planes: int, device=None):
    """Log-spaced depth planes (reference cost_volume.py:96-130), computed
    on the host and copied once per (planes, device) (``device_constant``)."""

    def build():
        lo = torch.log(torch.tensor(min_depth, dtype=torch.float32))
        span = torch.log(torch.tensor(max_depth / min_depth, dtype=torch.float32))
        return torch.exp(lo + span * linspace01(num_planes))

    return device_constant(("depth_planes", min_depth, max_depth, num_planes), build, device)


def _border_mask(px, py, h, w):
    """2-px border validity (reference cost_volume.py:73-94)."""
    return (px > 2) & (px < w - 2) & (py > 2) & (py < h - 2)


class CostVolumeDot(nn.Module):
    """Masked dot-product cost volume summed over views
    (simple_cost_volume): per plane, each source view's warped features
    dotted with the current features where its projected depth is
    positive. No parameters; the hint and the mask are not used (the 4th
    output is None, as in the JAX package)."""

    def __init__(self, num_depth_bins: int = 64, plane_chunk: int = 16, **_):
        super().__init__()
        self.num_depth_bins = num_depth_bins
        self.plane_chunk = plane_chunk

    def forward(self, cur_feats_bhwc, src_feats_bkhwc, src_cam_T_cur_cam_bk44,
                cur_cam_T_src_cam_bk44, src_K_bk44, cur_invK_b44, min_depth,
                max_depth, hint=None, return_mask: bool = False):
        b, h, w, c = cur_feats_bhwc.shape
        dtype = cur_feats_bhwc.dtype
        planes_d = generate_depth_planes(min_depth, max_depth, self.num_depth_bins,
                                         cur_feats_bhwc.device)
        P_bk34, rays_b3n, _, _ = volume_geometry(
            src_K_bk44, src_cam_T_cur_cam_bk44, cur_cam_T_src_cam_bk44, cur_invK_b44, h, w,
            dtype)
        cur_n = cur_feats_bhwc.reshape(b, 1, 1, h * w, c).float()
        chunks = []
        for s in range(0, self.num_depth_bins, self.plane_chunk):
            warped, z, _ = warp_planes(src_feats_bkhwc, P_bk34, rays_b3n,
                                       planes_d[s:s + self.plane_chunk])
            dot = (warped.float() * cur_n).sum(-1).to(dtype) * (z > 0).to(dtype)
            chunks.append(dot.sum(1))                                   # (B, Dc, N)
        volume_bdhw = torch.cat(chunks, 1).reshape(b, -1, h, w)
        return (volume_bdhw.permute(0, 2, 3, 1), planes_d[volume_bdhw.argmax(1)], planes_d,
                None)


class FeatureVolume(nn.Module):
    """Metadata MLP feature volume (mlp_feature_volume); (B, H, W, D) scores."""

    def __init__(self, num_depth_bins: int = 64, num_views: int = 7,
                 matching_feature_dims: int = 16, mlp_hidden: int = 128,
                 plane_chunk: int = 16, use_hint_mlp: bool = False,
                 fast_cost_volume: bool = False):
        super().__init__()
        self.num_depth_bins = num_depth_bins
        self.plane_chunk = plane_chunk
        self.fast_cost_volume = fast_cost_volume
        nin = mlp_in_channels(num_views, matching_feature_dims)
        self.mlp = MLP((nin, mlp_hidden, mlp_hidden, 1))
        self.hint_mlp = MLP((3, 12, 12, 1)) if use_hint_mlp else None

    @staticmethod
    def _layers(mlp):
        return None if mlp is None else [(l.weight, l.bias) for l in mlp.linears()]

    def forward(self, cur_feats_bhwc, src_feats_bkhwc, src_cam_T_cur_cam_bk44,
                cur_cam_T_src_cam_bk44, src_K_bk44, cur_invK_b44, min_depth,
                max_depth, hint=None, return_mask: bool = False):
        """hint (hint MLP only): dict with "depth_hint_bhw1" (any resolution,
        nearest-resized here), "hint_mask_bhw1" (bool) and
        "sampled_weights_bhw1". An all-invalid hint resizes to the same
        zeros from any size, and callers rely on it: the offline runner's
        pass 1 makes its empty hint at pass 2's hint size, so one graph
        serves both passes. Returns (volume_bhwd, lowest_cost_bhw,
        planes_d, overall_mask_bhw)."""
        b, h, w, _ = cur_feats_bhwc.shape
        dev, dtype = cur_feats_bhwc.device, cur_feats_bhwc.dtype
        planes_d = generate_depth_planes(min_depth, max_depth, self.num_depth_bins, dev)
        P_bk34, rays_b3n, centers_bk3, pose_meta_b3k = volume_geometry(
            src_K_bk44, src_cam_T_cur_cam_bk44, cur_cam_T_src_cam_bk44, cur_invK_b44, h, w,
            dtype)

        hint_bhw3 = None
        if self.hint_mlp is not None:
            depth = interpolate_nearest(hint["depth_hint_bhw1"], (h, w))[..., 0]
            valid = interpolate_nearest(hint["hint_mask_bhw1"].float(), (h, w))[..., 0] != 0
            wts = interpolate_nearest(hint["sampled_weights_bhw1"], (h, w))[..., 0]
            wts = torch.where(valid, wts, torch.zeros_like(wts)).to(dtype)
            # invalid hint depths are NaN: the plain path selects -1 for them
            # (as the XLA path does) and the kernel's wrapper zeroes them
            hint_bhw3 = torch.stack([depth.float(), valid.float(), wts.float()], -1)

        fast = self.fast_cost_volume and not self.training
        volume = fused_feature_volume if fast else feature_volume_plain
        volume_bdhw = volume(
            cur_feats_bhwc.contiguous(), src_feats_bkhwc.contiguous(), P_bk34, rays_b3n,
            centers_bk3, pose_meta_b3k, planes_d, self._layers(self.mlp),
            self._layers(self.hint_mlp), hint_bhw3, plane_chunk=self.plane_chunk)
        if fast:
            volume_bdhw = volume_bdhw.to(dtype)

        volume_bhwd = volume_bdhw.permute(0, 2, 3, 1)
        lowest_cost_bhw = planes_d[volume_bdhw.argmax(1)]

        overall_mask_bhw = None
        if return_mask:
            # validity at the LAST plane (feature_volume.py:709-713): any view
            # with positive projected depth inside the 2px border
            pts = planes_d[-1] * rays_b3n                                       # (B, 3, N)
            cam = torch.einsum("bkij,bjn->bkin", P_bk34[..., :3], pts) + P_bk34[..., 3, None]
            z = cam[:, :, 2] + 1e-8
            scale = torch.where(cam[:, :, 2].abs() > 1e-8, 1.0 / z, torch.ones_like(z))
            ok = _border_mask(cam[:, :, 0] * scale, cam[:, :, 1] * scale, h, w) & (z > 0)
            overall_mask_bhw = ok.any(1).reshape(b, h, w)
        return volume_bhwd, lowest_cost_bhw, planes_d, overall_mask_bhw


class FeatureMeshHintVolume(FeatureVolume):
    """Feature volume + hint MLP (mlp_mesh_hint_feature_volume)."""

    def __init__(self, **kwargs):
        kwargs.setdefault("use_hint_mlp", True)
        super().__init__(**kwargs)


def get_volume_class(feature_volume_type: str):
    classes = {
        "simple_cost_volume": CostVolumeDot,
        "mlp_feature_volume": FeatureVolume,
        "mlp_mesh_hint_feature_volume": FeatureMeshHintVolume,
    }
    if feature_volume_type not in classes:
        raise ValueError(f"Unknown feature volume: {feature_volume_type}")
    return classes[feature_volume_type]
