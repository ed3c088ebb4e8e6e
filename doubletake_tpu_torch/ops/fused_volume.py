"""Fused plane-sweep feature volume: the CUDA kernel ``csrc/fused_volume.cu``
and its plain version.

``fused_feature_volume`` is the port of the Pallas TPU kernel
``doubletake_tpu/ops/pallas/fused_volume.py``. On a CUDA tensor it launches
the kernel, or raises; on a CPU tensor it runs ``feature_volume_plain``.

``feature_volume_plain`` is the JAX package's XLA path of ``FeatureVolume``
(``doubletake_tpu/models/cost_volume.py``:252-326): planes in chunks,
projection with the ``|z| > 1e-8`` guard, the bilinear warp as
``F.grid_sample``, the metadata channels in the checkpoint's order, the
matching MLP and the hint MLP. The port's ``FeatureVolume`` uses it as its
non-kernel path, so the kernel and the module share one oracle.

Both take the geometry already set up (``volume_geometry``): the projection
rows P = src_K @ src_T_cur, the current view's unit-depth rays, the source
camera centres and the pose-distance metadata.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from doubletake_tpu_torch.ops.build import load_kernel
from doubletake_tpu_torch.ops.grid_sample import grid_sample_2d
from doubletake_tpu_torch.utils.geometry import (
    normalize_vectors,
    pixel_grid_homogeneous,
    pose_distance,
)

CHANNELS = 16      # matching feature channels the kernel takes
HIDDEN = 128       # matching MLP width the kernel takes
MAX_VIEWS = 8      # most source views the kernel takes


def mlp_in_channels(num_views: int, channels: int) -> int:
    """Metadata width: k*c + c + mask k + depth k + plane 1 + dot k +
    angle k + rays 3(1+k) + pose 3k (202 at k = 7, c = 16)."""
    return num_views * channels + channels + 10 * num_views + 4


def volume_geometry(src_K_bk44, src_cam_T_cur_cam_bk44, cur_cam_T_src_cam_bk44,
                    cur_invK_b44, h: int, w: int):
    """(P_bk34, rays_b3n, centers_bk3, pose_meta_b3k) for a matching grid h x w."""
    b, k = src_K_bk44.shape[:2]
    P_bk34 = torch.matmul(src_K_bk44, src_cam_T_cur_cam_bk44)[:, :, :3, :].contiguous()
    pix = pixel_grid_homogeneous(h, w, torch.float32, src_K_bk44.device)
    rays_b3n = torch.einsum("bij,jn->bin", cur_invK_b44[:, :3, :3], pix).contiguous()
    # the reference passes cur_cam_T_src_cam as the source poses
    pd, rm, tm = pose_distance(cur_cam_T_src_cam_bk44.reshape(b * k, 4, 4))
    pose_meta_b3k = torch.cat([pd.reshape(b, k), rm.reshape(b, k), tm.reshape(b, k)], -1)
    centers_bk3 = cur_cam_T_src_cam_bk44[:, :, :3, 3].contiguous()
    return P_bk34, rays_b3n, centers_bk3, pose_meta_b3k.contiguous()


def _mlp(layers, x):
    for i, (wgt, bias) in enumerate(layers):
        x = F.linear(x, wgt, bias)
        if i < len(layers) - 1:
            x = F.leaky_relu(x, 0.01)
    return x


def feature_volume_plain(cur_feats_bhwc, src_feats_bkhwc, P_bk34, rays_b3n, centers_bk3,
                         pose_meta_b3k, planes_d, mlp, hint_mlp=None, hint_bhw3=None,
                         plane_chunk: int = 16):
    """(B, D, h, w) scores. ``mlp``/``hint_mlp``: [(weight, bias)] per Linear,
    torch layout; ``hint_bhw3``: [depth, valid 0/1, weight], the depth finite
    where valid (elsewhere it is never used)."""
    b, h, w, c = cur_feats_bhwc.shape
    k = src_feats_bkhwc.shape[1]
    n = h * w
    dtype = cur_feats_bhwc.dtype
    cur_n = cur_feats_bhwc.reshape(b, n, c)
    src_flat = src_feats_bkhwc.reshape(b * k, h, w, c)
    if hint_mlp is not None:
        hd, hv, hw = hint_bhw3.reshape(b, n, 3).unbind(-1)
        hvalid = hv > 0.5

    chunks = []
    for s in range(0, planes_d.shape[0], plane_chunk):
        planes_c = planes_d[s:s + plane_chunk]
        dc = planes_c.shape[0]
        pts = planes_c[None, :, None, None] * rays_b3n[:, None]            # (B, Dc, 3, N)
        cam = (torch.einsum("bkij,bdjn->bkdin", P_bk34[..., :3], pts)
               + P_bk34[..., 3][:, :, None, :, None])                      # (B, k, Dc, 3, N)
        z = cam[:, :, :, 2] + 1e-8
        scale = torch.where(cam[:, :, :, 2].abs() > 1e-8, 1.0 / z, torch.ones_like(z))
        gx = 2.0 * (cam[:, :, :, 0] * scale) / w - 1.0
        gy = 2.0 * (cam[:, :, :, 1] * scale) / h - 1.0
        grid = torch.stack([gx, gy], -1).reshape(b * k, dc * h, w, 2)
        warped = grid_sample_2d(src_flat, grid).reshape(b, k, dc, n, c)
        mask = (z > 0).to(dtype)                                            # (B, k, Dc, N)
        dot = (warped * cur_n[:, None, None]).sum(-1) * mask

        cur_rays = normalize_vectors(pts, 2)                                # (B, Dc, 3, N)
        src_rays = normalize_vectors(pts[:, None] - centers_bk3[:, :, None, :, None], 3)
        angle = (cur_rays[:, None] * src_rays).sum(3)                      # (B, k, Dc, N)

        def per_view(x):  # (B, k, Dc, N) -> (B, Dc, N, k)
            return x.permute(0, 2, 3, 1)

        rays_all = torch.cat([cur_rays[:, None], src_rays], 1)              # (B, 1+k, Dc, 3, N)
        x = torch.cat([
            warped.permute(0, 2, 3, 1, 4).reshape(b, dc, n, k * c),
            cur_n[:, None].expand(b, dc, n, c),
            per_view(mask),
            per_view(z),
            planes_c[None, :, None, None].expand(b, dc, n, 1).to(dtype),
            per_view(dot),
            per_view(angle),
            rays_all.permute(0, 2, 4, 1, 3).reshape(b, dc, n, (1 + k) * 3),
            pose_meta_b3k[:, None, None].expand(b, dc, n, 3 * k).to(dtype),
        ], -1)
        score = _mlp(mlp, x)[..., 0]                                        # (B, Dc, N)

        if hint_mlp is not None:
            diff = torch.where(hvalid[:, None], (hd[:, None] - planes_c[None, :, None]).abs(),
                               torch.full((), -1.0, dtype=dtype, device=hd.device))
            wts = torch.where(hvalid, hw, torch.zeros_like(hw))[:, None].expand(b, dc, n)
            score = _mlp(hint_mlp, torch.stack([score, diff, wts], -1))[..., 0]
        chunks.append(score)
    return torch.cat(chunks, 1).reshape(b, -1, h, w)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None else ctypes.c_void_p(0)


def fused_feature_volume(cur_feats_bhwc, src_feats_bkhwc, P_bk34, rays_b3n, centers_bk3,
                         pose_meta_b3k, planes_d, mlp, hint_mlp=None, hint_bhw3=None,
                         plane_chunk: int = 16):
    """(B, D, h, w) scores through the kernel (CUDA) or the plain version (CPU).

    Same arguments as ``feature_volume_plain``. A hint may be given with
    non-finite depths: they are zeroed first, on both paths. With a hint
    MLP and no hint, the hint is all invalid.
    """
    b, h, w, c = cur_feats_bhwc.shape
    k = src_feats_bkhwc.shape[1]
    if hint_mlp is not None:
        if hint_bhw3 is None:
            hint_bhw3 = cur_feats_bhwc.new_zeros((b, h, w, 3))
        hint_bhw3 = torch.nan_to_num(hint_bhw3, nan=0.0, posinf=0.0, neginf=0.0)
    else:
        hint_bhw3 = None
    args = (cur_feats_bhwc, src_feats_bkhwc, P_bk34, rays_b3n, centers_bk3,
            pose_meta_b3k, planes_d, mlp, hint_mlp, hint_bhw3)
    if not cur_feats_bhwc.is_cuda:
        return feature_volume_plain(*args, plane_chunk=plane_chunk)

    d = planes_d.shape[0]
    nin = mlp_in_channels(k, c)
    (w1, b1), (w2, b2), (w3, b3) = mlp
    if c != CHANNELS or not 1 <= k <= MAX_VIEWS:
        raise ValueError(f"fused volume kernel takes {CHANNELS} channels and 1..{MAX_VIEWS} "
                         f"source views, got c={c}, k={k}")
    if (w1.shape != (HIDDEN, nin) or w2.shape != (HIDDEN, HIDDEN) or w3.shape != (1, HIDDEN)):
        raise ValueError(f"fused volume kernel takes an MLP [{nin}, {HIDDEN}, {HIDDEN}, 1]")
    if hint_mlp is not None:
        (h1, _), (h2, _), (h3, _) = hint_mlp
        if h1.shape != (12, 3) or h2.shape != (12, 12) or h3.shape != (1, 12):
            raise ValueError("fused volume kernel takes a hint MLP [3, 12, 12, 1]")
    expect = {
        "cur_feats": (cur_feats_bhwc, (b, h, w, c)),
        "src_feats": (src_feats_bkhwc, (b, k, h, w, c)),
        "P": (P_bk34, (b, k, 3, 4)),
        "rays": (rays_b3n, (b, 3, h * w)),
        "centers": (centers_bk3, (b, k, 3)),
        "pose_meta": (pose_meta_b3k, (b, 3 * k)),
        "planes": (planes_d, (d,)),
        "hint": (hint_bhw3, (b, h, w, 3)),
    }
    dev = cur_feats_bhwc.device
    for name, (t, shape) in expect.items():
        if t is None:
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_feature_volume: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"fused_feature_volume: {name} must be contiguous float32 on {dev}")

    weights = [w1.t(), b1, w2.t(), b2, w3.reshape(-1), b3]
    if hint_mlp is not None:
        (hw1, hb1), (hw2, hb2), (hw3, hb3) = hint_mlp
        weights += [hw1.t(), hb1, hw2.t(), hb2, hw3.reshape(-1), hb3]
    else:
        weights += [None] * 6
    weights = [None if t is None else t.detach().to(dev, torch.float32).contiguous()
               for t in weights]

    out = torch.empty((b, d, h, w), dtype=torch.float32, device=dev)
    lib = load_kernel("fused_volume")
    fn = lib.fused_volume_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(_ptr(cur_feats_bhwc), _ptr(src_feats_bkhwc), _ptr(rays_b3n), _ptr(P_bk34),
             _ptr(centers_bk3), _ptr(pose_meta_b3k), _ptr(planes_d), _ptr(hint_bhw3),
             *[_ptr(t) for t in weights], _ptr(out), b, k, h, w, d, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"fused volume kernel launch failed: cudaError {err}")
    fused_feature_volume.launches += 1
    return out


fused_feature_volume.launches = 0
