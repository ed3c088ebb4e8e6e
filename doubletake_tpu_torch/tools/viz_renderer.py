"""Scene-visualisation renderer: shaded TSDF views, the birdseye camera and
camera markers.

Counterpart of ``doubletake_tpu/tools/viz_renderer.py`` (in place of the
reference's pyrender/EGL mesh renderer, mesh_renderer.py:31-467): a view is
rendered by raycasting the TSDF (``tools.tsdf.raycast``): depth from the
first zero crossing, normals from the TSDF's central differences
(``sample_tsdf``), albedo from the fused colours when the volume has them.
Also the trajectory helpers: ``SmoothBirdsEyeCamera`` (:161-252), the
look-at pose, and camera frustum markers projected and drawn as lines
(:282-467). Every image returned is a writable numpy array.
"""

from __future__ import annotations

import numpy as np
import torch

from doubletake_tpu_torch.tools.tsdf import TSDF, raycast, sample_tsdf


def render_tsdf_view(tsdf: TSDF, world_T_cam_44, invK_44, height: int, width: int,
                     min_depth: float = 0.05, max_depth: float = 30.0,
                     num_samples: int = 384, light_dir=None, background: float = 1.0):
    """Render (rgb (H, W, 3) in [0, 1], depth (H, W), NaN where no surface)
    of the TSDF from any camera: Lambert shading of the TSDF-gradient
    normals under a headlight (half and half with ``light_dir`` when
    given), times the fused voxel colours when the volume carries them."""
    dev = tsdf.values.device
    world_T_cam = torch.as_tensor(np.asarray(world_T_cam_44, np.float32), device=dev)
    invK = torch.as_tensor(np.asarray(invK_44, np.float32), device=dev)
    depth, _, valid = raycast(tsdf, world_T_cam, invK, height, width, min_depth=min_depth,
                              max_depth=max_depth, num_samples=num_samples)

    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=dev),
                            torch.arange(width, dtype=torch.float32, device=dev), indexing="ij")
    pix = torch.stack([xs + 0.5, ys + 0.5, torch.ones_like(xs)], 0).reshape(3, -1)
    rays_w = (world_T_cam[:3, :3] @ (invK[:3, :3] @ pix)).T                    # (N, 3)
    d = torch.where(valid, depth, torch.full_like(depth, max_depth)).reshape(-1, 1)
    pts = world_T_cam[:3, 3] + rays_w * d

    # normals from the TSDF gradient (central differences, half a voxel)
    eps = 0.5 * tsdf.voxel_size
    grads = []
    for ax in range(3):
        off = torch.zeros((1, 3), device=dev)
        off[0, ax] = eps
        grads.append(sample_tsdf(tsdf, pts + off) - sample_tsdf(tsdf, pts - off))
    n = torch.stack(grads, -1)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-9)

    view = rays_w / torch.clamp(torch.linalg.norm(rays_w, dim=-1, keepdim=True), min=1e-9)
    shade = 0.25 + 0.75 * torch.clamp(-(n * view).sum(-1), 0.0, 1.0)
    if light_dir is not None:
        ld = torch.as_tensor(np.asarray(light_dir, np.float32), device=dev)
        ld = ld / torch.linalg.norm(ld)
        shade = 0.5 * shade + 0.5 * torch.clamp(-(n * ld).sum(-1), 0.0, 1.0)

    if tsdf.colors is not None:
        albedo = torch.clamp(sample_tsdf(tsdf, pts, what="colors"), 0.0, 1.0)
    else:
        albedo = torch.full((pts.shape[0], 3), 0.85, device=dev)
    rgb = albedo * shade[:, None]
    rgb = torch.where(valid.reshape(-1, 1), rgb, torch.full_like(rgb, background))
    return (rgb.reshape(height, width, 3).cpu().numpy(),
            torch.where(valid, depth, torch.full_like(depth, float("nan"))).cpu().numpy())


def get_cam_pose_from_lookat_and_loc(cam_location, look_at_vec, up=(0.0, 0.0, 1.0)):
    """world_T_cam from a location and a look-at direction (renderer
    :470-500; ScanNet convention, z up)."""
    z = np.asarray(look_at_vec, np.float64)
    z = z / np.linalg.norm(z)
    up = np.asarray(up, np.float64)
    x = np.cross(z, up)
    if np.linalg.norm(x) < 1e-6:
        x = np.array([1.0, 0.0, 0.0])
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    T = np.eye(4, dtype=np.float32)
    T[:3, 0], T[:3, 1], T[:3, 2] = x, y, z
    T[:3, 3] = cam_location
    return T


class SmoothBirdsEyeCamera:
    """A smoothed birdseye camera that follows the live camera and the scene
    centroid (reference mesh_renderer.py:161-252; ScanNet convention, z
    up)."""

    def __init__(self, look_at_moving_alpha=0.9, mean_mesh_moving_alpha=(0.8, 0.8, 0.8)):
        self.current_mean_loc = None
        self.fpv_cam_look_at = None
        self.look_at_moving_alpha = look_at_moving_alpha
        self.mean_mesh_moving_alpha = np.asarray(mean_mesh_moving_alpha)

    def get_bird_eye_trans(self, scene_points=None, fpv_pose=None, z_offset=6.0,
                           backwards_offset=7.0):
        """The birdseye world_T_cam for a live camera ``fpv_pose``
        (world_T_cam) over ``scene_points`` ((N, 3) observed scene points)."""
        if scene_points is not None and len(scene_points):
            mean_loc = np.asarray(scene_points).mean(0)
            mean_loc = (mean_loc + fpv_pose[:3, 3] * 5) / 6.0
        else:
            mean_loc = fpv_pose[:3, 3].copy()
        if self.current_mean_loc is None:
            self.current_mean_loc = mean_loc
        else:
            self.current_mean_loc = (self.mean_mesh_moving_alpha * self.current_mean_loc
                                     + (1 - self.mean_mesh_moving_alpha) * mean_loc)

        # the live camera's look direction (ScanNet: camera -y is forward, world z up)
        current_look = np.linalg.inv(fpv_pose[:3, :3]) @ np.array([0.0, -1.0, 0.0])
        if self.fpv_cam_look_at is None:
            self.fpv_cam_look_at = current_look
        else:
            self.fpv_cam_look_at = 0.05 * current_look + 0.95 * self.fpv_cam_look_at
            self.fpv_cam_look_at /= np.linalg.norm(self.fpv_cam_look_at)

        offset_vec = self.fpv_cam_look_at / np.linalg.norm(self.fpv_cam_look_at[:2])
        loc = self.current_mean_loc - offset_vec * backwards_offset
        loc[2] = self.current_mean_loc[2] + z_offset
        look_at = self.current_mean_loc - loc
        look_at /= np.linalg.norm(look_at)
        return get_cam_pose_from_lookat_and_loc(loc, look_at)


def observed_voxel_points(tsdf: TSDF, threshold: float = 0.01, max_points: int = 20000):
    """World positions of observed voxels (weight above ``threshold``), at
    most about ``max_points``: the birdseye camera's scene centroid."""
    idx = np.argwhere(tsdf.weights.cpu().numpy() > threshold)
    if len(idx) == 0:
        return np.zeros((0, 3), np.float32)
    if len(idx) > max_points:
        idx = idx[:: len(idx) // max_points + 1]
    return tsdf.origin.cpu().numpy()[None] + idx * tsdf.voxel_size


def _draw_line(img, p0, p1, color):
    h, w = img.shape[:2]
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1)) + 1
    xs = np.linspace(p0[0], p1[0], n)
    ys = np.linspace(p0[1], p1[1], n)
    ok = (xs >= 0) & (xs < w - 1) & (ys >= 0) & (ys < h - 1)
    xi, yi = xs[ok].astype(int), ys[ok].astype(int)
    img[yi, xi] = color
    img[yi + 1, xi] = color
    img[yi, xi + 1] = color


def draw_camera_marker(img_hw3, marker_world_T_cam, view_cam_T_world, K_44,
                       scale: float = 0.3, color=(0.9, 0.1, 0.1)):
    """Draw a camera frustum wireframe into a rendered view, in place, and
    return it; unchanged when a corner is not in front of the view (the
    reference's pyrender camera_marker geometry, :282-467)."""
    s = scale
    pts_cam = np.array([[0, 0, 0], [-s, -0.75 * s, s], [s, -0.75 * s, s],
                        [s, 0.75 * s, s], [-s, 0.75 * s, s]])
    pts_w = (marker_world_T_cam[:3, :3] @ pts_cam.T).T + marker_world_T_cam[:3, 3]
    cam = (view_cam_T_world[:3, :3] @ pts_w.T).T + view_cam_T_world[:3, 3]
    z = cam[:, 2]
    if (z <= 0.05).any():
        return img_hw3
    px = (K_44[:2, :2] @ (cam[:, :2] / z[:, None]).T).T + K_44[:2, 2]
    for a, b in [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]:
        _draw_line(img_hw3, px[a], px[b], np.asarray(color))
    return img_hw3
