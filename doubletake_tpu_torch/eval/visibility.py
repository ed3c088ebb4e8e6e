"""Visibility (occupancy) volumes for mesh-eval occlusion masking.

Counterpart of ``doubletake_tpu/eval/visibility.py`` (reference
utils/volume_utils.py, SimpleVolume + VisibilityAggregator): a dense 0/1
volume over the scene in which voxels in front of a frame's GT depth plus a
0.3 m buffer are marked visible (:253-314); sampling has align_corners=True
semantics (:185-237). Plain torch on the volume's device, as the JAX package
runs it in XLA; ``save`` and ``load`` use the JAX package's npz format.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from doubletake_tpu_torch.ops.grid_sample import grid_sample_2d, grid_sample_3d

VISIBILITY_BUFFER_M = 0.3  # volume_utils.py behavior: surface + 0.3 m


@dataclasses.dataclass
class SimpleVolume:
    """values: (X, Y, Z) float32 occupancy in [0, 1]; origin: (3,) world
    min corner."""

    values: torch.Tensor
    origin: torch.Tensor
    voxel_size: float

    @classmethod
    def from_bounds(cls, bounds: dict, voxel_size: float, device="cpu"):
        dims = []
        for axis in ("x", "y", "z"):
            extent = bounds[f"{axis}max"] - bounds[f"{axis}min"]
            dims.append(max(1, int(np.ceil(extent / voxel_size))))
        origin = torch.tensor([bounds["xmin"], bounds["ymin"], bounds["zmin"]],
                              dtype=torch.float32, device=device)
        return cls(values=torch.zeros(dims, dtype=torch.float32, device=device),
                   origin=origin, voxel_size=voxel_size)

    def sample(self, world_points_n3, method="bilinear"):
        """The volume at (N, 3) world points (numpy or torch), (N,) on the
        volume's device; zeros outside."""
        pts = torch.as_tensor(world_points_n3, dtype=torch.float32, device=self.values.device)
        vox = (pts - self.origin) / self.voxel_size
        dims = torch.tensor(self.values.shape, dtype=torch.float32, device=pts.device)
        grid = (vox / (dims - 1.0)) * 2.0 - 1.0
        return grid_sample_3d(self.values[..., None], grid, mode=method)[:, 0]

    def save(self, path):
        np.savez_compressed(
            path,
            values=self.values.detach().cpu().numpy().astype(np.float16),
            origin=self.origin.detach().cpu().numpy().astype(np.float32),
            voxel_size=self.voxel_size,
        )

    @classmethod
    def load(cls, path, device="cpu"):
        data = np.load(path)
        return cls(values=torch.as_tensor(data["values"].astype(np.float32), device=device),
                   origin=torch.as_tensor(data["origin"].astype(np.float32), device=device),
                   voxel_size=float(data["voxel_size"]))


def integrate_visibility(volume: SimpleVolume, depth_hw1, cam_T_world_44, K_44,
                         buffer_m: float = VISIBILITY_BUFFER_M) -> SimpleVolume:
    """Mark the voxels visible in this frame (inside the image, in front of
    the camera, closer than the GT depth + buffer) in place; returns the
    volume. The depth is sampled at each voxel's nearest pixel."""
    h, w = depth_hw1.shape[:2]
    X, Y, Z = volume.values.shape
    dev = volume.values.device
    f32 = torch.float32
    vs = torch.full((), volume.voxel_size, dtype=f32, device=dev)
    cx = (volume.origin[0] + torch.arange(X, dtype=f32, device=dev) * vs).view(X, 1, 1)
    cy = (volume.origin[1] + torch.arange(Y, dtype=f32, device=dev) * vs).view(1, Y, 1)
    cz = (volume.origin[2] + torch.arange(Z, dtype=f32, device=dev) * vs).view(1, 1, Z)
    # the projection elementwise, in float32 on any device (no TF32 matmul)
    P = torch.matmul(K_44.double(), cam_T_world_44.double())[:3].to(f32)
    cam = [(P[i, 0] * cx + P[i, 1] * cy + P[i, 2] * cz + P[i, 3]).reshape(-1) for i in range(3)]
    z = cam[2]
    zs = torch.where(z.abs() > 1e-8, z, torch.full_like(z, 1e-8))
    gx = 2.0 * (cam[0] / zs) / w - 1.0
    gy = 2.0 * (cam[1] / zs) / h - 1.0
    depth = torch.where(torch.isfinite(depth_hw1), depth_hw1, torch.zeros_like(depth_hw1))
    grid = torch.stack([gx, gy], -1)[None, :, None]
    sampled = grid_sample_2d(depth[None], grid, mode="nearest")[0, :, 0, 0]

    inb = (gx > -1) & (gx < 1) & (gy > -1) & (gy < 1)
    visible = inb & (z > 0) & (sampled > 0) & (z < sampled + buffer_m)
    volume.values = torch.maximum(volume.values, visible.reshape(X, Y, Z).to(f32))
    return volume
