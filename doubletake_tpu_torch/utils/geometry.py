"""Camera geometry core: plain functions on tensors.

Same conventions as the JAX package (and its reference,
src/doubletake/utils/geometry_utils.py) — these decide checkpoint parity:
  * pixel centers at integer + 0.5 (geometry_utils.py:34-39);
  * homogeneous points as (..., 4, N) column stacks;
  * ``cam_T_world`` maps world -> camera ("extrinsics"); ``world_T_cam`` is
    the pose;
  * projection divides by (z + eps) with a |z| > eps guard
    (geometry_utils.py:86-91).

The depth-map filters (``gaussian_blur``, ``spatial_gradient``,
``normals_from_depth``) serve the training losses. The numpy rotations at
the end (``rotx``/``roty``/``rotz``, ``qvec2rotmat``)
serve the dataset readers' pose conventions on the host.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def pixel_grid_homogeneous(height: int, width: int, dtype=torch.float32, device=None):
    """(3, H*W) homogeneous pixel coords with +0.5 center offset, x-major rows.

    Row 0 is x (width index), row 1 is y (height index), row 2 ones.
    Flattening order matches a (H, W) raster scan.
    """
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=dtype, device=device),
        torch.arange(width, dtype=dtype, device=device),
        indexing="ij",
    )
    ones = torch.ones((height, width), dtype=dtype, device=device)
    return torch.stack([xs + 0.5, ys + 0.5, ones], dim=0).reshape(3, height * width)


def backproject_depth(depth_b1n, invK_b44, height: int, width: int):
    """Backproject per-pixel depths to homogeneous camera-space points.

    depth_b1n: (B, 1, H*W) or (B, 1, H, W); invK_b44: (B, 4, 4).
    Returns (B, 4, H*W).
    """
    if depth_b1n.dim() == 4:
        depth_b1n = depth_b1n.reshape(depth_b1n.shape[0], 1, -1)
    pix = pixel_grid_homogeneous(height, width, depth_b1n.dtype, depth_b1n.device)
    cam_b3n = torch.einsum("bij,jn->bin", invK_b44[:, :3, :3], pix)
    cam_b3n = depth_b1n * cam_b3n
    ones = torch.ones_like(cam_b3n[:, :1])
    return torch.cat([cam_b3n, ones], dim=1)


def project_points(points_b4n, K_b44, cam_T_world_b44, eps: float = 1e-8):
    """Project homogeneous world points into a camera.

    Returns (B, 3, N): pixel x, pixel y, and depth (z + eps). Behind-camera
    points keep their sign (scale = 1/(z+eps) when |z| > eps, else 1).
    """
    P_b44 = torch.matmul(K_b44, cam_T_world_b44)
    cam_b3n = torch.einsum("bij,bjn->bin", P_b44[:, :3], points_b4n)
    z_b1n = cam_b3n[:, 2:3] + eps
    mask = cam_b3n[:, 2:3].abs() > eps
    scale = torch.where(mask, 1.0 / z_b1n, torch.ones_like(z_b1n))
    xy_b2n = cam_b3n[:, :2] * scale
    return torch.cat([xy_b2n, z_b1n], dim=1)


def pose_distance(pose_b44):
    """DVMVS combined pose-distance measure (geometry_utils.py:187-199).

    Returns (combined, R_measure, t_measure), each (B,).
    """
    R_trace = pose_b44[:, :3, :3].diagonal(dim1=-2, dim2=-1).sum(-1)
    # clamp at 0: for identity rotations the argument is exactly 0 and
    # rounding can push it to -eps, turning sqrt into NaN
    R_measure = torch.sqrt(
        torch.clamp(2.0 * (1.0 - torch.clamp(R_trace, max=3.0) / 3.0), min=0.0)
    )
    t_measure = torch.linalg.norm(pose_b44[:, :3, 3], dim=-1)
    combined = torch.sqrt(t_measure**2 + R_measure**2)
    return combined, R_measure, t_measure


def normalize_vectors(v, dim: int, eps: float = 1e-12):
    """torch F.normalize semantics: v / max(||v||, eps)."""
    norm = torch.linalg.norm(v, dim=dim, keepdim=True)
    return v / torch.clamp(norm, min=eps)


_constants: dict = {}   # (key, device) -> tensor


def device_constant(key, build, device=None) -> torch.Tensor:
    """The tensor ``build()`` makes on the host, copied to ``device`` once
    and kept under ``(key, device)``: later calls reuse it and neither copy
    nor synchronise, so a CUDA graph can capture their callers. ``key``
    names every value ``build`` depends on. The tensor is shared by every
    caller: read it, never write to it."""
    device = torch.device("cpu" if device is None else device)
    t = _constants.get((key, device))
    if t is None:
        t = _constants[(key, device)] = build().to(device)
    return t


def linspace01(num: int, device=None) -> torch.Tensor:
    """[0, 1] in ``num`` float32 steps, rounded like the JAX package's
    ``jnp.linspace(0, 1, num)`` on the CPU: i * float32(1/(num-1)), the last
    exactly 1. (``torch.linspace`` rounds some steps the other way.) Built
    once per (num, device) (``device_constant``)."""

    def build():
        if num == 1:
            return torch.zeros(1, dtype=torch.float32)
        step = torch.tensor(1.0 / (num - 1), dtype=torch.float32)
        ramp = torch.arange(num, dtype=torch.float32) * step
        ramp[-1] = 1.0
        return ramp

    return device_constant(("linspace01", num), build, device)


def gaussian_kernel_1d(kernel_size: int, sigma: float, dtype=torch.float32, device=None):
    """kornia get_gaussian_kernel1d (normalised to sum 1), computed in
    float64 and rounded to float32 as the JAX package does."""
    x = np.arange(kernel_size, dtype=np.float64) - (kernel_size - 1) / 2.0
    g = np.exp(-(x**2) / (2.0 * sigma**2))
    k = torch.from_numpy((g / g.sum()).astype(np.float32))
    return k.to(device=device, dtype=dtype)


def _depthwise(x_nchw, kernel_2d):
    """Cross-correlate every channel with one (kh, kw) kernel, no padding."""
    c = x_nchw.shape[1]
    k = kernel_2d.to(x_nchw.dtype)[None, None].repeat(c, 1, 1, 1)
    return F.conv2d(x_nchw, k, groups=c)


def gaussian_blur(x_nhwc, kernel_size: int = 5, sigma: float = 2.0):
    """kornia gaussian_blur2d: separable blur with reflect padding, NHWC."""
    k = gaussian_kernel_1d(kernel_size, sigma, device=x_nhwc.device)
    pad = kernel_size // 2
    x = F.pad(x_nhwc.permute(0, 3, 1, 2), (0, 0, pad, pad), mode="reflect")
    x = _depthwise(x, k[:, None])
    x = _depthwise(F.pad(x, (pad, pad, 0, 0), mode="reflect"), k[None, :])
    return x.permute(0, 2, 3, 1)


_SOBEL_X = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]]) / 8.0


def spatial_gradient(x_nhwc):
    """kornia spatial_gradient (sobel, order 1, normalized=True): replicate
    padding, normalised sobel kernels. Returns (dx, dy), each NHWC."""
    xp = F.pad(x_nhwc.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate")
    sobel = _SOBEL_X.to(x_nhwc.device)
    return (_depthwise(xp, sobel).permute(0, 2, 3, 1),
            _depthwise(xp, sobel.t()).permute(0, 2, 3, 1))


def normals_from_depth(depth_bhw1, invK_b44, kernel_size: int = 5, sigma: float = 2.0):
    """Normals of a depth map (geometry_utils.py:96-142): Gaussian-smooth the
    depth, backproject, take the spatial gradients of the 3D points, cross
    them and normalise. Returns (B, H, W, 3)."""
    b, h, w, _ = depth_bhw1.shape
    smooth = gaussian_blur(depth_bhw1, kernel_size, sigma)
    pts_b4n = backproject_depth(smooth.reshape(b, 1, -1), invK_b44, h, w)
    pts_bhw3 = pts_b4n[:, :3].reshape(b, 3, h, w).permute(0, 2, 3, 1)
    gx, gy = spatial_gradient(pts_bhw3)
    return normalize_vectors(torch.linalg.cross(gx, gy, dim=-1), -1)


def rotx(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def roty(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def rotz(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def qvec2rotmat(q):
    """COLMAP-convention quaternion (w, x, y, z) to rotation matrix."""
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * y**2 - 2 * z**2, 2 * x * y - 2 * w * z, 2 * z * x + 2 * w * y],
            [2 * x * y + 2 * w * z, 1 - 2 * x**2 - 2 * z**2, 2 * y * z - 2 * w * x],
            [2 * z * x - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x**2 - 2 * y**2],
        ]
    )
