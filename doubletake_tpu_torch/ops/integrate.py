"""TSDF integrate: the CUDA kernel ``csrc/integrate.cu`` and its plain version.

``fused_integrate`` is the port of the Pallas TPU kernel
``doubletake_tpu/ops/pallas/integrate.py``: one fusion step that updates a
volume's values and weights IN PLACE (the JAX runner donates the volume to
the step, so nothing else holds the old one). On a CUDA tensor it launches
the kernel, or raises; on a CPU tensor it runs ``integrate_plain`` and
copies the result into the volume.

``integrate_plain`` is the dense ``_voxel_update`` math of
``doubletake_tpu/tools/tsdf.py`` (:135-221), written elementwise in the
kernel's operation order — the projection as p0*cx + p1*cy + p2*cz + p3, not
a matmul; every divisor a tensor, so no op is turned into a multiplication
by a reciprocal — so that kernel and plain version agree bit for bit on the
card. ``voxel_update_plain`` is the same step returning also the per-voxel
terms (validity, sampled pixel, weights) that the colour update of
``tools.tsdf.integrate_depth`` reuses, so a coloured volume's values and
weights come out of this very arithmetic.

Each warp of the kernel owns a box of ``BOX`` voxels and skips it when its 8
corners prove that none of its voxels can update (beyond ``max_depth``, or
in front of the camera and projecting outside the image).
``block_cull_plain`` is that predicate in plain torch, for the tests: no
voxel that ``integrate_plain`` updates may lie in a box it skips.
"""

from __future__ import annotations

import ctypes

import torch

from doubletake_tpu_torch.ops.build import load_kernel
from doubletake_tpu_torch.utils import tracing

BOX = (8, 1, 32)     # voxels of one warp's box, (x, y, z) (csrc/integrate.cu)
CULL_REL = 1e-5      # corner margin, relative to each projected sum's magnitude
CULL_PIX = 2.0       # the image widened by this many pixels on each side


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """A one-element float32 tensor on ``like``'s device (a true divisor:
    PyTorch divides by a Python scalar as a multiplication by its
    reciprocal on the GPU, which the kernel does not)."""
    return torch.full((1,), x, dtype=torch.float32, device=like.device)


def integrate_plain(values_xyz, weights_xyz, depth_hw, P_34, origin_3, **kw):
    """One dense fusion step; returns new (values, weights), inputs untouched."""
    new_v, new_w, _ = voxel_update_plain(values_xyz, weights_xyz, depth_hw, P_34, origin_3, **kw)
    return new_v, new_w


def voxel_update_plain(values_xyz, weights_xyz, depth_hw, P_34, origin_3, *,
                       voxel_size: float, min_depth: float, max_depth: float,
                       truncation: float, trunc_check: float, update_rate: float,
                       max_weight: float, first_voxel=(0, 0, 0)):
    """``integrate_plain`` with the terms a colour update reuses: returns new
    (values, weights) and a dict of per-voxel ``valid``, ``in_img``, the
    sampled pixel's flat index ``flat``, the frame's weight ``new_w`` and
    the unclamped ``total`` weight (the JAX ``_voxel_update``, tsdf.py:135-221).

    ``first_voxel``: the index of the block's first voxel in a larger volume
    at ``origin_3``, so that a volume too large for this version's
    temporaries is computed block by block with the whole volume's
    arithmetic (origin + index x voxel size, as the kernel computes it)."""
    X, Y, Z = values_xyz.shape
    H, W = depth_hw.shape
    dev = values_xyz.device
    f32 = torch.float32
    vs = torch.full((), voxel_size, dtype=f32, device=dev)
    (i0, j0, k0) = first_voxel
    cx = (origin_3[0] + torch.arange(i0, i0 + X, dtype=f32, device=dev) * vs).view(X, 1, 1)
    cy = (origin_3[1] + torch.arange(j0, j0 + Y, dtype=f32, device=dev) * vs).view(1, Y, 1)
    cz = (origin_3[2] + torch.arange(k0, k0 + Z, dtype=f32, device=dev) * vs).view(1, 1, Z)
    P = P_34.reshape(12)
    cam0 = P[0] * cx + P[1] * cy + P[2] * cz + P[3]
    cam1 = P[4] * cx + P[5] * cy + P[6] * cz + P[7]
    zc = P[8] * cx + P[9] * cy + P[10] * cz + P[11]

    ix = torch.round(cam0 / zc - 0.5)   # half to even, like jnp.rint and rintf
    iy = torch.round(cam1 / zc - 0.5)
    in_img = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H) & (zc > 0)
    # a voxel at zc = 0 projects to NaN: index pixel 0 for it (not sampled)
    flat = torch.where(in_img, iy * W + ix, torch.zeros((), dtype=f32, device=dev)).long()
    sampled = torch.where(in_img, depth_hw.reshape(-1)[flat], torch.zeros((), dtype=f32, device=dev))

    conf = 1.0 - (sampled - min_depth) / _scalar(max_depth - min_depth, sampled)
    conf = conf.clamp(0.25, 1.0)
    conf = conf * conf
    dist = sampled - zc
    tsdf = (dist / _scalar(truncation, dist)).clamp(-1.0, 1.0)
    valid = (zc > 0) & (dist > trunc_check) & (sampled > 0) & (zc < max_depth) & (conf > 0)

    new_w = conf * update_rate / _scalar(max_weight, conf)
    total = weights_xyz + new_w
    fused = (values_xyz * weights_xyz + tsdf * new_w) / total
    terms = dict(valid=valid, in_img=in_img, flat=flat, new_w=new_w, total=total)
    return (torch.where(valid, fused, values_xyz),
            torch.where(valid, total.clamp(max=1.0), weights_xyz), terms)


def block_cull_plain(dims, hw, P_34, origin_3, *, voxel_size: float, max_depth: float):
    """The boxes the kernel skips, as a (ceil(X/8), Y, ceil(Z/32)) bool
    tensor: the kernel's corner test (``block_culled``) in float32."""
    H, W = hw
    dev = P_34.device
    f32 = torch.float32
    vs = torch.full((), voxel_size, dtype=f32, device=dev)
    ends = []
    for n, step in zip(dims, BOX):
        lo = torch.arange(0, n, step, device=dev)
        ends.append(torch.stack([lo, (lo + step).clamp(max=n) - 1], -1))   # (boxes, 2)
    i = ends[0][:, None, None, :, None, None]
    j = ends[1][None, :, None, None, :, None]
    k = ends[2][None, None, :, None, None, :]
    cx = origin_3[0] + i.to(f32) * vs
    cy = origin_3[1] + j.to(f32) * vs
    cz = origin_3[2] + k.to(f32) * vs
    P = P_34.reshape(12)

    def row(r):
        p = P[4 * r:4 * r + 4]
        val = p[0] * cx + p[1] * cy + p[2] * cz + p[3]
        mag = (p[0] * cx).abs() + (p[1] * cy).abs() + (p[2] * cz).abs() + p[3].abs()
        eps = CULL_REL * mag.flatten(-3).amax(-1)[..., None, None, None]
        return val.expand(*val.shape[:3], 2, 2, 2).flatten(-3), eps.flatten(-3)

    (cam0, e0), (cam1, e1), (zc, ez) = row(0), row(1), row(2)
    znear, zfar = zc - ez, zc + ez
    far = (znear >= max_depth).all(-1)
    front = (znear > 0).all(-1)

    def span(cam, e):
        q = torch.stack([(cam - e) / znear, (cam - e) / zfar, (cam + e) / znear,
                         (cam + e) / zfar], -1)
        return q.amin(-1), q.amax(-1)

    (umin, umax), (vmin, vmax) = span(cam0, e0), span(cam1, e1)
    outside = ((umax < -CULL_PIX).all(-1) | (umin > W + CULL_PIX).all(-1)
               | (vmax < -CULL_PIX).all(-1) | (vmin > H + CULL_PIX).all(-1))
    return far | (front & outside)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


@tracing.spanned("ops.integrate")
def fused_integrate(values_xyz, weights_xyz, depth_hw, P_34, origin_3, *,
                    voxel_size: float, min_depth: float, max_depth: float,
                    truncation: float, trunc_check: float, update_rate: float,
                    max_weight: float):
    """Fuse one depth map into (values, weights) in place; returns them."""
    kw = dict(voxel_size=voxel_size, min_depth=min_depth, max_depth=max_depth,
              truncation=truncation, trunc_check=trunc_check,
              update_rate=update_rate, max_weight=max_weight)
    if not values_xyz.is_cuda:
        new_v, new_w = integrate_plain(values_xyz, weights_xyz, depth_hw, P_34, origin_3, **kw)
        values_xyz.copy_(new_v)
        weights_xyz.copy_(new_w)
        return values_xyz, weights_xyz

    tensors = dict(values=values_xyz, weights=weights_xyz, depth=depth_hw, P=P_34,
                   origin=origin_3)
    for name, t in tensors.items():
        if not t.is_cuda or t.device != values_xyz.device:
            raise ValueError(f"fused_integrate: {name} must be on {values_xyz.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"fused_integrate: {name} must be contiguous float32")
    if values_xyz.dim() != 3 or weights_xyz.shape != values_xyz.shape:
        raise ValueError("fused_integrate: values and weights must be one (X, Y, Z) shape")
    if depth_hw.dim() != 2 or P_34.shape != (3, 4) or origin_3.shape != (3,):
        raise ValueError("fused_integrate: depth (H, W), P (3, 4) and origin (3,) expected")

    X, Y, Z = values_xyz.shape
    H, W = depth_hw.shape
    # 32-bit voxel indices; grid y (8 warps' rows a block) and z at most 65535
    if values_xyz.numel() >= 2**31 or -(-Y // 8) > 65535 or -(-X // BOX[0]) > 65535:
        raise ValueError(f"fused_integrate: volume {(X, Y, Z)} too large for the kernel")
    lib = load_kernel("integrate")
    fn = lib.integrate_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_float] * 8 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(values_xyz.device).cuda_stream
    err = fn(_ptr(values_xyz), _ptr(weights_xyz), _ptr(depth_hw), _ptr(P_34), _ptr(origin_3),
             X, Y, Z, H, W, voxel_size, min_depth, max_depth - min_depth, max_depth,
             truncation, trunc_check, update_rate, max_weight, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"integrate kernel launch failed: cudaError {err}")
    tracing.count("ops.integrate.launches")
    return values_xyz, weights_xyz
