"""The traffic generator: posed RGB-D scans of seeded synthetic rooms.

One general generator for every traffic file under ``traffic/``: the file
gives the room, the boxes in it, the camera orbit, the frames per scan, the
tuple size and the number of scans kept in the pool; the seed gives the
rooms. Each room is the interior of an axis-aligned box with solid boxes
standing on its floor, coloured by a smooth procedural texture, and is
ray-cast analytically on the device, so colour, depth and poses are exact
and the views are photo-consistent. The camera orbits the room looking at
its centre, one keyframe every ``orbit_share * 360 / orbit_frames``
degrees, for ``frames_per_scan`` frames; each frame from the
``tuple_size - 1``-th on is the reference of one tuple with its
``tuple_size - 1`` predecessors as sources.

Scan ``i`` of a run with seed ``s`` is the room drawn from ``s + i``; the
frames are made at set-up and kept in host memory, as a camera or decoder
would hand them over.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch

RENDER_CHUNK = 8      # frames ray-cast at once


@dataclasses.dataclass
class Scan:
    scan_id: str
    images: np.ndarray          # (N, H, W, 3) float32 RGB in [0, 1]
    depths: np.ndarray          # (N, h, w) float32 z-depth at depth resolution
    world_T_cam: np.ndarray     # (N, 4, 4) float32
    cam_T_world: np.ndarray     # (N, 4, 4) float32, its inverse
    K_image: np.ndarray         # (4, 4) float32 intrinsics at image resolution
    bounds: tuple               # (room min (3,), room max (3,))
    tuples: List[List[int]]     # [reference, sources...] frame indices


def intrinsics_pyramid(K_image, image_hw, depth_hw):
    """K_s0..K_s4 and their inverses: K_s0 at depth resolution, each next
    level half the previous."""
    K = K_image.astype(np.float32).copy()
    K[0] *= depth_hw[1] / image_hw[1]
    K[1] *= depth_hw[0] / image_hw[0]
    out = {}
    for i in range(5):
        Ks = K.copy()
        Ks[:2] /= 2 ** i
        out[f"K_s{i}_b44"] = Ks
        out[f"invK_s{i}_b44"] = np.linalg.inv(Ks).astype(np.float32)
    return out


def orbit(params: dict):
    """(N, 4, 4) float32 world_T_cam of the orbit (camera x right, y down,
    z forward, looking at a point near the room's centre)."""
    n = params["frames_per_scan"]
    step = 2 * math.pi * params["orbit_share"] / params["orbit_frames"]
    z0 = params["camera_height"]
    poses = []
    for i in range(n):
        ang = step * i
        radius = params["orbit_radius"] + 0.2 * math.sin(3 * ang)
        eye = np.array([radius * math.cos(ang), radius * math.sin(ang),
                        z0 + 0.2 * math.sin(2 * ang)])
        target = np.array([0.35 * math.sin(2 * ang), 0.35 * math.cos(ang), z0])
        fwd = (target - eye) / np.linalg.norm(target - eye)
        right = np.cross(fwd, np.array([0.0, 0.0, -1.0]))
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        T = np.eye(4)
        T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = right, down, fwd, eye
        poses.append(T)
    return np.stack(poses).astype(np.float32)


def _room(params: dict, seed: int, device):
    """(room min, room max, boxes (nb, 2, 3), texture phases (3,)) from the seed."""
    size = torch.tensor(params["room_size"], dtype=torch.float64)
    lo = torch.stack([-size[0] / 2, -size[1] / 2, torch.zeros((), dtype=torch.float64)])
    hi = torch.stack([size[0] / 2, size[1] / 2, size[2]])
    gen = torch.Generator(device=device).manual_seed(seed)
    nb = params["num_boxes"]
    u = torch.rand((nb, 5), generator=gen, device=device, dtype=torch.float64).cpu()
    half = torch.stack([0.2 + 0.4 * u[:, 0], 0.2 + 0.4 * u[:, 1], 0.2 + 0.25 * u[:, 2]], 1)
    first = lo[:2] + half[:, :2] + 0.2              # box centres keep 0.2 m from the walls
    last = hi[:2] - half[:, :2] - 0.2
    cx, cy = (first + u[:, 3:5] * (last - first)).unbind(1)
    center = torch.stack([cx, cy, half[:, 2]], 1)
    boxes = torch.stack([center - half, center + half], 1)
    phases = 10.0 * torch.rand(3, generator=gen, device=device, dtype=torch.float64).cpu()
    return lo, hi, boxes, phases


def _render(lo, hi, boxes, phases, world_T_cam, K, height, width, device):
    """RGB (N, H, W, 3) and z-depth (N, H, W) of a room for N cameras."""
    f64 = torch.float64
    T = torch.as_tensor(world_T_cam, dtype=f64, device=device)
    invK = torch.linalg.inv(torch.as_tensor(K, dtype=f64, device=device))
    ys, xs = torch.meshgrid(torch.arange(height, dtype=f64, device=device),
                            torch.arange(width, dtype=f64, device=device), indexing="ij")
    pix = torch.stack([xs + 0.5, ys + 0.5, torch.ones_like(xs)], -1).reshape(-1, 3)
    rays = pix @ invK[:3, :3].T                                           # unit z
    dirs = torch.einsum("nij,pj->npi", T[:, :3, :3], rays)               # (N, P, 3)
    orig = T[:, None, :3, 3].expand_as(dirs)
    lo, hi, boxes = lo.to(device), hi.to(device), boxes.to(device)
    t1 = (lo - orig) / dirs
    t2 = (hi - orig) / dirs
    t_hit = torch.maximum(t1, t2).amin(-1)                                # exit of the room
    for bmin, bmax in boxes:
        a = (bmin - orig) / dirs
        b = (bmax - orig) / dirs
        tmin = torch.minimum(a, b).amax(-1)
        tmax = torch.maximum(a, b).amin(-1)
        hit = (tmax >= tmin) & (tmax > 0) & (tmin > 1e-6)
        t_hit = torch.where(hit, torch.minimum(t_hit, tmin), t_hit)
    p = orig + dirs * t_hit[..., None]
    s = phases.to(device)
    r = 0.5 + 0.5 * torch.sin(3.1 * p[..., 0] + s[0]) * torch.cos(2.3 * p[..., 1])
    g = 0.5 + 0.5 * torch.sin(2.7 * p[..., 1] + s[1]) * torch.cos(1.9 * p[..., 2])
    checker = torch.remainder(torch.floor(p[..., 0] * 2) + torch.floor(p[..., 2] * 2), 2)
    bl = 0.25 + 0.5 * checker + 0.1 * torch.sin(5.0 * p[..., 1] + s[2])
    rgb = torch.stack([r, g, bl], -1).clamp(0.0, 1.0).float()
    n = T.shape[0]
    return rgb.reshape(n, height, width, 3), t_hit.float().reshape(n, height, width)


def make_scans(params: dict, image_hw, depth_hw, seed: int, device) -> List[Scan]:
    """The pool of ``params["pool_scans"]`` scans of a run with ``seed``."""
    h, w = image_hw
    fx = params["focal_ratio"] * w
    K = np.array([[fx, 0, w / 2, 0], [0, fx, h / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    Kd = K.copy()
    Kd[0] *= depth_hw[1] / w
    Kd[1] *= depth_hw[0] / h
    poses = orbit(params)
    inverses = np.linalg.inv(poses.astype(np.float64)).astype(np.float32)
    ts = params["tuple_size"]
    tuples = [[r] + [r - 1 - j for j in range(ts - 1)] for r in range(ts - 1, len(poses))]
    scans = []
    for i in range(params["pool_scans"]):
        lo, hi, boxes, phases = _room(params, seed + i, device)
        rgb, depth = [], []
        for c in range(0, len(poses), RENDER_CHUNK):     # bounded temporaries
            chunk = poses[c:c + RENDER_CHUNK]
            rgb.append(_render(lo, hi, boxes, phases, chunk, K, h, w, device)[0].cpu().numpy())
            depth.append(_render(lo, hi, boxes, phases, chunk, Kd, depth_hw[0], depth_hw[1],
                                 device)[1].cpu().numpy())
        scans.append(Scan(scan_id=f"room{i}", images=np.concatenate(rgb),
                          depths=np.concatenate(depth),
                          world_T_cam=poses, cam_T_world=inverses, K_image=K,
                          bounds=(lo.numpy().astype(np.float32), hi.numpy().astype(np.float32)),
                          tuples=tuples))
    return scans
