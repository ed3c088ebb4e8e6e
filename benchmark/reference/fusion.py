"""The plain TSDF volume, integrate and hint raycast of the reference.

A frozen copy of the port's ``tools/tsdf.py`` (``TSDF.from_bounds``, the
dense ``raycast``, ``prepare_static``), ``ops/integrate.py``'s
``integrate_plain`` and ``runners/common.render_hint``: dense float32
torch, no kernel. Nothing here imports the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.layers import linspace01

VOX_MOD = 8                      # volume dims rounded up to multiples of 8
MIN_DEPTH = 0.5                  # fusion and hint minimum depth
HINT_WEIGHT_THRESHOLD = 0.025    # hint pixels below this weight are invalid


@dataclasses.dataclass
class Volume:
    values: torch.Tensor
    weights: torch.Tensor
    origin: torch.Tensor
    voxel_size: float
    rounded: bool = False        # values and weights already rounded through bf16

    @property
    def dims(self):
        return tuple(self.values.shape)


def volume_from_bounds(lo, hi, voxel_size: float, device) -> Volume:
    dims = [int(np.ceil((hi[i] - lo[i]) / voxel_size / VOX_MOD)) * VOX_MOD for i in range(3)]
    return Volume(values=-torch.ones(dims, dtype=torch.float32, device=device),
                  weights=torch.zeros(dims, dtype=torch.float32, device=device),
                  origin=torch.tensor([float(x) for x in lo], dtype=torch.float32, device=device),
                  voxel_size=voxel_size)


def static_copy(vol: Volume) -> Volume:
    """The volume rounded through bf16 once (a volume that no longer changes)."""
    return Volume(vol.values.to(torch.bfloat16).float(), vol.weights.to(torch.bfloat16).float(),
                  vol.origin, vol.voxel_size, rounded=True)


def _div(x: float, like):
    return torch.full((1,), x, dtype=torch.float32, device=like.device)


def update_terms(vol: Volume, depth_hw, cam_T_world_44, K_44, max_depth: float,
                 extended_neg_truncation: bool, update_rate=2.5, max_weight=100.0,
                 truncation_voxels=3.0):
    """The fusion step's per-voxel terms: (valid, the frame's TSDF value,
    the frame's weight). Nearest depth sampling, InfiniTAM confidence,
    truncation 3 voxels (1.5x behind the surface when extended)."""
    truncation = truncation_voxels * vol.voxel_size
    trunc_check = -truncation * (1.5 if extended_neg_truncation else 1.0)
    P = torch.matmul(K_44, cam_T_world_44)[:3].reshape(12)
    X, Y, Z = vol.dims
    H, W = depth_hw.shape
    dev = vol.values.device
    f32 = torch.float32
    vs = torch.full((), vol.voxel_size, dtype=f32, device=dev)
    cx = (vol.origin[0] + torch.arange(X, dtype=f32, device=dev) * vs).view(X, 1, 1)
    cy = (vol.origin[1] + torch.arange(Y, dtype=f32, device=dev) * vs).view(1, Y, 1)
    cz = (vol.origin[2] + torch.arange(Z, dtype=f32, device=dev) * vs).view(1, 1, Z)
    cam0 = P[0] * cx + P[1] * cy + P[2] * cz + P[3]
    cam1 = P[4] * cx + P[5] * cy + P[6] * cz + P[7]
    zc = P[8] * cx + P[9] * cy + P[10] * cz + P[11]
    ix = torch.round(cam0 / zc - 0.5)
    iy = torch.round(cam1 / zc - 0.5)
    in_img = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H) & (zc > 0)
    zero = torch.zeros((), dtype=f32, device=dev)
    flat = torch.where(in_img, iy * W + ix, zero).long()
    sampled = torch.where(in_img, depth_hw.reshape(-1)[flat], zero)
    conf = (1.0 - (sampled - MIN_DEPTH) / _div(max_depth - MIN_DEPTH, sampled)).clamp(0.25, 1.0)
    conf = conf * conf
    dist = sampled - zc
    tsdf = (dist / _div(truncation, dist)).clamp(-1.0, 1.0)
    valid = (zc > 0) & (dist > trunc_check) & (sampled > 0) & (zc < max_depth) & (conf > 0)
    return valid, tsdf, conf * update_rate / _div(max_weight, conf)


def integrate(vol: Volume, depth_hw, cam_T_world_44, K_44, max_depth: float,
              extended_neg_truncation: bool):
    """One dense fusion step in place: a running weighted mean, weights
    clamped to 1."""
    valid, tsdf, new_w = update_terms(vol, depth_hw, cam_T_world_44, K_44, max_depth,
                                      extended_neg_truncation)
    total = vol.weights + new_w
    fused = (vol.values * vol.weights + tsdf * new_w) / total
    vol.values = torch.where(valid, fused, vol.values)
    vol.weights = torch.where(valid, total.clamp(max=1.0), vol.weights)
    return vol


def _sampler(vol: Volume, ov, dv):
    """Trilinear (value, weight, min contributing-corner weight) along rays
    v(s) = ov + s * dv in voxel coordinates, corners rounded through bf16."""
    X, Y, Z = vol.dims
    vals = vol.values.reshape(-1)
    wts = vol.weights.reshape(-1)
    hi = torch.tensor([X - 1, Y - 1, Z - 1], dtype=torch.float32, device=vals.device) - 1e-4

    def sample(zs):
        v = ov[None] + zs[:, None, :] * dv[None]
        v = torch.nan_to_num(v.permute(0, 2, 1), nan=0.0)
        v = torch.minimum(v.clamp(min=0.0), hi)
        v0 = torch.floor(v)
        f = v - v0
        i = v0.long()
        base = (i[..., 0] * Y + i[..., 1]) * Z + i[..., 2]
        fx, fy, fz = f.unbind(-1)
        val = torch.zeros_like(fx)
        wt = torch.zeros_like(fx)
        wmin = torch.full_like(fx, float("inf"))
        for a in (0, 1):
            wx = fx if a else 1.0 - fx
            for bb in (0, 1):
                wy = fy if bb else 1.0 - fy
                for e in (0, 1):
                    wz = fz if e else 1.0 - fz
                    coef = wz * wx * wy
                    idx = base + (a * Y + bb) * Z + e
                    cv, cw = vals[idx], wts[idx]
                    if not vol.rounded:
                        cv = cv.to(torch.bfloat16).float()
                        cw = cw.to(torch.bfloat16).float()
                    val = val + cv * coef
                    wt = wt + cw * coef
                    wmin = torch.where(coef > 1e-3, torch.minimum(wmin, cw), wmin)
        return val, wt, wmin

    return sample


def _first_crossing(vals, obs, extra=None):
    cross = (vals[:-1] > 0) & (vals[1:] <= 0) & obs[:-1] & obs[1:]
    if extra is not None:
        cross = cross & extra
    return cross.to(torch.uint8).argmax(0), cross.any(0)


def raycast(vol: Volume, world_T_cam, invK, height, width, min_depth, max_depth,
            num_samples=256, weight_epsilon=1e-4):
    """Hint depth, weight and validity (B, height, width) for (B, 4, 4)
    poses: coarse march to the first observed + -> - crossing, 8 fine
    samples across the bracket, linear refinement."""
    dev = vol.values.device
    X, Y, Z = vol.dims
    b = world_T_cam.shape[0]
    n = height * width
    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=dev),
                            torch.arange(width, dtype=torch.float32, device=dev), indexing="ij")
    pix = torch.stack([xs + 0.5, ys + 0.5, torch.ones_like(xs)], 0).reshape(3, n)
    ovs, dvs = [], []
    for i in range(b):
        rays = world_T_cam[i, :3, :3] @ (invK[i, :3, :3] @ pix)
        ovs.append(((world_T_cam[i, :3, 3] - vol.origin) / vol.voxel_size)[:, None].expand(3, n))
        dvs.append(rays / vol.voxel_size)
    ov = torch.cat(ovs, 1)
    dv = torch.cat(dvs, 1)
    dims = torch.tensor([X - 1, Y - 1, Z - 1], dtype=torch.float32, device=dev)[:, None]
    tiny = dv.abs() <= 1e-12
    safe = torch.where(tiny, torch.full_like(dv, 1e-12), dv)
    ta = (0.0 - ov) / safe
    tb = (dims - ov) / safe
    inside = (ov >= 0.0) & (ov <= dims)
    inf = torch.full_like(dv, float("inf"))
    t_lo = torch.where(tiny, torch.where(inside, -inf, inf), torch.minimum(ta, tb))
    t_hi = torch.where(tiny, torch.where(inside, inf, -inf), torch.maximum(ta, tb))
    t_enter = t_lo.amax(0).clamp(min=min_depth)
    t_exit = t_hi.amin(0).clamp(max=max_depth)
    hit_box = t_exit > t_enter
    t_exit = torch.maximum(t_exit, t_enter)

    sc, sf = max(2, num_samples // 4), 8
    zs = t_enter[None] + linspace01(sc, dev)[:, None] * (t_exit - t_enter)[None]
    dz = (t_exit - t_enter) / (sc - 1)
    sample = _sampler(vol, ov, dv)
    vals, _, wmins = sample(zs)
    first, valid = _first_crossing(vals, wmins > weight_epsilon, hit_box[None])
    v0 = vals[:-1].gather(0, first[None])[0]
    v1 = vals[1:].gather(0, first[None])[0]
    z_lo = zs.gather(0, first[None])[0]
    depth_coarse = z_lo + v0 / torch.clamp(v0 - v1, min=1e-12) * dz
    zf = z_lo[None] + linspace01(sf, dev)[:, None] * dz[None]
    fvals, _, fwmins = sample(zf)
    ffirst, fvalid = _first_crossing(fvals, fwmins > weight_epsilon)
    fv0 = fvals[:-1].gather(0, ffirst[None])[0]
    fv1 = fvals[1:].gather(0, ffirst[None])[0]
    ffrac = fv0 / torch.clamp(fv0 - fv1, min=1e-12)
    depth_fine = zf.gather(0, ffirst[None])[0] + ffrac * dz / (sf - 1)
    depth = torch.where(fvalid, depth_fine, depth_coarse)
    _, surf_w, _ = sample(depth[None])
    depth = torch.where(valid, depth, torch.full_like(depth, float("nan")))
    weight = torch.where(valid, surf_w[0], torch.zeros_like(depth))
    shape = (b, height, width)
    return depth.reshape(shape), weight.reshape(shape), valid.reshape(shape)


def render_hint(vol: Volume, world_T_cam, invK_s0, hint_h, hint_w, max_depth, num_samples):
    """The model's hint dict: raycast depth where valid and weight >= 0.025."""
    d, wt, v = raycast(vol, world_T_cam, invK_s0, hint_h, hint_w, MIN_DEPTH, max_depth,
                       num_samples)
    valid = v & (wt >= HINT_WEIGHT_THRESHOLD)
    return {"depth_hint_bhw1": torch.where(valid, d, torch.full_like(d, float("nan")))[..., None],
            "hint_mask_bhw1": valid[..., None],
            "sampled_weights_bhw1": torch.where(valid, wt, torch.zeros_like(wt))[..., None]}


def empty_hint(b, h, w, device):
    zero = torch.zeros((b, h, w, 1), dtype=torch.float32, device=device)
    return {"depth_hint_bhw1": zero, "hint_mask_bhw1": zero.bool(), "sampled_weights_bhw1": zero}
