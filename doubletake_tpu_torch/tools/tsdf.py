"""TSDF volume, fusion and hint raycasting on torch tensors.

Counterpart of ``doubletake_tpu.tools.tsdf`` (reference scene state:
src/doubletake/tools/tsdf.py):

  * ``TSDF`` — a dense, bounded (X, Y, Z) values/weights pair (values init
    -1, weights 0) with its world-space origin and voxel size, and optional
    (X, Y, Z, 3) float16 colours in [0, 1] (the reference's Open3D colour
    fusers, fusers_helper.py:110-211); ``save`` and ``load`` use the JAX
    package's npz format, so volumes pass between the two packages.
  * ``integrate_depth`` — TSDFFuser.integrate_depth math (tsdf.py:414-558):
    nearest depth sampling, InfiniTAM confidence, truncation 3 voxels (1.5x
    extended negative truncation optional), update_rate 2.5 / max weight
    100, weights clamped to 1. It runs ``ops.integrate.fused_integrate``:
    the CUDA kernel for a CUDA volume, the dense plain version on the CPU,
    and updates the volume IN PLACE (the JAX runner donates the volume).
    A coloured volume given an image takes, as in the JAX package (its XLA
    path, never Pallas), a dense plain-torch pass on the volume's device
    that also fuses the colours; its values and weights come out of
    ``ops.integrate.voxel_update_plain``, the kernel's plain version.
  * ``integrate_depth(cull=True)`` takes K2 as ``cull=False`` does: the JAX
    package's cull (chunks that cannot update compacted and scattered back,
    a TPU strategy for the same update of the same voxels) is K2's box cull
    on the card, so the result is bit-equal either way; the frustum-chunk
    diagnostics (``frustum_chunk_fraction``, ``choose_cull_fraction``) give
    the JAX package's fractions. ``integrate_batch`` fuses frames in order,
    one K2 launch each (the running mean depends on the order).
  * ``sample_tsdf`` — trilinear or nearest values, weights or colours at
    world points (align_corners=True, tsdf.py:277-339), on
    ``ops.grid_sample.grid_sample_3d``.
  * ``raycast`` — the hint renderer: a dense coarse-then-fine march along
    camera z to the first observed + -> - zero crossing, linear
    refinement, and the trilinear fusion weight at the surface, for one
    pose or a batch of poses in one march; with ``use_mip`` the coarse
    pass is the JAX package's candidate-block march over a min-pooled mip
    of the volume (``build_mip``). Plain torch, as the JAX raycast is plain
    XLA.
  * ``prepare_static`` — a volume that no longer changes (the offline
    pass-2 and revisit hint volumes), rounded through bf16 once instead of
    at every corner read: the counterpart of ``build_ray_table``, whose
    packed row table only the bf16 rounding of (tsdf.py:561) carries over.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from doubletake_tpu_torch.ops.grid_sample import grid_sample_3d
from doubletake_tpu_torch.ops.integrate import fused_integrate, voxel_update_plain
from doubletake_tpu_torch.utils.geometry import device_constant, linspace01
from doubletake_tpu_torch.utils.tracing import spanned

VOX_MOD = 8  # volume dims rounded up to multiples of 8 (tsdf.py:59)


@dataclasses.dataclass
class TSDF:
    """Dense TSDF volume. values/weights: (X, Y, Z) float32; origin: (3,)
    world min corner; colors: (X, Y, Z, 3) float16 in [0, 1], or None."""

    values: torch.Tensor
    weights: torch.Tensor
    origin: torch.Tensor
    voxel_size: float
    colors: Optional[torch.Tensor] = None

    @property
    def dims(self):
        return tuple(self.values.shape)

    @classmethod
    def from_bounds(cls, bounds: dict, voxel_size: float, device="cpu",
                    with_color: bool = False):
        """Create a volume covering bounds (tsdf.py:122-154), with zero
        colours if ``with_color``."""
        dims = []
        for axis in ("x", "y", "z"):
            extent = bounds[f"{axis}max"] - bounds[f"{axis}min"]
            dims.append(int(np.ceil(extent / voxel_size / VOX_MOD)) * VOX_MOD)
        origin = torch.tensor([bounds["xmin"], bounds["ymin"], bounds["zmin"]],
                              dtype=torch.float32, device=device)
        colors = (torch.zeros(dims + [3], dtype=torch.float16, device=device)
                  if with_color else None)
        return cls(values=-torch.ones(dims, dtype=torch.float32, device=device),
                   weights=torch.zeros(dims, dtype=torch.float32, device=device),
                   origin=origin, voxel_size=voxel_size, colors=colors)

    @classmethod
    def from_mesh_bounds(cls, verts_min, verts_max, voxel_size: float, device="cpu"):
        """A volume over mesh vertex bounds with a 3-voxel buffer
        (tsdf.py:100-120)."""
        b = {}
        for i, axis in enumerate(("x", "y", "z")):
            b[f"{axis}min"] = float(verts_min[i]) - 3 * voxel_size
            b[f"{axis}max"] = float(verts_max[i]) + 3 * voxel_size
        return cls.from_bounds(b, voxel_size, device=device)

    def save(self, path: str):
        """npz with float16 tsdf_values / tsdf_weights (and tsdf_colors),
        float32 origin and the voxel size — the JAX package's format."""
        arrays = dict(
            tsdf_values=self.values.detach().cpu().numpy().astype(np.float16),
            tsdf_weights=self.weights.detach().cpu().numpy().astype(np.float16),
            origin=self.origin.detach().cpu().numpy().astype(np.float32),
            voxel_size=self.voxel_size,
        )
        if self.colors is not None:
            arrays["tsdf_colors"] = self.colors.detach().cpu().numpy().astype(np.float16)
        np.savez_compressed(path, **arrays)

    @classmethod
    def load(cls, path: str, device="cpu"):
        data = np.load(path)
        return cls(
            values=torch.as_tensor(data["tsdf_values"].astype(np.float32), device=device),
            weights=torch.as_tensor(data["tsdf_weights"].astype(np.float32), device=device),
            origin=torch.as_tensor(data["origin"].astype(np.float32), device=device),
            voxel_size=float(data["voxel_size"]),
            colors=(torch.as_tensor(data["tsdf_colors"].astype(np.float16), device=device)
                    if "tsdf_colors" in data else None),
        )


def voxel_world_coords(tsdf: TSDF) -> torch.Tensor:
    """World coordinates of every voxel's sample point, (X, Y, Z, 3)."""
    grids = torch.meshgrid(*[torch.arange(d, dtype=torch.float32, device=tsdf.values.device)
                             for d in tsdf.dims], indexing="ij")
    return tsdf.origin + torch.stack(grids, -1) * tsdf.voxel_size


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    """Fusion hyperparameters (TSDFFuser defaults, tsdf.py:347-363)."""

    min_depth: float = 0.5
    max_depth: float = 5.0
    truncation_voxels: float = 3.0
    max_weight: float = 100.0
    update_rate: float = 2.5
    extended_neg_truncation: bool = False


@spanned("tsdf.integrate")
def integrate_depth(tsdf: TSDF, depth_hw1, cam_T_world_44, K_44, config: FusionConfig,
                    depth_mask_hw1=None, image_hw3=None, cull: Optional[bool] = None,
                    cull_max_fraction: float = 0.5) -> TSDF:
    """Fuse one depth map into ``tsdf`` in place and return it.

    ``cull`` / ``cull_max_fraction``: the JAX package's frustum-chunk cull
    (tsdf.py:330-331), which computes the same update of the same voxels
    as its dense pass. Here both values take the same path: K2, which skips
    the boxes of voxels that cannot update, on a CUDA volume, the plain
    version on the CPU; so the result is bit-equal whatever they say.

    With colours in the volume and an (H, W, 3) image in [0, 1] at the
    depth's size, the colours are fused too (the JAX ``_voxel_update``,
    tsdf.py:203-221): the voxel's nearest pixel, the same validity, a
    running mean weighted by the old and the frame's weights, stored as
    float16. That pass is dense plain torch (the JAX package's XLA path);
    every other volume takes K2."""
    if not 0.0 < cull_max_fraction <= 1.0:
        raise ValueError(f"cull_max_fraction={cull_max_fraction} is not in (0, 1]")
    truncation = config.truncation_voxels * tsdf.voxel_size
    if depth_mask_hw1 is not None:
        depth_hw1 = torch.where(depth_mask_hw1, depth_hw1, torch.full_like(depth_hw1, -1.0))
    P_34 = torch.matmul(K_44, cam_T_world_44)[:3].contiguous()
    kw = dict(voxel_size=tsdf.voxel_size, min_depth=config.min_depth,
              max_depth=config.max_depth, truncation=truncation,
              trunc_check=-truncation * (1.5 if config.extended_neg_truncation else 1.0),
              update_rate=config.update_rate, max_weight=config.max_weight)
    depth_hw = depth_hw1[..., 0].contiguous()
    if tsdf.colors is None or image_hw3 is None:
        fused_integrate(tsdf.values, tsdf.weights, depth_hw, P_34, tsdf.origin, **kw)
        return tsdf

    old_w = tsdf.weights
    new_v, new_w, t = voxel_update_plain(tsdf.values, old_w, depth_hw, P_34, tsdf.origin, **kw)
    rgb = image_hw3.reshape(-1, 3).float()[t["flat"]]               # (X, Y, Z, 3)
    rgb = torch.where(t["in_img"][..., None], rgb, torch.zeros((), device=rgb.device))
    old_c = tsdf.colors.float()
    fused_c = (old_c * old_w[..., None] + rgb * t["new_w"][..., None]) / t["total"][..., None]
    tsdf.colors = torch.where(t["valid"][..., None], fused_c, old_c).to(tsdf.colors.dtype)
    tsdf.values.copy_(new_v)
    tsdf.weights.copy_(new_w)
    return tsdf


def integrate_batch(tsdf: TSDF, depth_bhw1, cam_T_world_b44, K_b44, config: FusionConfig,
                    depth_mask_bhw1=None) -> TSDF:
    """Fuse a batch of depth maps in order, one ``integrate_depth`` each (the
    JAX package's ``lax.scan``; the running weighted mean depends on the
    order, as the reference's per-batch loop, tsdf.py:444)."""
    for i in range(depth_bhw1.shape[0]):
        integrate_depth(tsdf, depth_bhw1[i], cam_T_world_b44[i], K_b44[i], config,
                        None if depth_mask_bhw1 is None else depth_mask_bhw1[i])
    return tsdf


def _frustum_chunk_mask(tsdf: TSDF, P_34, h: int, w: int, max_depth: float, cz: int):
    """Conservative per-chunk camera-frustum mask, (X*Y*(Z//cz),) bool (the
    JAX package's, tsdf.py:224-283). A chunk is a z-run of ``cz`` voxel
    sample points at one (i, j); it is kept unless one of six planes (behind
    the camera, beyond max_depth, or a pixel outside the image widened by
    one) holds the whole run on its outer side, by the run's min corner."""
    X, Y, Z = tsdf.dims
    nzc = Z // cz
    vs = tsdf.voxel_size
    dev = tsdf.values.device

    def lin(row):  # a . p + b with p = origin + (i, j, k) * vs
        a = row[:3]
        return a * vs, row[3] + torch.dot(a, tsdf.origin)

    a1, b1 = lin(P_34[0])
    a2, b2 = lin(P_34[1])
    a3, b3 = lin(P_34[2])
    planes = [(-a3, -b3 - vs),                                # z >= -vs
              (a3, b3 - (max_depth + vs)),                    # z <= max_depth + vs
              (-a1 - a3, -b1 - b3),                           # px >= -1
              (a1 - (w + 1) * a3, b1 - (w + 1) * b3),         # px <= w + 1
              (-a2 - a3, -b2 - b3),                           # py >= -1
              (a2 - (h + 1) * a3, b2 - (h + 1) * b3)]         # py <= h + 1
    ii = torch.arange(X, dtype=torch.float32, device=dev)[:, None, None]
    jj = torch.arange(Y, dtype=torch.float32, device=dev)[None, :, None]
    kk = (torch.arange(nzc, dtype=torch.float32, device=dev) * cz)[None, None, :]
    keep = torch.ones((X, Y, nzc), dtype=torch.bool, device=dev)
    for a, b in planes:
        min_corner = (a[0] * ii + a[1] * jj + a[2] * kk
                      + torch.clamp(a[2] * float(cz - 1), max=0.0) + b)
        keep &= min_corner <= 0.0
    return keep.reshape(-1)


def _pick_cz(Z: int) -> int:
    """Chunk length along z: the divisor of Z closest to 32, in [8, 64]."""
    cands = [d for d in range(8, 65) if Z % d == 0]
    return min(cands, key=lambda d: abs(d - 32)) if cands else 8


def frustum_chunk_fraction(tsdf: TSDF, cam_T_world_44, K_44, config: FusionConfig,
                           h: int, w: int) -> float:
    """Fraction of the volume's z-chunks that intersect the camera frustum
    (the JAX package's diagnostic for ``cull_max_fraction``)."""
    P_34 = torch.matmul(K_44, cam_T_world_44)[:3]
    mask = _frustum_chunk_mask(tsdf, P_34, h, w, config.max_depth, _pick_cz(tsdf.dims[2]))
    return float(mask.float().mean())


def choose_cull_fraction(tsdf: TSDF, cam_T_world_n44, K_44, config: FusionConfig, h: int,
                         w: int, margin: float = 1.25, floor: float = 0.05) -> float:
    """``cull_max_fraction`` from a trajectory's poses: the largest frame's
    frustum chunk fraction times ``margin``, within [floor, 1]."""
    frac = max(frustum_chunk_fraction(tsdf, p, K_44, config, h, w) for p in cam_T_world_n44)
    return float(min(1.0, max(floor, frac * margin)))


def world_to_sample_coords(tsdf: TSDF, world_points_n3):
    """World points -> [-1, 1] sample coordinates, align_corners=True
    (tsdf.py:300-312)."""
    vox = (world_points_n3 - tsdf.origin) / tsdf.voxel_size
    dims = torch.tensor(tsdf.dims, dtype=torch.float32, device=vox.device)
    return (vox / (dims - 1.0)) * 2.0 - 1.0


def sample_tsdf(tsdf: TSDF, world_points_n3, what: str = "tsdf", method: str = "bilinear"):
    """Values (``what="tsdf"``, (N,)), weights (``"weights"``, (N,)) or
    colours (``"colors"``, (N, 3)) at world points: trilinear or nearest,
    zero outside the volume (tsdf.py:277-339)."""
    pts = world_to_sample_coords(tsdf, world_points_n3)
    if what == "colors":
        return grid_sample_3d(tsdf.colors.float(), pts, mode=method)
    vol = tsdf.values if what == "tsdf" else tsdf.weights
    return grid_sample_3d(vol[..., None], pts, mode=method)[:, 0]


def auto_raycast_samples(voxel_size: float, min_depth: float, max_depth: float,
                         extended_neg_truncation: bool = True,
                         truncation_voxels: float = 3.0, safety: float = 0.85) -> int:
    """Smallest raycast sample budget that cannot step over a surface: the
    coarse step (budget // 4 samples over at most [min_depth, max_depth])
    stays at ``safety`` x the observed-negative band behind a surface."""
    band = truncation_voxels * (1.5 if extended_neg_truncation else 1.0)
    sc = int(np.ceil((max_depth - min_depth) / (safety * band * voxel_size)))
    return 4 * max(8, sc)


@dataclasses.dataclass
class StaticVolume:
    """A TSDF that no longer changes, with its values and weights already
    rounded through bf16 (kept as float32). Made by ``prepare_static``."""

    values: torch.Tensor
    weights: torch.Tensor
    origin: torch.Tensor
    voxel_size: float

    @property
    def dims(self):
        return tuple(self.values.shape)


def prepare_static(tsdf: TSDF) -> StaticVolume:
    """Round a volume's values and weights through bf16 once, for many
    raycasts of a volume that stays as it is. Rounding is idempotent, so a
    raycast of the result is bit-equal to a raycast of ``tsdf``."""
    return StaticVolume(values=tsdf.values.to(torch.bfloat16).float(),
                        weights=tsdf.weights.to(torch.bfloat16).float(),
                        origin=tsdf.origin, voxel_size=tsdf.voxel_size)


def _box(dims, device):
    """(3, 1) float32: the interior box's upper corner, dims - 1, built on
    the host once per (dims, device)."""
    X, Y, Z = dims
    return device_constant(("box", X, Y, Z), lambda: torch.tensor(
        [X - 1, Y - 1, Z - 1], dtype=torch.float32)[:, None], device)


def _box_hi(dims, device):
    """The largest voxel coordinate a trilinear sample may start from, per
    axis: dims - 1 - 1e-4, computed on the host once per (dims, device)."""
    X, Y, Z = dims
    return device_constant(("box_hi", X, Y, Z), lambda: torch.tensor(
        [X - 1, Y - 1, Z - 1], dtype=torch.float32) - 1e-4, device)


def _sampler(vol, ov, dv):
    """Trilinear (value, weight, min contributing-corner weight) at camera
    depths, for rays v(s) = ov + s * dv in voxel coordinates.

    Values and weights are rounded through bf16 first, as the JAX package's
    packed ray table stores them (tsdf.py:561); a ``StaticVolume`` holds
    them rounded already. ``wmin`` is the smallest weight among corners
    whose trilinear coefficient exceeds 1e-3: unobserved voxels hold -1 at
    weight 0, so a blended weight can look observed at the frustum edge
    while the blended value fakes a crossing.
    """
    X, Y, Z = vol.dims
    vals = vol.values.reshape(-1)
    wts = vol.weights.reshape(-1)
    rounded = isinstance(vol, StaticVolume)
    hi = _box_hi(vol.dims, vals.device)

    def sample(zs):                                            # zs: (M, N)
        v = ov[None] + zs[:, None, :] * dv[None]               # (M, 3, N)
        v = torch.nan_to_num(v.permute(0, 2, 1), nan=0.0)      # (M, N, 3)
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
                    if not rounded:
                        cv = cv.to(torch.bfloat16).float()
                        cw = cw.to(torch.bfloat16).float()
                    val = val + cv * coef
                    wt = wt + cw * coef
                    wmin = torch.where(coef > 1e-3, torch.minimum(wmin, cw), wmin)
        return val, wt, wmin

    return sample


MIP_FACTOR = 4          # voxels per mip cell edge
MIP_WINDOW_VOXELS = 10  # full-resolution window after each candidate, in voxels


def build_mip(vol, weight_epsilon: float = 1e-4):
    """(X/4, Y/4, ceil(Z/4)) conservative mip of observed-negative voxels
    (the JAX package's ``_build_mip_table``): each cell holds the min of
    ``where(weight > eps, value, +1)`` over its 4^3 voxels and a one-voxel
    halo around them. A trilinear sample whose contributing corners include
    an observed voxel <= 0 lies in a cell that reads <= 0, so the mip flags
    a superset of the dense march's crossing samples.

    The JAX package packs the cells 128 to a row in bf16 for the TPU's
    gathers; the march reads only whether a cell is <= 0, which bf16
    rounding keeps, so a float32 (Xm, Ym, Zm) tensor gives the same flags.
    """
    X, Y, Z = vol.dims
    f = MIP_FACTOR
    assert X % f == 0 and Y % f == 0, (X, Y)
    zp = -(-Z // f) * f
    assert zp // f <= 128, zp // f
    v = torch.where(vol.weights > weight_epsilon, vol.values, torch.ones_like(vol.values))
    v = torch.nn.functional.pad(v, (0, zp - Z), value=1.0)

    def pool_axis(x, ax):
        """Stride-f min over f + 2 voxels along ``ax``: the block's min, the
        previous block's last voxel and the next block's first."""
        blocks = x.movedim(ax, -1).unflatten(-1, (-1, f))
        first, last = blocks[..., 0], blocks[..., -1]
        prev_last = torch.cat([last[..., :1], last[..., :-1]], -1)
        next_first = torch.cat([first[..., 1:], first[..., -1:]], -1)
        m = torch.minimum(blocks.amin(-1), torch.minimum(prev_last, next_first))
        return m.movedim(-1, ax)

    for ax in range(3):
        v = pool_axis(v, ax)
    return v


def _mip_coarse(vol, ov, dv, zs, hit_box, sample, min_depth, max_depth, weight_epsilon):
    """The candidate-block coarse pass (JAX ``raycast_table``'s mip
    branch): the coarse samples read the mip; the first three runs of
    flagged samples are candidates; each gets a forward window of ``wn``
    coarse samples (from one before the run), marched at full resolution
    with the dense crossing rule, so a crossing both marches find has the
    same bracket. Returns (valid, v0, v1, z_lo) of the first crossing."""
    mip = build_mip(vol)
    sc, n = zs.shape
    hi = _box_hi(vol.dims, zs.device)
    v = ov[None] + zs[:, None, :] * dv[None]                                   # (Sc, 3, N)
    v = torch.minimum(torch.nan_to_num(v.permute(0, 2, 1), nan=0.0).clamp(min=0.0), hi)
    cell = torch.floor(v).long() // MIP_FACTOR
    flags = (mip[cell[..., 0], cell[..., 1], cell[..., 2]] <= 0.0) & hit_box[None]
    # candidates: the starts of flag runs (a run's inside is one surface's halo)
    runs = flags & ~torch.cat([torch.zeros_like(flags[:1]), flags[:-1]])
    sidx = torch.arange(sc, device=zs.device)[:, None]
    starts, any_run = [], []
    for _ in range(3):
        starts.append(runs.to(torch.uint8).argmax(0))
        any_run.append(runs.any(0))
        runs = runs & (sidx > starts[-1][None])
    # the window covers the early-flag distance at the nominal step, plus
    # one sample before the run
    dz_nom = (max_depth - min_depth) / (sc - 1)
    wn = min(sc, int(np.ceil(MIP_WINDOW_VOXELS * vol.voxel_size / dz_nom)) + 3)
    offs = torch.arange(-1, wn - 1, device=zs.device)
    widx = (torch.stack(starts)[:, None] + offs[None, :, None]).clamp(0, sc - 1)
    zw = zs.gather(0, widx.reshape(3 * wn, n))                                # (3 Wn, N)
    wvals, _, wmins = sample(zw)
    wobs = wmins > weight_epsilon
    # pairs of consecutive samples inside each window, windows in ray order;
    # a clipped index repeats a sample, and (v > 0) & (v <= 0) never holds
    p0 = device_constant(("mip_pairs", wn), lambda: torch.tensor(
        [c * wn + j for c in range(3) for j in range(wn - 1)]), zs.device)
    ok = torch.stack(any_run).repeat_interleave(wn - 1, 0)
    cross = ((wvals[p0] > 0) & (wvals[p0 + 1] <= 0) & wobs[p0] & wobs[p0 + 1] & ok
             & hit_box[None])
    start = p0[cross.to(torch.uint8).argmax(0)][None]
    return (cross.any(0), wvals.gather(0, start)[0], wvals.gather(0, start + 1)[0],
            zw.gather(0, start)[0])


def _first_crossing(vals, obs, extra=None):
    """Index of the first (+ -> <= 0) pair between consecutive samples whose
    both ends are observed, and whether one exists."""
    cross = (vals[:-1] > 0) & (vals[1:] <= 0) & obs[:-1] & obs[1:]
    if extra is not None:
        cross = cross & extra
    return cross.to(torch.uint8).argmax(0), cross.any(0)


@spanned("tsdf.raycast")
def raycast(vol, world_T_cam, invK, height: int, width: int,
            min_depth: float = 0.1, max_depth: float = 5.0, num_samples: int = 256,
            weight_epsilon: float = 1e-4, use_mip: bool = False):
    """Render hint depth + confidence by ray-marching a ``TSDF`` or a
    ``StaticVolume``.

    Each pixel's ray (pixel centres at +0.5) is clipped to the volume's
    interior box and to [min_depth, max_depth], marched at
    ``num_samples // 4`` coarse depths to bracket the first observed
    + -> - crossing, re-marched with 8 fine samples across the bracket, and
    the crossing refined linearly. Returns (depth — z-depth, NaN where no
    surface —, weight — trilinear weight at the surface —, valid), each
    (height, width) for a (4, 4) pose and inverse intrinsics, or
    (B, height, width) for (B, 4, 4) ones.

    ``use_mip``: the coarse pass is the candidate-block march
    (``_mip_coarse``), the mip built from ``vol`` at this call, as the JAX
    package's ``raycast(use_mip=True)`` builds it. It is another algorithm,
    not a faster copy: where both marches find a crossing the depths are
    equal, but a grazing ray, or one with more than three false candidates
    before its surface, can be found by one and missed by the other.

    A batch is one march over all its rays. Each pose's rays are set up
    with the same (3, 3) products as a single pose's, and the march is
    elementwise per ray (with gathers and first-index argmaxes), so a batch
    is bit-equal to a loop of single-pose calls.
    """
    assert num_samples >= 16, (
        f"num_samples={num_samples}; resolve auto (0) with "
        "runners.common.resolve_raycast_samples before calling raycast")
    single = world_T_cam.dim() == 2
    if single:
        world_T_cam, invK = world_T_cam[None], invK[None]
    dev = vol.values.device
    X, Y, Z = vol.dims
    b = world_T_cam.shape[0]
    n = height * width
    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=dev),
                            torch.arange(width, dtype=torch.float32, device=dev), indexing="ij")
    pix = torch.stack([xs + 0.5, ys + 0.5, torch.ones_like(xs)], 0).reshape(3, n)
    ovs, dvs = [], []
    for i in range(b):
        rays_world = world_T_cam[i, :3, :3] @ (invK[i, :3, :3] @ pix)
        ovs.append(((world_T_cam[i, :3, 3] - vol.origin) / vol.voxel_size)[:, None].expand(3, n))
        dvs.append(rays_world / vol.voxel_size)
    # rays in voxel coordinates, v(s) = ov + s * dv, the batch's rays side by side
    ov = torch.cat(ovs, 1)                                                      # (3, B*n)
    dv = torch.cat(dvs, 1)                                                      # (3, B*n)
    dims = _box(vol.dims, dev)

    # slab clip against the interior box [0, dims - 1] (trilinear support)
    tiny = dv.abs() <= 1e-12
    safe_dv = torch.where(tiny, torch.full_like(dv, 1e-12), dv)
    ta = (0.0 - ov) / safe_dv
    tb = (dims - ov) / safe_dv
    inside = (ov >= 0.0) & (ov <= dims)
    inf = torch.full_like(dv, float("inf"))
    t_lo = torch.where(tiny, torch.where(inside, -inf, inf), torch.minimum(ta, tb))
    t_hi = torch.where(tiny, torch.where(inside, inf, -inf), torch.maximum(ta, tb))
    t_enter = t_lo.amax(0).clamp(min=min_depth)
    t_exit = t_hi.amin(0).clamp(max=max_depth)
    hit_box = t_exit > t_enter
    t_exit = torch.maximum(t_exit, t_enter)

    sc, sf = max(2, num_samples // 4), 8
    zs = t_enter[None] + linspace01(sc, dev)[:, None] * (t_exit - t_enter)[None]  # (Sc, N)
    dz = (t_exit - t_enter) / (sc - 1)
    sample = _sampler(vol, ov, dv)

    # coarse pass: bracket the first crossing
    if use_mip:
        valid, v0, v1, z_lo = _mip_coarse(vol, ov, dv, zs, hit_box, sample, min_depth,
                                          max_depth, weight_epsilon)
    else:
        vals, _, wmins = sample(zs)
        first, valid = _first_crossing(vals, wmins > weight_epsilon, hit_box[None])
        v0 = vals[:-1].gather(0, first[None])[0]
        v1 = vals[1:].gather(0, first[None])[0]
        z_lo = zs.gather(0, first[None])[0]
    depth_coarse = z_lo + v0 / torch.clamp(v0 - v1, min=1e-12) * dz

    # fine pass: re-march the bracketing interval
    zf = z_lo[None] + linspace01(sf, dev)[:, None] * dz[None]                    # (Sf, N)
    fvals, _, fwmins = sample(zf)
    ffirst, fvalid = _first_crossing(fvals, fwmins > weight_epsilon)
    fv0 = fvals[:-1].gather(0, ffirst[None])[0]
    fv1 = fvals[1:].gather(0, ffirst[None])[0]
    ffrac = fv0 / torch.clamp(fv0 - fv1, min=1e-12)
    depth_fine = zf.gather(0, ffirst[None])[0] + ffrac * dz / (sf - 1)
    # the coarse ends bracket a sign change, so the fine pass almost always
    # finds it again; otherwise keep the coarse interpolation
    depth = torch.where(fvalid, depth_fine, depth_coarse)

    _, surf_w, _ = sample(depth[None])
    depth = torch.where(valid, depth, torch.full_like(depth, float("nan")))
    weight = torch.where(valid, surf_w[0], torch.zeros_like(depth))
    shape = (height, width) if single else (b, height, width)
    return depth.reshape(shape), weight.reshape(shape), valid.reshape(shape)
