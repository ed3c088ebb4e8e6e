"""Training-data depth-hint renders (reference
scripts/render_scripts/render_meshes.py; the JAX package's
scripts/render_hints.py).

For each scan: the no-hint runner's cached depths (``<scan>_depths.npz``,
written with ``--cache_depths``) are fused in order by a ``PartialFuser``
into a 0.04 m volume (0.5-3.0 m), in two variants:

  * ``renders``: each frame rendered from the partial volume before it is
    fused; after the last frame, every frame is rendered again from the
    complete volume and replaces its partial render;
  * ``partial_renders``: the partial renders only, the depths noised by
    ``--depth_noise``.

Renders are 192x256 hint depth and TSDF weight, written as 16-bit PNGs with
the reference's scales (depth x2048, weights x8192; render_meshes.py:200,
225-228), which the ScanNet hint loader reads. As in the JAX script, the
complete-volume renders use the last frame's intrinsics (all frames of a
scan share them).

    python -m doubletake_tpu_torch.scripts.render_hints --dataset synthetic \
        --depth_cache_dir results/NAME/no_hint/depth_cache \
        --render_output_dir hints [--depth_noise 0.05] [--device cpu]
"""

from __future__ import annotations

import os

import numpy as np

from doubletake_tpu_torch.datasets.registry import dataset_from_opts
from doubletake_tpu_torch.options import OptionsHandler
from doubletake_tpu_torch.runners.common import resolve_device, scene_bounds_for_fusion
from doubletake_tpu_torch.runners.no_hint import unique_scans
from doubletake_tpu_torch.tools.partial_fuser import PartialFuser
from doubletake_tpu_torch.tools.tsdf import TSDF, FusionConfig

RENDER_H, RENDER_W = 192, 256
DEPTH_SCALE = 2048.0
WEIGHT_SCALE = 8192.0
VOXEL_SIZE = 0.04


def save_png16(path, arr, scale):
    """A 16-bit PNG of ``arr`` x ``scale`` (non-finite values 0)."""
    from PIL import Image

    arr = np.where(np.isfinite(arr), arr, 0.0)
    Image.fromarray(np.clip(arr * scale, 0, 65535).astype(np.uint16)).save(path)


def load_cached_depths(cache_dir, scan):
    """The no-hint runner's ``cache_depths`` npz of a scan."""
    return np.load(os.path.join(cache_dir, f"{scan.replace('/', '_')}_depths.npz"))


def scaled_K(K_s0, ds):
    """Depth-resolution K_s0 scaled to the render resolution."""
    K = np.asarray(K_s0, np.float32).copy()
    K[0] *= RENDER_W / ds.depth_width
    K[1] *= RENDER_H / ds.depth_height
    return K


def write_render(fuser, out_dir, fid, world_T_cam, K):
    """Render the fuser's volume from one pose and write its two PNGs."""
    depth, weights, _ = fuser.render_hint(world_T_cam, np.linalg.inv(K), RENDER_H, RENDER_W)
    save_png16(os.path.join(out_dir, f"depth_{int(fid):06d}.png"), depth.cpu().numpy(),
               DEPTH_SCALE)
    save_png16(os.path.join(out_dir, f"weights_{int(fid):06d}.png"), weights.cpu().numpy(),
               WEIGHT_SCALE)


def main(argv=None):
    """Render every scan's hints; returns {scan: {variant: output dir}}."""
    handler = OptionsHandler(argv)
    handler.parser.add_argument("--depth_cache_dir", type=str, required=True)
    handler.parser.add_argument("--render_output_dir", type=str, required=True)
    handler.parser.add_argument("--depth_noise", type=float, default=0.0)
    opts = handler.parse_and_merge_options()
    extra = handler.last_namespace
    device = resolve_device(opts)

    scans = unique_scans(dataset_from_opts(opts, split=opts.split))
    if opts.single_debug_scan_id:
        scans = [s for s in scans if s == opts.single_debug_scan_id]
    written = {}
    for scan in scans:
        ds = dataset_from_opts(opts, split=opts.split, limit_to_scan_id=scan)
        cache = load_cached_depths(extra.depth_cache_dir, scan)
        bounds = scene_bounds_for_fusion(ds, scan)
        frame_ids = cache["frame_ids"]
        written[scan] = {}
        for variant in ("renders", "partial_renders"):
            fuser = PartialFuser(
                TSDF.from_bounds(bounds, VOXEL_SIZE, device=device),
                FusionConfig(min_depth=0.5, max_depth=3.0),
                depth_noise=extra.depth_noise if variant == "partial_renders" else 0.0)
            out_dir = os.path.join(extra.render_output_dir, scan, variant)
            os.makedirs(out_dir, exist_ok=True)
            for i, fid in enumerate(frame_ids):
                world_T_cam, cam_T_world = ds.load_pose(scan, fid)
                K = ds.load_intrinsics(scan, fid)["K_s0_b44"]
                # the partial volume, before this frame is fused
                write_render(fuser, out_dir, fid, world_T_cam, scaled_K(K, ds))
                fuser.fuse_frame(cache["depths"][i], cam_T_world, K)
            if variant == "renders":
                # every frame again from the complete volume (the last K)
                for fid in frame_ids:
                    write_render(fuser, out_dir, fid, ds.load_pose(scan, fid)[0],
                                 scaled_K(K, ds))
            written[scan][variant] = out_dir
        print(f"{scan}: hint renders written")
    return written


if __name__ == "__main__":
    main()
