"""Build visibility volumes for mesh-eval occlusion masks (reference
scripts/create_visibility_volume.py; the JAX package's
scripts/create_visibility_volume.py).

For each scan: a ``SimpleVolume`` at 0.04 m over the scene bounds, in which
every frame marks the voxels in front of its GT depth + 0.3 m; saved as
``<output_base_path>/<name>/visibility/<scan>_visibility.npz``.

    python -m doubletake_tpu_torch.scripts.create_visibility_volume \
        --dataset synthetic --split test --name vis --output_base_path results \
        [--device cpu]
"""

from __future__ import annotations

import os

import torch

from doubletake_tpu_torch.data.loader import DataLoader
from doubletake_tpu_torch.datasets.registry import dataset_from_opts
from doubletake_tpu_torch.eval.visibility import SimpleVolume, integrate_visibility
from doubletake_tpu_torch.options import OptionsHandler
from doubletake_tpu_torch.runners.common import resolve_device, scene_bounds_for_fusion
from doubletake_tpu_torch.runners.no_hint import unique_scans

VOXEL_SIZE = 0.04


@torch.no_grad()
def build_visibility_volume(opts, ds, scan_id, device, voxel_size: float = VOXEL_SIZE):
    """The visibility volume of one scan from its frames' GT depths."""
    volume = SimpleVolume.from_bounds(scene_bounds_for_fusion(ds, scan_id), voxel_size,
                                      device=device)
    for cur_np, _ in DataLoader(ds, batch_size=1, num_workers=opts.num_workers):
        integrate_visibility(volume, *(torch.as_tensor(cur_np[k][0]).to(device) for k in
                                       ("depth_bhw1", "cam_T_world_b44", "K_s0_b44")))
    return volume


def main(argv=None):
    """Write every scan's volume; returns {scan: path}."""
    opts = OptionsHandler(argv).parse_and_merge_options()
    device = resolve_device(opts)
    probe = dataset_from_opts(opts, split=opts.split)
    scans = unique_scans(probe)
    if opts.single_debug_scan_id:
        scans = [s for s in scans if s == opts.single_debug_scan_id]

    out_dir = os.path.join(opts.output_base_path, opts.name, "visibility")
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for scan in scans:
        ds = dataset_from_opts(opts, split=opts.split, limit_to_scan_id=scan)
        volume = build_visibility_volume(opts, ds, scan, device)
        path = os.path.join(out_dir, f"{scan.replace('/', '_')}_visibility.npz")
        volume.save(path)
        frac = float(volume.values.mean())
        print(f"{scan}: visibility volume saved ({frac:.1%} visible) -> {path}")
        paths[scan] = path
    return paths


if __name__ == "__main__":
    main()
