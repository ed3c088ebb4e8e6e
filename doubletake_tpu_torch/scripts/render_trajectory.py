"""A smoothed birdseye video of a saved TSDF and its scan's trajectory (the
JAX package's scripts/render_trajectory.py; reference mesh_renderer.py with
visualization_utils.py's merged videos).

Loads a ``<scan>_tsdf.npz`` that a runner wrote, replays the scan's camera
path, renders the volume from a birdseye camera that follows it, draws the
live camera as a frustum marker (on a copy of the render), and writes an
mp4, or a PNG sequence where ffmpeg is absent. Two faults of the JAX script
are not carried over: it draws into the read-only array that
``np.asarray`` of a JAX array is (so it raises at the first marker in
view), and it hands ``save_video`` 8-bit frames that ``save_image`` scales
by 255 again (so every lit pixel saturates).

    python -m doubletake_tpu_torch.scripts.render_trajectory --dataset synthetic \
        --single_debug_scan_id synth0 --output birdseye.mp4 \
        --tsdf_path results/NAME/incremental_default/meshes/synth0_tsdf.npz \
        [--max_frames N] [--device cpu]
"""

from __future__ import annotations

import numpy as np

from doubletake_tpu_torch.datasets.registry import dataset_from_opts
from doubletake_tpu_torch.options import OptionsHandler
from doubletake_tpu_torch.runners.common import resolve_device
from doubletake_tpu_torch.tools.tsdf import TSDF
from doubletake_tpu_torch.tools.viz_renderer import (
    SmoothBirdsEyeCamera,
    draw_camera_marker,
    observed_voxel_points,
    render_tsdf_view,
)
from doubletake_tpu_torch.utils.visualization import save_video


def main(argv=None):
    """Render the video; returns {"path": what ``save_video`` wrote,
    "frames": the frame count}."""
    handler = OptionsHandler(argv)
    handler.parser.add_argument("--tsdf_path", required=True)
    handler.parser.add_argument("--output", default="birdseye.mp4")
    handler.parser.add_argument("--viz_height", type=int, default=384)
    handler.parser.add_argument("--viz_width", type=int, default=512)
    handler.parser.add_argument("--max_frames", type=int, default=0,
                                help="render the first N frames only (0: all)")
    opts = handler.parse_and_merge_options()
    extra = handler.last_namespace
    device = resolve_device(opts)

    tsdf = TSDF.load(extra.tsdf_path, device=device)
    ds = dataset_from_opts(opts, split=opts.split, limit_to_scan_id=opts.single_debug_scan_id)
    h, w = extra.viz_height, extra.viz_width
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 0.9 * w
    K[0, 2], K[1, 2] = w / 2, h / 2
    invK = np.linalg.inv(K)

    birdseye = SmoothBirdsEyeCamera()
    pts = observed_voxel_points(tsdf)
    lines = ds.frame_tuples[:extra.max_frames or None]
    frames = []
    for line in lines:
        scan_id, ref_id = line.split(" ")[:2]
        world_T_cam, _ = ds.load_pose(scan_id, ref_id)
        be_pose = birdseye.get_bird_eye_trans(pts, fpv_pose=world_T_cam)
        rgb, _ = render_tsdf_view(tsdf, be_pose, invK, h, w)
        rgb = draw_camera_marker(rgb.copy(), world_T_cam, np.linalg.inv(be_pose), K)
        # frames in [0, 1]: save_video scales them to 8 bits once
        frames.append(np.clip(rgb, 0, 1))
        if len(frames) % 20 == 0:
            print(f"rendered {len(frames)} frames")
    path = save_video(extra.output, frames, fps=15)
    print(f"wrote {path} ({len(frames)} frames)")
    return {"path": path, "frames": len(frames)}


if __name__ == "__main__":
    main()
