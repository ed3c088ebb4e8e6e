"""Visualisation helpers: depth colormapping, tiling, per-frame panels and
video export.

Counterpart of ``doubletake_tpu/utils/visualization.py`` (reference
utils/visualization_utils.py): a colormap with percentile-based vmin/vmax
(:15-73; turbo from the port's own copy of matplotlib's table), image
tiling, the quick_viz_export panels (:210-321), and videos through ffmpeg,
or a PNG sequence where ffmpeg is absent. PIL is imported where an image is
written, so hosts without it run everything else; no matplotlib is needed.
"""

from __future__ import annotations

import os
import subprocess
from typing import Optional

import numpy as np

from doubletake_tpu_torch.utils.io import reverse_imagenet_normalize
from doubletake_tpu_torch.utils.turbo import TURBO


def colormap_image(depth_hw: np.ndarray, mask_hw: Optional[np.ndarray] = None,
                   colormap: str = "turbo", vmin: Optional[float] = None,
                   vmax: Optional[float] = None, return_vminvmax: bool = False):
    """Depth -> RGB in [0, 1]; invalid pixels black. vmin/vmax default to the
    5th and 95th percentiles of the valid values. ``turbo``, the only
    colormap the port draws with, is looked up in the port's own table as
    matplotlib looks up its listed colormaps; another name raises."""
    if colormap != "turbo":
        raise ValueError(f"colormap {colormap!r}: only 'turbo' is available")
    depth = np.asarray(depth_hw, np.float32)
    if depth.ndim == 3:
        depth = depth[..., 0]
    valid = np.isfinite(depth)
    if mask_hw is not None:
        valid &= np.asarray(mask_hw, bool).reshape(valid.shape)
    vals = depth[valid]
    if vmin is None:
        vmin = float(np.percentile(vals, 5)) if vals.size else 0.0
    if vmax is None:
        vmax = float(np.percentile(vals, 95)) if vals.size else 1.0
    norm = np.clip((depth - vmin) / max(vmax - vmin, 1e-6), 0.0, 1.0)
    # matplotlib's ListedColormap: index int(x * N) in x's type, 1.0 -> N - 1
    x = np.nan_to_num(norm) * norm.dtype.type(len(TURBO))
    rgb = TURBO[np.minimum(x.astype(int), len(TURBO) - 1)].astype(np.float32)
    rgb[~valid] = 0.0
    if return_vminvmax:
        return rgb, vmin, vmax
    return rgb


def tile_images(images, cols: int = 2):
    """Tile same-size HxWx3 images into a grid, row-major."""
    images = [np.asarray(im) for im in images]
    h, w = images[0].shape[:2]
    rows = (len(images) + cols - 1) // cols
    canvas = np.zeros((rows * h, cols * w, 3), images[0].dtype)
    for i, im in enumerate(images):
        r, c = divmod(i, cols)
        canvas[r * h: (r + 1) * h, c * w: (c + 1) * w] = im
    return canvas


def save_image(path: str, image_hw3: np.ndarray):
    """An 8-bit PNG (or other PIL format) of an image in [0, 1]."""
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = np.clip(np.asarray(image_hw3) * 255.0, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def quick_viz_export(out_dir: str, frame_name: str, image_bhw3=None, depth_pred=None,
                     depth_gt=None, hint_depth=None, fixed_min_max: bool = False):
    """One frame's panel ``<out_dir>/<frame_name>.png``: the image, the GT
    depth, the prediction and the hint side by side, the depths coloured
    over the GT's range (0-5 m with ``fixed_min_max``), each panel resized
    to the first's size by nearest (the reference's quick_viz_export,
    visualization_utils.py:210-321)."""
    panels = []
    vmin = 0.0 if fixed_min_max else None
    vmax = 5.0 if fixed_min_max else None
    if image_bhw3 is not None:
        panels.append(np.clip(reverse_imagenet_normalize(np.asarray(image_bhw3)), 0, 1))
    if depth_gt is not None:
        gt_rgb, vmin, vmax = colormap_image(depth_gt, vmin=vmin, vmax=vmax,
                                            return_vminvmax=True)
        panels.append(gt_rgb)
    if depth_pred is not None:
        panels.append(colormap_image(depth_pred, vmin=vmin, vmax=vmax))
    if hint_depth is not None:
        panels.append(colormap_image(hint_depth, vmin=vmin, vmax=vmax))
    if not panels:
        return
    h, w = panels[0].shape[:2]
    resized = []
    for p in panels:
        if p.shape[:2] != (h, w):
            ys = np.floor(np.arange(h) * p.shape[0] / h).astype(int)
            xs = np.floor(np.arange(w) * p.shape[1] / w).astype(int)
            p = p[ys][:, xs]
        resized.append(p)
    save_image(os.path.join(out_dir, f"{frame_name}.png"), tile_images(resized))


def save_video(out_path: str, frames, fps: int = 30):
    """Write HxWx3 frames as an mp4 through ffmpeg; where ffmpeg is absent
    or fails, the PNG sequence in ``<out_path>_frames`` stays. Returns the
    path written."""
    import shutil

    seq_dir = out_path + "_frames"
    os.makedirs(seq_dir, exist_ok=True)
    for i, f in enumerate(frames):
        save_image(os.path.join(seq_dir, f"{i:06d}.png"), f)
    if write_video(seq_dir, out_path, fps) is None:
        return seq_dir
    shutil.rmtree(seq_dir)
    return out_path


def write_video(image_dir: str, out_path: str, fps: int = 30):
    """Encode ``image_dir``'s PNGs to an mp4 with ffmpeg; None where ffmpeg
    is absent or fails."""
    try:
        subprocess.run(["ffmpeg", "-y", "-framerate", str(fps), "-pattern_type", "glob",
                        "-i", os.path.join(image_dir, "*.png"), "-c:v", "libx264",
                        "-pix_fmt", "yuv420p", out_path], check=True, capture_output=True)
        return out_path
    except (FileNotFoundError, subprocess.CalledProcessError):
        return None
