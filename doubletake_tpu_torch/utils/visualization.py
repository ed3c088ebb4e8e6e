"""Depth colormapping for the training image panels.

Counterpart of ``colormap_image`` in ``doubletake_tpu/utils/visualization.py``
(reference utils/visualization_utils.py:15-73): a matplotlib colormap with
percentile-based vmin/vmax. matplotlib is imported where a panel is drawn,
so hosts without it run everything else.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def colormap_image(depth_hw: np.ndarray, mask_hw: Optional[np.ndarray] = None,
                   colormap: str = "turbo", vmin: Optional[float] = None,
                   vmax: Optional[float] = None, return_vminvmax: bool = False):
    """Depth -> RGB in [0, 1]; invalid pixels black. vmin/vmax default to the
    5th and 95th percentiles of the valid values."""
    from matplotlib import colormaps

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
    rgb = colormaps[colormap](norm)[..., :3].astype(np.float32)
    rgb[~valid] = 0.0
    if return_vminvmax:
        return rgb, vmin, vmax
    return rgb
