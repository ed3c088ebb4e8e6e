"""Partial fuser: a TSDF fused frame by frame from cached depths, for hint
renders.

Counterpart of ``doubletake_tpu/tools/partial_fuser.py`` (reference
tools/partial_fuser.py): cached first-pass depths are fused in order, so a
training-data hint can be rendered from the reconstruction as it stood
before each frame, with optional multiplicative depth noise (:59-64) drawn
from a ``numpy.random.RandomState(seed)`` — the same draws as the JAX
package's. Each fuse is ``integrate_depth`` (K2 on a CUDA volume); each
render is ``raycast``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from doubletake_tpu_torch.tools.tsdf import TSDF, FusionConfig, integrate_depth, raycast


class PartialFuser:
    """Fuse cached depths in order; render hints from the running volume."""

    def __init__(self, tsdf: TSDF, config: Optional[FusionConfig] = None,
                 depth_noise: float = 0.0, seed: int = 0):
        self.tsdf = tsdf
        self.config = config or FusionConfig(min_depth=0.5, max_depth=3.0)
        self.depth_noise = depth_noise
        self._rng = np.random.RandomState(seed)

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x, np.float32), device=self.tsdf.values.device)

    def fuse_frame(self, depth_hw1, cam_T_world_44, K_44):
        """Fuse one (H, W, 1) depth map (numpy), noised when depth_noise > 0."""
        depth = np.asarray(depth_hw1, np.float32)
        if self.depth_noise > 0:
            noise = 1.0 + self._rng.randn(*depth.shape).astype(np.float32) * self.depth_noise
            depth = depth * noise
        integrate_depth(self.tsdf, self._tensor(depth), self._tensor(cam_T_world_44),
                        self._tensor(K_44), self.config)

    def render_hint(self, world_T_cam_44, invK_44, height, width,
                    max_depth: Optional[float] = None, num_samples: int = 256):
        """(depth_hw NaN-coded, weights_hw, valid_hw) from the running volume."""
        return raycast(self.tsdf, self._tensor(world_T_cam_44), self._tensor(invK_44),
                       height, width, min_depth=self.config.min_depth,
                       max_depth=max_depth or self.config.max_depth, num_samples=num_samples)
