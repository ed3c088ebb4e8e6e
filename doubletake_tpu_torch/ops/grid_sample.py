"""Grid sampling with the JAX package's NHWC interface, over ``F.grid_sample``.

The reference uses three flavours of ``F.grid_sample`` (cost_volume.py:190-196
bilinear 2D, align_corners=False, zeros padding; tsdf.py:480-486 nearest 2D;
tsdf.py:332-337 trilinear 3D, align_corners=True). These wrappers take and
return channels-last tensors, like ``doubletake_tpu.ops.grid_sample``, so the
callers and tests compare like with like.
"""

from __future__ import annotations

import torch.nn.functional as F


def grid_sample_2d(input_nhwc, grid_nhw2, mode: str = "bilinear",
                   padding_mode: str = "zeros", align_corners: bool = False):
    """2D grid sample, NHWC layout, torch semantics.

    input_nhwc: (N, H_in, W_in, C); grid_nhw2: (N, H_out, W_out, 2) in
    [-1, 1], last dim (x, y). Returns (N, H_out, W_out, C).
    """
    if padding_mode != "zeros":
        raise NotImplementedError("only zeros padding is supported")
    dtype = input_nhwc.dtype
    # the grid in the input's type, as the JAX package casts it; a bf16
    # input is then sampled in float32 and the result rounded to bf16: the
    # JAX package maps coordinates to pixels in float32, where torch's bf16
    # sampler would round them to bf16 (and its CPU version returns NaN for
    # a channels-last bf16 input)
    out = F.grid_sample(
        input_nhwc.permute(0, 3, 1, 2).float(), grid_nhw2.to(dtype).float(),
        mode=mode, padding_mode="zeros", align_corners=align_corners,
    )
    return out.permute(0, 2, 3, 1).to(dtype)


def grid_sample_3d(volume_dhwc, points_n3, mode: str = "bilinear",
                   align_corners: bool = True):
    """Sample a 3D volume at normalized points.

    volume_dhwc: (D0, D1, D2, C) volume in index order; points_n3: (N, 3)
    in [-1, 1], points_n3[:, i] indexing axis i. Returns (N, C); zeros
    outside the volume.
    """
    vol = volume_dhwc.permute(3, 0, 1, 2)[None]          # (1, C, D0, D1, D2)
    # torch's grid last dim is (x, y, z) = (axis 2, axis 1, axis 0)
    grid = points_n3.flip(-1).to(volume_dhwc.dtype)[None, :, None, None, :]
    out = F.grid_sample(vol, grid, mode=mode, padding_mode="zeros",
                        align_corners=align_corners)    # (1, C, N, 1, 1)
    return out[0, :, :, 0, 0].t()
