"""Operations and bytes from shapes, and the peaks they are held against.

* ``k1_work``: the fused feature volume's work, counted once per
  pixel-plane as the algorithm needs it: the matching MLP
  [nin, 128, 128, 1] and the hint MLP [3, 12, 12, 1] at 2 FLOP a
  multiply-add; bytes are the current and source matching features, the
  hint, the geometry, the weights read once and the scores written once.
  How the kernel splits its products (three bf16 products a float32
  product) is not counted.
* ``k2_work``: the TSDF integrate's work for one frame: 16 bytes for each
  voxel the frame updates (value and weight read and written) and the
  depth image read once. Which voxels a frame updates depends on the depth
  it fuses, so the count takes the depth map and the pose.
* ``model_flops``: the FLOPs of one delivered depth map of the plain
  reference at a configuration's sizes, counted with
  ``torch.utils.flop_counter.FlopCounterMode`` at a call pattern: one
  forward with the source views' matching features cached
  (``incremental``), or two forwards that encode all views (``offline``:
  pass 1 and pass 2). The numbers are stored in the configuration files
  under ``flops_per_map``; ``benchmark/tests`` recomputes them.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM, published dense rates at the 700 W limit
PEAK_FLOPS = 989e12          # bf16 / fp16 tensor cores
PEAK_BYTES = 3.35e12         # HBM3

MATCHING_HIDDEN = 128
HINT_HIDDEN = 12


def mlp_macs(widths):
    return sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def k1_work(b, k, h, w, d, c=16, hint=True):
    """(FLOPs, bytes) of one fused-volume launch: b frames, k source views,
    an h x w matching grid, d planes, c feature channels."""
    nin = k * c + c + 10 * k + 4
    n = b * h * w
    mlp = [nin, MATCHING_HIDDEN, MATCHING_HIDDEN, 1]
    hint_mlp = [3, HINT_HIDDEN, HINT_HIDDEN, 1]
    macs = mlp_macs(mlp) + (mlp_macs(hint_mlp) if hint else 0)
    flops = 2 * macs * n * d
    weights = mlp_macs(mlp) + sum(mlp[1:])
    if hint:
        weights += mlp_macs(hint_mlp) + sum(hint_mlp[1:])
    floats = (n * c + k * n * c            # current and source features
              + (3 * n if hint else 0)     # hint depth, validity, weight
              + d * n                      # scores
              + weights
              + b * (k * 12 + 3 * h * w + 3 * k + 3 * k)   # P, rays, centres, pose meta
              + d)                                         # planes
    return flops, 4 * floats


def k2_work(updated_voxels, h, w):
    """(FLOPs, bytes) of one integrate launch (its FLOPs are not counted:
    it is bound by memory)."""
    return 0, 16 * updated_voxels + 4 * h * w + 4 * (12 + 3)


def bound_seconds(flops, nbytes):
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def updated_voxels(dims, origin, voxel_size, depth_hw, cam_T_world, K, max_depth, extended):
    """Voxels a fusion step updates (the reference's update predicate)."""
    from benchmark.reference.fusion import Volume, update_terms

    dev = depth_hw.device
    vol = Volume(torch.empty(dims, device=dev), torch.empty(dims, device=dev),
                 torch.as_tensor(origin, dtype=torch.float32, device=dev), voxel_size)
    valid, _, _ = update_terms(vol, depth_hw, cam_T_world, K, max_depth, extended)
    return int(valid.sum())


def model_flops(config: dict, pattern: str) -> int:
    """FLOPs of one delivered map of the reference at the sizes of
    ``config`` (a configuration file's contents), on the CPU."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference.fusion import empty_hint
    from benchmark.reference.weights import reference_model

    o = config["options"]
    h, w = o["image_height"], o["image_width"]
    k = o["model_num_views"] - 1
    model = reference_model(config, 0, "cpu")
    eye = torch.eye(4).expand(1, 4, 4)
    K = torch.tensor([[0.58 * w / 2, 0, w / 4, 0], [0, 0.58 * w / 2, h / 4, 0],
                      [0, 0, 1, 0], [0, 0, 0, 1]])
    cur = {"image_bhw3": torch.zeros(1, h, w, 3), "world_T_cam_b44": eye, "cam_T_world_b44": eye,
           "invK_s1_b44": torch.linalg.inv(K / torch.tensor([2.0, 2.0, 1.0, 1.0])[:, None])[None]}
    eyes = eye[:, None].expand(1, k, 4, 4)
    src = {"image_bkhw3": torch.zeros(1, k, h, w, 3), "world_T_cam_bk44": eyes,
           "cam_T_world_bk44": eyes,
           "K_s1_bk44": (K / torch.tensor([2.0, 2.0, 1.0, 1.0])[:, None]).expand(1, k, 4, 4)}
    hint = empty_hint(1, h, w, "cpu")
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        if pattern == "incremental":
            feats = torch.zeros(1, k, h // 4, w // 4, o["matching_feature_dims"])
            model(cur, src, hint, src_matching_feats=feats)
        elif pattern == "offline":
            model(cur, src, hint)
            model(cur, src, hint)
        else:
            raise ValueError(f"unknown call pattern {pattern!r}")
    return int(counter.get_total_flops())
