"""Training losses (NHWC tensors, NaN-coded invalid GT).

Counterpart of ``doubletake_tpu/losses.py``, with its reference
src/doubletake/losses.py and the loss cocktail of
src/doubletake/experiment_modules/sr_depth_model.py:437-526:

    loss = ms_log_l1 + 1.0 * grad + 1.0 * normals + 0.2 * mv

Invalid GT depth is NaN; every loss masks with isfinite and the given
validity mask. Masked selections are masked means (sum(x * m) / sum(m)),
the same values as the reference's boolean selections.
"""

from __future__ import annotations

import torch

from doubletake_tpu_torch.ops.grid_sample import grid_sample_2d
from doubletake_tpu_torch.ops.resize import interpolate_nearest, pyrdown
from doubletake_tpu_torch.utils.geometry import (
    backproject_depth,
    project_points,
    spatial_gradient,
)


def masked_mean(x, mask):
    """Mean of ``x`` over ``mask`` (0 for an empty mask); entries outside the
    mask, NaN included, take no part."""
    m = mask.float()
    denom = torch.clamp(m.sum(), min=1.0)
    return torch.where(mask, x, torch.zeros_like(x)).float().sum() / denom


def scale_invariant_loss(log_depth_gt, log_depth_pred, mask, si_lambda: float = 0.85):
    """Eigen's scale-invariant loss (losses.py:38-50)."""
    d = torch.where(mask, log_depth_gt - log_depth_pred, torch.zeros_like(log_depth_pred))
    m = mask.float()
    n = torch.clamp(m.sum(), min=1.0)
    mean_sq = (d**2 * m).sum() / n
    mean = (d * m).sum() / n
    return torch.sqrt(mean_sq - si_lambda * mean**2)


def ms_gradient_loss(depth_gt_bhw1, depth_pred_bhw1, num_scales: int = 4):
    """Multi-scale gradient L1 (losses.py:11-35). GT NaNs run through the
    blur-pool pyramid and are masked at each scale; the dx and dy errors
    are averaged together under one mask, as the reference does."""
    loss = 0.0
    for pred_d, gt_d in zip(pyrdown(depth_pred_bhw1, num_scales),
                            pyrdown(depth_gt_bhw1, num_scales)):
        gx_gt, gy_gt = spatial_gradient(gt_d)
        gx_p, gy_p = spatial_gradient(pred_d)
        mask = torch.isfinite(gx_gt) & torch.isfinite(gy_gt)
        err = torch.cat([(gx_p - gx_gt).abs(), (gy_p - gy_gt).abs()], -1)
        loss = loss + masked_mean(err, torch.cat([mask, mask], -1))
    return loss


def normals_loss(normals_gt_bhw3, normals_pred_bhw3):
    """(1 - dot) / 2 over pixels where both normals are finite (losses.py:53-74)."""
    mask = (torch.isfinite(normals_gt_bhw3).all(-1, keepdim=True)
            & torch.isfinite(normals_pred_bhw3).all(-1, keepdim=True))
    one = torch.ones((), dtype=normals_pred_bhw3.dtype, device=normals_pred_bhw3.device)
    gt = torch.where(mask, normals_gt_bhw3, one)
    pred = torch.where(mask, normals_pred_bhw3, one)
    dot = (gt * pred).sum(-1, keepdim=True)
    return masked_mean(0.5 * (1.0 - dot), mask)


def mv_depth_loss(depth_pred_bhw1, depth_gt_bhw1, src_depth_bkhw1, cur_invK_b44, src_K_bk44,
                  cur_world_T_cam_b44, src_cam_T_world_bk44):
    """Multi-view reprojection loss (losses.py:77-195).

    For each source view: project the current GT depth into it,
    nearest-sample the source GT depth there, keep points in front of the
    sampled surface (< 1.05x, the occlusion test), and penalise
    |log sampled - log projected prediction| over valid, finite entries.
    Mean over the source views.
    """
    b, h, w, _ = depth_gt_bhw1.shape
    k = src_depth_bkhw1.shape[1]

    def to_src(depth, src_K, src_cam_T_world):
        cam = backproject_depth(depth.reshape(b, 1, -1), cur_invK_b44, h, w)
        world = torch.einsum("bij,bjn->bin", cur_world_T_cam_b44, cam)
        return project_points(world, src_K, src_cam_T_world)

    loss = 0.0
    for ki in range(k):
        src_depth = src_depth_bkhw1[:, ki]
        src_K, src_cam_T_world = src_K_bk44[:, ki], src_cam_T_world_bk44[:, ki]
        gt_src = to_src(depth_gt_bhw1, src_K, src_cam_T_world)
        proj_depth = gt_src[:, 2].reshape(b, h, w, 1)
        px = gt_src[:, :2].reshape(b, 2, h, w)
        grid = torch.stack([2.0 * px[:, 0] / w - 1.0, 2.0 * px[:, 1] / h - 1.0], -1)
        # pixels of invalid GT project to NaN: they are masked below, and
        # sample outside the image here
        grid = torch.nan_to_num(grid, nan=-2.0)
        clean = torch.where(torch.isfinite(src_depth), src_depth, torch.zeros_like(src_depth))
        sampled = grid_sample_2d(clean, grid, mode="nearest")
        valid = (proj_depth < 1.05 * sampled) & (proj_depth > 0) & (sampled > 0)

        pred_depth = to_src(depth_pred_bhw1, src_K, src_cam_T_world)[:, 2].reshape(b, h, w, 1)
        diff = (torch.log(sampled) - torch.log(pred_depth)).abs()
        loss = loss + masked_mean(diff, valid & torch.isfinite(diff))
    return loss / k


def compute_losses(cur_data, src_data, outputs, normals_gt, normals_pred):
    """The loss cocktail (sr_depth_model.py:437-526).

    cur_data: "depth_bhw1" (NaN-coded GT), "mask_b_bhw1" (bool valid),
        "invK_s0_b44", "world_T_cam_b44".
    src_data: "depth_bkhw1", "K_s0_bk44", "cam_T_world_bk44".
    outputs: model outputs with log_depth_pred_s{i}_bhw1 / depth_pred_s0_bhw1.
    """
    depth_gt = cur_data["depth_bhw1"]
    mask_b = cur_data["mask_b_bhw1"]
    depth_pred = outputs["depth_pred_s0_bhw1"]
    log_depth_pred = outputs["log_depth_pred_s0_bhw1"]
    log_depth_gt = torch.log(depth_gt)

    gt_hw = depth_gt.shape[1:3]
    ms_loss = 0.0
    for i in range(4):
        key = f"log_depth_pred_s{i}_bhw1"
        if key in outputs:
            pred_up = interpolate_nearest(outputs[key], gt_hw)
            gt = torch.where(mask_b, log_depth_gt, torch.zeros_like(log_depth_gt))
            ms_loss = ms_loss + masked_mean((gt - pred_up).abs() * mask_b, mask_b) / (2**i)

    grad = ms_gradient_loss(depth_gt, depth_pred)
    n_loss = normals_loss(normals_gt, normals_pred)
    abs_l = masked_mean((depth_gt - depth_pred).abs(), mask_b)
    si = scale_invariant_loss(log_depth_gt, log_depth_pred, mask_b)
    log_l1 = masked_mean((log_depth_gt - log_depth_pred).abs(), mask_b)
    mv = mv_depth_loss(depth_pred, depth_gt, src_data["depth_bkhw1"], cur_data["invK_s0_b44"],
                       src_data["K_s0_bk44"], cur_data["world_T_cam_b44"],
                       src_data["cam_T_world_bk44"])

    loss = ms_loss + 1.0 * grad + 1.0 * n_loss + 0.2 * mv
    return {"loss": loss, "ms_loss": ms_loss, "grad_loss": grad, "normals_loss": n_loss,
            "abs_loss": abs_l, "si_loss": si, "log_l1_loss": log_l1, "mv_loss": mv}
