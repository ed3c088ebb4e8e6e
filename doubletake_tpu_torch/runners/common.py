"""Shared runner infrastructure: device selection, model construction and
weights, stage timing, the metric protocol (nearest upsample to full-res
GT, valid > 0.5 m), the fusers (with colour), the hint render and the mesh
export.

Protocol parity with the reference eval scripts (test_no_hint.py:177-212,
test_incremental.py:290-326): predictions are nearest-upsampled to the
full-res GT depth, masked to GT > 0.5 m (and finite), and averaged per
frame, per scene, and overall via ResultsAverager.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Tuple

import torch

from doubletake_tpu_torch.checkpoints.convert import lazy_load_state_dict, load_weights
from doubletake_tpu_torch.checkpoints.io import cast_floating
from doubletake_tpu_torch.data.loader import staged_images, to_device
from doubletake_tpu_torch.models.depth_model import get_model_class
from doubletake_tpu_torch.models.layers import init_parameters
from doubletake_tpu_torch.ops.resize import interpolate_bilinear, interpolate_nearest
from doubletake_tpu_torch.options import Options
from doubletake_tpu_torch.tools.marching_cubes import export_mesh
from doubletake_tpu_torch.tools.tsdf import TSDF, FusionConfig, auto_raycast_samples, raycast
from doubletake_tpu_torch.utils.io import IMAGENET_MEAN, IMAGENET_STD
from doubletake_tpu_torch.utils.metrics import compute_depth_metrics_batched
# the runners' and the benchmark's ``common.StageClock``
from doubletake_tpu_torch.utils.tracing import StageClock, spanned  # noqa: F401

EVAL_MIN_DEPTH = 0.5  # valid GT depth threshold (test_no_hint.py:184)
HINT_WEIGHT_THRESHOLD = 0.025  # test_incremental.py:244

# keys the step consumes
CUR_KEYS = ("image_bhw3", "cam_T_world_b44", "world_T_cam_b44", "invK_s1_b44",
            "K_s0_b44", "invK_s0_b44")
SRC_KEYS = ("image_bkhw3", "cam_T_world_bk44", "world_T_cam_bk44", "K_s1_bk44")


def resolve_device(opts: Options) -> torch.device:
    """The device the runner works on. CUDA unless the caller asks for the
    CPU; a CUDA request without a CUDA device raises (no silent fallback).
    On CUDA, float32 convolutions and matmuls run in full float32 (cuDNN's
    TF32 default would move EfficientNetV2-S by ~1e-3 relative)."""
    device = torch.device(opts.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but no CUDA device is present; pass device='cpu' "
                "explicitly to run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return device


def build_model(opts: Options) -> torch.nn.Module:
    """Construct the model from options (model registry parity), on
    ``opts.device``, in eval mode, without weights (see init_or_load_params)."""
    device = resolve_device(opts)
    model_type = opts.model_type or opts.extra.get("model_type", "depth_model")
    if opts.loss_type != "log_l1":
        raise ValueError(f"loss_type: {opts.loss_type} unknown")
    if opts.cv_encoder_type != "multi_scale_encoder":
        raise ValueError(f"cv_encoder_type: {opts.cv_encoder_type} unknown")
    model = get_model_class(model_type)(
        image_encoder_name=opts.image_encoder_name,
        depth_decoder_name=opts.depth_decoder_name,
        feature_volume_type=opts.feature_volume_type,
        matching_encoder_type=opts.matching_encoder_type,
        matching_scale=opts.matching_scale,
        matching_num_depth_bins=opts.matching_num_depth_bins,
        matching_feature_dims=opts.matching_feature_dims,
        model_num_views=opts.model_num_views,
        min_matching_depth=opts.min_matching_depth,
        max_matching_depth=opts.max_matching_depth,
        plane_chunk=opts.plane_chunk,
        fast_cost_volume=opts.fast_cost_volume,
        compute_dtype=opts.compute_dtype,
    )
    return model.to(device).eval()


def init_or_load_params(opts: Options, model: torch.nn.Module) -> torch.nn.Module:
    """Load weights from opts.load_weights_from_checkpoint (a reference
    ``.ckpt`` or a JAX-package npz, through the weights bridge), or
    initialise from a generator seeded with opts.random_seed. With
    opts.lazy_load_weights_from_checkpoint, the checkpoint's entries whose
    names and shapes match are then copied over the initialisation and the
    rest keep it (the JAX package's ``lazy_load_params``; reference
    model_utils.py:47-63). Under compute_dtype "bfloat16" the weights and
    the batch-norm statistics are then cast to bf16 (``maybe_cast``)."""
    path = opts.load_weights_from_checkpoint
    if path and os.path.exists(path):
        model.load_state_dict(load_weights(path))
        return maybe_cast(opts, model)
    device = next(model.parameters()).device
    generator = torch.Generator().manual_seed(opts.random_seed)
    model.cpu()
    init_parameters(model, generator)
    model.to(device)
    lazy_path = opts.lazy_load_weights_from_checkpoint
    if lazy_path and os.path.exists(lazy_path):
        lazy_load_state_dict(model, load_weights(lazy_path))
    return maybe_cast(opts, model)


def maybe_cast(opts: Options, model: torch.nn.Module) -> torch.nn.Module:
    """bf16 compute: cast the parameters and the floating buffers (batch-norm
    statistics included) so the layers compute in bf16 (the JAX package's
    ``_maybe_cast``; the model casts the images at entry)."""
    if opts.compute_dtype == "bfloat16":
        return cast_floating(model, torch.bfloat16)
    return model


def empty_hint(b: int, h: int, w: int, device):
    """An all-invalid hint, as the JAX runners feed before a volume exists."""
    zero = torch.zeros((b, h, w, 1), dtype=torch.float32, device=device)
    return {"depth_hint_bhw1": zero, "hint_mask_bhw1": zero.bool(),
            "sampled_weights_bhw1": zero}


# what a hint's raycast reads of the frame (``render_hint``)
HINT_KEYS = ("world_T_cam_b44", "hint_world_T_cam_b44", "invK_s0_b44")


def render_hint(vol, cur, hint_h, hint_w, raycast_samples, max_depth, use_mip=False):
    """Hint dict for the model, raycast from ``vol`` (a running ``TSDF`` or
    a ``StaticVolume``) at every pose of the batch: cur["world_T_cam_b44"],
    or cur["hint_world_T_cam_b44"] where a runner maps the poses into the
    volume's world frame. Pixels below weight 0.025 are invalid.
    ``use_mip``: the candidate-block march (``raycast_mip``)."""
    pose = cur.get("hint_world_T_cam_b44", cur["world_T_cam_b44"])
    hint_d, hint_wt, hint_v = raycast(
        vol, pose, cur["invK_s0_b44"], hint_h, hint_w, min_depth=EVAL_MIN_DEPTH,
        max_depth=max_depth, num_samples=raycast_samples, use_mip=use_mip)
    valid = hint_v & (hint_wt >= HINT_WEIGHT_THRESHOLD)
    return {
        "depth_hint_bhw1": torch.where(valid, hint_d, torch.full_like(hint_d, float("nan")))[..., None],
        "hint_mask_bhw1": valid[..., None],
        "sampled_weights_bhw1": torch.where(valid, hint_wt, torch.zeros_like(hint_wt))[..., None],
    }


def rgb_for_fusion(opts: Options, cur, out_hw):
    """De-normalised RGB at the fusion depth's size for colour fusion, or
    None without ``fuse_color`` (the reference's Open3DFuser resizes the
    colour to the depth map; JAX runners/common.py:95-105)."""
    if not opts.fuse_color:
        return None
    img = cur["image_bhw3"]
    img = (img * torch.as_tensor(IMAGENET_STD, device=img.device)
           + torch.as_tensor(IMAGENET_MEAN, device=img.device))
    return interpolate_bilinear(img, out_hw).clamp(0.0, 1.0)


def depth_for_fusion(opts: Options, out):
    """Depth fed to the fuser, honoring mask_pred_depth (invalidate pixels
    with no valid MVS info) and fusion_use_raw_lowest_cost (fuse the cost
    volume argmax) — reference test_no_hint.py:214-240."""
    depth = out["depth_pred_s0_bhw1"]
    if opts.fusion_use_raw_lowest_cost:
        depth = interpolate_nearest(out["lowest_cost_bhw"][..., None], depth.shape[1:3])
    if opts.mask_pred_depth:
        mask = out["overall_mask_bhw"][..., None].float()
        m = interpolate_nearest(mask, depth.shape[1:3]) > 0.5
        depth = torch.where(m, depth, torch.full_like(depth, -1.0))
    return depth


def finalize_tsdf(opts: Options, tsdf: TSDF) -> TSDF:
    """Pre-export trim: zero low-confidence voxels (reference
    fusers_helper.py:468-469, trim_tsdf_using_confience), in place."""
    if opts.trim_tsdf_using_confience:
        tsdf.values.masked_fill_(tsdf.weights < 0.02, 0.0)
    return tsdf


@spanned("runner.device_batch")
def device_batch(cur_np: Dict, src_np: Dict, device, cur_keys=CUR_KEYS, src_keys=SRC_KEYS):
    """The step's (cur, src) tensors on ``device`` from a loader batch: the
    keys ``cur_keys`` / ``src_keys`` that the batch has. A batch of
    ``data.loader.collate`` crosses key by key. A staged batch (the
    loader's, ``data/loader.py``) crosses its frames once and its other
    keys from page-locked memory, all without blocking the host; the
    device normalises the frames and gathers ``image_bhw3`` /
    ``image_bkhw3`` (``data.loader.staged_images``)."""
    if "frames_fhw3" not in cur_np:
        cur = {k: torch.as_tensor(cur_np[k]).to(device) for k in cur_keys if k in cur_np}
        src = {k: torch.as_tensor(src_np[k]).to(device) for k in src_keys if k in src_np}
        return cur, src
    device = torch.device(device)
    image, images = staged_images(cur_np["frames_fhw3"], cur_np["frame_index_b"],
                                  src_np["frame_index_bk"], device)
    cur_np = dict(cur_np, image_bhw3=image)
    src_np = dict(src_np, image_bkhw3=images)
    cur = {k: to_device(cur_np[k], device) for k in cur_keys if k in cur_np}
    src = {k: to_device(src_np[k], device) for k in src_keys if k in src_np}
    return cur, src


def frame_metrics(depth_pred_bhw1, full_gt_bhw1, mult_a: bool = True):
    """Reference metric protocol: nearest-upsample pred to full-res GT,
    mask GT finite and > 0.5 m. Returns dict of per-frame (B,) tensors."""
    gt_hw = full_gt_bhw1.shape[1:3]
    pred_up = interpolate_nearest(depth_pred_bhw1, gt_hw)
    b = full_gt_bhw1.shape[0]
    gt = full_gt_bhw1.reshape(b, -1)
    pred = pred_up.reshape(b, -1)
    valid = torch.isfinite(gt) & (gt > EVAL_MIN_DEPTH)
    return compute_depth_metrics_batched(gt, pred, valid, mult_a=mult_a)


def frame_rows(metrics):
    """Per-frame dicts of python floats from (B,) metric tensors
    (synchronises)."""
    host = {k: v.cpu().numpy() for k, v in metrics.items()}
    b = next(iter(host.values())).shape[0]
    return [{k: float(v[i]) for k, v in host.items()} for i in range(b)]


def write_scores(scores_dir, all_frame_avg, scene_avg):
    """Final frame and scene averages: JSONs and a printout."""
    all_frame_avg.compute_final_average()
    scene_avg.compute_final_average()
    all_frame_avg.output_json(os.path.join(scores_dir, "all_frame_avg_metrics.json"))
    scene_avg.output_json(os.path.join(scores_dir, "scene_avg_metrics.json"))
    print("\nScene averages:")
    scene_avg.pretty_print_results()
    print("\nFrame averages:")
    all_frame_avg.pretty_print_results()


def scene_bounds_for_fusion(dataset, scan_id, max_extent: float = 10.0):
    """TSDF bounds: dataset GT bounds when available (get_fuser parity —
    fusers_helper.py:214-260 uses the GT mesh), else fixed +-max_extent."""
    if hasattr(dataset, "get_gt_mesh_bounds"):
        mn, mx = dataset.get_gt_mesh_bounds(scan_id)
        return {"xmin": float(mn[0]), "xmax": float(mx[0]),
                "ymin": float(mn[1]), "ymax": float(mx[1]),
                "zmin": float(mn[2]), "zmax": float(mx[2])}
    return {"xmin": -max_extent, "xmax": max_extent, "ymin": -max_extent,
            "ymax": max_extent, "zmin": -max_extent, "zmax": max_extent}


def make_fuser(opts: Options, dataset, scan_id, device) -> Tuple[TSDF, FusionConfig]:
    """Score fuser: resolution and max depth from opts (0.02 m / 3.5 m for
    published scores), extended negative truncation optional.

    depth_fuser names the reference's fuser family (get_fuser,
    fusers_helper.py:214-260): "ours" is the paper-score fuser, "open3d" /
    "custom_open3d" were its colour-capable Open3D wrappers. One TSDF covers
    all three; it carries colours with ``fuse_color`` or an open3d name, as
    the JAX package's does (runners/common.py:189-208)."""
    if opts.depth_fuser not in ("ours", "open3d", "custom_open3d"):
        raise ValueError(f"depth_fuser: {opts.depth_fuser} unknown")
    with_color = opts.fuse_color or opts.depth_fuser in ("open3d", "custom_open3d")
    tsdf = TSDF.from_bounds(scene_bounds_for_fusion(dataset, scan_id),
                            opts.fusion_resolution, device=device, with_color=with_color)
    cfg = FusionConfig(min_depth=EVAL_MIN_DEPTH, max_depth=opts.fusion_max_depth,
                       extended_neg_truncation=opts.extended_neg_truncation)
    return tsdf, cfg


def make_hint_fuser(opts: Options, dataset, scan_id, device) -> Tuple[TSDF, FusionConfig]:
    """Hint-volume fuser locked to 0.04 m / 3.0 m (reference
    test_offline_two_pass.py:47-69; JAX runners/common.py:227-234)."""
    tsdf = TSDF.from_bounds(scene_bounds_for_fusion(dataset, scan_id), 0.04, device=device)
    cfg = FusionConfig(min_depth=EVAL_MIN_DEPTH, max_depth=3.0,
                       extended_neg_truncation=opts.extended_neg_truncation)
    return tsdf, cfg


def export_scan_mesh(tsdf: TSDF, meshes_dir: str, scan_name: str):
    """``<scan_name>.ply`` from a finalised volume (vertex colours when it
    has colours); returns the export's seconds (host clock, the copy of the
    volume to the host included) and its vertex and face counts."""
    t0 = time.perf_counter()
    verts, faces = export_mesh(tsdf, os.path.join(meshes_dir, f"{scan_name}.ply"))
    return {"export_s": time.perf_counter() - t0, "verts": len(verts), "faces": len(faces)}


def resolve_raycast_samples(opts: Options, voxel_size: float, max_depth: float) -> int:
    """opts.raycast_samples, with 0 meaning the band-derived minimal safe
    budget (tools.tsdf.auto_raycast_samples)."""
    if opts.raycast_samples:
        return opts.raycast_samples
    return auto_raycast_samples(voxel_size, EVAL_MIN_DEPTH, max_depth,
                                opts.extended_neg_truncation)


def output_dirs(opts: Options, mode: str):
    base = os.path.join(opts.output_base_path, opts.name, mode)
    scores = os.path.join(base, "scores")
    meshes = os.path.join(base, "meshes")
    os.makedirs(scores, exist_ok=True)
    os.makedirs(meshes, exist_ok=True)
    return base, scores, meshes

