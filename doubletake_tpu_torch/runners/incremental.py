"""Incremental (online) DoubleTake evaluation — the flagship mode.

Reference: src/doubletake/test_incremental.py; the JAX package's
runners/incremental.py. Per scan, frames arrive in order; each frame
raycasts the running TSDF for a hint (depth + confidence, invalid below
weight 0.025 — :244), runs the model with the hint injected into the cost
volume, computes metrics, and fuses the predicted depth into the volume.
The first frame needs no special case: an empty volume raycasts to an
all-invalid hint.

The hint is rendered at image/4 with the depth-resolution intrinsics
``invK_s0``, exactly as the JAX runner does, so the two packages agree.

With ``raycast_mip`` the hint takes the candidate-block mip march
(``tools.tsdf.raycast(use_mip=True)``), as only the JAX incremental runner
reads that option. With ``dump_depth_visualization`` each frame's image,
GT, prediction and hint panel is written under ``<base>/viz`` (the JAX
runner's ``quick_viz_export``, incremental.py:270-280); the other runners
ignore the option, as theirs do.

The volume lives on the device for the whole scan and the fuse step updates
it in place. Each frame's hint / model / fuse times are taken with CUDA
events on the GPU (host clock on the CPU) and stored with its metrics. The
step is three stages (``make_split_steps``); on the card each is the replay
of a CUDA graph (``runners.graphs``), and the clock's marks fall between
the replays. With ``split_timing`` the device is
synchronised after each of them and the stages are timed by the host clock,
as the JAX runner's split steps report ``hint_time`` and ``model_time``;
the src views' cached matching features are used in both modes, so both
compute the same depths. After the scan loop's timed window the run saves
the TSDF npz, its mesh (``<scan>.ply``) and the score JSONs.
"""

from __future__ import annotations

import os
import time
from collections import OrderedDict

import torch

from doubletake_tpu_torch.data.loader import DataLoader
from doubletake_tpu_torch.datasets.registry import dataset_from_opts
from doubletake_tpu_torch.options import Options
from doubletake_tpu_torch.runners import common, graphs
from doubletake_tpu_torch.runners.no_hint import unique_scans
from doubletake_tpu_torch.tools.tsdf import TSDF, integrate_depth
from doubletake_tpu_torch.utils.metrics import ResultsAverager
from doubletake_tpu_torch.utils.tracing import spanned
from doubletake_tpu_torch.utils.visualization import quick_viz_export

FEAT_CACHE_MAX = 64            # keyframe tuples reach back a few dozen frames
# what each stage reads of the frame and of the forward's outputs
HINT_KEYS = ("world_T_cam_b44", "hint_world_T_cam_b44", "invK_s0_b44")
FUSE_KEYS = ("cam_T_world_b44", "K_s0_b44")
FUSE_OUT_KEYS = ("depth_pred_s0_bhw1", "lowest_cost_bhw", "overall_mask_bhw")


def make_step(model, cfg, hint_h, hint_w, raycast_samples, fusion_max_depth, opts=None):
    """Per-frame step: raycast hint -> forward -> fuse (in place).

    ``step(tsdf, cur, src, src_feats=None, clock=None)`` returns (out, hint,
    tsdf). ``src_feats`` are the src views' cached matching features (every
    src view of a sequential scan was the cur frame earlier), so the
    matching encoder runs on one image instead of model_num_views.

    On a CUDA volume with the model in eval mode each stage is the replay
    of a CUDA graph, kept with the model across steps and sessions
    (``runners.graphs``); elsewhere (the CPU, training) the stages run
    eagerly. On the graph path the step hands back outputs of their own,
    and it moves tensors of its callers to other storage with
    ``Tensor.set_``, keeping their values:

    * the volume's ``values`` and ``weights`` onto the storage the graphs
      read (the previous session's, where the shape is the same), so views
      of them taken before the step no longer see the fused volume; and
    * at a stage's capture, the frame's tensors it reads (``cur``, ``src``,
      ``src_feats``, the hint) onto copies, so a tensor that shared its
      storage with them (other frames' views of one staged block) no longer
      shares it.

    The weights are read once, at the first graphed frame: a step assumes
    them fixed while it is used.
    """
    hint_step, forward_step, fuse_step = make_split_steps(
        model, cfg, hint_h, hint_w, raycast_samples, fusion_max_depth, opts)
    settings = (hint_h, hint_w, raycast_samples, fusion_max_depth, cfg,
                None if opts is None else (opts.raycast_mip, opts.mask_pred_depth,
                                           opts.fusion_use_raw_lowest_cost))
    weights_at = None

    @spanned("runner.step")
    def step(tsdf, cur, src, src_feats=None, clock=None):
        nonlocal weights_at
        if clock is not None:
            clock.mark("start")
        stages = graphs.stages(model, tsdf.values.device)
        values, weights, voxel_size = tsdf.values, tsdf.weights, tsdf.voxel_size
        if stages is not None:
            values, weights = stages.bind(tsdf)
            if weights_at is None:
                weights_at = stages.weights_key()

        def run(name, fn, *args):
            if stages is None:
                return fn(*args)
            if name == "forward":
                return stages.run_on_weights(weights_at, fn, args)
            return stages.run_on_volume((name, voxel_size, settings), fn, args)

        def on(origin):   # the volume as the graphs read it, its origin an argument
            return TSDF(values, weights, origin, voxel_size)

        def fuse(o, c, origin):   # hands back nothing: no graph keeps the volume
            fuse_step(on(origin), o, c)

        hint = run("hint", lambda c, origin: hint_step(on(origin), c),
                   {k: cur[k] for k in HINT_KEYS if k in cur}, tsdf.origin)
        if clock is not None:
            clock.mark("hint")
        if src_feats is not None:   # the source images are not read
            src = {k: v for k, v in src.items() if k != "image_bkhw3"}
        out = run("forward", forward_step, cur, src, hint, src_feats)
        if clock is not None:
            clock.mark("model")
        run("fuse", fuse, {k: out[k] for k in FUSE_OUT_KEYS if out.get(k) is not None},
            {k: cur[k] for k in FUSE_KEYS}, tsdf.origin)
        if clock is not None:
            clock.mark("fuse")
        return out, hint, tsdf

    return step


def make_split_steps(model, cfg, hint_h, hint_w, raycast_samples, fusion_max_depth,
                     opts=None):
    """Separate hint / forward / fuse callables (the JAX runner's split
    steps, for the reference's model_time / hint_time split,
    test_incremental.py:273-288)."""
    use_mip = bool(opts is not None and opts.raycast_mip)

    @torch.no_grad()
    def hint_step(tsdf, cur):
        return common.render_hint(tsdf, cur, hint_h, hint_w, raycast_samples, fusion_max_depth,
                                  use_mip=use_mip)

    @torch.no_grad()
    def forward_step(cur, src, hint, src_feats=None):
        return model(cur, src, hint=hint, return_mask=True, src_matching_feats=src_feats)

    @torch.no_grad()
    def fuse_step(tsdf, out, cur):
        depth = common.depth_for_fusion(opts, out) if opts is not None else out["depth_pred_s0_bhw1"]
        return integrate_depth(tsdf, depth[0], cur["cam_T_world_b44"][0], cur["K_s0_b44"][0], cfg)

    return hint_step, forward_step, fuse_step


def run(opts: Options, model=None):
    """Run the incremental evaluation; returns the frame and scene averages,
    each frame's metrics and stage times (``frame_rows``), the frames run,
    the scan loops' wall time and each scan's mesh export (``meshes``:
    seconds, vertex and face counts).

    ``model``: an already built and weighted model (else built from opts and
    initialised or loaded by ``common.init_or_load_params``).
    """
    if "hint" not in opts.feature_volume_type:
        raise ValueError("incremental mode needs a hint model (mlp_mesh_hint_feature_volume)")
    device = common.resolve_device(opts)
    base, scores_dir, meshes_dir = common.output_dirs(opts, f"incremental_{opts.frame_tuple_type}")
    if model is None:
        model = common.init_or_load_params(opts, common.build_model(opts))
    model.eval()

    probe = dataset_from_opts(opts, split=opts.split, include_full_res_depth=True)
    scans = unique_scans(probe)
    if opts.single_debug_scan_id:
        scans = [s for s in scans if s == opts.single_debug_scan_id]

    # hints at matching resolution (image / 4): the cost volume uses them
    # nearest-resized to matching resolution anyway
    hint_h, hint_w = opts.image_height // 4, opts.image_width // 4

    all_frame_avg = ResultsAverager(opts.name, "frame avg")
    scene_avg = ResultsAverager(opts.name, "scene avg")
    # wall time of the scan loops, from each loop's start to its last
    # frame's sync: unlike the per-frame times it includes loader waits
    frames, scan_time, meshes = 0, 0.0, {}

    for scan_id in scans:
        ds = dataset_from_opts(opts, split=opts.split, limit_to_scan_id=scan_id,
                               include_full_res_depth=True, pass_frame_id=True)
        # batch size 1 is mandatory: frames are sequential (reference :25)
        loader = DataLoader(ds, batch_size=1, shuffle=False, num_workers=min(4, opts.num_workers))
        tsdf, cfg = common.make_fuser(opts, ds, scan_id, device)
        samples = common.resolve_raycast_samples(opts, tsdf.voxel_size, opts.fusion_max_depth)
        step = make_step(model, cfg, hint_h, hint_w, samples, opts.fusion_max_depth, opts=opts)

        feat_cache: "OrderedDict[str, torch.Tensor]" = OrderedDict()
        scan_metrics = ResultsAverager(opts.name, f"scan {scan_id}")
        scan_t0 = time.perf_counter()
        for frame_idx, (cur_np, src_np) in enumerate(loader):
            cur, src = common.device_batch(cur_np, src_np, device)
            t0 = time.perf_counter()
            ids = src_np["frame_id_string"][0]
            src_feats = None
            if all(i in feat_cache for i in ids):
                src_feats = torch.stack([feat_cache[i] for i in ids])[None]
            clock = common.StageClock(device, synced=opts.split_timing)
            out, hint, tsdf = step(tsdf, cur, src, src_feats=src_feats, clock=clock)
            fid = cur_np["frame_id_string"][0]
            feat_cache[fid] = out["matching_feats_bhwc"][0]
            feat_cache.move_to_end(fid)
            while len(feat_cache) > FEAT_CACHE_MAX:
                feat_cache.popitem(last=False)

            metrics = common.frame_metrics(
                out["depth_pred_s0_bhw1"], torch.as_tensor(cur_np["full_res_depth_bhw1"]).to(device))
            fm = common.frame_rows(metrics)[0]          # synchronises
            fm["frame_time"] = time.perf_counter() - t0
            stages = clock.elapsed_ms()
            fm["hint_time"] = stages["hint"] / 1e3
            fm["model_time"] = stages["model"] / 1e3
            fm["fuse_time"] = stages["fuse"] / 1e3
            fm["hint_coverage"] = float(hint["hint_mask_bhw1"].float().mean())
            scan_metrics.update_results(fm)
            all_frame_avg.update_results(fm)
            frames += 1
            if opts.dump_depth_visualization:
                quick_viz_export(
                    os.path.join(base, "viz"), f"{scan_id.replace('/', '_')}_{frame_idx:06d}",
                    image_bhw3=cur["image_bhw3"][0].cpu().numpy(),
                    depth_pred=out["depth_pred_s0_bhw1"][0].float().cpu().numpy(),
                    depth_gt=cur_np["depth_bhw1"][0],
                    hint_depth=hint["depth_hint_bhw1"][0].cpu().numpy(),
                    fixed_min_max=opts.viz_fixed_min_max)
        scan_time += time.perf_counter() - scan_t0

        scan_metrics.compute_final_average()
        scan_metrics.output_json(os.path.join(scores_dir, f"{scan_id.replace('/', '_')}_metrics.json"))
        scene_avg.update_results(scan_metrics.final_metrics)
        scan_name = scan_id.replace("/", "_")
        tsdf = common.finalize_tsdf(opts, tsdf)
        tsdf.save(os.path.join(meshes_dir, f"{scan_name}_tsdf.npz"))
        meshes[scan_name] = common.export_scan_mesh(tsdf, meshes_dir, scan_name)

    common.write_scores(scores_dir, all_frame_avg, scene_avg)
    return {"frame_avg": all_frame_avg.final_metrics, "scene_avg": scene_avg.final_metrics,
            "frame_rows": all_frame_avg.elem_metrics, "frames": frames, "scan_time": scan_time,
            "meshes": meshes}
