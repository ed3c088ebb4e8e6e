"""Offline two-pass DoubleTake evaluation (reference
src/doubletake/test_offline_two_pass.py; the JAX package's
runners/offline_two_pass.py).

Pass 1 runs the model with empty hints over the scan, in batches of
``opts.batch_size``, and fuses its depths into a hint volume locked at
0.04 m / 3.0 m (:47-69). Pass 2 re-estimates every depth, again in batches,
with hints raycast from that volume, which no longer changes: it is rounded
once (``prepare_static``) and each batch raycasts all its poses in one
march. The final fusion at the score resolution (0.02 m / 3.5 m for
published scores) runs frame by frame, since the running weighted mean
depends on the order, when ``run_fusion`` is set.

On a CUDA device with the model in eval mode, each batch's forward is the
replay of a CUDA graph kept with the model (``runners.graphs``): one graph
a batch shape serves both passes, pass 1's empty hint being a hint of pass
2's shape, so the batch's inputs and outputs are held once. Pass 2's
raycast is one more replay; its graphs, one a batch shape and pose key,
all read the model's one static-volume slot, into which each session's
static volume is copied once. A shape runs eagerly at its first use and
is captured at its second, so a scan's smaller last batch runs eagerly
until its shape comes back. The per-frame fuses stay eager; with no sync
between batches the host issues them while the card works. Elsewhere (the
CPU, training) both passes run eagerly.

Both volumes are saved in the JAX package's npz format (``*_hint_tsdf.npz``,
``*_tsdf.npz``), and the final volume's mesh as ``<scan>.ply``, after pass
2's timed window.
"""

from __future__ import annotations

import os
import time

import torch

from doubletake_tpu_torch.data.loader import DataLoader
from doubletake_tpu_torch.datasets.registry import dataset_from_opts
from doubletake_tpu_torch.options import Options
from doubletake_tpu_torch.runners import common, graphs
from doubletake_tpu_torch.runners.no_hint import unique_scans
from doubletake_tpu_torch.tools.tsdf import StaticVolume, integrate_depth, prepare_static
from doubletake_tpu_torch.utils.metrics import ResultsAverager
from doubletake_tpu_torch.utils.tracing import span, spanned

HINT_MAX_DEPTH = 3.0  # the hint volume's fusion range (test_offline_two_pass.py:47-69)


def make_forward(model, device):
    """(stages, forward): the model's ``graphs.Stages`` on ``device`` (None
    where it runs eagerly) and ``forward(cur, src, hint)``, the model's
    outputs with ``hint``. On a CUDA device with the model in eval mode
    ``forward`` replays the graph of the arguments' shapes (module doc),
    under the weights as they are now: the caller keeps them fixed while it
    uses ``forward``. Elsewhere it runs the model eagerly."""

    @torch.no_grad()
    def forward(cur, src, hint):
        return model(cur, src, hint=hint, return_mask=True)

    stages = graphs.stages(model, device)
    if stages is None:
        return None, forward
    weights_at = stages.weights_key()
    return stages, lambda cur, src, hint: stages.run_on_weights(
        weights_at, forward, (cur, src, hint))


@torch.no_grad()
def compute_hint_volume(opts, model, ds, scan_id, device):
    """Pass 1: empty-hint inference over ``ds`` fused into the locked hint
    volume (the model's raw s0 depths, frame by frame). The empty hint is
    at image / 4, pass 2's hint size: the model resizes an all-invalid
    hint to the same zeros from any size."""
    tsdf, cfg = common.make_hint_fuser(opts, ds, scan_id, device)
    _, forward = make_forward(model, device)
    loader = DataLoader(ds, batch_size=opts.batch_size, shuffle=False,
                        num_workers=opts.num_workers)
    for cur_np, src_np in loader:
        with span("runner.pass1_batch"):
            cur, src = common.device_batch(cur_np, src_np, device)
            b, h, w = cur["image_bhw3"].shape[:3]
            out = forward(cur, src, common.empty_hint(b, h // 4, w // 4, device))
            depth = out["depth_pred_s0_bhw1"]
            for i in range(b):
                integrate_depth(tsdf, depth[i], cur["cam_T_world_b44"][i], cur["K_s0_b44"][i],
                                cfg)
    return tsdf


def make_pass2_step(model, hint_h, hint_w, raycast_samples, hint_max_depth):
    """Pass 2 step: ``step(static_vol, cur, src) -> (out, hint)``. Raycasts
    the static hint volume at every pose of the batch (at
    cur["hint_world_T_cam_b44"] where the revisit runner maps the poses
    into the volume's world frame; the model still sees the batch's own
    poses) and runs the model with those hints. No fusion inside.

    On a CUDA volume with the model in eval mode the raycast and the
    forward each replay a CUDA graph (module doc), and the step hands back
    tensors of its own. It moves tensors of its callers to other storage
    with ``Tensor.set_``, keeping their values: the static volume's values
    and weights onto the model's static-volume slot (``graphs.Slot``; the
    previous session's storage, where the shape is the same), and at a
    stage's capture the batch's tensors it reads onto copies. The model's
    stages and the weights are read once, at the first call: a step
    assumes them fixed while it is used."""
    stages = forward = None
    settings = ("pass2_hint", hint_h, hint_w, raycast_samples, hint_max_depth)

    def render(vol, pose):
        return common.render_hint(vol, pose, hint_h, hint_w, raycast_samples, hint_max_depth)

    @spanned("runner.step")
    @torch.no_grad()
    def step(static_vol, cur, src):
        nonlocal stages, forward
        if forward is None:
            stages, forward = make_forward(model, static_vol.values.device)
        pose = {k: cur[k] for k in common.HINT_KEYS if k in cur}
        if stages is None:
            hint = render(static_vol, pose)
        else:
            values, weights = stages.static.bind(static_vol)
            voxel_size = static_vol.voxel_size
            hint = stages.run_on_volume(
                stages.static, (settings, voxel_size),
                lambda p, origin: render(StaticVolume(values, weights, origin, voxel_size), p),
                (pose, static_vol.origin))
        model_cur = {k: v for k, v in cur.items() if k != "hint_world_T_cam_b44"}
        return forward(model_cur, src, hint), hint

    return step


def score_batch(out, hint, cur_np, device, t0, scan_metrics, all_frame_avg):
    """Metrics of a pass-2 batch, one row per frame with its hint coverage
    and its share of the batch's step time (synchronises)."""
    depth = out["depth_pred_s0_bhw1"]
    metrics = common.frame_metrics(depth, torch.as_tensor(cur_np["full_res_depth_bhw1"]).to(device))
    metrics["hint_coverage"] = hint["hint_mask_bhw1"].float().flatten(1).mean(1)
    rows = common.frame_rows(metrics)
    frame_time = (time.perf_counter() - t0) / len(rows)
    for fm in rows:
        fm["frame_time"] = frame_time
        scan_metrics.update_results(fm)
        all_frame_avg.update_results(fm)
    return len(rows)


def run(opts: Options, model=None):
    """Run the offline two-pass evaluation; returns the frame and scene
    averages, the frames run, each pass's wall time over all scans (from
    the pass's start to its last sync, loader waits included) and, with
    fusion, each scan's mesh export (``meshes``).

    ``model``: an already built and weighted model (else built from opts and
    initialised or loaded by ``common.init_or_load_params``).
    """
    if "hint" not in opts.feature_volume_type:
        raise ValueError("offline two-pass mode needs a hint model (mlp_mesh_hint_feature_volume)")
    device = common.resolve_device(opts)
    _, scores_dir, meshes_dir = common.output_dirs(opts, f"offline_two_pass_{opts.frame_tuple_type}")
    if model is None:
        model = common.init_or_load_params(opts, common.build_model(opts))
    model.eval()

    probe = dataset_from_opts(opts, split=opts.split, include_full_res_depth=True)
    scans = unique_scans(probe)
    if opts.single_debug_scan_id:
        scans = [s for s in scans if s == opts.single_debug_scan_id]
    hint_h, hint_w = opts.image_height // 4, opts.image_width // 4

    all_frame_avg = ResultsAverager(opts.name, "frame avg")
    scene_avg = ResultsAverager(opts.name, "scene avg")
    frames, pass_time, meshes = 0, {"pass1": 0.0, "pass2": 0.0}, {}

    for scan_id in scans:
        scan_name = scan_id.replace("/", "_")
        ds = dataset_from_opts(opts, split=opts.split, limit_to_scan_id=scan_id,
                               include_full_res_depth=True)

        t0 = time.perf_counter()
        hint_tsdf = compute_hint_volume(opts, model, ds, scan_id, device)
        hint_tsdf.save(os.path.join(meshes_dir, f"{scan_name}_hint_tsdf.npz"))  # synchronises
        pass_time["pass1"] += time.perf_counter() - t0

        samples = common.resolve_raycast_samples(opts, hint_tsdf.voxel_size, HINT_MAX_DEPTH)
        step = make_pass2_step(model, hint_h, hint_w, samples, HINT_MAX_DEPTH)
        static = prepare_static(hint_tsdf)
        final_tsdf = final_cfg = None
        if opts.run_fusion:
            final_tsdf, final_cfg = common.make_fuser(opts, ds, scan_id, device)
        loader = DataLoader(ds, batch_size=opts.batch_size, shuffle=False,
                            num_workers=opts.num_workers)
        scan_metrics = ResultsAverager(opts.name, f"scan {scan_id}")
        t0 = time.perf_counter()
        for cur_np, src_np in loader:
            cur, src = common.device_batch(cur_np, src_np, device)
            step_t0 = time.perf_counter()
            out, hint = step(static, cur, src)
            frames += score_batch(out, hint, cur_np, device, step_t0, scan_metrics, all_frame_avg)
            if opts.run_fusion:
                with torch.no_grad():
                    fusion_depth = common.depth_for_fusion(opts, out)
                    for i in range(fusion_depth.shape[0]):
                        integrate_depth(final_tsdf, fusion_depth[i], cur["cam_T_world_b44"][i],
                                        cur["K_s0_b44"][i], final_cfg)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        pass_time["pass2"] += time.perf_counter() - t0

        scan_metrics.compute_final_average()
        scan_metrics.output_json(os.path.join(scores_dir, f"{scan_name}_metrics.json"))
        scene_avg.update_results(scan_metrics.final_metrics)
        if opts.run_fusion:
            final_tsdf = common.finalize_tsdf(opts, final_tsdf)
            final_tsdf.save(os.path.join(meshes_dir, f"{scan_name}_tsdf.npz"))
            meshes[scan_name] = common.export_scan_mesh(final_tsdf, meshes_dir, scan_name)

    common.write_scores(scores_dir, all_frame_avg, scene_avg)
    return {"frame_avg": all_frame_avg.final_metrics, "scene_avg": scene_avg.final_metrics,
            "frames": frames, "pass_time": pass_time, "meshes": meshes}
