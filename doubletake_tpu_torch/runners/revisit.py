"""Revisit evaluation: hints from a previous session's volume (reference
src/doubletake/test_revisit.py, 3RScan cross-session; the JAX package's
runners/revisit.py).

The hint volume is built from the FIRST visit of a scene by the offline
pass 1 (``compute_hint_volume``, in batches of ``opts.batch_size``). The
rescan's frames then run one at a time with hints raycast from that volume,
their poses mapped into the first visit's world frame by
``first_T_second @ world_T_cam`` for the raycast only (:225-240): the model
still sees the rescan's own poses. The first visit's hint volume is saved
as ``*_hint_tsdf.npz``, as the offline runner saves its pass-1 volume. The
rescan's depths are fused when ``run_fusion`` is set, and the volume saved
with its mesh (``<scan>.ply``) after the rescan's timed window.

Dataset hook: ``revisit_source_scan(scan_id) -> (first_scan_id,
first_T_second_44)``. The 3RScan reader parses 3RScan.json; the synthetic
dataset's rescans ("synthN@M") share the world frame (identity).
"""

from __future__ import annotations

import os
import time

import torch

from doubletake_tpu_torch.data.loader import DataLoader
from doubletake_tpu_torch.datasets.registry import dataset_from_opts
from doubletake_tpu_torch.options import Options
from doubletake_tpu_torch.runners import common
from doubletake_tpu_torch.runners.no_hint import unique_scans
from doubletake_tpu_torch.runners.offline_two_pass import (
    HINT_MAX_DEPTH,
    compute_hint_volume,
    make_pass2_step,
    score_batch,
)
from doubletake_tpu_torch.tools.tsdf import integrate_depth, prepare_static
from doubletake_tpu_torch.utils.metrics import ResultsAverager


def run(opts: Options, model=None):
    """Run the revisit evaluation; returns the frame and scene averages, the
    rescan frames run, the wall times of the first visits' hint passes and
    of the rescan loops (from each one's start to its last sync, loader
    waits included) and, with fusion, each rescan's mesh export (``meshes``).

    ``model``: an already built and weighted model (else built from opts and
    initialised or loaded by ``common.init_or_load_params``).
    """
    if "hint" not in opts.feature_volume_type:
        raise ValueError("revisit mode needs a hint model (mlp_mesh_hint_feature_volume)")
    device = common.resolve_device(opts)
    _, scores_dir, meshes_dir = common.output_dirs(opts, f"revisit_{opts.frame_tuple_type}")
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
    frames, pass_time, meshes = 0, {"first_visit": 0.0, "rescan": 0.0}, {}

    for scan_id in scans:
        scan_name = scan_id.replace("/", "_")
        rescan_ds = dataset_from_opts(opts, split=opts.split, limit_to_scan_id=scan_id,
                                      include_full_res_depth=True)
        if not hasattr(rescan_ds, "revisit_source_scan"):
            raise ValueError(f"dataset {opts.dataset} does not support revisit")
        first_scan_id, first_T_second = rescan_ds.revisit_source_scan(scan_id)
        first_T_second = torch.as_tensor(first_T_second, dtype=torch.float32, device=device)
        first_ds = dataset_from_opts(opts, split=opts.split, limit_to_scan_id=first_scan_id,
                                     include_full_res_depth=True)

        t0 = time.perf_counter()
        hint_tsdf = compute_hint_volume(opts, model, first_ds, first_scan_id, device)
        hint_tsdf.save(os.path.join(meshes_dir, f"{first_scan_id.replace('/', '_')}_hint_tsdf.npz"))
        static = prepare_static(hint_tsdf)
        pass_time["first_visit"] += time.perf_counter() - t0   # the save synchronised

        samples = common.resolve_raycast_samples(opts, hint_tsdf.voxel_size, HINT_MAX_DEPTH)
        step = make_pass2_step(model, hint_h, hint_w, samples, HINT_MAX_DEPTH)
        tsdf = cfg = None
        if opts.run_fusion:
            tsdf, cfg = common.make_fuser(opts, rescan_ds, scan_id, device)
        loader = DataLoader(rescan_ds, batch_size=1, shuffle=False,
                            num_workers=min(4, opts.num_workers))
        scan_metrics = ResultsAverager(opts.name, f"scan {scan_id}")
        t0 = time.perf_counter()
        for cur_np, src_np in loader:
            cur, src = common.device_batch(cur_np, src_np, device)
            cur["hint_world_T_cam_b44"] = torch.matmul(first_T_second, cur["world_T_cam_b44"])
            step_t0 = time.perf_counter()
            out, hint = step(static, cur, src)
            frames += score_batch(out, hint, cur_np, device, step_t0, scan_metrics, all_frame_avg)
            if opts.run_fusion:
                with torch.no_grad():
                    depth = common.depth_for_fusion(opts, out)
                    integrate_depth(tsdf, depth[0], cur["cam_T_world_b44"][0], cur["K_s0_b44"][0],
                                    cfg)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        pass_time["rescan"] += time.perf_counter() - t0

        if opts.run_fusion:
            tsdf = common.finalize_tsdf(opts, tsdf)
            tsdf.save(os.path.join(meshes_dir, f"{scan_name}_tsdf.npz"))
            meshes[scan_name] = common.export_scan_mesh(tsdf, meshes_dir, scan_name)
        scan_metrics.compute_final_average()
        scan_metrics.output_json(os.path.join(scores_dir, f"{scan_name}_metrics.json"))
        scene_avg.update_results(scan_metrics.final_metrics)

    common.write_scores(scores_dir, all_frame_avg, scene_avg)
    return {"frame_avg": all_frame_avg.final_metrics, "scene_avg": scene_avg.final_metrics,
            "frames": frames, "pass_time": pass_time, "meshes": meshes}
