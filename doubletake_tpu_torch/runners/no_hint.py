"""No-hint depth evaluation (reference src/doubletake/test_no_hint.py; the
JAX package's runners/no_hint.py).

Per scan, frames run through the model in batches of ``opts.batch_size``:
SimpleRecon (``DepthModel``), or DoubleTake with an all-invalid hint. Each
frame is scored against its full-resolution GT (valid > 0.5 m), and
optionally fused (0.02 m / 3.5 m for published scores; with its RGB when
``fuse_color`` is set) and its depth cached to an npz. Scores go to per-scan
and overall JSONs. A batch's model time is taken with CUDA events on the GPU
(host clock on the CPU) and shared by its frames. Fusion saves the TSDF npz
and then its mesh, ``<scan>.ply``, after the scan loop's timed window.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from doubletake_tpu_torch.data.loader import DataLoader
from doubletake_tpu_torch.datasets.registry import dataset_from_opts
from doubletake_tpu_torch.options import Options
from doubletake_tpu_torch.runners import common
from doubletake_tpu_torch.tools.tsdf import integrate_depth
from doubletake_tpu_torch.utils.metrics import ResultsAverager


def unique_scans(dataset):
    """The dataset's scan ids in the order their tuples first appear."""
    seen, scans = set(), []
    for line in dataset.frame_tuples:
        scan = line.split(" ")[0]
        if scan not in seen:
            seen.add(scan)
            scans.append(scan)
    return scans


def run(opts: Options, model=None):
    """Run the no-hint evaluation; returns the frame and scene averages, the
    frames run, the scan loops' wall time (from each loop's start to its
    last sync, loader waits included) and, with fusion, each scan's mesh
    export (``meshes``: seconds, vertex and face counts).

    ``model``: an already built and weighted model (else built from opts and
    initialised or loaded by ``common.init_or_load_params``).
    """
    device = common.resolve_device(opts)
    base, scores_dir, meshes_dir = common.output_dirs(opts, f"no_hint_{opts.frame_tuple_type}")
    if model is None:
        model = common.init_or_load_params(opts, common.build_model(opts))
    model.eval()
    use_hint = "hint" in opts.feature_volume_type

    probe = dataset_from_opts(opts, split=opts.split, include_full_res_depth=True)
    scans = unique_scans(probe)
    if opts.single_debug_scan_id:
        scans = [s for s in scans if s == opts.single_debug_scan_id]

    all_frame_avg = ResultsAverager(opts.name, "frame avg")
    scene_avg = ResultsAverager(opts.name, "scene avg")
    frames, scan_time, meshes = 0, 0.0, {}

    for scan_id in scans:
        ds = dataset_from_opts(opts, split=opts.split, limit_to_scan_id=scan_id,
                               include_full_res_depth=True, pass_frame_id=opts.cache_depths)
        loader = DataLoader(ds, batch_size=opts.batch_size, shuffle=False,
                            num_workers=opts.num_workers)
        tsdf = cfg = None
        if opts.run_fusion:
            tsdf, cfg = common.make_fuser(opts, ds, scan_id, device)
        scan_metrics = ResultsAverager(opts.name, f"scan {scan_id}")
        cached_depths, cached_frame_ids = [], []
        scan_t0 = time.perf_counter()
        for cur_np, src_np in loader:
            cur, src = common.device_batch(cur_np, src_np, device)
            t0 = time.perf_counter()
            clock = common.StageClock(device)
            with torch.no_grad():
                clock.mark("start")
                hint = None
                if use_hint:
                    b, h, w = cur["image_bhw3"].shape[:3]
                    hint = common.empty_hint(b, h, w, device)
                out = model(cur, src, hint=hint, return_mask=True)
                clock.mark("model")
                depth = out["depth_pred_s0_bhw1"]
                metrics = common.frame_metrics(
                    depth, torch.as_tensor(cur_np["full_res_depth_bhw1"]).to(device))
            bsz = depth.shape[0]
            rows = common.frame_rows(metrics)          # synchronises
            shared = {"frame_time": (time.perf_counter() - t0) / bsz,
                      "model_time": clock.elapsed_ms()["model"] / 1e3 / bsz}
            for fm in rows:
                fm.update(shared)
                scan_metrics.update_results(fm)
                all_frame_avg.update_results(fm)
            frames += bsz

            if opts.run_fusion:
                with torch.no_grad():
                    fusion_depth = common.depth_for_fusion(opts, out)
                    rgb = common.rgb_for_fusion(opts, cur, fusion_depth.shape[1:3])
                    for i in range(bsz):
                        integrate_depth(tsdf, fusion_depth[i], cur["cam_T_world_b44"][i],
                                        cur["K_s0_b44"][i], cfg,
                                        image_hw3=None if rgb is None else rgb[i])
            if opts.cache_depths:
                cached_depths.append(depth.cpu().numpy())
                cached_frame_ids.extend(cur_np.get("frame_id_string", []))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        scan_time += time.perf_counter() - scan_t0

        scan_name = scan_id.replace("/", "_")
        scan_metrics.compute_final_average()
        scan_metrics.output_json(os.path.join(scores_dir, f"{scan_name}_metrics.json"))
        scene_avg.update_results(scan_metrics.final_metrics)
        if opts.cache_depths and cached_depths:
            cache_dir = os.path.join(base, "depth_cache")
            os.makedirs(cache_dir, exist_ok=True)
            np.savez_compressed(
                os.path.join(cache_dir, f"{scan_name}_depths.npz"),
                depths=np.concatenate(cached_depths, axis=0),
                frame_ids=np.asarray([fid.split("_")[-1] for fid in cached_frame_ids]))
        if opts.run_fusion:
            tsdf = common.finalize_tsdf(opts, tsdf)
            tsdf.save(os.path.join(meshes_dir, f"{scan_name}_tsdf.npz"))
            meshes[scan_name] = common.export_scan_mesh(tsdf, meshes_dir, scan_name)

    common.write_scores(scores_dir, all_frame_avg, scene_avg)
    return {"frame_avg": all_frame_avg.final_metrics, "scene_avg": scene_avg.final_metrics,
            "frames": frames, "scan_time": scan_time, "meshes": meshes}
