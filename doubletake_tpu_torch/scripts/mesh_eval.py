"""Mesh metrics CLI (reference scripts/evals/mesh_eval.py; the JAX
package's scripts/mesh_eval.py).

Scores predicted meshes (``<scan>.ply`` in a results dir) against GT meshes
with the TransformerFusion protocol and visibility masking (the visibility
lookup on ``--device``); writes per-scene and summary JSON.

    python -m doubletake_tpu_torch.scripts.mesh_eval --pred_dir PRED --gt_dir GT \
        [--visibility_dir VIS] [--output_json mesh_metrics.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

from doubletake_tpu_torch.eval.mesh_eval import evaluate_mesh
from doubletake_tpu_torch.eval.visibility import SimpleVolume
from doubletake_tpu_torch.options import Options
from doubletake_tpu_torch.runners.common import resolve_device
from doubletake_tpu_torch.tools.marching_cubes import load_ply
from doubletake_tpu_torch.utils.metrics import ResultsAverager


def main(argv=None):
    """Score every scan; returns the JSON payload written."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--pred_dir", required=True,
                        help="directory with <scan>.ply predicted meshes")
    parser.add_argument("--gt_dir", required=True,
                        help="directory with <scan>.ply ground-truth meshes")
    parser.add_argument("--visibility_dir", default=None,
                        help="directory with <scan>_visibility.npz volumes")
    parser.add_argument("--output_json", default="mesh_metrics.json")
    parser.add_argument("--scans", nargs="*", default=None)
    parser.add_argument("--device", default="cuda",
                        help="device of the visibility lookup (cuda unless cpu is asked)")
    args = parser.parse_args(argv)
    device = resolve_device(Options(device=args.device))

    scans = args.scans or sorted(
        f[:-4] for f in os.listdir(args.pred_dir) if f.endswith(".ply"))
    averager = ResultsAverager("mesh_eval", "scene avg")
    per_scene = {}
    for scan in scans:
        pred_v, pred_f = load_ply(os.path.join(args.pred_dir, f"{scan}.ply"))
        gt_v, gt_f = load_ply(os.path.join(args.gt_dir, f"{scan}.ply"))
        vis = None
        if args.visibility_dir:
            vis_path = os.path.join(args.visibility_dir, f"{scan}_visibility.npz")
            if os.path.exists(vis_path):
                vis = SimpleVolume.load(vis_path, device=device)
        metrics = evaluate_mesh(pred_v, pred_f, gt_v, gt_f, visibility_volume=vis)
        per_scene[scan] = metrics
        averager.update_results(metrics)
        print(scan, {k: round(v, 4) for k, v in metrics.items()})

    averager.compute_final_average()
    payload = {"per_scene": per_scene, "summary": averager.final_metrics}
    with open(args.output_json, "w") as f:
        json.dump(payload, f, indent=2)
    print("summary:", averager.final_metrics)
    return payload


if __name__ == "__main__":
    main()
