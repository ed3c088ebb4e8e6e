"""Mesh metrics: Chamfer distance and F-score, TransformerFusion protocol.

Counterpart of ``doubletake_tpu/eval/mesh_eval.py`` (reference
scripts/evals/mesh_eval.py): 200k area-weighted surface samples per mesh
(numpy ``RandomState`` draws, the same as the JAX package's), nearest-
neighbour distances clamped at 1.0 m, accuracy / completion / Chamfer in cm,
precision / recall / F-score at 5 cm, and visibility-volume occlusion masking
of the predicted points (:34-37, :164-172). Host side (numpy + scipy
cKDTree); only the visibility lookup runs on the volume's device.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
from scipy.spatial import cKDTree

NUM_SAMPLES = 200_000
DIST_CLAMP = 1.0       # meters
FSCORE_THRESHOLD = 0.05  # meters


def sample_mesh_points(verts: np.ndarray, faces: np.ndarray,
                       num_samples: int = NUM_SAMPLES, seed: int = 0) -> np.ndarray:
    """Area-weighted uniform surface sampling."""
    if len(faces) == 0:
        return np.zeros((0, 3), np.float32)
    v0 = verts[faces[:, 0]]
    v1 = verts[faces[:, 1]]
    v2 = verts[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    total = areas.sum()
    if total <= 0:
        return np.zeros((0, 3), np.float32)
    rng = np.random.RandomState(seed)
    tri = rng.choice(len(faces), num_samples, p=areas / total)
    r1 = np.sqrt(rng.rand(num_samples, 1))
    r2 = rng.rand(num_samples, 1)
    pts = (1 - r1) * v0[tri] + r1 * (1 - r2) * v1[tri] + r1 * r2 * v2[tri]
    return pts.astype(np.float32)


def compute_mesh_metrics(
    pred_points: np.ndarray,
    gt_points: np.ndarray,
    visibility_mask_pred: Optional[np.ndarray] = None,
    dist_clamp: float = DIST_CLAMP,
    fscore_threshold: float = FSCORE_THRESHOLD,
) -> Dict[str, float]:
    """TransformerFusion-style metrics from sampled point sets (meters in,
    centimeters out for distances)."""
    if visibility_mask_pred is not None and visibility_mask_pred.any():
        pred_points = pred_points[visibility_mask_pred]

    if len(pred_points) == 0 or len(gt_points) == 0:
        return {k: float("nan") for k in
                ("acc", "compl", "chamfer", "precision", "recall", "fscore")}

    d_pred_to_gt = cKDTree(gt_points).query(pred_points, k=1)[0]
    d_gt_to_pred = cKDTree(pred_points).query(gt_points, k=1)[0]
    d_pred_to_gt = np.minimum(d_pred_to_gt, dist_clamp)
    d_gt_to_pred = np.minimum(d_gt_to_pred, dist_clamp)

    acc = float(d_pred_to_gt.mean())
    compl = float(d_gt_to_pred.mean())
    precision = float((d_pred_to_gt < fscore_threshold).mean())
    recall = float((d_gt_to_pred < fscore_threshold).mean())
    fscore = (2 * precision * recall / (precision + recall)
              if precision + recall > 0 else 0.0)
    return {
        "acc": acc * 100.0,        # cm
        "compl": compl * 100.0,    # cm
        "chamfer": (acc + compl) / 2.0 * 100.0,  # cm
        "precision": precision,
        "recall": recall,
        "fscore": fscore,
    }


def evaluate_mesh(
    pred_verts, pred_faces, gt_verts, gt_faces,
    visibility_volume=None, num_samples: int = NUM_SAMPLES, seed: int = 0,
) -> Dict[str, float]:
    """Full protocol: sample both meshes, mask the predicted points by a
    ``eval.visibility.SimpleVolume`` (nearest sample > 0.5) when given."""
    pred_pts = sample_mesh_points(pred_verts, pred_faces, num_samples, seed)
    gt_pts = sample_mesh_points(gt_verts, gt_faces, num_samples, seed + 1)

    vis_mask = None
    if visibility_volume is not None and len(pred_pts):
        vis = visibility_volume.sample(pred_pts, method="nearest")
        vis_mask = vis.cpu().numpy() > 0.5
    return compute_mesh_metrics(pred_pts, gt_pts, vis_mask)
