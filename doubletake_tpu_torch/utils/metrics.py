"""Depth metrics and results averaging.

Parity with reference src/doubletake/utils/metrics_utils.py:
  * compute_depth_metrics / compute_depth_metrics_batched — abs_diff,
    abs_rel, sq_rel, rmse, rmse_log and inlier ratios a5/a10/a25/a0-a3,
    with the batched variant masking via NaN + nanmean (:51-119);
  * ResultsAverager — running mean for live printing plus a stable final
    mean over stored per-element metrics, JSON export (:122-306).
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

_A_THRESHOLDS = {
    "a5": 1.05,
    "a10": 1.10,
    "a25": 1.25,
    "a0": 1.10,
    "a1": 1.25,
    "a2": 1.25**2,
    "a3": 1.25**3,
}


def compute_depth_metrics_batched(gt_bn, pred_bn, valid_bn, mult_a: bool = False):
    """Per-element metrics over flattened depth maps (B, N) with validity
    masks. Returns dict of (B,) tensors; invalid entries are excluded via
    nanmean, as in the reference."""
    nan = torch.full((), float("nan"), dtype=gt_bn.dtype, device=gt_bn.device)
    gt = torch.where(valid_bn, gt_bn, nan)
    pred = torch.where(valid_bn, pred_bn, nan)

    thresh = torch.maximum(gt / pred, pred / gt)
    out = {}
    for name, t in _A_THRESHOLDS.items():
        a = torch.where(valid_bn, (thresh < t).to(gt.dtype), nan)
        val = torch.nanmean(a, dim=1)
        out[name] = val * 100.0 if mult_a else val

    out["abs_diff"] = torch.nanmean((gt - pred).abs(), dim=1)
    out["abs_rel"] = torch.nanmean((gt - pred).abs() / gt, dim=1)
    out["sq_rel"] = torch.nanmean((gt - pred) ** 2 / gt, dim=1)
    out["rmse"] = torch.sqrt(torch.nanmean((gt - pred) ** 2, dim=1))
    out["rmse_log"] = torch.sqrt(torch.nanmean((torch.log(gt) - torch.log(pred)) ** 2, dim=1))
    return out


def compute_depth_metrics(gt, pred, mult_a: bool = False):
    """Unbatched variant over already-masked (selected) values."""
    gt = gt.reshape(1, -1)
    pred = pred.reshape(1, -1)
    valid = torch.ones_like(gt, dtype=torch.bool)
    out = compute_depth_metrics_batched(gt, pred, valid, mult_a)
    return {k: v[0] for k, v in out.items()}


class ResultsAverager:
    """Running + stable-final metric averaging with JSON export."""

    def __init__(self, exp_name: str, metrics_name: str):
        self.exp_name = exp_name
        self.metrics_name = metrics_name
        self.elem_metrics = []
        self.running_metrics = None
        self.running_count = 0
        self.final_metrics = None

    def update_results(self, elem_metrics: Dict[str, float]):
        clean = {
            k: float(np.asarray(v)) for k, v in elem_metrics.items() if v is not None
        }
        self.elem_metrics.append(clean)
        if self.running_metrics is None:
            self.running_metrics = dict(clean)
        else:
            for k, v in clean.items():
                prev = self.running_metrics.get(k, v)
                self.running_metrics[k] = (
                    prev * self.running_count + v
                ) / (self.running_count + 1)
        self.running_count += 1

    def compute_final_average(self, ignore_nans: bool = False):
        self.final_metrics = {}
        if not self.elem_metrics:
            return
        keys = self.elem_metrics[0].keys()
        for k in keys:
            vals = np.array([m[k] for m in self.elem_metrics if k in m], np.float64)
            self.final_metrics[k] = float(
                np.nanmean(vals) if ignore_nans else np.mean(vals)
            )

    def print_sheets_friendly(self, print_exp_name=True, include_metrics_names=True,
                              print_running_metrics=False):
        metrics = self.running_metrics if print_running_metrics else self.final_metrics
        if metrics is None:
            print("WARNING: no metrics to print.")
            return
        if print_exp_name:
            print(f"{self.exp_name} — {self.metrics_name}")
        if include_metrics_names:
            print(", ".join(metrics.keys()))
        print(", ".join(f"{v:.4f}" for v in metrics.values()))

    def output_json(self, filepath: str, print_running_metrics: bool = False):
        metrics = self.running_metrics if print_running_metrics else self.final_metrics
        payload = {
            "exp_name": self.exp_name,
            "metrics_type": self.metrics_name,
            "scores": metrics or {},
        }
        os.makedirs(os.path.dirname(filepath) or ".", exist_ok=True)
        with open(filepath, "w") as f:
            json.dump(payload, f, indent=2)

    def pretty_print_results(self, print_running_metrics=False):
        metrics = self.running_metrics if print_running_metrics else self.final_metrics
        if metrics is None:
            print("WARNING: no metrics to print.")
            return
        for k, v in metrics.items():
            print(f"{k:>12}: {v:.4f}")
