"""The numbers that decide ``correct``: the program's outputs of one
session against the reference's, worked out again from the same frames.
The offline reference runs the whole session on its own; the incremental
reference follows the program step by step, fusing the program's depths
(``benchmark/reference/chain.incremental``), because an independent online
chain amplifies K1's rounding through the bf16-rounded hint raycast.

* ``depth_rel_p99``: the 99th percentile, over every pixel of every
  compared frame, of |program depth - reference depth| / reference depth
  (the s0 depth maps: both encoders, K1's cost volume, the cost-volume
  encoder and the decoder);
* ``hint_valid_mismatch``: the share of hint pixels valid on one side only
  (the raycast of the running or static volume, and the weight threshold);
* ``hint_depth_p99``: the 99th percentile of |hint depth difference| in
  metres over pixels valid on both sides;
* ``tsdf_p99`` (and ``hint_tsdf_p99`` for the offline pass-1 volume): the
  99th percentile of |value difference| over voxels that either side
  observed (weight > 0); a voxel observed on one side only differs by its
  whole value (K2's fuses).

Each cell's workload file gives the limit of each number it compares.
"""

from __future__ import annotations

import torch


def quantile(x: torch.Tensor, q: float) -> float:
    x = x.flatten().double()
    if x.numel() == 0:
        return 0.0
    k = min(x.numel(), max(1, int(round(q * x.numel()))))
    return float(x.kthvalue(k).values)


def _volume(prefix, kept, ref):
    observed = (kept[prefix + "weights"] > 0) | (ref[prefix + "weights"] > 0)
    diff = (kept[prefix + "values"] - ref[prefix + "values"]).abs()[observed]
    return {prefix + "tsdf_p99": quantile(diff, 0.99)}


def numbers(kept: dict, ref: dict) -> dict:
    out = {}
    d_p, d_r = kept["depth"].double(), ref["depth"].double()
    rel = ((d_p - d_r).abs() / d_r.abs().clamp(min=1e-6))
    rel = torch.where(torch.isfinite(rel), rel, torch.full_like(rel, float("inf")))
    out["depth_rel_p99"] = quantile(rel, 0.99)
    v_p, v_r = kept["hint_valid"], ref["hint_valid"]
    out["hint_valid_mismatch"] = float((v_p != v_r).double().mean())
    both = v_p & v_r
    out["hint_depth_p99"] = quantile((kept["hint_depth"] - ref["hint_depth"]).abs()[both], 0.99)
    out.update(_volume("", kept, ref))
    if "hint_values" in kept:
        out.update(_volume("hint_", kept, ref))
    return out
