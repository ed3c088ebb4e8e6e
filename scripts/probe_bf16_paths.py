"""Where the port's bf16 model departs from its plain path, on one GPU.

    python3 scripts/probe_bf16_paths.py [--batch 4]

On the first batch of the synthetic scan at 512x384, with the flagship
model (random weights from seed 0) in compute_dtype "bfloat16" and an empty
hint (offline pass 1's forward), compares:
  * the volume: K1's bf16 mode against the plain path, both from the
    model's own matching features (``stop_after="cost_volume"``);
  * the s0 depth of the kernel path (K: K1, volume cast to bf16, bf16
    decoders), the plain path (P: float32 volume, so float32 decoders on
    bf16 weights) and the plain volume cast to bf16 through the kernel
    path's bf16 decoders (C), with cuDNN on and off;
  * the float32 model's s0 depth on the same batch (F).
Prints the p99 and max of each |difference| and writes
chiprun_out/probe_bf16_paths.json.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def stats(a, b):
    import numpy as np

    d = (a.float() - b.float()).abs().flatten(1).cpu().numpy()
    return {"p99": float(np.percentile(d, 99, axis=1).max()), "max": float(d.max()),
            "mean": float(d.mean())}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from doubletake_tpu_torch.models import cost_volume
    from doubletake_tpu_torch.ops.fused_volume import feature_volume_plain
    from doubletake_tpu_torch.runners import common

    out_dir = os.path.join(ROOT, "chiprun_out")
    opts = cs.throughput_options(out_dir, "probe_bf16")
    batch_np = cs.first_batch(opts, "synth0", args.batch)
    cur, src = common.device_batch(*batch_np, "cuda")
    hint = common.empty_hint(args.batch, opts.image_height, opts.image_width, "cuda")
    f32 = common.init_or_load_params(opts, common.build_model(opts))
    opts.compute_dtype = "bfloat16"
    model = common.init_or_load_params(opts, common.build_model(opts))
    plain = cs.plain_copy(model)
    res = {}
    with torch.no_grad():
        vk = model(cur, src, hint=hint, stop_after="cost_volume")["cost_volume_bhwd"]
        vp = plain(cur, src, hint=hint, stop_after="cost_volume")["cost_volume_bhwd"]
        res["volume_K_vs_P"] = stats(vk, vp)
        res["volume_range"] = [float(vp.min()), float(vp.max())]
        depth = {"K": model(cur, src, hint=hint)["depth_pred_s0_bhw1"],
                 "P": plain(cur, src, hint=hint)["depth_pred_s0_bhw1"],
                 "F": f32(cur, src, hint=hint)["depth_pred_s0_bhw1"]}
        kernel = cost_volume.fused_feature_volume
        cost_volume.fused_feature_volume = feature_volume_plain
        try:
            depth["C"] = model(cur, src, hint=hint)["depth_pred_s0_bhw1"]
            torch.backends.cudnn.enabled = False
            depth["C_no_cudnn"] = model(cur, src, hint=hint)["depth_pred_s0_bhw1"]
            depth["P_no_cudnn"] = plain(cur, src, hint=hint)["depth_pred_s0_bhw1"]
        finally:
            cost_volume.fused_feature_volume = kernel
        depth["K_no_cudnn_convs"] = model(cur, src, hint=hint)["depth_pred_s0_bhw1"]
        torch.backends.cudnn.enabled = True
    for a, b in (("K", "P"), ("C", "P"), ("K", "C"), ("C_no_cudnn", "P_no_cudnn"),
                 ("K_no_cudnn_convs", "P_no_cudnn"), ("C", "C_no_cudnn"), ("K", "F"),
                 ("P", "F")):
        res[f"depth_{a}_vs_{b}"] = stats(depth[a], depth[b])
    res["depth_range"] = [float(depth["F"].min()), float(depth["F"].max())]
    res["card"] = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True).stdout.strip()
    for k, v in res.items():
        print(k, v)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "probe_bf16_paths.json"), "w") as f:
        json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
