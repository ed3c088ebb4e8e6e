"""Time the port's model forward on one GPU, for comparing two trees.

    python3 scripts/time_forward.py --root DIR [--reps 10] [--bf16]

Imports ``doubletake_tpu_torch`` from the tree at DIR (a checkout of any
commit of the port) and times, with CUDA events (warm, median of --reps),
the eval forward of:
  * the flagship model (EfficientNetV2-S, ResNet matching, hint volume,
    U-Net++, 64 planes, 8 views, fast cost volume) at 512x384, b=1 and b=16
    with an empty hint (offline pass 1's forward);
  * the SimpleRecon model (metadata volume, no hint MLP) at b=16;
  * offline pass 2's step at b=16 (``make_pass2_step``: the batched hint
    raycast of the empty 0.04 m hint volume of the synthetic room, then the
    flagship forward with those hints);
  * with --bf16 (trees with the bf16 compute dtype), the flagship forward at b=16 and pass
    2's step again at compute_dtype "bfloat16".
Weights come from seed 0; images are random normal, poses and intrinsics
those of the synthetic scan's first tuples. Prints one JSON line with the
tree, the card's name and power limit and the times in ms; run two trees
in turns in one call (parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys


def batch(ds, b, device):
    import numpy as np
    import torch

    cur = {k: [] for k in ("cam_T_world_b44", "world_T_cam_b44", "invK_s1_b44")}
    src = {k: [] for k in ("cam_T_world_bk44", "world_T_cam_bk44", "K_s1_bk44")}
    K1 = ds.load_intrinsics("synth0")["K_s1_b44"].astype(np.float32)
    for i in range(b):
        scan, *ids = ds.frame_tuples[i].split(" ")
        poses = [ds.load_pose(scan, f) for f in ids]          # (world_T_cam, cam_T_world)
        cur["world_T_cam_b44"].append(poses[0][0])
        cur["cam_T_world_b44"].append(poses[0][1])
        cur["invK_s1_b44"].append(np.linalg.inv(K1))
        src["world_T_cam_bk44"].append(np.stack([p[0] for p in poses[1:]]))
        src["cam_T_world_bk44"].append(np.stack([p[1] for p in poses[1:]]))
        src["K_s1_bk44"].append(np.stack([K1] * (len(poses) - 1)))
    g = torch.Generator().manual_seed(0)
    out_c = {k: torch.from_numpy(np.stack(v).astype(np.float32)).to(device) for k, v in cur.items()}
    out_s = {k: torch.from_numpy(np.stack(v).astype(np.float32)).to(device) for k, v in src.items()}
    k = out_s["K_s1_bk44"].shape[1]
    out_c["image_bhw3"] = torch.randn((b, 384, 512, 3), generator=g).to(device)
    out_s["image_bkhw3"] = torch.randn((b, k, 384, 512, 3), generator=g).to(device)
    return out_c, out_s


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--bf16", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch

    from doubletake_tpu_torch.datasets.synthetic import SyntheticDataset
    from doubletake_tpu_torch.options import Options
    from doubletake_tpu_torch.runners import common, offline_two_pass
    from doubletake_tpu_torch.tools.tsdf import prepare_static

    def options(hint, dtype="float32"):
        o = Options()
        o.compute_dtype = dtype
        o.model_type = "cv_hint_depth_model" if hint else "depth_model"
        o.feature_volume_type = "mlp_mesh_hint_feature_volume" if hint else "mlp_feature_volume"
        o.image_encoder_name, o.matching_encoder_type = "efficientnet", "resnet"
        o.depth_decoder_name, o.fast_cost_volume, o.device = "unet_pp", True, "cuda"
        return o

    ds = SyntheticDataset(split="test", image_height=384, image_width=512, num_frames=40)
    times = {}
    cases = [("flagship_b1", True, 1, "float32"), ("flagship_b16", True, 16, "float32"),
             ("simplerecon_b16", False, 16, "float32"), ("pass2_step_b16", True, 16, "float32")]
    if args.bf16:
        cases += [("flagship_b16_bf16", True, 16, "bfloat16"),
                  ("pass2_step_b16_bf16", True, 16, "bfloat16")]
    for name, hint, b, dtype in cases:
        o = options(hint, dtype)
        model = common.init_or_load_params(o, common.build_model(o))
        cur, src = batch(ds, b, "cuda")
        if name.startswith("pass2"):
            cur["K_s0_b44"] = cur["invK_s1_b44"].inverse()
            cur["K_s0_b44"][:, :2] *= 2.0
            cur["invK_s0_b44"] = cur["K_s0_b44"].inverse()
            static = prepare_static(common.make_hint_fuser(o, ds, "synth0", "cuda")[0])
            depth = offline_two_pass.HINT_MAX_DEPTH
            samples = common.resolve_raycast_samples(o, static.voxel_size, depth)
            step = offline_two_pass.make_pass2_step(model, 96, 128, samples, depth)
            call = lambda: step(static, cur, src)  # noqa: E731
        else:
            kw = {"hint": common.empty_hint(b, 384, 512, "cuda")} if hint else {}
            call = lambda: model(cur, src, **kw)  # noqa: E731
        with torch.no_grad():
            for _ in range(2):
                call()
            torch.cuda.synchronize()
            ms = []
            for _ in range(args.reps):
                a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                call()
                e.record()
                e.synchronize()
                ms.append(a.elapsed_time(e))
        times[name] = sorted(ms)[len(ms) // 2]
        del model, cur, src, call
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(json.dumps({"root": args.root, "card": smi, "forward_ms": times}))


if __name__ == "__main__":
    main()
