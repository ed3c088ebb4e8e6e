"""The reference's chains over one scan: the incremental loop and the
offline two-pass loop, worked out again from the scan's frames.

Inputs are the benchmark's frames (``benchmark.frames.Scan``): the
reference orders each tuple's source views by the DVMVS pose penalty,
normalises the images, raycasts its own volume for the hints, runs its own
model and fuses into its own volumes. It takes nothing the program made.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.frames import intrinsics_pyramid
from benchmark.reference.fusion import (
    empty_hint,
    integrate,
    render_hint,
    static_copy,
    volume_from_bounds,
)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
HINT_VOXEL = 0.04         # the offline hint volume
HINT_MAX_DEPTH = 3.0


def ordered_sources(scan, tup):
    """The tuple's source frames sorted by their DVMVS pose penalty against
    the reference frame."""
    ref, srcs = tup[0], tup[1:]
    penalties = []
    for s in srcs:
        rel = scan.cam_T_world[ref] @ scan.world_T_cam[s]
        r = np.sqrt(max(2 * (1 - min(3.0, np.trace(rel[:3, :3])) / 3), 0.0))
        penalties.append(np.sqrt(r ** 2 + np.linalg.norm(rel[:3, 3]) ** 2))
    return [srcs[i] for i in np.argsort(penalties)]


def batch_inputs(scan, tuples, device):
    """(cur, src) tensors of a batch of tuples on ``device``."""
    image_hw = scan.images.shape[1:3]
    depth_hw = scan.depths.shape[1:3]
    Ks = intrinsics_pyramid(scan.K_image, image_hw, depth_hw)
    mean = torch.tensor(IMAGENET_MEAN, device=device)
    std = torch.tensor(IMAGENET_STD, device=device)

    def images(idx):
        return (torch.as_tensor(scan.images[idx], device=device) - mean) / std

    refs = [t[0] for t in tuples]
    srcs = [ordered_sources(scan, t) for t in tuples]
    w_T_c = torch.as_tensor(scan.world_T_cam, device=device)
    c_T_w = torch.as_tensor(scan.cam_T_world, device=device)
    b, k = len(tuples), len(srcs[0])

    def K(name, shape):
        return torch.as_tensor(Ks[name], device=device).expand(*shape, 4, 4)

    cur = {"image_bhw3": images(refs), "world_T_cam_b44": w_T_c[refs],
           "cam_T_world_b44": c_T_w[refs], "K_s0_b44": K("K_s0_b44", (b,)),
           "invK_s0_b44": K("invK_s0_b44", (b,)), "invK_s1_b44": K("invK_s1_b44", (b,))}
    flat = [s for row in srcs for s in row]
    src = {"image_bkhw3": images(flat).reshape(b, k, *image_hw, 3),
           "world_T_cam_bk44": w_T_c[flat].reshape(b, k, 4, 4),
           "cam_T_world_bk44": c_T_w[flat].reshape(b, k, 4, 4),
           "K_s1_bk44": K("K_s1_b44", (b, k))}
    return cur, src


def _record(store, out, hint):
    store["depth"].append(out["depth_s0_bhw1"][..., 0])
    store["hint_depth"].append(hint["depth_hint_bhw1"][..., 0])
    store["hint_valid"].append(hint["hint_mask_bhw1"][..., 0])


def incremental(model, scan, options, device, fused_depths=None):
    """One incremental session over every tuple of ``scan``: per frame the
    hint raycast from the running volume, the forward with that hint, the
    fuse. Returns the depths (N, h, w), hint depths and validity
    (N, h/2, w/2) and the final volume's values and weights.

    ``fused_depths`` (N, h, w): the depths to fuse in place of the
    reference's own, so that the reference follows a program step by step:
    each frame's hint is then raycast from the volume of the program's
    earlier depths, and each depth is computed from that hint."""
    o = options
    lo, hi = scan.bounds
    vol = volume_from_bounds(lo, hi, o["fusion_resolution"], device)
    hint_hw = (o["image_height"] // 4, o["image_width"] // 4)
    store = {"depth": [], "hint_depth": [], "hint_valid": []}
    with torch.no_grad():
        for tup in scan.tuples:
            cur, src = batch_inputs(scan, [tup], device)
            hint = render_hint(vol, cur["world_T_cam_b44"], cur["invK_s0_b44"], *hint_hw,
                               o["fusion_max_depth"], o["raycast_samples"])
            out = model(cur, src, hint)
            depth = out["depth_s0_bhw1"][0, ..., 0]
            if fused_depths is not None:
                depth = fused_depths[len(store["depth"])].to(device)
            integrate(vol, depth, cur["cam_T_world_b44"][0], cur["K_s0_b44"][0],
                      o["fusion_max_depth"], o["extended_neg_truncation"])
            _record(store, out, hint)
    result = {k: torch.cat(v) for k, v in store.items()}
    result.update(values=vol.values, weights=vol.weights)
    return result


def offline(model, scan, options, device, batch_size):
    """One offline two-pass session: pass 1 with empty hints fused into the
    0.04 m / 3.0 m hint volume, that volume rounded once, pass 2 with its
    raycast hints, and the final fuse of the pass-2 depths frame by frame.
    Returns the pass-2 depths and hints, the hint volume and the final
    volume."""
    o = options
    lo, hi = scan.bounds
    ext = o["extended_neg_truncation"]
    h, w = o["image_height"], o["image_width"]
    batches = [scan.tuples[i:i + batch_size] for i in range(0, len(scan.tuples), batch_size)]
    hint_vol = volume_from_bounds(lo, hi, HINT_VOXEL, device)
    final = volume_from_bounds(lo, hi, o["fusion_resolution"], device)
    store = {"depth": [], "hint_depth": [], "hint_valid": []}
    with torch.no_grad():
        for tuples in batches:
            cur, src = batch_inputs(scan, tuples, device)
            out = model(cur, src, empty_hint(len(tuples), h, w, device))
            for i in range(len(tuples)):
                integrate(hint_vol, out["depth_s0_bhw1"][i, ..., 0], cur["cam_T_world_b44"][i],
                          cur["K_s0_b44"][i], HINT_MAX_DEPTH, ext)
        static = static_copy(hint_vol)
        for tuples in batches:
            cur, src = batch_inputs(scan, tuples, device)
            hint = render_hint(static, cur["world_T_cam_b44"], cur["invK_s0_b44"], h // 4, w // 4,
                               HINT_MAX_DEPTH, o["raycast_samples"])
            out = model(cur, src, hint)
            for i in range(len(tuples)):
                integrate(final, out["depth_s0_bhw1"][i, ..., 0], cur["cam_T_world_b44"][i],
                          cur["K_s0_b44"][i], o["fusion_max_depth"], ext)
            _record(store, out, hint)
    result = {k: torch.cat(v) for k, v in store.items()}
    result.update(values=final.values, weights=final.weights, hint_values=hint_vol.values,
                  hint_weights=hint_vol.weights)
    return result
