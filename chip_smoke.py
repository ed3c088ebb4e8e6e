"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels to their
plain versions.

    python3 chip_smoke.py               # every phase; exit 0 only if all pass
    python3 chip_smoke.py --kernels-only  # build + kernel checks, then stop
    python3 chip_smoke.py --profile     # also trace warm steps (profile_*.txt)

Phases (each one fails the run on error):
  1. the card's name and power limit, torch / CUDA versions, and the build
     of every kernel from ``doubletake_tpu_torch/csrc`` (one nvcc each, in
     parallel) into ``build/torch_kernels``;
  2. K1, the fused feature volume, against its plain version at the flagship
     shapes (b=1, 7 source views, 96x128x16 features, 64 planes) with a
     partly valid hint and without the hint MLP (the matching MLP's own
     scores), at 61 planes (not a multiple of the planes a warp walks), at
     k=8 with a hint and k=1 without, at a small odd shape (partial pixel
     groups, b=2), at the offline pass-2 shape (b=16 with a hint), and again
     after a weight is changed in place: max |score difference| <= 1e-3
     (the kernel takes each product as three bf16 products of hi/lo parts,
     in another order than the float32 plain path); and K1's bf16 mode
     (bf16 features and weights, one bf16 product) against its plain
     version at bf16 (the XLA bf16 path) at the flagship shape with and
     without the hint MLP and at the pass-2 shape: mean |difference| < 5e-3,
     p99 < 5e-2 (tests/test_fused_volume.py:87-89), the max recorded;
  3. K2, the TSDF integrate, against its plain version on the synthetic
     room's 304x200x152 score volume (0.02 m / 3.5 m) and on its 152x104x80
     hint volume (0.04 m / 3.0 m, extended truncation: offline pass 1 and
     revisit's first visit) for three chained frames of rendered depth
     and one with NaN pixels, on a small odd volume, with the camera inside
     the room and with nothing in view (no element may change): values and
     weights bit-equal;
  4. the main path: ``runners.incremental.run`` on a synthetic scan at
     512x384 with the flagship model configuration (EfficientNetV2-S,
     ResNet matching encoder, hint feature volume, U-Net++, 64 planes, 8
     views, fast cost volume), fusion at 0.02 m to 3.5 m with extended
     truncation, random weights from a seeded generator, over the scan's 33
     frames; both kernels must launch once per frame; maps/s is the frames
     over the scan loop's wall time (loader waits included), beside the
     inverse of the mean per-frame step time; the run's mesh (``synth0.ply``,
     exported after the timed loop) must load, have faces and lie inside the
     volume, and its export ms and vertex / face counts are recorded (so in
     phases 7-9 too);
  5. whole-step parity on the card: the first frames through the kernel path
     and through the plain path (plain volume, plain integrate) with the
     same weights: s0 depth p99 <= 1e-2 m and Abs-Diff delta <= 5e-4 m;
  6. kernel timings (CUDA events, warm, median) beside each kernel's bound,
     K1 also at the pass-2 shape (b=16) and in its bf16 mode at b=1 and
     b=16; K1's bound counts its tensor-core products at the bf16 rate
     (three per multiply-add in the float32 mode, one in the bf16 mode), and
     ``bound_fp32_simt_ms`` keeps the reference's MACs at the fp32 rate;
  7. the no-hint path: ``runners.no_hint.run`` with the SimpleRecon model
     (``configs/models/simplerecon_model.yaml`` set in code: metadata
     feature volume, EfficientNetV2-S, ResNet matching, U-Net++) in batches
     of 16, fusion at 0.02 m to 3.5 m;
  8. the offline two-pass path: ``runners.offline_two_pass.run`` with the
     flagship configuration in batches of 16 (pass 1 into the 0.04 m /
     3.0 m hint volume, pass 2 raycasting it in one march per batch), final
     fusion at 0.02 m to 3.5 m with extended truncation; and the batched
     raycast alone at b=16 (time, peak memory), of the saved hint volume
     and of its ``prepare_static`` copy, interleaved and bit-equal;
  9. the revisit path: ``runners.revisit.run`` with the flagship
     configuration on the rescan ``synth0@1``, its hint volume from the
     first visit ``synth0`` (pass 1 in batches of 16), the rescan frame by
     frame, fused; its parity check raycasts the hint volume the run saved.
  10. bf16 serving: ``runners.offline_two_pass.run`` as in phase 8 with
     compute_dtype "bfloat16" (weights and batch-norm statistics cast to
     bf16, K1 in its bf16 mode); its first batch's parity is gated as
     ``bf16_parity`` says (phase 5's 1e-2 m cannot hold for bf16 decoders
     on random weights), and the bf16-vs-float32 difference of its s0 depth
     is reported, not gated;
  11. training: ``training.train_loop.train`` with the flagship
     configuration at precision 16, batch 16, on ``synthetic`` with
     fill_depth_hints, for 4 steps with validation at step 4 (one batch of 4
     per validation set): finite losses, step 4 reached, checkpoints,
     ``best`` and the final ``.ckpt`` written, the ``.ckpt`` loaded by
     ``runners.common.init_or_load_params``; K1 must launch 0 times inside
     the train steps (autograd takes the plain path) and once per
     validation batch; then, on one fixed batch, the median warm train-step
     time, samples/s, peak device memory, and the loss over 6 steps at lr
     1e-5 falling below its first value (``FIXED_BATCH_LR``);
  12. colour fusion: ``runners.no_hint.run`` as in phase 7 with
     ``fuse_color``: K1 once per batch, K2 never (a coloured volume takes the
     dense plain-torch pass); the volume's colours finite and in [0, 1], the
     PLY with vertex colours. Then the scan's GT depths with their RGB fused
     into a coloured volume, and the same depths without colour through K2:
     values and weights bit-equal; ms per frame of both;
  13. the mesh against the truth: the scan's GT depths fused through K2 at
     0.02 m / 3.5 m and meshed; the visibility volume (0.04 m) built on the
     card by ``scripts.create_visibility_volume`` from the GT depths, and one
     frame's ``integrate_visibility`` on the card against the CPU (at most
     1e-4 of the voxels differ); ``scripts.mesh_eval`` of that mesh against
     the scene's analytic mesh (``SyntheticScene.gt_mesh``): accuracy < 2 cm
     and precision > 0.95 (completion and recall reported: the orbit does
     not see every face); the GT mesh against its own samples gives Chamfer
     0 and F-score 1; phase 4's mesh (random weights) against the GT,
     finite, reported.
  14. the small config (``configs/models/doubletake_small_model.yaml`` set in
     code: ResNet18D, the skip decoder, the ResNet matching encoder, the hint
     volume): the incremental path as in phase 4 (33 / 33 launches, the PLY)
     with phase 5's whole-step parity and a torch.profiler trace of warm
     frames (device ms a frame, against phase 15's flagship trace); the
     offline two-pass path as in phase 8 (6 / 66, pass-1 and pass-2 parity);
     training as in phase 11 (precision 16, b=16, K1 only in validation,
     then timed steps on one batch).
  15. ``raycast_mip``: first a trace of warm flagship frames (the dense
     step); then the flagship's incremental path with the candidate-block
     mip march for every hint (33 / 33, the PLY), whole-step parity with the
     plain path on the same march, and its hint ms against phase 4's; then
     the mip and the dense march on the same volume at the first batch's 16
     poses: the run's volume (reported) and the scan's GT depths fused
     through K2, where validity may differ on < 5% of the pixels (the JAX
     contract, tests/test_tsdf.py:148-176); and one pose's march alone, dense
     and mip in turns.
  16. ``split_timing``: the flagship incremental path over the 12-frame
     synthetic scan with and without it: each frame's depth metrics and the
     saved volume equal, the split run's host-clock hint / model / fuse times
     finite; both runs' launches counted.
  17. data-parallel training (``training/distributed.py``): (a) the
     flagship at precision 16, global b=16, 2 steps on one fixed batch
     (``train_loop.fixed_batch_steps``) in a one-process NCCL group,
     against the one-device step, and the one-device step against itself
     (the card's own run-to-run spread); (b) two spawned gloo ranks on the
     card (NCCL refuses two ranks on one GPU), global b=4, against the plain
     collective (``make_sharded_train_step``) in this process, run twice:
     each rank's first-step vector after the collective (gradients, running
     statistics, losses) within 8x the plain collective's rerun distance,
     a gate shown to reject a rank that skips the reduction or sums in
     place of averaging (``check_reduced``); then the first step's losses
     bit-equal and the rest as ``compare_states`` says (cuDNN's and the
     samplers' backward is not bit-reproducible), bit-equality reported;
     step ms (against phase 11's), the flat vector's bytes, the all-reduce
     ms, peak GiB per rank; no kernel launches inside the steps.
  18. hint renders: phase 7's no-hint path again, untimed, with
     ``cache_depths``; ``scripts.render_hints`` on the card over those
     depths with --depth_noise 0.05: K2 once a
     frame and variant (66 for synth0), 2 PNGs a frame in each variant, the
     depth PNGs read back as the hint loader reads them within 1/2048 m of
     a raycast of the same complete volume where valid; fuse and render ms
     a frame.
  19. the extras: ``integrate_batch`` of the GT frames through K2 bit-equal
     to a loop of ``integrate_depth``, ``cull=True`` bit-equal to
     ``cull=False``, ``sample_tsdf`` on the card against the CPU within
     SAMPLE_TOL; ``scripts.render_trajectory`` on phase 4's volume over
     TRAJECTORY_FRAMES frames (ms a frame, mp4 or PNG sequence); a 12-frame
     incremental run with ``dump_depth_visualization``: one panel a frame.
  20. the evaluation chain through files: (a) a ScanNet-layout scan under
     ``build/scannet_synth`` (``write_scannet_scan``: 96 frames of the
     synthetic room at 640x480, JPEG colour, uint16 mm depth PNGs, pose
     files, frames 40-71 with ``-inf`` poses, so the online keyframe buffer
     resets); (b) ``scripts.precompute_valid_frames`` (64 lines),
     ``scripts.generate_test_tuples`` for the four types and
     ``scripts.generate_train_tuples`` at 8 and 2 frames, each file equal to
     ``tools.tuple_generation`` on the poses written, every id a valid
     frame; line counts and short (< 8 frames) lines per type; (c)
     ``scripts.strip_checkpoint`` on phase 11's last training state, the
     ``.ckpt`` loaded by ``init_or_load_params`` bit-equal to phase 11's
     model; (d) ``scripts.evaluation`` on the card (the flagship at 512x384,
     fast cost volume, the stripped weights) through the ScanNet reader over
     the default tuples of 8 frames (the short ones dropped into a second
     file): K1 and K2 once a kept line, finite metrics against the PNG
     depths, the PLY, loop and step maps/s beside phase 4's; a short line
     refused by the K1 wrapper (``ValueError``); and the first frames'
     whole-step parity (phase 5's budgets) over the room's bounds;
     (e) the reader's first CUBE_FRAMES GT depths fused through K2 into
     its own +-10 m cube (the volume of (d)) bit-equal to the plain version
     run slab by slab (``cube_parity``); all its GT depths and poses fused
     through K2 at 0.02 m / 3.5 m over the room, meshed, the visibility
     CLI over the scan's
     dense_offline tuples and ``scripts.mesh_eval`` against the analytic
     room: accuracy < 2 cm, precision > 0.95.
  Phases 15, 16 and 19 run right after phase 10, on its model; 17 after 11,
  18 after 17; phase 14, then phase 20, last.
  In phases 7-10 and 12 both kernels must launch as often as the path's batches and
  fused frames imply (counted from the dataset's length and the batch
  size), the metrics must be finite, hint coverage (pass 2, rescan) > 0,
  and the first batch of each model run of the path must agree between the
  kernel path and the plain path within phase 5's budgets (pass 2 and the
  rescan on the same hint volume; phase 10 as above); maps/s per pass, step maps/s and the
  path's peak device memory are recorded.

The last lines are the nvidia-smi line, one JSON line ``{"kernels": [...]}``
(each row with ``launches`` of the main path and ``launches_by_path``) and
``{"ok": true, "device": {...}}``. Everything measured also goes to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

FP32_PEAK = 67e12     # H100 SXM float32 outside the tensor cores, FLOP/s
BF16_TC_PEAK = 989e12  # H100 SXM bf16 tensor cores, dense, FLOP/s
HBM_RATE = 3.35e12    # H100 SXM HBM3, bytes/s
K1_TOL = 1e-3
# K1's bf16 mode against the XLA bf16 path (tests/test_fused_volume.py:87-89)
K1_BF16_MEAN, K1_BF16_P99 = 5e-3, 5e-2
PARITY_P99_LIMIT = 1e-2
ABS_DIFF_DELTA_LIMIT = 5e-4
PARITY_FRAMES = 4
BATCH = 16            # the throughput modes' batch size (Options' default)
PASS2_CASE = f"pass-2 b={BATCH} k=7 D=64 hint"
TRAIN_STEPS, TRAIN_VAL_BATCH = 4, 4
# the fixed-batch curve's learning rate: on random weights the flagship
# diverges at 1e-3 (NaN by step 4 on the card) and does not fall within 6
# steps at the config's 1e-4; AdamW's first steps move every weight by ~lr
FIXED_BATCH_LR = 1e-5
# phase 17 (``check_reduced``): the first step's flat vector after the
# collective, part by part (gradients, running statistics, losses), as a
# relative L2 distance from the plain collective's; the limit is DP_SPREAD_FACTOR
# x the plain collective's distance from its own rerun (the backward adds with
# atomics, so a rerun of the same step need not be bit-equal) plus a margin of
# a few float32 roundings where the rerun is bit-equal. After 2 steps (``compare_states``): the second step's losses and
# the running statistics' median, relative; parameters' median difference
DP_SPREAD_FACTOR, DP_SPREAD_FLOOR = 8.0, 1e-6
DP_LOSS_REL, DP_STATS_REL = 2e-2, 1e-2
DP_TIMEOUT_S, DP_JOIN_TIMEOUT_S = 300.0, 420.0
# phase 19: trilinear samples, card against the CPU: the two devices may round
# a sample's float32 voxel coordinate (< 512) one ulp (2^-15) apart each way,
# and neighbouring TSDF values differ by up to 2
SAMPLE_TOL = 2 * 2 * 2.0 ** -15
TRAJECTORY_FRAMES = 8
# phase 20: the ScanNet-layout scan (frames SCANNET_LOST have -inf poses: a
# gap of 32 > 30 frames resets the online keyframe buffer), the tuple types,
# and the suffix of the default tuples kept for the 8-view model
SCANNET_SCAN, SCANNET_FRAMES, SCANNET_LOST = "scene_synth0", 96, range(40, 72)
TUPLE_TYPES = ("default", "offline", "dense", "dense_offline")
SCANNET_KEPT_SUFFIX = "_eight_view_deepvmvs_8frames.txt"
SCANNET_SHORT_SUFFIX = "_eight_view_deepvmvs_short.txt"
# the reader's +-10 m cube held to the plain version over its first frames,
# in x-slabs of CUBE_SLAB voxels (the plain version's temporaries over the
# whole cube would take tens of GiB)
CUBE_FRAMES, CUBE_SLAB = 8, 100
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")


def log(msg):
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def median_ms(fn, reps=10, warmup=2, inner=1):
    """Median over ``reps`` CUDA-event timings of ``inner`` back-to-back
    calls of fn(), per call (each timing synchronised). With inner > 1 the
    host queues the next launch while the card runs the last, so a kernel
    is timed without the host's time between launches."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    times.sort()
    return times[len(times) // 2]


def kernel_launches(since=None):
    """K1's and K2's launches so far (the port's ``tracing`` counters), or
    since ``since``, an earlier reading."""
    from doubletake_tpu_torch.utils import tracing

    c = tracing.counters()
    now = {"fused_volume": c.get("ops.fused_volume.launches", 0),
           "integrate": c.get("ops.integrate.launches", 0)}
    return now if since is None else {k: now[k] - since[k] for k in now}


def sync():
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


# ------------------------------------------------------------------- inputs


def flagship_volume_inputs(device):
    """K1 inputs at the flagship shapes: geometry from the synthetic scan's
    first 8-view tuple, random features and MLP weights from seeds, and a
    hint valid on ~60% of the pixels (NaN depth elsewhere)."""
    import numpy as np
    import torch

    from doubletake_tpu_torch.datasets.synthetic import SyntheticDataset
    from doubletake_tpu_torch.models.cost_volume import FeatureMeshHintVolume, generate_depth_planes
    from doubletake_tpu_torch.models.layers import init_parameters
    from doubletake_tpu_torch.ops.fused_volume import volume_geometry

    ds = SyntheticDataset(split="test", image_height=384, image_width=512, num_frames=12)
    scan, *frame_ids = ds.frame_tuples[0].split(" ")
    poses = [ds.load_pose(scan, f) for f in frame_ids]            # (world_T_cam, cam_T_world)
    K1 = ds.load_intrinsics(scan)["K_s1_b44"]
    cur_cTw, src = poses[0][1], poses[1:]
    src_T_cur = np.stack([s[1] @ poses[0][0] for s in src])[None].astype(np.float32)
    cur_T_src = np.stack([cur_cTw @ s[0] for s in src])[None].astype(np.float32)
    src_K = np.broadcast_to(K1, (1, 7, 4, 4)).astype(np.float32)
    invK = np.linalg.inv(K1)[None].astype(np.float32)

    g = torch.Generator().manual_seed(1)
    h, w, c, k = 96, 128, 16, 7
    cur = torch.randn((1, h, w, c), generator=g)
    srcf = torch.randn((1, k, h, w, c), generator=g)
    depth = torch.rand((1, h, w), generator=g) * 3.5 + 0.5
    valid = torch.rand((1, h, w), generator=g) < 0.6
    weight = torch.rand((1, h, w), generator=g)
    hint = torch.stack([torch.where(valid, depth, torch.full_like(depth, float("nan"))),
                        valid.float(), torch.where(valid, weight, torch.zeros_like(weight))], -1)

    module = FeatureMeshHintVolume(num_depth_bins=64, num_views=k)
    init_parameters(module, torch.Generator().manual_seed(2))
    module = module.to(device).eval()
    geo = volume_geometry(*(torch.from_numpy(x).to(device)
                            for x in (src_K, src_T_cur, cur_T_src, invK)), h, w)
    planes = generate_depth_planes(0.25, 5.0, 64, device)
    to = lambda x: x.to(device).contiguous()   # noqa: E731
    args = (to(cur), to(srcf), *geo, planes, module._layers(module.mlp),
            module._layers(module.hint_mlp), to(hint))
    return args


def random_volume_case(device, b, k, h, w, d, hint, seed):
    """K1 arguments at any shape: random features, poses within ~0.2 m of
    the current view, a module with weights from ``seed`` (hint valid on
    ~60% of the pixels, NaN depth elsewhere), and the module."""
    import torch

    from doubletake_tpu_torch.models.cost_volume import (
        FeatureMeshHintVolume,
        FeatureVolume,
        generate_depth_planes,
    )
    from doubletake_tpu_torch.models.layers import init_parameters
    from doubletake_tpu_torch.ops.fused_volume import volume_geometry

    g = torch.Generator().manual_seed(seed)
    module = (FeatureMeshHintVolume if hint else FeatureVolume)(num_depth_bins=d, num_views=k)
    init_parameters(module, g)
    module = module.to(device).eval()
    pose = torch.eye(4).repeat(b, k, 1, 1)
    pose[:, :, :3, 3] = torch.randn((b, k, 3), generator=g) * 0.2
    f = 0.8 * w
    K = torch.tensor([[f, 0, w / 2, 0], [0, f, h / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    geo = volume_geometry(K.repeat(b, k, 1, 1).to(device), pose.to(device),
                          torch.linalg.inv(pose).to(device),
                          torch.linalg.inv(K)[None].repeat(b, 1, 1).to(device), h, w)
    args = [torch.randn((b, h, w, 16), generator=g).to(device),
            torch.randn((b, k, h, w, 16), generator=g).to(device), *geo,
            generate_depth_planes(0.25, 5.0, d, device), module._layers(module.mlp)]
    if hint:
        depth = torch.rand((b, h, w), generator=g) * 3.5 + 0.5
        valid = torch.rand((b, h, w), generator=g) < 0.6
        weight = torch.rand((b, h, w), generator=g)
        hint_t = torch.stack([torch.where(valid, depth, torch.full_like(depth, float("nan"))),
                              valid.float(), torch.where(valid, weight, torch.zeros_like(weight))],
                             -1)
        args += [module._layers(module.hint_mlp), hint_t.to(device)]
    return tuple(args), module


def k1_error(args):
    """max |kernel - plain| of one K1 call (the plain path reads the hint
    with NaN depths zeroed, as the kernel's wrapper does)."""
    import torch

    from doubletake_tpu_torch.ops import fused_volume as fv

    plain_args = args if len(args) < 10 else (*args[:-1], torch.nan_to_num(args[-1], nan=0.0))
    with torch.no_grad():
        kern = fv.fused_feature_volume(*args)
        plain = fv.feature_volume_plain(*plain_args)
    sync()
    if not torch.isfinite(kern).all():
        raise RuntimeError("K1: non-finite scores from the kernel")
    return float((kern - plain).abs().max()), plain, kern


def check_fused_volume(device):
    import torch

    from doubletake_tpu_torch.models.cost_volume import generate_depth_planes
    from doubletake_tpu_torch.ops import fused_volume as fv

    args = flagship_volume_inputs(device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    planes61 = generate_depth_planes(0.25, 5.0, 61, device)
    run61, _ = fv.plane_schedule(1, 96 * 128, 61, sms)
    if 61 % run61 == 0:
        raise RuntimeError(f"K1 check: 61 planes are a multiple of the run ({run61})")
    cases = [
        # the flagship shape, with the hint MLP and a partly valid hint
        ("flagship k=7 D=64 hint", args),
        # the matching MLP's own scores at the flagship shape
        ("flagship k=7 D=64 no hint", args[:8]),
        # a plane count the warps' runs of planes do not divide
        (f"flagship k=7 D=61 (run {run61}) hint", (*args[:6], planes61, *args[7:])),
        ("k=8 96x128 D=64 hint", random_volume_case(device, 1, 8, 96, 128, 64, True, 4)[0]),
        ("k=1 96x128 D=64 no hint", random_volume_case(device, 1, 1, 96, 128, 64, False, 5)[0]),
    ]
    # partial 64-pixel groups (925 pixels), two batch elements, two views
    small, module = random_volume_case(device, 2, 2, 25, 37, 8, False, 3)
    cases.append(("b=2 k=2 25x37 D=8 no hint", small))
    # the offline pass-2 batch: 16 elements at the flagship shape, with a hint
    pass2, _ = random_volume_case(device, BATCH, 7, 96, 128, 64, True, 6)
    cases.append((PASS2_CASE, pass2))
    errs = {}
    for name, case in cases:
        err, plain, _ = k1_error(case)
        errs[name] = err
        log(f"K1 {name}: max |kernel - plain| = {err:.3e} (limit {K1_TOL}), "
            f"score range [{float(plain.min()):.3f}, {float(plain.max()):.3f}]")
        if not err <= K1_TOL:
            raise RuntimeError(f"K1 disagrees with its plain version at {name}: {err}")

    # the packed weights follow an in-place change of a weight
    _, _, before = k1_error(small)
    with torch.no_grad():
        module.mlp.linears()[1].weight.mul_(-1.0)
    err, _, after = k1_error(small)
    moved = float((after - before).abs().max())
    log(f"K1 after an in-place weight change: max |kernel - plain| = {err:.3e}, "
        f"scores moved by up to {moved:.3f}")
    if not (err <= K1_TOL and moved > 1e-3):
        raise RuntimeError(f"K1 did not pick up a changed weight: err {err}, moved {moved}")
    errs["after weight change"] = err
    return {"max_abs_err": max(errs.values()), "errors": errs, "args": args,
            "pass2_args": pass2}


def bf16_case(args):
    """K1 arguments in the bf16 mode: features and MLP weights in bf16, the
    hint's weight channel rounded to bf16 (as the module hands it over)."""
    import torch

    def cast(mlp):
        return None if mlp is None else [(w.bfloat16(), b.bfloat16()) for w, b in mlp]

    out = [args[0].bfloat16(), args[1].bfloat16(), *args[2:7], cast(args[7])]
    if len(args) > 8:
        hint = args[9].clone()
        hint[..., 2] = hint[..., 2].bfloat16().float()
        out += [cast(args[8]), hint]
    return tuple(out)


def check_fused_volume_bf16(device, k1):
    """K1's bf16 mode against its plain version at bf16 (mean and p99 of
    |difference| within the reduced-precision budgets)."""
    import torch

    from doubletake_tpu_torch.ops import fused_volume as fv

    cases = [("flagship k=7 D=64 hint", bf16_case(k1["args"])),
             ("flagship k=7 D=64 no hint", bf16_case(k1["args"][:8])),
             (PASS2_CASE, bf16_case(k1["pass2_args"]))]
    errs = {}
    for name, case in cases:
        plain_args = case if len(case) < 10 else (*case[:-1], torch.nan_to_num(case[-1], nan=0.0))
        with torch.no_grad():
            kern = fv.fused_feature_volume(*case)
            plain = fv.feature_volume_plain(*plain_args)
        sync()
        if kern.dtype != torch.float32 or not torch.isfinite(kern).all():
            raise RuntimeError(f"K1 bf16 {name}: scores {kern.dtype}, finite "
                               f"{bool(torch.isfinite(kern).all())}")
        diff = (kern - plain).abs().flatten()
        row = {"mean": float(diff.mean()), "p99": float(torch.quantile(diff[::3], 0.99)),
               "max": float(diff.max())}
        errs[name] = row
        log(f"K1 bf16 {name}: |kernel - plain| mean {row['mean']:.3e}, p99 {row['p99']:.3e}, "
            f"max {row['max']:.3e} (limits {K1_BF16_MEAN} / {K1_BF16_P99})")
        if not (row["mean"] < K1_BF16_MEAN and row["p99"] < K1_BF16_P99):
            raise RuntimeError(f"K1's bf16 mode disagrees with its plain version at {name}: {row}")
    return {"max_abs_err": max(r["max"] for r in errs.values()), "errors": errs,
            "args": cases[0][1], "pass2_args": cases[2][1]}


def look_at(pos, fwd):
    """cam_T_world (float32 numpy) of a camera at ``pos`` looking along ``fwd``."""
    import numpy as np

    fwd = np.asarray(fwd, float) / np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    T = np.eye(4)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = right, np.cross(fwd, right), fwd, pos
    return np.linalg.inv(T).astype(np.float32)


def synthetic_depth_frames(n, device):
    """(depth (H, W), P (3, 4)) of n consecutive synthetic frames at depth
    resolution (192x256), the dataset and the intrinsics K_s0."""
    import numpy as np
    import torch

    from doubletake_tpu_torch.datasets.synthetic import SyntheticDataset

    ds = SyntheticDataset(split="test", image_height=384, image_width=512, num_frames=40)
    K0 = ds.load_intrinsics("synth0")["K_s0_b44"]
    frames = []
    for i in range(n):
        depth, _, _ = ds.load_target_size_depth_and_mask("synth0", 2 * i)
        _, cTw = ds.load_pose("synth0", 2 * i)
        P = torch.from_numpy((K0 @ cTw)[:3].astype(np.float32))
        frames.append((torch.from_numpy(depth[..., 0]).to(device), P.to(device)))
    return frames, ds, K0


def integrate_kwargs(voxel=0.02):
    trunc = 3.0 * voxel
    return dict(voxel_size=voxel, min_depth=0.5, max_depth=3.5, truncation=trunc,
                trunc_check=-trunc * 1.5, update_rate=2.5, max_weight=100.0)


def fuser_kwargs(vol, cfg):
    """K2's keywords for a fuser's volume and config, as
    ``tools.tsdf.integrate_depth`` passes them."""
    trunc = cfg.truncation_voxels * vol.voxel_size
    return dict(voxel_size=vol.voxel_size, min_depth=cfg.min_depth, max_depth=cfg.max_depth,
                truncation=trunc,
                trunc_check=-trunc * (1.5 if cfg.extended_neg_truncation else 1.0),
                update_rate=cfg.update_rate, max_weight=cfg.max_weight)


def chained_integrate(name, vol, frames, kw):
    """K2 and its plain version over ``frames`` chained on copies of
    ``vol``: values and weights must stay bit-equal after every frame.
    Returns the kernel's (values, weights) and the plain path's."""
    from doubletake_tpu_torch.ops import integrate as ig

    kv, kw_ = vol.values.clone(), vol.weights.clone()
    pv, pw = vol.values.clone(), vol.weights.clone()
    worst = 0
    for depth, P in frames:
        ig.fused_integrate(kv, kw_, depth, P, vol.origin, **kw)
        pv, pw = ig.integrate_plain(pv, pw, depth, P, vol.origin, **kw)
        sync()
        worst = max(worst, int((kv != pv).sum()) + int((kw_ != pw).sum()))
    observed = int((kw_ > 0).sum())
    log(f"K2 integrate, {name}, on {tuple(vol.dims)} over {len(frames)} frames (last with "
        f"NaNs): {worst} differing elements, {observed} observed voxels")
    if worst != 0:
        raise RuntimeError(f"K2 differs from its plain version on {worst} elements ({name})")
    if observed == 0:
        raise RuntimeError(f"K2 fused nothing ({name})")
    return (kv, kw_), (pv, pw)


def check_integrate(device):
    import torch

    from doubletake_tpu_torch.ops import integrate as ig
    from doubletake_tpu_torch.options import Options
    from doubletake_tpu_torch.runners import common
    from doubletake_tpu_torch.tools.tsdf import TSDF

    frames, ds, K0 = synthetic_depth_frames(3, device)
    bounds = common.scene_bounds_for_fusion(ds, "synth0")
    nan_depth = frames[-1][0].clone()
    nan_depth[40:80, 60:120] = float("nan")
    nan_depth[::7, ::5] = float("nan")
    frames.append((nan_depth, frames[-1][1]))
    vol = TSDF.from_bounds(bounds, 0.02, device=device)
    kw = integrate_kwargs()
    (kv, kw_), (pv, pw) = chained_integrate("score volume 0.02 m / 3.5 m", vol, frames, kw)
    err = float(max((kv - pv).abs().max(), (kw_ - pw).abs().max()))

    # the hint volume of offline pass 1 and of revisit's first visit:
    # 0.04 m / 3.0 m with extended truncation (common.make_hint_fuser)
    hint_opts = Options()
    hint_opts.extended_neg_truncation = True
    hvol, hcfg = common.make_hint_fuser(hint_opts, ds, "synth0", device)
    chained_integrate("hint volume 0.04 m / 3.0 m", hvol, frames, fuser_kwargs(hvol, hcfg))

    # a volume at the room's centre whose voxel count (odd dims, which
    # from_bounds never makes) leaves a partial block of threads
    dims, voxel = (43, 38, 35), 0.05
    centre = torch.tensor([(bounds[f"{a}min"] + bounds[f"{a}max"]) / 2 for a in "xyz"])
    origin = (centre - torch.tensor(dims) * voxel / 2).float().to(device)
    ov = -torch.ones(dims, device=device)
    ow = torch.zeros(dims, device=device)
    depth, P = frames[0]
    pv, pw = ig.integrate_plain(ov, ow, depth, P, origin, **integrate_kwargs(voxel))
    ig.fused_integrate(ov, ow, depth, P, origin, **integrate_kwargs(voxel))
    sync()
    bad = int((ov != pv).sum()) + int((ow != pw).sum())
    observed = int((ow > 0).sum())
    log(f"K2 integrate on {dims}: {bad} differing elements, {observed} observed voxels")
    if bad != 0 or observed == 0:
        raise RuntimeError(f"K2 on the odd volume: {bad} differing elements, "
                           f"{observed} observed voxels")

    # two more poses on the room's volume as the chained frames left it: the
    # camera at the room's centre, and one outside looking away (nothing in
    # view: no voxel may change, not even by a write of its own value)
    centre = [(bounds[f"{a}min"] + bounds[f"{a}max"]) / 2 for a in "xyz"]
    poses = {"inside": look_at(centre, (1.0, 0.3, -0.2)),
             "away": look_at((bounds["xmax"] + 1.0, centre[1], centre[2]), (1.0, 0.0, 0.0))}
    depth = frames[0][0]
    for name, cTw in poses.items():
        P = torch.from_numpy((K0 @ cTw)[:3].astype("float32")).to(device)
        ov, ow = kv.clone(), kw_.clone()
        pv, pw = ig.integrate_plain(ov, ow, depth, P, vol.origin, **kw)
        ig.fused_integrate(ov, ow, depth, P, vol.origin, **kw)
        sync()
        bad = int((ov != pv).sum()) + int((ow != pw).sum())
        updated = int((pw != kw_).sum())
        changed = int((ov != kv).sum()) + int((ow != kw_).sum())
        log(f"K2 integrate, camera {name}: {bad} differing elements, {updated} voxels "
            f"updated, {changed} elements changed")
        if bad != 0:
            raise RuntimeError(f"K2 differs from its plain version, camera {name}: {bad}")
        if name == "inside" and updated == 0:
            raise RuntimeError("K2 with the camera inside the room updated nothing")
        if name == "away" and (updated != 0 or changed != 0):
            raise RuntimeError(f"K2 with nothing in view changed {changed} elements")
    return {"max_abs_err": err, "frames": frames, "bounds": bounds, "dims": tuple(vol.dims)}


# ---------------------------------------------------------------- main path


def flagship_options(out_dir):
    from doubletake_tpu_torch.options import Options

    o = Options()
    # configs/models/doubletake_model.yaml, set in code (no yaml needed)
    o.name = "chip_smoke"
    o.model_type = "cv_hint_depth_model"
    o.feature_volume_type = "mlp_mesh_hint_feature_volume"
    o.image_encoder_name = "efficientnet"
    o.matching_encoder_type = "resnet"
    o.depth_decoder_name = "unet_pp"
    o.cv_encoder_type = "multi_scale_encoder"
    o.loss_type = "log_l1"
    o.fill_depth_hints = True
    # the README's incremental command
    o.device = "cuda"
    o.dataset = "synthetic"
    o.image_width, o.image_height = 512, 384
    o.batch_size = 1
    o.num_workers = 4
    o.fast_cost_volume = True
    o.run_fusion = True
    o.fusion_resolution = 0.02
    o.fusion_max_depth = 3.5
    o.extended_neg_truncation = True
    o.depth_fuser = "ours"
    o.output_base_path = out_dir
    o.random_seed = 0
    return o


def run_main_path(opts, path="main path", model=None):
    """``runners.incremental.run`` over the scan with both kernels' launches
    counted over it; each kernel must launch once a frame. The
    model is built from ``opts`` with random weights unless given."""
    import torch

    from doubletake_tpu_torch.datasets.registry import dataset_from_opts
    from doubletake_tpu_torch.runners import common, incremental

    if model is None:
        model = common.init_or_load_params(opts, common.build_model(opts))
    torch.cuda.reset_peak_memory_stats()   # the main path's peak, not the kernel checks'
    launches0 = kernel_launches()
    t0 = time.perf_counter()
    res = incremental.run(opts, model=model)
    sync()
    wall = time.perf_counter() - t0
    launches = kernel_launches(launches0)

    base = os.path.join(opts.output_base_path, opts.name, "incremental_default")
    with open(os.path.join(base, "scores", "synth0_metrics.json")) as f:
        json.load(f)
    mesh = check_mesh(path, os.path.join(base, "meshes"), "synth0", res["meshes"]["synth0"])
    frames = len(dataset_from_opts(opts, split=opts.split))
    fa = res["frame_avg"]
    require_finite(path, fa, ("abs_diff", "abs_rel", "a5", "frame_time", "hint_time",
                              "model_time", "fuse_time", "hint_coverage"))
    if res["frames"] != frames:
        raise RuntimeError(f"{path}: {res['frames']} of {frames} frames ran")
    for name, n in launches.items():
        if n != frames:
            raise RuntimeError(f"{path}: {name} launched {n} times over {frames} frames")
    summary = {
        "frames": frames, "wall_s": wall, "launches": launches,
        # frames over the scan loop's wall time, loop start to last sync:
        # loader waits included, what a user's scan costs
        "maps_per_s": frames / res["scan_time"],
        # 1 / mean per-frame step time (device batch to the frame's sync):
        # excludes the waits on the loader between frames
        "step_maps_per_s": 1.0 / fa["frame_time"],
        "frame_ms": fa["frame_time"] * 1e3, "hint_ms": fa["hint_time"] * 1e3,
        "model_ms": fa["model_time"] * 1e3, "fuse_ms": fa["fuse_time"] * 1e3,
        "hint_coverage": fa["hint_coverage"], "abs_diff": fa["abs_diff"],
        "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2**30
                         if torch.cuda.is_available() else None),
        "mesh": mesh,
    }
    log(f"{path}: {frames} frames, {summary['maps_per_s']:.2f} maps/s over the scan loop, "
        f"{summary['step_maps_per_s']:.2f} maps/s by mean step "
        f"(frame {summary['frame_ms']:.1f} ms; device hint {summary['hint_ms']:.2f} / "
        f"model {summary['model_ms']:.2f} / fuse {summary['fuse_ms']:.2f} ms), "
        f"hint coverage {summary['hint_coverage']:.3f}, launches {launches}")
    return model, summary


def whole_step_parity(opts, model, scan_id="synth0", bounds_from=None):
    """The first frames through the kernel path and the plain path, chained,
    same weights and starting volume (over ``bounds_from``'s GT bounds when
    given, else the dataset's)."""
    import torch

    from doubletake_tpu_torch.data.loader import DataLoader
    from doubletake_tpu_torch.datasets.registry import dataset_from_opts
    from doubletake_tpu_torch.ops.integrate import integrate_plain
    from doubletake_tpu_torch.runners import common, incremental

    device = torch.device(opts.device)
    plain_model = plain_copy(model)
    ds = dataset_from_opts(opts, split=opts.split, include_full_res_depth=True,
                           pass_frame_id=True)
    loader = DataLoader(ds, batch_size=1, shuffle=False, num_workers=2)
    vol_k, cfg = common.make_fuser(opts, bounds_from or ds, scan_id, device)
    vol_p, _ = common.make_fuser(opts, bounds_from or ds, scan_id, device)
    samples = common.resolve_raycast_samples(opts, vol_k.voxel_size, opts.fusion_max_depth)
    step = incremental.make_step(model, cfg, *hint_hw(opts), samples, opts.fusion_max_depth,
                                 opts)
    kw = fuser_kwargs(vol_p, cfg)
    rows = []
    for i, (cur_np, src_np) in enumerate(loader):
        if i == PARITY_FRAMES:
            break
        cur, src = common.device_batch(cur_np, src_np, device)
        out_k, _, vol_k = step(vol_k, cur, src)
        with torch.no_grad():
            hint = common.render_hint(vol_p, cur, *hint_hw(opts), samples, opts.fusion_max_depth,
                                      use_mip=opts.raycast_mip)
            out_p = plain_model(cur, src, hint=hint, return_mask=True)
            P = torch.matmul(cur["K_s0_b44"][0], cur["cam_T_world_b44"][0])[:3].contiguous()
            vol_p.values, vol_p.weights = integrate_plain(
                vol_p.values, vol_p.weights, out_p["depth_pred_s0_bhw1"][0, ..., 0].contiguous(),
                P, vol_p.origin, **kw)
        gt = torch.as_tensor(cur_np["full_res_depth_bhw1"]).to(device)
        rows.append(batch_parity(f"{opts.name} frame {i}", out_k, out_p, gt))
    return rows


def profile_calls(name, calls, frames_per_call=1):
    """torch.profiler over warm ``calls`` (thunks): the device busy share of
    the wall time and device time by kernel, per frame, with the table in
    chiprun_out/profile_{name}.txt."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for call in calls:
            call()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # the kernels and copies themselves (CPU ops also carry their kernels'
    # device time, which would count it twice)
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    device_us = sum(dev_us(e) for e in kernels)
    top = sorted(kernels, key=dev_us, reverse=True)[:12]
    frames = len(calls) * frames_per_call
    summary = {
        "frames": frames, "wall_ms_per_frame": wall_us / frames / 1e3,
        "device_ms_per_frame": device_us / frames / 1e3,
        "device_busy_share": device_us / wall_us,
        "top": [{"name": e.key[:80], "device_ms_per_frame": dev_us(e) / frames / 1e3,
                 "calls_per_frame": e.count / frames} for e in top],
    }
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"profile_{name}.txt"), "w") as f:
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=40))
    log(f"profile {name}: {summary['wall_ms_per_frame']:.1f} ms/frame wall, "
        f"{summary['device_ms_per_frame']:.1f} ms/frame on the device "
        f"(busy {summary['device_busy_share']:.2f})")
    for row in summary["top"]:
        log(f"  {row['device_ms_per_frame']:8.3f} ms  x{row['calls_per_frame']:.2f}  {row['name']}")
    return summary


def profile_main_step(opts, model, warm=2, frames=3, name="incremental"):
    """``profile_calls`` over a few warm frames of the incremental step."""
    import torch

    from doubletake_tpu_torch.data.loader import DataLoader
    from doubletake_tpu_torch.datasets.registry import dataset_from_opts
    from doubletake_tpu_torch.runners import common, incremental

    device = torch.device(opts.device)
    ds = dataset_from_opts(opts, split=opts.split, pass_frame_id=True)
    batches = []
    for i, b in enumerate(DataLoader(ds, batch_size=1, shuffle=False, num_workers=2)):
        if i == warm + frames:
            break
        batches.append(common.device_batch(*b, device))
    vol, cfg = common.make_fuser(opts, ds, "synth0", device)
    samples = common.resolve_raycast_samples(opts, vol.voxel_size, opts.fusion_max_depth)
    step = incremental.make_step(model, cfg, *hint_hw(opts), samples, opts.fusion_max_depth,
                                 opts)
    for cur, src in batches[:warm]:
        step(vol, cur, src)
    return profile_calls(name, [lambda b=b: step(vol, *b) for b in batches[warm:]])


# ------------------------------------------------------- the other paths


def throughput_options(out_dir, name):
    """The flagship configuration in batches of 16 (offline, revisit)."""
    o = flagship_options(out_dir)
    o.name = name
    o.batch_size = BATCH
    return o


def no_hint_options(out_dir):
    o = throughput_options(out_dir, "chip_smoke_no_hint")
    # configs/models/simplerecon_model.yaml, set in code
    o.model_type = "depth_model"
    o.feature_volume_type = "mlp_feature_volume"
    o.fill_depth_hints = False
    o.extended_neg_truncation = False
    return o


def hint_hw(opts):
    """The hint's size: the matching resolution, image / 4."""
    return opts.image_height // 4, opts.image_width // 4


def require_finite(path, metrics, keys):
    for key in keys:
        v = metrics.get(key)
        if not (v is not None and v == v and abs(v) != float("inf")):
            raise RuntimeError(f"{path}: metric {key} missing or not finite")


def npz_shape(path, key):
    """The shape of array ``key`` of an npz, read from its header alone (a
    compressed volume is not decompressed)."""
    import zipfile

    import numpy as np

    with zipfile.ZipFile(path) as z, z.open(f"{key}.npy") as f:
        version = np.lib.format.read_magic(f)
        read = {(1, 0): np.lib.format.read_array_header_1_0,
                (2, 0): np.lib.format.read_array_header_2_0}[version]
        return read(f)[0]


def check_mesh(path, meshes_dir, scan, exported, colors=False):
    """The run's ``<scan>.ply``: it loads, has faces, lies inside the volume
    of ``<scan>_tsdf.npz``, carries vertex colours exactly when ``colors``,
    and matches the counts the run returned. Returns export ms and counts."""
    import numpy as np

    from doubletake_tpu_torch.tools.marching_cubes import load_ply

    verts, faces, rgb = load_ply(os.path.join(meshes_dir, f"{scan}.ply"), return_colors=True)
    npz = os.path.join(meshes_dir, f"{scan}_tsdf.npz")
    with np.load(npz) as vol:
        lo = vol["origin"].astype(np.float64)
        voxel = float(vol["voxel_size"])
    hi = lo + (np.array(npz_shape(npz, "tsdf_values")) - 1) * voxel
    inside = bool(len(verts) and (verts >= lo - 1e-4).all() and (verts <= hi + 1e-4).all())
    row = {"export_ms": exported["export_s"] * 1e3, "verts": len(verts), "faces": len(faces),
           "vertex_colors": rgb is not None}
    log(f"{path} mesh {scan}.ply: {row['verts']} vertices, {row['faces']} faces, exported in "
        f"{row['export_ms']:.1f} ms, inside the volume {inside}, colours {rgb is not None}")
    if not (len(faces) and inside and int(faces.max()) < len(verts)
            and (len(verts), len(faces)) == (exported["verts"], exported["faces"])
            and (rgb is not None) == colors):
        raise RuntimeError(f"{path}: bad mesh {scan}.ply: {row}, inside {inside}")
    return row


def drive(path, run, opts, model, expected):
    """One run of a path with both kernels' launches counted over it;
    fails unless each kernel launched ``expected``
    times. Returns the run's result and its launches, wall time and peak
    device memory."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    launches0 = kernel_launches()
    t0 = time.perf_counter()
    res = run(opts, model=model)
    sync()
    wall = time.perf_counter() - t0
    launches = kernel_launches(launches0)
    summary = {"wall_s": wall, "launches": launches, "expected_launches": expected,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    if launches != expected:
        raise RuntimeError(f"{path}: launches {launches}, expected {expected}")
    return res, summary


def plain_copy(model):
    """The model with the same weights on the plain feature-volume path."""
    import copy

    plain = copy.deepcopy(model)
    plain.cost_volume.fast_cost_volume = False
    return plain


def first_batch(opts, scan_id, batch_size):
    """The first batch of a scan, as the loader gives it (cur, src)."""
    from doubletake_tpu_torch.data.loader import DataLoader
    from doubletake_tpu_torch.datasets.registry import dataset_from_opts

    ds = dataset_from_opts(opts, split=opts.split, limit_to_scan_id=scan_id,
                           include_full_res_depth=True)
    for batch in DataLoader(ds, batch_size=batch_size, shuffle=False, num_workers=4):
        return batch


def batch_parity(name, out_k, out_p, gt):
    """Per frame of a batch: s0 depth p99 |kernel - plain| and the Abs-Diff
    metric's difference, within phase 5's budgets."""
    import numpy as np

    from doubletake_tpu_torch.runners import common

    dk, dp = out_k["depth_pred_s0_bhw1"], out_p["depth_pred_s0_bhw1"]
    p99 = np.percentile((dk - dp).abs().flatten(1).cpu().numpy(), 99, axis=1)
    delta = (common.frame_metrics(dk, gt)["abs_diff"]
             - common.frame_metrics(dp, gt)["abs_diff"]).abs().cpu().numpy()
    row = {"frames": int(dk.shape[0]), "s0_p99_m_max": float(p99.max()),
           "abs_diff_delta_m_max": float(delta.max())}
    log(f"parity {name}: {row['frames']} frames, s0 p99 <= {row['s0_p99_m_max']:.2e} m, "
        f"Abs-Diff delta <= {row['abs_diff_delta_m_max']:.2e} m")
    if not (row["s0_p99_m_max"] <= PARITY_P99_LIMIT
            and row["abs_diff_delta_m_max"] <= ABS_DIFF_DELTA_LIMIT):
        raise RuntimeError(f"parity failed on {name}: {row}")
    return row


def run_no_hint_path(out_dir, batch_np):
    import torch

    from doubletake_tpu_torch.datasets.registry import dataset_from_opts
    from doubletake_tpu_torch.runners import common, no_hint

    opts = no_hint_options(out_dir)
    device = torch.device(opts.device)
    model = common.init_or_load_params(opts, common.build_model(opts))
    frames = len(dataset_from_opts(opts, split=opts.split))
    expected = {"fused_volume": -(-frames // BATCH), "integrate": frames}
    # the parity check first: the timed run then starts warm at b=16
    cur, src = common.device_batch(*batch_np, device)
    gt = torch.as_tensor(batch_np[0]["full_res_depth_bhw1"]).to(device)
    with torch.no_grad():
        parity = batch_parity("no-hint batch 0", model(cur, src, return_mask=True),
                              plain_copy(model)(cur, src, return_mask=True), gt)
    del cur, src, gt
    res, summary = drive("no-hint", no_hint.run, opts, model, expected)
    fa = res["frame_avg"]
    require_finite("no-hint", fa, ("abs_diff", "abs_rel", "a5", "frame_time", "model_time"))
    if res["frames"] != frames:
        raise RuntimeError(f"no-hint: {res['frames']} of {frames} frames ran")
    summary.update({
        "frames": frames, "maps_per_s": frames / res["scan_time"],
        "step_maps_per_s": 1.0 / fa["frame_time"], "model_ms_per_frame": fa["model_time"] * 1e3,
        "abs_diff": fa["abs_diff"], "parity": parity,
        "mesh": check_mesh("no-hint", os.path.join(out_dir, opts.name, "no_hint_default",
                                                   "meshes"), "synth0", res["meshes"]["synth0"]),
    })
    log(f"no-hint: {frames} frames, {summary['maps_per_s']:.2f} maps/s over the scan loop, "
        f"{summary['step_maps_per_s']:.2f} by mean step (model {summary['model_ms_per_frame']:.1f} "
        f"ms a frame), peak {summary['peak_mem_gib']:.2f} GiB, launches {summary['launches']}")
    return summary, model


def run_offline_path(out_dir, model, batch_np, profile=False, opts=None, path="offline"):
    """The offline two-pass path (the flagship's unless ``opts``): the run,
    pass-1 and pass-2 parity, and for the flagship the batched raycast."""
    import torch

    from doubletake_tpu_torch.datasets.registry import dataset_from_opts
    from doubletake_tpu_torch.runners import common, offline_two_pass
    from doubletake_tpu_torch.tools.tsdf import TSDF, prepare_static, raycast

    flagship = opts is None
    opts = opts or throughput_options(out_dir, "chip_smoke_offline")
    device = torch.device(opts.device)
    frames = len(dataset_from_opts(opts, split=opts.split))
    batches = -(-frames // BATCH)
    # pass 1 and pass 2 each run every batch; each fuses every frame
    expected = {"fused_volume": 2 * batches, "integrate": 2 * frames}
    cur, src = common.device_batch(*batch_np, device)
    gt = torch.as_tensor(batch_np[0]["full_res_depth_bhw1"]).to(device)
    plain = plain_copy(model)
    hint = common.empty_hint(cur["image_bhw3"].shape[0], opts.image_height, opts.image_width,
                             device)
    # pass 1's parity check first: the timed run then starts warm at b=16
    with torch.no_grad():
        parity_pass1 = batch_parity(
            f"{path} pass 1 batch 0", model(cur, src, hint=hint, return_mask=True),
            plain(cur, src, hint=hint, return_mask=True), gt)
    res, summary = drive(path, offline_two_pass.run, opts, model, expected)
    fa = res["frame_avg"]
    require_finite(path, fa, ("abs_diff", "abs_rel", "a5", "frame_time", "hint_coverage"))
    if res["frames"] != frames or not fa["hint_coverage"] > 0:
        raise RuntimeError(f"{path}: {res['frames']} of {frames} frames, "
                           f"hint coverage {fa['hint_coverage']}")
    pt = res["pass_time"]
    summary.update({
        "frames": frames, "pass1_maps_per_s": frames / pt["pass1"],
        "pass2_maps_per_s": frames / pt["pass2"], "step_maps_per_s": 1.0 / fa["frame_time"],
        "hint_coverage": fa["hint_coverage"], "abs_diff": fa["abs_diff"],
        "parity_pass1": parity_pass1,
    })
    meshes_dir = os.path.join(out_dir, opts.name, "offline_two_pass_default", "meshes")
    summary["mesh"] = check_mesh(path, meshes_dir, "synth0", res["meshes"]["synth0"])

    hint_path = os.path.join(meshes_dir, "synth0_hint_tsdf.npz")
    loaded = TSDF.load(hint_path, device=device)
    static = prepare_static(loaded)
    samples = common.resolve_raycast_samples(opts, static.voxel_size, offline_two_pass.HINT_MAX_DEPTH)
    steps = [offline_two_pass.make_pass2_step(m, *hint_hw(opts), samples,
                                              offline_two_pass.HINT_MAX_DEPTH)
             for m in (model, plain)]
    summary["parity_pass2"] = batch_parity(f"{path} pass 2 batch 0", steps[0](static, cur, src)[0],
                                           steps[1](static, cur, src)[0], gt)
    if profile:
        summary["profile_pass2"] = profile_calls(
            "offline_pass2", [lambda: steps[0](static, cur, src)] * 3, BATCH)
    del plain, steps
    if not flagship:
        log(f"{path}: {frames} frames, pass 1 {summary['pass1_maps_per_s']:.2f} / pass 2 "
            f"{summary['pass2_maps_per_s']:.2f} maps/s over the loops, "
            f"{summary['step_maps_per_s']:.2f} by mean pass-2 step, hint coverage "
            f"{fa['hint_coverage']:.3f}, peak {summary['peak_mem_gib']:.2f} GiB, "
            f"launches {summary['launches']}")
        return summary

    # the batched raycast alone: one march over the batch's 16 poses, of the
    # volume as loaded (bf16 rounding at each corner read) and of its
    # rounded static copy, interleaved; the two must be bit-equal
    kw = dict(min_depth=common.EVAL_MIN_DEPTH, max_depth=offline_two_pass.HINT_MAX_DEPTH,
              num_samples=samples)

    def cast(vol):
        return raycast(vol, cur["world_T_cam_b44"], cur["invK_s0_b44"], *hint_hw(opts), **kw)

    def timed(vol):
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            ms = median_ms(lambda: cast(vol), reps=5, warmup=1)
        return ms, (torch.cuda.max_memory_allocated() - base) / 2**30

    with torch.no_grad():
        a, b = cast(loaded), cast(static)
    if not all(torch.equal(torch.nan_to_num(x, nan=-7.0), torch.nan_to_num(y, nan=-7.0))
               for x, y in zip(a, b)):
        raise RuntimeError("raycast of the static copy differs from the loaded volume's")
    ab = {"tsdf": [], "static": []}
    for which in ("tsdf", "static", "static", "tsdf", "tsdf", "static"):
        ab[which].append(timed(loaded if which == "tsdf" else static))
    ms = sorted(t for t, _ in ab["static"])[1]
    summary["raycast_b16"] = {
        "ms": ms, "samples": samples, "volume": list(static.dims),
        "peak_temporaries_gib": max(m for _, m in ab["static"]),
        "tsdf_ms": [t for t, _ in ab["tsdf"]], "static_ms": [t for t, _ in ab["static"]],
        "tsdf_peak_gib": max(m for _, m in ab["tsdf"])}
    log(f"raycast b={BATCH}: loaded TSDF {summary['raycast_b16']['tsdf_ms']} ms "
        f"(peak {summary['raycast_b16']['tsdf_peak_gib']:.2f} GiB), static copy "
        f"{summary['raycast_b16']['static_ms']} ms (peak "
        f"{summary['raycast_b16']['peak_temporaries_gib']:.2f} GiB)")
    log(f"offline: {frames} frames, pass 1 {summary['pass1_maps_per_s']:.2f} / pass 2 "
        f"{summary['pass2_maps_per_s']:.2f} maps/s over the loops, {summary['step_maps_per_s']:.2f} "
        f"by mean pass-2 step, hint coverage {fa['hint_coverage']:.3f}, peak "
        f"{summary['peak_mem_gib']:.2f} GiB, launches {summary['launches']}; raycast b={BATCH} "
        f"({samples} samples, volume {static.dims}): {ms:.2f} ms, temporaries "
        f"{summary['raycast_b16']['peak_temporaries_gib']:.2f} GiB")
    return summary


def run_revisit_path(out_dir, model):
    import torch

    from doubletake_tpu_torch.datasets.registry import dataset_from_opts
    from doubletake_tpu_torch.runners import common, offline_two_pass, revisit
    from doubletake_tpu_torch.tools.tsdf import TSDF, prepare_static

    opts = throughput_options(out_dir, "chip_smoke_revisit")
    opts.single_debug_scan_id = "synth0@1"
    device = torch.device(opts.device)
    rescan_ds = dataset_from_opts(opts, split=opts.split)
    first_scan, first_T_second = rescan_ds.revisit_source_scan(opts.single_debug_scan_id)
    first = len(dataset_from_opts(opts, split=opts.split, limit_to_scan_id=first_scan))
    rescan = len(rescan_ds)
    # the first visit's pass 1 in batches, the rescan frame by frame; both fused
    expected = {"fused_volume": -(-first // BATCH) + rescan, "integrate": first + rescan}
    res, summary = drive("revisit", revisit.run, opts, model, expected)
    fa = res["frame_avg"]
    require_finite("revisit", fa, ("abs_diff", "abs_rel", "a5", "frame_time", "hint_coverage"))
    if res["frames"] != rescan or not fa["hint_coverage"] > 0:
        raise RuntimeError(f"revisit: {res['frames']} of {rescan} frames, "
                           f"hint coverage {fa['hint_coverage']}")
    pt = res["pass_time"]
    summary.update({
        "first_visit_frames": first, "rescan_frames": rescan,
        "first_visit_maps_per_s": first / pt["first_visit"],
        "rescan_maps_per_s": rescan / pt["rescan"], "step_maps_per_s": 1.0 / fa["frame_time"],
        "hint_coverage": fa["hint_coverage"], "abs_diff": fa["abs_diff"],
        "mesh": check_mesh("revisit", os.path.join(out_dir, opts.name, "revisit_default",
                                                   "meshes"), opts.single_debug_scan_id,
                           res["meshes"][opts.single_debug_scan_id]),
    })

    # the parity check on the hint volume this run built from the first visit
    static = prepare_static(TSDF.load(os.path.join(
        out_dir, opts.name, "revisit_default", "meshes", f"{first_scan}_hint_tsdf.npz"),
        device=device))
    batch_np = first_batch(opts, opts.single_debug_scan_id, 1)
    cur, src = common.device_batch(*batch_np, device)
    cur["hint_world_T_cam_b44"] = torch.matmul(
        torch.as_tensor(first_T_second, dtype=torch.float32, device=device), cur["world_T_cam_b44"])
    gt = torch.as_tensor(batch_np[0]["full_res_depth_bhw1"]).to(device)
    samples = common.resolve_raycast_samples(opts, static.voxel_size, offline_two_pass.HINT_MAX_DEPTH)
    steps = [offline_two_pass.make_pass2_step(m, *hint_hw(opts), samples,
                                              offline_two_pass.HINT_MAX_DEPTH)
             for m in (model, plain_copy(model))]
    summary["parity"] = batch_parity("revisit rescan frame 0", steps[0](static, cur, src)[0],
                                     steps[1](static, cur, src)[0], gt)
    log(f"revisit: first visit {first} frames at {summary['first_visit_maps_per_s']:.2f} maps/s, "
        f"rescan {rescan} frames at {summary['rescan_maps_per_s']:.2f} maps/s over the loop, "
        f"{summary['step_maps_per_s']:.2f} by mean step, hint coverage {fa['hint_coverage']:.3f}, "
        f"peak {summary['peak_mem_gib']:.2f} GiB, launches {summary['launches']}")
    return summary


def p99_max(a, b):
    """The largest per-frame p99, and the max, of |a - b| over a batch."""
    import numpy as np

    d = (a.float() - b.float()).abs().flatten(1).cpu().numpy()
    return {"p99": float(np.percentile(d, 99, axis=1).max()), "max": float(d.max())}


def bf16_parity(name, model, cur, src, hint, gt):
    """Kernel path against plain path of a bf16 model on one batch.

    The plain path's volume is float32 (the XLA bf16 path's), so its
    decoders compute in float32; the kernel path casts the volume to bf16
    and runs them in bf16. With random weights the norm-free decoders
    amplify bf16 rounding to centimetres (two bf16 evaluations that differ
    only in their convolution algorithms differ by ~0.1 m at p99:
    scripts/probe_bf16_paths.py), so phase 5's 1e-2 m cannot hold for a
    bf16 path. Gated instead: (1) K1 on the model's own features, against
    the plain volume: mean < 5e-3, p99 < 5e-2 (phase 2's bf16 budgets);
    (2) the s0 depth: p99 |kernel - plain| within 1.5x the p99 of the plain
    volume cast to bf16 through the same bf16 decoders (the decoders' own
    rounding) against the plain path, and the Abs-Diff delta within 5e-4 m
    or 3x the decoders' own delta, whichever is larger (the kernel path
    rounds twice where the decoders' comparison rounds once: K1's bf16
    products, then the decoders). A kernel fault (scores off by order 1, as
    a wrong tile layout gives) moves depths by metres and fails all three."""
    import numpy as np
    import torch

    from doubletake_tpu_torch.models import cost_volume
    from doubletake_tpu_torch.ops.fused_volume import feature_volume_plain
    from doubletake_tpu_torch.runners import common

    plain = plain_copy(model)
    with torch.no_grad():
        vk = model(cur, src, hint=hint, stop_after="cost_volume")["cost_volume_bhwd"]
        vp = plain(cur, src, hint=hint, stop_after="cost_volume")["cost_volume_bhwd"]
        dv = (vk.float() - vp).abs().flatten()
        volume = {"mean": float(dv.mean()), "p99": float(torch.quantile(dv[::7], 0.99)),
                  "max": float(dv.max())}
        del vk, vp, dv
        dk = model(cur, src, hint=hint)["depth_pred_s0_bhw1"]
        dp = plain(cur, src, hint=hint)["depth_pred_s0_bhw1"]
        kernel = cost_volume.fused_feature_volume
        cost_volume.fused_feature_volume = feature_volume_plain
        try:   # the kernel path's types, with the plain volume
            dc = model(cur, src, hint=hint)["depth_pred_s0_bhw1"]
        finally:
            cost_volume.fused_feature_volume = kernel
    abs_diff = {k: common.frame_metrics(d, gt)["abs_diff"] for k, d in
                (("kernel", dk), ("plain", dp), ("decoders", dc))}
    row = {"frames": int(dk.shape[0]), "volume": volume, "kernel_vs_plain": p99_max(dk, dp),
           "bf16_decoders_vs_plain": p99_max(dc, dp),
           "abs_diff_delta_m_max": float((abs_diff["kernel"] - abs_diff["plain"]).abs().max()),
           "decoders_abs_diff_delta_m_max": float(
               (abs_diff["decoders"] - abs_diff["plain"]).abs().max())}
    log(f"parity {name}: K1 on the model's features |kernel - plain| mean {volume['mean']:.2e}, "
        f"p99 {volume['p99']:.2e}; s0 p99 kernel vs plain {row['kernel_vs_plain']['p99']:.2e} m "
        f"against the bf16 decoders' own {row['bf16_decoders_vs_plain']['p99']:.2e} m; "
        f"Abs-Diff delta <= {row['abs_diff_delta_m_max']:.2e} m against the decoders' own "
        f"{row['decoders_abs_diff_delta_m_max']:.2e} m")
    if not (volume["mean"] < K1_BF16_MEAN and volume["p99"] < K1_BF16_P99
            and row["kernel_vs_plain"]["p99"] <= 1.5 * row["bf16_decoders_vs_plain"]["p99"]
            and row["abs_diff_delta_m_max"] <= max(
                ABS_DIFF_DELTA_LIMIT, 3 * row["decoders_abs_diff_delta_m_max"])):
        raise RuntimeError(f"bf16 parity failed on {name}: {row}")
    return row


def run_offline_bf16_path(out_dir, fp32_model, batch_np):
    """Phase 10: the offline path with compute_dtype "bfloat16"."""
    import numpy as np
    import torch

    from doubletake_tpu_torch.datasets.registry import dataset_from_opts
    from doubletake_tpu_torch.runners import common, offline_two_pass

    opts = throughput_options(out_dir, "chip_smoke_offline_bf16")
    opts.compute_dtype = "bfloat16"
    device = torch.device(opts.device)
    model = common.init_or_load_params(opts, common.build_model(opts))
    dtypes = {p.dtype for p in model.parameters()} | {b.dtype for b in model.buffers()
                                                       if b.is_floating_point()}
    if dtypes != {torch.bfloat16}:
        raise RuntimeError(f"offline bf16: the model holds {dtypes}")
    frames = len(dataset_from_opts(opts, split=opts.split))
    expected = {"fused_volume": 2 * -(-frames // BATCH), "integrate": 2 * frames}
    cur, src = common.device_batch(*batch_np, device)
    gt = torch.as_tensor(batch_np[0]["full_res_depth_bhw1"]).to(device)
    hint = common.empty_hint(cur["image_bhw3"].shape[0], opts.image_height, opts.image_width,
                             device)
    parity = bf16_parity("offline bf16 pass 1 batch 0", model, cur, src, hint, gt)
    with torch.no_grad():
        # the same weights in float32 (the same seed): reported, not gated
        d16 = model(cur, src, hint=hint)["depth_pred_s0_bhw1"]
        d32 = fp32_model(cur, src, hint=hint)["depth_pred_s0_bhw1"]
    parity["vs_fp32"] = p99_max(d16, d32)
    log(f"offline bf16 vs float32, batch 0: s0 p99 <= {parity['vs_fp32']['p99']:.2e} m, "
        f"max {parity['vs_fp32']['max']:.2e} m (reported, not gated)")
    del cur, src, gt, d16, d32
    res, summary = drive("offline bf16", offline_two_pass.run, opts, model, expected)
    fa = res["frame_avg"]
    require_finite("offline bf16", fa, ("abs_diff", "abs_rel", "a5", "frame_time",
                                        "hint_coverage"))
    if res["frames"] != frames or not fa["hint_coverage"] > 0:
        raise RuntimeError(f"offline bf16: {res['frames']} of {frames} frames, "
                           f"hint coverage {fa['hint_coverage']}")
    pt = res["pass_time"]
    summary.update({
        "frames": frames, "pass1_maps_per_s": frames / pt["pass1"],
        "pass2_maps_per_s": frames / pt["pass2"], "step_maps_per_s": 1.0 / fa["frame_time"],
        "hint_coverage": fa["hint_coverage"], "abs_diff": fa["abs_diff"],
        "parity_pass1": parity,
    })
    log(f"offline bf16: {frames} frames, pass 1 {summary['pass1_maps_per_s']:.2f} / pass 2 "
        f"{summary['pass2_maps_per_s']:.2f} maps/s over the loops, "
        f"{summary['step_maps_per_s']:.2f} by mean pass-2 step, hint coverage "
        f"{fa['hint_coverage']:.3f}, peak {summary['peak_mem_gib']:.2f} GiB, "
        f"launches {summary['launches']}")
    return summary


def train_options(out_dir):
    """The flagship configuration as configs/models/doubletake_model.yaml
    trains it (precision 16), batch 16 on one card, on ``synthetic``."""
    o = throughput_options(out_dir, "chip_smoke_train")
    o.log_dir = out_dir
    o.precision = 16
    o.depth_hint_aug = 0.5
    o.max_steps = TRAIN_STEPS
    o.val_interval = TRAIN_STEPS
    o.val_batches = 1
    o.val_batch_size = TRAIN_VAL_BATCH
    o.log_interval = 1
    o.image_log_interval = 10 ** 9
    o.num_workers = 8
    return o


def run_train_path(out_dir, opts=None, path="train"):
    """train() for a few steps, then timed steps on a fixed batch: the
    flagship's (phase 11) unless ``opts``."""
    import copy

    import torch

    from doubletake_tpu_torch.data.loader import DataLoader
    from doubletake_tpu_torch.datasets.registry import dataset_from_opts
    from doubletake_tpu_torch.runners import common
    from doubletake_tpu_torch.training import train_loop as tl

    opts = opts or train_options(out_dir)
    device = torch.device(opts.device)
    val_sets = 4   # fill_depth_hints: hint-aug 0.5 / 1.0 / 0.0 / 0.0
    counts = {}
    validate = tl.validate

    def counted_validate(*args, **kwargs):
        counts["in_train_steps"] = kernel_launches(launches0)["fused_volume"]
        before = kernel_launches(launches0)["fused_volume"]
        out = validate(*args, **kwargs)
        counts["in_validation"] = kernel_launches(launches0)["fused_volume"] - before
        return out

    torch.cuda.reset_peak_memory_stats()
    launches0 = kernel_launches()
    tl.validate = counted_validate
    t0 = time.perf_counter()
    try:
        res = tl.train(opts)
    finally:
        tl.validate = validate
    sync()
    wall = time.perf_counter() - t0
    launches = kernel_launches(launches0)
    losses = res["losses"]
    if res["step"] != TRAIN_STEPS or not all(v == v and abs(v) != float("inf")
                                             for v in losses.values()):
        raise RuntimeError(f"{path}: step {res['step']}, losses {losses}")
    if counts != {"in_train_steps": 0, "in_validation": val_sets} or launches != {
            "fused_volume": val_sets, "integrate": 0}:
        raise RuntimeError(f"{path}: K1 launches {counts}, all launches {launches}; expected 0 "
                           f"in the train steps and {val_sets} in the validation")
    log_dir = os.path.join(opts.log_dir, opts.name)
    for rel in ("options.yaml", "code/doubletake_tpu_torch", "checkpoints", "best",
                "final_weights.ckpt"):
        if not os.path.exists(os.path.join(log_dir, rel)):
            raise RuntimeError(f"{path}: {rel} was not written")
    load_opts = copy.copy(opts)
    load_opts.load_weights_from_checkpoint = res["final_weights"]
    loaded = common.init_or_load_params(load_opts, common.build_model(load_opts)).state_dict()
    trained = res["model"].state_dict()
    if sorted(loaded) != sorted(trained) or not all(torch.equal(loaded[k], trained[k])
                                                    for k in trained):
        raise RuntimeError(f"{path}: the final .ckpt does not load the trained weights")
    summary = {"wall_s": wall, "steps": res["step"], "losses": losses, "launches": launches,
               "k1_launches": counts, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    del res, loaded, trained
    torch.cuda.empty_cache()

    # timed steps on one fixed batch, fixed augmentation
    ds = dataset_from_opts(opts, split="train", disable_flip=True)
    batch = next(iter(DataLoader(ds, BATCH, shuffle=True, num_workers=opts.num_workers,
                                 seed=opts.random_seed)))
    cur, src = tl.train_batch(*batch, device)
    opts.lr = FIXED_BATCH_LR
    model = tl.init_train_state(opts, common.build_model(opts))
    optimizer, schedule = tl.make_optimizer(opts, model)
    step = tl.make_train_step(tl.train_model_for(opts, model), optimizer, schedule,
                              use_hint_model=True, precision=16)
    aug, flip = tl.draw_step_randomness(torch.Generator().manual_seed(7), BATCH,
                                        src["image_bkhw3"].shape[1], device)
    torch.cuda.reset_peak_memory_stats()
    curve, times = [], []
    for _ in range(6):
        sync()
        t = time.perf_counter()
        curve.append(float(step(cur, src, aug, flip)["loss"]))
        times.append(time.perf_counter() - t)
    warm = sorted(times[1:])[len(times[1:]) // 2]
    summary.update({"fixed_batch_losses": curve, "step_ms": warm * 1e3,
                    "step_ms_all": [t * 1e3 for t in times], "samples_per_s": BATCH / warm,
                    "step_peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    if not (all(v == v for v in curve) and min(curve[1:]) < curve[0]):
        raise RuntimeError(f"{path}: the loss on a fixed batch did not fall: {curve}")
    log(f"{path}: {summary['steps']} steps in {wall:.1f} s, losses {losses['loss']:.4f}, K1 "
        f"launches {counts}, peak {summary['peak_mem_gib']:.2f} GiB; fixed batch: "
        f"{summary['step_ms']:.1f} ms a step ({summary['samples_per_s']:.1f} samples/s), peak "
        f"{summary['step_peak_mem_gib']:.2f} GiB, loss {[round(v, 4) for v in curve]}")
    return summary


# ------------------------------------------------------ meshes and colour


def gt_frames(ds, device):
    """The scan's GT frames at depth resolution on the card, one per tuple
    (its current frame): (depth (H, W, 1), cam_T_world, K_s0, RGB (H, W, 3)
    resized as ``runners.common.rgb_for_fusion`` resizes a batch)."""
    import torch

    from doubletake_tpu_torch.ops.resize import interpolate_bilinear

    K0 = torch.from_numpy(ds.load_intrinsics("synth0")["K_s0_b44"]).to(device)
    frames = []
    for line in ds.frame_tuples:
        scan, fid = line.split(" ")[:2]
        depth, _, _ = ds.load_target_size_depth_and_mask(scan, fid)
        rgb = torch.from_numpy(ds.load_color(scan, fid)).to(device)[None]
        rgb = interpolate_bilinear(rgb, depth.shape[:2]).clamp(0.0, 1.0)[0]
        frames.append((torch.from_numpy(depth).to(device),
                       torch.from_numpy(ds.load_pose(scan, fid)[1]).to(device), K0, rgb))
    return frames


def timed_fuse(vol, cfg, frames, color):
    """Fuse ``frames`` into ``vol`` (with their RGB if ``color``); the ms of
    each frame, CUDA events around each call."""
    import torch

    from doubletake_tpu_torch.tools.tsdf import integrate_depth

    times = []
    with torch.no_grad():
        for depth, cTw, K, rgb in frames:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            integrate_depth(vol, depth, cTw, K, cfg, image_hw3=rgb if color else None)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
    return times


def run_color_path(out_dir, model):
    """Phase 12: the no-hint path with fuse_color, then the GT depths fused
    with colour (dense plain pass) and without (K2), bit-equal."""
    import numpy as np
    import torch

    from doubletake_tpu_torch.datasets.registry import dataset_from_opts
    from doubletake_tpu_torch.runners import common, no_hint
    from doubletake_tpu_torch.tools.tsdf import TSDF

    opts = no_hint_options(out_dir)
    opts.name = "chip_smoke_color"
    opts.fuse_color = True
    device = torch.device(opts.device)
    ds = dataset_from_opts(opts, split=opts.split)
    frames = len(ds)
    # K1 once a batch; a coloured volume takes no K2 launch
    expected = {"fused_volume": -(-frames // BATCH), "integrate": 0}
    res, summary = drive("colour no-hint", no_hint.run, opts, model, expected)
    require_finite("colour no-hint", res["frame_avg"], ("abs_diff", "abs_rel", "frame_time"))
    meshes_dir = os.path.join(out_dir, opts.name, "no_hint_default", "meshes")
    vol = TSDF.load(os.path.join(meshes_dir, "synth0_tsdf.npz"))
    colors = vol.colors.float()
    observed = vol.weights > 0
    if not (torch.isfinite(colors).all() and float(colors.min()) >= 0.0
            and float(colors.max()) <= 1.0 and float(colors[observed].max()) > 0.0):
        raise RuntimeError("colour no-hint: colours not finite in [0, 1], or all zero")
    summary.update({
        "frames": frames, "maps_per_s": frames / res["scan_time"],
        "step_maps_per_s": 1.0 / res["frame_avg"]["frame_time"],
        "mean_observed_color": colors[observed].mean(0).tolist(),
        "mesh": check_mesh("colour no-hint", meshes_dir, "synth0", res["meshes"]["synth0"],
                           colors=True),
    })

    # the GT depths with their RGB (dense plain pass) against the same
    # depths through K2: values and weights bit-equal, no K2 launch for colour
    gt = gt_frames(dataset_from_opts(opts, split=opts.split, limit_to_scan_id="synth0"), device)
    vol_c, cfg = common.make_fuser(opts, ds, "synth0", device)
    vol_k = TSDF(vol_c.values.clone(), vol_c.weights.clone(), vol_c.origin, vol_c.voxel_size)
    before = kernel_launches()["integrate"]
    color_ms = timed_fuse(vol_c, cfg, gt, color=True)
    color_launches = kernel_launches()["integrate"] - before
    k2_ms = timed_fuse(vol_k, cfg, gt, color=False)
    k2_launches = kernel_launches()["integrate"] - before - color_launches
    bad = int((vol_c.values != vol_k.values).sum()) + int((vol_c.weights != vol_k.weights).sum())
    c = vol_c.colors.float()
    summary["gt_fusion"] = {
        "frames": len(gt), "differing_elements": bad, "k2_launches_colour": color_launches,
        "k2_launches_plain": k2_launches, "observed_voxels": int((vol_k.weights > 0).sum()),
        "colour_ms_per_frame": float(np.median(color_ms)), "colour_ms_all": color_ms,
        "k2_ms_per_frame": float(np.median(k2_ms)), "k2_ms_all": k2_ms}
    g = summary["gt_fusion"]
    log(f"colour no-hint: {frames} frames, launches {summary['launches']}, colours in [0, 1]; "
        f"GT fusion of {len(gt)} frames with colour {g['colour_ms_per_frame']:.3f} ms a frame "
        f"(dense plain pass, {color_launches} K2 launches) vs K2 {g['k2_ms_per_frame']:.4f} ms "
        f"a frame ({k2_launches} launches): {bad} differing elements")
    if bad or color_launches or k2_launches != len(gt) or g["observed_voxels"] == 0 or not (
            torch.isfinite(c).all() and 0.0 <= float(c.min()) and float(c.max()) <= 1.0):
        raise RuntimeError(f"colour GT fusion: {g}")
    return summary


def run_mesh_truth_path(out_dir, main_mesh_path):
    """Phase 13: the GT-depth mesh against the scene's analytic mesh under
    the visibility mask, through the two CLIs."""
    import numpy as np
    import torch

    from doubletake_tpu_torch.datasets.registry import dataset_from_opts
    from doubletake_tpu_torch.eval.mesh_eval import (
        compute_mesh_metrics,
        evaluate_mesh,
        sample_mesh_points,
    )
    from doubletake_tpu_torch.eval.visibility import SimpleVolume, integrate_visibility
    from doubletake_tpu_torch.runners import common
    from doubletake_tpu_torch.scripts import create_visibility_volume, mesh_eval
    from doubletake_tpu_torch.tools.marching_cubes import load_ply, save_ply

    opts = flagship_options(out_dir)
    opts.name = "chip_smoke_mesh"
    device = torch.device(opts.device)
    ds = dataset_from_opts(opts, split=opts.split, limit_to_scan_id="synth0")
    gt = gt_frames(ds, device)
    base = os.path.join(out_dir, opts.name)
    pred_dir, gt_dir = os.path.join(base, "pred"), os.path.join(base, "gt")
    os.makedirs(pred_dir, exist_ok=True)

    # the GT depths through K2 at the score fuser's 0.02 m / 3.5 m
    vol, cfg = common.make_fuser(opts, ds, "synth0", device)
    launches0 = kernel_launches()
    fuse_ms = timed_fuse(vol, cfg, gt, color=False)
    launches = kernel_launches(launches0)
    if launches != {"fused_volume": 0, "integrate": len(gt)}:
        raise RuntimeError(f"mesh truth: launches {launches}")
    vol.save(os.path.join(pred_dir, "synth0_tsdf.npz"))
    mesh = check_mesh("mesh truth", pred_dir, "synth0",
                      common.export_scan_mesh(vol, pred_dir, "synth0"))
    gt_v, gt_f = ds.get_gt_mesh("synth0")
    save_ply(os.path.join(gt_dir, "synth0.ply"), gt_v, gt_f)

    # the visibility volume by its CLI on the card, and the same frames timed
    t0 = time.perf_counter()
    paths = create_visibility_volume.main([
        "--dataset", "synthetic", "--split", opts.split, "--name", opts.name,
        "--output_base_path", out_dir, "--image_width", str(opts.image_width),
        "--image_height", str(opts.image_height), "--num_workers", str(opts.num_workers),
        "--single_debug_scan_id", "synth0", "--device", opts.device])
    cli_s = time.perf_counter() - t0
    vis = SimpleVolume.load(paths["synth0"], device=device)
    mine = SimpleVolume.from_bounds(common.scene_bounds_for_fusion(ds, "synth0"),
                                    create_visibility_volume.VOXEL_SIZE, device=device)
    vis_ms = []
    for depth, cTw, K, _ in gt:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        integrate_visibility(mine, depth, cTw, K)
        b.record()
        b.synchronize()
        vis_ms.append(a.elapsed_time(b))
    cli_vs_frames = int((mine.values != vis.values).sum())
    # one frame on the card against the CPU
    depth, cTw, K, _ = gt[len(gt) // 2]
    one = []
    for dev in (device, torch.device("cpu")):
        v = SimpleVolume.from_bounds(common.scene_bounds_for_fusion(ds, "synth0"),
                                     create_visibility_volume.VOXEL_SIZE, device=dev)
        one.append(integrate_visibility(v, depth.to(dev), cTw.to(dev), K.to(dev)).values.cpu())
    cpu_share = float((one[0] != one[1]).float().mean())

    # the CLI's metrics of the GT-depth mesh, and the self-checks
    t0 = time.perf_counter()
    payload = mesh_eval.main(["--pred_dir", pred_dir, "--gt_dir", gt_dir, "--visibility_dir",
                              os.path.dirname(paths["synth0"]), "--output_json",
                              os.path.join(base, "mesh_metrics.json"), "--device", opts.device])
    eval_s = time.perf_counter() - t0
    metrics = payload["per_scene"]["synth0"]
    pts = sample_mesh_points(gt_v, gt_f)
    self_metrics = compute_mesh_metrics(pts, pts)
    t0 = time.perf_counter()
    floor = evaluate_mesh(gt_v, gt_f, gt_v, gt_f, visibility_volume=vis)
    floor_s = time.perf_counter() - t0
    main_v, main_f = load_ply(main_mesh_path)
    random_weights = evaluate_mesh(main_v, main_f, gt_v, gt_f, visibility_volume=vis)
    summary = {
        "launches": launches, "frames": len(gt), "fuse_ms_per_frame": float(np.median(fuse_ms)),
        "mesh": mesh, "visibility": {
            "cli_s": cli_s, "ms_per_frame": float(np.median(vis_ms)), "ms_all": vis_ms,
            "dims": list(vis.values.shape), "visible_share": float(vis.values.mean()),
            "cli_vs_timed_differing_voxels": cli_vs_frames,
            "cuda_vs_cpu_differing_share": cpu_share},
        "metrics": metrics, "eval_s": eval_s, "self_check": self_metrics,
        "gt_vs_gt_sampling": floor, "gt_vs_gt_s": floor_s,
        "main_path_random_weights": random_weights,
    }
    log(f"mesh truth: GT-depth mesh vs the analytic room: acc {metrics['acc']:.3f} cm, compl "
        f"{metrics['compl']:.3f} cm, chamfer {metrics['chamfer']:.3f} cm, precision "
        f"{metrics['precision']:.4f}, recall {metrics['recall']:.4f}, F {metrics['fscore']:.4f} "
        f"(eval {eval_s:.1f} s); GT vs its own samples chamfer {self_metrics['chamfer']} F "
        f"{self_metrics['fscore']}; GT vs GT resampled acc {floor['acc']:.3f} cm; main path "
        f"(random weights) acc {random_weights['acc']:.2f} cm F {random_weights['fscore']:.4f}")
    log(f"mesh truth: visibility {vis.values.shape} at {create_visibility_volume.VOXEL_SIZE} m, "
        f"{summary['visibility']['ms_per_frame']:.3f} ms a frame, CLI {cli_s:.1f} s, "
        f"{summary['visibility']['visible_share']:.3f} visible, card vs CPU {cpu_share:.2e} of "
        f"the voxels differ, CLI vs timed loop {cli_vs_frames} voxels")
    finite = all(np.isfinite(v) for v in list(metrics.values()) + list(random_weights.values()))
    if not (finite and metrics["acc"] < 2.0 and metrics["precision"] > 0.95
            and self_metrics["chamfer"] == 0.0 and self_metrics["fscore"] == 1.0
            and cpu_share <= 1e-4 and cli_vs_frames == 0
            and 0.0 < summary["visibility"]["visible_share"] < 1.0):
        raise RuntimeError(f"mesh truth failed: {summary}")
    return summary


# ------------------------------------- the small config, raycast_mip, split_timing


def as_small(o, name):
    """configs/models/doubletake_small_model.yaml's model on options ``o``,
    set in code (yaml may be missing on the card): it differs from the
    flagship's only in the image encoder and the decoder."""
    o.name = name
    o.image_encoder_name = "resnet18d"
    o.depth_decoder_name = "skip"
    return o


def run_small_config(out_dir, batch_np):
    """Phase 14: the small config on the incremental path (whole-step
    parity, device time per frame), offline two-pass at b=16 and train() at
    precision 16."""
    opts = as_small(flagship_options(out_dir), "chip_smoke_small")
    model, summary = run_main_path(opts, "small incremental")
    summary["parity"] = whole_step_parity(opts, model)
    summary["profile"] = profile_main_step(opts, model, name="incremental_small")
    offline = run_offline_path(out_dir, model, batch_np, path="small offline", opts=as_small(
        throughput_options(out_dir, ""), "chip_smoke_small_offline"))
    del model
    train = run_train_path(out_dir, as_small(train_options(out_dir), "chip_smoke_small_train"),
                           path="small train")
    return {"small_incremental": summary, "small_offline_two_pass": offline,
            "small_train": train}


def run_mip_path(out_dir, model, main_summary, batch_np):
    """Phase 15: the flagship's incremental path with ``raycast_mip``; then
    the mip march against the dense march on the run's final volume. First
    the flagship's dense step is profiled, for phase 14's device time per
    frame against the small config's in the same call."""
    import torch

    from doubletake_tpu_torch.runners import common
    from doubletake_tpu_torch.tools.tsdf import TSDF, raycast

    opts = flagship_options(out_dir)
    profile = profile_main_step(opts, model, name="incremental_flagship")
    opts.name, opts.raycast_mip = "chip_smoke_mip", True
    _, summary = run_main_path(opts, "mip incremental", model=model)
    summary["profile_flagship_dense"] = profile
    summary["parity"] = whole_step_parity(opts, model)
    summary["dense_hint_ms"] = main_summary["hint_ms"]

    # the two marches on the same volume and poses (the first batch's 16,
    # at the hint's size): the run's final volume (random weights: noisy,
    # many false candidates), and the scan's GT depths fused through K2, the
    # kind of volume the JAX contract describes (a sliver under 5%,
    # tests/test_tsdf.py:148-176); only the latter is gated
    from doubletake_tpu_torch.datasets.registry import dataset_from_opts
    from doubletake_tpu_torch.tools.tsdf import integrate_depth

    device = torch.device(opts.device)
    cur, _ = common.device_batch(*batch_np, device)
    run_vol = TSDF.load(os.path.join(out_dir, opts.name, "incremental_default", "meshes",
                                     "synth0_tsdf.npz"), device=device)
    ds = dataset_from_opts(opts, split=opts.split, limit_to_scan_id="synth0")
    gt_vol, cfg = common.make_fuser(opts, ds, "synth0", device)
    for depth, cam_T_world, K, _ in gt_frames(ds, device):
        integrate_depth(gt_vol, depth, cam_T_world, K, cfg)
    samples = common.resolve_raycast_samples(opts, run_vol.voxel_size, opts.fusion_max_depth)
    kw = dict(min_depth=common.EVAL_MIN_DEPTH, max_depth=opts.fusion_max_depth,
              num_samples=samples)

    def vs_dense(vol):
        with torch.no_grad():
            dense = raycast(vol, cur["world_T_cam_b44"], cur["invK_s0_b44"], *hint_hw(opts),
                            **kw)
            mip = raycast(vol, cur["world_T_cam_b44"], cur["invK_s0_b44"], *hint_hw(opts),
                          use_mip=True, **kw)
        both = dense[2] & mip[2]
        diff = (dense[0] - mip[0]).abs()[both]
        return {"dense_valid": float(dense[2].float().mean()),
                "mip_valid": float(mip[2].float().mean()),
                "validity_differs_share": float((dense[2] != mip[2]).float().mean()),
                "both_valid_depth_differs_share": float((diff > 0).float().mean()),
                "both_valid_max_depth_diff_m": float(diff.max()) if diff.numel() else 0.0}

    summary["vs_dense"] = {"poses": int(cur["world_T_cam_b44"].shape[0]), "samples": samples,
                           "run_volume": vs_dense(run_vol), "gt_volume": vs_dense(gt_vol)}

    # one pose's march alone, dense and mip in turns (b=1, the step's)
    def one(vol, use_mip):
        return lambda: raycast(vol, cur["world_T_cam_b44"][:1], cur["invK_s0_b44"][:1],
                               *hint_hw(opts), use_mip=use_mip, **kw)

    times = {"dense": [], "mip": []}
    with torch.no_grad():
        for which in ("dense", "mip", "mip", "dense"):
            times[which].append(median_ms(one(run_vol, which == "mip"), reps=10, warmup=2))
    summary["raycast_b1_ms"] = times
    log(f"mip incremental: hint {summary['hint_ms']:.2f} ms a frame against the dense march's "
        f"{summary['dense_hint_ms']:.2f} ms (phase 4); the run volume's raycast alone (b=1) "
        f"{times['mip']} ms against {times['dense']} ms")
    for name, vd in summary["vs_dense"].items():
        if isinstance(vd, dict):
            log(f"  mip vs dense on the {name.replace('_', ' ')} at "
                f"{summary['vs_dense']['poses']} poses: validity differs on "
                f"{vd['validity_differs_share']:.4f} of the pixels (dense {vd['dense_valid']:.3f}, "
                f"mip {vd['mip_valid']:.3f}); depths differ on "
                f"{vd['both_valid_depth_differs_share']:.5f} of those valid in both, by at most "
                f"{vd['both_valid_max_depth_diff_m']:.3e} m")
    gt = summary["vs_dense"]["gt_volume"]
    if not (gt["validity_differs_share"] < 0.05 and gt["dense_valid"] > 0.1):
        raise RuntimeError(f"mip incremental: the mip march against the dense on GT depths: {gt}")
    return summary


def run_split_timing(out_dir, model):
    """Phase 16: a short incremental run (the 12-frame synthetic scan) with
    and without ``split_timing``: each frame's depth metrics and the saved
    volume equal, the split run's host-clock stage times finite."""
    import numpy as np

    from doubletake_tpu_torch.datasets import registry
    from doubletake_tpu_torch.runners import incremental

    def short_dataset(*a, **k):
        return registry.dataset_from_opts(*a, num_frames=12, **k)

    runs = {}
    dataset_from_opts = incremental.dataset_from_opts
    incremental.dataset_from_opts = short_dataset
    try:
        for split in (False, True):
            opts = flagship_options(out_dir)
            opts.name, opts.split_timing = f"chip_smoke_split_{split}", split
            frames = len(short_dataset(opts, split=opts.split))
            res, summary = drive(f"split_timing={split}", incremental.run, opts, model,
                                 {"fused_volume": frames, "integrate": frames})
            with np.load(os.path.join(out_dir, opts.name, "incremental_default", "meshes",
                                      "synth0_tsdf.npz")) as f:
                volume = (f["tsdf_values"], f["tsdf_weights"])
            runs[split] = (res, summary, volume)
    finally:
        incremental.dataset_from_opts = dataset_from_opts
    (fused, fused_summary, fused_vol), (split, summary, split_vol) = runs[False], runs[True]

    def depth_metrics(row):
        return {k: v for k, v in row.items() if not k.endswith("_time")}

    rows = split["frame_rows"]
    equal = (len(rows) == len(fused["frame_rows"]) == split["frames"] > 0
             and all(depth_metrics(a) == depth_metrics(b)
                     for a, b in zip(rows, fused["frame_rows"]))
             and all(np.array_equal(a, b) for a, b in zip(split_vol, fused_vol)))
    finite = all(np.isfinite(r[k]) and r[k] > 0 for r in rows
                 for k in ("hint_time", "model_time", "fuse_time"))
    ms = {k: [r[f"{k}_time"] * 1e3 for r in rows] for k in ("hint", "model", "fuse")}
    fused_ms = {k: [r[f"{k}_time"] * 1e3 for r in fused["frame_rows"]]
                for k in ("hint", "model", "fuse")}
    summary.update({"frames": split["frames"], "host_ms": ms, "fused_event_ms": fused_ms,
                    "fused_launches": fused_summary["launches"], "equal": equal})
    log(f"split_timing: {split['frames']} frames, depths and volume equal to the fused run's "
        f"{equal}; host-clock hint / model / fuse ms a frame (median) "
        + " / ".join(f"{sorted(v)[len(v) // 2]:.2f}" for v in ms.values())
        + "; the fused run's CUDA events " + " / ".join(
            f"{sorted(v)[len(v) // 2]:.2f}" for v in fused_ms.values()))
    if not (equal and finite):
        raise RuntimeError(f"split_timing: equal {equal}, finite times {finite}")
    return summary


# ------------------------- data-parallel training, hint renders, the extras


def compare_states(name, ref, got, lr):
    """A run's losses and state (2 steps) against a reference run's. The
    first step's losses must be bit-equal (the same forward of the same
    weights and rows). cuDNN's and grid_sample's backward add with atomics,
    so the gradients, and what follows them, need not be: the second step's
    losses within DP_LOSS_REL, the running statistics' median relative
    difference within DP_STATS_REL, and the parameters' median difference
    below lr / 10 (a rank that kept its own shard's gradients would move
    most elements by about lr). The parameters' largest difference is
    reported only: AdamW moves an element by at most about lr a step,
    whatever its gradient, so it cannot exceed ~2 lr over 2 steps. Returns
    the row, bit-equality reported."""
    import torch

    state_a, state_b = ref["state"], got["state"]
    params = [k for k in state_a if not k.endswith(("running_mean", "running_var",
                                                    "num_batches_tracked"))]
    stats = [k for k in state_a if k.endswith(("running_mean", "running_var"))]

    def flat(state, keys):
        return torch.cat([state[k].double().reshape(-1) for k in keys])

    dp = (flat(state_a, params) - flat(state_b, params)).abs()
    sa = flat(state_a, stats)
    ds = (sa - flat(state_b, stats)).abs() / sa.abs().clamp(min=1e-12)
    row = {"bit_equal": ref["losses"] == got["losses"] and all(
               torch.equal(state_a[k], state_b[k]) for k in state_a),
           "first_loss_equal": ref["losses"][0] == got["losses"][0],
           "param_max_abs": float(dp.max()), "param_median_abs": float(dp.median()),
           "loss_max_rel": max(abs(b[k] - a[k]) / max(abs(a[k]), 1e-12)
                               for a, b in zip(ref["losses"], got["losses"]) for k in a),
           "stats_max_rel": float(ds.max()), "stats_median_rel": float(ds.median())}
    log(f"{name}: bit-equal {row['bit_equal']}, first losses equal {row['first_loss_equal']}; "
        f"parameters max / median |diff| {row['param_max_abs']:.3e} (reported) / "
        f"{row['param_median_abs']:.3e} (limit {lr / 10:.1e}); losses "
        f"{row['loss_max_rel']:.3e} relative (limit {DP_LOSS_REL}); running statistics max / "
        f"median relative {row['stats_max_rel']:.3e} / {row['stats_median_rel']:.3e} (limit "
        f"{DP_STATS_REL} on the median)")
    if not (row["first_loss_equal"] and row["param_median_abs"] <= lr / 10
            and row["loss_max_rel"] <= DP_LOSS_REL and row["stats_median_rel"] <= DP_STATS_REL):
        raise RuntimeError(f"{name}: {row}")
    return row


def vector_distance(model, ref, got):
    """Two step vectors as ``pack`` lays them out (the gradients of
    ``model``'s trained parameters, its batch norms' running means and
    variances, the losses): each part's relative L2 distance."""
    import torch

    n_grad = sum(p.numel() for p in model.parameters() if p.requires_grad)
    n_stats = sum(m.running_mean.numel() + m.running_var.numel() for m in model.modules()
                  if isinstance(m, torch.nn.BatchNorm2d))
    a, b = ref.double(), got.to(ref.device).double()
    cuts = {"gradients": (0, n_grad), "statistics": (n_grad, n_grad + n_stats),
            "losses": (n_grad + n_stats, a.numel())}
    return {k: float((a[i:j] - b[i:j]).norm() / a[i:j].norm().clamp(min=1e-30))
            for k, (i, j) in cuts.items()}


def check_reduced(model, plain, rerun, ranks):
    """17(b)'s gate: each rank's first-step vector after the collective
    within the limit of every part's distance from the plain collective's
    (DP_SPREAD_FACTOR x the plain collective's distance from its rerun +
    DP_SPREAD_FLOOR); the gate must reject the two faults a collective can
    have, checked on the plain collective's own vectors: a rank that keeps
    its shard's vector (shard 0's, unreduced) and one that sums in place of
    averaging (twice the mean at a world of 2)."""
    spread = vector_distance(model, plain["reduced"], rerun["reduced"])
    limits = {k: DP_SPREAD_FACTOR * v + DP_SPREAD_FLOOR for k, v in spread.items()}
    faults = {"unreduced": vector_distance(model, plain["reduced"], plain["local"]),
              "summed": vector_distance(model, plain["reduced"], 2 * plain["reduced"])}
    got = [vector_distance(model, plain["reduced"], r["reduced"]) for r in ranks]
    row = {"rerun_spread": spread, "limits": limits, "ranks": got, "faults": faults,
           "ranks_within": all(d[k] <= limits[k] for d in got for k in limits),
           "faults_rejected": {f: {k: d[k] > limits[k] for k in limits}
                               for f, d in faults.items()}}
    def fmt(d):
        return ", ".join(f"{k} {v:.3e}" for k, v in d.items())

    log(f"data-parallel (b): first-step vector after the collective, relative L2 by part: "
        + "; ".join(f"rank {r} {fmt(d)}" for r, d in enumerate(got))
        + f"; limits {fmt(limits)} (the plain collective's rerun {fmt(spread)}); planted "
        + "; ".join(f"{f} {fmt(d)}" for f, d in faults.items()))
    if not (row["ranks_within"] and all(row["faults_rejected"]["summed"].values())
            and row["faults_rejected"]["unreduced"]["gradients"]):
        raise RuntimeError(f"data-parallel (b): the reduced vectors: {row}")
    return row


def dp_options(out_dir, batch):
    """The flagship at precision 16 (phase 11's), a global batch of
    ``batch``, the fixed-batch learning rate."""
    o = train_options(out_dir)
    o.name = f"chip_smoke_dp{batch}"
    o.batch_size = batch
    o.lr = FIXED_BATCH_LR
    return o


def dp_rank(rank, world, opts):
    """One rank of phase 17 (at module level, so that spawned ranks import
    it): ``train_loop.fixed_batch_steps`` with the kernels' launches inside
    it counted, its peak device memory, and in a group the median ms of 5
    all-reduces of the step's flat vector."""
    import torch

    from doubletake_tpu_torch.training import distributed
    from doubletake_tpu_torch.training import train_loop as tl

    device = torch.device(opts.device)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    launches0 = kernel_launches()
    res = tl.fixed_batch_steps(rank, world, opts)
    res["launches"] = kernel_launches(launches0)
    res["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    res["allreduce_ms"] = None
    if torch.distributed.is_initialized():
        flat = torch.zeros(res["flat_bytes"] // 4, dtype=torch.float32, device=device)
        ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            distributed.all_reduce_mean(flat)
            torch.cuda.synchronize(device)
            ms.append((time.perf_counter() - t0) * 1e3)
        res["allreduce_ms"] = sorted(ms)[2]
    return res


def plain_collective(opts, batch, shards_n=2, steps=2):
    """The plain collective (``make_sharded_train_step``) over ``shards_n``
    shards of ``batch`` with each rank's draws, ``steps`` steps from
    ``init_train_state``'s weights: the losses, the state on the host, the
    first step's averaged vector and shard 0's before the average (on the
    card), the model, and the kernels' launches."""
    import torch

    from doubletake_tpu_torch.runners import common
    from doubletake_tpu_torch.training import train_loop as tl

    device = torch.device(opts.device)
    model = tl.init_train_state(opts, common.build_model(opts))
    optimizer, schedule = tl.make_optimizer(opts, model)
    step = tl.make_sharded_train_step(tl.train_model_for(opts, model), optimizer, schedule,
                                      use_hint_model=True, precision=opts.precision)
    rows = opts.batch_size // shards_n
    whole = tl.train_batch(*batch, device)
    shards = [tuple({k: v[rows * r: rows * (r + 1)] for k, v in part.items()} for part in whole)
              for r in range(shards_n)]
    gens = [tl.rank_generator(opts, r) for r in range(shards_n)]
    launches0 = kernel_launches()
    losses, first = [], {}
    for i in range(steps):
        draws = [tl.draw_step_randomness(g, rows, s["image_bkhw3"].shape[1], device)
                 for g, (_, s) in zip(gens, shards)]
        out = step([(c, s, aug, flip) for (c, s), (aug, flip) in zip(shards, draws)])
        losses.append({k: float(v) for k, v in out.items()})
        if i == 0:
            first = {"reduced": step.reduced.clone(), "local": step.flats[0].clone()}
    return {"losses": losses, "state": {k: v.cpu() for k, v in model.state_dict().items()},
            "model": model, **first,
            "launches": kernel_launches(launches0)}


def run_data_parallel(out_dir, train_summary):
    """Phase 17: (a) the data-parallel step in a one-process NCCL group
    against the one-device step (and the one-device step against itself,
    the card's own reproducibility), flagship at precision 16, global
    b=16, 2 steps on one fixed batch; a world of 1 averages over one rank,
    so (a) shows the step in a group runs, not that the reduction is right;
    (b) two gloo ranks on the card (NCCL refuses two ranks on one GPU),
    global b=4, against the plain collective in this process
    (``check_reduced`` on the first step's vector, then ``compare_states``)."""
    import torch

    from doubletake_tpu_torch.training import distributed

    t0 = time.perf_counter()
    opts = dp_options(out_dir, BATCH)
    one = dp_rank(0, 1, opts)
    again = dp_rank(0, 1, opts)
    store = tempfile.mkdtemp(dir=out_dir)
    distributed.init_group(0, 1, distributed.default_backend(opts.device),
                           os.path.join(store, "store"), timeout_s=DP_TIMEOUT_S)
    try:
        dp = dp_rank(0, 1, opts)
    finally:
        torch.distributed.destroy_process_group()
    a = {"repeat": compare_states("data-parallel (a): one-device step run twice", one, again,
                                  opts.lr),
         "vs_one_device": compare_states("data-parallel (a): NCCL world of 1 vs one-device",
                                         one, dp, opts.lr),
         "step_ms": dp["step_ms"], "one_device_step_ms": one["step_ms"],
         "phase11_step_ms": train_summary["step_ms"], "flat_bytes": dp["flat_bytes"],
         "allreduce_ms": dp["allreduce_ms"], "peak_gib": dp["peak_gib"],
         "launches": dp["launches"]}
    log(f"data-parallel (a): step ms {[round(x, 1) for x in dp['step_ms']]} against the "
        f"one-device {[round(x, 1) for x in one['step_ms']]} (phase 11: "
        f"{train_summary['step_ms']:.1f}); flat vector {dp['flat_bytes'] / 2**20:.1f} MiB, "
        f"all-reduce {dp['allreduce_ms']:.3f} ms, peak {dp['peak_gib']:.2f} GiB, launches "
        f"{dp['launches']}")
    del one, again, dp

    ob = dp_options(out_dir, 4)
    ranks = distributed.spawn(dp_rank, 2, out_dir, args=(ob,), backend="gloo",
                              timeout_s=DP_TIMEOUT_S, join_timeout_s=DP_JOIN_TIMEOUT_S)
    batch = first_train_batch(ob)
    plain = plain_collective(ob, batch)
    rerun = plain_collective(ob, batch)
    b = {"reduced": check_reduced(plain["model"], plain, rerun, ranks),
         "rerun": compare_states("data-parallel (b): the plain collective run twice", plain,
                                 rerun, ob.lr),
         "ranks": [compare_states(f"data-parallel (b): gloo rank {r} vs the plain collective",
                                  plain, res, ob.lr) for r, res in enumerate(ranks)],
         "step_ms": [res["step_ms"] for res in ranks], "flat_bytes": ranks[0]["flat_bytes"],
         "allreduce_ms": [res["allreduce_ms"] for res in ranks],
         "peak_gib": [res["peak_gib"] for res in ranks],
         "launches": [res["launches"] for res in ranks]}
    launches = {k: a["launches"][k] + sum(r[k] for r in b["launches"])
                for k in ("fused_volume", "integrate")}
    log(f"data-parallel (b): 2 gloo ranks, step ms {b['step_ms']}, all-reduce ms "
        f"{b['allreduce_ms']}, peak GiB {b['peak_gib']}, launches {b['launches']} (the plain "
        f"collective's {plain['launches']} / {rerun['launches']})")
    if launches != {"fused_volume": 0, "integrate": 0} or any(
            any(p["launches"].values()) for p in (plain, rerun)):
        raise RuntimeError(f"data-parallel: kernels launched inside the steps: {launches}")
    return {"a": a, "b": b, "launches": launches, "seconds": time.perf_counter() - t0}


def first_train_batch(opts):
    """The first global batch of ``opts``' training loader, as the loader gives it."""
    from doubletake_tpu_torch.data.loader import DataLoader
    from doubletake_tpu_torch.datasets.registry import dataset_from_opts

    ds = dataset_from_opts(opts, split="train", disable_flip=True)
    batches = iter(DataLoader(ds, opts.batch_size, shuffle=True, num_workers=opts.num_workers,
                              drop_last=True, seed=opts.random_seed))
    batch = next(batches)
    batches.close()
    return batch


def run_hint_renders(out_dir, no_hint_model):
    """Phase 18: phase 7's no-hint path again, untimed, with
    ``cache_depths`` (so phase 7's timed loop copies nothing to the host);
    then ``scripts.render_hints`` on the card over those depths with
    --depth_noise 0.05: K2 once a frame and variant, the PNG counts, and
    the depth PNGs read back as the hint loader reads them within 1/2048 m
    of a raycast of the same complete volume where valid; ms a frame of a
    fuse and a render."""
    import numpy as np
    import torch

    from doubletake_tpu_torch.datasets.registry import dataset_from_opts
    from doubletake_tpu_torch.scripts import render_hints
    from doubletake_tpu_torch.tools.partial_fuser import PartialFuser
    from doubletake_tpu_torch.tools.tsdf import TSDF, FusionConfig
    from doubletake_tpu_torch.utils.io import read_image_file

    from doubletake_tpu_torch.runners import no_hint

    t0 = time.perf_counter()
    opts = no_hint_options(out_dir)
    opts.name = "chip_smoke_no_hint_cache"
    opts.cache_depths = True
    no_hint.run(opts, model=no_hint_model)
    cache_dir = os.path.join(out_dir, opts.name, "no_hint_default", "depth_cache")
    render_dir = os.path.join(out_dir, "hint_renders")
    launches0 = kernel_launches()
    t_cli = time.perf_counter()
    render_hints.main(["--dataset", "synthetic", "--single_debug_scan_id", "synth0",
                       "--split", opts.split, "--image_width", str(opts.image_width),
                       "--image_height", str(opts.image_height), "--device", opts.device,
                       "--depth_cache_dir", cache_dir, "--render_output_dir", render_dir,
                       "--depth_noise", "0.05"])
    sync()
    cli_s = time.perf_counter() - t_cli
    launches = kernel_launches(launches0)
    cache = np.load(os.path.join(cache_dir, "synth0_depths.npz"))
    ids, depths = cache["frame_ids"], cache["depths"]
    counts = {v: len(os.listdir(os.path.join(render_dir, "synth0", v)))
              for v in ("renders", "partial_renders")}
    expected = {"fused_volume": 0, "integrate": 2 * len(ids)}
    if launches != expected or counts != {"renders": 2 * len(ids),
                                          "partial_renders": 2 * len(ids)}:
        raise RuntimeError(f"hint renders: launches {launches} (expected {expected}), "
                           f"PNGs {counts} for {len(ids)} frames")

    # the complete volume again in memory, timed; its raycasts against the PNGs
    ds = dataset_from_opts(opts, split=opts.split, limit_to_scan_id="synth0")
    fuser = PartialFuser(TSDF.from_bounds(render_hints.scene_bounds_for_fusion(ds, "synth0"),
                                          render_hints.VOXEL_SIZE, device=opts.device),
                         FusionConfig(min_depth=0.5, max_depth=3.0))
    fuse_ms, render_ms, worst, valid_share = [], [], 0.0, []
    for i, fid in enumerate(ids):
        sync()
        t = time.perf_counter()
        fuser.fuse_frame(depths[i], ds.load_pose("synth0", fid)[1],
                         ds.load_intrinsics("synth0", fid)["K_s0_b44"])
        sync()
        fuse_ms.append((time.perf_counter() - t) * 1e3)
    K = render_hints.scaled_K(ds.load_intrinsics("synth0", ids[-1])["K_s0_b44"], ds)
    for fid in ids:
        sync()
        t = time.perf_counter()
        depth, _, valid = fuser.render_hint(ds.load_pose("synth0", fid)[0], np.linalg.inv(K),
                                            render_hints.RENDER_H, render_hints.RENDER_W)
        depth, valid = depth.cpu().numpy(), valid.cpu().numpy()
        render_ms.append((time.perf_counter() - t) * 1e3)
        png = read_image_file(os.path.join(render_dir, "synth0", "renders",
                                           f"depth_{int(fid):06d}.png"),
                              height=render_hints.RENDER_H, width=render_hints.RENDER_W,
                              value_scale_factor=1.0 / 2048.0, resampling_mode="nearest")
        png = png[..., 0] if png.ndim == 3 else png
        both = valid & (png > 0)
        valid_share.append(float(both.mean()))
        if both.any():
            worst = max(worst, float(np.abs(png[both] - depth[both]).max()))
    summary = {"frames": len(ids), "launches": launches, "pngs": counts, "cli_s": cli_s,
               "fuse_ms": fuse_ms, "render_ms": render_ms, "decode_max_abs_m": worst,
               "valid_share_mean": float(np.mean(valid_share)),
               "seconds": time.perf_counter() - t0}
    log(f"hint renders: {len(ids)} frames x 2 variants in {cli_s:.1f} s, launches {launches}, "
        f"PNGs {counts}; fuse {np.median(fuse_ms):.2f} / render {np.median(render_ms):.2f} ms a "
        f"frame (median); PNG vs raycast max {worst:.2e} m over "
        f"{summary['valid_share_mean']:.3f} valid pixels a frame")
    if not (worst <= 1.0 / 2048.0 and summary["valid_share_mean"] > 0.1):
        raise RuntimeError(f"hint renders: {summary}")
    return summary


def run_extras(out_dir, model, main_opts):
    """Phase 19: ``integrate_batch`` of the GT frames through K2 bit-equal to
    a loop of ``integrate_depth``; ``cull=True`` bit-equal to ``cull=False``;
    ``sample_tsdf`` on the card against the CPU within SAMPLE_TOL; the
    trajectory CLI on phase 4's volume over TRAJECTORY_FRAMES frames; a
    12-frame incremental run with dump_depth_visualization: one panel a
    frame."""
    import numpy as np
    import torch

    from doubletake_tpu_torch.datasets import registry
    from doubletake_tpu_torch.runners import common, incremental
    from doubletake_tpu_torch.scripts import render_trajectory
    from doubletake_tpu_torch.tools import tsdf as tt

    t0 = time.perf_counter()
    device = torch.device(main_opts.device)
    ds = registry.dataset_from_opts(main_opts, split=main_opts.split)
    frames = gt_frames(ds, device)
    launches0 = kernel_launches()
    vols = {}
    with torch.no_grad():
        for name in ("batch", "loop", "cull"):
            vols[name], cfg = common.make_fuser(main_opts, ds, "synth0", device)
        tt.integrate_batch(vols["batch"], torch.stack([f[0] for f in frames]),
                           torch.stack([f[1] for f in frames]),
                           torch.stack([f[2] for f in frames]), cfg)
        for depth, cTw, K, _ in frames:
            tt.integrate_depth(vols["loop"], depth, cTw, K, cfg)
            tt.integrate_depth(vols["cull"], depth, cTw, K, cfg, cull=True,
                               cull_max_fraction=0.5)
    launches = kernel_launches(launches0)
    equal = {name: bool(torch.equal(vols[name].values, vols["loop"].values)
                        and torch.equal(vols[name].weights, vols["loop"].weights))
             for name in ("batch", "cull")}
    fraction = tt.choose_cull_fraction(vols["loop"], [f[1] for f in frames], frames[0][2],
                                       cfg, *frames[0][0].shape[:2])
    vol = vols["loop"]
    lo, hi = vol.origin, vol.origin + (torch.tensor(vol.dims, device=device) - 1) * vol.voxel_size
    gen = torch.Generator(device="cpu").manual_seed(0)
    pts = (lo - 0.1 + torch.rand((200000, 3), generator=gen).to(device) * (hi - lo + 0.2))
    cpu_vol = tt.TSDF(vol.values.cpu(), vol.weights.cpu(), vol.origin.cpu(), vol.voxel_size)
    sample_err = {}
    for what in ("tsdf", "weights"):
        card = tt.sample_tsdf(vol, pts, what=what).cpu()
        sample_err[what] = float((card - tt.sample_tsdf(cpu_vol, pts.cpu(), what=what)).abs().max())
    log(f"extras: integrate_batch bit-equal to a loop {equal['batch']}, cull=True to "
        f"cull=False {equal['cull']} (K2 launches {launches['integrate']} over "
        f"{3 * len(frames)} fuses; choose_cull_fraction {fraction:.3f}); sample_tsdf card vs "
        f"CPU max {sample_err}")
    if not (all(equal.values()) and max(sample_err.values()) <= SAMPLE_TOL
            and launches == {"fused_volume": 0, "integrate": 3 * len(frames)}):
        raise RuntimeError(f"extras: equal {equal}, sample errors {sample_err}, "
                           f"launches {launches}")
    del vols, vol, cpu_vol

    tsdf_path = os.path.join(main_opts.output_base_path, main_opts.name, "incremental_default",
                             "meshes", "synth0_tsdf.npz")
    t = time.perf_counter()
    traj = render_trajectory.main(["--dataset", "synthetic", "--single_debug_scan_id", "synth0",
                                   "--split", main_opts.split, "--device", main_opts.device,
                                   "--tsdf_path", tsdf_path,
                                   "--output", os.path.join(out_dir, "birdseye.mp4"),
                                   "--max_frames", str(TRAJECTORY_FRAMES)])
    traj_ms = (time.perf_counter() - t) * 1e3 / max(traj["frames"], 1)
    log(f"extras: render_trajectory {traj['frames']} frames at 384x512, {traj_ms:.1f} ms a "
        f"frame (video encode included) -> {os.path.basename(traj['path'])}")
    if traj["frames"] != TRAJECTORY_FRAMES or not os.path.exists(traj["path"]):
        raise RuntimeError(f"extras: render_trajectory wrote {traj}")

    def short_dataset(*a, **k):
        return registry.dataset_from_opts(*a, num_frames=12, **k)

    opts = flagship_options(out_dir)
    opts.name, opts.dump_depth_visualization = "chip_smoke_viz", True
    n = len(short_dataset(opts, split=opts.split))
    dataset_from_opts = incremental.dataset_from_opts
    incremental.dataset_from_opts = short_dataset
    try:
        res, viz = drive("dump_depth_visualization", incremental.run, opts, model,
                         {"fused_volume": n, "integrate": n})
    finally:
        incremental.dataset_from_opts = dataset_from_opts
    panels = sorted(os.listdir(os.path.join(out_dir, opts.name, "incremental_default", "viz")))
    log(f"extras: dump_depth_visualization {res['frames']} frames, {len(panels)} panels, "
        f"launches {viz['launches']}")
    if len(panels) != res["frames"] or res["frames"] != n:
        raise RuntimeError(f"extras: {len(panels)} panels for {res['frames']} frames")
    return {"launches": {k: launches[k] + viz["launches"][k] for k in launches},
            "integrate_batch_equal": equal["batch"], "cull_equal": equal["cull"],
            "cull_fraction": fraction, "sample_max_abs": sample_err,
            "trajectory": {"frames": traj["frames"], "ms_per_frame": traj_ms,
                           "output": os.path.basename(traj["path"])},
            "viz": {"frames": res["frames"], "panels": len(panels), **viz},
            "seconds": time.perf_counter() - t0}


# ------------------------------------------- the evaluation chain through files


def write_scannet_scan(root, scan=SCANNET_SCAN, num_frames=SCANNET_FRAMES, lost=SCANNET_LOST,
                       width=640, height=480, seed=0, threads=8):
    """A ScanNet-layout scan of ``SyntheticScene(seed)`` along
    ``synthetic_trajectory(num_frames, seed)`` under ``root/scans_test/<scan>``
    (``root/scans`` links to ``scans_test``, the train split's folder):
    ``sensor_data/frame-%06d.color.jpg``, ``.depth.png`` (uint16 mm) and
    ``.pose.txt`` (world_T_cam; all ``-inf`` for the frames in ``lost``,
    ScanNet's mark for lost tracking), ``intrinsic/intrinsic_depth.txt`` (the
    synthetic K at ``width`` x ``height``) and ``<scan>.txt``. Returns the
    poses written, None where lost."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image

    from doubletake_tpu_torch.datasets.synthetic import SyntheticScene, synthetic_trajectory

    scan_dir = os.path.join(root, "scans_test", scan)
    sensor = os.path.join(scan_dir, "sensor_data")
    os.makedirs(sensor)
    os.makedirs(os.path.join(scan_dir, "intrinsic"))
    if not os.path.exists(os.path.join(root, "scans")):
        os.symlink("scans_test", os.path.join(root, "scans"))
    # the synthetic dataset's K (fx = fy = 0.58 x width, centred)
    K = np.eye(4)
    K[0, 0] = K[1, 1] = 0.58 * width
    K[0, 2], K[1, 2] = width / 2, height / 2
    np.savetxt(os.path.join(scan_dir, "intrinsic", "intrinsic_depth.txt"), K)
    with open(os.path.join(scan_dir, f"{scan}.txt"), "w") as f:
        f.write(f"colorHeight = {height}\ncolorWidth = {width}\ndepthHeight = {height}\n"
                f"depthWidth = {width}\nfx_depth = {K[0, 0]}\nfy_depth = {K[1, 1]}\n"
                f"mx_depth = {K[0, 2]}\nmy_depth = {K[1, 2]}\nnumColorFrames = {num_frames}\n"
                f"numDepthFrames = {num_frames}\n")
    scene = SyntheticScene(seed=seed)
    poses = synthetic_trajectory(num_frames, seed)

    def write(i):
        rgb, depth = scene.render(poses[i], K, height, width)
        path = os.path.join(sensor, f"frame-{i:06d}")
        Image.fromarray(np.round(rgb * 255).astype(np.uint8)).save(f"{path}.color.jpg",
                                                                    quality=95)
        mm = np.where(np.isfinite(depth), np.round(depth * 1000.0), 0.0)
        Image.fromarray(mm.astype(np.uint16)).save(f"{path}.depth.png")
        np.savetxt(f"{path}.pose.txt",
                   np.full((4, 4), -np.inf) if i in lost else poses[i])

    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(write, range(num_frames)))
    return [None if i in lost else p for i, p in enumerate(poses)]


class RoomBounds:
    """Fusion bounds of the synthetic room, for ``common.make_fuser`` (and
    either package's ``scene_bounds_for_fusion``): the ScanNet reader has
    none, so its runs fuse into a +-10 m cube."""

    def __init__(self, seed=0):
        from doubletake_tpu_torch.datasets.synthetic import SyntheticScene

        self.scene = SyntheticScene(seed=seed)

    def get_gt_mesh_bounds(self, scan_id):
        return self.scene.room_min, self.scene.room_max


def slab_parity(name, vol, frames, kw, slab=CUBE_SLAB):
    """K2's ``vol`` after ``frames`` (depth (H, W), P (3, 4)), fused from a
    fresh volume, against the plain version chained over the same frames
    slab by slab along x from a fresh slab (values -1, weights 0): each slab
    keeps its voxels' indices in the whole volume (``first_voxel``), so its
    arithmetic is the whole volume's, and the plain temporaries stay a
    slab's. Bit-equal or it raises."""
    import torch

    from doubletake_tpu_torch.ops import integrate as ig

    X = vol.values.shape[0]
    bad = observed = 0
    t0 = time.perf_counter()
    for x0 in range(0, X, slab):
        x1 = min(x0 + slab, X)
        pv = -torch.ones_like(vol.values[x0:x1])
        pw = torch.zeros_like(vol.weights[x0:x1])
        for depth, P in frames:
            pv, pw = ig.integrate_plain(pv, pw, depth, P, vol.origin, first_voxel=(x0, 0, 0),
                                        **kw)
        bad += int((vol.values[x0:x1] != pv).sum()) + int((vol.weights[x0:x1] != pw).sum())
        observed += int((pw > 0).sum())
    sync()
    log(f"K2 integrate, {name}, on {tuple(vol.values.shape)} over {len(frames)} frames vs the "
        f"plain version in x-slabs of {slab}: {bad} differing elements, {observed} observed "
        f"voxels ({time.perf_counter() - t0:.1f} s)")
    if bad != 0 or observed == 0:
        raise RuntimeError(f"K2 differs from its plain version on {bad} elements, or fused "
                           f"nothing ({name}, {observed} observed voxels)")
    return {"dims": list(vol.values.shape), "frames": len(frames), "slab": slab,
            "differing": bad, "observed": observed}


def cube_parity(opts, ds, scan, frames, dims):
    """``frames`` (GT depth, cam_T_world, K, _) fused through K2 by
    ``integrate_depth`` into the volume ``common.make_fuser`` gives ``ds``
    (the ScanNet reader's +-10 m cube, which must have the evaluation
    run's ``dims``), held bit-equal to the plain version slab by slab."""
    import torch

    from doubletake_tpu_torch.runners import common
    from doubletake_tpu_torch.tools.tsdf import integrate_depth

    torch.cuda.empty_cache()
    cube, cfg = common.make_fuser(opts, ds, scan, opts.device)
    if list(cube.values.shape) != list(dims):
        raise RuntimeError(f"the reader's volume {list(cube.values.shape)} is not the "
                           f"evaluation's {list(dims)}")
    before = kernel_launches()["integrate"]
    with torch.no_grad():
        for depth, cTw, K, _ in frames:
            integrate_depth(cube, depth, cTw, K, cfg)
        # the depth and P that integrate_depth gives K2
        planes = [(depth[..., 0].contiguous(), torch.matmul(K, cTw)[:3].contiguous())
                  for depth, cTw, K, _ in frames]
        summary = slab_parity("the reader's cube", cube, planes, fuser_kwargs(cube, cfg))
    summary["k2_launches"] = kernel_launches()["integrate"] - before
    if summary["k2_launches"] != len(frames):
        raise RuntimeError(f"the cube took {summary['k2_launches']} K2 launches for "
                           f"{len(frames)} frames")
    del cube, planes
    torch.cuda.empty_cache()
    return summary


def options_argv(opts, keys):
    """CLI flags that give ``keys`` the values they have in ``opts``."""
    argv = []
    for key in keys:
        value = getattr(opts, key)
        if isinstance(value, bool):
            argv += [f"--{key}"] if value else []
        else:
            argv += [f"--{key}", str(value)]
    return argv


def run_scannet_path(out_dir, train_dir, main_summary):
    """Phase 20: a ScanNet-layout scan on disk; its valid frames and tuple
    files by the port's CLIs; phase 11's training state stripped by the
    CLI; ``scripts.evaluation`` on the card over the scan's 8-frame default
    tuples through the ScanNet reader; the reader's GT depths fused and
    meshed against the analytic room."""
    import shutil

    import numpy as np
    import torch

    from doubletake_tpu_torch.datasets.registry import dataset_from_opts
    from doubletake_tpu_torch.options import OptionsHandler
    from doubletake_tpu_torch.runners import common
    from doubletake_tpu_torch.scripts import (
        create_visibility_volume,
        evaluation,
        generate_test_tuples,
        generate_train_tuples,
        mesh_eval,
        precompute_valid_frames,
        strip_checkpoint,
    )
    from doubletake_tpu_torch.tools import tuple_generation
    from doubletake_tpu_torch.tools.marching_cubes import save_ply
    from doubletake_tpu_torch.utils.io import readlines

    path, scan = "scannet eval", SCANNET_SCAN
    t_phase = time.perf_counter()
    summary = {"scan": scan, "frames_on_disk": SCANNET_FRAMES,
               "lost_frames": [SCANNET_LOST.start, SCANNET_LOST.stop - 1]}

    # (a) the scan on disk
    root = os.path.join(os.path.dirname(OUT_DIR), "build", "scannet_synth")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    poses = write_scannet_scan(root)
    summary["write_s"] = time.perf_counter() - t0
    split_file = os.path.join(root, "scans.txt")
    with open(split_file, "w") as f:
        f.write(f"{scan}\n")
    tuple_dir = os.path.join(root, "tuples")
    data = ["--dataset", "scannet", "--dataset_path", root, "--dataset_scan_split_file",
            split_file, "--tuple_info_file_location", tuple_dir]

    # (b) valid frames and tuple files by the CLIs, against the tuple
    # functions on the poses written (ids, gaps and poses from the writer)
    t0 = time.perf_counter()
    written = precompute_valid_frames.main(data + ["--split", "test"])[scan]
    valid = [i for i, p in enumerate(poses) if p is not None]
    dists = [i - prev - 1 for prev, i in zip([-1] + valid[:-1], valid)]
    ids = [f"{i:06d}" for i in valid]
    valid_poses = [poses[i] for i in valid]
    if readlines(written) != [f"{scan} {fid} {d}" for fid, d in zip(ids, dists)]:
        raise RuntimeError(f"{path}: {written} differs from the poses written")
    files = {}
    for kind in TUPLE_TYPES:
        files[kind] = (generate_test_tuples.main(data + ["--split", "test",
                                                         "--frame_tuple_type", kind]),
                       tuple_generation.generate_test_tuples(
                           scan, valid_poses, ids, kind, 8, dists_to_last_valid=dists))
    for k, suffix in ((8, "_eight_view_train.txt"), (2, "_two_view_train.txt")):
        files[f"train_{k}"] = (generate_train_tuples.main(data + [
            "--split", "train", "--num_images_in_tuple", str(k), "--mv_tuple_file_suffix",
            suffix]), tuple_generation.generate_train_tuples(scan, valid_poses, ids, k))
    summary["tuples_s"] = time.perf_counter() - t0
    counts = {}
    for kind, (file, want) in files.items():
        with open(file) as f:
            text = f.read()
        refs = {fid for line in want for fid in line.split(" ")[1:]}
        counts[kind] = {"lines": len(want), "file": os.path.relpath(file, root),
                        "short": sum(len(line.split(" ")) - 1 < 8 for line in want)}
        if text != "\n".join(want) + "\n" or not want or not refs <= set(ids):
            raise RuntimeError(f"{path}: {file} differs from the in-process tuples, or "
                               f"references a frame that is not valid: {counts[kind]}")
    summary["tuples"] = counts
    log(f"{path}: wrote {SCANNET_FRAMES} frames ({len(valid)} valid) in "
        f"{summary['write_s']:.1f} s; tuple files equal to the in-process tuples in "
        f"{summary['tuples_s']:.1f} s: " + ", ".join(
            f"{k} {c['lines']} lines ({c['short']} short)" for k, c in counts.items()))

    # (c) phase 11's last training state stripped, loaded bit-equal
    states = sorted(f for f in os.listdir(os.path.join(train_dir, "checkpoints"))
                    if f.startswith("step_") and f.endswith(".pt"))
    src = os.path.join(train_dir, "checkpoints", states[-1])
    ckpt = strip_checkpoint.main(["--src", src, "--dst", os.path.join(out_dir,
                                                                      "scannet_eval.ckpt")])
    def eval_argv(suffix, name):
        return data + options_argv(flagship_options(out_dir), (
            "model_type", "feature_volume_type", "image_encoder_name", "matching_encoder_type",
            "depth_decoder_name", "cv_encoder_type", "loss_type", "fill_depth_hints",
            "image_width", "image_height", "batch_size", "fast_cost_volume", "depth_fuser",
            "random_seed", "device")) + [
            "--split", "test", "--num_workers", "4", "--name", name, "--output_base_path",
            out_dir, "--single_debug_scan_id", scan, "--mv_tuple_file_suffix", suffix,
            "--load_weights_from_checkpoint", ckpt]

    argv = eval_argv(SCANNET_KEPT_SUFFIX, "chip_smoke_scannet")
    opts = evaluation.score_options(OptionsHandler(argv).parse_and_merge_options())
    model = common.init_or_load_params(opts, common.build_model(opts))
    loaded = model.state_dict()
    trained = torch.load(src, map_location="cpu", weights_only=True)["model"]
    final = torch.load(os.path.join(train_dir, "final_weights.ckpt"), map_location="cpu",
                       weights_only=True)["state_dict"]
    for name, ref in (("the training state", trained), ("phase 11's final .ckpt", final)):
        if sorted(loaded) != sorted(ref) or not all(torch.equal(loaded[k].cpu(), ref[k])
                                                    for k in ref):
            raise RuntimeError(f"{path}: the stripped .ckpt does not load {name}'s weights")
    summary["stripped"] = {"src": states[-1], "tensors": len(loaded)}

    # (d) scripts.evaluation on the card over the 8-frame default tuples
    default = readlines(files["default"][0])
    kept = [line for line in default if len(line.split(" ")) - 1 == 8]
    with open(os.path.join(tuple_dir, f"test{SCANNET_KEPT_SUFFIX}"), "w") as f:
        f.write("\n".join(kept) + "\n")
    summary["kept_lines"], summary["dropped_lines"] = len(kept), len(default) - len(kept)
    log(f"{path}: {len(kept)} of {len(default)} default lines have 8 frames; "
        f"{len(default) - len(kept)} dropped")
    torch.cuda.reset_peak_memory_stats()
    launches0 = kernel_launches()
    t0 = time.perf_counter()
    res = evaluation.main(argv)
    sync()
    wall = time.perf_counter() - t0
    launches = kernel_launches(launches0)
    expected = {"fused_volume": len(kept), "integrate": len(kept)}
    if launches != expected or res["frames"] != len(kept):
        raise RuntimeError(f"{path}: launches {launches}, frames {res['frames']}, "
                           f"expected {expected}")
    fa = res["frame_avg"]
    require_finite(path, fa, ("abs_diff", "abs_rel", "a5", "frame_time", "hint_time",
                              "model_time", "fuse_time", "hint_coverage"))
    meshes_dir = os.path.join(out_dir, opts.name, "incremental_default", "meshes")
    dims = list(npz_shape(os.path.join(meshes_dir, f"{scan}_tsdf.npz"), "tsdf_weights"))
    summary.update({
        "launches": launches, "wall_s": wall, "frames": res["frames"],
        # the CLI's wall outside its scan loop: the model and its weights,
        # the volume, its npz and the mesh export
        "outside_loop_s": wall - res["scan_time"],
        "maps_per_s": res["frames"] / res["scan_time"],
        "step_maps_per_s": 1.0 / fa["frame_time"],
        "phase4_maps_per_s": main_summary["maps_per_s"],
        "phase4_step_maps_per_s": main_summary["step_maps_per_s"],
        "frame_ms": fa["frame_time"] * 1e3, "hint_ms": fa["hint_time"] * 1e3,
        "model_ms": fa["model_time"] * 1e3, "fuse_ms": fa["fuse_time"] * 1e3,
        "hint_coverage": fa["hint_coverage"], "abs_diff": fa["abs_diff"],
        "abs_rel": fa["abs_rel"], "volume_dims": dims,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "mesh": check_mesh(path, meshes_dir, scan, res["meshes"][scan]),
    })
    log(f"{path}: {res['frames']} frames through the ScanNet reader, "
        f"{summary['maps_per_s']:.2f} maps/s over the scan loop (phase 4: "
        f"{main_summary['maps_per_s']:.2f}), {summary['step_maps_per_s']:.2f} maps/s by mean "
        f"step (phase 4: {main_summary['step_maps_per_s']:.2f}); hint coverage "
        f"{fa['hint_coverage']:.3f}, Abs-Diff {fa['abs_diff']:.4f} m vs the PNG depths; volume "
        f"{dims}, peak {summary['peak_mem_gib']:.2f} GiB; launches {launches}")
    # a line of fewer than 8 frames: the 8-view model must refuse it (the K1
    # wrapper takes only the MLP width of the line's views)
    short = next(line for line in default if len(line.split(" ")) - 1 < 8)
    with open(os.path.join(tuple_dir, f"test{SCANNET_SHORT_SUFFIX}"), "w") as f:
        f.write(short + "\n")
    try:
        evaluation.main(eval_argv(SCANNET_SHORT_SUFFIX, "chip_smoke_scannet_short"))
    except ValueError as e:
        if "fused volume kernel takes an MLP" not in str(e):
            raise
        summary["short_line"] = {"line": short, "error": str(e)}
    else:
        raise RuntimeError(f"{path}: the short line '{short}' went through the 8-view model")
    log(f"{path}: the short line '{short}' is refused: {summary['short_line']['error']}")
    # the first frames, kernel path against plain path, over the room's
    # bounds (the plain model and hint renders are the parity's subject; K2
    # on the reader's cube is held to the plain version in (e))
    summary["parity"] = whole_step_parity(opts, model, scan_id=scan, bounds_from=RoomBounds())
    del model

    # (e) the reader's GT depths (PNG, mm) and poses: the first frames fused
    # through K2 into the reader's own +-10 m cube (the volume that (d)
    # drives) and held bit-equal to the plain version slab by slab; all of
    # them fused over the room, meshed and scored against the analytic room
    ds = dataset_from_opts(opts, split="test", limit_to_scan_id=scan,
                           mv_tuple_file_suffix=None)
    K0 = torch.from_numpy(ds.load_intrinsics(scan)["K_s0_b44"]).to(opts.device)
    gt = [(torch.from_numpy(ds.load_target_size_depth_and_mask(scan, fid)[0]).to(opts.device),
           torch.from_numpy(ds.load_pose(scan, fid)[1]).to(opts.device), K0, None)
          for fid in ids]
    summary["cube_parity"] = cube_parity(opts, ds, scan, gt[:CUBE_FRAMES], dims)
    vol, cfg = common.make_fuser(opts, RoomBounds(), scan, opts.device)
    before = kernel_launches()["integrate"]
    fuse_ms = timed_fuse(vol, cfg, gt, color=False)
    gt_launches = kernel_launches()["integrate"] - before
    base = os.path.join(out_dir, "chip_smoke_scannet_mesh")
    pred_dir, gt_dir = os.path.join(base, "pred"), os.path.join(base, "gt")
    os.makedirs(pred_dir, exist_ok=True)
    vol.save(os.path.join(pred_dir, f"{scan}_tsdf.npz"))
    truth_mesh = check_mesh(path, pred_dir, scan, common.export_scan_mesh(vol, pred_dir, scan))
    save_ply(os.path.join(gt_dir, f"{scan}.ply"), *RoomBounds().scene.gt_mesh())
    t0 = time.perf_counter()
    vis = create_visibility_volume.main(data + [
        "--split", "test", "--mv_tuple_file_suffix", "_eight_view_deepvmvs_dense_offline.txt",
        "--name", "chip_smoke_scannet_mesh", "--output_base_path", out_dir,
        "--image_width", str(opts.image_width), "--image_height", str(opts.image_height),
        "--num_workers", "4", "--single_debug_scan_id", scan, "--device", opts.device])
    vis_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    metrics = mesh_eval.main([
        "--pred_dir", pred_dir, "--gt_dir", gt_dir, "--visibility_dir",
        os.path.dirname(vis[scan]), "--output_json", os.path.join(base, "mesh_metrics.json"),
        "--device", opts.device])["per_scene"][scan]
    summary["mesh_truth"] = {
        "frames": len(gt), "k2_launches": gt_launches,
        "fuse_ms_per_frame": float(np.median(fuse_ms)), "mesh": truth_mesh,
        "visibility_cli_s": vis_s, "eval_s": time.perf_counter() - t0, "metrics": metrics}
    log(f"{path}: the reader's GT depths ({len(gt)} frames, {gt_launches} K2 launches) vs "
        f"the analytic room: acc {metrics['acc']:.3f} cm, compl {metrics['compl']:.3f} cm, "
        f"precision {metrics['precision']:.4f}, recall {metrics['recall']:.4f}, F "
        f"{metrics['fscore']:.4f}")
    if not (gt_launches == len(gt) == len(valid) and all(np.isfinite(v) for v in
                                                         metrics.values())
            and metrics["acc"] < 2.0 and metrics["precision"] > 0.95):
        raise RuntimeError(f"{path}: the reader's GT mesh failed: {summary['mesh_truth']}")
    summary["phase_s"] = time.perf_counter() - t_phase
    log(f"{path}: phase 20 took {summary['phase_s']:.1f} s")
    return summary


# -------------------------------------------------------------- kernel line


def time_k1(args):
    """K1's time (batches of 10 launches), its plain version's and its bound
    at the shape of ``args``."""
    import torch

    from doubletake_tpu_torch.ops import fused_volume as fv

    hint = torch.nan_to_num(args[-1], nan=0.0)
    cur, src = args[0], args[1]
    b, h, w, c = cur.shape
    k, d = src.shape[1], args[6].shape[0]
    (w1, _), _, _ = args[7]
    nin, hid = w1.shape[1], w1.shape[0]
    # the MLPs as the reference computes them (every channel for every plane)
    macs = b * d * h * w * (nin * hid + hid * hid + hid + 3 * 12 + 12 * 12 + 12)
    # the kernel's tensor-core products: per plane 23 rows a view and W2,
    # per pixel the c + 3 + 3k channels all planes share; three bf16
    # products each (hi/lo split) in the float32 mode, one in the bf16 mode
    macs_tc = b * h * w * (d * (23 * k * hid + hid * hid) + (c + 3 + 3 * k) * hid)
    products = 1 if cur.dtype == torch.bfloat16 else 3
    # and outside the tensor cores: + plane * w, LeakyReLU . w3, hint MLP
    macs_simt = b * d * h * w * (2 * hid + 3 * 12 + 12 * 12 + 12)
    mlp_tensors = [x for pair in args[7] + args[8] for x in pair]
    bytes_k1 = nbytes(*args[:7], hint, *mlp_tensors) + b * d * h * w * 4
    with torch.no_grad():
        ms = median_ms(lambda: fv.fused_feature_volume(*args), reps=20, inner=10)
        plain_ms = median_ms(lambda: fv.feature_volume_plain(*args[:-1], hint), reps=5, warmup=1)
    t_ops = max(products * 2 * macs_tc / BF16_TC_PEAK, 2 * macs_simt / FP32_PEAK) * 1e3
    t_bytes = bytes_k1 / HBM_RATE * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            # the PR 1 bound: the reference's MACs at the fp32 rate outside
            # the tensor cores
            "bound_fp32_simt_ms": 2 * macs / FP32_PEAK * 1e3}


def time_kernels(k1, k1_bf16, k2, launches, bf16_launches):
    from doubletake_tpu_torch.ops import integrate as ig
    from doubletake_tpu_torch.tools.tsdf import TSDF

    rows = []
    # K1: one call computes the (1, 64, 96, 128) hint volume; and the
    # (16, 64, 96, 128) volume of an offline pass-2 batch
    pass2 = {"b": BATCH, "max_abs_err": k1["errors"][PASS2_CASE], **time_k1(k1["pass2_args"])}
    # the bf16 mode at both shapes; its launches are the bf16 serving path's
    bf16 = {"launches": bf16_launches, "max_abs_err": k1_bf16["max_abs_err"],
            "errors": k1_bf16["errors"], **time_k1(k1_bf16["args"]),
            "pass2_shape": {"b": BATCH, **time_k1(k1_bf16["pass2_args"])}}
    rows.append({
        "name": "fused_feature_volume", "route": "cuda",
        "source": "doubletake_tpu_torch/csrc/fused_volume.cu",
        "replaces": "doubletake_tpu/ops/pallas/fused_volume.py:511",
        "launches": launches["fused_volume"], "max_abs_err": k1["max_abs_err"],
        "library_ms": None, **time_k1(k1["args"]), "pass2_shape": pass2, "bf16": bf16,
    })
    log(f"fused_feature_volume at b={BATCH}: {pass2['ms']:.3f} ms (plain {pass2['plain_ms']:.3f} "
        f"ms, bound {pass2['bound_ms']:.4f} ms by {pass2['bound_by']})")
    for tag, row in (("b=1", bf16), (f"b={BATCH}", bf16["pass2_shape"])):
        log(f"fused_feature_volume bf16 mode at {tag}: {row['ms']:.3f} ms (plain "
            f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms by {row['bound_by']})")

    # K2: one fusion step on the 304x200x152 volume with the third frame's
    # depth. Which voxels update depends on the depth and the pose only, not
    # on the volume's state, so repeated launches do the same work.
    frames, bounds = k2["frames"], k2["bounds"]
    vol = TSDF.from_bounds(bounds, 0.02, device="cuda")
    kw = integrate_kwargs()
    depth, P = frames[2]
    _, first_w = ig.integrate_plain(vol.values, vol.weights, depth, P, vol.origin, **kw)
    changed = int((first_w > 0).sum())
    n_vox = vol.values.numel()
    culled = ig.block_cull_plain(tuple(vol.dims), tuple(depth.shape), P, vol.origin,
                                 voxel_size=kw["voxel_size"], max_depth=kw["max_depth"])
    # bytes this run needs: the depth image, and each updated voxel's value
    # and weight read and written once; operations: ~24 to project and test
    # every voxel, ~16 more to update one
    bytes_k2 = nbytes(depth, P, vol.origin) + changed * 16
    ops_k2 = 24 * n_vox + 16 * changed
    ms = median_ms(lambda: ig.fused_integrate(vol.values, vol.weights, depth, P, vol.origin,
                                              **kw), reps=20, inner=10)
    plain_ms = median_ms(lambda: ig.integrate_plain(vol.values, vol.weights, depth, P,
                                                    vol.origin, **kw), reps=5, warmup=1)
    t_ops, t_bytes = ops_k2 / FP32_PEAK * 1e3, bytes_k2 / HBM_RATE * 1e3
    rows.append({
        "name": "fused_integrate", "route": "cuda",
        "source": "doubletake_tpu_torch/csrc/integrate.cu",
        "replaces": "doubletake_tpu/ops/pallas/integrate.py:542",
        "launches": launches["integrate"], "max_abs_err": k2["max_abs_err"],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None,
        "changed_voxels": changed, "voxels": n_vox,
        "boxes_culled_share": float(culled.float().mean()),
    })
    for r in rows:
        log(f"{r['name']}: {r['ms']:.3f} ms (plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']})")
    return rows


# --------------------------------------------------------------------- main


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the GPU port only",
              file=sys.stderr)
        return 2

    from doubletake_tpu_torch.ops import build as kbuild
    from doubletake_tpu_torch.options import Options
    from doubletake_tpu_torch.runners import common

    kernels_only = "--kernels-only" in argv
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    opts = Options()
    device = common.resolve_device(opts)   # cuda, TF32 off

    t0 = time.perf_counter()
    kbuild.build(["fused_volume", "integrate", "marching"])
    build_s = time.perf_counter() - t0
    log(f"built kernels in {build_s:.1f} s into {kbuild.BUILD_DIR}")
    for name, text in kbuild.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  nvcc {name}: {line.strip()}")

    results = {"card": smi, "kind": kind, "torch": torch.__version__,
               "cuda": torch.version.cuda, "build_s": build_s,
               "nvcc": kbuild.build_logs}
    k1 = check_fused_volume(device)
    k1_bf16 = check_fused_volume_bf16(device, k1)
    k2 = check_integrate(device)
    results["k1_max_abs_err"] = k1["max_abs_err"]
    results["k1_errors"] = k1["errors"]
    results["k1_bf16_errors"] = k1_bf16["errors"]
    results["k2_max_abs_err"] = k2["max_abs_err"]

    if not kernels_only:
        with tempfile.TemporaryDirectory(dir=os.path.dirname(OUT_DIR)) as tmp:
            opts = flagship_options(tmp)
            model, main_summary = run_main_path(opts)
            results["main_path"] = main_summary
            results["parity"] = whole_step_parity(opts, model)
            if "--profile" in argv:
                results["profile"] = profile_main_step(opts, model)
            batch_np = first_batch(opts, "synth0", BATCH)
            no_hint_summary, no_hint_model = run_no_hint_path(tmp, batch_np)
            paths = {"no_hint": no_hint_summary}
            paths["offline_two_pass"] = run_offline_path(tmp, model, batch_np,
                                                         "--profile" in argv)
            paths["revisit"] = run_revisit_path(tmp, model)
            paths["offline_bf16"] = run_offline_bf16_path(tmp, model, batch_np)
            paths["raycast_mip"] = run_mip_path(tmp, model, main_summary, batch_np)
            paths["split_timing"] = run_split_timing(tmp, model)
            paths["extras"] = run_extras(tmp, model, opts)
            del model
            paths["train"] = run_train_path(tmp)
            paths["data_parallel"] = run_data_parallel(tmp, paths["train"])
            paths["hint_renders"] = run_hint_renders(tmp, no_hint_model)
            paths["color_no_hint"] = run_color_path(tmp, no_hint_model)
            del no_hint_model
            paths["mesh_truth"] = run_mesh_truth_path(tmp, os.path.join(
                opts.output_base_path, opts.name, "incremental_default", "meshes", "synth0.ply"))
            paths.update(run_small_config(tmp, batch_np))
            paths["scannet_eval"] = run_scannet_path(
                tmp, os.path.join(tmp, "chip_smoke_train"), main_summary)
            results["paths"] = paths
            kernels = time_kernels(k1, k1_bf16, k2, main_summary["launches"],
                                   paths["offline_bf16"]["launches"]["fused_volume"])
        by_path = {"incremental": main_summary["launches"],
                   **{p: v["launches"] for p, v in paths.items()}}
    else:
        # the paths did not run: their launch counts were not measured
        kernels = time_kernels(k1, k1_bf16, k2, {"fused_volume": None, "integrate": None}, None)
        by_path = None
    for row, key in zip(kernels, ("fused_volume", "integrate")):
        row["launches_by_path"] = by_path and {p: n[key] for p, n in by_path.items()}
    results["kernels"] = kernels

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(results, f, indent=1)
    if kernels_only:
        print(json.dumps({"kernels": kernels}))
        return 0
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
