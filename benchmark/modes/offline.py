"""The offline two-pass loop at the cell's batch, scan after scan, composed
as ``runners.offline_two_pass.run`` composes it.

Per session (one scan of the pool, taken in turn): pass 1,
``offline_two_pass.compute_hint_volume`` over the scan (empty hints, its
depths fused into the 0.04 m / 3.0 m hint volume); ``tools.tsdf.
prepare_static``; pass 2, ``offline_two_pass.make_pass2_step`` on each
batch; and the final fuse, ``integrate_depth`` per frame into the score
volume. A batch's maps are delivered at the sync after its final fuse;
pass-1 depths count for nothing. The window closes only at the end of a
session. Nothing is scored or written.
"""

from __future__ import annotations

import time

import torch

from benchmark.harness import Unit
from benchmark.program import ScanDataset, common
from benchmark.reference import chain
from doubletake_tpu_torch.data.loader import DataLoader
from doubletake_tpu_torch.runners import offline_two_pass
from doubletake_tpu_torch.tools.tsdf import integrate_depth, prepare_static

WINDOW_UNIT = "session"


def batches(ctx, session: int):
    """Yield a ``Unit`` for each pass-2 batch of ``session``; pass 1 runs
    before the first."""
    opts, device = ctx.opts, ctx.device
    scan = ctx.scans[session % len(ctx.scans)]
    if len(scan.tuples) % opts.batch_size:
        raise ValueError(f"{len(scan.tuples)} tuples a scan do not split into batches of "
                         f"{opts.batch_size}")
    ds = ScanDataset(scan, opts, pass_frame_id=False)
    keep = ctx.keeper(session)
    with ctx.span("pass1"):
        hint_tsdf = offline_two_pass.compute_hint_volume(opts, ctx.model, ds, scan.scan_id, device)
    if keep is not None:
        keep.volume("hint_", hint_tsdf)
    samples = common.resolve_raycast_samples(opts, hint_tsdf.voxel_size,
                                             offline_two_pass.HINT_MAX_DEPTH)
    step = offline_two_pass.make_pass2_step(ctx.model, opts.image_height // 4,
                                            opts.image_width // 4, samples,
                                            offline_two_pass.HINT_MAX_DEPTH)
    with ctx.span("prepare_static"):
        static = prepare_static(hint_tsdf)
    final, cfg = common.make_fuser(opts, ds, scan.scan_id, device)
    loader = DataLoader(ds, batch_size=opts.batch_size, shuffle=False,
                        num_workers=opts.num_workers)
    n = len(loader)
    it = iter(loader)
    try:
        for bi in range(n):
            tw = time.perf_counter()
            with ctx.span("loader"):
                cur_np, src_np = next(it)
            t0 = time.perf_counter()
            with ctx.span("device_batch"):
                cur, src = common.device_batch(cur_np, src_np, device)
            with ctx.span("pass2"):
                out, hint = step(static, cur, src)
            with ctx.span("fuse"), torch.no_grad():
                depth = common.depth_for_fusion(opts, out)
                for i in range(depth.shape[0]):
                    integrate_depth(final, depth[i], cur["cam_T_world_b44"][i],
                                    cur["K_s0_b44"][i], cfg)
            with ctx.span("sync"):
                ctx.sync()
            t1 = time.perf_counter()
            done = bi == n - 1
            if keep is not None:
                keep.frame(out["depth_pred_s0_bhw1"], hint)
                if done:
                    keep.volume("", final)
            fused = None
            if ctx.tracing:
                fused = [ctx.fused_record(final, cfg, depth[i, ..., 0], cur["cam_T_world_b44"][i],
                                          cur["K_s0_b44"][i]) for i in range(depth.shape[0])]
            yield Unit(maps=depth.shape[0], t0=t0, t1=t1, session=session, session_done=done,
                       fused=fused, wait_ms=(t0 - tw) * 1e3)
    finally:
        it.close()


def run(ctx):
    session = 0
    while True:
        yield from batches(ctx, session)
        session += 1


def warm_up(ctx):
    """One whole session on the pool's last scan: pass 1, the static copy,
    pass 2 and the final fuse at the cell's batch."""
    for _ in batches(ctx, -1):
        pass


def reference(ctx, session: int, model, judged=None):
    """The reference over ``session``, worked out on its own from the frames."""
    scan = ctx.scans[session % len(ctx.scans)]
    return chain.offline(model, scan, ctx.config["options"], ctx.device, ctx.opts.batch_size)
