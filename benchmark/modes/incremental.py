"""The online loop: ``runners.incremental.make_step`` once a frame, in a
closed loop (frame t+1 needs frame t's volume), session after session.

Each session is one scan of the pool, taken in turn, with a new volume from
``common.make_fuser`` and the source views' matching-feature cache kept as
``runners.incremental.run`` keeps it (``FEAT_CACHE_MAX``). A frame's time
runs from handing its host batch to ``common.device_batch`` to the sync
after its fuse: then its depth map exists and the volume is ready for the
next frame. Nothing is scored or written.
"""

from __future__ import annotations

import time
from collections import OrderedDict

import torch

from benchmark.harness import Unit
from benchmark.program import ScanDataset, common
from benchmark.reference import chain
from doubletake_tpu_torch.data.loader import DataLoader
from doubletake_tpu_torch.runners import incremental

WINDOW_UNIT = "frame"        # the window may close after any frame
WARM_FRAMES = 16             # covers frames without and with cached source features


def frames(ctx, session: int, limit=None):
    """Yield a ``Unit`` for each frame of ``session`` (at most ``limit``)."""
    opts, device = ctx.opts, ctx.device
    scan = ctx.scans[session % len(ctx.scans)]
    ds = ScanDataset(scan, opts, pass_frame_id=True)
    loader = DataLoader(ds, batch_size=1, shuffle=False, num_workers=min(4, opts.num_workers))
    tsdf, cfg = common.make_fuser(opts, ds, scan.scan_id, device)
    samples = common.resolve_raycast_samples(opts, tsdf.voxel_size, opts.fusion_max_depth)
    step = incremental.make_step(ctx.model, cfg, opts.image_height // 4, opts.image_width // 4,
                                 samples, opts.fusion_max_depth, opts=opts)
    keep = ctx.keeper(session)
    cache: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    n = len(ds) if limit is None else min(limit, len(ds))
    batches = iter(loader)
    try:
        for i in range(n):
            tw = time.perf_counter()
            with ctx.span("loader"):
                cur_np, src_np = next(batches)
            t0 = time.perf_counter()
            with ctx.span("device_batch"):
                cur, src = common.device_batch(cur_np, src_np, device)
            ids = src_np["frame_id_string"][0]
            src_feats = None
            if all(j in cache for j in ids):
                src_feats = torch.stack([cache[j] for j in ids])[None]
            clock = ctx.clock()
            out, hint, tsdf = step(tsdf, cur, src, src_feats=src_feats, clock=clock)
            fid = cur_np["frame_id_string"][0]
            cache[fid] = out["matching_feats_bhwc"][0]
            cache.move_to_end(fid)
            while len(cache) > incremental.FEAT_CACHE_MAX:
                cache.popitem(last=False)
            with ctx.span("sync"):
                ctx.sync()
            t1 = time.perf_counter()
            done = i == len(ds) - 1
            if keep is not None:
                keep.frame(out["depth_pred_s0_bhw1"], hint)
                if done:
                    keep.volume("", tsdf)
            fused = None
            if ctx.tracing:
                fused = [ctx.fused_record(tsdf, cfg, out["depth_pred_s0_bhw1"][0, ..., 0],
                                          cur["cam_T_world_b44"][0], cur["K_s0_b44"][0])]
            yield Unit(maps=1, t0=t0, t1=t1, session=session, session_done=done,
                       frame_ms=(t1 - t0) * 1e3, wait_ms=(t0 - tw) * 1e3,
                       stages=clock.elapsed_ms() if clock is not None else None, fused=fused)
    finally:
        batches.close()


def run(ctx):
    """Frames of session after session, for as long as the harness pulls."""
    session = 0
    while True:
        yield from frames(ctx, session)
        session += 1


def warm_up(ctx):
    """The first frames of a session on the pool's last scan."""
    for _ in frames(ctx, -1, limit=WARM_FRAMES):
        pass


def reference(ctx, session: int, model, judged=None):
    """The reference over ``session``, following the judged outputs step by
    step: it fuses their depths (module doc of ``benchmark.compare``)."""
    scan = ctx.scans[session % len(ctx.scans)]
    return chain.incremental(model, scan, ctx.config["options"], ctx.device,
                             fused_depths=None if judged is None else judged["depth"])
