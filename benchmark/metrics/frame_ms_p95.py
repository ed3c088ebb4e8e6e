"""frame_ms_p95: an online frame's latency, the 95th percentile over the
traced run's window (the traced stretch left out) of the host-clock time from
handing the frame's host batch to ``runners.common.device_batch`` to the
sync after its fuse, when its depth map exists and the volume is ready for
the next frame. Unbounded: the host's speed swings it (PERF.md, section 2)."""

import numpy as np


def read(m):
    traced = {id(u) for u in m.traced}
    frame_ms = [u.frame_ms for u in m.window if u.frame_ms is not None and id(u) not in traced]
    return float(np.percentile(frame_ms, 95)) if frame_ms else None
