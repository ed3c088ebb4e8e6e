"""dispatch_ms: the host's time to issue one online frame's step (raycast,
forward and fuse, before the harness's sync: the port's ``runner.step``
span, ``runners/incremental.make_step``), the median over the traced
stretch's frames. Read from the port's span records (``utils/tracing.py``);
None where the port records none."""

import statistics


def read(m):
    try:
        from doubletake_tpu_torch.utils import tracing
    except ImportError:           # a port without span records
        return None
    steps = [(r.end_ns - r.start_ns) / 1e6 for r in tracing.records()
             if r.name == "runner.step" and r.end_ns >= 0]
    return statistics.median(steps) if steps else None
