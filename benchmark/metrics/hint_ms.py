"""hint_ms: the hint raycast's time a frame (``tools.tsdf.raycast`` of the
running volume, ``runners.common.render_hint``), the median over the traced
run's window of the port's ``StageClock`` span from the step's start mark to
its hint mark (CUDA events)."""

import statistics


def read(m):
    spans = [u.stages["hint"] for u in m.window if u.stages]
    return statistics.median(spans) if spans else None
