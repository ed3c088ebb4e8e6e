"""model_ms: the ``DepthModelCVHint`` forward's time a frame (encoders, the
hint feature volume through K1, the cost-volume encoder, the decoder), the
median over the traced run's window of the port's ``StageClock`` span from
the hint mark to the model mark (CUDA events)."""

import statistics


def read(m):
    spans = [u.stages["model"] for u in m.window if u.stages]
    return statistics.median(spans) if spans else None
