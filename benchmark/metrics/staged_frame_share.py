"""staged_frame_share: the share of the images that a batch's tuples
reference which the port's loader staged, each distinct frame once
(``data/loader.py``): 100 * ``data.frames_staged`` /
``data.frames_referenced`` over the process (``utils/tracing.py``
counters). 100% where no two tuples of a batch share a frame. None where
the port counts neither."""


def read(m):
    try:
        from doubletake_tpu_torch.utils import tracing
    except ImportError:           # a port without counters
        return None
    counters = tracing.counters()
    staged = counters.get("data.frames_staged")
    referenced = counters.get("data.frames_referenced")
    return 100.0 * staged / referenced if staged and referenced else None
