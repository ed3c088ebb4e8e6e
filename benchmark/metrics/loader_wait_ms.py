"""loader_wait_ms: the consumer's wait for a batch of the port's
``DataLoader`` (its ``data.loader_wait`` spans, ``data/loader.py``), summed
over the traced stretch (offline: both passes) per delivered map. Read from
the port's span records (``utils/tracing.py``); None where the port records
none."""


def read(m):
    try:
        from doubletake_tpu_torch.utils import tracing
    except ImportError:           # a port without span records
        return None
    waits = [r.end_ns - r.start_ns for r in tracing.records()
             if r.name == "data.loader_wait" and r.end_ns >= 0]
    maps = sum(u.maps for u in m.traced)
    return sum(waits) / 1e6 / maps if waits and maps else None
