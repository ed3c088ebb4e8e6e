"""copy_ms: the host's time in the host-to-device copies of a batch (the
port's ``runner.device_batch`` spans, ``runners/common.device_batch``),
summed over the traced stretch (offline: both passes) per delivered map.
Read from the port's span records (``utils/tracing.py``); None where the
port records none."""


def read(m):
    try:
        from doubletake_tpu_torch.utils import tracing
    except ImportError:           # a port without span records
        return None
    copies = [r.end_ns - r.start_ns for r in tracing.records()
              if r.name == "runner.device_batch" and r.end_ns >= 0]
    maps = sum(u.maps for u in m.traced)
    return sum(copies) / 1e6 / maps if copies and maps else None
