"""device_idle: the share of the traced stretch's wall time in which no
kernel, copy or fill ran on the card (the union of their intervals)."""


def read(m):
    if not m.trace or not m.trace["kernels"]:
        return None
    return 100.0 * (1.0 - m.trace["busy_s"] / m.trace["window_s"])
