"""mfu: the whole step's share of the card's dense bf16 peak: the
configuration's FLOPs of a delivered map (the plain reference's count at
the cell's call pattern, ``counts.model_flops``, stored in the
configuration file) times the maps delivered in the traced stretch, over
the stretch's wall time times 989 TFLOP/s."""

from benchmark.counts import PEAK_FLOPS


def read(m):
    if not m.trace or not m.trace["kernels"]:
        return None
    flops = m.ctx.config["flops_per_map"][m.ctx.cell.traffic["mode"]]
    maps = sum(u.maps for u in m.traced)
    return 100.0 * flops * maps / (m.trace["window_s"] * PEAK_FLOPS)
