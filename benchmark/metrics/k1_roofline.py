"""k1_roofline: K1's share of its roofline (``ops/fused_volume`` ->
``csrc/fused_volume.cu``): for each launch in the traced stretch, the least
time the card could take for the work the algorithm needs
(``counts.k1_work`` at the cell's batch, source views, matching grid and
planes: the larger of its FLOPs over 989 TFLOP/s and its bytes over
3.35 TB/s), summed, over the launches' summed device time. Launches are
matched by the kernel's name."""

from benchmark.counts import bound_seconds, k1_work

KERNEL = "fused_volume_kernel"


def read(m):
    launches = m.kernels(KERNEL)
    if not launches:
        return None
    o = m.ctx.opts
    bound = bound_seconds(*k1_work(o.batch_size, o.model_num_views - 1, o.image_height // 4,
                                   o.image_width // 4, o.matching_num_depth_bins,
                                   o.matching_feature_dims))
    return 100.0 * bound * len(launches) / sum(d for _, d in launches)
