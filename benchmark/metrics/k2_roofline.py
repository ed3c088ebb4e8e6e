"""k2_roofline: K2's share of its roofline (``ops/integrate`` ->
``csrc/integrate.cu``) on the score volume: for each fuse of a delivered
map in the traced stretch, 16 bytes for every voxel the frame updates (the
reference's update predicate on the depth the program fused) plus the
depth image, over 3.35 TB/s, summed, over those launches' summed device
time. The score volume's fuses are the last launches of the stretch (the
offline pass 1 fuses into its hint volume first); launches are matched by
the kernel's name."""

from benchmark.counts import bound_seconds, k2_work, updated_voxels

KERNEL = "integrate_kernel"


def read(m):
    fused = [f for u in m.traced for f in (u.fused or [])]
    launches = m.kernels(KERNEL)
    if not fused or len(launches) < len(fused):
        return None
    bound = 0.0
    for f in fused:
        n = updated_voxels(f["dims"], f["origin"], f["voxel_size"], f["depth"], f["cam_T_world"],
                           f["K"], f["max_depth"], f["extended"])
        bound += bound_seconds(*k2_work(n, *f["depth"].shape))
    return 100.0 * bound / sum(d for _, d in launches[-len(fused):])
