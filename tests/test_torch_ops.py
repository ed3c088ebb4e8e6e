"""Geometry, grid-sample and resize ops: the PyTorch port against the JAX
package on the same numpy inputs (CPU, float32). The bound is 1e-6 absolute
on O(1) values (a few ulps); index rules (nearest, rint ties, plane
ramps) must agree exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from doubletake_tpu.models.cost_volume import generate_depth_planes as jax_planes
from doubletake_tpu.ops import grid_sample as jgs
from doubletake_tpu.ops import resize as jrs
from doubletake_tpu.utils import geometry as jgeo

from doubletake_tpu_torch.models.cost_volume import generate_depth_planes
from doubletake_tpu_torch.ops import grid_sample as tgs
from doubletake_tpu_torch.ops import resize as trs
from doubletake_tpu_torch.utils import geometry as tgeo

ATOL = 1e-6


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=atol)


def random_pose(rng):
    q = rng.randn(4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                 [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                 [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]]
    T[:3, 3] = rng.randn(3)
    return T


def test_geometry():
    rng = np.random.RandomState(0)
    h, w = 6, 10
    np.testing.assert_array_equal(tgeo.pixel_grid_homogeneous(h, w).numpy(),
                                  np.asarray(jgeo.pixel_grid_homogeneous(h, w)))
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 8.0, 9.0, w / 2, h / 2
    invK = np.linalg.inv(K)[None].astype(np.float32)
    depth = (rng.rand(2, 1, h * w) + 0.5).astype(np.float32)
    invK2 = np.repeat(invK, 2, 0)
    pts_t = tgeo.backproject_depth(t(depth), t(invK2), h, w)
    pts_j = jgeo.backproject_depth(jnp.asarray(depth), jnp.asarray(invK2), h, w)
    close(pts_t.numpy(), pts_j)

    poses = np.stack([random_pose(rng) for _ in range(2)])
    K2 = np.repeat(K[None], 2, 0)
    close(tgeo.project_points(pts_t, t(K2), t(poses)).numpy(),
          jgeo.project_points(pts_j, jnp.asarray(K2), jnp.asarray(poses)), atol=1e-4)

    poses[0] = np.eye(4)  # identity: the clamped sqrt must stay finite
    for a, b in zip(tgeo.pose_distance(t(poses)), jgeo.pose_distance(jnp.asarray(poses))):
        close(a.numpy(), b)
    v = rng.randn(3, 5, 4).astype(np.float32)
    v[:, 0] = 0.0
    close(tgeo.normalize_vectors(t(v), 0).numpy(), jgeo.normalize_vectors(jnp.asarray(v), 0))


@pytest.mark.parametrize("mode,align", [("bilinear", False), ("nearest", False),
                                        ("bilinear", True)])
def test_grid_sample_2d(mode, align):
    rng = np.random.RandomState(1)
    img = rng.randn(2, 7, 9, 5).astype(np.float32)
    grid = (rng.rand(2, 4, 6, 2) * 2.6 - 1.3).astype(np.float32)   # some outside
    grid[0, 0, 0] = [0.0, 0.0]
    out_t = tgs.grid_sample_2d(t(img), t(grid), mode=mode, align_corners=align)
    out_j = jgs.grid_sample_2d(jnp.asarray(img), jnp.asarray(grid), mode=mode,
                               align_corners=align)
    close(out_t.numpy(), out_j)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_grid_sample_3d(mode):
    rng = np.random.RandomState(2)
    vol = rng.randn(5, 6, 7, 2).astype(np.float32)
    pts = (rng.rand(40, 3) * 2.4 - 1.2).astype(np.float32)
    close(tgs.grid_sample_3d(t(vol), t(pts), mode=mode).numpy(),
          jgs.grid_sample_3d(jnp.asarray(vol), jnp.asarray(pts), mode=mode))


@pytest.mark.parametrize("out_hw", [(12, 16), (3, 4), (5, 7), (6, 8)])
def test_resize(out_hw):
    x = np.random.RandomState(3).randn(2, 6, 8, 3).astype(np.float32)
    np.testing.assert_array_equal(trs.interpolate_nearest(t(x), out_hw).numpy(),
                                  np.asarray(jrs.interpolate_nearest(jnp.asarray(x), out_hw)))
    close(trs.interpolate_bilinear(t(x), out_hw).numpy(),
          jrs.interpolate_bilinear(jnp.asarray(x), out_hw))


def test_pyramid_and_pads():
    x = np.random.RandomState(4).randn(1, 8, 10, 3).astype(np.float32)
    close(trs.upsample2x_bilinear(t(x)).numpy(), jrs.upsample2x_bilinear(jnp.asarray(x)))
    for a, b in zip(trs.pyrdown(t(x), 3), jrs.pyrdown(jnp.asarray(x), 3)):
        close(a.numpy(), b)
    close(trs.reflect_pad(t(x), (1, 2), (2, 1)).numpy(),
          jrs.reflect_pad(jnp.asarray(x), (1, 2), (2, 1)))
    close(trs.replicate_pad(t(x), (1, 2), (2, 1)).numpy(),
          jrs.replicate_pad(jnp.asarray(x), (1, 2), (2, 1)))


@pytest.mark.parametrize("num", [8, 16, 64, 96])
def test_linspace_and_depth_planes(num):
    np.testing.assert_array_equal(tgeo.linspace01(num).numpy(),
                                  np.asarray(jnp.linspace(0.0, 1.0, num)))
    # exp/log may round 1 ulp apart between XLA and torch
    np.testing.assert_allclose(generate_depth_planes(0.25, 5.0, num).numpy(),
                               np.asarray(jax_planes(0.25, 5.0, num)), rtol=2.5e-7, atol=0)


def test_depth_metrics():
    from doubletake_tpu.utils.metrics import compute_depth_metrics_batched as jax_metrics

    from doubletake_tpu_torch.utils.metrics import ResultsAverager, compute_depth_metrics_batched

    rng = np.random.RandomState(6)
    gt = (rng.rand(3, 50) * 4 + 0.1).astype(np.float32)
    pred = (gt * (1 + rng.randn(3, 50) * 0.1)).astype(np.float32)
    gt[0, :5] = np.nan
    valid = np.isfinite(gt) & (gt > 0.5)
    ref = jax_metrics(jnp.asarray(gt), jnp.asarray(pred), jnp.asarray(valid), mult_a=True)
    out = compute_depth_metrics_batched(t(gt), t(pred), t(valid), mult_a=True)
    assert sorted(out) == sorted(ref)
    for k in ref:
        close(out[k].numpy(), ref[k], atol=1e-5)

    avg = ResultsAverager("x", "frame avg")
    for i in range(3):
        avg.update_results({k: float(v[i]) for k, v in out.items()})
    avg.compute_final_average()
    np.testing.assert_allclose(avg.final_metrics["abs_rel"], float(out["abs_rel"].mean()),
                               rtol=1e-6)
