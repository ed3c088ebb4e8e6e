"""Mesh evaluation: the port's visibility volumes, mesh metrics and the two
CLIs against the JAX package's, on the CPU.

Bounds: ``integrate_visibility`` over chained synthetic frames differs from
the JAX volume on at most 1e-4 of the voxels (the projection rounds in
another order, which can move a voxel across a pixel or the depth + 0.3 m
edge); ``SimpleVolume`` files pass between the packages bit for bit;
``sample_mesh_points`` and ``compute_mesh_metrics`` are equal (the same
numpy draws and scipy queries); ``evaluate_mesh`` with a visibility volume
within 1e-9 relative; the mesh-eval CLI's JSON equals the JAX functions'
numbers on the same files. The synthetic scene's analytic mesh (the GT of
the check on the card) holds every rendered depth pixel.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from doubletake_tpu.eval import mesh_eval as jme
from doubletake_tpu.eval import visibility as jvis
from doubletake_tpu.tools import marching_cubes as jm

from doubletake_tpu_torch.datasets import registry
from doubletake_tpu_torch.datasets.synthetic import SyntheticDataset
from doubletake_tpu_torch.eval import mesh_eval as pme
from doubletake_tpu_torch.eval import visibility as pvis
from doubletake_tpu_torch.options import OptionsHandler
from doubletake_tpu_torch.scripts import create_visibility_volume, mesh_eval
from doubletake_tpu_torch.tools import marching_cubes as pm
from test_mesh_tools import sphere_sdf

BOUNDS = dict(xmin=-1, xmax=1, ymin=-1, ymax=1, zmin=0, zmax=3)


@pytest.fixture(autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def synthetic_frames(n=4, h=96, w=128):
    """(depth (h, w, 1), cam_T_world, K) of n synthetic frames at depth size."""
    ds = SyntheticDataset(split="test", image_height=2 * h, image_width=2 * w, num_frames=40)
    K = ds.load_intrinsics("synth0")["K_s0_b44"]
    frames = []
    for i in range(n):
        depth, _, _ = ds.load_target_size_depth_and_mask("synth0", 9 * i)
        frames.append((depth, ds.load_pose("synth0", 9 * i)[1], K))
    return ds, frames


def test_integrate_visibility_matches_jax():
    ds, frames = synthetic_frames()
    lo, hi = ds.get_gt_mesh_bounds("synth0")
    bounds = {f"{a}{m}": float(v[i]) for i, a in enumerate("xyz")
              for m, v in (("min", lo), ("max", hi))}
    jvol = jvis.SimpleVolume.from_bounds(bounds, 0.08)
    pvol = pvis.SimpleVolume.from_bounds(bounds, 0.08)
    for depth, cTw, K in frames:
        jvol = jvis.integrate_visibility(jvol, jnp.asarray(depth), jnp.asarray(cTw),
                                         jnp.asarray(K))
        pvis.integrate_visibility(pvol, torch.from_numpy(depth), torch.from_numpy(cTw),
                                  torch.from_numpy(K))
    assert pvol.values.shape == tuple(jvol.values.shape) == (75, 50, 38)
    seen = float(pvol.values.mean())
    assert 0.2 < seen < 0.95
    assert float((pvol.values.numpy() != np.asarray(jvol.values)).mean()) <= 1e-4


def test_visibility_wall_and_nan_depth():
    """A wall at 2 m: in front visible, beyond +0.3 m not, outside the image
    not; NaN pixels mark nothing."""
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 40.0
    K[0, 2], K[1, 2] = 32, 24
    depth = np.full((48, 64, 1), 2.0, np.float32)
    depth[:, 32:] = np.nan
    vol = pvis.integrate_visibility(pvis.SimpleVolume.from_bounds(BOUNDS, 0.1),
                                    torch.from_numpy(depth), torch.eye(4), torch.from_numpy(K))
    got = vol.sample(np.array([[-0.3, 0.0, 1.0], [-0.3, 0.0, 2.6], [5.0, 5.0, 1.0],
                               [0.5, 0.0, 1.0]], np.float32), "nearest")
    assert got.tolist() == [1.0, 0.0, 0.0, 0.0]


@pytest.mark.parametrize("method", ["nearest", "bilinear"])
def test_simple_volume_npz_interchange_and_sample(tmp_path, method):
    rng = np.random.RandomState(3)
    jvol = jvis.SimpleVolume.from_bounds(BOUNDS, 0.1)
    jvol = jvol.replace(values=jnp.asarray((rng.rand(*jvol.values.shape) > 0.5)
                                           .astype(np.float32)))
    jvol.save(str(tmp_path / "jax.npz"))
    pvol = pvis.SimpleVolume.load(str(tmp_path / "jax.npz"))
    np.testing.assert_array_equal(pvol.values.numpy(), np.asarray(jvol.values))
    np.testing.assert_array_equal(pvol.origin.numpy(), np.asarray(jvol.origin))
    pvol.values[3:7] = 1.0
    pvol.save(str(tmp_path / "torch.npz"))
    back = jvis.SimpleVolume.load(str(tmp_path / "torch.npz"))
    np.testing.assert_array_equal(np.asarray(back.values), pvol.values.numpy())
    assert back.voxel_size == pvol.voxel_size == 0.1

    pts = rng.uniform(-1.2, 3.2, (5000, 3)).astype(np.float32)
    want = np.asarray(back.sample(jnp.asarray(pts), method))
    np.testing.assert_allclose(pvol.sample(pts, method).numpy(), want, rtol=0, atol=1e-6)


def test_sample_points_and_metrics_equal():
    verts, faces = jm.extract_mesh(sphere_sdf(32))
    verts = verts / 32.0
    for seed in (0, 1):
        np.testing.assert_array_equal(pme.sample_mesh_points(verts, faces, 5000, seed),
                                      jme.sample_mesh_points(verts, faces, 5000, seed))
    pred = pme.sample_mesh_points(verts + [0.02, 0.0, 0.0], faces, 5000, 0)
    gt = pme.sample_mesh_points(verts, faces, 5000, 1)
    mask = np.random.RandomState(2).rand(5000) > 0.3
    for m in (None, mask):
        assert pme.compute_mesh_metrics(pred, gt, m) == jme.compute_mesh_metrics(pred, gt, m)
    assert pme.sample_mesh_points(verts, faces[:0]).shape == (0, 3)


def test_evaluate_mesh_with_visibility_matches_jax():
    ds, frames = synthetic_frames(3)
    pvol = pvis.SimpleVolume.from_bounds(
        {"xmin": -3.0, "xmax": 3.0, "ymin": -2.0, "ymax": 2.0, "zmin": 0.0, "zmax": 3.0}, 0.08)
    for depth, cTw, K in frames:
        pvis.integrate_visibility(pvol, torch.from_numpy(depth), torch.from_numpy(cTw),
                                  torch.from_numpy(K))
    jvol = jvis.SimpleVolume(values=jnp.asarray(pvol.values.numpy()),
                             origin=jnp.asarray(pvol.origin.numpy()), voxel_size=0.08)
    gv, gf = ds.get_gt_mesh("synth0")
    pred_v = gv + np.float32(0.01) * np.sin(7.0 * gv)
    kw = dict(num_samples=20000)
    want = jme.evaluate_mesh(pred_v, gf, gv, gf, visibility_volume=jvol, **kw)
    got = pme.evaluate_mesh(pred_v, gf, gv, gf, visibility_volume=pvol, **kw)
    unmasked = pme.evaluate_mesh(pred_v, gf, gv, gf, **kw)
    assert got["recall"] != unmasked["recall"]     # the mask dropped points
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-9 * abs(v), (k, got[k], v)


def test_synthetic_gt_mesh_holds_the_rendered_depth():
    ds, frames = synthetic_frames(2, 24, 32)
    verts, faces = ds.get_gt_mesh("synth0")
    scene = ds.scene("synth0")
    assert faces.shape == (12 * (1 + len(scene.boxes)), 3)
    np.testing.assert_allclose(verts.min(0), scene.room_min, atol=1e-6)
    np.testing.assert_allclose(verts.max(0), scene.room_max, atol=1e-6)
    areas = 0.5 * np.linalg.norm(np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                                          verts[faces[:, 2]] - verts[faces[:, 0]]), axis=1)
    boxes = [(scene.room_min, scene.room_max), *scene.boxes]
    want = sum(2 * ((b - a)[0] * (b - a)[1] + (b - a)[1] * (b - a)[2] + (b - a)[0] * (b - a)[2])
               for a, b in boxes)
    np.testing.assert_allclose(areas.sum(), want, rtol=1e-5)

    # every pixel's 3-D point lies on one box's surface
    for depth, cTw, K in frames:
        h, w = depth.shape[:2]
        ys, xs = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5, indexing="ij")
        rays = np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3) @ \
            np.linalg.inv(K[:3, :3]).T
        pts = rays * depth.reshape(-1, 1)
        world = pts @ np.linalg.inv(cTw)[:3, :3].T + np.linalg.inv(cTw)[:3, 3]
        dist = np.full(len(world), np.inf)
        for a, b in boxes:
            inside = np.all((world >= a - 1e-4) & (world <= b + 1e-4), axis=1)
            to_face = np.minimum(np.abs(world - a), np.abs(world - b)).min(1)
            dist = np.minimum(dist, np.where(inside, to_face, np.inf))
        assert dist.max() < 1e-4


def test_clis_end_to_end(tmp_path, monkeypatch):
    """create_visibility_volume on a 12-frame synthetic scan, then mesh_eval
    of a fused mesh against the analytic GT: the JSON equals the JAX
    functions' numbers on the same files."""
    monkeypatch.setattr(create_visibility_volume, "dataset_from_opts",
                        lambda *a, **k: registry.dataset_from_opts(*a, num_frames=12, **k))
    argv = ["--dataset", "synthetic", "--split", "test", "--name", "vis", "--device", "cpu",
            "--output_base_path", str(tmp_path), "--image_width", "128", "--image_height", "96",
            "--model_num_views", "2", "--num_workers", "0"]
    paths = create_visibility_volume.main(argv)
    vis_path = tmp_path / "vis" / "visibility" / "synth0_visibility.npz"
    assert paths == {"synth0": str(vis_path)}
    vol = pvis.SimpleVolume.load(str(vis_path))
    assert vol.voxel_size == 0.04 and 0.05 < float(vol.values.mean()) < 0.95

    # the JAX function over the same frames
    opts = OptionsHandler(argv).parse_and_merge_options()
    ds = registry.dataset_from_opts(opts, split="test", limit_to_scan_id="synth0", num_frames=12)
    jvol = jvis.SimpleVolume.from_bounds(
        {"xmin": -3.0, "xmax": 3.0, "ymin": -2.0, "ymax": 2.0, "zmin": 0.0, "zmax": 3.0}, 0.04)
    for i in range(len(ds)):
        cur = ds[i][0]
        jvol = jvis.integrate_visibility(jvol, *(jnp.asarray(cur[k]) for k in
                                                 ("depth_bhw1", "cam_T_world_b44", "K_s0_b44")))
    assert float((vol.values.numpy() != np.asarray(jvol.values)).mean()) <= 1e-4

    gt_dir, pred_dir = tmp_path / "gt", tmp_path / "pred"
    gv, gf = ds.get_gt_mesh("synth0")
    pm.save_ply(str(gt_dir / "synth0.ply"), gv, gf)
    pred_v = gv + np.float32(0.015) * np.cos(5.0 * gv)
    pm.save_ply(str(pred_dir / "synth0.ply"), pred_v, gf)
    out = tmp_path / "metrics.json"
    payload = mesh_eval.main(["--pred_dir", str(pred_dir), "--gt_dir", str(gt_dir),
                              "--visibility_dir", str(vis_path.parent), "--output_json",
                              str(out), "--device", "cpu"])
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(payload))

    jv, jf = jm.load_ply(str(pred_dir / "synth0.ply"))
    want = jme.evaluate_mesh(jv, jf, *jm.load_ply(str(gt_dir / "synth0.ply")),
                             visibility_volume=jvis.SimpleVolume.load(str(vis_path)))
    assert payload["per_scene"]["synth0"] == want
    assert payload["summary"] == pytest.approx(want, rel=1e-12)
