"""TSDF state, integrate (the integrate kernel's plain version) and raycast:
the PyTorch port against the JAX package's dense XLA paths, on the CPU.

Integrate: the same voxel math in float32. On smooth depth the two agree to
float32 rounding; on rough random depth a voxel whose projection lands
within an ulp of a pixel boundary can pick the neighbouring pixel (rint
ties / division rounding differ between XLA and torch), so the bound there
is a mismatch fraction (<= 1e-4), as tests/test_fused_integrate.py bounds
the Pallas kernel.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from doubletake_tpu.datasets.synthetic import SyntheticDataset
from doubletake_tpu.tools import tsdf as jt

from doubletake_tpu_torch.ops.integrate import fused_integrate, integrate_plain
from doubletake_tpu_torch.tools import tsdf as tt
from doubletake_tpu_torch.utils import tracing

H, W = 48, 64
BOUNDS = dict(xmin=-0.4, xmax=0.88, ymin=-0.3, ymax=0.98, zmin=0.0, zmax=2.56)


def camera(yaw=0.3, pitch=-0.25, pos=(0.4, 0.3, 1.2)):
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    fwd = Ry @ Rx @ np.array([0.0, 0.0, 1.0])
    right = np.cross(fwd, [0.0, 0.0, -1.0])
    right /= np.linalg.norm(right)
    T = np.eye(4, dtype=np.float32)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = right, np.cross(fwd, right), fwd, pos
    return T


def intrinsics():
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 0.7 * W
    K[0, 2], K[1, 2] = W / 2, H / 2
    return K


def smooth_depth(seed=0):
    rng = np.random.RandomState(seed)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    d = 1.5 + 0.4 * np.sin(xs / 17.0 + rng.rand()) + 0.3 * np.cos(ys / 11.0 + rng.rand())
    return d.astype(np.float32)[..., None]


def fuse_both(frames, cfg, bounds=BOUNDS, voxel=0.04):
    """Fuse (depth, cam_T_world) frames with both packages; returns volumes."""
    jvol = jt.TSDF.from_bounds(bounds, voxel)
    tvol = tt.TSDF.from_bounds(bounds, voxel)
    K = intrinsics()
    for depth, cTw in frames:
        jvol = jt.integrate_depth(jvol, jnp.asarray(depth), jnp.asarray(cTw), jnp.asarray(K),
                                  jt.FusionConfig(**vars(cfg)), use_pallas=False)
        tt.integrate_depth(tvol, torch.from_numpy(depth), torch.from_numpy(cTw),
                           torch.from_numpy(K), cfg)
    return jvol, tvol


@pytest.mark.parametrize("extended", [False, True])
def test_integrate_smooth_depth(extended):
    cfg = tt.FusionConfig(min_depth=0.4, max_depth=3.0, extended_neg_truncation=extended)
    cTw = np.linalg.inv(camera()).astype(np.float32)
    jvol, tvol = fuse_both([(smooth_depth(), cTw)], cfg)
    dv = np.abs(np.asarray(jvol.values) - tvol.values.numpy())
    dw = np.abs(np.asarray(jvol.weights) - tvol.weights.numpy())
    assert dv.max() < 1e-5 and dw.max() < 1e-6, (dv.max(), dw.max())
    assert float(tvol.weights.max()) > 0.01


def test_integrate_random_depth_chained():
    cfg = tt.FusionConfig(min_depth=0.4, max_depth=3.0)
    rng = np.random.RandomState(1)
    frames = []
    for f in range(3):
        depth = rng.rand(H, W, 1).astype(np.float32) * 1.5 + 0.6
        cTw = np.linalg.inv(camera(yaw=0.3 + 0.2 * f, pos=(0.4, 0.3 + 0.1 * f, 1.2)))
        frames.append((depth, cTw.astype(np.float32)))
    jvol, tvol = fuse_both(frames, cfg)
    dv = np.abs(np.asarray(jvol.values) - tvol.values.numpy())
    assert float((dv > 1e-3).mean()) <= 1e-4
    assert np.percentile(dv, 99.9) < 1e-5


def test_integrate_nan_depth_and_mask():
    cfg = tt.FusionConfig(min_depth=0.4, max_depth=3.0)
    depth = smooth_depth()
    depth[10:20, 20:30] = np.nan
    cTw = np.linalg.inv(camera()).astype(np.float32)
    jvol, tvol = fuse_both([(depth, cTw)], cfg)
    assert torch.isfinite(tvol.values).all()
    dv = np.abs(np.asarray(jvol.values) - tvol.values.numpy())
    assert dv.max() < 1e-5

    # a depth mask routes through the same update (-1 = invalid)
    mask = np.ones((H, W, 1), bool)
    mask[:, :32] = False
    jm = jt.integrate_depth(jt.TSDF.from_bounds(BOUNDS, 0.04), jnp.asarray(smooth_depth()),
                            jnp.asarray(cTw), jnp.asarray(intrinsics()),
                            jt.FusionConfig(**vars(cfg)), depth_mask_hw1=jnp.asarray(mask),
                            use_pallas=False)
    tm = tt.integrate_depth(tt.TSDF.from_bounds(BOUNDS, 0.04), torch.from_numpy(smooth_depth()),
                            torch.from_numpy(cTw), torch.from_numpy(intrinsics()), cfg,
                            depth_mask_hw1=torch.from_numpy(mask))
    assert np.abs(np.asarray(jm.values) - tm.values.numpy()).max() < 1e-5


def test_fused_integrate_wrapper_on_cpu_is_plain_in_place():
    vol = tt.TSDF.from_bounds(BOUNDS, 0.04)
    values, weights = vol.values, vol.weights
    P = torch.from_numpy(intrinsics() @ np.linalg.inv(camera()).astype(np.float32))[:3].contiguous()
    kw = dict(voxel_size=0.04, min_depth=0.4, max_depth=3.0, truncation=0.12,
              trunc_check=-0.18, update_rate=2.5, max_weight=100.0)
    depth = torch.from_numpy(smooth_depth()[..., 0])
    pv, pw = integrate_plain(values.clone(), weights.clone(), depth, P, vol.origin, **kw)
    launches = tracing.counters().get("ops.integrate.launches", 0)
    ov, ow = fused_integrate(values, weights, depth, P, vol.origin, **kw)
    assert ov is values and ow is weights            # in place
    assert tracing.counters().get("ops.integrate.launches", 0) == launches   # the CPU launches nothing
    assert torch.equal(values, pv) and torch.equal(weights, pw)


def synthetic_volume():
    """GT depths of the synthetic room fused by the JAX package (0.04 m)."""
    ds = SyntheticDataset(split="test", image_height=96, image_width=128, num_frames=12)
    poses, scene = ds.poses("synth0"), ds.scene("synth0")
    K = np.asarray(ds.K_image, np.float32)
    vol = jt.TSDF.from_bounds(dict(xmin=-3.2, xmax=3.2, ymin=-2.2, ymax=2.2, zmin=-0.1,
                                   zmax=3.1), 0.04)
    cfg = jt.FusionConfig(min_depth=0.3, max_depth=5.0, extended_neg_truncation=True)
    fuse = jax.jit(lambda v, d, c, k: jt.integrate_depth(v, d, c, k, cfg, use_pallas=False))
    for i in range(0, 10, 2):
        _, depth = scene.render(poses[i], K, 96, 128)
        vol = fuse(vol, jnp.asarray(depth)[..., None],
                   jnp.asarray(np.linalg.inv(poses[i]), jnp.float32), jnp.asarray(K))
    return vol, poses[7], K


def test_raycast_matches_jax():
    jvol, wTc, K = synthetic_volume()
    tvol = tt.TSDF(values=torch.from_numpy(np.array(jvol.values)),
                   weights=torch.from_numpy(np.array(jvol.weights)),
                   origin=torch.from_numpy(np.array(jvol.origin)), voxel_size=jvol.voxel_size)
    invK = np.linalg.inv(K).astype(np.float32)
    kw = dict(min_depth=0.3, max_depth=5.0, num_samples=128)
    jd, jw, jv = jt.raycast(jvol, jnp.asarray(wTc), jnp.asarray(invK), 96, 128, **kw)
    td, tw, tv = tt.raycast(tvol, torch.from_numpy(wTc), torch.from_numpy(invK), 96, 128, **kw)
    jd, jw, jv = np.asarray(jd), np.asarray(jw), np.asarray(jv)
    td, tw, tv = td.numpy(), tw.numpy(), tv.numpy()
    assert jv.mean() > 0.5
    # a crossing right at an observedness or sign boundary may flip on an ulp
    assert float((jv != tv).mean()) <= 1e-3
    both = jv & tv
    assert np.abs(jd[both] - td[both]).max() < 1e-4          # metres
    assert np.abs(jw[both] - tw[both]).max() < 1e-4
    assert np.isnan(td[~tv]).all() and (tw[~tv] == 0).all()


def test_auto_raycast_samples():
    for args in [(0.02, 0.5, 3.5, True), (0.04, 0.5, 3.0, False)]:
        assert tt.auto_raycast_samples(*args) == jt.auto_raycast_samples(*args)


def test_tsdf_npz_interchange(tmp_path):
    """A volume each package writes loads in the other, bit for bit."""
    rng = np.random.RandomState(5)
    jvol = jt.TSDF.from_bounds(BOUNDS, 0.04)
    jvol = jvol.replace(values=jnp.asarray(rng.uniform(-1, 1, jvol.dims).astype(np.float32)),
                        weights=jnp.asarray(rng.rand(*jvol.dims).astype(np.float32)))
    jvol.save(str(tmp_path / "jax.npz"))
    tvol = tt.TSDF.load(str(tmp_path / "jax.npz"))
    np.testing.assert_array_equal(tvol.values.numpy(),
                                  np.asarray(jvol.values).astype(np.float16).astype(np.float32))
    assert tvol.voxel_size == jvol.voxel_size
    np.testing.assert_array_equal(tvol.origin.numpy(), np.asarray(jvol.origin))

    tvol.weights.mul_(0.75)   # float16 rounding of the file applies again
    tvol.save(str(tmp_path / "torch.npz"))
    back = jt.TSDF.load(str(tmp_path / "torch.npz"))
    np.testing.assert_array_equal(np.asarray(back.weights),
                                  tvol.weights.numpy().astype(np.float16).astype(np.float32))
    np.testing.assert_array_equal(np.asarray(back.values), tvol.values.numpy())
    assert back.dims == tvol.dims and back.voxel_size == tvol.voxel_size


def test_integrate_camera_on_a_voxel_centre():
    """A voxel at the camera centre projects to 0/0: it is not sampled, and
    nothing fails on the NaN (the plain version indexes pixel 0 for it)."""
    cfg = tt.FusionConfig(min_depth=0.05, max_depth=3.0)
    tvol = tt.TSDF.from_bounds(BOUNDS, 0.04)
    centre = (tvol.origin + torch.tensor([10.0, 10.0, 30.0]) * tvol.voxel_size).numpy()
    cTw = np.eye(4, dtype=np.float32)
    cTw[:3, 3] = -centre
    K = np.eye(4, dtype=np.float32)         # P = [I | -centre]: exactly 0 / 0 there
    depth = np.full((H, W, 1), 0.5, np.float32)
    tt.integrate_depth(tvol, torch.from_numpy(depth), torch.from_numpy(cTw),
                       torch.from_numpy(K), cfg)
    jvol = jt.integrate_depth(jt.TSDF.from_bounds(BOUNDS, 0.04), jnp.asarray(depth),
                              jnp.asarray(cTw), jnp.asarray(K), jt.FusionConfig(**vars(cfg)),
                              use_pallas=False)
    assert torch.isfinite(tvol.values).all() and float(tvol.weights[10, 10, 30]) == 0.0
    assert float(tvol.weights.max()) > 0
    np.testing.assert_allclose(tvol.values.numpy(), np.asarray(jvol.values), atol=1e-5)
    np.testing.assert_allclose(tvol.weights.numpy(), np.asarray(jvol.weights), atol=1e-6)


# ------------------------------------------------------------ the mip march


@pytest.fixture(scope="module")
def room():
    """The synthetic room fused by the JAX package (``synthetic_volume``),
    the same volume on the port's side, a pose and the inverse intrinsics."""
    jvol, wTc, K = synthetic_volume()
    tvol = tt.TSDF(values=torch.from_numpy(np.array(jvol.values)),
                   weights=torch.from_numpy(np.array(jvol.weights)),
                   origin=torch.from_numpy(np.array(jvol.origin)), voxel_size=jvol.voxel_size)
    return jvol, tvol, wTc, np.linalg.inv(K).astype(np.float32)


def test_mip_flags_match_jax(room):
    """The port's float32 mip flags (cell <= 0) are the JAX package's bf16
    packed table's, cell for cell."""
    jvol, tvol, _, _ = room
    table, zm = jt._build_mip_table(jvol)
    mip = tt.build_mip(tvol)
    xm, ym = tvol.dims[0] // 4, tvol.dims[1] // 4
    assert tuple(mip.shape) == (xm, ym, zm)
    jflags = np.asarray(table.astype(jnp.float32)).reshape(xm, ym, 128)[..., :zm] <= 0
    assert jflags.any() and not jflags.all()
    np.testing.assert_array_equal(mip.numpy() <= 0, jflags)


def test_raycast_mip_matches_jax(room):
    """``use_mip=True`` against the JAX package's mip march, at the dense
    raycast's tolerances (``test_raycast_matches_jax``)."""
    jvol, tvol, wTc, invK = room
    kw = dict(min_depth=0.3, max_depth=5.0, num_samples=128)
    jd, jw, jv = jt.raycast(jvol, jnp.asarray(wTc), jnp.asarray(invK), 96, 128, use_mip=True,
                            **kw)
    td, tw, tv = tt.raycast(tvol, torch.from_numpy(wTc), torch.from_numpy(invK), 96, 128,
                            use_mip=True, **kw)
    jd, jw, jv = np.asarray(jd), np.asarray(jw), np.asarray(jv)
    td, tw, tv = td.numpy(), tw.numpy(), tv.numpy()
    assert jv.mean() > 0.5
    assert float((jv != tv).mean()) <= 1e-3
    both = jv & tv
    assert np.abs(jd[both] - td[both]).max() < 1e-4
    assert np.abs(jw[both] - tw[both]).max() < 1e-4
    assert np.isnan(td[~tv]).all() and (tw[~tv] == 0).all()


def test_raycast_mip_matches_dense():
    """The mip march against the port's own dense march on the JAX
    package's scene (tests/test_tsdf.py:148-176: two fused walls at 0.08 m),
    seen from two poses in one batch: equal depths where both find a
    surface (each window re-runs the dense crossing rule on the same
    samples), and a validity sliver under 5%. (On a cluttered scene a ray
    whose surface run is not among its three candidates can find a later
    surface: the JAX march does the same, ``test_raycast_mip_matches_jax``.)"""
    cfg = tt.FusionConfig(min_depth=0.5, max_depth=3.5)
    vol = tt.TSDF.from_bounds(dict(xmin=-1.0, xmax=1.0, ymin=-1.0, ymax=1.0, zmin=0.0,
                                   zmax=3.0), 0.08)
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 40.0
    K[0, 2], K[1, 2] = 32.0, 24.0
    cam2 = np.eye(4, dtype=np.float32)
    cam2[0, 3] = 0.15
    for z, cTw in ((2.0, np.eye(4, dtype=np.float32)), (1.8, cam2)):
        tt.integrate_depth(vol, torch.full((48, 64, 1), z), torch.from_numpy(cTw),
                           torch.from_numpy(K), cfg)
    view2 = np.eye(4, dtype=np.float32)
    view2[:3, 3] = (-0.1, 0.05, 0.1)
    poses = torch.from_numpy(np.stack([np.eye(4, dtype=np.float32), view2]))
    invKs = torch.from_numpy(np.stack([np.linalg.inv(K)] * 2).astype(np.float32))
    kw = dict(min_depth=0.5, max_depth=3.0, num_samples=200)
    d0, w0, v0 = tt.raycast(vol, poses, invKs, 48, 64, **kw)
    d1, w1, v1 = tt.raycast(vol, poses, invKs, 48, 64, use_mip=True, **kw)
    both = v0 & v1
    assert float(both.float().mean()) > 0.5
    assert torch.equal(d0[both], d1[both]) and torch.equal(w0[both], w1[both])
    assert float((v0 != v1).float().mean()) < 0.05


def test_raycast_mip_empty_volume_all_invalid():
    tvol = tt.TSDF.from_bounds(BOUNDS, 0.04)
    depth, weights, valid = tt.raycast(tvol, torch.eye(4), torch.from_numpy(
        np.linalg.inv(intrinsics())), 16, 24, min_depth=0.5, max_depth=3.0, num_samples=64,
        use_mip=True)
    assert not valid.any() and torch.isnan(depth).all() and (weights == 0).all()
