"""The fusion extras and the visualisation helpers of the port against the
JAX package's, on the CPU: the rest of ``tools/tsdf.py`` (mesh bounds,
voxel coordinates, the frustum-chunk fractions, ``cull``,
``integrate_batch``, ``sample_tsdf``), ``PartialFuser``, the hint-render
CLI, the TSDF view renderer with its trajectory helpers and CLI, and
``utils/visualization``.

Bounds: integrate as tests/test_torch_tsdf.py (smooth depth: values 1e-5,
weights 1e-6; rough depth: at most 1e-4 of the voxels off by more than
1e-3, since a voxel that projects within an ulp of a pixel boundary can
take the neighbouring pixel); raycast as test_raycast_matches_jax (validity
differs on at most 1e-3 of the pixels, depth and weight 1e-4 where both are
valid); trilinear sampling 1e-6; the culled integrate against JAX's culled
pass at tests/test_tsdf.py::test_culled_integrate_matches_dense's bounds
(values 1e-5, weights 1e-6, the same updated set).
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from doubletake_tpu.datasets import registry as jregistry
from doubletake_tpu.datasets.synthetic import SyntheticDataset
from doubletake_tpu.tools import partial_fuser as jpf
from doubletake_tpu.tools import tsdf as jt
from doubletake_tpu.tools import viz_renderer as jviz
from doubletake_tpu.utils import visualization as jvis

from doubletake_tpu_torch.datasets import registry
from doubletake_tpu_torch.scripts import render_hints, render_trajectory
from doubletake_tpu_torch.tools import partial_fuser as tpf
from doubletake_tpu_torch.tools import tsdf as tt
from doubletake_tpu_torch.tools import viz_renderer as tviz
from doubletake_tpu_torch.utils import visualization as tvis

from test_torch_tsdf import BOUNDS, H, W, camera, intrinsics, smooth_depth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


def poses(n=4):
    """cam_T_world of n cameras swinging across the BOUNDS volume."""
    return [np.linalg.inv(camera(yaw=0.3 - 0.15 * i, pitch=-0.25 + 0.05 * i,
                                 pos=(0.4 + 0.05 * i, 0.3, 1.2))).astype(np.float32)
            for i in range(n)]


def close_volumes(jvol, tvol):
    np.testing.assert_allclose(tvol.values.numpy(), np.asarray(jvol.values), atol=1e-5)
    np.testing.assert_allclose(tvol.weights.numpy(), np.asarray(jvol.weights), atol=1e-6)


# ------------------------------------------------------------------ tsdf


def test_mesh_bounds_and_voxel_coords():
    """``from_mesh_bounds`` and ``voxel_world_coords``: equal."""
    lo, hi = np.array([-0.31, 0.02, 0.4]), np.array([0.77, 1.13, 2.21])
    jvol = jt.TSDF.from_mesh_bounds(lo, hi, 0.04)
    tvol = tt.TSDF.from_mesh_bounds(lo, hi, 0.04)
    assert tvol.dims == tuple(jvol.dims)
    np.testing.assert_array_equal(tvol.origin.numpy(), np.asarray(jvol.origin))
    np.testing.assert_array_equal(tt.voxel_world_coords(tvol).numpy(),
                                  np.asarray(jt.voxel_world_coords(jvol)))


def test_frustum_chunk_fractions():
    """The chunk mask, ``frustum_chunk_fraction`` of each pose and
    ``choose_cull_fraction`` of the trajectory: equal."""
    cfg = tt.FusionConfig(min_depth=0.4, max_depth=3.0)
    jvol, tvol = jt.TSDF.from_bounds(BOUNDS, 0.04), tt.TSDF.from_bounds(BOUNDS, 0.04)
    K = intrinsics()
    fracs = []
    for cTw in poses() + [np.linalg.inv(camera(yaw=2.5)).astype(np.float32)]:
        jf = float(jt.frustum_chunk_fraction(jvol, jnp.asarray(cTw), jnp.asarray(K),
                                             jt.FusionConfig(**vars(cfg)), H, W))
        fracs.append(tt.frustum_chunk_fraction(tvol, t(cTw), t(K), cfg, H, W))
        assert fracs[-1] == jf
        P = torch.matmul(t(K), t(cTw))[:3]
        jP = jnp.matmul(jnp.asarray(K), jnp.asarray(cTw))[:3]
        cz = tt._pick_cz(tvol.dims[2])
        assert cz == jt._pick_cz(jvol.dims[2])
        np.testing.assert_array_equal(
            tt._frustum_chunk_mask(tvol, P, H, W, cfg.max_depth, cz).numpy(),
            np.asarray(jt._frustum_chunk_mask(jvol, jP, H, W, cfg.max_depth, cz)))
    assert 0 < min(fracs) < max(fracs) < 1
    stack = np.stack(poses())
    assert tt.choose_cull_fraction(tvol, t(stack), t(K), cfg, H, W) == \
        jt.choose_cull_fraction(jvol, stack, jnp.asarray(K), jt.FusionConfig(**vars(cfg)), H, W)


def test_cull_is_the_same_update():
    """``cull=True`` is bit-equal to ``cull=False`` (both take the plain
    version here, K2 on the card), and holds JAX's culled pass to its
    dense pass's bounds on the same camera and wall as tests/test_tsdf.py;
    a coloured volume takes the dense coloured pass whatever ``cull``
    says."""
    bounds = dict(xmin=-2.0, xmax=2.0, ymin=-2.0, ymax=2.0, zmin=-0.5, zmax=3.5)
    cfg = tt.FusionConfig(min_depth=0.5, max_depth=3.5, extended_neg_truncation=True)
    th = 0.4
    cTw = np.eye(4, dtype=np.float32)
    cTw[:3, :3] = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                            [-np.sin(th), 0, np.cos(th)]], np.float32)
    cTw[:3, 3] = [0.3, -0.2, 0.4]
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 40.0
    K[0, 2], K[1, 2] = W / 2, H / 2
    depth = np.full((H, W, 1), 1.8, np.float32)
    img = np.random.RandomState(0).rand(H, W, 3).astype(np.float32)
    for with_color in (False, True):
        kw = dict(image_hw3=t(img)) if with_color else {}
        vols = {}
        for cull in (False, True):
            vol = tt.TSDF.from_bounds(bounds, 0.05, with_color=with_color)
            vols[cull] = tt.integrate_depth(vol, t(depth), t(cTw), t(K), cfg, cull=cull,
                                            cull_max_fraction=0.5, **kw)
        assert torch.equal(vols[True].values, vols[False].values)
        assert torch.equal(vols[True].weights, vols[False].weights)
        if with_color:
            assert torch.equal(vols[True].colors, vols[False].colors)
        jvol = jt.TSDF.from_bounds(bounds, 0.05, with_color=with_color)
        jkw = dict(image_hw3=jnp.asarray(img)) if with_color else {}
        jcull = jt.integrate_depth(jvol, jnp.asarray(depth), jnp.asarray(cTw), jnp.asarray(K),
                                   jt.FusionConfig(**vars(cfg)), cull=True,
                                   cull_max_fraction=0.5, **jkw)
        np.testing.assert_array_equal(vols[True].weights.numpy() > 0,
                                      np.asarray(jcull.weights) > 0)
        close_volumes(jcull, vols[True])
        assert float(vols[True].weights.max()) > 0
    with pytest.raises(ValueError, match="cull_max_fraction"):
        tt.integrate_depth(tt.TSDF.from_bounds(bounds, 0.05), t(depth), t(cTw), t(K), cfg,
                           cull=True, cull_max_fraction=0.0)


def test_integrate_batch_matches_scan():
    """``integrate_batch`` of 4 frames (with a mask on one) against JAX's
    ``lax.scan``, and bit-equal to a loop of ``integrate_depth``."""
    cfg = tt.FusionConfig(min_depth=0.4, max_depth=3.0)
    depths = np.stack([smooth_depth(i) for i in range(4)])
    masks = np.ones_like(depths, bool)
    masks[1, :10] = False
    cTws = np.stack(poses())
    Ks = np.stack([intrinsics()] * 4)
    jvol = jt.integrate_batch(jt.TSDF.from_bounds(BOUNDS, 0.04), jnp.asarray(depths),
                              jnp.asarray(cTws), jnp.asarray(Ks), jt.FusionConfig(**vars(cfg)),
                              jnp.asarray(masks))
    tvol = tt.integrate_batch(tt.TSDF.from_bounds(BOUNDS, 0.04), t(depths), t(cTws), t(Ks),
                              cfg, torch.from_numpy(masks))
    close_volumes(jvol, tvol)
    loop = tt.TSDF.from_bounds(BOUNDS, 0.04)
    for i in range(4):
        tt.integrate_depth(loop, t(depths[i]), t(cTws[i]), t(Ks[i]), cfg,
                           torch.from_numpy(masks[i]))
    assert torch.equal(loop.values, tvol.values) and torch.equal(loop.weights, tvol.weights)


@pytest.mark.parametrize("method", ["bilinear", "nearest"])
def test_sample_tsdf_matches_jax(method):
    """Values, weights and colours at world points inside, on the edge of and
    outside a coloured volume fused from 2 frames: 1e-6."""
    cfg = tt.FusionConfig(min_depth=0.4, max_depth=3.0)
    rng = np.random.RandomState(2)
    frames = [(smooth_depth(i), cTw) for i, cTw in enumerate(poses(2))]
    imgs = [rng.rand(H, W, 3).astype(np.float32) for _ in frames]
    jvol = jt.TSDF.from_bounds(BOUNDS, 0.04, with_color=True)
    tvol = tt.TSDF.from_bounds(BOUNDS, 0.04, with_color=True)
    for (depth, cTw), img in zip(frames, imgs):
        jvol = jt.integrate_depth(jvol, jnp.asarray(depth), jnp.asarray(cTw),
                                  jnp.asarray(intrinsics()), jt.FusionConfig(**vars(cfg)),
                                  image_hw3=jnp.asarray(img))
        tt.integrate_depth(tvol, t(depth), t(cTw), t(intrinsics()), cfg, image_hw3=t(img))
    lo = np.array([BOUNDS["xmin"], BOUNDS["ymin"], BOUNDS["zmin"]])
    hi = np.array([BOUNDS["xmax"], BOUNDS["ymax"], BOUNDS["zmax"]])
    pts = (lo - 0.1 + rng.rand(4000, 3) * (hi - lo + 0.2)).astype(np.float32)
    for what in ("tsdf", "weights", "colors"):
        ref = np.asarray(jt.sample_tsdf(jvol, jnp.asarray(pts), what=what, method=method))
        out = tt.sample_tsdf(tvol, t(pts), what=what, method=method).numpy()
        assert out.shape == ref.shape
        assert np.abs(out - ref).max() <= 1e-6, what
        assert np.abs(ref).max() > 0


# --------------------------------------------------------- partial fuser


@pytest.mark.parametrize("noise", [0.0, 0.05])
def test_partial_fuser_matches_jax(noise, monkeypatch):
    """Four frames fused by both packages' ``PartialFuser`` (seed 3): the
    depths each hands its integrate are bit-equal (the same RandomState
    draws), the volumes agree (smooth depth without noise at the tight
    bounds, noised depth at the rough-depth bounds), and so do the hints
    rendered before and after."""
    cfg = tt.FusionConfig(min_depth=0.4, max_depth=3.0)
    jfuser = jpf.PartialFuser(jt.TSDF.from_bounds(BOUNDS, 0.04),
                              jt.FusionConfig(**vars(cfg)), depth_noise=noise, seed=3)
    tfuser = tpf.PartialFuser(tt.TSDF.from_bounds(BOUNDS, 0.04), cfg, depth_noise=noise,
                              seed=3)
    jdepths, tdepths = [], []
    jfuse = jfuser._fuse
    jfuser._fuse = lambda vol, d, c, k: (jdepths.append(np.asarray(d)), jfuse(vol, d, c, k))[1]
    integrate = tpf.integrate_depth
    monkeypatch.setattr(tpf, "integrate_depth",
                        lambda vol, d, *a: (tdepths.append(d.numpy().copy()),
                                            integrate(vol, d, *a))[1])
    invK = np.linalg.inv(intrinsics())
    for i, cTw in enumerate(poses()):
        if i == 2:
            wTc = np.linalg.inv(cTw)
            jd, jw, jv = (np.asarray(x) for x in jfuser.render_hint(wTc, invK, H, W))
            td, tw, tv = (x.numpy() for x in tfuser.render_hint(wTc, invK, H, W))
            assert jv.mean() > 0.05 and float((jv != tv).mean()) <= 1e-3
            both = jv & tv
            assert np.abs(jd[both] - td[both]).max() < 1e-4
            assert np.abs(jw[both] - tw[both]).max() < 1e-4
        jfuser.fuse_frame(smooth_depth(i), cTw, intrinsics())
        tfuser.fuse_frame(smooth_depth(i), cTw, intrinsics())
    assert len(jdepths) == len(tdepths) == 4
    for a, b in zip(jdepths, tdepths):
        np.testing.assert_array_equal(a, b)
    assert (noise > 0) == any(not np.array_equal(d, smooth_depth(i))
                              for i, d in enumerate(tdepths))
    dv = np.abs(tfuser.tsdf.values.numpy() - np.asarray(jfuser.tsdf.values))
    if noise:
        assert float((dv > 1e-3).mean()) <= 1e-4 and np.percentile(dv, 99.9) < 1e-5
    else:
        close_volumes(jfuser.tsdf, tfuser.tsdf)


def load_script(name):
    """The JAX package's CLI ``scripts/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def short_synthetic(module, monkeypatch, reg):
    monkeypatch.setattr(module, "dataset_from_opts",
                        lambda *a, **k: reg.dataset_from_opts(*a, num_frames=12, **k))


def test_render_hints_matches_jax_script(tmp_path, monkeypatch):
    """The port's render-hints CLI against the JAX script on the 12-frame
    synthetic scan, from one cache of its GT depths (the no-hint runner's
    npz format) with --depth_noise 0.05, both scripts rendering at 48x64
    (their constant is 192x256; the JAX raycast is slow on the CPU): the
    same files in both variants.
    Per file, the PNGs are byte-equal or decode to 16-bit values within one
    step wherever both are non-zero, with at most 1e-3 of the pixels zero in
    one and not the other (the raycast's bounds); the partial renders are
    not the full ones; and the port's depth PNGs decode, as the hint loader
    reads them, to within 1/2048 m of a raycast of the complete volume."""
    ds = SyntheticDataset(split="test", image_height=384, image_width=512, num_frames=12)
    ids = [line.split(" ")[1] for line in ds.frame_tuples]
    depths = []
    for i in range(len(ids)):
        cur, _ = ds[i]
        depths.append(cur["depth_bhw1"])
    cache = tmp_path / "cache"
    cache.mkdir()
    np.savez_compressed(cache / "synth0_depths.npz", depths=np.stack(depths).astype(np.float32),
                        frame_ids=np.asarray(ids))
    args = ["--dataset", "synthetic", "--single_debug_scan_id", "synth0",
            "--depth_cache_dir", str(cache), "--depth_noise", "0.05"]

    jscript = load_script("render_hints")
    short_synthetic(jscript, monkeypatch, jregistry)
    # renders at 48x64 (the JAX raycast takes ~7 s a 192x256 render here)
    for module in (jscript, render_hints):
        monkeypatch.setattr(module, "RENDER_H", 48)
        monkeypatch.setattr(module, "RENDER_W", 64)
    monkeypatch.setattr(sys, "argv", ["render_hints"] + args
                        + ["--render_output_dir", str(tmp_path / "jax")])
    jscript.main()
    short_synthetic(render_hints, monkeypatch, registry)
    out = render_hints.main(args + ["--render_output_dir", str(tmp_path / "port"),
                                    "--device", "cpu"])
    assert sorted(out["synth0"]) == ["partial_renders", "renders"]

    from PIL import Image

    for variant in ("renders", "partial_renders"):
        names = sorted(os.listdir(tmp_path / "jax" / "synth0" / variant))
        assert names == sorted(os.listdir(tmp_path / "port" / "synth0" / variant))
        assert len(names) == 2 * len(ids)
        for name in names:
            a, b = (tmp_path / side / "synth0" / variant / name for side in ("jax", "port"))
            if a.read_bytes() == b.read_bytes():
                continue
            ja = np.asarray(Image.open(a)).astype(np.int64)
            pb = np.asarray(Image.open(b)).astype(np.int64)
            both = (ja > 0) & (pb > 0)
            assert np.abs(ja - pb)[both].max() <= 1, (variant, name)
            assert float(((ja > 0) != (pb > 0)).mean()) <= 1e-3, (variant, name)
    full = np.asarray(Image.open(tmp_path / "port/synth0/renders" / f"depth_{int(ids[0]):06d}.png"))
    part = np.asarray(Image.open(tmp_path / "port/synth0/partial_renders"
                                 / f"depth_{int(ids[0]):06d}.png"))
    assert (full > 0).mean() > 0.3 and not (part > 0).any()   # nothing fused before frame 0

    # the hint loader's decoding against the complete volume's raycast
    tds = registry.dataset_from_opts(render_hints.OptionsHandler(
        ["--dataset", "synthetic", "--device", "cpu"]).parse_and_merge_options(),
        split="test", limit_to_scan_id="synth0", num_frames=12)
    fuser = tpf.PartialFuser(tt.TSDF.from_bounds(
        render_hints.scene_bounds_for_fusion(tds, "synth0"), 0.04))
    for i, fid in enumerate(ids):
        fuser.fuse_frame(depths[i], tds.load_pose("synth0", fid)[1],
                         tds.load_intrinsics("synth0", fid)["K_s0_b44"])
    K = render_hints.scaled_K(tds.load_intrinsics("synth0", ids[-1])["K_s0_b44"], tds)
    fid = ids[2]
    depth, _, valid = fuser.render_hint(tds.load_pose("synth0", fid)[0], np.linalg.inv(K),
                                        render_hints.RENDER_H, render_hints.RENDER_W)
    png = np.asarray(Image.open(tmp_path / "port/synth0/renders" / f"depth_{int(fid):06d}.png"))
    decoded = png.astype(np.float32) / 2048.0
    v = valid.numpy() & (png > 0)
    assert v.mean() > 0.3
    assert np.abs(decoded[v] - depth.numpy()[v]).max() <= 1.0 / 2048.0


# ------------------------------------------------------------- rendering


@pytest.fixture(scope="module")
def colour_room():
    """Both packages' coloured volumes over BOUNDS from 3 frames of smooth
    depth with random colours."""
    cfg = tt.FusionConfig(min_depth=0.4, max_depth=3.0)
    rng = np.random.RandomState(5)
    jvol = jt.TSDF.from_bounds(BOUNDS, 0.04, with_color=True)
    tvol = tt.TSDF.from_bounds(BOUNDS, 0.04, with_color=True)
    for i, cTw in enumerate(poses(3)):
        img = rng.rand(H, W, 3).astype(np.float32)
        jvol = jt.integrate_depth(jvol, jnp.asarray(smooth_depth(i)), jnp.asarray(cTw),
                                  jnp.asarray(intrinsics()), jt.FusionConfig(**vars(cfg)),
                                  image_hw3=jnp.asarray(img))
        tt.integrate_depth(tvol, t(smooth_depth(i)), t(cTw), t(intrinsics()), cfg,
                           image_hw3=t(img))
    return jvol, tvol


@pytest.mark.parametrize("color", [True, False])
def test_render_tsdf_view_matches_jax(colour_room, color):
    """A view from a pose between the fused ones, with and without colours
    and a fixed light: depth within 1e-4 m and rgb within 1e-3 where both
    found a surface (a depth 1e-4 m off moves the normals' central
    differences by about that much), validity as the raycast's; the
    returned arrays are writable."""
    jvol, tvol = colour_room
    if not color:
        jvol, tvol = jvol.replace(colors=None), tt.TSDF(tvol.values, tvol.weights, tvol.origin,
                                                        tvol.voxel_size)
    wTc = camera(yaw=0.2, pitch=-0.2, pos=(0.42, 0.3, 1.25))
    invK = np.linalg.inv(intrinsics())
    for light in (None, (0.3, -1.0, 0.5)):
        jrgb, jd = jviz.render_tsdf_view(jvol, wTc, invK, H, W, light_dir=light)
        trgb, td = tviz.render_tsdf_view(tvol, wTc, invK, H, W, light_dir=light)
        assert trgb.flags.writeable and td.flags.writeable
        jv, tv = np.isfinite(jd), np.isfinite(td)
        assert jv.mean() > 0.05 and float((jv != tv).mean()) <= 1e-3
        both = jv & tv
        assert np.abs(jd[both] - td[both]).max() < 1e-4
        assert np.abs(jrgb[both] - trgb[both]).max() < 1e-3
        np.testing.assert_array_equal(trgb[~tv], 1.0)


def test_trajectory_helpers_match_jax(colour_room):
    """``observed_voxel_points``, ``SmoothBirdsEyeCamera`` over a trajectory,
    the look-at pose and ``draw_camera_marker`` (in front, and behind the
    view): equal."""
    jvol, tvol = colour_room
    jpts, tpts = jviz.observed_voxel_points(jvol), tviz.observed_voxel_points(tvol)
    np.testing.assert_array_equal(jpts, tpts)
    assert len(tpts) > 100
    np.testing.assert_array_equal(jviz.observed_voxel_points(jvol, max_points=50),
                                  tviz.observed_voxel_points(tvol, max_points=50))
    jcam, tcam = jviz.SmoothBirdsEyeCamera(), tviz.SmoothBirdsEyeCamera()
    for cTw in poses():
        wTc = np.linalg.inv(cTw)
        np.testing.assert_array_equal(jcam.get_bird_eye_trans(jpts, fpv_pose=wTc),
                                      tcam.get_bird_eye_trans(tpts, fpv_pose=wTc))
    np.testing.assert_array_equal(tviz.get_cam_pose_from_lookat_and_loc([1, 2, 3], [0, 0, 1]),
                                  jviz.get_cam_pose_from_lookat_and_loc([1, 2, 3], [0, 0, 1]))
    img = np.random.RandomState(1).rand(H, W, 3).astype(np.float32)
    for z in (1.5, -1.0):
        marker = np.eye(4)
        marker[2, 3] = z
        a = jviz.draw_camera_marker(img.copy(), marker, np.eye(4), intrinsics(), scale=0.2)
        b = tviz.draw_camera_marker(img.copy(), marker, np.eye(4), intrinsics(), scale=0.2)
        np.testing.assert_array_equal(a, b)
        assert (b != img).any() == (z > 0)


def test_render_trajectory_cli(colour_room, tmp_path, monkeypatch):
    """The trajectory CLI on a saved coloured volume over the first 3 frames
    of the 12-frame synthetic scan at 48x64: without ffmpeg a PNG sequence
    whose frames are what the JAX renderer gives from the same birdseye
    poses, marker drawn on a copy: the marker's pixels equal, the others
    within 1 of 255 but for at most 1e-3 of them (where one raycast found a
    surface and the other did not); the volume passes through its float16
    npz on both sides."""
    jvol, tvol = colour_room
    path = str(tmp_path / "synth0_tsdf.npz")
    tvol.save(path)
    monkeypatch.setattr(tvis, "write_video", lambda *a, **k: None)    # no ffmpeg
    short_synthetic(render_trajectory, monkeypatch, registry)
    out = render_trajectory.main(["--dataset", "synthetic", "--single_debug_scan_id", "synth0",
                                  "--tsdf_path", path, "--output", str(tmp_path / "v.mp4"),
                                  "--viz_height", str(H), "--viz_width", str(W),
                                  "--max_frames", "3", "--device", "cpu"])
    assert out == {"path": str(tmp_path / "v.mp4") + "_frames", "frames": 3}
    assert sorted(os.listdir(out["path"])) == [f"{i:06d}.png" for i in range(3)]

    from PIL import Image

    ds = jregistry.dataset_from_opts(render_hints.OptionsHandler(
        ["--dataset", "synthetic"]).parse_and_merge_options(), split="test",
        limit_to_scan_id="synth0", num_frames=12)
    loaded = jt.TSDF.load(path)
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 0.9 * W
    K[0, 2], K[1, 2] = W / 2, H / 2
    cam = jviz.SmoothBirdsEyeCamera()
    pts = jviz.observed_voxel_points(loaded)
    marked = 0
    for i, line in enumerate(ds.frame_tuples[:3]):
        wTc, _ = ds.load_pose("synth0", line.split(" ")[1])
        be = cam.get_bird_eye_trans(pts, fpv_pose=wTc)
        rgb, _ = jviz.render_tsdf_view(loaded, be, np.linalg.inv(K), H, W)
        rgb = np.clip(rgb, 0, 1)
        want = np.clip(jviz.draw_camera_marker(rgb.copy(), wTc, np.linalg.inv(be), K), 0, 1)
        got = np.asarray(Image.open(os.path.join(out["path"], f"{i:06d}.png"))).astype(int)
        ref = (want * 255.0).astype(np.uint8).astype(int)
        drawn = (want != rgb).any(-1)
        marked += drawn.sum()
        np.testing.assert_array_equal(got[drawn], ref[drawn])
        off = (np.abs(got - ref).max(-1) > 1) & ~drawn
        assert float(off.mean()) <= 1e-3, i                # the raycast's validity bound
    assert marked > 0


# --------------------------------------------------------- visualisation


def test_visualisation_helpers_match_jax(tmp_path, monkeypatch):
    """``colormap_image`` (turbo, from the port's table with matplotlib
    unimportable) gives the JAX package's (matplotlib's) colours, at the
    ends of the range too; ``tile_images`` and ``quick_viz_export`` (free
    and fixed depth range, panels of other sizes resized) give the JAX
    package's arrays and PNG bytes; another colormap raises; ``save_video``
    without ffmpeg leaves the PNG sequence, and with an encoder hands it the
    frames once and removes them after it succeeds."""
    rng = np.random.RandomState(0)
    depth = (rng.rand(40, 60) * 4).astype(np.float32)
    depth[::7, ::5] = np.nan
    depth[0, :20] = np.linspace(0.0, 6.0, 20)
    refs = [jvis.colormap_image(depth, **kw) for kw in ({}, dict(vmin=0.0, vmax=5.0),
                                                        dict(vmin=1.0, vmax=1.0))]
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "matplotlib", None)
        for ref, kw in zip(refs, ({}, dict(vmin=0.0, vmax=5.0), dict(vmin=1.0, vmax=1.0))):
            np.testing.assert_array_equal(tvis.colormap_image(depth, **kw), ref)
    with pytest.raises(ValueError, match="viridis"):
        tvis.colormap_image(depth, colormap="viridis")
    ims = [rng.rand(6, 8, 3).astype(np.float32) for _ in range(5)]
    np.testing.assert_array_equal(tvis.tile_images(ims, cols=2), jvis.tile_images(ims, cols=2))
    np.testing.assert_array_equal(tvis.tile_images(ims, cols=3), jvis.tile_images(ims, cols=3))
    image = rng.randn(16, 24, 3).astype(np.float32)
    gt = (rng.rand(8, 12, 1) * 3 + 0.5).astype(np.float32)
    gt[0, :3] = np.nan
    pred = (gt + 0.1 * rng.randn(*gt.shape)).astype(np.float32)
    hint = np.where(rng.rand(4, 6, 1) < 0.5, np.nan, 1.5).astype(np.float32)
    for fixed in (False, True):
        kw = dict(image_bhw3=image, depth_pred=pred, depth_gt=gt, hint_depth=hint,
                  fixed_min_max=fixed)
        jvis.quick_viz_export(str(tmp_path / "jax"), "f", **kw)
        tvis.quick_viz_export(str(tmp_path / "port"), "f", **kw)
        jpng, ppng = (tmp_path / side / "f.png" for side in ("jax", "port"))
        assert jpng.read_bytes() == ppng.read_bytes()
    monkeypatch.setattr(tvis, "write_video", lambda *a, **k: None)
    out = tvis.save_video(str(tmp_path / "v.mp4"), ims[:3], fps=5)
    assert out == str(tmp_path / "v.mp4") + "_frames"
    assert sorted(os.listdir(out)) == ["000000.png", "000001.png", "000002.png"]
    encoded = []

    def encode(image_dir, out_path, fps):
        encoded.append(sorted(os.listdir(image_dir)))
        return out_path

    monkeypatch.setattr(tvis, "write_video", encode)
    out = tvis.save_video(str(tmp_path / "w.mp4"), ims[:2], fps=5)
    assert out == str(tmp_path / "w.mp4")
    assert encoded == [["000000.png", "000001.png"]]
    assert not os.path.exists(out + "_frames")
    tvis.save_image(str(tmp_path / "one.png"), ims[0])
    jvis.save_image(str(tmp_path / "one_jax.png"), ims[0])
    assert (tmp_path / "one.png").read_bytes() == (tmp_path / "one_jax.png").read_bytes()
