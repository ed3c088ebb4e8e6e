"""The mesh layer: the port's marching-tetrahedra extractor, PLY files,
coloured fusion and every runner's mesh export, against the JAX package's,
on the CPU.

Both packages build the same C++ source with the same g++ flags, so the
same volume must give the same mesh bit for bit, and ``save_ply`` the same
bytes. Coloured fusion (the JAX dense ``_voxel_update``) is held to 1e-6 on
values and weights and one float16 ulp on colours over chained frames; its
values and weights are bit-equal to the port's plain K2 version. Exported
vertex colours: within 1 (uint8). Each runner writes ``<scan>.ply`` equal to
the JAX ``extract_mesh`` of the volume the runner held in memory.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from doubletake_tpu.options import Options as JaxOptions
from doubletake_tpu.runners import common as jcommon
from doubletake_tpu.runners import no_hint as jno_hint
from doubletake_tpu.tools import marching_cubes as jm
from doubletake_tpu.tools import tsdf as jt

from doubletake_tpu_torch.checkpoints.convert import variables_to_state_dict
from doubletake_tpu_torch.data.loader import collate
from doubletake_tpu_torch.datasets import registry
from doubletake_tpu_torch.datasets.synthetic import SyntheticDataset
from doubletake_tpu_torch.ops import build
from doubletake_tpu_torch.ops.integrate import integrate_plain
from doubletake_tpu_torch.options import Options
from doubletake_tpu_torch.runners import common, incremental, no_hint, offline_two_pass, revisit
from doubletake_tpu_torch.tools import marching_cubes as pm
from doubletake_tpu_torch.tools import tsdf as tt
from test_mesh_tools import sphere_sdf
from test_torch_tsdf import BOUNDS, H, W, camera, intrinsics, smooth_depth

TINY = dict(
    dataset="synthetic", image_width=64, image_height=32, image_encoder_name="tiny",
    matching_encoder_type="tiny", depth_decoder_name="skip",
    model_type="cv_hint_depth_model", feature_volume_type="mlp_mesh_hint_feature_volume",
    matching_num_depth_bins=8, plane_chunk=8, model_num_views=2, batch_size=2,
    raycast_samples=64, num_workers=0, fusion_resolution=0.04,
    extended_neg_truncation=True, fast_cost_volume=True,
)
SIMPLERECON = dict(model_type="depth_model", feature_volume_type="mlp_feature_volume")


@pytest.fixture(autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def options(cls, **extra):
    o = cls()
    for k, v in {**TINY, **extra}.items():
        setattr(o, k, v)
    return o


def random_tsdf(n=20, seed=0):
    """A smooth random field with a weight mask (a third unobserved)."""
    rng = np.random.RandomState(seed)
    g = np.linspace(0, 2 * np.pi, n)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    a = rng.uniform(0.5, 1.5, 3)
    vol = (np.sin(a[0] * x) * np.cos(a[1] * y) + 0.5 * np.sin(a[2] * z)
           + 0.2 * rng.randn(n, n, n)).astype(np.float32)
    weights = (rng.rand(n, n, n) > 0.33).astype(np.float32) * rng.rand(n, n, n).astype(np.float32)
    return vol, weights


@pytest.mark.parametrize("case", ["sphere", "random_weighted"])
def test_extract_mesh_matches_jax(case):
    if case == "sphere":
        vol, weights, origin, vs = sphere_sdf(40), None, None, 1.0
    else:
        vol, weights = random_tsdf()
        origin, vs = np.array([-0.3, 0.2, 1.0], np.float32), 0.04
    jv, jf = jm.extract_mesh(vol, weights=weights, origin=origin, voxel_size=vs)
    pv, pf = pm.extract_mesh(torch.from_numpy(vol),
                             weights=None if weights is None else torch.from_numpy(weights),
                             origin=None if origin is None else torch.from_numpy(origin),
                             voxel_size=vs)
    assert len(pf) > 100
    assert pv.dtype == jv.dtype and pf.dtype == jf.dtype
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pf, jf)


def test_marching_builds_with_the_jax_flags_and_a_failed_build_raises(tmp_path, monkeypatch):
    path = build.library_path("marching")
    assert path.parent == build.BUILD_DIR and path.name.startswith("libmarching-")
    assert build.HOST_FLAGS == ("-O3", "-shared", "-fPIC", "-std=c++17")
    pm.extract_mesh(sphere_sdf(8))
    assert path.exists()

    # no fallback: a source that does not compile raises from the extractor
    (tmp_path / "marching.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(RuntimeError, match="build failed for marching"):
        pm.extract_mesh(sphere_sdf(8))


@pytest.mark.parametrize("colored", [False, True])
def test_save_ply_bytes_and_cross_load(tmp_path, colored):
    verts, faces = jm.extract_mesh(sphere_sdf(24))
    colors = (np.random.RandomState(1).rand(len(verts), 3) * 255.0 if colored else None)
    jm.save_ply(str(tmp_path / "jax.ply"), verts, faces, colors=colors)
    pm.save_ply(str(tmp_path / "torch.ply"), verts, faces, colors=colors)
    assert (tmp_path / "jax.ply").read_bytes() == (tmp_path / "torch.ply").read_bytes()

    pv, pf, pc = pm.load_ply(str(tmp_path / "jax.ply"), return_colors=True)
    jv, jf = jm.load_ply(str(tmp_path / "torch.ply"))
    for v, f in ((pv, pf), (jv, jf)):
        np.testing.assert_array_equal(v, verts)
        np.testing.assert_array_equal(f, faces)
    if colored:
        np.testing.assert_array_equal(pc, colors.astype(np.uint8))
    else:
        assert pc is None


def color_frames(n=3):
    """(depth (H, W, 1), cam_T_world, image (H, W, 3)) frames from seeds."""
    out = []
    for i in range(n):
        rng = np.random.RandomState(10 + i)
        img = rng.rand(H, W, 3).astype(np.float32)
        out.append((smooth_depth(i), np.linalg.inv(camera(yaw=0.3 + 0.1 * i)).astype(np.float32),
                    img))
    return out


def fuse_color_both(frames, cfg):
    jvol = jt.TSDF.from_bounds(BOUNDS, 0.04, with_color=True)
    tvol = tt.TSDF.from_bounds(BOUNDS, 0.04, with_color=True)
    K = intrinsics()
    for depth, cTw, img in frames:
        jvol = jt.integrate_depth(jvol, jnp.asarray(depth), jnp.asarray(cTw), jnp.asarray(K),
                                  jt.FusionConfig(**vars(cfg)), image_hw3=jnp.asarray(img),
                                  use_pallas=False)
        tt.integrate_depth(tvol, torch.from_numpy(depth), torch.from_numpy(cTw),
                           torch.from_numpy(K), cfg, image_hw3=torch.from_numpy(img))
    return jvol, tvol


def test_color_integrate_matches_jax_and_k2():
    cfg = tt.FusionConfig(min_depth=0.5, max_depth=3.5, extended_neg_truncation=True)
    frames = color_frames()
    jvol, tvol = fuse_color_both(frames, cfg)
    assert tvol.colors.dtype == torch.float16 and float(tvol.weights.max()) > 0
    np.testing.assert_allclose(tvol.values.numpy(), np.asarray(jvol.values), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tvol.weights.numpy(), np.asarray(jvol.weights), rtol=0, atol=1e-6)
    jc = np.asarray(jvol.colors)
    pc = tvol.colors.numpy()
    assert float(pc.astype(np.float32).max()) > 0.1
    ulp = np.spacing(np.maximum(np.abs(jc), np.abs(pc)).astype(np.float16)).astype(np.float32)
    assert (np.abs(pc.astype(np.float32) - jc.astype(np.float32)) <= ulp).all()

    # the values and weights are the plain K2 version's, bit for bit
    K = torch.from_numpy(intrinsics())
    plain = tt.TSDF.from_bounds(BOUNDS, 0.04)
    trunc = cfg.truncation_voxels * 0.04
    kw = dict(voxel_size=0.04, min_depth=cfg.min_depth, max_depth=cfg.max_depth,
              truncation=trunc, trunc_check=-trunc * 1.5, update_rate=cfg.update_rate,
              max_weight=cfg.max_weight)
    for depth, cTw, _ in frames:
        P = torch.matmul(K, torch.from_numpy(cTw))[:3].contiguous()
        plain.values, plain.weights = integrate_plain(
            plain.values, plain.weights, torch.from_numpy(depth[..., 0]), P, plain.origin, **kw)
    assert torch.equal(plain.values, tvol.values) and torch.equal(plain.weights, tvol.weights)


def test_color_tsdf_npz_interchange(tmp_path):
    cfg = tt.FusionConfig(min_depth=0.5, max_depth=3.5)
    jvol, tvol = fuse_color_both(color_frames(2), cfg)
    jvol.save(str(tmp_path / "jax.npz"))
    tvol.save(str(tmp_path / "torch.npz"))
    from_jax = tt.TSDF.load(str(tmp_path / "jax.npz"))
    from_torch = jt.TSDF.load(str(tmp_path / "torch.npz"))
    assert from_jax.colors.dtype == torch.float16
    np.testing.assert_array_equal(from_jax.colors.numpy(), np.asarray(jvol.colors))
    np.testing.assert_array_equal(np.asarray(from_torch.colors), tvol.colors.numpy())
    np.testing.assert_array_equal(np.asarray(from_torch.values),
                                  tvol.values.numpy().astype(np.float16).astype(np.float32))
    assert from_jax.voxel_size == jvol.voxel_size and from_torch.dims == tvol.dims
    assert tt.TSDF.load(str(tmp_path / "torch.npz")).colors is not None


def test_colored_export_matches_jax(tmp_path):
    cfg = tt.FusionConfig(min_depth=0.5, max_depth=3.5)
    jvol, tvol = fuse_color_both(color_frames(), cfg)
    # one volume state for both exports: the port's values, weights and colours
    jvol = jvol.replace(values=jnp.asarray(tvol.values.numpy()),
                        weights=jnp.asarray(tvol.weights.numpy()),
                        colors=jnp.asarray(tvol.colors.numpy()))
    jm.export_mesh(jvol, str(tmp_path / "jax.ply"))
    verts, faces = pm.export_mesh(tvol, str(tmp_path / "torch.ply"))
    jv, jf, jc = pm.load_ply(str(tmp_path / "jax.ply"), return_colors=True)
    pv, pf, pc = pm.load_ply(str(tmp_path / "torch.ply"), return_colors=True)
    assert len(faces) > 100 and pc is not None and pc.max() > 20
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pf, jf)
    assert np.abs(pc.astype(int) - jc.astype(int)).max() <= 1


def short_dataset(*a, **k):
    return registry.dataset_from_opts(*a, num_frames=12, **k)


RUNNERS = {
    "incremental": (incremental, dict(batch_size=1), "incremental_default", "synth0"),
    "no_hint": (no_hint, dict(SIMPLERECON), "no_hint_default", "synth0"),
    "offline_two_pass": (offline_two_pass, {}, "offline_two_pass_default", "synth0"),
    "revisit": (revisit, dict(single_debug_scan_id="synth0@1"), "revisit_default", "synth0@1"),
}


@pytest.mark.parametrize("name", list(RUNNERS))
def test_runner_writes_the_jax_mesh_of_its_volume(name, tmp_path, monkeypatch):
    module, extra, mode, scan = RUNNERS[name]
    monkeypatch.setattr(module, "dataset_from_opts", short_dataset)
    held = {}
    export = common.export_scan_mesh

    def recording_export(tsdf, meshes_dir, scan_name):
        held[scan_name] = [x.clone().numpy() for x in (tsdf.values, tsdf.weights, tsdf.origin)]
        held["voxel_size"] = tsdf.voxel_size
        return export(tsdf, meshes_dir, scan_name)

    monkeypatch.setattr(common, "export_scan_mesh", recording_export)
    o = options(Options, device="cpu", name=name, output_base_path=str(tmp_path),
                run_fusion=True, **extra)
    res = module.run(o)
    meshes = tmp_path / name / mode / "meshes"
    assert (meshes / f"{scan}_tsdf.npz").exists()
    values, weights, origin = held[scan]
    jv, jf = jm.extract_mesh(values, weights=weights, origin=origin,
                             voxel_size=held["voxel_size"])
    assert len(jf) > 100
    jm.save_ply(str(tmp_path / "jax.ply"), jv, jf)
    assert (meshes / f"{scan}.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    info = res["meshes"][scan]
    assert (info["verts"], info["faces"]) == (len(jv), len(jf)) and info["export_s"] > 0


def test_fusers_and_rgb_for_fusion_match_jax():
    ds = SyntheticDataset(split="test", image_height=32, image_width=64, tuple_size=2,
                          num_images_in_tuple=2, num_frames=6)
    for fuser, fuse_color in (("ours", False), ("ours", True), ("open3d", False),
                              ("custom_open3d", False)):
        jopts = options(JaxOptions, depth_fuser=fuser, fuse_color=fuse_color)
        popts = options(Options, device="cpu", depth_fuser=fuser, fuse_color=fuse_color)
        jvol, _ = jcommon.make_fuser(jopts, ds, "synth0")
        pvol, _ = common.make_fuser(popts, ds, "synth0", "cpu")
        assert (pvol.colors is None) == (jvol.colors is None)
        assert pvol.colors is None or pvol.colors.shape == jvol.colors.shape
    with pytest.raises(ValueError, match="unknown"):
        common.make_fuser(options(Options, device="cpu", depth_fuser="tsdf"), ds, "synth0", "cpu")

    cur_np, _ = collate([ds[1], ds[3]])
    popts = options(Options, device="cpu", fuse_color=True)
    got = common.rgb_for_fusion(popts, {"image_bhw3": torch.from_numpy(cur_np["image_bhw3"])},
                                (16, 32))
    want = jcommon.rgb_for_fusion(options(JaxOptions, fuse_color=True),
                                  {"image_bhw3": jnp.asarray(cur_np["image_bhw3"])}, (16, 32))
    assert got.shape == (2, 16, 32, 3) and 0.0 <= float(got.min()) and float(got.max()) <= 1.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert common.rgb_for_fusion(options(Options, device="cpu"), {}, (16, 32)) is None


def test_color_no_hint_run_matches_jax(tmp_path, monkeypatch):
    """SimpleRecon with fuse_color over a 12-frame scan in both packages,
    same weights: the coloured volume and the coloured PLY."""
    monkeypatch.setattr(no_hint, "dataset_from_opts", short_dataset)
    from doubletake_tpu.datasets import registry as jregistry

    monkeypatch.setattr(jno_hint, "dataset_from_opts",
                        lambda *a, **k: jregistry.dataset_from_opts(*a, num_frames=12, **k))
    extra = dict(SIMPLERECON, run_fusion=True, fuse_color=True,
                 output_base_path=str(tmp_path))
    jopts = options(JaxOptions, name="jax", **extra)
    popts = options(Options, device="cpu", name="torch", **extra)
    ds = short_dataset(popts, split="test", limit_to_scan_id="synth0")
    jmodel = jcommon.build_model(jopts)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     *jcommon.device_batch(*collate([ds[0]])))
    pmodel = common.build_model(popts)
    pmodel.load_state_dict(variables_to_state_dict(jax.device_get(variables)))
    jno_hint.run(jopts, variables=variables)
    res = no_hint.run(popts, model=pmodel)
    assert res["frames"] == 5

    vols = {}
    for side in ("jax", "torch"):
        d = tmp_path / side / "no_hint_default" / "meshes"
        vols[side] = (tt.TSDF.load(str(d / "synth0_tsdf.npz")),
                      pm.load_ply(str(d / "synth0.ply"), return_colors=True))
    (jvol, (jv, jf, jc)), (pvol, (pv, pf, pc)) = vols["jax"], vols["torch"]
    assert pvol.colors is not None and float(pvol.colors.float().max()) > 0.1
    assert float(((pvol.values - jvol.values).abs() > 1e-3).float().mean()) <= 1e-4
    np.testing.assert_allclose(pvol.weights.sum().item(), jvol.weights.sum().item(), rtol=1e-4)
    dc = (pvol.colors.float() - jvol.colors.float()).abs()
    assert float((dc > 2e-3).float().mean()) <= 1e-4
    assert pc is not None and jc is not None and len(pf) > 100
    assert abs(len(pv) - len(jv)) <= 0.01 * len(jv)
    np.testing.assert_allclose(pc.astype(float).mean(0), jc.astype(float).mean(0), atol=1.0)
    assert os.path.exists(tmp_path / "torch" / "no_hint_default" / "scores"
                          / "synth0_metrics.json")
