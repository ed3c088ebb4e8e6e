"""The offline two-pass mode: the port's pass 1, pass-2 step and batched
static-volume raycast against the JAX package's, and the port's runner end
to end, on the CPU.

The tiny CI configuration (tests/test_torch_incremental.py) at batch 2 on a
12-frame synthetic scan, with the JAX initialisation carried over by the
weights bridge. Bounds:
  * pass-1 hint volume: |value difference| > 1e-3 on at most 1e-4 of the
    voxels, weight sums within 1e-4 relative (the incremental test's rule);
  * pass-2 step (the same hint volume on both sides; the JAX step raycasts
    its packed ray table under ``vmap``): hint validity mismatch <= 1% of
    the pixels, hint depth 1e-4 m where both are valid, s0 depth 1e-4
    relative;
  * the batched raycast: bit-equal to a loop of single-pose calls.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from doubletake_tpu.data.loader import collate
from doubletake_tpu.datasets.synthetic import SyntheticDataset
from doubletake_tpu.options import Options as JaxOptions
from doubletake_tpu.runners import common as jcommon
from doubletake_tpu.runners import offline_two_pass as joffline
from doubletake_tpu.tools.tsdf import build_ray_table

from doubletake_tpu_torch.checkpoints.convert import variables_to_state_dict
from doubletake_tpu_torch.datasets import registry
from doubletake_tpu_torch.datasets.synthetic import SyntheticDataset as PortSyntheticDataset
from doubletake_tpu_torch.options import Options
from doubletake_tpu_torch.runners import common, offline_two_pass
from doubletake_tpu_torch.tools.tsdf import TSDF, prepare_static, raycast

TINY = dict(
    dataset="synthetic", image_width=64, image_height=32, image_encoder_name="tiny",
    matching_encoder_type="tiny", depth_decoder_name="skip",
    model_type="cv_hint_depth_model", feature_volume_type="mlp_mesh_hint_feature_volume",
    matching_num_depth_bins=8, plane_chunk=8, model_num_views=2, batch_size=2,
    raycast_samples=64, num_workers=0, fusion_resolution=0.04,
    extended_neg_truncation=True, fast_cost_volume=True,
)


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


def dataset(cls):
    return cls(split="test", image_height=32, image_width=64, tuple_size=2,
               num_images_in_tuple=2, num_frames=12, include_full_res_depth=True)


@pytest.fixture(scope="module")
def pass1():
    """Both packages' models (same weights) and pass-1 hint volumes."""
    torch.set_num_threads(2)
    jopts, popts = options(JaxOptions), options(Options, device="cpu")
    jds, pds = dataset(SyntheticDataset), dataset(PortSyntheticDataset)
    jmodel = jcommon.build_model(jopts)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     *jcommon.device_batch(*collate([jds[0]])))
    pmodel = common.build_model(popts)
    pmodel.load_state_dict(variables_to_state_dict(jax.device_get(variables)))
    jvol = joffline.compute_hint_volume(jopts, jmodel, variables, jds, "synth0")
    pvol = offline_two_pass.compute_hint_volume(popts, pmodel, pds, "synth0", torch.device("cpu"))
    return dict(jmodel=jmodel, variables=variables, pmodel=pmodel, jvol=jvol, pvol=pvol, ds=pds)


def test_hint_volume_matches_jax(pass1):
    jvol, pvol = pass1["jvol"], pass1["pvol"]
    assert pvol.dims == tuple(jvol.dims) == (152, 104, 80)
    assert float(pvol.weights.max()) > 0
    dv = np.abs(pvol.values.numpy() - np.asarray(jvol.values))
    assert float((dv > 1e-3).mean()) <= 1e-4
    np.testing.assert_allclose(pvol.weights.numpy().sum(), float(jnp.sum(jvol.weights)),
                               rtol=1e-4)


def test_pass2_step_matches_jax(pass1):
    """Both steps on the JAX pass-1 volume, batch 2."""
    jvol = pass1["jvol"]
    pvol = TSDF(values=torch.from_numpy(np.array(jvol.values)),
                weights=torch.from_numpy(np.array(jvol.weights)),
                origin=torch.from_numpy(np.array(jvol.origin)), voxel_size=jvol.voxel_size)
    cur_np, src_np = collate([pass1["ds"][i] for i in (2, 3)])
    jstep = joffline.make_pass2_step(pass1["jmodel"], 8, 16, 64, 3.0)
    jout, jhint = jstep(pass1["variables"], jax.jit(build_ray_table)(jvol),
                        *jcommon.device_batch(cur_np, src_np))
    pstep = offline_two_pass.make_pass2_step(pass1["pmodel"], 8, 16, 64, 3.0)
    pout, phint = pstep(prepare_static(pvol), *common.device_batch(cur_np, src_np, "cpu"))

    jv = np.asarray(jhint["hint_mask_bhw1"])
    pv = phint["hint_mask_bhw1"].numpy()
    assert pv.shape == (2, 8, 16, 1) and pv.mean() > 0.3
    assert float((jv != pv).mean()) <= 0.01
    both = jv & pv
    assert np.abs(np.asarray(jhint["depth_hint_bhw1"])[both]
                  - phint["depth_hint_bhw1"].numpy()[both]).max() < 1e-4
    a = pout["depth_pred_s0_bhw1"].numpy()
    b = np.asarray(jout["depth_pred_s0_bhw1"])
    assert np.abs(a - b).max() / np.abs(b).max() < 1e-4


def test_batched_raycast_is_bit_equal_to_a_loop(pass1):
    """One march over a batch of poses (one of them outside the volume,
    looking away) gives what one call per pose gives, from the running
    volume and from its static copy."""
    vol = pass1["pvol"]
    ds = pass1["ds"]
    poses = [ds.load_pose("synth0", i)[0] for i in (1, 5, 9)]
    away = np.eye(4, dtype=np.float32)
    away[:3, 3] = (vol.origin.numpy() + np.array(vol.dims) * vol.voxel_size + 1.0)
    poses.append(away)
    world_T_cam = torch.from_numpy(np.stack(poses))
    invK = torch.from_numpy(ds.load_intrinsics("synth0")["invK_s0_b44"])[None].repeat(4, 1, 1)
    kw = dict(min_depth=0.5, max_depth=3.0, num_samples=64)
    loop = [raycast(vol, world_T_cam[i], invK[i], 8, 16, **kw) for i in range(4)]
    assert loop[0][2].any() and not loop[3][2].any()
    for source in (vol, prepare_static(vol)):
        batch = raycast(source, world_T_cam, invK, 8, 16, **kw)
        for got, want in zip(batch, zip(*loop)):
            # exact equality, NaNs where the loop has them
            np.testing.assert_array_equal(got.numpy(), torch.stack(want).numpy())


def test_run_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(offline_two_pass, "dataset_from_opts",
                        lambda *a, **k: registry.dataset_from_opts(*a, num_frames=12, **k))
    o = options(Options, device="cpu", name="off", output_base_path=str(tmp_path),
                run_fusion=True)
    res = offline_two_pass.run(o)
    assert res["frames"] == 5 and res["pass_time"]["pass1"] > 0 and res["pass_time"]["pass2"] > 0
    fa = res["frame_avg"]
    for key in ("abs_diff", "abs_rel", "a5", "frame_time", "hint_coverage"):
        assert np.isfinite(fa[key]), key
    assert fa["hint_coverage"] > 0.0
    base = tmp_path / "off" / "offline_two_pass_default"
    for name in ("all_frame_avg_metrics.json", "scene_avg_metrics.json", "synth0_metrics.json"):
        assert (base / "scores" / name).exists(), name
    hint_vol = TSDF.load(str(base / "meshes" / "synth0_hint_tsdf.npz"))
    final_vol = TSDF.load(str(base / "meshes" / "synth0_tsdf.npz"))
    assert (hint_vol.voxel_size, final_vol.voxel_size) == (0.04, 0.04)
    assert float(hint_vol.weights.max()) > 0 and float(final_vol.weights.max()) > 0
