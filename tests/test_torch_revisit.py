"""The revisit mode: the port's pass-2 step with rescan poses mapped into
the first visit's world frame, against the JAX package's, and the port's
runner end to end with a rescan whose world frame is moved, on the CPU.

The tiny CI configuration (tests/test_torch_incremental.py). The JAX
package has no revisit end-to-end test: here the rescan's poses are given
in a world frame moved by a rigid ``T`` and the dataset reports ``T`` as
first_T_second, so the rescan's hints and depths must equal those of the
unmoved rescan (1e-4 m on hint depths where both are valid, validity
mismatch <= 1%, s0 depth 1e-4 relative).
"""

import numpy as np
import pytest
import torch

import jax

from doubletake_tpu.data.loader import collate
from doubletake_tpu.options import Options as JaxOptions
from doubletake_tpu.runners import common as jcommon
from doubletake_tpu.runners import offline_two_pass as joffline
from doubletake_tpu.tools import tsdf as jt

from doubletake_tpu_torch.checkpoints.convert import variables_to_state_dict
from doubletake_tpu_torch.datasets import registry
from doubletake_tpu_torch.datasets.synthetic import SyntheticDataset
from doubletake_tpu_torch.options import Options
from doubletake_tpu_torch.runners import common, offline_two_pass, revisit
from doubletake_tpu_torch.tools.tsdf import prepare_static

TINY = dict(
    dataset="synthetic", image_width=64, image_height=32, image_encoder_name="tiny",
    matching_encoder_type="tiny", depth_decoder_name="skip",
    model_type="cv_hint_depth_model", feature_volume_type="mlp_mesh_hint_feature_volume",
    matching_num_depth_bins=8, plane_chunk=8, model_num_views=2, batch_size=2,
    raycast_samples=64, num_workers=0, fusion_resolution=0.04,
    extended_neg_truncation=True, fast_cost_volume=True,
)


def first_T_second():
    """A rigid transform: 0.3 rad about z, 0.2 rad about x, and a shift."""
    cz, sz, cx, sx = np.cos(0.3), np.sin(0.3), np.cos(0.2), np.sin(0.2)
    T = np.eye(4)
    T[:3, :3] = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]]) @ \
        np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    T[:3, 3] = (0.4, -0.7, 0.25)
    return T.astype(np.float32)


class MovedRescans(SyntheticDataset):
    """Rescans ("synthN@M") with their poses in a world frame moved by
    ``first_T_second``: world2_T_cam = inv(T) @ world1_T_cam."""

    def load_pose(self, scan_id, frame_id):
        world_T_cam, cam_T_world = super().load_pose(scan_id, frame_id)
        if "@" in scan_id:
            world_T_cam = (np.linalg.inv(first_T_second()) @ world_T_cam).astype(np.float32)
            cam_T_world = np.linalg.inv(world_T_cam).astype(np.float32)
        return world_T_cam, cam_T_world

    def revisit_source_scan(self, scan_id):
        first, _ = super().revisit_source_scan(scan_id)
        return first, first_T_second()


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


def short_dataset(moved):
    def make(*args, **kwargs):
        ds = registry.dataset_from_opts(*args, num_frames=12, **kwargs)
        if moved:
            ds.__class__ = MovedRescans
        return ds
    return make


def test_mapped_pass2_step_matches_jax():
    """A moved rescan batch through both packages' pass-2 steps, with
    hint_world_T_cam = first_T_second @ world_T_cam, on the port's first
    visit hint volume."""
    popts = options(Options, device="cpu")
    first = short_dataset(False)(popts, split="test", limit_to_scan_id="synth0")
    rescan = short_dataset(True)(popts, split="test", limit_to_scan_id="synth0@1",
                                 include_full_res_depth=True)
    jmodel = jcommon.build_model(options(JaxOptions))
    cur_np, src_np = collate([rescan[i] for i in (2, 3)])
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), *jcommon.device_batch(cur_np, src_np))
    pmodel = common.build_model(popts)
    pmodel.load_state_dict(variables_to_state_dict(jax.device_get(variables)))
    pvol = offline_two_pass.compute_hint_volume(popts, pmodel, first, "synth0", torch.device("cpu"))
    jvol = jt.TSDF.from_bounds(dict(xmin=0, xmax=1, ymin=0, ymax=1, zmin=0, zmax=1), 0.04).replace(
        values=pvol.values.numpy(), weights=pvol.weights.numpy(), origin=pvol.origin.numpy())

    T = first_T_second()
    jcur, jsrc = jcommon.device_batch(cur_np, src_np)
    jcur["hint_world_T_cam_b44"] = np.einsum("ij,bjk->bik", T, cur_np["world_T_cam_b44"])
    jout, jhint = joffline.make_pass2_step(jmodel, 8, 16, 64, 3.0)(
        variables, jax.jit(jt.build_ray_table)(jvol), jcur, jsrc)
    pcur, psrc = common.device_batch(cur_np, src_np, "cpu")
    pcur["hint_world_T_cam_b44"] = torch.matmul(torch.from_numpy(T), pcur["world_T_cam_b44"])
    pout, phint = offline_two_pass.make_pass2_step(pmodel, 8, 16, 64, 3.0)(
        prepare_static(pvol), pcur, psrc)

    jv = np.asarray(jhint["hint_mask_bhw1"])
    pv = phint["hint_mask_bhw1"].numpy()
    assert pv.mean() > 0.3
    assert float((jv != pv).mean()) <= 0.01
    both = jv & pv
    assert np.abs(np.asarray(jhint["depth_hint_bhw1"])[both]
                  - phint["depth_hint_bhw1"].numpy()[both]).max() < 1e-4
    a = pout["depth_pred_s0_bhw1"].numpy()
    b = np.asarray(jout["depth_pred_s0_bhw1"])
    assert np.abs(a - b).max() / np.abs(b).max() < 1e-4


def run_recording(monkeypatch, tmp_path, moved, **extra):
    """revisit.run over a 12-frame rescan; returns its result and each
    step's (hint depth, hint validity, s0 depth)."""
    monkeypatch.setattr(revisit, "dataset_from_opts", short_dataset(moved))
    steps = []

    def recording_step(*args):
        step = offline_two_pass.make_pass2_step(*args)

        def record(vol, cur, src):
            out, hint = step(vol, cur, src)
            steps.append((hint["depth_hint_bhw1"].numpy(), hint["hint_mask_bhw1"].numpy(),
                          out["depth_pred_s0_bhw1"].numpy()))
            return out, hint
        return record

    monkeypatch.setattr(revisit, "make_pass2_step", recording_step)
    o = options(Options, device="cpu", name=f"rv{int(moved)}", output_base_path=str(tmp_path),
                single_debug_scan_id="synth0@1", **extra)
    return revisit.run(o), steps


def test_run_with_a_moved_rescan_frame(tmp_path, monkeypatch):
    res, steps = run_recording(monkeypatch, tmp_path, moved=False, run_fusion=True)
    _, moved_steps = run_recording(monkeypatch, tmp_path, moved=True)
    assert res["frames"] == len(steps) == len(moved_steps) == 5
    for (hd, hv, d), (mhd, mhv, md) in zip(steps, moved_steps):
        assert hv.shape == (1, 8, 16, 1)
        assert float((hv != mhv).mean()) <= 0.01
        both = hv & mhv
        assert np.abs(hd[both] - mhd[both]).max(initial=0.0) < 1e-4
        assert np.abs(d - md).max() / np.abs(d).max() < 1e-4
    assert sum(int(hv.any()) for _, hv, _ in steps) == 5

    fa = res["frame_avg"]
    for key in ("abs_diff", "abs_rel", "a5", "frame_time", "hint_coverage"):
        assert np.isfinite(fa[key]), key
    assert fa["hint_coverage"] > 0.0
    assert res["pass_time"]["first_visit"] > 0 and res["pass_time"]["rescan"] > 0
    base = tmp_path / "rv0" / "revisit_default"
    for name in ("all_frame_avg_metrics.json", "scene_avg_metrics.json", "synth0@1_metrics.json"):
        assert (base / "scores" / name).exists(), name
    assert np.load(base / "meshes" / "synth0@1_tsdf.npz")["tsdf_weights"].max() > 0
    hint_vol = np.load(base / "meshes" / "synth0_hint_tsdf.npz")
    assert float(hint_vol["voxel_size"]) == 0.04 and hint_vol["tsdf_weights"].max() > 0
