"""The slice end to end: the port's incremental step and runner against the
JAX package's, on the CPU, plus the port's isolation from JAX and its
device default.

The step test runs the tiny CI configuration (the JAX package's
tests/test_e2e_gate.py:74-89: tiny encoders, skip decoder, 8 planes, 2
views, 64-sample raycast) for five chained frames of the synthetic scan
with the same weights (JAX init, carried over by the weights bridge) and
compares hint, depth and the final volume. Both sides are float32; the
chain feeds each frame's depth into the next frame's hint, so rounding
differences can move a hint pixel across a crossing. Bounds: hint validity
mismatch <= 1% of pixels, hint depth 1e-4 m where both are valid, s0 depth
1e-4 relative, and final TSDF values equal to 1e-3 on all but 1e-4 of the
voxels.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from doubletake_tpu.data.loader import collate
from doubletake_tpu.datasets.synthetic import SyntheticDataset
from doubletake_tpu.options import Options as JaxOptions
from doubletake_tpu.runners import common as jcommon
from doubletake_tpu.runners import incremental as jinc

from doubletake_tpu_torch.checkpoints.convert import variables_to_state_dict
from doubletake_tpu_torch.options import Options
from doubletake_tpu_torch.runners import common, incremental, no_hint, offline_two_pass, revisit
from doubletake_tpu_torch.scripts import (
    create_visibility_volume,
    evaluation,
    mesh_eval,
    render_hints,
    render_trajectory,
)
from doubletake_tpu_torch.tools.tsdf import TSDF
from doubletake_tpu_torch.training import train_loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = dict(
    dataset="synthetic", image_width=64, image_height=32, image_encoder_name="tiny",
    matching_encoder_type="tiny", depth_decoder_name="skip",
    model_type="cv_hint_depth_model", feature_volume_type="mlp_mesh_hint_feature_volume",
    matching_num_depth_bins=8, plane_chunk=8, model_num_views=2, batch_size=1,
    skip_frames=8, raycast_samples=64, num_workers=0, fusion_resolution=0.04,
    extended_neg_truncation=True, fast_cost_volume=True,
)


@pytest.fixture(autouse=True)
def few_torch_threads():
    """The tier runs several test processes at once: keep torch's CPU ops
    from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def options(cls, **extra):
    o = cls()
    for k, v in {**TINY, **extra}.items():
        setattr(o, k, v)
    return o


def test_incremental_step_matches_jax():
    jopts = options(JaxOptions)
    popts = options(Options, device="cpu")
    ds = SyntheticDataset(split="test", image_height=32, image_width=64, tuple_size=2,
                          num_images_in_tuple=2, include_full_res_depth=True,
                          pass_frame_id=True)
    batches = [collate([ds[i]]) for i in range(5)]

    jmodel = jcommon.build_model(jopts)
    cur0, src0 = jcommon.device_batch(*batches[0])
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), cur0, src0)
    jtsdf, jcfg = jcommon.make_fuser(jopts, ds, "synth0")
    jstep, _ = jinc.make_step(jmodel, jcfg, 8, 16, 64, jopts.fusion_max_depth, opts=jopts)

    pmodel = common.build_model(popts)
    pmodel.load_state_dict(variables_to_state_dict(variables))
    ptsdf, pcfg = common.make_fuser(popts, ds, "synth0", torch.device("cpu"))
    pstep = incremental.make_step(pmodel, pcfg, 8, 16, 64, popts.fusion_max_depth, opts=popts)

    hint_frames = 0
    for cur_np, src_np in batches:
        jout, jhint, jtsdf = jstep(variables, jtsdf, *jcommon.device_batch(cur_np, src_np))
        pout, phint, ptsdf = pstep(ptsdf, *common.device_batch(cur_np, src_np, "cpu"))

        jv = np.asarray(jhint["hint_mask_bhw1"])
        pv = phint["hint_mask_bhw1"].numpy()
        assert float((jv != pv).mean()) <= 0.01
        both = jv & pv
        jd = np.asarray(jhint["depth_hint_bhw1"])[both]
        pd = phint["depth_hint_bhw1"].numpy()[both]
        assert np.abs(jd - pd).max(initial=0.0) < 1e-4
        hint_frames += int(both.any())

        a = pout["depth_pred_s0_bhw1"].numpy()
        b = np.asarray(jout["depth_pred_s0_bhw1"])
        assert np.abs(a - b).max() / np.abs(b).max() < 1e-4

    assert hint_frames >= 2, "the hint must engage after the first frames"
    dv = np.abs(ptsdf.values.numpy() - np.asarray(jtsdf.values))
    assert float((dv > 1e-3).mean()) <= 1e-4
    np.testing.assert_allclose(ptsdf.weights.numpy().sum(), float(jnp.sum(jtsdf.weights)),
                               rtol=1e-4)

    # the split steps compute the same frame
    hint_step, forward_step, fuse_step = incremental.make_split_steps(
        pmodel, pcfg, 8, 16, 64, popts.fusion_max_depth, opts=popts)
    cur, src = common.device_batch(*batches[-1], "cpu")
    vol_a = TSDF(ptsdf.values.clone(), ptsdf.weights.clone(), ptsdf.origin, ptsdf.voxel_size)
    vol_b = TSDF(ptsdf.values.clone(), ptsdf.weights.clone(), ptsdf.origin, ptsdf.voxel_size)
    out_a, _, vol_a = pstep(vol_a, cur, src)
    out_b = forward_step(cur, src, hint_step(vol_b, cur))
    fuse_step(vol_b, out_b, cur)
    assert torch.equal(out_a["depth_pred_s0_bhw1"], out_b["depth_pred_s0_bhw1"])
    assert torch.equal(vol_a.values, vol_b.values)


def test_run_end_to_end_on_cpu(tmp_path):
    # the synthetic scan is always 33 frames: a coarse volume keeps it quick
    o = options(Options, device="cpu", name="port_e2e", output_base_path=str(tmp_path),
                fusion_resolution=0.08)
    res = incremental.run(o)
    fa = res["frame_avg"]
    for key in ("abs_diff", "abs_rel", "a5", "frame_time", "hint_time", "model_time",
                "fuse_time", "hint_coverage"):
        assert np.isfinite(fa[key]), key
    assert 0.0 < fa["abs_rel"] < 50.0 and 0.0 <= fa["a5"] <= 100.0
    assert fa["hint_coverage"] > 0.0
    # the scan loop's wall time covers every frame's step, and the loader
    # waits between them
    assert res["frames"] == 33
    assert res["scan_time"] >= 33 * fa["frame_time"]
    base = tmp_path / "port_e2e" / "incremental_default"
    assert (base / "scores" / "all_frame_avg_metrics.json").exists()
    assert (base / "meshes" / "synth0_tsdf.npz").exists()
    assert (base / "meshes" / "synth0.ply").exists() and res["meshes"]["synth0"]["faces"] > 0


def test_cuda_is_the_default_device():
    """Without device="cpu" the entry points insist on CUDA: with no CUDA
    device they raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is honoured")
    o = options(Options)
    assert o.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        common.build_model(o)
    for runner in (incremental, no_hint, offline_two_pass, revisit):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            runner.run(o)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_loop.train(o)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_visibility_volume.main(["--dataset", "synthetic"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_eval.main(["--pred_dir", ".", "--gt_dir", "."])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_hints.main(["--depth_cache_dir", ".", "--render_output_dir", "."])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_trajectory.main(["--tsdf_path", "missing.npz"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluation.main(["--dataset", "synthetic", "--feature_volume_type",
                         "mlp_mesh_hint_feature_volume"])


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, import with jax, flax and
    doubletake_tpu made unimportable; the mesh extractor loads the port's
    own build (build/torch_kernels), never the JAX package's native/."""
    code = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "doubletake_tpu", "native"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import doubletake_tpu_torch
names = [m.name for m in pkgutil.walk_packages(doubletake_tpu_torch.__path__,
                                              "doubletake_tpu_torch.")]
assert {"doubletake_tpu_torch.train", "doubletake_tpu_torch.losses",
        "doubletake_tpu_torch.training.train_loop",
        "doubletake_tpu_torch.training.augmentation",
        "doubletake_tpu_torch.tools.marching_cubes", "doubletake_tpu_torch.eval.visibility",
        "doubletake_tpu_torch.eval.mesh_eval",
        "doubletake_tpu_torch.scripts.create_visibility_volume",
        "doubletake_tpu_torch.scripts.mesh_eval",
        "doubletake_tpu_torch.scripts.render_hints",
        "doubletake_tpu_torch.scripts.render_trajectory",
        "doubletake_tpu_torch.tools.partial_fuser", "doubletake_tpu_torch.tools.viz_renderer",
        "doubletake_tpu_torch.training.distributed",
        "doubletake_tpu_torch.tools.keyframe_buffer", "doubletake_tpu_torch.tools.tuple_generation",
        "doubletake_tpu_torch.utils.cropping", "doubletake_tpu_torch.scripts.evaluation",
        "doubletake_tpu_torch.scripts.precompute_valid_frames",
        "doubletake_tpu_torch.scripts.generate_test_tuples",
        "doubletake_tpu_torch.scripts.generate_train_tuples",
        "doubletake_tpu_torch.scripts.strip_checkpoint"} <= set(names), names
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "doubletake_tpu",
                                                    "native")]
assert not bad, bad
import numpy as np
from doubletake_tpu_torch.tools.marching_cubes import extract_mesh
g = np.linspace(-1, 1, 9, dtype=np.float32)
assert len(extract_mesh(np.sqrt((g[:, None, None] ** 2 + g[:, None] ** 2 + g ** 2)) - 0.5)[1])
libs = [line.split()[-1] for line in open("/proc/self/maps") if "marching" in line]
assert libs and all("/build/torch_kernels/libmarching-" in p for p in libs), libs
print(len(names))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 20
