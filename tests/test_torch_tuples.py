"""The port's DVMVS keyframe buffers, tuple generation, cropping helpers and
the tuple / strip / evaluation CLIs against the JAX package's, on the CPU.

The buffers, the tuple functions and the cropping helpers are the same
numpy arithmetic in both packages, so every comparison is exact (tolerance
0): return codes, measurement-frame indices, tuple lines, pixel boxes. The
CLIs run on a small ScanNet-layout fixture (``chip_smoke.write_scannet_scan``
at 128x96: the synthetic room along its orbit, frames 40-71 with ``-inf``
poses) and must write byte-equal files. The evaluation CLI runs the tiny
8-view configuration with the same weights (a JAX-package npz, read by both)
over the fixture's 8-frame default tuples; its metrics agree at the fp32
module budget.
"""

import importlib.util
import json
import os
import pathlib
import runpy
import sys

import numpy as np
import pytest
import torch

import flax
import jax

from doubletake_tpu.checkpoints.io import load_params as jax_load_params
from doubletake_tpu.checkpoints.io import save_params as jax_save_params
from doubletake_tpu.data.loader import collate
from doubletake_tpu.datasets.synthetic import SyntheticDataset
from doubletake_tpu.options import Options as JaxOptions
from doubletake_tpu.runners import common as jcommon
from doubletake_tpu.tools import keyframe_buffer as jkb
from doubletake_tpu.tools import tuple_generation as jtg
from doubletake_tpu.utils import cropping as jcrop

from doubletake_tpu_torch.checkpoints.convert import variables_to_state_dict
from doubletake_tpu_torch.checkpoints.io import save_train_state
from doubletake_tpu_torch.datasets.synthetic import synthetic_trajectory
from doubletake_tpu_torch.options import Options
from doubletake_tpu_torch.runners import common
from doubletake_tpu_torch.scripts import (
    evaluation,
    generate_test_tuples,
    generate_train_tuples,
    precompute_valid_frames,
    strip_checkpoint,
)
from doubletake_tpu_torch.tools import keyframe_buffer as pkb
from doubletake_tpu_torch.tools import tuple_generation as ptg
from doubletake_tpu_torch.utils import cropping as pcrop

# the module fixture that imports torch._dynamo (torch.optim's first use)
# with the reference-parity stubs set aside
from test_torch_training import dynamo_imported  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TUPLE_TYPES = ("default", "offline", "dense", "dense_offline")
LOST = range(40, 72)
# (frames, lost frames) of each trajectory of synthetic_trajectory(n, seed=0)
TRAJECTORIES = {"40": (40, range(0)), "120": (120, range(0)), "96_gap": (96, LOST)}
# (lines, lines of fewer than 8 frames) the generator gives; the short lines
# of default / dense are the JAX generator's, kept for parity
LINE_COUNTS = {
    "40": {"default": (39, 6), "offline": (39, 0), "dense": (38, 6), "dense_offline": (40, 0)},
    "120": {"default": (56, 6), "offline": (56, 0), "dense": (116, 12),
            "dense_offline": (120, 0)},
    "96_gap": {"default": (30, 12), "offline": (31, 0), "dense": (60, 12),
               "dense_offline": (64, 0)},
}
TINY = dict(
    image_width=64, image_height=32, image_encoder_name="tiny", matching_encoder_type="tiny",
    depth_decoder_name="skip", model_type="cv_hint_depth_model",
    feature_volume_type="mlp_mesh_hint_feature_volume", matching_num_depth_bins=8,
    plane_chunk=8, model_num_views=8, batch_size=1, raycast_samples=64, num_workers=0,
)


def load_file(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# the fixture's scan writer and the room's fusion bounds
CHIP_SMOKE = load_file("chip_smoke_helpers", os.path.join(REPO, "chip_smoke.py"))


def run_jax_script(name, argv, monkeypatch):
    """A JAX-package CLI under scripts/, run as ``python scripts/<name>.py``."""
    monkeypatch.setattr(sys, "argv", [name, *argv])
    runpy.run_path(os.path.join(REPO, "scripts", f"{name}.py"), run_name="__main__")


@pytest.fixture(autouse=True)
def few_torch_threads():
    """The tier runs several test processes at once: keep torch's CPU ops
    from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def trajectory(name):
    """Valid poses, frame ids and gaps (frames since the last valid one)."""
    n, lost = TRAJECTORIES[name]
    poses = synthetic_trajectory(n, seed=0)
    valid = [i for i in range(n) if i not in lost]
    dists = [i - prev - 1 for prev, i in zip([-1] + valid[:-1], valid)]
    return [poses[i] for i in valid], [f"{i:06d}" for i in valid], dists


def short(lines):
    return sum(len(line.split(" ")) - 1 < 8 for line in lines)


# ------------------------------------------------------------ keyframe buffers


def pose_stream(seed, n=90):
    """A seeded orbit (float64) with NaN poses at random frames and a run
    of 36 -inf poses (tracking lost for longer than 30 frames), and each
    valid frame's gap to the last valid one (None for an invalid frame)."""
    rng = np.random.RandomState(seed)
    poses = [p.astype(np.float64) for p in synthetic_trajectory(n, seed)]
    for i in range(n):
        poses[i][:3, 3] += rng.normal(0, 0.01, 3)
    for i in rng.choice(np.arange(1, 25), 4, replace=False):
        poses[i] = np.full((4, 4), np.nan)
    for i in range(30, 66):
        poses[i] = np.full((4, 4), -np.inf)
    dists, last = [], -1
    for i, p in enumerate(poses):
        ok = bool(np.isfinite(p).all())
        dists.append(i - last - 1 if ok else None)
        last = i if ok else last
    return poses, dists


def drive_buffer(kb, kind, poses, dists):
    """Each frame's return code and, after it, the buffer's measurement
    frames' indices."""
    if kind == "keyframe":
        buf = kb.KeyframeBuffer(store_return_indices=True)
    elif kind == "simple":
        buf = kb.SimpleBuffer(7, store_return_indices=True)
    else:
        buf = kb.OfflineKeyframeBuffer(store_return_indices=True)
    rows = []
    for i, (pose, dist) in enumerate(zip(poses, dists)):
        if kind == "keyframe":
            code = buf.try_new_keyframe(pose.copy(), None, dist, index=i)
        else:
            code = buf.try_new_keyframe(pose.copy(), None, index=i)
        row = [code]
        if len(buf.buffer):
            if kind == "simple":
                row.append([f[2] for f in buf.get_measurement_frames()])
            else:
                row.append([f[2] for f in buf.get_best_measurement_frames(7)])
            if kind == "offline":
                row.append([f[2] for f in buf.get_best_measurement_frames_for_0index(7)])
        rows.append(row)
    return rows


@pytest.mark.parametrize("kind", ["keyframe", "simple", "offline"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_buffers_match_jax(kind, seed):
    poses, dists = pose_stream(seed)
    got = drive_buffer(pkb, kind, poses, dists)
    assert got == drive_buffer(jkb, kind, poses, dists)
    codes = {row[0] for row in got}
    # the stream reaches the accept, reject and lost-tracking codes
    assert {0, 1} <= codes and (2 in codes or kind == "simple")
    assert {"keyframe": 3, "simple": 2, "offline": 3}[kind] in codes


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pose_measures_match_jax(seed):
    rng = np.random.RandomState(seed)
    poses = [p.astype(np.float64) for p in synthetic_trajectory(30, seed)]
    pairs = [(poses[i], poses[j]) for i, j in rng.randint(0, 30, (40, 2))]
    pairs.append((poses[0], poses[0].copy()))   # trace 3: the clamp
    for a, b in pairs:
        assert pkb.pose_distance(a, b) == jkb.pose_distance(a, b)
        for lo, hi in ((0.125, 0.325), (0.0, 0.1), (0.05, 1.0)):
            assert (pkb.is_valid_pair(a, b, lo, hi, return_measure=True)
                    == jkb.is_valid_pair(a, b, lo, hi, return_measure=True))
    for t, r in rng.rand(20, 2) * 0.4:
        assert pkb.selection_penalty(t, r) == jkb.selection_penalty(t, r)
        assert pkb.selection_penalty(t, r, 0.1, 0.05) == jkb.selection_penalty(t, r, 0.1, 0.05)
    assert pkb.pose_available(poses[0]) and not pkb.pose_available(np.full((4, 4), -np.inf))


# ------------------------------------------------------------ tuple generation


@pytest.mark.parametrize("kind", TUPLE_TYPES)
@pytest.mark.parametrize("name", list(TRAJECTORIES))
def test_test_tuples_match_jax(name, kind):
    poses, ids, dists = trajectory(name)
    got = ptg.generate_test_tuples("scan", poses, ids, kind, 8, dists_to_last_valid=dists)
    assert got == jtg.generate_test_tuples("scan", poses, ids, kind, 8,
                                           dists_to_last_valid=dists)
    assert (len(got), short(got)) == LINE_COUNTS[name][kind]
    assert all(len(set(line.split(" ")[1:])) == len(line.split(" ")) - 1 for line in got)


@pytest.mark.parametrize("k", [2, 8])
@pytest.mark.parametrize("name", list(TRAJECTORIES))
def test_train_tuples_match_jax(name, k):
    poses, ids, _ = trajectory(name)
    got = ptg.generate_train_tuples("scan", poses, ids, k)
    assert got == jtg.generate_train_tuples("scan", poses, ids, k)
    assert got and all(len(line.split(" ")) == k + 1 for line in got)


def test_unknown_tuple_type_raises():
    poses, ids, _ = trajectory("40")
    with pytest.raises(ValueError, match="unknown frame_tuple_type"):
        ptg.generate_test_tuples("scan", poses, ids, "sparse", 8)


# ------------------------------------------------------------------- cropping


def figure(seed, h=40, w=60):
    """A white uint8 image with two coloured boxes (none for seed None)."""
    image = np.full((h, w, 3), 255, np.uint8)
    if seed is None:
        return image
    rng = np.random.RandomState(seed)
    for _ in range(2):
        y, x = rng.randint(0, h - 5), rng.randint(0, w - 5)
        image[y:y + rng.randint(2, 8), x:x + rng.randint(2, 10)] = rng.randint(0, 250, 3)
    return image


@pytest.mark.parametrize("seed", [0, 1, 2, None], ids=["s0", "s1", "s2", "white"])
def test_cropping_matches_jax(seed):
    image = figure(seed)
    assert pcrop.find_image_bounding_box(image) == jcrop.find_image_bounding_box(image)
    for pad in (0, 3):
        np.testing.assert_array_equal(pcrop.crop_to_content(image, pad),
                                      jcrop.crop_to_content(image, pad))
    images = [image, figure(7), figure(8)]
    for got, want in zip(pcrop.crop_images_to_shared_bounding_box(images),
                         jcrop.crop_images_to_shared_bounding_box(images)):
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------------ CLIs


@pytest.fixture(scope="module")
def scannet_root(tmp_path_factory):
    """Two ScanNet-layout scans at 128x96: scene_synth0 (96 frames, 40-71
    lost) and scene_synth1 (40 frames of another room, none lost), with the
    split file ``scans.txt``."""
    root = str(tmp_path_factory.mktemp("scannet"))
    CHIP_SMOKE.write_scannet_scan(root, "scene_synth0", 96, LOST, 128, 96, threads=2)
    CHIP_SMOKE.write_scannet_scan(root, "scene_synth1", 40, range(0), 128, 96, seed=1,
                                  threads=2)
    with open(os.path.join(root, "scans.txt"), "w") as f:
        f.write("scene_synth0\nscene_synth1\n")
    return root


def data_argv(root, out, split):
    return ["--dataset", "scannet", "--dataset_path", root, "--split", split,
            "--dataset_scan_split_file", os.path.join(root, "scans.txt"),
            "--tuple_info_file_location", out]


CLI_CASES = {
    **{f"test_{kind}": ("generate_test_tuples", "test", ["--frame_tuple_type", kind])
       for kind in TUPLE_TYPES},
    "train_8": ("generate_train_tuples", "train",
                ["--num_images_in_tuple", "8", "--mv_tuple_file_suffix", "_eight_view.txt"]),
    "train_2": ("generate_train_tuples", "train",
                ["--num_images_in_tuple", "2", "--mv_tuple_file_suffix", "_two_view.txt"]),
}
PORT_CLIS = {"generate_test_tuples": generate_test_tuples,
             "generate_train_tuples": generate_train_tuples}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_tuple_clis_match_jax(case, scannet_root, tmp_path, monkeypatch):
    script, split, extra = CLI_CASES[case]
    argv = extra + ["--num_workers", "1"]
    port_path = PORT_CLIS[script].main(data_argv(scannet_root, str(tmp_path / "p"), split)
                                       + argv)
    run_jax_script(script, data_argv(scannet_root, str(tmp_path / "j"), split) + argv,
                   monkeypatch)
    jax_path = str(tmp_path / "j" / os.path.relpath(port_path, tmp_path / "p"))
    with open(port_path, "rb") as f, open(jax_path, "rb") as g:
        got = f.read()
        assert got == g.read()
    lines = got.decode().splitlines()
    assert {line.split(" ")[0] for line in lines} == {"scene_synth0", "scene_synth1"}
    name = os.path.basename(port_path)
    kind = extra[1] if script == "generate_test_tuples" else None
    assert name == {None: f"train{extra[-1]}", "default": "test_eight_view_deepvmvs.txt"}.get(
        kind, f"test_eight_view_deepvmvs_{kind}.txt")
    # no lost frame is referenced
    ids = {int(i) for line in lines if line.startswith("scene_synth0")
           for i in line.split(" ")[1:]}
    assert ids and not ids & set(LOST)


def test_precompute_valid_frames_matches_jax(scannet_root, monkeypatch):
    files = [os.path.join(scannet_root, "scans_test", scan, "valid_frames.txt")
             for scan in ("scene_synth0", "scene_synth1")]
    written = {}
    for side in ("jax", "port"):
        for path in files:
            if os.path.exists(path):
                os.remove(path)
        argv = data_argv(scannet_root, scannet_root, "test")
        if side == "jax":
            run_jax_script("precompute_valid_frames", argv, monkeypatch)
        else:
            assert precompute_valid_frames.main(argv) == dict(
                zip(("scene_synth0", "scene_synth1"), files))
        written[side] = [pathlib.Path(path).read_bytes() for path in files]
    assert written["port"] == written["jax"]
    lines = written["port"][0].decode().splitlines()
    assert len(lines) == 96 - len(LOST)
    assert lines[40] == "scene_synth0 000072 32"


def test_test_tuple_pool_matches_in_process(scannet_root, tmp_path, monkeypatch):
    """--num_workers leaves the tuple file as it is: the scans run one after
    another in process, as in the JAX script (which takes the flag and
    starts no pool); the bytes equal at 1 and 2 workers and the JAX
    script's."""
    files = []
    for workers in ("1", "2"):
        files.append(generate_test_tuples.main(
            data_argv(scannet_root, str(tmp_path / workers), "test")
            + ["--frame_tuple_type", "dense", "--num_workers", workers]))
    run_jax_script("generate_test_tuples", data_argv(scannet_root, str(tmp_path / "j"), "test")
                   + ["--frame_tuple_type", "dense", "--num_workers", "2"], monkeypatch)
    texts = [pathlib.Path(p).read_bytes()
             for p in files + [str(tmp_path / "j" / os.path.basename(files[0]))]]
    assert texts[0] == texts[1] == texts[2]
    assert {line.split(" ")[0] for line in texts[0].decode().splitlines()} == {
        "scene_synth0", "scene_synth1"}


# ------------------------------------------------------------ weights and runs


@pytest.fixture(scope="module")
def tiny_variables():
    """JAX-package variables of the tiny 8-view hint model."""
    jopts = JaxOptions()
    for key, value in {**TINY, "dataset": "synthetic"}.items():
        setattr(jopts, key, value)
    ds = SyntheticDataset(split="test", image_height=32, image_width=64, tuple_size=8,
                          num_images_in_tuple=8)
    cur_np, src_np = collate([ds[0]])
    jmodel = jcommon.build_model(jopts)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), *jcommon.device_batch(cur_np,
                                                                                 src_np))
    return jax.tree_util.tree_map(np.asarray, variables)


def port_options(**extra):
    o = Options(device="cpu")
    for key, value in {**TINY, **extra}.items():
        setattr(o, key, value)
    return o


def assert_trees_equal(got, want):
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert sorted(map(str, flat_got)) == sorted(map(str, flat_want))
    for key, value in flat_want.items():
        np.testing.assert_array_equal(np.asarray(flat_got[key]), value, err_msg=str(key))


@pytest.mark.parametrize("cli", ["port", "jax"])
def test_stripped_checkpoint_loads_in_both(cli, tiny_variables, tmp_path, monkeypatch):
    """The port's CLI on a port training state (EfficientNetV2-S and the
    ResNet matching encoder, which the JAX package's .ckpt converter reads)
    and the JAX script on a JAX npz of the tiny model with optimizer state:
    both packages load the stripped weights, equal to the weights saved."""
    if cli == "port":
        opts = port_options(image_encoder_name="efficientnet", matching_encoder_type="resnet")
        model = common.init_or_load_params(opts, common.build_model(opts))
        state_dict = model.state_dict()
        # an optimizer with moments, which the strip must drop (lr 0: the
        # weights stay as they were)
        optimizer = torch.optim.Adam(model.parameters(), lr=0.0)
        for p in model.parameters():
            p.grad = torch.ones_like(p)
        optimizer.step()
        save_train_state(str(tmp_path / "checkpoints"), 7, model, optimizer)
        dst = strip_checkpoint.main(["--src", str(tmp_path / "checkpoints" / "step_00000007.pt"),
                                     "--dst", str(tmp_path / "weights.ckpt")])
        assert sorted(torch.load(dst, weights_only=True)) == ["state_dict"]
    else:
        opts = port_options()
        state_dict = variables_to_state_dict(tiny_variables)
        src, dst = str(tmp_path / "state.npz"), str(tmp_path / "weights.npz")
        jax_save_params(src, {**tiny_variables, "opt_state": {"mu": {"w": np.ones(3)}}})
        run_jax_script("strip_checkpoint", ["--src", src, "--dst", dst], monkeypatch)
        assert not [n for n in np.load(dst).files if n.startswith("opt_state")]
        assert_trees_equal(jax_load_params(dst), tiny_variables)
    opts.load_weights_from_checkpoint = dst
    loaded = common.init_or_load_params(opts, common.build_model(opts)).state_dict()
    assert sorted(loaded) == sorted(state_dict)
    for key, value in state_dict.items():
        assert torch.equal(loaded[key], value), key
    # the JAX package's variables of the stripped file, carried back
    # through the weights bridge: the same tensors
    bridged = variables_to_state_dict(jax_load_params(dst))
    assert bridged and set(bridged) <= set(state_dict)
    for key, value in bridged.items():
        assert torch.equal(value, state_dict[key]), key


def use_room_bounds(monkeypatch):
    """Both packages' fusers over the fixture room's bounds
    (``chip_smoke.RoomBounds``): the ScanNet reader has no GT bounds, so
    both would fuse a +-10 m cube, 8 GB at the forced 0.02 m; the room's
    304x200x152 keeps the comparison small."""
    from doubletake_tpu.runners import common as jcommon_runner

    room = CHIP_SMOKE.RoomBounds()
    for module in (common, jcommon_runner):
        bounds = module.scene_bounds_for_fusion
        monkeypatch.setattr(module, "scene_bounds_for_fusion",
                            lambda dataset, scan_id, max_extent=10.0, bounds=bounds:
                            bounds(room, scan_id))


def tuple_file(root, tmp_path, lines):
    out = tmp_path / "tuples"
    out.mkdir(exist_ok=True)
    (out / "test_kept.txt").write_text("\n".join(lines) + "\n")
    return str(out)


def eval_argv(root, tuples, weights, out):
    flags = []
    for key, value in TINY.items():
        if key not in ("num_workers",):
            flags += [f"--{key}", str(value)]
    return flags + [
        "--fast_cost_volume", "--dataset", "scannet", "--dataset_path", root, "--split", "test",
        "--tuple_info_file_location", tuples, "--mv_tuple_file_suffix", "_kept.txt",
        "--single_debug_scan_id", "scene_synth0", "--load_weights_from_checkpoint", weights,
        "--name", "eval", "--output_base_path", out, "--num_workers", "0"]


def default_lines(root):
    ds_opts = port_options(dataset="scannet", dataset_path=root, split="test")
    return generate_test_tuples.process_scan(ds_opts, "scene_synth0")


def test_evaluation_cli_matches_jax(scannet_root, tiny_variables, tmp_path, monkeypatch):
    """The evaluation CLI of each package over the fixture's first six
    8-frame default tuples, with the same weights: frame-averaged depth
    metrics within 1e-5 relative (plus 1e-6 absolute for metrics near 0),
    the same hint coverage to 1e-3, and the same voxels observed."""
    kept = [line for line in default_lines(scannet_root) if len(line.split(" ")) == 9][:6]
    tuples = tuple_file(scannet_root, tmp_path, kept)
    weights = str(tmp_path / "weights.npz")
    jax_save_params(weights, tiny_variables)
    use_room_bounds(monkeypatch)

    res = evaluation.main(eval_argv(scannet_root, tuples, weights, str(tmp_path / "p"))
                          + ["--device", "cpu"])
    run_jax_script("evaluation", eval_argv(scannet_root, tuples, weights, str(tmp_path / "j")),
                   monkeypatch)
    assert res["frames"] == 6
    scores = {}
    for side in ("p", "j"):
        base = tmp_path / side / "eval" / "incremental_default"
        with open(base / "scores" / "all_frame_avg_metrics.json") as f:
            scores[side] = json.load(f)["scores"]
        with np.load(base / "meshes" / "scene_synth0_tsdf.npz") as vol:
            scores[side]["observed"] = int((vol["tsdf_weights"] > 0).sum())
            scores[side]["dims"] = vol["tsdf_weights"].shape
    p, j = scores["p"], scores["j"]
    assert p["dims"] == j["dims"] == (304, 200, 152)
    for key in ("abs_diff", "abs_rel", "sq_rel", "rmse", "rmse_log", "a5", "a10", "a25"):
        assert np.isfinite(p[key])
        np.testing.assert_allclose(p[key], j[key], rtol=1e-5, atol=1e-6, err_msg=key)
    assert abs(p["hint_coverage"] - j["hint_coverage"]) <= 1e-3
    assert p["hint_coverage"] > 0
    assert abs(p["observed"] - j["observed"]) <= 1e-4 * j["observed"]


def test_short_tuple_fails_in_both(scannet_root, tiny_variables, tmp_path, monkeypatch):
    """A generated tuple of fewer than 8 frames cannot go through the 8-view
    model in either package: each raises at the feature volume's MLP (on
    the card the port's K1 wrapper refuses the MLP's width first)."""
    lines = default_lines(scannet_root)
    short_line = next(line for line in lines if len(line.split(" ")) < 9)
    tuples = tuple_file(scannet_root, tmp_path, [short_line])
    weights = str(tmp_path / "weights.npz")
    jax_save_params(weights, tiny_variables)
    use_room_bounds(monkeypatch)
    # 2 frames: one source view, 46 volume channels against the MLP's 202
    assert len(short_line.split(" ")) == 3
    with pytest.raises(RuntimeError, match=r"shapes cannot be multiplied \(1024x46 and 202x128\)"):
        evaluation.main(eval_argv(scannet_root, tuples, weights, str(tmp_path / "p"))
                        + ["--device", "cpu"])
    with pytest.raises(flax.errors.ScopeParamShapeError, match=r"\(46, 128\).*\(202, 128\)"):
        run_jax_script("evaluation", eval_argv(scannet_root, tuples, weights,
                                               str(tmp_path / "j")), monkeypatch)
