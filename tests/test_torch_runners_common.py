"""The port's shared runner pieces against the JAX package's, on the CPU:
the lazy (tolerant) weight load, the hint-volume fuser, and the serving
options ``raycast_mip``, ``split_timing`` and ``dump_depth_visualization``.

Lazy load: a JAX npz of another initialisation with one layer's shape
changed is merged over the same starting weights by both packages; every
entry of the port's state dict must equal the bridge's conversion of the
JAX merge, bit for bit.
"""

import os

import numpy as np
import pytest
import torch

import jax

from doubletake_tpu.checkpoints.io import lazy_load_params, load_params, save_params
from doubletake_tpu.data.loader import collate
from doubletake_tpu.datasets.synthetic import SyntheticDataset
from doubletake_tpu.options import Options as JaxOptions
from doubletake_tpu.runners import common as jcommon

from doubletake_tpu_torch.checkpoints.convert import (
    lazy_load_state_dict,
    load_weights,
    variables_to_state_dict,
)
from doubletake_tpu_torch.datasets import registry
from doubletake_tpu_torch.options import Options
from doubletake_tpu_torch.runners import common, incremental, no_hint, offline_two_pass, revisit

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


def test_lazy_load_matches_jax(tmp_path):
    jopts = options(JaxOptions)
    ds = SyntheticDataset(split="test", image_height=32, image_width=64, tuple_size=2,
                          num_images_in_tuple=2, num_frames=4)
    cur, src = jcommon.device_batch(*collate([ds[0]]))
    jmodel = jcommon.build_model(jopts)
    init = jax.jit(jmodel.init)
    start = jax.device_get(init(jax.random.PRNGKey(0), cur, src))
    ckpt = jax.device_get(init(jax.random.PRNGKey(1), cur, src))
    kernel = ckpt["params"]["matching_model"]["conv1"]["kernel"]
    ckpt["params"]["matching_model"]["conv1"]["kernel"] = np.concatenate(
        [kernel, kernel[..., :1]], -1)                       # one more output channel
    path = str(tmp_path / "ckpt.npz")
    save_params(path, ckpt)
    expected = variables_to_state_dict(lazy_load_params(start, load_params(path)))

    model = common.build_model(options(Options, device="cpu"))
    model.load_state_dict(variables_to_state_dict(start))
    kept = lazy_load_state_dict(model, load_weights(path))
    assert kept == ["matching_model.conv1.weight"]
    got = model.state_dict()
    assert set(got) == set(expected)
    for name, value in expected.items():
        assert torch.equal(got[name], value), name
    assert not torch.equal(got["matching_model.conv0.weight"],
                           variables_to_state_dict(start)["matching_model.conv0.weight"])

    # through the option: the checkpoint's matching entries over the seeded
    # initialisation, which the mismatched layer keeps
    fresh = common.init_or_load_params(options(Options, device="cpu"),
                                       common.build_model(options(Options, device="cpu")))
    lazy = common.init_or_load_params(
        options(Options, device="cpu", lazy_load_weights_from_checkpoint=path),
        common.build_model(options(Options, device="cpu")))
    for name, value in lazy.state_dict().items():
        want = fresh.state_dict()[name] if name in kept else expected[name]
        assert torch.equal(value, want), name


def test_hint_fuser_matches_jax():
    ds = SyntheticDataset(split="test", image_height=32, image_width=64, num_frames=4)
    jtsdf, jcfg = jcommon.make_hint_fuser(options(JaxOptions), ds, "synth0")
    ptsdf, pcfg = common.make_hint_fuser(options(Options, device="cpu"), ds, "synth0", "cpu")
    assert ptsdf.dims == tuple(jtsdf.dims) and ptsdf.voxel_size == jtsdf.voxel_size == 0.04
    np.testing.assert_array_equal(ptsdf.origin.numpy(), np.asarray(jtsdf.origin))
    assert (pcfg.min_depth, pcfg.max_depth, pcfg.extended_neg_truncation) == \
        (jcfg.min_depth, jcfg.max_depth, jcfg.extended_neg_truncation) == (0.5, 3.0, True)


def short_dataset(*a, **k):
    return registry.dataset_from_opts(*a, num_frames=12, **k)


def saved_run(module, opts, model, tmp_path, monkeypatch):
    """One run of ``module`` over the 12-frame scan: its result and the
    volumes it saved (values, weights), by scan."""
    monkeypatch.setattr(module, "dataset_from_opts", short_dataset)
    res = module.run(opts, model=model)
    vols = {}
    for path in sorted(tmp_path.glob(f"{opts.name}/*/meshes/*_tsdf.npz")):
        with np.load(path) as f:
            vols[path.name] = (f["tsdf_values"], f["tsdf_weights"])
    assert vols
    return res, vols


def depth_metrics(row):
    return {k: v for k, v in row.items() if not k.endswith("_time")}


EXTRA = {
    "incremental": dict(batch_size=1),
    "no_hint": dict(model_type="depth_model", feature_volume_type="mlp_feature_volume"),
    "offline_two_pass": {},
    "revisit": dict(single_debug_scan_id="synth0@1"),
}


@pytest.mark.parametrize("runner", [incremental, no_hint, offline_two_pass, revisit],
                         ids=lambda m: m.__name__.split(".")[-1])
def test_raycast_mip(runner, tmp_path, monkeypatch):
    """Only the incremental runner reads ``raycast_mip``, as in the JAX
    package: its hints take the mip march and its run matches the JAX
    incremental run with the option (same weights, the 12-frame scan; the
    bounds of tests/test_torch_incremental.py's chained step). The other
    runners give the same outputs with and without it."""
    name = runner.__name__.split(".")[-1]
    kw = dict(EXTRA[name], run_fusion=True, output_base_path=str(tmp_path))
    popts = options(Options, device="cpu", name="mip", raycast_mip=True, **kw)
    ds = short_dataset(popts, split="test", limit_to_scan_id="synth0")
    model = common.build_model(popts)
    if name != "incremental":
        model = common.init_or_load_params(popts, model)
        res, vols = saved_run(runner, popts, model, tmp_path, monkeypatch)
        off = options(Options, device="cpu", name="plain", **kw)
        res0, vols0 = saved_run(runner, off, model, tmp_path, monkeypatch)
        assert depth_metrics(res["frame_avg"]) == depth_metrics(res0["frame_avg"])
        for scan, (values, weights) in vols0.items():
            np.testing.assert_array_equal(vols[scan][0], values)
            np.testing.assert_array_equal(vols[scan][1], weights)
        return

    from doubletake_tpu.datasets import registry as jregistry
    from doubletake_tpu.runners import incremental as jincremental

    jopts = options(JaxOptions, name="jax", raycast_mip=True, **kw)
    jmodel = jcommon.build_model(jopts)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     *jcommon.device_batch(*collate([ds[0]])))
    model.load_state_dict(variables_to_state_dict(jax.device_get(variables)))
    monkeypatch.setattr(jincremental, "dataset_from_opts",
                        lambda *a, **k: jregistry.dataset_from_opts(*a, num_frames=12, **k))
    jres = jincremental.run(jopts, variables=variables)
    mip_calls = []
    render_hint = common.render_hint

    def recording_render_hint(*a, use_mip=False, **k):
        mip_calls.append(use_mip)
        return render_hint(*a, use_mip=use_mip, **k)

    monkeypatch.setattr(common, "render_hint", recording_render_hint)
    res, vols = saved_run(runner, popts, model, tmp_path, monkeypatch)
    assert mip_calls and all(mip_calls) and len(mip_calls) == res["frames"]
    jfa, fa = jres["frame_avg"], res["frame_avg"]
    assert fa["hint_coverage"] > 0 and abs(fa["hint_coverage"] - jfa["hint_coverage"]) <= 0.01
    for key in ("abs_diff", "abs_rel", "rmse"):
        assert abs(fa[key] - jfa[key]) <= 1e-4 * abs(jfa[key]), key
    with np.load(tmp_path / "jax" / "incremental_default" / "meshes" / "synth0_tsdf.npz") as f:
        jvalues, jweights = f["tsdf_values"], f["tsdf_weights"]
    values, weights = vols["synth0_tsdf.npz"]
    dv = np.abs(values.astype(np.float32) - jvalues.astype(np.float32))
    assert float((dv > 1e-3).mean()) <= 1e-4
    np.testing.assert_allclose(weights.astype(np.float64).sum(),
                               jweights.astype(np.float64).sum(), rtol=1e-4)


@pytest.mark.parametrize("runner", [incremental, no_hint, offline_two_pass, revisit],
                         ids=lambda m: m.__name__.split(".")[-1])
def test_depth_visualization(runner, tmp_path, monkeypatch):
    """Only the incremental runner reads ``dump_depth_visualization``, as in
    the JAX package: over the 12-frame scan it writes one panel a frame
    under ``<base>/viz``, with the JAX incremental run's names, and each
    panel (image, GT, prediction, hint) within one 8-bit level of the JAX
    run's on all but 1e-3 of its values (the depths agree to the chained
    step's bounds, and a hint pixel's validity may flip). The other runners
    give the same outputs with and without it and write no panel."""
    from PIL import Image

    name = runner.__name__.split(".")[-1]
    kw = dict(EXTRA[name], run_fusion=True, output_base_path=str(tmp_path))
    popts = options(Options, device="cpu", name="viz", dump_depth_visualization=True, **kw)
    ds = short_dataset(popts, split="test", limit_to_scan_id="synth0")
    model = common.build_model(popts)
    if name != "incremental":
        model = common.init_or_load_params(popts, model)
        res, vols = saved_run(runner, popts, model, tmp_path, monkeypatch)
        off = options(Options, device="cpu", name="plain", **kw)
        res0, vols0 = saved_run(runner, off, model, tmp_path, monkeypatch)
        assert depth_metrics(res["frame_avg"]) == depth_metrics(res0["frame_avg"])
        for scan, (values, weights) in vols0.items():
            np.testing.assert_array_equal(vols[scan][0], values)
            np.testing.assert_array_equal(vols[scan][1], weights)
        assert not list(tmp_path.glob("viz/*/viz"))
        return

    from doubletake_tpu.datasets import registry as jregistry
    from doubletake_tpu.runners import incremental as jincremental

    jopts = options(JaxOptions, name="jax", dump_depth_visualization=True, **kw)
    jmodel = jcommon.build_model(jopts)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     *jcommon.device_batch(*collate([ds[0]])))
    model.load_state_dict(variables_to_state_dict(jax.device_get(variables)))
    monkeypatch.setattr(jincremental, "dataset_from_opts",
                        lambda *a, **k: jregistry.dataset_from_opts(*a, num_frames=12, **k))
    jincremental.run(jopts, variables=variables)
    res, _ = saved_run(runner, popts, model, tmp_path, monkeypatch)
    jdir = tmp_path / "jax" / "incremental_default" / "viz"
    pdir = tmp_path / "viz" / "incremental_default" / "viz"
    names = sorted(os.listdir(pdir))
    assert names == sorted(os.listdir(jdir)) and len(names) == res["frames"] > 1
    for png in names:
        a = np.asarray(Image.open(jdir / png)).astype(int)
        b = np.asarray(Image.open(pdir / png)).astype(int)
        assert a.shape == b.shape == (2 * 32, 2 * 64, 3), png      # image, GT / pred, hint
        assert float((np.abs(a - b) > 1).mean()) <= 1e-3, png


def test_split_timing(tmp_path, monkeypatch):
    """``split_timing``: every frame's depths (its depth metrics) and the
    volume equal the fused run's, and each frame has finite host-clock
    hint, model and fuse times."""
    kw = dict(batch_size=1, run_fusion=True, output_base_path=str(tmp_path))
    fused_opts = options(Options, device="cpu", name="fused", **kw)
    model = common.init_or_load_params(fused_opts, common.build_model(fused_opts))
    fused, fused_vols = saved_run(incremental, fused_opts, model, tmp_path, monkeypatch)
    split, split_vols = saved_run(incremental, options(Options, device="cpu", name="split",
                                                       split_timing=True, **kw),
                                  model, tmp_path, monkeypatch)
    assert split["frames"] == fused["frames"] == len(split["frame_rows"]) > 1
    for a, b in zip(split["frame_rows"], fused["frame_rows"]):
        assert depth_metrics(a) == depth_metrics(b)
        for key in ("hint_time", "model_time", "fuse_time"):
            assert np.isfinite(a[key]) and a[key] > 0, key
    for scan, (values, weights) in fused_vols.items():
        np.testing.assert_array_equal(split_vols[scan][0], values)
        np.testing.assert_array_equal(split_vols[scan][1], weights)
