"""The no-hint mode: the port's batched forward against the JAX package's,
and the port's runner end to end, on the CPU.

The tiny CI configuration (tests/test_torch_incremental.py) at batch 2:
SimpleRecon (``DepthModel``, metadata feature volume) and DoubleTake fed an
all-invalid hint, each with the JAX initialisation carried over by the
weights bridge. Bound: s0 depth relative max error < 1e-4.
"""

import numpy as np
import pytest
import torch

import jax

from doubletake_tpu.data.loader import collate
from doubletake_tpu.datasets.synthetic import SyntheticDataset
from doubletake_tpu.options import Options as JaxOptions
from doubletake_tpu.runners import common as jcommon

from doubletake_tpu_torch.checkpoints.convert import variables_to_state_dict
from doubletake_tpu_torch.datasets import registry
from doubletake_tpu_torch.options import Options
from doubletake_tpu_torch.runners import common, no_hint
from doubletake_tpu_torch.utils import tracing

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


@pytest.mark.parametrize("extra", [SIMPLERECON, {}], ids=["simplerecon", "empty_hint"])
def test_batched_forward_matches_jax(extra):
    jopts = options(JaxOptions, **extra)
    popts = options(Options, device="cpu", **extra)
    ds = SyntheticDataset(split="test", image_height=32, image_width=64, tuple_size=2,
                          num_images_in_tuple=2, num_frames=6)
    cur_np, src_np = collate([ds[1], ds[3]])
    use_hint = "hint" in jopts.feature_volume_type

    jmodel = jcommon.build_model(jopts)
    cur, src = jcommon.device_batch(cur_np, src_np)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), cur, src)
    fwd = jcommon.make_forward_fn(jmodel, use_hint=use_hint)
    if use_hint:
        zero = np.zeros((2, 32, 64, 1), np.float32)
        jout = fwd(variables, cur, src, {"depth_hint_bhw1": zero,
                                         "hint_mask_bhw1": zero.astype(bool),
                                         "sampled_weights_bhw1": zero})
    else:
        jout = fwd(variables, cur, src)

    pmodel = common.build_model(popts)
    pmodel.load_state_dict(variables_to_state_dict(jax.device_get(variables)))
    pcur, psrc = common.device_batch(cur_np, src_np, "cpu")
    hint = common.empty_hint(2, 32, 64, "cpu") if use_hint else None
    with torch.no_grad():
        pout = pmodel(pcur, psrc, hint=hint, return_mask=True)
    a = pout["depth_pred_s0_bhw1"].numpy()
    b = np.asarray(jout["depth_pred_s0_bhw1"])
    assert a.shape == b.shape == (2, 16, 32, 1)
    assert np.abs(a - b).max() / np.abs(b).max() < 1e-4
    np.testing.assert_array_equal(pout["overall_mask_bhw"].numpy(), np.asarray(jout["overall_mask_bhw"]))


def test_run_on_cpu(tmp_path, monkeypatch):
    """SimpleRecon over a 12-frame scan (5 tuples, batches of 2, 2 and 1):
    scores, the depth cache and the fused volume; the cached depths are the
    model's depths for those batches."""
    monkeypatch.setattr(no_hint, "dataset_from_opts",
                        lambda *a, **k: registry.dataset_from_opts(*a, num_frames=12, **k))
    o = options(Options, device="cpu", name="nh", output_base_path=str(tmp_path),
                run_fusion=True, cache_depths=True, **SIMPLERECON)
    model = common.init_or_load_params(o, common.build_model(o))
    def kernel_launches():
        return {k: v for k, v in tracing.counters().items() if k.endswith(".launches")}

    launches = kernel_launches()
    res = no_hint.run(o, model=model)
    assert kernel_launches() == launches   # the CPU launches no kernel
    assert res["frames"] == 5 and res["scan_time"] > 0
    fa = res["frame_avg"]
    for key in ("abs_diff", "abs_rel", "a5", "frame_time", "model_time"):
        assert np.isfinite(fa[key]), key
    assert 0.0 < fa["abs_rel"] < 50.0

    base = tmp_path / "nh" / "no_hint_default"
    for name in ("all_frame_avg_metrics.json", "scene_avg_metrics.json", "synth0_metrics.json"):
        assert (base / "scores" / name).exists(), name
    vol = np.load(base / "meshes" / "synth0_tsdf.npz")
    assert vol["tsdf_weights"].max() > 0
    cache = np.load(base / "depth_cache" / "synth0_depths.npz")
    assert list(cache["frame_ids"]) == ["7", "8", "9", "10", "11"]
    ds = registry.dataset_from_opts(o, split=o.split, limit_to_scan_id="synth0", num_frames=12)
    with torch.no_grad():
        want = [model(*common.device_batch(*collate([ds[i] for i in idx]), "cpu"),
                      return_mask=True)["depth_pred_s0_bhw1"].numpy()
                for idx in ((0, 1), (2, 3), (4,))]
    np.testing.assert_array_equal(cache["depths"], np.concatenate(want))
