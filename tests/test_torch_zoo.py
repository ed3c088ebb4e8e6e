"""The rest of the model zoo: the port against the JAX package, on the CPU.

ResNet18D (the small DoubleTake config's image encoder) with the pools it
takes, the U-Net / FPN matching encoder (MnasNet100 + feature pyramid), the
dot-product cost volume, the small config end to end, and the weights bridge
both ways for the new modules. Inputs and weights come from numpy seeds
(``tests/test_torch_models.py``'s helpers: the JAX module's ``init`` tree
filled from numpy, carried into the port by ``variables_to_state_dict``).

Bounds: the pools are equal; float32 modules and models agree to 1e-5
relative (``REL``); ResNet18D in bf16 (the JAX package's per-op rounding)
is held to a quarter of the JAX package's own bf16-vs-float32 gap, the
budget of ``tests/test_torch_bf16.py``'s tiny bf16 model.
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from doubletake_tpu.checkpoints.convert import convert_state_dict
from doubletake_tpu.checkpoints.io import cast_floating as jax_cast
from doubletake_tpu.models import backbones as jb
from doubletake_tpu.models import cost_volume as jcv
from doubletake_tpu.models import layers as jl
from doubletake_tpu.models import unet_encoder as ju
from doubletake_tpu.options import OptionsHandler as JaxOptionsHandler
from doubletake_tpu.runners import common as jcommon

from doubletake_tpu_torch.checkpoints.convert import load_weights, variables_to_state_dict
from doubletake_tpu_torch.checkpoints.io import cast_floating
from doubletake_tpu_torch.models import backbones as tb
from doubletake_tpu_torch.models import cost_volume as tcv
from doubletake_tpu_torch.models import layers as tl
from doubletake_tpu_torch.models import unet_encoder as tu
from doubletake_tpu_torch.models.depth_model import DepthModel
from doubletake_tpu_torch.options import OptionsHandler
from doubletake_tpu_torch.runners import common

# the module fixture that imports torch._dynamo with the stubs set aside
from test_torch_training import RecordingWriter, dynamo_imported  # noqa: F401
from test_torch_models import (  # noqa: F401
    REL,
    jax_variables,
    load_port,
    model_batch,
    rel_err,
    t,
    volume_inputs,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_CONFIG = os.path.join(REPO, "configs", "models", "doubletake_small_model.yaml")


@pytest.fixture(autouse=True)
def few_torch_threads():
    """The tier runs several test processes at once: keep torch's CPU ops
    from oversubscribing the cores (the shapes here are small)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def nchw(x):
    return t(x).permute(0, 3, 1, 2)


# -------------------------------------------------------------------- pools


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw", [(7, 9), (8, 10)], ids=["odd", "even"])
@pytest.mark.parametrize("pool", ["max", "avg"])
def test_pools_equal_jax(pool, hw, dtype):
    """max_pool 3/2/1 (-inf padding) and avg_pool 2/2 (no padding, the sum
    over 4; bf16 sums in bf16 as XLA does): equal to the JAX package's."""
    x = (np.random.RandomState(1).randn(2, *hw, 5) * 3).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    px = nchw(x).to(getattr(torch, dtype))
    if pool == "max":
        ref, out = jl.max_pool(jx, 3, 2, 1), tl.max_pool(px, 3, 2, 1)
    else:
        ref, out = jl.avg_pool(jx, 2, 2), tl.avg_pool(px, 2, 2)
    ref = np.asarray(ref.astype(jnp.float32))
    out = out.permute(0, 2, 3, 1).float().numpy()
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


# ---------------------------------------------------------------- ResNet18D


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resnet18d(dtype):
    """Five features at strides 2-32 with channels (64, 64, 128, 256, 512).
    (An odd size at a stride-2 block gives the shortcut's pool one row
    fewer than the conv, in both packages.)"""
    x = np.random.RandomState(0).randn(1, 64, 96, 3).astype(np.float32)
    jm = jb.ResNet18D()
    v = jax_variables(jm, x)
    ref = jax.jit(jm.apply)(v, x)
    pm = load_port(tb.ResNet18D(), v, "encoder")
    assert tuple(pm.feature_channels) == tuple(jb.encoder_feature_channels("resnet18d"))
    if dtype == "float32":
        with torch.no_grad():
            out = pm(t(x))
        for o, r in zip(out, ref):
            assert o.shape == r.shape
            assert rel_err(o.numpy(), r) < REL
        return
    ref16 = jax.jit(jm.apply)(jax_cast(v, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16))
    pm = cast_floating(pm, torch.bfloat16)
    with torch.no_grad():
        out = pm(t(x).bfloat16())
    for o, r16, r32 in zip(out, ref16, ref):
        assert o.dtype == torch.bfloat16
        r16 = np.asarray(r16.astype(jnp.float32))
        jax_gap = np.percentile(np.abs(r16 - np.asarray(r32)), 99)
        port_gap = np.percentile(np.abs(o.float().numpy() - r16), 99)
        assert jax_gap > 0 and port_gap <= jax_gap / 4, (port_gap, jax_gap)


# ------------------------------------------------------ U-Net matching encoder


@pytest.fixture(scope="module")
def unet_case():
    """The JAX U-Net encoder's variables at an even and an odd input size."""
    xs = {hw: np.random.RandomState(4).randn(2, *hw, 3).astype(np.float32)
          for hw in ((64, 96), (52, 76))}
    jm = ju.UNetMatchingEncoder(16)
    return jm, jax_variables(jm, xs[(64, 96)], seed=2), xs


def test_mnasnet100(unet_case):
    """The backbone alone: five features, channels (16, 24, 40, 96, 320)."""
    _, v, xs = unet_case
    x = xs[(64, 96)]
    ref = ju.MnasNet100().apply({c: tree["encoder"] for c, tree in v.items()}, x)
    pm = load_port(tu.UNetMatchingEncoder(16), v, "matching_model").encoder
    with torch.no_grad():
        out = pm.forward_nchw(nchw(x))
    assert [o.shape[1] for o in out] == list(ju.MnasNet100.feature_channels)
    for o, r in zip(out, ref):
        o = o.permute(0, 2, 3, 1).numpy()
        assert o.shape == r.shape
        assert rel_err(o, r) < REL


def test_feature_pyramid_on_odd_sizes():
    """Odd-sized levels, one of them more than half its finer neighbour
    (8 rows under 13): the top-down step repeats and crops, as the JAX
    package computes it, where torchvision's ``F.interpolate(size=...)``
    would pick other rows. (On the ceil-halving pyramid of strided convs
    the two agree.)"""
    rng = np.random.RandomState(3)
    sizes = [(13, 19), (8, 10), (4, 5), (2, 3), (1, 2)]
    chans = (6, 8, 10, 12, 14)
    feats = [rng.randn(1, h, w, c).astype(np.float32) for (h, w), c in zip(sizes, chans)]
    jm = ju.FeaturePyramid(out_channels=8)
    v = jax_variables(jm, feats, seed=4)
    ref = jm.apply(v, feats)
    pm = tu.FeaturePyramid(chans, 8)
    sd = {}
    for i in range(5):
        for src, dst in (("inner", "inner_blocks"), ("layer", "layer_blocks")):
            node = v["params"][f"{src}_{i}"]
            sd[f"{dst}.{i}.0.weight"] = t(np.asarray(node["kernel"]).transpose(3, 2, 0, 1))
            sd[f"{dst}.{i}.0.bias"] = t(np.asarray(node["bias"]))
    pm.load_state_dict(sd)
    with torch.no_grad():
        out = pm([nchw(f) for f in feats])
    for o, r in zip(out, ref):
        assert rel_err(o.permute(0, 2, 3, 1).numpy(), r) < REL
    # the sizes are ones where the two upsamplings differ
    coarse = torch.arange(8 * 10, dtype=torch.float32).reshape(1, 1, 8, 10)
    repeat = coarse.repeat_interleave(2, 2).repeat_interleave(2, 3)[:, :, :13, :19]
    assert not torch.equal(repeat, F.interpolate(coarse, size=(13, 19), mode="nearest"))


@pytest.mark.parametrize("hw", [(64, 96), (52, 76)], ids=["even", "odd"])
def test_unet_matching_encoder(unet_case, hw):
    jm, v, xs = unet_case
    ref = np.asarray(jm.apply(v, xs[hw]))
    pm = load_port(tb.get_matching_encoder("unet"), v, "matching_model")
    assert isinstance(tb.get_matching_encoder("fpn"), tu.UNetMatchingEncoder)
    with torch.no_grad():
        out = pm(t(xs[hw])).numpy()
    assert out.shape == ref.shape == (2, hw[0] // 4, hw[1] // 4, 16)
    assert rel_err(out, ref) < REL


# ------------------------------------------------------------- dot volume


def test_cost_volume_dot():
    """The masked dot volume and its argmax plane, float32."""
    a = volume_inputs(seed=5)
    args = (a["cur"], a["src"], a["src_T_cur"], a["cur_T_src"], a["src_K"], a["cur_invK"])
    jm = jcv.CostVolumeDot(num_depth_bins=8, plane_chunk=4)
    jvol, jlow, jplanes, jmask = jm.apply({}, *map(jnp.asarray, args), 0.25, 5.0,
                                          return_mask=True)
    pm = tcv.get_volume_class("simple_cost_volume")(num_depth_bins=8, plane_chunk=4)
    with torch.no_grad():
        vol, low, planes, mask = pm(*map(t, args), 0.25, 5.0, return_mask=True)
    assert jmask is None and mask is None
    assert vol.shape == (1, 8, 12, 8)
    assert rel_err(vol.numpy(), jvol) < REL
    np.testing.assert_allclose(low.numpy(), np.asarray(jlow), rtol=2e-7, atol=0)


def test_depth_model_with_the_dot_volume():
    """SimpleRecon's DepthModel with ``simple_cost_volume``: s0 depth and
    lowest-cost depths against JAX; the mask output is None."""
    cur, src, _ = model_batch(seed=1)
    kw = dict(image_encoder_name="tiny", matching_encoder_type="tiny",
              depth_decoder_name="skip", feature_volume_type="simple_cost_volume",
              matching_num_depth_bins=16, plane_chunk=8, model_num_views=3)
    from doubletake_tpu.models.depth_model import DepthModel as JaxDepthModel

    jm = JaxDepthModel(**kw)
    v = jax_variables(jm, cur, src, seed=6)
    ref = jax.jit(lambda v_, c, s: jm.apply(v_, c, s, return_mask=True))(v, cur, src)
    pm = DepthModel(**kw)
    pm.load_state_dict(variables_to_state_dict(v))
    assert not any(k.startswith("cost_volume.") for k in pm.state_dict())
    with torch.no_grad():
        out = pm.eval()({k: t(x) for k, x in cur.items()}, {k: t(x) for k, x in src.items()},
                        return_mask=True)
    assert ref["overall_mask_bhw"] is None and out["overall_mask_bhw"] is None
    assert rel_err(out["depth_pred_s0_bhw1"].numpy(), ref["depth_pred_s0_bhw1"]) < REL
    np.testing.assert_allclose(out["lowest_cost_bhw"].numpy(), np.asarray(ref["lowest_cost_bhw"]),
                               rtol=2e-7, atol=0)


# -------------------------------------------------------- the small config


def small_options(handler):
    opts = handler.load_options_from_yaml(SMALL_CONFIG)
    opts.device = "cpu"
    return opts


@pytest.fixture(scope="module")
def small_model():
    """configs/models/doubletake_small_model.yaml built by both packages (8
    views, 64 planes: the model's own widths) with one set of weights."""
    jopts = small_options(JaxOptionsHandler)
    popts = small_options(OptionsHandler)
    jm = jcommon.build_model(jopts)
    cur, src, hint = model_batch(seed=2)
    cur, src = small_batch(cur, src, jopts.model_num_views - 1)
    v = jax_variables(jm, cur, src, seed=7)
    return jm, v, popts, cur, src, hint


def small_batch(cur, src, k):
    """``model_batch`` with ``k`` source views (more poses along its path)."""
    def pose(i):
        T = np.eye(4, dtype=np.float32)
        T[0, 3], T[1, 3] = 0.1 * i, 0.03 * i
        return T

    rng = np.random.RandomState(9)
    src = dict(src)
    h, w = cur["image_bhw3"].shape[1:3]
    src["image_bkhw3"] = rng.randn(1, k, h, w, 3).astype(np.float32)
    src["cam_T_world_bk44"] = np.stack([pose(i + 1) for i in range(k)])[None]
    src["world_T_cam_bk44"] = np.linalg.inv(src["cam_T_world_bk44"]).astype(np.float32)
    src["K_s1_bk44"] = np.repeat(src["K_s1_bk44"][:, :1], k, 1)
    return cur, src


def test_small_config_s0_depth(small_model):
    """The small DoubleTake (ResNet18D, ResNet matching encoder, hint volume,
    skip decoder on ResNet18D's channels) with a hint: s0 depth, the other
    scales and the mask against JAX, float32."""
    jm, v, popts, cur, src, hint = small_model
    ref = jax.jit(lambda v_, c, s, h: jm.apply(v_, c, s, hint=h, return_mask=True))(
        v, cur, src, hint)
    pm = common.build_model(popts)
    assert isinstance(pm.encoder, tb.ResNet18D)
    assert type(pm.depth_decoder).__name__ == "SkipDecoderRegression"
    # the skip decoder on ResNet18D's stride-2 level (64) and the CV encoder's
    dec = pm.depth_decoder
    assert dec.block1.pre_concat_conv.conv1.in_channels == 384
    assert dec.block4.post_concat_conv.conv1.in_channels == 64 + 64
    pm.load_state_dict(variables_to_state_dict(v))
    with torch.no_grad():
        out = pm({k: t(x) for k, x in cur.items()}, {k: t(x) for k, x in src.items()},
                 hint={k: t(x) for k, x in hint.items()}, return_mask=True)
    for key in ("depth_pred_s0_bhw1", "depth_pred_s1_bhw1", "depth_pred_s3_bhw1"):
        assert out[key].shape == ref[key].shape
        assert rel_err(out[key].numpy(), ref[key]) < REL, key
    np.testing.assert_array_equal(out["overall_mask_bhw"].numpy(),
                                  np.asarray(ref["overall_mask_bhw"]))


def port_model_of(kind):
    """A port model with random weights (the seeded initialisation): the
    small config, or the small config with the U-Net matching encoder."""
    opts = small_options(OptionsHandler)
    if kind == "unet":
        opts.matching_encoder_type = "unet"
    model = common.build_model(opts)
    generator = torch.Generator().manual_seed(3)
    tl.init_parameters(model, generator)
    with torch.no_grad():
        for name, buf in model.named_buffers():     # statistics that matter
            if name.endswith(("running_mean", "running_var")):
                buf.copy_(torch.rand(buf.shape, generator=generator) + 0.5)
    return model


@pytest.mark.parametrize("kind", ["small", "unet"])
def test_bridge_both_ways(kind):
    """The port's state_dict -> the JAX package's converter -> the bridge
    back: every entry bit for bit, and the JAX tree is the one the JAX
    model's ``init`` makes."""
    model = port_model_of(kind)
    sd = model.state_dict()
    variables = convert_state_dict({k: x.numpy() for k, x in sd.items()})
    back = variables_to_state_dict(variables)
    assert set(back) == set(sd)
    for k, x in back.items():
        assert k.endswith("num_batches_tracked") or torch.equal(x, sd[k]), k

    jopts = small_options(JaxOptionsHandler)
    if kind == "unet":
        jopts.matching_encoder_type = "unet"
    cur, src, _ = model_batch()
    cur, src = small_batch(cur, src, jopts.model_num_views - 1)
    jm = jcommon.build_model(jopts)
    shapes = jax.eval_shape(lambda key: jm.init(key, cur, src), jax.random.PRNGKey(0))
    for coll in ("params", "batch_stats"):
        want = jax.tree_util.tree_leaves_with_path(shapes[coll])
        got = jax.tree_util.tree_leaves_with_path(variables[coll])
        assert [p for p, _ in got] == [p for p, _ in want]
        for (p, x), (_, s) in zip(got, want):
            assert np.asarray(x).shape == s.shape, p


def test_old_fpn_layout_loads(tmp_path):
    """A reference checkpoint from torchvision before 0.13 names the FPN's
    convs ``{inner,layer}_blocks.{i}``: ``load_weights`` maps them on."""
    model = port_model_of("unet")
    sd = model.state_dict()
    old = {k.replace(".0.weight", ".weight").replace(".0.bias", ".bias")
           if "_blocks." in k else k: v for k, v in sd.items()}
    assert "matching_model.decoder.inner_blocks.0.weight" in old
    torch.save({"state_dict": old}, str(tmp_path / "old.ckpt"))
    loaded = load_weights(str(tmp_path / "old.ckpt"))
    assert sorted(loaded) == sorted(sd)
    for k in sd:
        assert torch.equal(loaded[k], sd[k]), k


# --------------------------------------------- the small config's paths


def small_run_options(tmp_path, **extra):
    """The small config's own widths (8 views, 64 planes) at 64x32 images."""
    opts = small_options(OptionsHandler)
    for k, v in dict(dataset="synthetic", image_width=64, image_height=32,
                     output_base_path=str(tmp_path), num_workers=0, raycast_samples=64,
                     fusion_resolution=0.04, extended_neg_truncation=True,
                     fast_cost_volume=True, run_fusion=True, **extra).items():
        setattr(opts, k, v)
    return opts


@pytest.mark.parametrize("name", ["incremental", "offline_two_pass", "revisit"])
def test_small_config_hint_runners(name, tmp_path, monkeypatch):
    """Every hint runner runs the small config over a 12-frame scan: finite
    metrics, a hint that engages, the scan's mesh."""
    import importlib

    from doubletake_tpu_torch.datasets import registry

    module = importlib.import_module(f"doubletake_tpu_torch.runners.{name}")
    monkeypatch.setattr(module, "dataset_from_opts",
                        lambda *a, **k: registry.dataset_from_opts(*a, num_frames=12, **k))
    extra = {"incremental": dict(batch_size=1), "offline_two_pass": dict(batch_size=4),
             "revisit": dict(batch_size=4, single_debug_scan_id="synth0@1")}[name]
    res = module.run(small_run_options(tmp_path, name=name, **extra))
    assert res["frames"] == 5
    fa = res["frame_avg"]
    for key in ("abs_diff", "abs_rel", "a5", "frame_time", "hint_coverage"):
        assert np.isfinite(fa[key]), key
    assert fa["hint_coverage"] > 0
    scan = extra.get("single_debug_scan_id", "synth0")
    assert res["meshes"][scan]["faces"] > 0


def test_small_config_trains_at_precision_16(tmp_path, monkeypatch):
    """train() for 2 steps at the config's precision 16 (bf16 compute on
    float32 master weights) with validation: finite losses, checkpoints."""
    from doubletake_tpu_torch.training import train_loop

    monkeypatch.setattr(train_loop, "_make_writer", lambda log_dir: RecordingWriter())
    opts = small_run_options(tmp_path, name="small_train", log_dir=str(tmp_path), batch_size=2,
                             max_steps=2, val_interval=2, val_batches=1, val_batch_size=2,
                             log_interval=1, image_log_interval=10 ** 9)
    assert opts.precision == 16 and opts.fill_depth_hints
    res = train_loop.train(opts)
    assert res["step"] == 2
    assert all(np.isfinite(v) for v in res["losses"].values())
    assert (tmp_path / "small_train" / "checkpoints" / "step_00000002.pt").exists()
    assert {p.dtype for p in res["model"].parameters()} == {torch.float32}
