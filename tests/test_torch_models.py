"""Module parity: the PyTorch port against the JAX package, on the CPU.

Inputs and weights are made with numpy from a seed — the weights fill the
tree of the JAX module's ``init`` (batch-norm statistics random too, so they
matter) — and reach the port through ``variables_to_state_dict``, the
weights bridge. Every module is
float32 on both sides, so the bound is ~1e-5 relative to the activation
scale (a few ulps of accumulated rounding per layer; the deepest stack,
EfficientNetV2-S, lands near 1e-6).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from doubletake_tpu.checkpoints.convert import convert_state_dict
from doubletake_tpu.models import backbones as jb
from doubletake_tpu.models import cost_volume as jcv
from doubletake_tpu.models import decoders as jd
from doubletake_tpu.models import layers as jl
from doubletake_tpu.models.depth_model import DepthModelCVHint as JaxDepthModelCVHint

from doubletake_tpu_torch.checkpoints.convert import variables_to_state_dict
from doubletake_tpu_torch.models import backbones as tb
from doubletake_tpu_torch.models import cost_volume as tcv
from doubletake_tpu_torch.models import decoders as td
from doubletake_tpu_torch.models import layers as tl
from doubletake_tpu_torch.models.depth_model import DepthModelCVHint, get_model_class

REL = 1e-5


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def numpy_variables(shapes, seed):
    """Values for a variables tree of ``model.init``'s shapes, from numpy:
    lecun-normal kernels, small biases, BN scale/var in [0.5, 1.5)."""
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            x = rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name in ("scale", "var"):
            x = rng.rand(*s.shape) + 0.5
        else:                                   # bias, mean
            x = rng.randn(*s.shape) * 0.1
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_variables(module, *args, seed=0, **kwargs):
    """``module.init``'s variables tree (traced with eval_shape: no compile)
    filled from numpy."""
    init = lambda key: module.init(key, *args, **kwargs)  # noqa: E731
    return numpy_variables(jax.eval_shape(init, jax.random.PRNGKey(0)), seed)


@pytest.fixture(autouse=True)
def few_torch_threads():
    """The tier runs several test processes at once: keep torch's CPU ops
    from oversubscribing the cores (the shapes here are tiny)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def load_port(module, variables, prefix):
    """Bridge JAX variables of one submodule into a port module."""
    wrapped = {c: {prefix: t} for c, t in variables.items()}
    sd = variables_to_state_dict(wrapped)
    module.load_state_dict({k[len(prefix) + 1:]: v for k, v in sd.items()})
    return module.eval()


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ------------------------------------------------------------------ layers


@pytest.mark.parametrize("inp,planes,stride", [(8, 8, 1), (8, 16, 1), (8, 16, 2)])
def test_basic_block(inp, planes, stride):
    x = np.random.RandomState(1).randn(2, 12, 16, inp).astype(np.float32)
    jm = jl.BasicBlock(planes, stride)
    v = jax_variables(jm, x, seed=stride)
    ref = np.asarray(jm.apply(v, x))
    # BasicBlock sits inside the CVEncoder tree in the bridge's naming
    sd = variables_to_state_dict({"params": {"cost_volume_net": {"ds_conv_0": v["params"]}}})
    pm = tl.BasicBlock(inp, planes, stride)
    pm.load_state_dict({k.replace("cost_volume_net.convs.ds_conv_0.", ""): w for k, w in sd.items()})
    with torch.no_grad():
        out = pm(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert rel_err(out, ref) < REL


def test_mlp_leaky_001():
    x = np.random.RandomState(2).randn(5, 10).astype(np.float32) * 3
    jm = jl.MLP(channel_list=(10, 12, 12, 1))
    v = jax_variables(jm, x)
    ref = np.asarray(jm.apply(v, x))
    sd = variables_to_state_dict({"params": {"cost_volume": {"mlp": v["params"]}}})
    pm = tl.MLP((10, 12, 12, 1))
    pm.load_state_dict({k.replace("cost_volume.mlp.", ""): w for k, w in sd.items()})
    with torch.no_grad():
        out = pm(t(x)).numpy()
    assert rel_err(out, ref) < REL
    assert pm.net[1].negative_slope == 0.01


# ---------------------------------------------------------------- encoders


def test_efficientnetv2s_full_width():
    x = np.random.RandomState(0).randn(1, 64, 64, 3).astype(np.float32)
    jm = jb.EfficientNetV2S()
    v = jax_variables(jm, x)
    ref = jax.jit(jm.apply)(v, x)
    pm = load_port(tb.EfficientNetV2S(), v, "encoder")
    with torch.no_grad():
        out = pm(t(x))
    assert len(out) == 5
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        assert rel_err(o.numpy(), r) < REL


def test_resnet_matching_encoder():
    x = np.random.RandomState(3).randn(2, 64, 96, 3).astype(np.float32)
    jm = jb.ResnetMatchingEncoder(16)
    v = jax_variables(jm, x, seed=1)
    ref = np.asarray(jm.apply(v, x))
    pm = load_port(tb.ResnetMatchingEncoder(16), v, "matching_model")
    with torch.no_grad():
        out = pm(t(x)).numpy()
    assert out.shape == ref.shape == (2, 16, 24, 16)
    assert rel_err(out, ref) < REL


@pytest.mark.parametrize("which", ["image", "matching"])
def test_tiny_encoders(which):
    x = np.random.RandomState(4).randn(2, 32, 64, 3).astype(np.float32)
    if which == "image":
        jm, pm, prefix = jb.TinyEncoder(), tb.TinyEncoder(), "encoder"
    else:
        jm, pm, prefix = jb.TinyMatchingEncoder(16), tb.TinyMatchingEncoder(16), "matching_model"
    v = jax_variables(jm, x, seed=2)
    ref = jm.apply(v, x)
    pm = load_port(pm, v, prefix)
    with torch.no_grad():
        out = pm(t(x))
    if which == "image":
        for o, r in zip(out, ref):
            assert rel_err(o.numpy(), r) < REL
    else:
        assert rel_err(out.numpy(), ref) < REL


# ---------------------------------------------------------------- decoders


def test_cv_encoder():
    rng = np.random.RandomState(3)
    enc_ch, outs = [8, 12, 16, 20], (16, 24, 32, 40)
    cv = rng.randn(1, 16, 24, 6).astype(np.float32)
    feats = [rng.randn(1, 16 // 2**i, 24 // 2**i, c).astype(np.float32)
             for i, c in enumerate(enc_ch)]
    jm = jd.CVEncoder(num_ch_outs=outs)
    v = jax_variables(jm, cv, feats)
    ref = jm.apply(v, cv, feats)
    pm = load_port(td.CVEncoder(6, enc_ch, outs), v, "cost_volume_net")
    with torch.no_grad():
        out = pm(t(cv), [t(f) for f in feats])
    for o, r in zip(out, ref):
        assert rel_err(o.numpy(), r) < REL


@pytest.mark.parametrize("decoder", ["unet_pp", "skip"])
def test_depth_decoders(decoder):
    rng = np.random.RandomState(4)
    enc_ch = [8, 12, 16, 20, 24]
    feats = [rng.randn(1, 32 // 2**i, 48 // 2**i, c).astype(np.float32)
             for i, c in enumerate(enc_ch)]
    if decoder == "unet_pp":
        jm, pm = jd.DepthDecoderPP(), td.DepthDecoderPP(enc_ch)
    else:
        jm, pm = jd.SkipDecoderRegression(), td.SkipDecoderRegression(enc_ch)
    v = jax_variables(jm, feats)
    # shrink weights: twenty stacked norm-free blocks otherwise blow up
    v = jax.tree_util.tree_map(lambda a: np.asarray(a) * 0.5, v)
    ref = jax.jit(jm.apply)(v, feats)
    pm = load_port(pm, v, "depth_decoder")
    with torch.no_grad():
        out = pm([t(f) for f in feats])
    assert sorted(out) == sorted(ref)
    for key in ref:
        assert rel_err(out[key].numpy(), ref[key]) < REL, key


# ----------------------------------------------------------- feature volume

B, K, C, H, W, D = 1, 3, 16, 8, 12, 8


def volume_inputs(seed=0):
    rng = np.random.RandomState(seed)

    def pose():
        ang = rng.randn(3) * 0.1
        cx, cy, cz = np.cos(ang)
        sx, sy, sz = np.sin(ang)
        Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = Rz @ Ry @ Rx
        T[:3, 3] = rng.randn(3) * 0.1
        return T

    Km = np.eye(4, dtype=np.float32)
    Km[0, 0] = Km[1, 1] = 10.0
    Km[0, 2], Km[1, 2] = W / 2, H / 2
    src_T_cur = np.stack([pose() for _ in range(K)])[None]
    return dict(
        cur=rng.randn(B, H, W, C).astype(np.float32),
        src=rng.randn(B, K, H, W, C).astype(np.float32),
        src_T_cur=src_T_cur,
        cur_T_src=np.linalg.inv(src_T_cur).astype(np.float32),
        src_K=np.broadcast_to(Km, (B, K, 4, 4)).copy(),
        cur_invK=np.linalg.inv(Km)[None].astype(np.float32),
    )


def make_hint(kind, seed=8):
    rng = np.random.RandomState(seed)
    depth = ((rng.rand(B, H, W, 1) + 0.3) * 2).astype(np.float32)
    if kind == "valid":
        mask = np.ones((B, H, W, 1), bool)
    elif kind == "invalid":
        mask = np.zeros((B, H, W, 1), bool)
    else:  # partly valid, NaN depth where invalid (the runner's coding)
        mask = rng.rand(B, H, W, 1) > 0.4
        depth = np.where(mask, depth, np.nan).astype(np.float32)
    weights = rng.rand(B, H, W, 1).astype(np.float32)
    return {"depth_hint_bhw1": depth, "hint_mask_bhw1": mask, "sampled_weights_bhw1": weights}


@pytest.mark.parametrize("hint_kind", ["valid", "invalid", "nan"])
@pytest.mark.parametrize("fast", [False, True])
def test_feature_mesh_hint_volume(hint_kind, fast):
    """Port vs the JAX XLA path (use_pallas=False). ``fast`` routes the port
    through the kernel wrapper, which takes the plain path on the CPU."""
    a = volume_inputs()
    args = (a["cur"], a["src"], a["src_T_cur"], a["cur_T_src"], a["src_K"], a["cur_invK"])
    hint = make_hint(hint_kind)
    jm = jcv.FeatureMeshHintVolume(num_depth_bins=D, plane_chunk=4)
    v = jax_variables(jm, *map(jnp.asarray, args), 0.25, 5.0, hint=hint, seed=2)
    jvol, jlow, jplanes, jmask = jm.apply(v, *map(jnp.asarray, args), 0.25, 5.0, hint=hint,
                                          return_mask=True)
    pm = tcv.FeatureMeshHintVolume(num_depth_bins=D, num_views=K, plane_chunk=4,
                                   fast_cost_volume=fast)
    sd = variables_to_state_dict({"params": {"cost_volume": v["params"]}})
    pm.load_state_dict({k[len("cost_volume."):]: w for k, w in sd.items()})
    pm.eval()
    with torch.no_grad():
        vol, low, planes, mask = pm(*map(t, args), 0.25, 5.0,
                                    hint={k: t(x) for k, x in hint.items()}, return_mask=True)
    # exp rounds 1 ulp apart between XLA and torch on some planes
    np.testing.assert_allclose(planes.numpy(), np.asarray(jplanes), rtol=2e-7, atol=0)
    assert vol.shape == (B, H, W, D)
    assert rel_err(vol.numpy(), jvol) < REL
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(low.numpy(), np.asarray(jlow), rtol=2e-7, atol=0)


def test_feature_volume_no_hint():
    a = volume_inputs(seed=3)
    args = (a["cur"], a["src"], a["src_T_cur"], a["cur_T_src"], a["src_K"], a["cur_invK"])
    jm = jcv.FeatureVolume(num_depth_bins=D, plane_chunk=4)
    v = jax_variables(jm, *map(jnp.asarray, args), 0.25, 5.0, seed=1)
    jvol = jm.apply(v, *map(jnp.asarray, args), 0.25, 5.0)[0]
    pm = tcv.FeatureVolume(num_depth_bins=D, num_views=K, plane_chunk=4)
    sd = variables_to_state_dict({"params": {"cost_volume": v["params"]}})
    pm.load_state_dict({k[len("cost_volume."):]: w for k, w in sd.items()})
    with torch.no_grad():
        vol = pm.eval()(*map(t, args), 0.25, 5.0)[0]
    assert rel_err(vol.numpy(), jvol) < REL


# ------------------------------------------------------------- full model

MH, MW, MK = 64, 96, 2


def model_batch(seed=0):
    rng = np.random.RandomState(seed)
    Km = np.eye(4, dtype=np.float32)
    Km[0, 0] = Km[1, 1] = 40.0
    Km[0, 2], Km[1, 2] = MW / 2, MH / 2
    K_s1 = Km.copy()
    K_s1[:2] /= 4.0

    def pose(i):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 0.1 * i
        T[1, 3] = 0.03 * i
        return T

    cur = {
        "image_bhw3": rng.randn(1, MH, MW, 3).astype(np.float32),
        "cam_T_world_b44": pose(0)[None],
        "world_T_cam_b44": np.linalg.inv(pose(0))[None].astype(np.float32),
        "invK_s1_b44": np.linalg.inv(K_s1)[None].astype(np.float32),
    }
    src = {
        "image_bkhw3": rng.randn(1, MK, MH, MW, 3).astype(np.float32),
        "cam_T_world_bk44": np.stack([pose(i + 1) for i in range(MK)])[None],
        "world_T_cam_bk44": np.stack([np.linalg.inv(pose(i + 1))
                                      for i in range(MK)])[None].astype(np.float32),
        "K_s1_bk44": np.stack([K_s1] * MK)[None],
    }
    hint = make_hint("nan", seed=5)
    hint = {k: np.repeat(np.repeat(v, 8, 1), 8, 2)[:, :MH, :MW] for k, v in hint.items()}
    return cur, src, hint


@pytest.fixture(scope="module")
def small_flagship():
    """JAX variables of the flagship modules at a small spatial size, shared
    by the model-level tests: the tree of ``model.init`` (traced with
    eval_shape, quicker than compiling init here) filled from numpy."""
    cur, src, hint = model_batch()
    kw = dict(matching_num_depth_bins=16, plane_chunk=8, model_num_views=MK + 1)
    jm = JaxDepthModelCVHint(**kw)
    v = jax_variables(jm, cur, src, seed=3)
    return jm, kw, v, cur, src, hint


def test_depth_model_cv_hint_s0_depth(small_flagship):
    """Flagship modules (EfficientNetV2-S, ResNet matching encoder, hint
    volume, U-Net++) at a small spatial size, with a hint."""
    jm, kw, v, cur, src, hint = small_flagship
    ref = jax.jit(lambda v_, c, s, h: jm.apply(v_, c, s, hint=h, return_mask=True))(
        v, cur, src, hint)

    pm = DepthModelCVHint(fast_cost_volume=True, **kw)
    pm.load_state_dict(variables_to_state_dict(v))
    with torch.no_grad():
        out = pm.eval()({k: t(x) for k, x in cur.items()}, {k: t(x) for k, x in src.items()},
                        hint={k: t(x) for k, x in hint.items()}, return_mask=True)
    for key in ("depth_pred_s0_bhw1", "depth_pred_s3_bhw1", "log_depth_pred_s1_bhw1"):
        assert out[key].shape == ref[key].shape
        assert rel_err(out[key].numpy(), ref[key]) < REL, key
    np.testing.assert_array_equal(out["overall_mask_bhw"].numpy(), np.asarray(ref["overall_mask_bhw"]))
    assert rel_err(out["matching_feats_bhwc"].numpy(), ref["matching_feats_bhwc"]) < REL

    # the empty hint is an all-invalid hint at image resolution, and the
    # feature-cache inputs reproduce the image path
    with torch.no_grad():
        cur_t = {k: t(x) for k, x in cur.items()}
        src_t = {k: t(x) for k, x in src.items()}
        empty = pm(cur_t, src_t)
        zero = torch.zeros((1, MH, MW, 1))
        invalid = pm(cur_t, src_t, hint={"depth_hint_bhw1": zero, "sampled_weights_bhw1": zero,
                                          "hint_mask_bhw1": zero.bool()})
        feats, mfeats = pm.encode_frame(cur_t["image_bhw3"])
        src_feats = pm.matching_model(src_t["image_bkhw3"][0])[None]
        cached = pm(cur_t, src_t, cur_feats=feats, cur_matching_feats=mfeats,
                    src_matching_feats=src_feats)
    assert torch.equal(empty["depth_pred_s0_bhw1"], invalid["depth_pred_s0_bhw1"])
    np.testing.assert_allclose(cached["depth_pred_s0_bhw1"].numpy(),
                               empty["depth_pred_s0_bhw1"].numpy(), rtol=1e-6, atol=0)


def test_bridge_roundtrip_reference_layout(small_flagship):
    """The JAX package's converter reads the port's own state_dict back into
    the JAX params exactly (reference-layout modules)."""
    _, kw, v, _, _, _ = small_flagship
    pm = get_model_class("cv_hint_depth_model")(**kw)
    pm.load_state_dict(variables_to_state_dict(v))
    back = convert_state_dict({k: x.numpy() for k, x in pm.state_dict().items()})
    for coll in ("params", "batch_stats"):
        a = jax.tree_util.tree_leaves_with_path(back[coll])
        b = jax.tree_util.tree_leaves_with_path(v[coll])
        assert [p for p, _ in a] == [p for p, _ in b]
        for (p, x), (_, y) in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(p))


def test_weights_files_load(tmp_path):
    """The JAX package's save_params npz and a reference-style Lightning
    .ckpt both load into the port through ``load_weights``."""
    from doubletake_tpu.checkpoints.io import save_params

    from doubletake_tpu_torch.checkpoints.convert import load_weights

    x = np.random.RandomState(7).randn(1, 32, 64, 3).astype(np.float32)
    jm = jb.TinyEncoder()
    v = jax_variables(jm, x, seed=5)
    variables = {c: {"encoder": tree} for c, tree in v.items()}
    save_params(str(tmp_path / "w.npz"), variables)
    from_npz = load_weights(str(tmp_path / "w.npz"))
    expect = variables_to_state_dict(variables)
    assert sorted(from_npz) == sorted(expect)
    for k in expect:
        assert torch.equal(from_npz[k], expect[k]), k

    torch.save({"state_dict": expect, "epoch": 3, "hyper_parameters": {}},
               str(tmp_path / "w.ckpt"))
    from_ckpt = load_weights(str(tmp_path / "w.ckpt"))
    pm = tb.TinyEncoder()
    pm.load_state_dict({k[len("encoder."):]: w for k, w in from_ckpt.items()})
    with torch.no_grad():
        out = pm.eval()(t(x))
    for o, r in zip(out, jm.apply(v, x)):
        assert rel_err(o.numpy(), r) < REL
