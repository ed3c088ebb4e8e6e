"""The bf16 compute path of the port against the JAX package's, on the CPU.

Under compute_dtype "bfloat16" the JAX package casts the weights and
batch-norm statistics to bf16 (runners/common.py:84-91) and the images at
the model's entry; flax's type promotion decides every layer's type after
that. Its XLA volume concatenates float32 depths into the metadata, so the
volume and everything after it compute in float32 on bf16 weights; the
Pallas path casts the volume to bf16 instead (cost_volume.py:388). The port
follows the same flow, so the bounds here are those of reduced-precision
rounding at a few different places: volume scores mean < 5e-3 and p99 <
5e-2 (tests/test_fused_volume.py:87-89); the whole tiny model's s0 depth
within a quarter of the JAX package's own bf16-vs-float32 difference. The
train step at precision 16 (bf16 compute on float32 master weights) is here
too.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from doubletake_tpu.checkpoints.io import cast_floating
from doubletake_tpu.models import cost_volume as jcv
from doubletake_tpu.options import Options as JaxOptions
from doubletake_tpu.runners import common as jcommon
from doubletake_tpu.training import train_loop as jtrain

from doubletake_tpu_torch.checkpoints.convert import variables_to_state_dict
from doubletake_tpu_torch.data.loader import collate
from doubletake_tpu_torch.datasets.registry import dataset_from_opts
from doubletake_tpu_torch.models import cost_volume as tcv
from doubletake_tpu_torch.ops import fused_volume as fv
from doubletake_tpu_torch.options import Options
from doubletake_tpu_torch.runners import common
from doubletake_tpu_torch.training import train_loop

# the tiny training setup (a module fixture) and its helpers
from test_torch_training import (  # noqa: F401
    copied,
    dynamo_imported,
    port_draws,
    port_model,
    tiny_setup,
)

TINY = dict(
    dataset="synthetic", image_width=64, image_height=32, image_encoder_name="tiny",
    matching_encoder_type="tiny", depth_decoder_name="skip",
    model_type="cv_hint_depth_model", feature_volume_type="mlp_mesh_hint_feature_volume",
    matching_num_depth_bins=8, plane_chunk=8, model_num_views=2, batch_size=2,
)


@pytest.fixture(autouse=True)
def few_torch_threads():
    """The tier runs several test processes at once: keep torch's CPU ops
    from oversubscribing the cores (the shapes here are small)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def fill(shapes, seed):
    """A variables tree of ``shapes`` from numpy: lecun-normal kernels, small
    biases, batch-norm scale and variance in [0.5, 1.5)."""
    rng = np.random.RandomState(seed)

    def one(path, s):
        name = path[-1].key
        if name == "kernel":
            x = rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name in ("scale", "var"):
            x = rng.rand(*s.shape) + 0.5
        else:
            x = rng.randn(*s.shape) * 0.1
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, shapes)


# ------------------------------------------------------------------- volume

B, K, C, H, W, D = 1, 3, 16, 16, 24, 8


def volume_inputs(seed=0):
    rng = np.random.RandomState(seed)

    def pose():
        a = rng.randn(3) * 0.1
        cx, cy, cz = np.cos(a)
        sx, sy, sz = np.sin(a)
        R = (np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
             @ np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
             @ np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]]))
        T = np.eye(4, dtype=np.float32)
        T[:3, :3], T[:3, 3] = R, rng.randn(3) * 0.1
        return T

    Km = np.eye(4, dtype=np.float32)
    Km[0, 0] = Km[1, 1] = 20.0
    Km[0, 2], Km[1, 2] = W / 2, H / 2
    src_T_cur = np.stack([pose() for _ in range(K)])[None]
    depth = ((rng.rand(B, H, W, 1) + 0.3) * 2).astype(np.float32)
    mask = rng.rand(B, H, W, 1) > 0.4
    hint = {"depth_hint_bhw1": np.where(mask, depth, np.nan).astype(np.float32),
            "hint_mask_bhw1": mask,
            "sampled_weights_bhw1": rng.rand(B, H, W, 1).astype(np.float32)}
    args = (rng.randn(B, H, W, C).astype(np.float32),
            rng.randn(B, K, H, W, C).astype(np.float32), src_T_cur,
            np.linalg.inv(src_T_cur).astype(np.float32),
            np.broadcast_to(Km, (B, K, 4, 4)).copy(), np.linalg.inv(Km)[None].astype(np.float32))
    return args, hint


@pytest.mark.parametrize("with_hint", [True, False])
def test_bf16_volume_matches_jax_xla(with_hint):
    """The port's plain volume with bf16 features and weights against the
    JAX XLA FeatureVolume with the same (float32 scores on both sides)."""
    args, hint = volume_inputs()
    jcls = jcv.FeatureMeshHintVolume if with_hint else jcv.FeatureVolume
    jm = jcls(num_depth_bins=D, plane_chunk=4)
    kw = {"hint": hint} if with_hint else {}
    v = fill(jax.eval_shape(lambda key: jm.init(key, *args, 0.25, 5.0, **kw),
                            jax.random.PRNGKey(0)), seed=2)
    jargs = [jnp.asarray(a, jnp.bfloat16) if i < 2 else jnp.asarray(a)
             for i, a in enumerate(args)]
    ref = np.asarray(jm.apply(cast_floating(v, jnp.bfloat16), *jargs, 0.25, 5.0, **kw)[0])
    assert ref.dtype == np.float32

    pcls = tcv.FeatureMeshHintVolume if with_hint else tcv.FeatureVolume
    pm = pcls(num_depth_bins=D, num_views=K, plane_chunk=4)
    sd = variables_to_state_dict({"params": {"cost_volume": v["params"]}})
    pm.load_state_dict({k[len("cost_volume."):]: w for k, w in sd.items()})
    pm = pm.eval().to(torch.bfloat16)
    pargs = [t(a).bfloat16() if i < 2 else t(a) for i, a in enumerate(args)]
    with torch.no_grad():
        vol = pm(*pargs, 0.25, 5.0, hint={k: t(x) for k, x in hint.items()} if with_hint
                 else None)[0]
    assert vol.dtype == torch.float32
    diff = np.abs(vol.numpy() - ref)
    assert diff.mean() < 5e-3 and np.percentile(diff, 99) < 5e-2, (diff.mean(), diff.max())


def kernel_bf16_emulated(cur, src, geo, planes, mlp, hint_mlp, hint, bf16_grid=True):
    """K1's bf16 arithmetic in torch: bf16 features, every MLP operand and
    layer 1's activations rounded to bf16, float32 sums; the hint MLP in
    float32. ``bf16_grid``: sample at the bf16-rounded grid coordinate, as
    the kernel and its plain version do (False: at the float32 one)."""
    c, s = (cur, src) if bf16_grid else (cur.float(), src.float())
    x = fv.volume_metadata(c, s, *geo, planes).float().bfloat16().float()
    (w1, b1), (w2, b2), (w3, b3) = [(w.float(), b.float()) for w, b in mlp]
    h1 = F.leaky_relu(F.linear(x, w1, b1), 0.01).bfloat16().float()
    h2 = F.leaky_relu(F.linear(h1, w2, b2), 0.01).bfloat16().float()
    score = F.linear(h2, w3, b3)[..., 0]
    b, h, w, _ = cur.shape
    hd, hv, hw = hint.reshape(b, -1, 3).unbind(-1)
    score = fv.hint_mlp_plain([(a.float(), z.float()) for a, z in hint_mlp], score, hd, hv > 0.5,
                              hw, planes)
    return score.reshape(b, -1, h, w)


def test_kernel_bf16_arithmetic_within_budget():
    """K1's bf16 mode, emulated, against its plain version (the XLA bf16
    path) at 7 views and 24x32: within the reduced-precision budgets, and
    closer with the bf16 sampling grid than with a float32 one (why the
    kernel rounds the grid: the plain version does)."""
    g = torch.Generator().manual_seed(0)
    k, h, w, d = 7, 24, 32, 16
    module = tcv.FeatureMeshHintVolume(num_depth_bins=d, num_views=k)
    from doubletake_tpu_torch.models.layers import init_parameters

    init_parameters(module, g)
    module = module.to(torch.bfloat16)
    pose = torch.eye(4).repeat(1, k, 1, 1)
    pose[:, :, :3, 3] = torch.randn((1, k, 3), generator=g) * 0.2
    Km = torch.tensor([[0.8 * w, 0, w / 2, 0], [0, 0.8 * w, h / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    geo = fv.volume_geometry(Km.repeat(1, k, 1, 1), pose, torch.linalg.inv(pose),
                             torch.linalg.inv(Km)[None], h, w, torch.bfloat16)
    cur = torch.randn((1, h, w, 16), generator=g).bfloat16()
    src = torch.randn((1, k, h, w, 16), generator=g).bfloat16()
    valid = torch.rand((1, h, w), generator=g) < 0.6
    hint = torch.stack([torch.where(valid, torch.rand((1, h, w), generator=g) * 3 + 0.5, 0.0),
                        valid.float(), torch.where(valid, torch.rand((1, h, w), generator=g),
                                                   0.0).bfloat16().float()], -1)
    planes = tcv.generate_depth_planes(0.25, 5.0, d)
    mlp, hint_mlp = module._layers(module.mlp), module._layers(module.hint_mlp)
    with torch.no_grad():
        plain = fv.feature_volume_plain(cur, src, *geo, planes, mlp, hint_mlp, hint)
        errs = [(kernel_bf16_emulated(cur, src, geo, planes, mlp, hint_mlp, hint, g_) - plain)
                .abs() for g_ in (True, False)]
    assert errs[0].mean() < 5e-3 and torch.quantile(errs[0].flatten(), 0.99) < 5e-2
    assert errs[0].mean() < errs[1].mean()


# -------------------------------------------------------------- tiny model


def options(cls, **extra):
    o = cls()
    for k, v in {**TINY, **extra}.items():
        setattr(o, k, v)
    if cls is Options:
        o.device = "cpu"
    return o


@pytest.fixture(scope="module")
def tiny_batch():
    ds = dataset_from_opts(options(Options), split="test")
    cur_np, src_np = collate([ds[0], ds[1]])
    rng = np.random.RandomState(4)
    depth = cur_np["depth_bhw1"]
    valid = np.isfinite(depth) & (rng.rand(*depth.shape) < 0.6)
    hint = {"depth_hint_bhw1": np.where(valid, depth, np.nan).astype(np.float32),
            "hint_mask_bhw1": valid,
            "sampled_weights_bhw1": np.where(valid, rng.rand(*depth.shape), 0).astype(np.float32)}
    return cur_np, src_np, hint


def test_bf16_tiny_model_matches_jax(tiny_batch):
    """The tiny model at compute_dtype "bfloat16" (the plain volume on both
    sides): the port's s0 depth within a quarter of the JAX package's own
    bf16-vs-float32 difference (p99 over the pixels)."""
    cur_np, src_np, hint = tiny_batch
    cur, src = jcommon.device_batch(cur_np, src_np)
    outs = {}
    for dtype in ("float32", "bfloat16"):
        jo = options(JaxOptions, compute_dtype=dtype)
        jm = jcommon.build_model(jo)
        if dtype == "float32":
            variables = fill(jax.eval_shape(lambda key: jm.init(key, cur, src),
                                            jax.random.PRNGKey(0)), seed=3)
        fwd = jax.jit(lambda v, c, s, h: jm.apply(v, c, s, hint=h))
        outs[dtype] = np.asarray(fwd(jcommon._maybe_cast(jo, variables), cur, src,
                                     hint)["depth_pred_s0_bhw1"])

    o = options(Options, compute_dtype="bfloat16")
    model = common.build_model(o)
    model.load_state_dict(variables_to_state_dict(variables))
    model = common.maybe_cast(o, model)
    pc, ps = common.device_batch(cur_np, src_np, "cpu")
    with torch.no_grad():
        out = model(pc, ps, hint={k: t(v) for k, v in hint.items()})["depth_pred_s0_bhw1"]
    assert out.dtype == torch.float32
    jax_gap = np.percentile(np.abs(outs["bfloat16"] - outs["float32"]), 99)
    port_gap = np.percentile(np.abs(out.numpy() - outs["bfloat16"]), 99)
    assert jax_gap > 0 and port_gap <= jax_gap / 4, (port_gap, jax_gap)


def test_maybe_cast_and_the_fast_path_types(tiny_batch):
    """compute_dtype "bfloat16": every floating parameter and buffer
    (batch-norm statistics too) is bf16, outputs are float32, the fast
    path's volume is bf16 (cast after the kernel) and the plain path's
    float32."""
    cur_np, src_np, hint = tiny_batch
    o = options(Options, compute_dtype="bfloat16", fast_cost_volume=True)
    model = common.init_or_load_params(o, common.build_model(o))
    floats = [p for p in model.parameters()] + [b for b in model.buffers()
                                                if b.is_floating_point()]
    assert {x.dtype for x in floats} == {torch.bfloat16}
    assert any("running_var" in n for n, b in model.named_buffers() if b.dtype == torch.bfloat16)
    pc, ps = common.device_batch(cur_np, src_np, "cpu")
    h = {k: t(v) for k, v in hint.items()}
    with torch.no_grad():
        fast = model(pc, ps, hint=h, stop_after="cost_volume")["cost_volume_bhwd"]
        model.cost_volume.fast_cost_volume = False
        plain = model(pc, ps, hint=h, stop_after="cost_volume")["cost_volume_bhwd"]
        out = model(pc, ps, hint=h)
    assert fast.dtype == torch.bfloat16 and plain.dtype == torch.float32
    assert torch.equal(fast, plain.bfloat16())
    assert all(v.dtype == torch.float32 for k, v in out.items() if k.startswith(("depth", "log")))
    assert all(torch.isfinite(v).all() for k, v in out.items() if k.startswith("depth"))


# ------------------------------------------------------ precision-16 step


def test_precision16_step(tiny_setup):
    """Precision 16: parameters and optimizer state stay float32, a 6-step
    loss curve on a fixed batch at lr 1e-3 tracks the port's float32 curve
    (mean relative < 0.15, tests/test_training.py:166-197), and step 1's
    loss matches the JAX package's precision-16 step to 2e-2 relative: both
    round the same weights and images to bf16, but bf16 sums of different
    order move a loss of ~3 by a few 1e-3."""
    jo, jmodel, _, state, batch, keys = tiny_setup
    curves = {}
    for precision in (32, 16):
        o, model = port_model(state, precision=precision, lr=1e-3)
        optimizer, schedule = train_loop.make_optimizer(o, model)
        step = train_loop.make_train_step(train_loop.train_model_for(o, model), optimizer,
                                          schedule, use_hint_model=True, precision=precision)
        pcur, psrc = train_loop.train_batch(*batch, "cpu")
        aug, flip = port_draws(keys[0], 2, 1)
        curves[precision] = [float(step(pcur, psrc, aug, flip)["loss"]) for _ in range(6)]
        floats = [p for p in model.parameters()] + [
            v for st in optimizer.state.values() for v in st.values() if v.is_floating_point()]
        assert all(x.dtype == torch.float32 for x in floats)
        assert model.compute_dtype == torch.float32
    a, b = np.asarray(curves[32]), np.asarray(curves[16])
    assert np.isfinite(b).all()
    assert (np.abs(a - b) / np.abs(a)).mean() < 0.15, (a, b)

    jo16 = options(JaxOptions, precision=16, lr=1e-3)
    jm16 = jtrain.train_model_for(jo16)
    tx, _ = jtrain.make_optimizer(jo16)
    jstate = copied(jtrain.TrainState(step=state.step, params=state.params,
                                      batch_stats=state.batch_stats,
                                      opt_state=tx.init(state.params)))
    _, jl = jtrain.make_train_step(jm16, tx, None, use_hint_model=True, precision=16)(
        jstate, *jtrain._train_batch(*batch), keys[0])
    assert abs(curves[16][0] - float(jl["loss"])) <= 2e-2 * abs(float(jl["loss"]))
