"""Training in the port against the JAX package's, on the CPU.

The losses, the depth-map filters, the color jitter, batch norm in train
mode, the flipped forward, the float32 train step, the learning-rate
schedule and ``train()`` end to end (the precision-16 step is in
tests/test_torch_bf16.py). Inputs come from numpy
seeds and the synthetic dataset; weights reach the port from the JAX
package's init through ``variables_to_state_dict``; random draws of a JAX
step (jitter factors, the flip coin) are repeated here from its key and fed
to the port's step, whose draws are explicit inputs.

Bounds: float32 module paths agree to ~1e-5 relative (losses, filters,
jitter); the forward with batch statistics to 1e-4; running statistics to
1e-6 relative (a biased-vs-unbiased variance would be off by n/(n-1), 1e-3
at the smallest layer here). The train step's bounds are stated at the
tests.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from doubletake_tpu import losses as jlosses
from doubletake_tpu.checkpoints.io import load_params as jax_load_params
from doubletake_tpu.options import Options as JaxOptions
from doubletake_tpu.runners import common as jcommon
from doubletake_tpu.training import train_loop as jtrain
from doubletake_tpu.training.augmentation import color_jitter as jax_color_jitter
from doubletake_tpu.utils import geometry as jgeo

from doubletake_tpu_torch import losses as tlosses
from doubletake_tpu_torch.checkpoints.convert import variables_to_state_dict
from doubletake_tpu_torch.data.loader import collate
from doubletake_tpu_torch.datasets.registry import dataset_from_opts
from doubletake_tpu_torch.models.layers import BatchNorm2d
from doubletake_tpu_torch.options import Options
from doubletake_tpu_torch.runners import common
from doubletake_tpu_torch.training import train_loop
from doubletake_tpu_torch.training.augmentation import apply_jitter
from doubletake_tpu_torch.utils import geometry as tgeo

TINY = dict(
    dataset="synthetic", image_width=64, image_height=32, image_encoder_name="tiny",
    matching_encoder_type="tiny", depth_decoder_name="skip",
    model_type="cv_hint_depth_model", feature_volume_type="mlp_mesh_hint_feature_volume",
    matching_num_depth_bins=8, plane_chunk=8, model_num_views=2, batch_size=2,
)


@pytest.fixture(autouse=True)
def few_torch_threads():
    """The tier runs several test processes at once: keep torch's CPU ops
    from oversubscribing the cores (the shapes here are tiny)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def dynamo_imported():
    """torch.optim and torch.utils.checkpoint import torch._dynamo at their
    first use, and that import walks sys.modules with inspect, which fails on
    a stub module whose ``__file__`` is not a string
    (tests/test_reference_parity.py installs such stubs while it is collected,
    in every worker). Import it once with those stubs set aside."""
    def stub(module):
        try:
            return not isinstance(getattr(module, "__file__", None), (str, type(None)))
        except Exception:
            return True

    stubs = {name: m for name, m in list(sys.modules.items()) if stub(m)}
    for name in stubs:
        del sys.modules[name]
    try:
        import torch._dynamo  # noqa: F401
    finally:
        sys.modules.update(stubs)


def options(cls, **extra):
    o = cls()
    for k, v in {**TINY, **extra}.items():
        setattr(o, k, v)
    if cls is Options:
        o.device = "cpu"
    return o


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


# ------------------------------------------------------------- loss inputs


def loss_inputs(seed=0, b=2, k=2, h=16, w=32):
    """GT depth with NaN holes, a positive prediction, source depths with
    holes, intrinsics and poses a few cm apart."""
    rng = np.random.RandomState(seed)
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 20.0
    K[0, 2], K[1, 2] = w / 2, h / 2
    invK = np.linalg.inv(K).astype(np.float32)

    def pose(i):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [0.05 * i, 0.02 * i, -0.01 * i]
        return T

    gt = (rng.rand(b, h, w, 1) * 2 + 1).astype(np.float32)
    gt[rng.rand(b, h, w, 1) < 0.15] = np.nan
    src_depth = (rng.rand(b, k, h, w, 1) * 2 + 1).astype(np.float32)
    src_depth[rng.rand(b, k, h, w, 1) < 0.1] = np.nan
    pred = (gt + rng.randn(b, h, w, 1) * 0.1).astype(np.float32)
    pred = np.where(np.isfinite(pred), pred, 1.5).astype(np.float32)
    cur = {"depth_bhw1": gt, "mask_b_bhw1": np.isfinite(gt),
           "invK_s0_b44": np.stack([invK] * b), "world_T_cam_b44": np.stack([pose(0)] * b)}
    src = {"depth_bkhw1": src_depth, "K_s0_bk44": np.broadcast_to(K, (b, k, 4, 4)).copy(),
           "cam_T_world_bk44": np.stack([np.stack([np.linalg.inv(pose(i + 1))
                                                   for i in range(k)])] * b).astype(np.float32)}
    outputs = {"depth_pred_s0_bhw1": pred, "log_depth_pred_s0_bhw1": np.log(pred)}
    for i in range(1, 4):
        lo = pred[:, ::2**i, ::2**i]
        outputs[f"log_depth_pred_s{i}_bhw1"] = np.log(lo).astype(np.float32)
    return cur, src, outputs


def normals_pair(depth, invK):
    """normals of a NaN-coded depth as the train step makes them, both sides."""
    jd = jnp.asarray(depth)
    jn = jgeo.normals_from_depth(jnp.where(jnp.isfinite(jd), jd, 0.0), jnp.asarray(invK))
    jn = np.asarray(jnp.where(jnp.isfinite(jd), jn, jnp.nan))
    td = t(depth)
    tn = tgeo.normals_from_depth(torch.where(torch.isfinite(td), td, torch.zeros_like(td)),
                                 t(invK))
    tn = torch.where(torch.isfinite(td), tn, torch.full_like(tn, float("nan")))
    return jn, tn


@pytest.mark.parametrize("term", ["scale_invariant", "ms_gradient", "normals", "mv_depth",
                                  "compute_losses"])
def test_losses_match_jax(term):
    cur, src, outputs = loss_inputs()
    gt, pred, mask = cur["depth_bhw1"], outputs["depth_pred_s0_bhw1"], cur["mask_b_bhw1"]
    if term == "scale_invariant":
        ref = {"v": jlosses.scale_invariant_loss(jnp.log(gt), jnp.log(pred), mask)}
        out = {"v": tlosses.scale_invariant_loss(torch.log(t(gt)), torch.log(t(pred)), t(mask))}
    elif term == "ms_gradient":
        ref = {"v": jlosses.ms_gradient_loss(gt, pred)}
        out = {"v": tlosses.ms_gradient_loss(t(gt), t(pred))}
    elif term == "normals":
        jn_gt, tn_gt = normals_pair(gt, cur["invK_s0_b44"])
        jn_p, tn_p = normals_pair(pred, cur["invK_s0_b44"])
        ref = {"v": jlosses.normals_loss(jn_gt, jn_p)}
        out = {"v": tlosses.normals_loss(tn_gt, tn_p)}
    elif term == "mv_depth":
        args = (pred, gt, src["depth_bkhw1"], cur["invK_s0_b44"], src["K_s0_bk44"],
                cur["world_T_cam_b44"], src["cam_T_world_bk44"])
        ref = {"v": jlosses.mv_depth_loss(*map(jnp.asarray, args))}
        out = {"v": tlosses.mv_depth_loss(*map(t, args))}
    else:
        jn_gt, tn_gt = normals_pair(gt, cur["invK_s0_b44"])
        jn_p, tn_p = normals_pair(pred, cur["invK_s0_b44"])
        ref = jlosses.compute_losses({k: jnp.asarray(v) for k, v in cur.items()},
                                     {k: jnp.asarray(v) for k, v in src.items()},
                                     {k: jnp.asarray(v) for k, v in outputs.items()}, jn_gt, jn_p)
        out = tlosses.compute_losses({k: t(v) for k, v in cur.items()},
                                     {k: t(v) for k, v in src.items()},
                                     {k: t(v) for k, v in outputs.items()}, tn_gt, tn_p)
    assert sorted(out) == sorted(ref)
    for key in ref:
        r, o = float(ref[key]), float(out[key])
        assert np.isfinite(r) and r != 0.0, (key, r)
        assert abs(o - r) <= 1e-5 * abs(r), (key, o, r)


@pytest.mark.parametrize("fn", ["spatial_gradient", "gaussian_blur", "normals_from_depth"])
def test_depth_filters_match_jax(fn):
    rng = np.random.RandomState(3)
    x = (rng.rand(2, 12, 20, 1) * 2 + 0.5).astype(np.float32)
    invK = np.linalg.inv(np.diag([15.0, 15.0, 1.0, 1.0]).astype(np.float32))[None]
    invK = np.repeat(invK, 2, 0).astype(np.float32)
    if fn == "spatial_gradient":
        x3 = rng.randn(2, 12, 20, 3).astype(np.float32)
        refs, outs = jgeo.spatial_gradient(x3), tgeo.spatial_gradient(t(x3))
    elif fn == "gaussian_blur":
        refs, outs = [jgeo.gaussian_blur(x)], [tgeo.gaussian_blur(t(x))]
    else:
        refs, outs = [jgeo.normals_from_depth(x, invK)], [tgeo.normals_from_depth(t(x), t(invK))]
    for r, o in zip(refs, outs):
        assert o.shape == r.shape
        assert rel(o.numpy(), r) < 1e-5


def jax_jitter_factors(key, b, strength=0.2):
    """The factors ``color_jitter`` draws from ``key`` (augmentation.py:51-55)."""
    k_b, k_c, k_s, k_h = jax.random.split(key, 4)
    u = lambda k, shape: jax.random.uniform(k, shape, minval=-strength, maxval=strength)  # noqa: E731
    return {"brightness": t(np.asarray(1.0 + u(k_b, (b, 1, 1, 1)))),
            "contrast": t(np.asarray(1.0 + u(k_c, (b, 1, 1, 1)))),
            "saturation": t(np.asarray(1.0 + u(k_s, (b, 1, 1, 1)))),
            "hue": t(np.asarray(u(k_h, (b, 1, 1)) * jnp.pi))}


def test_color_jitter_applies_jax_draws():
    img = np.random.RandomState(0).randn(3, 16, 24, 3).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = np.asarray(jax_color_jitter(key, jnp.asarray(img)))
    out = apply_jitter(t(img), jax_jitter_factors(key, 3)).numpy()
    assert np.abs(out - ref).max() <= 1e-5
    assert np.abs(out - img).max() > 1e-3


def test_batch_norm_running_stats_are_flax_biased():
    """One train-mode BatchNorm2d call against flax BatchNorm (momentum 0.9,
    the JAX package's batch_norm): running statistics to 1e-6 relative and
    the output to 1e-5; bf16 scale/bias beside float32 statistics (the
    precision-16 step) normalise a bf16 input and keep the statistics
    float32."""
    from doubletake_tpu.models.layers import batch_norm

    rng = np.random.RandomState(1)
    x = (rng.randn(2, 3, 5, 4) * 2 + 0.7).astype(np.float32)        # NHWC, n = 30
    jm = batch_norm(True, 1e-5)
    v = {"params": {"scale": rng.rand(4).astype(np.float32) + 0.5,
                    "bias": rng.randn(4).astype(np.float32)},
         "batch_stats": {"mean": rng.randn(4).astype(np.float32),
                         "var": rng.rand(4).astype(np.float32) + 0.5}}
    ref, mutated = jm.apply(v, x, mutable=["batch_stats"])
    bn = BatchNorm2d(4)
    bn.load_state_dict({"weight": t(v["params"]["scale"]), "bias": t(v["params"]["bias"]),
                        "running_mean": t(v["batch_stats"]["mean"]),
                        "running_var": t(v["batch_stats"]["var"]),
                        "num_batches_tracked": torch.tensor(0)})
    out = bn.train()(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert rel(out.detach().numpy(), ref) < 1e-5
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        assert rel(getattr(bn, name).numpy(), mutated["batch_stats"][key]) < 1e-6, name

    bn.weight.data, bn.bias.data = bn.weight.data.bfloat16(), bn.bias.data.bfloat16()
    y = bn(t(x).permute(0, 3, 1, 2).bfloat16())
    assert y.dtype == torch.bfloat16 and bn.running_var.dtype == torch.float32


def test_lr_schedule_matches_optax():
    o = options(Options)
    sched = train_loop.lr_schedule(o)
    ref = optax.piecewise_constant_schedule(o.lr, {int(s): 0.1 for s in o.lr_steps})
    for step in (0, 69999, 70000, 80000):
        assert sched(step) == float(ref(step)), step


# --------------------------------------------------------- model and steps


@pytest.fixture(scope="module")
def tiny_setup():
    """The tiny configuration's JAX model and initial variables, the port's
    model with the same weights, a synthetic batch of 2 with a partly valid
    hint (so the hint MLP gets a gradient), and JAX keys whose flip coins
    differ."""
    jo = options(JaxOptions)
    jmodel = jcommon.build_model(jo)
    ds = dataset_from_opts(options(Options), split="train")
    cur_np, src_np = collate([ds[0], ds[1]])
    rng = np.random.RandomState(4)
    depth = cur_np["depth_bhw1"]
    valid = np.isfinite(depth) & (rng.rand(*depth.shape) < 0.6)
    cur_np = dict(cur_np)
    cur_np["depth_hint_bhw1"] = np.where(valid, depth * (1 + 0.05 * rng.randn(*depth.shape)),
                                         np.nan).astype(np.float32)
    cur_np["hint_mask_bhw1"] = valid
    cur_np["sampled_weights_bhw1"] = np.where(valid, rng.rand(*depth.shape), 0).astype(np.float32)
    tx, _ = jtrain.make_optimizer(jo)
    state = init_state(jmodel, tx, cur_np, src_np)
    keys = {}
    for s in range(64):
        flip = bool(jax.random.bernoulli(jax.random.split(jax.random.PRNGKey(s))[1], 0.5))
        keys.setdefault(flip, jax.random.PRNGKey(s))
        if len(keys) == 2:
            break
    return jo, jmodel, tx, state, (cur_np, src_np), [keys[True], keys[False]]


def init_state(jmodel, tx, cur_np, src_np, seed=0):
    """A JAX TrainState over the tree of the model's init (traced with
    eval_shape, quicker than compiling init) filled from numpy: lecun-normal
    kernels, small biases, batch-norm scale and variance in [0.5, 1.5)."""
    cur = {k: cur_np[k] for k in jcommon.CUR_KEYS}
    src = {k: src_np[k] for k in jcommon.SRC_KEYS}
    shapes = jax.eval_shape(lambda key: jmodel.init(key, cur, src), jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            x = rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name in ("scale", "var"):
            x = rng.rand(*s.shape) + 0.5
        else:
            x = rng.randn(*s.shape) * 0.1
        return jnp.asarray(x.astype(np.float32))

    v = jax.tree_util.tree_map_with_path(fill, shapes)
    return jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                             batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]))


def copied(state):
    """A copy of a TrainState (the JAX step donates the one it is given)."""
    return jax.tree_util.tree_map(jnp.array, state)


def adam_mu(opt_state):
    """The first moment of optax's adam state."""
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")).mu


def port_model(state, **extra):
    o = options(Options, **extra)
    model = common.build_model(o)
    model.load_state_dict(variables_to_state_dict(
        jax.tree_util.tree_map(np.asarray, {"params": state.params,
                                            "batch_stats": state.batch_stats})))
    return o, model


def port_draws(key, b, k):
    """The JAX step's draws from its key (train_loop.py:123-138)."""
    aug_rng, flip_rng = jax.random.split(key)
    keys = jax.random.split(aug_rng, 1 + k)
    aug = {"cur": jax_jitter_factors(keys[0], b),
           "src": [jax_jitter_factors(keys[1 + i], b) for i in range(k)]}
    return aug, bool(jax.random.bernoulli(flip_rng, 0.5))


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_flipped_forward_matches_jax(tiny_setup, mode):
    """flip=True with the partly valid hint, in eval mode (running
    statistics) and train mode (batch statistics, and the running
    statistics' update against JAX's mutated batch_stats, 1e-6)."""
    jo, jmodel, _, state, (cur_np, src_np), _ = tiny_setup
    cur = {k: cur_np[k] for k in jtrain.TRAIN_CUR_KEYS}
    src = {k: src_np[k] for k in jtrain.TRAIN_SRC_KEYS}
    hint = {k: cur_np[k] for k in jtrain._HINT_KEYS}
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    if mode == "train":
        ref, mutated = jax.jit(lambda v, c, s, h: jmodel.apply(
            v, c, s, train=True, flip=True, hint=h, mutable=["batch_stats"]))(
                variables, cur, src, hint)
    else:
        ref = jax.jit(lambda v, c, s, h: jmodel.apply(v, c, s, flip=True, hint=h))(
            variables, cur, src, hint)
    o, model = port_model(state)
    model.train(mode == "train")
    with torch.no_grad():
        out = model({k: t(v) for k, v in cur.items()}, {k: t(v) for k, v in src.items()},
                    hint={k: t(v) for k, v in hint.items()}, flip=True)
    assert "matching_feats_bhwc" not in out
    for key in ("depth_pred_s0_bhw1", "log_depth_pred_s3_bhw1", "lowest_cost_bhw"):
        assert rel(out[key].numpy(), ref[key]) < 1e-4, key
    if mode == "train":
        sd = variables_to_state_dict(jax.tree_util.tree_map(
            np.asarray, {"params": state.params, "batch_stats": mutated["batch_stats"]}))
        port_sd = model.state_dict()
        stats = [k for k in sd if k.endswith(("running_mean", "running_var"))]
        assert stats
        for k in stats:
            assert rel(port_sd[k].numpy(), sd[k].numpy()) < 1e-6, k


def test_fp32_train_step_matches_jax(tiny_setup):
    """Two float32 steps on the same batch with JAX's draws (one flipped, one
    not). Loss dicts to 1e-4 relative; step 1's gradients per tensor to 1e-3
    in relative norm (JAX's are its adam first moment after step 1 over
    1 - beta1; a gradient that is zero in exact arithmetic must stay below
    1e-6 of the largest on both sides). Parameters after step 2: AdamW's first updates move
    each element by about lr whatever its gradient's size, so an element
    whose gradient is ~0 may move the other way in the two frameworks: the
    bound is 2 steps x 2 lr = 4e-4 per element, and the median difference
    must stay below 1e-6 (the updates agree for all but such elements).
    Batch-norm running statistics after step 2: 1e-5 relative."""
    jo, jmodel, tx, state, batch, keys = tiny_setup
    cur, src = jtrain._train_batch(*batch)
    step_fn = jtrain.make_train_step(jmodel, tx, None, use_hint_model=True)

    o, model = port_model(state)
    optimizer, schedule = train_loop.make_optimizer(o, model)
    step = train_loop.make_train_step(model, optimizer, schedule, use_hint_model=True)
    pcur, psrc = train_loop.train_batch(*batch, "cpu")
    jstate = copied(state)
    for i, key in enumerate(keys):
        jstate, jl = step_fn(jstate, cur, src, key)
        aug, flip = port_draws(key, 2, 1)
        assert flip == (i == 0)
        pl = step(pcur, psrc, aug, flip)
        assert sorted(pl) == sorted(jl)
        for k in jl:
            assert abs(float(pl[k]) - float(jl[k])) <= 1e-4 * abs(float(jl[k])), (i, k)
        if i == 0:
            grads = jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1, adam_mu(jstate.opt_state))
            gsd = variables_to_state_dict(jax.tree_util.tree_map(
                np.asarray, {"params": grads, "batch_stats": state.batch_stats}))
            named = dict(model.named_parameters())
            assert set(named) <= set(gsd)
            scale = max(np.linalg.norm(gsd[name].numpy()) for name in named)
            for name, p in named.items():
                g, r = p.grad.numpy(), gsd[name].numpy()
                if np.linalg.norm(r) < 1e-6 * scale:
                    # zero in exact arithmetic (a bias before an instance
                    # norm): rounding noise on both sides
                    assert np.linalg.norm(g) < 1e-6 * scale, name
                else:
                    assert np.linalg.norm(g - r) <= 1e-3 * np.linalg.norm(r), name
            hint_grads = [n for n in named if n.startswith("cost_volume.hint_mlp")]
            assert hint_grads and all(named[n].grad.abs().sum() > 0 for n in hint_grads)
    after = variables_to_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    port_sd = model.state_dict()
    diffs = np.concatenate([np.abs(port_sd[n].numpy() - after[n].numpy()).ravel()
                            for n, _ in model.named_parameters()])
    assert diffs.max() <= 4 * o.lr and np.median(diffs) < 1e-6
    for k in port_sd:
        if k.endswith(("running_mean", "running_var")):
            assert rel(port_sd[k].numpy(), after[k].numpy()) < 1e-5, k


def test_checkpoint_io(tmp_path):
    """Training states keep the newest two and restore model, optimizer and
    step; stripping one leaves a reference-style .ckpt of the weights;
    cast_floating casts parameters and buffers."""
    from doubletake_tpu_torch.checkpoints.convert import load_weights
    from doubletake_tpu_torch.checkpoints.io import (
        cast_floating,
        restore_train_state,
        save_train_state,
        strip_checkpoint,
    )

    o = options(Options)
    model = train_loop.init_train_state(o, common.build_model(o))
    optimizer, _ = train_loop.make_optimizer(o, model)
    model.cost_volume.mlp.net[0].weight.sum().backward()
    optimizer.step()
    for step in (1, 2, 3):
        save_train_state(str(tmp_path), step, model, optimizer)
    assert sorted(os.listdir(tmp_path)) == ["step_00000002.pt", "step_00000003.pt"]
    other = train_loop.init_train_state(options(Options, random_seed=1),
                                        common.build_model(options(Options)))
    other_opt, _ = train_loop.make_optimizer(o, other)
    assert restore_train_state(str(tmp_path), other, other_opt) == 3
    for k, v in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    assert other_opt.state_dict()["state"].keys() == optimizer.state_dict()["state"].keys()
    strip_checkpoint(str(tmp_path / "step_00000003.pt"), str(tmp_path / "w.ckpt"))
    stripped = load_weights(str(tmp_path / "w.ckpt"))
    assert sorted(stripped) == sorted(model.state_dict())
    half = cast_floating(model, torch.bfloat16)
    assert half.encoder.bn0.running_var.dtype == torch.bfloat16
    assert half.encoder.bn0.num_batches_tracked.dtype == torch.long
    assert cast_floating({"a": torch.ones(2), "n": torch.tensor(3)},
                         torch.bfloat16)["n"].dtype == torch.long


# -------------------------------------------------------------- train() e2e


class RecordingWriter:
    """Stands in for the TensorBoard writer: records what train() writes."""

    def __init__(self):
        self.scalars, self.images = {}, {}

    def add_scalar(self, key, value, step):
        self.scalars.setdefault(key, []).append((step, value))

    def add_image(self, key, img, step, dataformats):
        assert dataformats == "HWC" and img.ndim == 3 and img.shape[-1] == 3
        self.images.setdefault(key, []).append(step)

    def flush(self):
        pass

    def close(self):
        pass


def test_train_end_to_end(tmp_path, monkeypatch):
    """train() for 2 steps with one validation batch per set under
    fill_depth_hints, then a resumed run; the final .ckpt loads into the
    port's runner and into the JAX package (load_params converts a
    reference-style .ckpt), and both give the same s0 depth (1e-4
    relative). The model uses the modules the JAX package's converter maps
    (EfficientNetV2-S, ResNet matching encoder, hint volume, skip decoder).
    The TensorBoard writer is a recorder here (importing tensorboard pulls
    in TensorFlow where it is installed, which takes longer than the run)."""
    writer = RecordingWriter()
    monkeypatch.setattr(train_loop, "_make_writer", lambda log_dir: writer)
    extra = dict(image_encoder_name="efficientnet", matching_encoder_type="resnet",
                 name="train_smoke", log_dir=str(tmp_path), max_steps=2, val_interval=2,
                 val_batches=1, val_batch_size=2, log_interval=1, image_log_interval=2,
                 num_workers=2, fill_depth_hints=True)
    o = options(Options, **extra)
    res = train_loop.train(o)
    assert res["step"] == 2 and np.isfinite(res["losses"]["loss"])
    log_dir = tmp_path / "train_smoke"
    assert (log_dir / "options.yaml").exists()
    assert (log_dir / "code" / "doubletake_tpu_torch" / "csrc" / "fused_volume.cu").exists()
    assert (log_dir / "checkpoints" / "step_00000002.pt").exists()
    assert (log_dir / "best" / "step_00000002.pt").exists()
    assert [s for s, _ in writer.scalars["train/loss"]] == [1, 2]
    assert {f"val_{i}_metrics/a5" for i in range(4)} <= set(writer.scalars)
    assert "train/samples_per_sec" in writer.scalars and "train/lr" in writer.scalars
    assert writer.images["train_images/depth_pred"] == [2]

    resumed = train_loop.train(options(Options, **{**extra, "max_steps": 3,
                                                   "resume": str(log_dir / "checkpoints")}))
    assert resumed["step"] == 3
    assert sorted(os.listdir(log_dir / "checkpoints")) == ["step_00000002.pt",
                                                           "step_00000003.pt"]

    ckpt = resumed["final_weights"]
    lo = options(Options, **{**extra, "load_weights_from_checkpoint": ckpt})
    model = common.init_or_load_params(lo, common.build_model(lo))
    loaded = model.state_dict()
    for k, v in resumed["model"].state_dict().items():
        assert torch.equal(loaded[k], v), k
    jo = options(JaxOptions, image_encoder_name="efficientnet", matching_encoder_type="resnet")
    jmodel = jcommon.build_model(jo)
    variables = jax_load_params(ckpt)
    # one numpy batch feeds both packages
    ds = dataset_from_opts(lo, split="val")
    cur_np, src_np = collate([ds[0], ds[1]])
    cur, src = jcommon.device_batch(cur_np, src_np)
    ref = jax.jit(jmodel.apply)(variables, cur, src)["depth_pred_s0_bhw1"]
    pc, ps = common.device_batch(cur_np, src_np, "cpu")
    with torch.no_grad():
        out = model(pc, ps)["depth_pred_s0_bhw1"]
    assert rel(out.numpy(), ref) <= 1e-4
