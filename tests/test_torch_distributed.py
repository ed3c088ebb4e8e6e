"""The port's data-parallel trainer against the JAX package's, on the CPU.

The plain version of the step's collective (``make_sharded_train_step``:
the shards of a global batch one after another, their flat vectors of
gradients, running statistics and losses averaged) against JAX
``make_train_step`` on ``data_mesh(n)`` (the 8 virtual CPU devices of
tests/conftest.py), each shard fed JAX's draws from ``fold_in(key, r)``;
then a real 2-process gloo group against that plain version; the loader
shard; and ``train(num_devices=2)`` end to end on the CPU. Every spawned
group has a rendezvous and collective timeout and a join timeout.

Bounds: the plain step against JAX is held to the float32 step's bounds of
tests/test_torch_training.py::test_fp32_train_step_matches_jax (losses 1e-4
relative; parameters: at most 2 steps x 2 lr per element, median below
1e-6; running statistics 1e-5 relative). Two gloo ranks sum two vectors,
one addition an element whichever rank adds first, so the group's step is
held to the plain version bit for bit (both sides' ranks use 2 threads).
"""

import os

import numpy as np
import pytest
import torch

import jax

from doubletake_tpu.checkpoints.io import load_params as jax_load_params
from doubletake_tpu.options import Options as JaxOptions
from doubletake_tpu.runners import common as jcommon
from doubletake_tpu.training import train_loop as jtrain

from doubletake_tpu_torch.checkpoints.convert import variables_to_state_dict
from doubletake_tpu_torch.data.loader import DataLoader, collate
from doubletake_tpu_torch.datasets.registry import dataset_from_opts
from doubletake_tpu_torch.runners import common
from doubletake_tpu_torch.training import distributed, train_loop

from test_torch_training import (  # noqa: F401
    copied,
    dynamo_imported,
    few_torch_threads,
    init_state,
    options,
    port_draws,
    rel,
)
from doubletake_tpu_torch.options import Options

JOIN_TIMEOUT_S = 480.0
STAGED_KEYS = ("frames_fhw3", "frame_index_b")     # a loader batch's staged frames, cur side
GROUP_TIMEOUT_S = 300.0


def hinted_batch(b, seed=4):
    """The first synthetic batch of ``b`` rows with a partly valid hint (so
    the hint MLP gets a gradient), as tests/test_torch_training.py's
    tiny_setup makes its batch of 2."""
    ds = dataset_from_opts(options(Options), split="train")
    cur_np, src_np = collate([ds[i] for i in range(b)])
    rng = np.random.RandomState(seed)
    depth = cur_np["depth_bhw1"]
    valid = np.isfinite(depth) & (rng.rand(*depth.shape) < 0.6)
    cur_np = dict(cur_np)
    cur_np["depth_hint_bhw1"] = np.where(valid, depth * (1 + 0.05 * rng.randn(*depth.shape)),
                                         np.nan).astype(np.float32)
    cur_np["hint_mask_bhw1"] = valid
    cur_np["sampled_weights_bhw1"] = np.where(valid, rng.rand(*depth.shape), 0).astype(np.float32)
    return cur_np, src_np


def rows(batch, lo, hi):
    """Rows [lo, hi) of a (cur, src) batch of numpy arrays or tensors."""
    return tuple({k: v[lo:hi] for k, v in part.items()} for part in batch)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_step_matches_jax_mesh(n):
    """Two steps of JAX's shard_map step on data_mesh(n) over a global batch
    of 2n against the port's plain collective over n shards of 2 rows, each
    shard with JAX's draws from fold_in(key, r) (one key flips device 0,
    the other does not)."""
    jo = options(JaxOptions)
    jmodel = jcommon.build_model(jo)
    batch = hinted_batch(2 * n)
    tx, _ = jtrain.make_optimizer(jo)
    state = init_state(jmodel, tx, *batch)
    keys = {}
    for s in range(64):
        key = jax.random.PRNGKey(s)
        flip = port_draws(jax.random.fold_in(key, 0), 2, 1)[1]
        keys.setdefault(flip, key)
        if len(keys) == 2:
            break
    keys = [keys[True], keys[False]]
    step_fn = jtrain.make_train_step(jmodel, tx, jtrain.data_mesh(n), use_hint_model=True)
    cur, src = jtrain._train_batch(*batch)

    o = options(Options)
    model = common.build_model(o)
    model.load_state_dict(variables_to_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": state.params, "batch_stats": state.batch_stats})))
    optimizer, schedule = train_loop.make_optimizer(o, model)
    step = train_loop.make_sharded_train_step(model, optimizer, schedule, use_hint_model=True)
    shards = [train_loop.train_batch(*rows(batch, 2 * r, 2 * r + 2), "cpu") for r in range(n)]
    jstate = copied(state)
    flips = []
    for key in keys:
        jstate, jl = step_fn(jstate, cur, src, key)
        draws = [port_draws(jax.random.fold_in(key, r), 2, 1) for r in range(n)]
        flips.append([f for _, f in draws])
        pl = step([(c, s, aug, flip) for (c, s), (aug, flip) in zip(shards, draws)])
        assert sorted(pl) == sorted(jl)
        for k in jl:
            assert abs(float(pl[k]) - float(jl[k])) <= 1e-4 * abs(float(jl[k])), k
    assert flips[0][0] and not flips[1][0]
    after = variables_to_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    port_sd = model.state_dict()
    diffs = np.concatenate([np.abs(port_sd[k].numpy() - after[k].numpy()).ravel()
                            for k, _ in model.named_parameters()])
    assert diffs.max() <= 4 * o.lr and np.median(diffs) < 1e-6
    stats = [k for k in port_sd if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in stats:
        assert rel(port_sd[k].numpy(), after[k].numpy()) < 1e-5, k
    # one count a step, however many shards ran
    assert all(int(v) == 2 for k, v in port_sd.items() if k.endswith("num_batches_tracked"))


def group_options(**extra):
    return options(Options, fill_depth_hints=True, num_workers=2, **extra)


def test_two_gloo_ranks_match_plain_collective(tmp_path, monkeypatch):
    """A spawned 2-process gloo group runs the real step at precision 16
    (``fixed_batch_steps``: each rank its block of the first global batch
    of 4, its own draws) for 2 steps; the plain collective over the same
    shards and draws in this process gives the same first-step vector
    after the collective, losses and state, bit for bit."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    o = group_options(batch_size=4)
    results = distributed.spawn(train_loop.fixed_batch_steps, 2, str(tmp_path), args=(o,),
                                backend="gloo", timeout_s=GROUP_TIMEOUT_S,
                                join_timeout_s=JOIN_TIMEOUT_S)
    assert not os.listdir(tmp_path)                     # the store and results removed

    assert o.precision == 16                            # the bf16 compute of the configs
    model = train_loop.init_train_state(o, common.build_model(o))
    optimizer, schedule = train_loop.make_optimizer(o, model)
    step = train_loop.make_sharded_train_step(train_loop.train_model_for(o, model), optimizer,
                                              schedule, use_hint_model=True, precision=16)
    ds = dataset_from_opts(o, split="train", disable_flip=True)
    loader = DataLoader(ds, 4, shuffle=True, num_workers=2, drop_last=True, seed=o.random_seed)
    batches = iter(loader)
    batch = next(batches)
    batches.close()
    whole = train_loop.train_batch(*batch, "cpu")
    shards = [rows(whole, 2 * r, 2 * r + 2) for r in range(2)]
    gens = [train_loop.rank_generator(o, r) for r in range(2)]
    for i in range(2):
        draws = [train_loop.draw_step_randomness(g, 2, s["image_bkhw3"].shape[1])
                 for g, (_, s) in zip(gens, shards)]
        losses = step([(c, s, aug, flip) for (c, s), (aug, flip) in zip(shards, draws)])
        if i == 0:
            for res in results:
                assert torch.equal(res["reduced"], step.reduced)
            assert not torch.equal(step.flats[0], step.reduced)   # the shards differ
        for res in results:
            assert res["losses"][i] == {k: float(v) for k, v in losses.items()}, i
    for res in results:
        assert res["flat_bytes"] == res["reduced"].numel() * 4
        for k, v in model.state_dict().items():
            assert torch.equal(res["state"][k], v), k


def test_loader_shard():
    """The rows of n ranks' loaders, each rendering only its block, are the
    one-process loader's batches, for n = 1, 2, 4 over two shuffled
    epochs; a batch that does not divide, or a shard without drop_last, is
    refused."""
    ds = dataset_from_opts(options(Options), split="train")
    kw = dict(shuffle=True, num_workers=2, drop_last=True, seed=3)
    whole = DataLoader(ds, 4, **kw)
    ref = [b for _, b in zip(range(len(whole) + 1), DataLoader(ds, 4, infinite=True, **kw))]
    for n in (1, 2, 4):
        parts = []
        for r in range(n):
            loader = DataLoader(ds, 4, infinite=True, shard=(r, n), **kw)
            parts.append([b for _, b in zip(range(len(ref)), loader)])
        for i, want in enumerate(ref):
            for key, value in want[0].items():
                if key in STAGED_KEYS:
                    continue
                got = [parts[r][i][0][key] for r in range(n)]
                if isinstance(value, list):
                    assert sum(got, []) == value, (n, i, key)
                else:
                    np.testing.assert_array_equal(np.concatenate(got), value)
            # the images, gathered from each batch's staged frames
            got = [common.device_batch(*parts[r][i], "cpu") for r in range(n)]
            images = common.device_batch(*want, "cpu")
            for part, key in ((0, "image_bhw3"), (1, "image_bkhw3")):
                assert torch.equal(torch.cat([g[part][key] for g in got]), images[part][key])
    with pytest.raises(ValueError, match="divides"):
        DataLoader(ds, 4, drop_last=True, shard=(0, 3))
    with pytest.raises(ValueError, match="drop_last"):
        DataLoader(ds, 4, shard=(0, 2))


def test_world_size():
    """0 devices: one process on the CPU; a world that does not divide the
    batch is refused."""
    cpu = torch.device("cpu")
    assert train_loop.world_size(group_options(batch_size=4), cpu) == 1
    assert train_loop.world_size(group_options(batch_size=4, num_devices=2), cpu) == 2
    with pytest.raises(ValueError, match="does not divide"):
        train_loop.world_size(group_options(batch_size=4, num_devices=3), cpu)


def test_train_two_processes_on_cpu(tmp_path, monkeypatch):
    """train(num_devices=2) on the CPU for 2 steps with validation at step
    2: rank 0 writes the checkpoints, ``best`` and the final .ckpt; the
    returned model is rank 0's and the .ckpt holds it; it loads into the
    JAX package too and both give the same s0 depth (1e-4 relative). The
    model uses the modules the JAX converter maps, as
    tests/test_torch_training.py::test_train_end_to_end."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    monkeypatch.setattr(distributed, "TIMEOUT_S", GROUP_TIMEOUT_S)
    extra = dict(image_encoder_name="efficientnet", matching_encoder_type="resnet",
                 name="train_dp", log_dir=str(tmp_path), max_steps=2, val_interval=2,
                 val_batches=1, val_batch_size=2, log_interval=1,
                 image_log_interval=10 ** 9, batch_size=4, num_devices=2)
    o = group_options(**extra)
    res = train_loop.train(o)
    assert res["step"] == 2 and np.isfinite(res["losses"]["loss"])
    log_dir = tmp_path / "train_dp"
    assert sorted(os.listdir(log_dir / "checkpoints")) == ["step_00000002.pt"]
    assert sorted(os.listdir(log_dir / "best")) == ["step_00000002.pt"]
    assert not [p for p in os.listdir(log_dir) if p.startswith("dist_")]
    assert len(res["optimizer"].state_dict()["state"]) > 0

    lo = group_options(**{**extra, "load_weights_from_checkpoint": res["final_weights"]})
    model = common.init_or_load_params(lo, common.build_model(lo))
    for k, v in res["model"].state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    jmodel = jcommon.build_model(options(JaxOptions, image_encoder_name="efficientnet",
                                         matching_encoder_type="resnet"))
    variables = jax_load_params(res["final_weights"])
    ds = dataset_from_opts(lo, split="val")
    cur_np, src_np = collate([ds[0], ds[1]])
    ref = jax.jit(jmodel.apply)(variables, *jcommon.device_batch(cur_np, src_np))
    with torch.no_grad():
        out = model(*common.device_batch(cur_np, src_np, "cpu"))["depth_pred_s0_bhw1"]
    assert rel(out.numpy(), ref["depth_pred_s0_bhw1"]) <= 1e-4
