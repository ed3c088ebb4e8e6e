"""Training: optimizer and schedule, the train step, and the train loop.

Counterpart of ``doubletake_tpu/training/train_loop.py`` (reference
train.py + sr_depth_model.py:528-689): AdamW lr 1e-4 wd 1e-4 with x0.1 steps
at 70k and 80k, the full loss cocktail, flip and color augmentation,
periodic validation over several validation sets, checkpoints with resume,
TensorBoard scalars and image panels.

Data parallelism (the JAX package's ``shard_map`` step, train_loop.py:189-226,
with the same semantics by another mechanism): ``train()`` runs one process
per device when its world (``Options.num_devices``, 0 = every visible CUDA
device, one process on the CPU) is above 1, joined in a
``torch.distributed`` group (``training/distributed.py``). Each rank renders
its block of every global batch of ``batch_size`` rows, runs the forward and
backward on it with batch-norm batch statistics of its own rows (the
reference's DDP semantics; no ``SyncBatchNorm``), then ravels its float32
gradients, the running mean and variance of every batch norm and its losses
into one vector, and averages it over the ranks in ONE all-reduce (the JAX
step's ``psum(flat) / n_dev``); AdamW then steps the same way on every rank.
``num_batches_tracked`` (an integer JAX does not have) stays out of the
average. Not ``DistributedDataParallel``: its default ``broadcast_buffers``
copies rank 0's running statistics instead of averaging them, and it
all-reduces per bucket. Only rank 0 validates, logs and writes checkpoints;
the others wait at a barrier. A world of 1 takes the one-device step, as
the JAX package does on one device. ``make_sharded_train_step`` is the plain
version of the collective: the shards of a global batch one after another in
one process, their vectors summed; the tests and chip_smoke.py hold the
process group to it, and nothing on the training path runs it.

Mixed precision (opts.precision == 16, the reference's fp16-AMP analogue):
master parameters, optimizer state and batch-norm running statistics stay
float32; the forward and backward compute in bf16 because the parameters
are cast to bf16 inside the loss (a differentiable cast through
``torch.func.functional_call``), so the gradients come out float32. The
module that runs the step has compute dtype bf16, so the images are cast to
match (``train_model_for``). Not ``torch.autocast``: autocast keeps some
layers in float32 and so computes another function than the JAX step.

The randomness of a step (color-jitter factors per image, the flip coin) is
an explicit input of the step; ``draw_step_randomness`` draws it from a
``torch.Generator`` of each rank, seeded with random_seed + 1 + rank
(``rank_generator``), so rank 0 keeps the one-device stream and every rank
draws its own factors and coin (the JAX step folds the device index into
its key).
"""

from __future__ import annotations

import copy
import os
import time
from typing import Dict

import numpy as np
import torch
from torch.func import functional_call

from doubletake_tpu_torch import losses as losses_mod
from doubletake_tpu_torch.checkpoints.convert import lazy_load_state_dict, load_weights
from doubletake_tpu_torch.checkpoints.io import (
    restore_train_state,
    save_params,
    save_train_state,
)
from doubletake_tpu_torch.models.layers import init_parameters
from doubletake_tpu_torch.options import Options
from doubletake_tpu_torch.runners import common
from doubletake_tpu_torch.training.augmentation import apply_jitter, draw_jitter
from doubletake_tpu_torch.utils.geometry import normals_from_depth
from doubletake_tpu_torch.utils.metrics import compute_depth_metrics_batched

TRAIN_CUR_KEYS = common.CUR_KEYS + ("depth_bhw1", "mask_b_bhw1")
TRAIN_SRC_KEYS = common.SRC_KEYS + ("depth_bkhw1", "K_s0_bk44")
HINT_KEYS = ("depth_hint_bhw1", "hint_mask_bhw1", "sampled_weights_bhw1")


def train_batch(cur_np, src_np, device):
    """The step's (cur, src) tensors on ``device`` from a loader batch
    (``common.device_batch`` with the train step's keys)."""
    return common.device_batch(cur_np, src_np, device, TRAIN_CUR_KEYS + HINT_KEYS,
                               TRAIN_SRC_KEYS)


def lr_schedule(opts: Options):
    """step -> learning rate: opts.lr times 0.1 for each of opts.lr_steps the
    step has reached, in float32 (optax.piecewise_constant_schedule, as the
    JAX package's make_optimizer builds it)."""
    bounds = sorted(int(s) for s in opts.lr_steps)

    def schedule(step: int) -> float:
        v = np.float32(opts.lr)
        for bound in bounds:
            if step >= bound:
                v = np.float32(0.1) * v
        return float(v)

    return schedule


def make_optimizer(opts: Options, model: torch.nn.Module):
    """AdamW (betas 0.9 / 0.999, eps 1e-8, decoupled weight decay opts.wd)
    over the model's parameters and its schedule; the train step sets the
    learning rate of each update from the schedule."""
    schedule = lr_schedule(opts)
    optimizer = torch.optim.AdamW(model.parameters(), lr=schedule(0), betas=(0.9, 0.999),
                                  eps=1e-8, weight_decay=opts.wd)
    return optimizer, schedule


def train_model_for(opts: Options, model: torch.nn.Module) -> torch.nn.Module:
    """The module the train step runs: ``model`` itself, or with
    opts.precision == 16 a shallow copy whose compute dtype is bf16 and
    which shares the model's parameters and buffers (its submodules are the
    model's)."""
    if opts.precision == 16 and model.compute_dtype == torch.float32:
        twin = copy.copy(model)
        twin.compute_dtype = torch.bfloat16
        return twin
    return model


def draw_step_randomness(generator: torch.Generator, b: int, k: int, device=None):
    """A step's (aug, flip): color-jitter factors for the current images and
    for each of the k source views, and the 50% flip coin."""
    aug = {"cur": draw_jitter(b, generator, device=device),
           "src": [draw_jitter(b, generator, device=device) for _ in range(k)]}
    flip = bool(torch.rand((), generator=generator) < 0.5)
    return aug, flip


def augment(cur, src, aug):
    """The batch with its images color-jittered by ``aug``."""
    cur = dict(cur, image_bhw3=apply_jitter(cur["image_bhw3"], aug["cur"]))
    src_imgs = src["image_bkhw3"]
    src = dict(src, image_bkhw3=torch.stack(
        [apply_jitter(src_imgs[:, i], f) for i, f in enumerate(aug["src"])], 1))
    return cur, src


def step_losses(model, cur, src, use_hint_model: bool, flip: bool, params=None):
    """Forward in train mode and the loss dict. ``params``: the parameters to
    call the model with (``functional_call``), or None for its own."""
    hint = None
    if use_hint_model and "depth_hint_bhw1" in cur:
        hint = {k: cur[k] for k in HINT_KEYS}
    kwargs = {"hint": hint, "flip": flip}
    if params is None:
        outputs = model(cur, src, **kwargs)
    else:
        outputs = functional_call(model, params, (cur, src), kwargs, strict=False)
    depth_gt, invK_s0 = cur["depth_bhw1"], cur["invK_s0_b44"]
    finite = torch.isfinite(depth_gt)
    normals_gt = normals_from_depth(torch.where(finite, depth_gt, torch.zeros_like(depth_gt)),
                                    invK_s0)
    normals_gt = torch.where(finite, normals_gt, torch.full_like(normals_gt, float("nan")))
    normals_pred = normals_from_depth(outputs["depth_pred_s0_bhw1"], invK_s0)
    return losses_mod.compute_losses(cur, src, outputs, normals_gt, normals_pred), outputs


def _step_parts(model, optimizer, schedule, use_hint_model: bool, precision: int):
    """The pieces every train step shares: ``local(cur, src, aug, flip)``
    runs the forward and backward (gradients in ``.grad``, the batch norms'
    running statistics updated in place) and returns the loss dict;
    ``update(count)`` takes the AdamW step at the schedule's rate of update
    ``count``; ``pack`` / ``unpack`` ravel the float32 gradients, running
    means and variances and the losses into one vector and back."""
    if precision == 16 and model.compute_dtype != torch.bfloat16:
        raise ValueError("precision=16 needs a bf16-compute model; build it with "
                         "training.train_loop.train_model_for(opts, model)")
    params = [p for p in model.parameters() if p.requires_grad]
    stats = [buf for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)
             for buf in (m.running_mean, m.running_var)]

    def local(cur, src, aug, flip):
        model.train()
        cur, src = augment(cur, src, aug)
        cast = None
        if precision == 16:
            cast = {n: p.to(torch.bfloat16) for n, p in model.named_parameters()}
        loss_dict, _ = step_losses(model, cur, src, use_hint_model, flip, cast)
        optimizer.zero_grad(set_to_none=True)
        loss_dict["loss"].backward()
        return loss_dict

    def pack(loss_dict):
        # a parameter without a gradient gets zeros, as JAX's grads have
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        return torch.cat([t.reshape(-1).float() for t in grads + stats]
                         + [torch.stack([v.detach().float() for v in loss_dict.values()])])

    def unpack(flat, loss_dict):
        i = 0
        for p in params:
            p.grad = flat[i: i + p.numel()].view_as(p).to(p.dtype)
            i += p.numel()
        for s in stats:
            s.copy_(flat[i: i + s.numel()].view_as(s))
            i += s.numel()
        return {k: flat[i + j].to(v.dtype) for j, (k, v) in enumerate(loss_dict.items())}

    def update(count):
        for group in optimizer.param_groups:
            group["lr"] = schedule(count)
        optimizer.step()

    return local, pack, unpack, update


def make_train_step(model, optimizer, schedule, use_hint_model: bool = False,
                    precision: int = 32, reduce=None):
    """step(cur, src, aug, flip) -> loss dict: one AdamW update of the
    model's parameters (and its batch-norm running statistics), the
    learning rate from ``schedule`` at the step's index. ``step.count`` is
    the number of updates taken.

    ``reduce``: the data-parallel step's collective (``distributed.
    all_reduce_mean``): the step's gradients, running statistics and losses
    go through it as one flat vector before the update, and the loss dict
    returned is the average. None: the one-device step.

    precision == 16: bf16 compute with float32 master parameters (module
    doc); ``model`` must have compute dtype bf16 (``train_model_for``).
    """
    local, pack, unpack, update = _step_parts(model, optimizer, schedule, use_hint_model,
                                              precision)

    def step(cur, src, aug, flip):
        loss_dict = local(cur, src, aug, flip)
        if reduce is not None:
            flat = pack(loss_dict)
            step.flat_bytes = flat.numel() * flat.element_size()
            loss_dict = unpack(reduce(flat), loss_dict)
        update(step.count)
        step.count += 1
        return {k: v.detach() for k, v in loss_dict.items()}

    step.count = 0
    step.flat_bytes = 0
    return step


def make_sharded_train_step(model, optimizer, schedule, use_hint_model: bool = False,
                            precision: int = 32):
    """The plain version of the data-parallel step's collective, in one
    process: step(shards) with ``shards`` a list of (cur, src, aug, flip),
    one per rank. Each shard's forward and backward start from the same
    weights and running statistics; their flat vectors are summed in shard
    order and divided by their count, then one update is taken, as every
    rank of ``make_train_step(reduce=all_reduce_mean)`` takes it. The last
    step's vectors stay readable: ``step.flats`` (one a shard, before the
    average) and ``step.reduced`` (the average). For the tests and
    chip_smoke.py; nothing on the training path runs it."""
    local, pack, unpack, update = _step_parts(model, optimizer, schedule, use_hint_model,
                                              precision)
    buffers = [b for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)
               for b in m.buffers()]

    def step(shards):
        start = [b.clone() for b in buffers]
        step.flats = []
        for cur, src, aug, flip in shards:
            for b, v in zip(buffers, start):   # each rank's forward sees the same state
                b.copy_(v)
            loss_dict = local(cur, src, aug, flip)
            step.flats.append(pack(loss_dict))
        step.reduced = sum(step.flats[1:], step.flats[0]) / len(shards)
        loss_dict = unpack(step.reduced, loss_dict)
        update(step.count)
        step.count += 1
        return {k: v.detach() for k, v in loss_dict.items()}

    step.count = 0
    step.flats, step.reduced = [], None
    return step


def make_eval_step(model):
    """eval_step(cur, src) -> {metric: mean over the batch}: the model in
    eval mode, without a hint (as the JAX package's eval step), metrics
    against the finite GT."""

    @torch.no_grad()
    def eval_step(cur, src):
        model.eval()
        outputs = model(cur, src)
        depth_gt = cur["depth_bhw1"]
        b = depth_gt.shape[0]
        valid = torch.isfinite(depth_gt).reshape(b, -1)
        metrics = compute_depth_metrics_batched(
            depth_gt.reshape(b, -1), outputs["depth_pred_s0_bhw1"].reshape(b, -1), valid)
        return {k: float(torch.nanmean(v.float())) for k, v in metrics.items()}

    return eval_step


def init_train_state(opts: Options, model: torch.nn.Module) -> torch.nn.Module:
    """Initialise the model from a generator seeded with opts.random_seed,
    then copy opts.load_weights_from_checkpoint's entries whose names and
    shapes match over it (the JAX package's lazy_load_params)."""
    device = next(model.parameters()).device
    model.cpu()
    init_parameters(model, torch.Generator().manual_seed(opts.random_seed))
    model.to(device)
    if opts.load_weights_from_checkpoint:
        lazy_load_state_dict(model, load_weights(opts.load_weights_from_checkpoint))
    return model


def world_size(opts: Options, device: torch.device) -> int:
    """The data-parallel world: opts.num_devices, or with 0 every visible
    CUDA device (one process on the CPU). The global batch must divide into
    equal blocks, as the JAX step requires."""
    n = opts.num_devices or (torch.cuda.device_count() if device.type == "cuda" else 1)
    if device.type == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"num_devices={n} but {torch.cuda.device_count()} CUDA devices are "
                         "visible")
    if opts.batch_size % n:
        raise ValueError(f"batch_size={opts.batch_size} does not divide over {n} devices")
    return n


def rank_generator(opts: Options, rank: int) -> torch.Generator:
    """The generator of rank ``rank``'s step randomness: seeded with
    random_seed + 1 + rank, so rank 0 draws the one-device stream."""
    return torch.Generator().manual_seed(opts.random_seed + 1 + rank)


def train(opts: Options):
    """The training loop with validation, checkpoints and TensorBoard logs,
    in one process per device when the world (``world_size``) is above 1.
    Returns {"model", "optimizer", "step", "final_weights", "losses"}: rank
    0's, on ``opts.device`` (cuda:0 for a CUDA run)."""
    from doubletake_tpu_torch.options import OptionsHandler
    from doubletake_tpu_torch.training import distributed
    from doubletake_tpu_torch.utils.io import copy_code_state

    device = common.resolve_device(opts)
    world = world_size(opts, device)
    log_dir = os.path.join(opts.log_dir, opts.name)
    os.makedirs(log_dir, exist_ok=True)
    # reproducibility snapshot: code + merged options (train.py:349-356)
    copy_code_state(os.path.join(log_dir, "code"))
    OptionsHandler.save_options_as_yaml(os.path.join(log_dir, "options.yaml"), opts)
    if world == 1:
        return train_rank(0, 1, opts)

    res = distributed.spawn(_train_worker, world, log_dir, args=(opts,),
                            backend=distributed.default_backend(device),
                            timeout_s=distributed.TIMEOUT_S)[0]
    model = common.build_model(opts)
    model.load_state_dict(res.pop("model"))
    optimizer, _ = make_optimizer(opts, model)
    optimizer.load_state_dict(res.pop("optimizer"))
    return {"model": model, "optimizer": optimizer, **res}


def _train_worker(rank: int, world: int, opts: Options):
    """A spawned rank of ``train``: rank 0 returns its result with the model
    and optimizer as state dicts on the host; the others return None."""
    res = train_rank(rank, world, opts)
    if rank:
        return None
    return {**res, "model": {k: v.cpu() for k, v in res["model"].state_dict().items()},
            "optimizer": res["optimizer"].state_dict()}


def train_rank(rank: int, world: int, opts: Options):
    """Rank ``rank`` of a ``world``-rank training run (the whole run for a
    world of 1); the ranks above 0 are spawned by ``train`` and joined in
    its process group."""
    from doubletake_tpu_torch.data.loader import DataLoader
    from doubletake_tpu_torch.datasets.registry import dataset_from_opts
    from doubletake_tpu_torch.training import distributed

    device = common.resolve_device(opts)
    lead = rank == 0
    log_dir = os.path.join(opts.log_dir, opts.name)
    writer = _make_writer(log_dir) if lead else None

    train_ds = dataset_from_opts(opts, split="train", disable_flip=True)
    train_loader = DataLoader(train_ds, opts.batch_size, shuffle=True,
                              num_workers=opts.num_workers, drop_last=True, infinite=True,
                              seed=opts.random_seed, shard=(rank, world))
    # validation protocol (reference train.py:79-206): with depth hints, four
    # loaders at hint-aug 0.5 / 1.0 (all empty) / 0.0 / 0.0; the first drives
    # the best checkpoint through val_0_metrics/a5. Rank 0 validates.
    val_augs = [0.5, 1.0, 0.0, 0.0] if opts.fill_depth_hints else [opts.depth_hint_aug]
    val_loaders = [
        DataLoader(dataset_from_opts(opts, split="val", disable_flip=True, depth_hint_aug=aug,
                                     include_full_res_depth=opts.high_res_validation),
                   opts.val_batch_size, shuffle=False,
                   num_workers=max(opts.num_workers // 2, 1), drop_last=True)
        for aug in val_augs] if lead else []

    model = init_train_state(opts, common.build_model(opts))
    train_model = train_model_for(opts, model)
    use_hint = "hint" in opts.feature_volume_type
    optimizer, schedule = make_optimizer(opts, model)
    train_step = make_train_step(train_model, optimizer, schedule, use_hint_model=use_hint,
                                 precision=opts.precision,
                                 reduce=distributed.all_reduce_mean if world > 1 else None)
    # validation in float32 master precision, the model in eval mode
    eval_step = make_eval_step(model)

    ckpt_dir = os.path.join(log_dir, "checkpoints")
    start_step = 0
    if opts.resume:
        restored = restore_train_state(opts.resume, model, optimizer)
        if restored is not None:
            start_step = restored
            if lead:
                print(f"resumed from step {start_step}")
    train_step.count = start_step

    generator = rank_generator(opts, rank)
    it = iter(train_loader)
    t0 = time.time()
    step = start_step
    best_a5 = -1.0
    loss_dict: Dict[str, torch.Tensor] = {}
    profiler = None
    try:
        while step < opts.max_steps:
            batch = next(it)
            cur, src = train_batch(*batch, device)
            aug, flip = draw_step_randomness(generator, cur["image_bhw3"].shape[0],
                                             src["image_bkhw3"].shape[1], device)
            if lead and opts.profile_dir and step - start_step == 20:
                profiler = _start_profile()
            loss_dict = train_step(cur, src, aug, flip)
            step += 1
            if profiler is not None and step - start_step == 25:
                _stop_profile(profiler, opts.profile_dir)
                profiler = None

            if lead and step % opts.log_interval == 0:
                scalars = {f"train/{k}": float(v) for k, v in loss_dict.items()}
                # the global batch: every rank's rows
                rate = opts.log_interval * opts.batch_size / (time.time() - t0)
                t0 = time.time()
                scalars["train/samples_per_sec"] = rate
                scalars["train/lr"] = schedule(step)
                _write_scalars(writer, scalars, step)
                print(f"step {step}: loss {scalars['train/loss']:.4f} ({rate:.1f} samples/s, "
                      f"lr {scalars['train/lr']:.3g})")

            if lead and step % opts.image_log_interval == 0:
                _log_image_panels(writer, model, cur, src, use_hint, step)

            if step % opts.val_interval == 0:
                if lead:
                    scalars = validate(opts, model, eval_step, val_loaders, device)
                    _write_scalars(writer, scalars, step)
                    print(f"step {step} val: " + ", ".join(
                        f"{k.rsplit('/', 1)[0].split('_')[1]}:{k.split('/')[-1]}={v:.4f}"
                        for k, v in scalars.items() if k.endswith(("a5", "abs_diff"))))
                    save_train_state(ckpt_dir, step, model, optimizer)
                    # best-checkpoint selection on val_0_metrics/a5 (train.py:223-230)
                    a5 = scalars.get("val_0_metrics/a5")
                    if a5 is not None and a5 > best_a5:
                        best_a5 = a5
                        save_train_state(os.path.join(log_dir, "best"), step, model,
                                         optimizer)
                if world > 1:
                    torch.distributed.barrier()
    finally:
        it.close()
        if writer is not None:
            writer.close()

    final = os.path.join(log_dir, "final_weights.ckpt")
    if lead:
        save_train_state(ckpt_dir, step, model, optimizer)
        save_params(final, model.state_dict())
    return {"model": model, "optimizer": optimizer, "step": step, "final_weights": final,
            "losses": {k: float(v) for k, v in loss_dict.items()}}


def fixed_batch_steps(rank: int, world: int, opts: Options, steps: int = 2):
    """``steps`` train steps of rank ``rank`` on its block of rows
    (``shard=(rank, world)``) of the first global batch of ``opts``'
    training loader, with its own draws (``rank_generator``), from
    ``init_train_state``'s weights: in a process group the data-parallel
    step (``make_train_step(reduce=all_reduce_mean)``, also for a world of
    1), else the one-device step. The entry ``distributed.spawn`` starts
    for the tests and chip_smoke.py, which hold it to
    ``make_sharded_train_step``; nothing on the training path runs it.

    Returns {"losses": [loss dict of each step], "state": the model's state
    dict on the host, "reduced": the first step's flat vector after the
    collective, on the host (None outside a group), "step_ms": host ms of
    each step (the first's includes that copy), "flat_bytes"}."""
    from doubletake_tpu_torch.data.loader import DataLoader
    from doubletake_tpu_torch.datasets.registry import dataset_from_opts
    from doubletake_tpu_torch.training import distributed

    device = common.resolve_device(opts)
    ds = dataset_from_opts(opts, split="train", disable_flip=True)
    loader = DataLoader(ds, opts.batch_size, shuffle=True, num_workers=opts.num_workers,
                        drop_last=True, seed=opts.random_seed, shard=(rank, world))
    batches = iter(loader)
    cur, src = train_batch(*next(batches), device)
    batches.close()
    model = init_train_state(opts, common.build_model(opts))
    optimizer, schedule = make_optimizer(opts, model)
    reduced = []

    def reduce(flat):
        flat = distributed.all_reduce_mean(flat)
        if not reduced:
            reduced.append(flat.cpu())
        return flat

    step = make_train_step(train_model_for(opts, model), optimizer, schedule,
                           use_hint_model="hint" in opts.feature_volume_type,
                           precision=opts.precision,
                           reduce=reduce if torch.distributed.is_initialized() else None)
    generator = rank_generator(opts, rank)
    losses, times = [], []
    for _ in range(steps):
        aug, flip = draw_step_randomness(generator, cur["image_bhw3"].shape[0],
                                         src["image_bkhw3"].shape[1], device)
        t0 = time.perf_counter()
        out = step(cur, src, aug, flip)
        losses.append({k: float(v) for k, v in out.items()})   # synchronises
        times.append((time.perf_counter() - t0) * 1e3)
    return {"losses": losses, "state": {k: v.cpu() for k, v in model.state_dict().items()},
            "reduced": reduced[0] if reduced else None, "step_ms": times,
            "flat_bytes": step.flat_bytes}


def validate(opts: Options, model, eval_step, val_loaders, device) -> Dict[str, float]:
    """{f"val_{i}_metrics/{name}": mean over up to opts.val_batches batches}
    of each validation loader."""
    scalars = {}
    for li, val_loader in enumerate(val_loaders):
        vmetrics: Dict[str, list] = {}
        batches = iter(val_loader)
        for vi, vb in enumerate(batches):
            if vi >= opts.val_batches:
                break
            vc, vs = train_batch(*vb, device)
            if opts.high_res_validation and "full_res_depth_bhw1" in vb[0]:
                # metrics against the full-resolution GT (sr_depth_model.py:622-630)
                with torch.no_grad():
                    model.eval()
                    pred = model(vc, vs)["depth_pred_s0_bhw1"]
                    fm = common.frame_metrics(
                        pred, torch.as_tensor(vb[0]["full_res_depth_bhw1"]).to(device))
                m = {k: float(torch.nanmean(v.float())) for k, v in fm.items()}
            else:
                m = eval_step(vc, vs)
            for k, v in m.items():
                vmetrics.setdefault(k, []).append(v)
        batches.close()
        scalars.update({f"val_{li}_metrics/{k}": float(np.mean(v))
                        for k, v in vmetrics.items()})
    return scalars


def _log_image_panels(writer, model, cur, src, use_hint, step):
    """TensorBoard image panels: depth prediction and GT, the volume's
    lowest-cost depth, the hint (reference doubletake_model.py:566-630)."""
    if writer is None:
        return
    from doubletake_tpu_torch.utils.io import reverse_imagenet_normalize
    from doubletake_tpu_torch.utils.visualization import colormap_image

    hint = None
    if use_hint and "depth_hint_bhw1" in cur:
        hint = {k: cur[k] for k in HINT_KEYS}
    with torch.no_grad():
        model.eval()
        outputs = model(cur, src, hint=hint)
    host = lambda x: x[0].float().cpu().numpy()  # noqa: E731
    panels = {
        "image": np.clip(reverse_imagenet_normalize(host(cur["image_bhw3"])), 0.0, 1.0),
        "depth_pred": colormap_image(host(outputs["depth_pred_s0_bhw1"])),
        "depth_gt": colormap_image(host(cur["depth_bhw1"])),
        "lowest_cost": colormap_image(host(outputs["lowest_cost_bhw"])),
    }
    if hint is not None:
        panels["depth_hint"] = colormap_image(np.nan_to_num(host(hint["depth_hint_bhw1"])))
        panels["hint_weights"] = colormap_image(host(hint["sampled_weights_bhw1"]))
    for name, img in panels.items():
        writer.add_image(f"train_images/{name}", img, step, dataformats="HWC")


def _make_writer(log_dir):
    """A TensorBoard writer, or None where tensorboard is not installed."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir)


def _write_scalars(writer, scalars: Dict[str, float], step: int):
    if writer is None:
        return
    for k, v in scalars.items():
        writer.add_scalar(k, v, step)
    writer.flush()


def _start_profile():
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    return prof


def _stop_profile(prof, profile_dir):
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "train_trace.json"))
    print(f"profiler trace written to {profile_dir}")
