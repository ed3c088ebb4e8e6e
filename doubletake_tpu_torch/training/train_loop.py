"""Training: optimizer and schedule, the train step, and the train loop.

Counterpart of ``doubletake_tpu/training/train_loop.py`` (reference
train.py + sr_depth_model.py:528-689): AdamW lr 1e-4 wd 1e-4 with x0.1 steps
at 70k and 80k, the full loss cocktail, flip and color augmentation,
periodic validation over several validation sets, checkpoints with resume,
TensorBoard scalars and image panels. One device; the JAX package's
data-parallel ``shard_map`` step (train_loop.py:189-226) is not ported yet.

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
``torch.Generator`` seeded with random_seed + 1.
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
    """The step's (cur, src) tensors on ``device`` from a loader batch."""
    cur = {k: torch.as_tensor(cur_np[k]).to(device)
           for k in TRAIN_CUR_KEYS + HINT_KEYS if k in cur_np}
    src = {k: torch.as_tensor(src_np[k]).to(device) for k in TRAIN_SRC_KEYS if k in src_np}
    return cur, src


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


def make_train_step(model, optimizer, schedule, use_hint_model: bool = False,
                    precision: int = 32):
    """step(cur, src, aug, flip) -> loss dict: one AdamW update of the
    model's parameters (and its batch-norm running statistics), the
    learning rate from ``schedule`` at the step's index. ``step.count`` is
    the number of updates taken.

    precision == 16: bf16 compute with float32 master parameters (module
    doc); ``model`` must have compute dtype bf16 (``train_model_for``).
    """
    if precision == 16 and model.compute_dtype != torch.bfloat16:
        raise ValueError("precision=16 needs a bf16-compute model; build it with "
                         "training.train_loop.train_model_for(opts, model)")

    def step(cur, src, aug, flip):
        model.train()
        cur, src = augment(cur, src, aug)
        params = None
        if precision == 16:
            params = {n: p.to(torch.bfloat16) for n, p in model.named_parameters()}
        loss_dict, _ = step_losses(model, cur, src, use_hint_model, flip, params)
        optimizer.zero_grad(set_to_none=True)
        loss_dict["loss"].backward()
        for group in optimizer.param_groups:
            group["lr"] = schedule(step.count)
        optimizer.step()
        step.count += 1
        return {k: v.detach() for k, v in loss_dict.items()}

    step.count = 0
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


def train(opts: Options):
    """The training loop with validation, checkpoints and TensorBoard logs.
    Returns {"model", "optimizer", "step", "final_weights", "losses"}."""
    from doubletake_tpu_torch.data.loader import DataLoader
    from doubletake_tpu_torch.datasets.registry import dataset_from_opts
    from doubletake_tpu_torch.options import OptionsHandler
    from doubletake_tpu_torch.utils.io import copy_code_state

    device = common.resolve_device(opts)
    log_dir = os.path.join(opts.log_dir, opts.name)
    os.makedirs(log_dir, exist_ok=True)
    writer = _make_writer(log_dir)
    # reproducibility snapshot: code + merged options (train.py:349-356)
    copy_code_state(os.path.join(log_dir, "code"))
    OptionsHandler.save_options_as_yaml(os.path.join(log_dir, "options.yaml"), opts)

    train_ds = dataset_from_opts(opts, split="train", disable_flip=True)
    train_loader = DataLoader(train_ds, opts.batch_size, shuffle=True,
                              num_workers=opts.num_workers, drop_last=True, infinite=True,
                              seed=opts.random_seed)
    # validation protocol (reference train.py:79-206): with depth hints, four
    # loaders at hint-aug 0.5 / 1.0 (all empty) / 0.0 / 0.0; the first drives
    # the best checkpoint through val_0_metrics/a5
    val_augs = [0.5, 1.0, 0.0, 0.0] if opts.fill_depth_hints else [opts.depth_hint_aug]
    val_loaders = [
        DataLoader(dataset_from_opts(opts, split="val", disable_flip=True, depth_hint_aug=aug,
                                     include_full_res_depth=opts.high_res_validation),
                   opts.val_batch_size, shuffle=False,
                   num_workers=max(opts.num_workers // 2, 1), drop_last=True)
        for aug in val_augs]

    model = init_train_state(opts, common.build_model(opts))
    train_model = train_model_for(opts, model)
    use_hint = "hint" in opts.feature_volume_type
    optimizer, schedule = make_optimizer(opts, model)
    train_step = make_train_step(train_model, optimizer, schedule, use_hint_model=use_hint,
                                 precision=opts.precision)
    # validation in float32 master precision, the model in eval mode
    eval_step = make_eval_step(model)

    ckpt_dir = os.path.join(log_dir, "checkpoints")
    start_step = 0
    if opts.resume:
        restored = restore_train_state(opts.resume, model, optimizer)
        if restored is not None:
            start_step = restored
            print(f"resumed from step {start_step}")
    train_step.count = start_step

    generator = torch.Generator().manual_seed(opts.random_seed + 1)
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
            if opts.profile_dir and step - start_step == 20:
                profiler = _start_profile()
            loss_dict = train_step(cur, src, aug, flip)
            step += 1
            if profiler is not None and step - start_step == 25:
                _stop_profile(profiler, opts.profile_dir)
                profiler = None

            if step % opts.log_interval == 0:
                scalars = {f"train/{k}": float(v) for k, v in loss_dict.items()}
                rate = opts.log_interval * opts.batch_size / (time.time() - t0)
                t0 = time.time()
                scalars["train/samples_per_sec"] = rate
                scalars["train/lr"] = schedule(step)
                _write_scalars(writer, scalars, step)
                print(f"step {step}: loss {scalars['train/loss']:.4f} ({rate:.1f} samples/s, "
                      f"lr {scalars['train/lr']:.3g})")

            if step % opts.image_log_interval == 0:
                _log_image_panels(writer, model, cur, src, use_hint, step)

            if step % opts.val_interval == 0:
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
                    save_train_state(os.path.join(log_dir, "best"), step, model, optimizer)
    finally:
        it.close()
        if writer is not None:
            writer.close()

    save_train_state(ckpt_dir, step, model, optimizer)
    final = os.path.join(log_dir, "final_weights.ckpt")
    save_params(final, model.state_dict())
    return {"model": model, "optimizer": optimizer, "step": step, "final_weights": final,
            "losses": {k: float(v) for k, v in loss_dict.items()}}


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
