"""Seeded weights for the reference model, made on the device in a few calls.

Every convolution and linear weight is drawn from a truncated normal with
the lecun-normal scale (std 1/sqrt(fan_in) / 0.8796, cut at two standard
deviations), every bias is zero, batch norms are the identity (scale 1,
shift 0, running mean 0, running variance 1) and the blur-pool filters are
the fixed binomial ones. All truncated-normal draws come from one uniform
draw of a ``torch.Generator`` seeded with the run's seed, so one seed gives
one set of weights on a given device type.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from benchmark.reference.layers import BlurPool, blur_filter
from benchmark.reference.model import DepthModelCVHint

TRUNC_STD = 0.87962566103423978   # std of a unit normal cut to [-2, 2]


def build(config: dict, device="meta") -> DepthModelCVHint:
    """The reference model for ``config`` (a configuration file's options)."""
    with torch.device(device):
        model = DepthModelCVHint(
            image_encoder_name=config["image_encoder_name"],
            depth_decoder_name=config["depth_decoder_name"],
            matching_num_depth_bins=config["matching_num_depth_bins"],
            matching_feature_dims=config["matching_feature_dims"],
            model_num_views=config["model_num_views"],
            min_matching_depth=config["min_matching_depth"],
            max_matching_depth=config["max_matching_depth"],
            plane_chunk=config["plane_chunk"])
    return model.eval()


def make_state_dict(config: dict, seed: int, device) -> dict:
    """{name: tensor} for the reference model (and the port's, whose names
    are the same), float32 on ``device``. ``config``: a configuration
    file's contents; its ``depth_head`` scales the s0 depth head's weights
    and sets its bias, so that depths from random weights fall inside the
    fusion range."""
    head = config.get("depth_head")
    config = config["options"]
    model = build(config, "meta")
    dense = [(name, m) for name, m in model.named_modules()
             if isinstance(m, (nn.Conv2d, nn.Linear))]
    counts = [m.weight.numel() for _, m in dense]
    stds = torch.tensor([math.sqrt(1.0 / m.weight[0].numel()) / TRUNC_STD for _, m in dense],
                        dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(sum(counts), generator=gen, device=device, dtype=torch.float32)
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = lo + u * (1.0 - 2.0 * lo)
    draws = torch.erfinv(2.0 * u - 1.0).mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    draws.mul_(torch.repeat_interleave(stds, torch.tensor(counts, device=device)))
    chunks = iter(torch.split(draws, counts))

    state = {}
    for name, m in dense:
        state[f"{name}.weight"] = next(chunks).view(m.weight.shape)
    ones, zeros = [], []
    for name, t in model.state_dict().items():
        if name in state:
            continue
        owner = model.get_submodule(name.rsplit(".", 1)[0]) if "." in name else model
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(owner, BlurPool):
            state[name] = blur_filter(owner.channels).to(device)
        elif leaf == "num_batches_tracked":
            state[name] = torch.zeros((), dtype=torch.long, device=device)
        elif leaf in ("weight", "running_var"):
            ones.append((name, t.shape))
        else:   # biases, batch-norm shifts and running means
            zeros.append((name, t.shape))
    for leaves, fill in ((ones, torch.ones), (zeros, torch.zeros)):
        sizes = [math.prod(shape) for _, shape in leaves]
        flat = fill(sum(sizes), dtype=torch.float32, device=device)
        for (name, shape), part in zip(leaves, torch.split(flat, sizes)):
            state[name] = part.view(shape)
    if head is not None:
        state[head["module"] + ".weight"].mul_(head["weight_scale"])
        state[head["module"] + ".bias"].fill_(head["bias"])
    return state


def reference_model(config: dict, seed: int, device) -> DepthModelCVHint:
    model = build(config["options"], "meta")
    model.load_state_dict(make_state_dict(config, seed, device), assign=True)
    return model.eval()
