"""The yardstick's counts: the FLOPs of a delivered map stored in each
configuration file, K1's and K2's work from shapes."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark.conftest import ROOT
from benchmark.counts import (
    PEAK_FLOPS,
    bound_seconds,
    k1_work,
    k2_work,
    model_flops,
    updated_voxels,
)


@pytest.mark.parametrize("name", ["flagship", "small"])
@pytest.mark.parametrize("pattern", ["incremental", "offline"])
def test_stored_flops_per_map(name, pattern):
    config = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
    assert model_flops(config, pattern) == config["flops_per_map"][pattern]


def test_k1_counts_each_pixel_plane_once():
    flops, nbytes = k1_work(1, 7, 96, 128, 64)
    # MLP [202, 128, 128, 1] and hint MLP [3, 12, 12, 1], 2 FLOP a multiply-add
    assert flops == 2 * (202 * 128 + 128 * 128 + 128 + 3 * 12 + 12 * 12 + 12) * 96 * 128 * 64
    assert bound_seconds(flops, nbytes) == pytest.approx(flops / PEAK_FLOPS)
    assert bound_seconds(flops, nbytes) * 1e3 == pytest.approx(0.0677, abs=2e-4)
    f16, b16 = k1_work(16, 7, 96, 128, 64)
    assert f16 == 16 * flops and b16 < 16 * nbytes       # the weights are read once a launch


def test_k2_counts_the_voxels_a_frame_updates():
    from doubletake_tpu_torch.ops.integrate import voxel_update_plain

    depth = torch.full((48, 64), 2.0)
    depth[:10] = -1.0
    K = torch.tensor([[37.1, 0, 32, 0], [0, 37.1, 24, 0], [0, 0, 1, 0], [0, 0, 0, 1.0]])
    pose = torch.eye(4)
    dims, origin, vs = (40, 30, 50), torch.tensor([-1.6, -1.2, 0.0]), 0.08
    n = updated_voxels(dims, origin, vs, depth, pose, K, 3.5, True)
    trunc = 3 * vs
    _, _, terms = voxel_update_plain(-torch.ones(dims), torch.zeros(dims), depth, (K @ pose)[:3],
                                     origin, voxel_size=vs, min_depth=0.5, max_depth=3.5,
                                     truncation=trunc, trunc_check=-1.5 * trunc, update_rate=2.5,
                                     max_weight=100.0)
    assert n == int(terms["valid"].sum()) > 0
    assert k2_work(n, 48, 64)[1] == 16 * n + 4 * 48 * 64 + 60
