"""The frozen plain reference against the port's CPU path, at a small size.

The reference (``benchmark/reference``) must compute what the port
computes: the same state dict loads into both models, the forwards agree,
and the reference's fuse, raycast and static rounding agree with the
port's ``tools/tsdf``. This test may import both; the reference imports
neither the port nor JAX (``test_bench_imports.py``).
"""

from __future__ import annotations

import json

import pytest
import torch

from benchmark.conftest import ROOT, TINY_OPTIONS
from benchmark.frames import make_scans
from benchmark.reference import chain, fusion
from benchmark.reference.weights import make_state_dict, reference_model


def tiny_config(name):
    config = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
    config["options"].update(TINY_OPTIONS)
    return config


def tiny_scan(frames=12, seed=5):
    params = json.loads((ROOT / "benchmark" / "traffic" / "live.json").read_text())
    params.update(frames_per_scan=frames, pool_scans=1)
    return make_scans(params, (96, 128), (48, 64), seed, "cpu")[0]


def port_model(config, seed):
    from benchmark import program

    opts = program.options(config, {"batch_size": 1}, "cpu")
    return program.build_model(opts, make_state_dict(config, seed, "cpu")), opts


@pytest.mark.parametrize("name", ["flagship", "small"])
def test_forward_matches_port(name):
    config = tiny_config(name)
    ref = reference_model(config, 3, "cpu")
    port, _ = port_model(config, 3)
    scan = tiny_scan()
    cur, src = chain.batch_inputs(scan, scan.tuples[:2], "cpu")
    vol = fusion.volume_from_bounds(*scan.bounds, 0.08, "cpu")
    for i in range(7):      # the ground truth of the source frames, so that hints exist
        fusion.integrate(vol, torch.as_tensor(scan.depths[i]), torch.as_tensor(scan.cam_T_world[i]),
                         cur["K_s0_b44"][0], 3.5, True)
    hint = fusion.render_hint(vol, cur["world_T_cam_b44"], cur["invK_s0_b44"], 24, 32, 3.5, 256)
    assert hint["hint_mask_bhw1"].any()
    with torch.no_grad():
        a = ref(cur, src, hint)
        b = port(cur, src, hint=hint, return_mask=True)
    torch.testing.assert_close(a["depth_s0_bhw1"], b["depth_pred_s0_bhw1"], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(a["matching_feats_bhwc"], b["matching_feats_bhwc"], rtol=1e-5,
                               atol=1e-6)


def test_cached_source_features_give_the_same_depth():
    config = tiny_config("small")
    ref = reference_model(config, 4, "cpu")
    scan = tiny_scan()
    cur, src = chain.batch_inputs(scan, scan.tuples[:1], "cpu")
    hint = fusion.empty_hint(1, 96, 128, "cpu")
    with torch.no_grad():
        feats = ref.matching_model(src["image_bkhw3"][0])[None]
        full = ref(cur, src, hint)["depth_s0_bhw1"]
        cached = ref(cur, src, hint, src_matching_feats=feats)["depth_s0_bhw1"]
    torch.testing.assert_close(full, cached, rtol=1e-5, atol=1e-6)


def test_fusion_matches_port():
    from doubletake_tpu_torch.tools.tsdf import (
        TSDF,
        FusionConfig,
        integrate_depth,
        prepare_static,
        raycast,
    )

    scan = tiny_scan()
    lo, hi = scan.bounds
    bounds = {f"{a}{e}": float(v[i]) for i, a in enumerate("xyz")
              for e, v in (("min", lo), ("max", hi))}
    port = TSDF.from_bounds(bounds, 0.08)
    ref = fusion.volume_from_bounds(lo, hi, 0.08, "cpu")
    cfg = FusionConfig(min_depth=0.5, max_depth=3.5, extended_neg_truncation=True)
    cur, _ = chain.batch_inputs(scan, scan.tuples[:4], "cpu")
    for i in range(4):
        depth = torch.as_tensor(scan.depths[scan.tuples[i][0]])
        integrate_depth(port, depth[..., None], cur["cam_T_world_b44"][i], cur["K_s0_b44"][i], cfg)
        fusion.integrate(ref, depth, cur["cam_T_world_b44"][i], cur["K_s0_b44"][i], 3.5, True)
    assert torch.equal(port.values, ref.values) and torch.equal(port.weights, ref.weights)
    assert (ref.weights > 0).any()
    for p_vol, r_vol in ((port, ref), (prepare_static(port), fusion.static_copy(ref))):
        a = raycast(p_vol, cur["world_T_cam_b44"], cur["invK_s0_b44"], 24, 32, min_depth=0.5,
                    max_depth=3.5, num_samples=256)
        b = fusion.raycast(r_vol, cur["world_T_cam_b44"], cur["invK_s0_b44"], 24, 32, 0.5, 3.5,
                           256)
        assert b[2].any()
        for x, y in zip(a, b):
            assert torch.equal(torch.nan_to_num(x.float(), nan=-7.0),
                               torch.nan_to_num(y.float(), nan=-7.0))


def test_state_dict_is_seeded_and_complete():
    config = tiny_config("flagship")
    a = make_state_dict(config, 11, "cpu")
    b = make_state_dict(config, 11, "cpu")
    c = make_state_dict(config, 12, "cpu")
    assert a.keys() == b.keys() == c.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    head = config["depth_head"]
    assert float(a[head["module"] + ".bias"]) == pytest.approx(head["bias"])
    port, _ = port_model(config, 11)          # loads strictly: every name matches
    assert set(port.state_dict()) == set(a)
