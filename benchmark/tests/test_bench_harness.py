"""Whole runs of the harness on the CPU at a tiny size (the port's plain
paths stand in for its kernels): the cells run and compare correct, a new
cell, configuration, traffic mix and per-layer metric are new files only,
each fault a cell can have turns ``correct`` false, and without a card the
command prints no result."""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark.conftest import ROOT
from benchmark.harness import run_cell

SEED = 2 ** 31 + 17          # larger than 32 signed bits hold


def run(root, cell, trace=False, seconds=1.0, seed=SEED):
    return run_cell(root, cell, seed, seconds, trace, "cpu", time.perf_counter())


@pytest.mark.parametrize("cell", ["flagship.incremental", "small.incremental", "small.offline"])
def test_tiny_cells_compare_correct(tiny_root, cell):
    result, numbers = run(tiny_root, cell)
    assert result["correct"] and result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    names = {m["name"] for m in json.loads((tiny_root / "BENCHMARK.json").read_text())["end_to_end"]
             if cell in m.get("workloads", [cell])}
    assert set(result["metrics"]) == names - {"peak_gib"}       # no card: no device memory
    assert result["metrics"]["maps_per_s"]["value"] > 0


def digest(root):
    return {p.relative_to(root): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_cell_config_traffic_and_metric_are_new_files(tiny_root):
    """A fifth cell on a third configuration and a new traffic mix, with a new
    per-layer metric: only BENCHMARK.json gains entries, every other file
    that is there stays as it is."""
    bench = tiny_root / "benchmark"
    before = digest(bench)
    config = json.loads((bench / "configs" / "small.json").read_text())
    (bench / "configs" / "mini.json").write_text(json.dumps(config))
    traffic = json.loads((bench / "traffic" / "live.json").read_text())
    traffic.update(orbit_frames=60, camera_height=1.3)
    (bench / "traffic" / "slow_orbit.json").write_text(json.dumps(traffic))
    workload = json.loads((bench / "workloads" / "small.incremental.json").read_text())
    (bench / "workloads" / "mini.slow_orbit.json").write_text(json.dumps(workload))
    (bench / "metrics" / "frames_traced.py").write_text(
        '"""frames_traced: frames in the traced stretch."""\n\n\n'
        "def read(m):\n    return float(sum(u.maps for u in m.traced)) if m.traced else None\n")
    manifest = json.loads((tiny_root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "mini", "source": "https://example.org/mini",
                                "file": "benchmark/configs/mini.json", "reduced": [],
                                "why": "a test configuration"})
    manifest["workloads"].append({"name": "mini.slow_orbit", "config": "mini",
                                  "traffic": "slow_orbit", "chips": 1, "why": "a test cell"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "small.incremental" in m.get("workloads", []):
            m["workloads"].append("mini.slow_orbit")
    manifest["per_layer"].append({"name": "frames_traced", "unit": "frames", "better": "higher",
                                  "source": "program_counter", "layer": "test",
                                  "moves": "maps_per_s", "workloads": ["mini.slow_orbit"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(manifest))

    after = digest(bench)
    assert all(after[p] == h for p, h in before.items())
    result, _ = run(tiny_root, "mini.slow_orbit", seconds=1.5)
    assert result["correct"] and result["metrics"]["maps_per_s"]["value"] > 0
    result, _ = run(tiny_root, "mini.slow_orbit", trace=True, seconds=1.5)
    assert result["correct"] and result["metrics"]["frames_traced"]["value"] > 0
    assert {"frame_ms_p95", "hint_ms", "model_ms"} <= set(result["metrics"])


def state_unchanged(monkeypatch):
    """The fuse returns the volume as it was."""
    from doubletake_tpu_torch.tools import tsdf

    monkeypatch.setattr(tsdf, "fused_integrate", lambda values, weights, *a, **k: (values, weights))


def answer_altered(monkeypatch):
    """Each depth map is altered where the model produces it."""
    from doubletake_tpu_torch.models.depth_model import DepthModel

    forward = DepthModel.forward

    def altered(self, *args, **kwargs):
        out = forward(self, *args, **kwargs)
        out["depth_pred_s0_bhw1"] = out["depth_pred_s0_bhw1"] * 1.01
        return out

    monkeypatch.setattr(DepthModel, "forward", altered)


def half_batch(monkeypatch):
    """Pass 2 runs the model on the first half of each batch and hands its
    depths out for the whole batch."""
    from doubletake_tpu_torch.runners import offline_two_pass

    make = offline_two_pass.make_pass2_step

    def halved(*args, **kwargs):
        step = make(*args, **kwargs)

        def run_half(static, cur, src):
            b = cur["image_bhw3"].shape[0]
            idx = torch.arange(b) % max(1, b // 2)
            out, hint = step(static, {k: v[: max(1, b // 2)] for k, v in cur.items()},
                             {k: v[: max(1, b // 2)] for k, v in src.items()})
            return {k: v[idx] if torch.is_tensor(v) and v.shape[:1] == (max(1, b // 2),) else v
                    for k, v in out.items()}, {k: v[idx] for k, v in hint.items()}

        return run_half

    monkeypatch.setattr(offline_two_pass, "make_pass2_step", halved)


@pytest.mark.parametrize("cell,fault", [
    ("small.incremental", state_unchanged), ("small.incremental", answer_altered),
    ("small.offline", state_unchanged), ("small.offline", answer_altered),
    ("small.offline", half_batch)])
def test_faults_turn_correct_false(tiny_root, monkeypatch, cell, fault):
    fault(monkeypatch)
    result, numbers = run(tiny_root, cell)
    assert not result["correct"], numbers


def test_no_card_no_result(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
                           "flagship.incremental", "--seed", str(SEED), "--seconds", "1",
                           "--trace", "0"], cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
