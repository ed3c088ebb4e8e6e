"""Fixtures of the benchmark's own tests (``pytest benchmark/tests``).

``tiny_root`` copies ``BENCHMARK.json`` and this folder into a temporary
root and shrinks the cells' configurations and traffic so that a whole run
of a cell (set-up, window, comparison) takes seconds on the CPU with the
port's plain paths. Tests that need the card carry the ``card`` marker and
ask for the ``cuda`` fixture, which skips them where no card is present.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_OPTIONS = {"image_width": 128, "image_height": 96, "fusion_resolution": 0.08,
                "num_workers": 2}
TINY_TRAFFIC = {"frames_per_scan": 23, "pool_scans": 2}   # 16 tuples a scan


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skipped without one)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control computes in TF32, which exists only there")
    return torch.device("cuda")


def make_tiny_root(dest: Path, options=None, traffic=None) -> Path:
    dest.mkdir(parents=True, exist_ok=True)
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for path in (dest / "benchmark" / "configs").glob("*.json"):
        config = json.loads(path.read_text())
        config["options"].update(TINY_OPTIONS, **(options or {}))
        path.write_text(json.dumps(config))
    for path in (dest / "benchmark" / "traffic").glob("*.json"):
        params = json.loads(path.read_text())
        params.update(TINY_TRAFFIC, **(traffic or {}))
        path.write_text(json.dumps(params))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path / "root")
