"""The comparison's control, kept as a test: the reference computed in
TF32 in the program's place must fail at least one of each cell's numbers
on every seed. TF32 exists only on the card, so this runs there
(``python3 -m pytest benchmark/tests -m card``); the cells' limits were set
from the control's readings at the cells' own sizes
(``benchmark/control.py``, PERF.md)."""

from __future__ import annotations

import pytest

from benchmark.control import readings
from benchmark.harness import load_cell


@pytest.mark.card
@pytest.mark.parametrize("cell", ["flagship.incremental", "flagship.offline", "small.incremental",
                                  "small.offline"])
def test_tf32_control_fails(cuda, tiny_root, cell):
    spec = load_cell(tiny_root, cell)
    for seed in (21, 22, 23):
        numbers = readings(spec, seed, "cuda")
        assert any(not numbers[k] <= lim for k, lim in spec.workload["limits"].items()), numbers
