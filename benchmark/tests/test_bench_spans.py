"""The readers of the port's spans (``loader_wait_ms``, ``copy_ms``,
``dispatch_ms``) on hand-made records, and in a traced run of a tiny cell
on the CPU, where the port's loader waits nest inside the harness's."""

from __future__ import annotations

import pytest

from benchmark.conftest import ROOT
from benchmark.harness import (
    MetricContext,
    Unit,
    load_cell,
    load_module,
    measure,
    per_layer,
    set_up,
)
from benchmark.trace import Tracer
from doubletake_tpu_torch.utils import tracing
from doubletake_tpu_torch.utils.tracing import Record

SEED = 2 ** 31 + 29
MS = 1_000_000          # ns


def reader(name):
    return load_module(ROOT / "benchmark" / "metrics" / f"{name}.py", f"benchmark.metrics.{name}")


def context(maps):
    traced = [Unit(maps=n, t0=0.0, t1=1.0, session=0, session_done=False) for n in maps]
    return MetricContext(ctx=None, window=traced, traced=traced, trace=None)


RECORDS = [
    Record("data.loader_wait", -1, 0, 0, 4 * MS),
    Record("runner.device_batch", -1, 1, 4 * MS, 6 * MS),
    Record("runner.step", -1, 2, 6 * MS, 36 * MS),
    Record("tsdf.raycast", 2, 2, 7 * MS, 9 * MS),
    Record("data.loader_wait", -1, 4, 40 * MS, 42 * MS),
    Record("runner.device_batch", -1, 5, 42 * MS, 45 * MS),
    Record("runner.step", -1, 6, 45 * MS, 95 * MS),
    Record("runner.step", -1, 7, 95 * MS, 105 * MS),
    Record("runner.step", -1, 8, 105 * MS, -1),           # still open: not read
]


@pytest.mark.parametrize("name, maps, expected", [
    ("loader_wait_ms", [1, 1], 3.0),          # (4 + 2) ms over 2 maps
    ("loader_wait_ms", [16, 16], 6.0 / 32),
    ("copy_ms", [1, 1], 2.5),                 # (2 + 3) ms over 2 maps
    ("dispatch_ms", [1, 1], 30.0),            # the median of 30, 50 and 10 ms
])
def test_reader_on_hand_made_records(monkeypatch, name, maps, expected):
    monkeypatch.setattr(tracing, "records", lambda: list(RECORDS))
    assert reader(name).read(context(maps)) == pytest.approx(expected)


@pytest.mark.parametrize("name", ["loader_wait_ms", "copy_ms", "dispatch_ms"])
def test_reader_without_records_reads_none(monkeypatch, name):
    monkeypatch.setattr(tracing, "records", lambda: [])
    assert reader(name).read(context([1, 1])) is None


@pytest.mark.parametrize("cell", ["small.incremental", "small.offline"])
def test_traced_tiny_run_reads_the_spans(tiny_root, cell):
    """The cell's span metrics are read over the traced stretch; online, the
    port's loader waits add up to no more than the harness's own waits
    around the same ``next`` calls."""
    ctx = set_up(load_cell(tiny_root, cell), SEED, "cpu", True)
    tracer = Tracer(ctx.device, tiny_root)
    tracing.clear()
    window, _, _, traced = measure(ctx, 1.5, tracer)
    out = per_layer(ctx, window, traced, tracer.summary)
    names = {m["name"] for m in ctx.cell.metrics("per_layer")} & {
        "loader_wait_ms", "copy_ms", "dispatch_ms"}
    assert names and names <= set(out)
    assert all(out[n] > 0 for n in names)
    if cell.endswith("incremental"):
        port_wait = out["loader_wait_ms"] * sum(u.maps for u in traced)
        assert port_wait <= sum(u.wait_ms for u in traced) + 1e-3
    tracing.clear()
