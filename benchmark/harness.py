"""One run of one cell: set-up, the measured window, the traced stretch and
the comparison with the reference.

Everything that belongs to one cell, configuration, traffic mix or metric
is found by name under the benchmark's folder:

* ``workloads/<cell>.json``: the sessions a sample is drawn from, the
  traced stretch and the limits of the numbers compared;
* the configuration file that ``BENCHMARK.json`` names: the port's Options
  and the FLOPs of a delivered map;
* ``traffic/<mix>.json``: the loop the frames arrive in (``mode``), the
  batch, and the parameters of the frame generator (``frames.py``);
* ``modes/<mode>.py``: the loop the window drives;
* ``metrics/<metric>.py``: the reader of one per-layer metric.

A run makes its frames and weights from the seed, builds the port's model,
warms up the cell's shapes, then pulls units of work (frames, or batches)
from the mode for ``seconds`` seconds. With tracing on it also records
the port's stage clock on every frame and a profiler trace over a steady
stretch. After the window it reads the peak memory, frees the program,
runs the reference over one session drawn from the seed and compares.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import random
import sys
import time
from contextlib import nullcontext
from pathlib import Path
from typing import Optional

import numpy as np
import torch

TRACE_AFTER_SHARE = 0.33     # the traced stretch starts a third of the way into the window


@dataclasses.dataclass
class Unit:
    """One unit of delivered work: its maps, its host-clock span, its session."""

    maps: int
    t0: float
    t1: float
    session: int
    session_done: bool
    frame_ms: Optional[float] = None
    stages: Optional[dict] = None          # the stage clock's ms (traced runs)
    fused: Optional[list] = None           # score-volume fuses (traced stretch)
    wait_ms: float = 0.0                   # time blocked on the loader before t0


@dataclasses.dataclass
class Cell:
    name: str
    root: Path
    manifest: dict
    workload: dict
    config: dict
    traffic: dict

    @property
    def bench_dir(self) -> Path:
        return self.root / "benchmark"

    def metrics(self, section: str):
        return [m for m in self.manifest[section] if self.name in m.get("workloads", [self.name])]


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(root, name: str) -> Cell:
    root = Path(root)
    manifest = load_json(root / "BENCHMARK.json")
    entries = [w for w in manifest["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    entry = entries[0]
    config_file = [c for c in manifest["configs"] if c["name"] == entry["config"]][0]["file"]
    bench = root / "benchmark"
    return Cell(name=name, root=root, manifest=manifest,
                workload=load_json(bench / "workloads" / f"{name}.json"),
                config=load_json(root / config_file),
                traffic=load_json(bench / "traffic" / f"{entry['traffic']}.json"))


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class MetricContext:
    """What a per-layer metric's reader reads: the run (``ctx``: options,
    configuration, cell), the window's units, the traced stretch's units
    and the parsed trace (``benchmark.trace.Tracer.summary``; None on a
    machine without a card)."""

    ctx: "Context"
    window: list
    traced: list
    trace: Optional[dict]

    def kernels(self, pattern: str):
        """(start, duration) in seconds of the traced device kernels whose
        name holds ``pattern``, in time order."""
        if not self.trace:
            return []
        return sorted((ts, dur) for name, ts, dur in self.trace["kernels"] if pattern in name)


class Keeper:
    """The program's outputs of the session that is compared, on the host."""

    def __init__(self):
        self.data = {"depth": [], "hint_depth": [], "hint_valid": []}

    def frame(self, depth_bhw1, hint):
        self.data["depth"].append(depth_bhw1[..., 0].float().cpu())
        self.data["hint_depth"].append(hint["depth_hint_bhw1"][..., 0].float().cpu())
        self.data["hint_valid"].append(hint["hint_mask_bhw1"][..., 0].cpu())

    def volume(self, prefix: str, vol):
        self.data[prefix + "values"] = vol.values.cpu()
        self.data[prefix + "weights"] = vol.weights.cpu()

    def outputs(self):
        return {k: torch.cat(v) if isinstance(v, list) else v for k, v in self.data.items()}


class Context:
    """What a mode's loop needs: the program, its inputs, and the hooks of
    the harness (spans, the stage clock, the kept session)."""

    def __init__(self, cell: Cell, seed: int, device: str, trace: bool):
        from benchmark import program

        self.cell, self.seed, self.trace = cell, seed, trace
        self.config = cell.config
        self.device = torch.device(device)
        self.mode = load_module(cell.bench_dir / "modes" / f"{cell.traffic['mode']}.py",
                                f"benchmark.modes.{cell.traffic['mode']}")
        self.opts = program.options(cell.config, cell.traffic, device)
        self.program = program
        self.tracing = False
        self.sampled = random.Random(seed).randrange(cell.workload["compare_sessions"])
        self.kept = None
        self.scans = None
        self.model = None

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def span(self, name: str):
        return torch.profiler.record_function(name) if self.trace else nullcontext()

    def clock(self):
        return self.program.SpanClock(self.device) if self.trace else None

    def keeper(self, session: int):
        if session != self.sampled:
            return None
        self.kept = Keeper()
        return self.kept

    def fused_record(self, vol, cfg, depth_hw, cam_T_world, K):
        return {"dims": tuple(vol.dims), "origin": vol.origin, "voxel_size": vol.voxel_size,
                "max_depth": cfg.max_depth, "extended": cfg.extended_neg_truncation,
                "depth": depth_hw, "cam_T_world": cam_T_world, "K": K}


def set_up(cell: Cell, seed: int, device: str, trace: bool) -> Context:
    from benchmark.frames import make_scans
    from benchmark.reference.weights import make_state_dict

    ctx = Context(cell, seed, device, trace)
    o = ctx.opts
    ctx.scans = make_scans(cell.traffic, (o.image_height, o.image_width),
                           (o.image_height // 2, o.image_width // 2), seed, ctx.device)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(ctx.device)
    ctx.model = ctx.program.build_model(o, make_state_dict(cell.config, seed, ctx.device))
    ctx.mode.warm_up(ctx)
    ctx.sync()
    return ctx


def measure(ctx: Context, seconds: float, tracer=None):
    """Pull units for ``seconds``; returns (window units, window seconds,
    peak bytes, traced units). The window closes after the first unit
    that ends past the deadline (at a session's end where the mode says
    so); the loop then runs on, untimed, until the compared session is
    done and the traced stretch has ended."""
    w = ctx.cell.workload
    by_session = getattr(ctx.mode, "WINDOW_UNIT", "frame") == "session"
    stretch = w.get("trace_units")
    stream = ctx.mode.run(ctx)
    window, traced = [], []
    in_window, traced_done = True, tracer is None
    sampled_done = False
    prev = None
    t_start = time.perf_counter()
    deadline = t_start + seconds
    window_s = peak = None
    try:
        while True:
            if (not traced_done and not ctx.tracing
                    and time.perf_counter() - t_start >= TRACE_AFTER_SHARE * seconds
                    and (stretch != "session" or prev is None or prev.session_done)):
                ctx.sync()
                tracer.start()
                ctx.tracing = True
            unit = next(stream)
            if in_window:
                window.append(unit)
            if ctx.tracing:
                traced.append(unit)
                if (stretch == "session" and unit.session_done) or (
                        stretch != "session" and len(traced) >= stretch):
                    ctx.sync()
                    tracer.stop()
                    ctx.tracing = False
                    traced_done = True
            if unit.session == ctx.sampled and unit.session_done:
                sampled_done = True
            if in_window and unit.t1 >= deadline and (not by_session or unit.session_done):
                in_window = False
                window_s = unit.t1 - t_start
                if ctx.device.type == "cuda":
                    peak = torch.cuda.max_memory_allocated(ctx.device)
            prev = unit
            if not in_window and traced_done and sampled_done:
                break
    finally:
        stream.close()
    return window, window_s, peak, traced


def end_to_end(window, window_s, peak, setup_s):
    """Every end-to-end metric the harness knows; the cell prints those
    BENCHMARK.json gives it."""
    out = {"maps_per_s": sum(u.maps for u in window) / window_s, "setup_s": setup_s}
    if peak is not None:
        out["peak_gib"] = peak / 2 ** 30
    return out


def per_layer(ctx: Context, window, traced, trace_summary):
    """Each of the cell's per-layer metrics, from its reader; a reader that
    finds nothing returns None and the metric is left out."""
    mctx = MetricContext(ctx=ctx, window=window, traced=traced, trace=trace_summary)
    out = {}
    for m in ctx.cell.metrics("per_layer"):
        reader = load_module(ctx.cell.bench_dir / "metrics" / f"{m['name']}.py",
                             f"benchmark.metrics.{m['name'].replace('.', '_')}")
        value = reader.read(mctx)
        if value is not None:
            out[m["name"]] = value
    return out


def compare(ctx: Context, reference_model=None):
    """Free the program, run the reference over the kept session, and
    compare: returns ({number: (value, limit)}, correct, failed maps)."""
    from benchmark import compare as cmp
    from benchmark.reference.weights import reference_model as make_reference

    kept = ctx.kept.outputs()
    ctx.model = None
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
        for flag in (torch.backends.cudnn, torch.backends.cuda.matmul):
            flag.allow_tf32 = False
    model = reference_model or make_reference(ctx.config, ctx.seed, ctx.device)
    with torch.no_grad():
        ref = ctx.mode.reference(ctx, ctx.sampled, model, kept)
    ref = {k: v.cpu() for k, v in ref.items()}
    numbers = cmp.numbers(kept, ref)
    limits = ctx.cell.workload["limits"]
    checks = {name: (numbers[name], limits[name]) for name in limits}
    correct = all(np.isfinite(v) and v <= lim for v, lim in checks.values())
    failed = int((~torch.isfinite(kept["depth"]).flatten(1).all(1)).sum())
    return checks, correct and failed == 0, failed, numbers


def run_cell(root, name: str, seed: int, seconds: float, trace: bool, device: str,
             process_start: float):
    """One run; returns the result line's dict and the numbers compared."""
    from benchmark.trace import Tracer

    cell = load_cell(root, name)
    ctx = set_up(cell, seed, device, trace)
    setup_s = time.perf_counter() - process_start
    tracer = Tracer(ctx.device, cell.root) if trace else None
    window, window_s, peak, traced = measure(ctx, seconds, tracer)
    result = {"attempted": sum(u.maps for u in window)}
    if trace:
        metrics = per_layer(ctx, window, traced, tracer.summary)
    else:
        values = end_to_end(window, window_s, peak, setup_s)
        metrics = {m["name"]: values[m["name"]] for m in cell.metrics("end_to_end")
                   if m["name"] in values}
    units = {m["name"]: m["unit"] for m in cell.manifest["end_to_end"] + cell.manifest["per_layer"]}
    device_info = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
                   "kind": (torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda"
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": peak}
    if trace:
        device_info.update(busy_s=tracer.summary["busy_s"], window_s=tracer.summary["window_s"])
    if window:
        t0 = window[0].t0
        slices = [0] * (int(window_s // 5) + 1)
        for u in window:
            slices[min(len(slices) - 1, int((u.t1 - t0) // 5))] += u.maps
        print(f"window: maps per 5 s {slices}; loader waits {sum(u.wait_ms for u in window):.0f} ms"
              f" over {len(window)} units", file=sys.stderr)
    t_ref = time.perf_counter()
    checks, correct, failed, numbers = compare(ctx)
    print(f"reference and comparison: {time.perf_counter() - t_ref:.1f} s; window {window_s:.2f} s,"
          f" set-up {setup_s:.2f} s, session {ctx.sampled} compared", file=sys.stderr)
    result.update(correct=correct, failed=failed,
                  metrics={k: {"value": v, "unit": units[k]} for k, v in metrics.items()},
                  device=device_info)
    if trace:
        result["breakdown"] = tracer.summary["breakdown"]
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result, numbers
