"""The traced stretch: torch.profiler over a steady part of the window, read
back from its Chrome trace.

The summary holds every device interval (kernels, copies and fills, by
name), the host ranges the harness and the port's stage clock open, the
device's busy time (the union of its intervals, so that overlapping
streams are not counted twice), the stretch's wall time, and the
``breakdown`` the result line carries: the device operations that took
most time, and the idle gaps of the device grouped by what the host was
doing (the innermost harness or stage range, and the innermost host
operation, at the gap's middle).
"""

from __future__ import annotations

import bisect
import json
import os
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


class Tracer:
    def __init__(self, device: torch.device, root: Path):
        self.device = device
        self.path = Path(root) / "build" / "benchmark_trace.json"
        self.summary = None
        self.prof = None

    def start(self):
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        wall = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))
        with open(self.path) as f:
            events = json.load(f).get("traceEvents", [])
        os.remove(self.path)
        self.summary = summarise(events, wall)
        self.prof = None


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _innermost(ranges, starts, t):
    """Name of the latest-starting range of ``ranges`` (sorted by start)
    that holds ``t``, or None."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 200), -1):
        s, e, name = ranges[j]
        if s <= t <= e:
            return name
    return None


def summarise(events, wall_s: float) -> dict:
    us = 1e-6
    device, host_ops, spans = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        start, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if cat in DEVICE_CATEGORIES:
            device.append((e["name"], start, end))
        elif cat == "cpu_op":
            host_ops.append((start, end, e["name"]))
        elif cat == "user_annotation":
            spans.append((start, end, e["name"]))
    host_ops.sort()
    spans.sort()
    busy = _union([(s, e) for _, s, e in device])
    busy_s = sum(e - s for s, e in busy) * us

    by_name = defaultdict(float)
    for name, s, e in device:
        by_name[name[:160]] += (e - s) * us
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    gaps = defaultdict(float)
    if busy:
        host_lo = min([s for s, _, _ in host_ops + spans] or [busy[0][0]])
        host_hi = max([e for _, e, _ in host_ops + spans] or [busy[-1][1]])
        edges = [(host_lo, busy[0][0])] + [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
        edges.append((busy[-1][1], host_hi))
        op_starts = [s for s, _, _ in host_ops]
        span_starts = [s for s, _, _ in spans]
        for s, e in edges:
            if e <= s:
                continue
            mid = 0.5 * (s + e)
            label = (f"{_innermost(spans, span_starts, mid) or 'outside any range'} / "
                     f"{_innermost(host_ops, op_starts, mid) or 'python'}")
            gaps[label] += (e - s) * us
    idle_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "kernels": [(name, s * us, (e - s) * us) for name, s, e in device],
        "busy_s": busy_s,
        "window_s": wall_s,
        "breakdown": {"device_ops": [[k, v] for k, v in device_ops],
                      "idle_gaps": [[k, v] for k, v in idle_gaps]},
    }
