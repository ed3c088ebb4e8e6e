"""The port's one timing module: host spans, counters and the stage clock.

* ``span(name)``: a context manager around one piece of host work, named
  ``<layer>.<part>`` (``runner.step``, ``model.decoder``, ...). While no
  ``torch.profiler`` records on the calling thread it costs one check and
  does nothing else. While one records, it opens
  ``torch.profiler.record_function(name)``, so the span lands in the same
  trace as the kernels and copies, on the same clock, and appends a
  ``Record`` to a bounded in-memory list: its name, its parent, its root
  (the outermost span open on the thread: the spans of one frame or batch
  share it) and its host start and end (``time.perf_counter_ns``). A span
  adds no device work and no synchronisation. ``spanned(name)`` puts a span
  around every call of a function.
* ``records()``, ``dropped()`` and ``clear()`` read and reset the list. It
  holds ``MAX_RECORDS`` records; the spans past that are counted, not kept.
  Nothing is written to disk.
* ``count(name, n)`` and ``counters()``: integer counters, always on (the
  kernels' launches, ``ops.fused_volume.launches`` and
  ``ops.integrate.launches``).
* ``StageClock``: CUDA events at a step's stage marks (the runners'
  hint / model / fuse times).

Spans are recorded exactly while the profiler records, so a caller that
profiles a stretch of frames gets the records of those frames and nothing
else; an unprofiled run pays one check a span.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd.profiler import record_function

MAX_RECORDS = 200_000

_profiler_enabled = torch._C._autograd._profiler_enabled   # thread-local: the profiler's state


class Record(NamedTuple):
    name: str
    parent: int      # index in records() of the enclosing span, -1 for a root
    root: int        # index of the outermost enclosing span (its own for a root)
    start_ns: int    # host clock, time.perf_counter_ns
    end_ns: int      # -1 while the span is open


_records: list = []
_dropped = 0
_counters: dict = {}
_lock = threading.Lock()
_local = threading.local()


class _Off:
    """The span while the profiler is off: nothing to open or record."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "range", "log", "index", "stack")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _dropped
        self.range = record_function(self.name)
        self.range.__enter__()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.stack = stack
        log = _records
        outer = stack[-1] if stack else None
        parent, root = (outer[1], outer[2]) if outer is not None and outer[0] is log else (-1, -1)
        index = len(log)
        if index < MAX_RECORDS:
            root = index if root < 0 else root
            log.append(Record(self.name, parent, root, time.perf_counter_ns(), -1))
            self.log, self.index = log, index
            stack.append((log, index, root))
        else:
            with _lock:
                _dropped += 1
            self.log = None
            stack.append(None)
        return None

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.stack.pop()
        if self.log is not None:
            self.log[self.index] = self.log[self.index]._replace(end_ns=end)
        self.range.__exit__(*exc)
        return False


def span(name: str):
    """A span named ``name`` around a ``with`` block (module doc)."""
    return _Span(name) if _profiler_enabled() else _OFF


def spanned(name: str):
    """Decorator: a ``span(name)`` around every call of the function."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def records() -> list:
    """The spans recorded since the last ``clear()``, in the order they
    opened (a ``Record``'s ``parent`` and ``root`` index this list)."""
    return list(_records)


def dropped() -> int:
    """Spans not recorded since the last ``clear()``: the list was full."""
    return _dropped


def clear():
    """Forget the records and the count of dropped spans. Spans still open
    close without a record."""
    global _records, _dropped
    _records = []
    _dropped = 0


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> dict:
    """A copy of every counter: {name: count since the process started}."""
    with _lock:
        return dict(_counters)


class StageClock:
    """Stage boundaries of one step: CUDA events on a GPU (read after the
    step's synchronisation, so timing adds no sync), host clock on the CPU.
    ``synced`` (``split_timing``): each mark first waits for the device and
    reads the host clock."""

    def __init__(self, device, synced: bool = False):
        self.cuda = torch.device(device).type == "cuda"
        self.events = self.cuda and not synced
        self.marks = []

    def mark(self, name: str):
        if self.events:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))
            return
        if self.cuda:
            torch.cuda.synchronize()
        self.marks.append((name, time.perf_counter()))

    def elapsed_ms(self):
        """{stage: ms} between consecutive marks; call after a synchronize."""
        out = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            out[name] = a.elapsed_time(b) if self.events else (b - a) * 1e3
        return out
