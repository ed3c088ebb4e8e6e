"""Process groups for the data-parallel trainer: set-up, the step's one
collective, and the spawned workers.

The JAX package runs its data-parallel step as one program over a device
mesh (``doubletake_tpu/training/train_loop.py:189-226``); the port runs one
process per device, joined in a ``torch.distributed`` group: NCCL between
CUDA devices, gloo on the CPU. The group is initialised through a
``file://`` store in a fresh directory of the run (never a fixed port, so
runs side by side never meet), and both the rendezvous and every collective
take a timeout: a rank that hangs or dies fails the others' next collective
instead of hanging the run.

``spawn`` starts the workers with ``torch.multiprocessing`` (the spawn
method), runs ``fn(rank, world, *args)`` in each, and returns the ranks'
results; it raises when a rank raises, dies, or outlives ``join_timeout_s``.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

TIMEOUT_S = 1800.0     # rendezvous and each collective
POLL_S = 1.0


def default_backend(device) -> str:
    """NCCL between CUDA devices, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_group(rank: int, world: int, backend: str, store_path: str,
               timeout_s: float = TIMEOUT_S):
    """Join the process group of ``world`` ranks that meet at the file
    ``store_path`` (which must not hold another group's store)."""
    dist.init_process_group(backend, init_method=f"file://{os.path.abspath(store_path)}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def all_reduce_mean(flat: torch.Tensor) -> torch.Tensor:
    """The data-parallel step's one collective: the sum of every rank's
    ``flat`` over the group, divided by the world size (the JAX step's
    ``psum(flat) / n_dev``)."""
    dist.all_reduce(flat)
    return flat / dist.get_world_size()


def _worker(rank: int, fn: Callable, world: int, backend: str, run_dir: str,
            timeout_s: float, args: Sequence):
    """A spawned rank: join the group, run ``fn``, save its result for the
    parent (``torch.save``), leave the group."""
    if backend == "nccl":
        torch.cuda.set_device(rank)
    init_group(rank, world, backend, os.path.join(run_dir, "store"), timeout_s)
    try:
        result = fn(rank, world, *args)
        torch.save(result, os.path.join(run_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, run_dir: str, args: Sequence = (),
          backend: str = "gloo", timeout_s: float = TIMEOUT_S,
          join_timeout_s: Optional[float] = None) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes joined
    in one ``backend`` group; returns their results in rank order.

    ``fn`` must be a module-level function of an importable module (the
    children import it). The store and the results live in a fresh
    directory under ``run_dir``, removed afterwards. Raises when a rank
    raises or exits abnormally (the others are then terminated), or when
    the ranks are still running after ``join_timeout_s`` (None: no limit
    beyond the collectives' ``timeout_s``)."""
    os.makedirs(run_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="dist_", dir=run_dir)
    try:
        ctx = torch.multiprocessing.start_processes(
            _worker, args=(fn, world, backend, tmp, timeout_s, tuple(args)), nprocs=world,
            join=False, start_method="spawn")
        deadline = None if join_timeout_s is None else time.monotonic() + join_timeout_s
        try:
            while not ctx.join(timeout=POLL_S):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks still running after {join_timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
