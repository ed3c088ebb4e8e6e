"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload flagship.incremental --seed 7 --seconds 51 --trace 0

Run from the root of a checkout on a machine with an NVIDIA card. The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device`` and, traced, the
``breakdown``; its last key, ``checks``, holds each number compared with
the reference beside its limit, which also end standard error. Without a
card, with fewer cards than the cell asks for, or with JAX or the JAX
package loaded once the window has closed, the run prints no result and
exits with another code than 0.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "doubletake_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (whole names: ``doubletake_tpu_torch`` is the port)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # caches at fixed paths inside the checkout; no library may load flax
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton_cache"))
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark.harness import load_cell, run_cell

    cell = load_cell(ROOT, args.workload)
    chips = [w for w in cell.manifest["workloads"] if w["name"] == args.workload][0]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, numbers = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                               "cuda", PROCESS_START)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package are loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print("numbers: " + json.dumps(numbers), file=sys.stderr)
    for name, check in result["checks"].items():
        print(f"check {name} = {check['value']!r} (limit {check['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
