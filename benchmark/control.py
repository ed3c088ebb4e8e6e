"""The control of the comparison: the reference in the program's place,
computed one precision below the configuration's (TF32 for float32 with
TF32 off), against the reference in float32, on the session a run with the
same seed compares.

    python3 benchmark/control.py --workload flagship.incremental --seeds 11 12 13

Each seed prints one JSON line of the numbers ``benchmark/compare.py``
reads, beside the cell's limits; a limit is sound only where every seed
of the control fails at least one of the cell's numbers. Runs on a card:
TF32 exists only there. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, device: str):
    """The control's numbers for one seed."""
    import torch

    from benchmark import compare
    from benchmark.frames import make_scans
    from benchmark.harness import load_module
    from benchmark.reference.weights import reference_model

    o = cell.config["options"]
    mode = load_module(cell.bench_dir / "modes" / f"{cell.traffic['mode']}.py",
                       f"benchmark.modes.{cell.traffic['mode']}")
    scans = make_scans(cell.traffic, (o["image_height"], o["image_width"]),
                       (o["image_height"] // 2, o["image_width"] // 2), seed, device)

    class Ctx:   # what a mode's ``reference`` reads
        pass

    ctx = Ctx()
    ctx.scans, ctx.config, ctx.device = scans, cell.config, torch.device(device)
    ctx.opts = argparse.Namespace(batch_size=cell.traffic["batch_size"])
    session = random.Random(seed).randrange(cell.workload["compare_sessions"])
    model = reference_model(cell.config, seed, device)
    judged = None
    for tf32 in (True, False):     # the control in the program's place, then the reference
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        with torch.no_grad():
            out = {k: v.cpu() for k, v in mode.reference(ctx, session, model, judged).items()}
        judged = judged or out
    return compare.numbers(judged, out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the comparison's TF32 control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import load_cell

    if not torch.cuda.is_available():
        print("the control needs a card", file=sys.stderr)
        return 2
    cell = load_cell(ROOT, args.workload)
    limits = cell.workload["limits"]
    for seed in args.seeds:
        t = time.perf_counter()
        numbers = readings(cell, seed, "cuda")
        fails = [k for k, lim in limits.items() if not numbers[k] <= lim]
        print(json.dumps({"workload": args.workload, "seed": seed, "numbers": numbers,
                          "fails": fails, "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
