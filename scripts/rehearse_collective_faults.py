"""Rehearse chip_smoke.py's phase-17 gate against planted faults of the
data-parallel step's collective, on one GPU.

    python3 scripts/rehearse_collective_faults.py

Copies the port (``doubletake_tpu_torch/``, ``configs/``, ``chip_smoke.py``)
into ``build/collective_faults/<fault>/`` with one fault planted in
``training/distributed.all_reduce_mean``:
  * ``unreduced``: each rank keeps its own vector (no all-reduce);
  * ``summed``: the sum over the ranks in place of their mean.
Then runs phase 17 alone (``chip_smoke.run_data_parallel``) on this tree and
on each copy, one process a tree. Prints the card's name and power limit,
then one JSON line a tree: whether the phase passed, and the
``check_reduced`` row or the error. Exits 0 when this tree passes and every
faulty copy fails at ``check_reduced``; the lines also go to
``chiprun_out/collective_faults.json``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOUND = "    dist.all_reduce(flat)\n    return flat / dist.get_world_size()\n"
FAULTS = {"unreduced": "    return flat\n",
          "summed": "    dist.all_reduce(flat)\n    return flat\n"}
GATE_ERROR = "data-parallel (b): the reduced vectors"


def planted_copy(fault: str) -> str:
    """The port, configs and chip_smoke.py under build/collective_faults/
    with ``fault`` in ``all_reduce_mean``."""
    dst = os.path.join(ROOT, "build", "collective_faults", fault)
    shutil.rmtree(dst, ignore_errors=True)
    os.makedirs(dst)
    ignore = shutil.ignore_patterns("__pycache__")
    for name in ("doubletake_tpu_torch", "configs"):
        shutil.copytree(os.path.join(ROOT, name), os.path.join(dst, name), ignore=ignore)
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), dst)
    path = os.path.join(dst, "doubletake_tpu_torch", "training", "distributed.py")
    with open(path) as f:
        src = f.read()
    if src.count(SOUND) != 1:
        raise RuntimeError(f"all_reduce_mean's body not found in {path}")
    with open(path, "w") as f:
        f.write(src.replace(SOUND, FAULTS[fault]))
    return dst


def phase17(tree: str) -> dict:
    """Phase 17 of chip_smoke.py from ``tree`` (this process)."""
    sys.path.insert(0, tree)
    import chip_smoke

    from doubletake_tpu_torch.options import Options
    from doubletake_tpu_torch.runners import common

    common.resolve_device(Options())          # CUDA, TF32 off, as chip_smoke's main
    os.makedirs(os.path.join(tree, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(tree, "build")) as tmp:
        try:
            res = chip_smoke.run_data_parallel(tmp, {"step_ms": float("nan")})
            return {"passed": True, "reduced": res["b"]["reduced"]}
        except Exception as e:   # a planted fault is expected to fail the phase
            return {"passed": False, "error": repr(e)}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--tree":
        print("RESULT " + json.dumps(phase17(sys.argv[2]), default=str), flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0])
    rows, ok = [], True
    for fault, tree in [(None, ROOT)] + [(f, planted_copy(f)) for f in FAULTS]:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree", tree],
                             capture_output=True, text=True, cwd=tree)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")]
        if out.returncode or not lines:
            raise RuntimeError(f"phase 17 on {tree} did not report:\n{out.stderr[-4000:]}")
        row = {"fault": fault, **json.loads(lines[-1][len("RESULT "):])}
        caught = not row["passed"] and GATE_ERROR in row["error"]
        ok &= row["passed"] if fault is None else caught
        rows.append(row)
        print(json.dumps(row, default=str), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "collective_faults.json"), "w") as f:
        json.dump(rows, f, indent=1, default=str)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
