"""Where the port's fused-volume kernel (K1) spends its time, on one GPU.

    python3 scripts/probe_fused_volume_cuda.py [variant ...]

Builds ``doubletake_tpu_torch/csrc/fused_volume.cu`` as it is ("base") and
with parts of its work taken out, then times each build at the flagship
shape of ``chip_smoke.py`` (b=1, k=7, 96x128, 64 planes), with and without
the hint MLP, in batches of 10 launches. The variants compute wrong scores
and only say what a part costs:

  * nogather: no tap is loaded (every tap counts as outside the image);
  * noview:   no view is processed: layer 1 is u + plane * w alone, so what
              is left is u, layer 2, the epilogue and the hint MLP.

Only "base" is checked against ``feature_volume_plain``. The variants are
made by replacing lines of the source; a variant whose line is gone fails
loudly. Results are printed and written to chiprun_out/probe_fused_volume.json.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

VARIANTS = {
    "base": [],
    "nogather": [("const bool vy0 = live &&", "const bool vy0 = false &&"),
                 ("const bool vy1 = live &&", "const bool vy1 = false &&")],
    "noview": [("for (int v = 0; v < K; ++v) {", "for (int v = 0; v < 0; ++v) {")],
}


def build(names, out_dir):
    from doubletake_tpu_torch.ops import build as kb

    src = open(os.path.join(ROOT, "doubletake_tpu_torch", "csrc", "fused_volume.cu")).read()
    procs = {}
    for name in names:
        code = src
        for old, new in VARIANTS[name]:
            if old not in code:
                raise RuntimeError(f"variant {name}: line {old!r} not in the source")
            code = code.replace(old, new)
        cu = os.path.join(out_dir, f"fused_volume_{name}.cu")
        with open(cu, "w") as f:
            f.write(code)
        lib = os.path.join(out_dir, f"libfused_volume_{name}.so")
        procs[name] = (subprocess.Popen([kb.nvcc_path(), *kb.NVCC_FLAGS, "-o", lib, cu],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        spills = [line.strip() for line in log.splitlines() if "spill" in line]
        print(f"{name}: {spills[-1] if spills else ''}", flush=True)
        libs[name] = ctypes.CDLL(lib)
    return libs


def launch(lib, args, hint_on):
    """One launch of a build, as ``fused_feature_volume`` makes it."""
    import torch

    from doubletake_tpu_torch.ops import fused_volume as fv

    cur, src, P, rays, centers, pose, planes, mlp = args[:8]
    hint_mlp = args[8] if hint_on else None
    hint = torch.nan_to_num(args[9], nan=0.0) if hint_on else None
    b, h, w, c = cur.shape
    k, d = src.shape[1], planes.shape[0]
    pk = fv.packed_volume_weights(mlp, hint_mlp, k, c)
    run, blocks = fv.plane_schedule(b, h * w, d,
                                    torch.cuda.get_device_properties(0).multi_processor_count)
    out = torch.empty((b, d, h, w), device=cur.device)
    fn = lib.fused_volume_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 8 + [ctypes.c_void_p]

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr() if t is not None else 0)

    err = fn(ptr(cur), ptr(src), ptr(rays), ptr(P), ptr(centers), ptr(pose), ptr(planes),
             ptr(hint), ptr(pk["w1_inv_frag"]), ptr(pk["w1_plane_tiles"]), ptr(pk["w2_tiles"]),
             ptr(pk["vec"]), ptr(pk["hint"] if hint_on else None), ptr(out),
             b, k, h, w, d, run, blocks, int(hint_on),
             ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"launch failed: cudaError {err}")
    return out


def main(argv):
    import torch

    import chip_smoke as cs
    from doubletake_tpu_torch.ops import fused_volume as fv

    if not torch.cuda.is_available():
        print("probe_fused_volume_cuda: no CUDA device", file=sys.stderr)
        return 2
    names = argv or list(VARIANTS)
    out_dir = os.path.join(ROOT, "build", "probe_fused_volume")
    os.makedirs(out_dir, exist_ok=True)
    libs = build(names, out_dir)
    args = cs.flagship_volume_inputs("cuda")
    results = {"card": torch.cuda.get_device_name(0), "ms": {}}
    if "base" in libs:
        with torch.no_grad():
            plain = fv.feature_volume_plain(*args[:9], torch.nan_to_num(args[9], nan=0.0))
        err = float((launch(libs["base"], args, True) - plain).abs().max())
        print(f"base: max |kernel - plain| = {err:.3e}", flush=True)
        if not err <= cs.K1_TOL:
            raise RuntimeError(f"base disagrees with the plain version: {err}")
        results["base_max_abs_err"] = err
    for rnd in range(2):
        for name, lib in libs.items():
            for hint_on in (True, False):
                ms = cs.median_ms(lambda: launch(lib, args, hint_on), reps=7, inner=10)
                results["ms"].setdefault(f"{name} hint={hint_on}", []).append(ms)
                print(f"round {rnd} {name:9s} hint={hint_on}: {ms:.4f} ms", flush=True)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "probe_fused_volume.json"), "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
