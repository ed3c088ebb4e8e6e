"""The import guard: nothing the benchmark runs on the card imports JAX,
flax or the JAX package (top-level names compared whole, since the port's
``doubletake_tpu_torch`` begins with ``doubletake_tpu``), and the
reference imports nothing of the port either."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
import textwrap

from benchmark.conftest import ROOT, make_tiny_root

FORBIDDEN = {"jax", "jaxlib", "flax", "doubletake_tpu"}
PORT = "doubletake_tpu_torch"


def imported_top_names(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def imported_modules(path):
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            mods.add(node.module)
    return mods


def sources(sub=""):
    return [p for p in (ROOT / "benchmark" / sub).rglob("*.py") if "tests" not in p.parts]


def test_no_source_imports_jax_or_the_jax_package():
    for path in sources():
        assert not imported_top_names(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_port():
    allowed = {"benchmark.frames"}
    for path in sources("reference"):
        mods = imported_modules(path)
        assert PORT not in {m.split(".")[0] for m in mods}, path
        assert all(m in allowed or m.startswith("benchmark.reference")
                   for m in mods if m.startswith("benchmark")), (path, mods)


def run_python(code, cwd):
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=cwd,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_reference_loads_without_the_port(tmp_path):
    loaded = run_python(f"""
        import json, sys
        sys.path.insert(0, {str(ROOT)!r})
        import benchmark.compare, benchmark.counts, benchmark.frames
        import benchmark.reference.chain, benchmark.reference.weights
        print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
    """, tmp_path)
    assert PORT not in loaded and not FORBIDDEN & set(loaded)


def test_a_run_loads_no_jax(tmp_path):
    root = make_tiny_root(tmp_path / "root")
    loaded = run_python(f"""
        import json, sys, time
        sys.path.insert(0, {str(ROOT)!r})
        from benchmark.harness import run_cell
        run_cell({str(root)!r}, "small.incremental", 5, 0.5, True, "cpu", time.perf_counter())
        sys.path.insert(0, {str(ROOT / "benchmark")!r})
        import run
        loaded = sorted({{m.split(".")[0] for m in sys.modules}})
        print(json.dumps(run.forbidden_modules() + loaded))
    """, tmp_path)
    assert PORT in loaded and not FORBIDDEN & set(loaded)
