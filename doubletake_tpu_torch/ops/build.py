"""Build and load the port's native code (``csrc/``) at first use.

Each CUDA source (``csrc/*.cu``) is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface under
``build/torch_kernels/`` at the repo root, and loaded with ``ctypes``. The
host sources (``csrc/*.cpp``: the marching-tetrahedra mesh extractor) take
the same route through ``g++`` with the JAX package's flags
(``doubletake_tpu/tools/marching_cubes.py:25-30``), on any machine. The
library name carries a hash of the source and the flags, so an edited source
is rebuilt and a stale one never loaded. Nothing is built when a module is
imported: ``load_kernel`` runs the build the first time a wrapper needs it,
and ``build`` compiles several sources in parallel (one compiler each).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# host sources: the JAX package builds native/marching.cpp with these
HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
HOST_SOURCES = ("marching",)
# per-kernel extra flags: the integrate kernel must not contract a*b+c into
# an fma, or it stops agreeing bit for bit with its plain torch version
EXTRA_FLAGS = {"integrate": ("-fmad=false",)}

_loaded: dict = {}
build_logs: dict = {}   # kernel name -> compiler output (registers, spills)


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _source(name: str) -> Path:
    return CSRC_DIR / (f"{name}.cpp" if name in HOST_SOURCES else f"{name}.cu")


def _flags(name: str):
    if name in HOST_SOURCES:
        return HOST_FLAGS
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def _compiler(name: str) -> str:
    return "g++" if name in HOST_SOURCES else nvcc_path()


def library_path(name: str) -> Path:
    src = _source(name).read_bytes()
    digest = hashlib.sha1(src + " ".join(_flags(name)).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names) -> None:
    """Compile the named sources that are not built yet, all at once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_compiler(name), *_flags(name), str(_source(name)), "-o", str(tmp)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("build failed for " + "\n".join(failed))


def load_kernel(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
