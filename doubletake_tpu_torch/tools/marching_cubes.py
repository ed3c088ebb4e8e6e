"""Host-side isosurface extraction and PLY export (ctypes over ``csrc/marching.cpp``).

Counterpart of ``doubletake_tpu/tools/marching_cubes.py``. The extractor is
the port's copy of the JAX package's marching-tetrahedra C++ source, built by
``ops.build`` with the same g++ flags into ``build/torch_kernels/`` at first
use, so the same volume gives the same mesh in both packages. A failed build
raises: there is no fallback. A volume on the card is copied to the host once
per export.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np
import torch

from doubletake_tpu_torch.ops.build import load_kernel


def _lib():
    lib = load_kernel("marching")
    lib.marching_tetrahedra.restype = ctypes.c_int
    lib.marching_tetrahedra.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.mt_free.argtypes = [ctypes.c_void_p]
    return lib


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def extract_mesh(
    values,
    weights=None,
    isolevel: float = 0.0,
    weight_threshold: float = 0.0,
    origin=None,
    voxel_size: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract (verts (V, 3) float32, faces (F, 3) int32) from a dense
    (X, Y, Z) volume (numpy or torch).

    verts are in world coordinates when origin/voxel_size are given, else in
    voxel index coordinates. Cells with any unobserved corner (weight <=
    threshold) are skipped when weights is given.
    """
    vol = np.ascontiguousarray(np.clip(_host(values), -1.0, 1.0), np.float32)
    nx, ny, nz = vol.shape
    lib = _lib()

    wptr = None
    if weights is not None:
        wts = np.ascontiguousarray(_host(weights), np.float32)
        wptr = wts.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    verts_p = ctypes.POINTER(ctypes.c_float)()
    faces_p = ctypes.POINTER(ctypes.c_int32)()
    nv = ctypes.c_int64()
    nf = ctypes.c_int64()
    rc = lib.marching_tetrahedra(
        vol.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        wptr, ctypes.c_float(weight_threshold),
        nx, ny, nz, ctypes.c_float(isolevel),
        ctypes.byref(verts_p), ctypes.byref(nv),
        ctypes.byref(faces_p), ctypes.byref(nf),
    )
    if rc != 0:
        raise RuntimeError("marching_tetrahedra failed")
    try:
        verts = np.ctypeslib.as_array(verts_p, shape=(nv.value, 3)).copy() \
            if nv.value else np.zeros((0, 3), np.float32)
        faces = np.ctypeslib.as_array(faces_p, shape=(nf.value, 3)).copy() \
            if nf.value else np.zeros((0, 3), np.int32)
    finally:
        lib.mt_free(verts_p)
        lib.mt_free(faces_p)

    if origin is not None:
        verts = _host(origin).astype(np.float32)[None] + verts * voxel_size
    return verts, faces


def tsdf_to_mesh(tsdf, observed_only: bool = True):
    """The mesh of a ``tools.tsdf.TSDF`` in world coordinates, unobserved
    cells skipped."""
    return extract_mesh(
        tsdf.values,
        weights=tsdf.weights if observed_only else None,
        isolevel=0.0,
        weight_threshold=0.0,
        origin=tsdf.origin,
        voxel_size=tsdf.voxel_size,
    )


def save_ply(path: str, verts: np.ndarray, faces: np.ndarray,
             colors: Optional[np.ndarray] = None):
    """Write a binary little-endian PLY (the JAX package's bytes)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n, m = len(verts), len(faces)
    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0",
                  f"element vertex {n}",
                  "property float x", "property float y", "property float z"]
        if colors is not None:
            header += ["property uchar red", "property uchar green",
                       "property uchar blue"]
        header += [f"element face {m}",
                   "property list uchar int vertex_indices", "end_header"]
        f.write(("\n".join(header) + "\n").encode())
        if colors is not None:
            rec = np.zeros(n, dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
            rec["xyz"] = verts.astype(np.float32)
            rec["rgb"] = colors.astype(np.uint8)
            f.write(rec.tobytes())
        else:
            f.write(verts.astype(np.float32).tobytes())
        rec = np.zeros(m, dtype=[("cnt", np.uint8), ("idx", np.int32, 3)])
        rec["cnt"] = 3
        rec["idx"] = faces.astype(np.int32)
        f.write(rec.tobytes())


_PLY_TYPES = {"float": np.float32, "float32": np.float32, "double": np.float64,
              "uchar": np.uint8, "uint8": np.uint8, "int": np.int32, "uint": np.uint32,
              "short": np.int16, "ushort": np.uint16}


def load_ply(path: str, return_colors: bool = False):
    """Read a PLY (binary little-endian or ascii): (verts, faces), and the
    (V, 3) uint8 vertex colours (None without them) if ``return_colors``."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            header.append(line)
            if line == "end_header":
                break
        n_verts = n_faces = 0
        vert_props = []
        binary = any("binary_little_endian" in h for h in header)
        section = None
        for h in header:
            if h.startswith("element vertex"):
                n_verts = int(h.split()[-1])
                section = "vertex"
            elif h.startswith("element face"):
                n_faces = int(h.split()[-1])
                section = "face"
            elif h.startswith("property") and section == "vertex":
                parts = h.split()
                vert_props.append((parts[-1], parts[1]))
        names = [p[0] for p in vert_props]
        has_rgb = all(c in names for c in ("red", "green", "blue"))

        if binary:
            dt = np.dtype([(name, _PLY_TYPES[t]) for name, t in vert_props])
            vdata = np.frombuffer(f.read(dt.itemsize * n_verts), dtype=dt)
            verts = np.stack([vdata["x"], vdata["y"], vdata["z"]], -1).astype(np.float32)
            colors = (np.stack([vdata["red"], vdata["green"], vdata["blue"]], -1)
                      .astype(np.uint8) if has_rgb else None)
            raw = f.read()
            tri = np.dtype([("cnt", np.uint8), ("idx", "<i4", 3)])
            rec = (np.frombuffer(raw, dtype=tri) if len(raw) == tri.itemsize * n_faces
                   else None)
            if rec is not None and (rec["cnt"] == 3).all():
                faces = rec["idx"].astype(np.int32)
            else:   # polygons of other sizes: their first three indices
                faces = np.zeros((n_faces, 3), np.int32)
                off = 0
                for i in range(n_faces):
                    cnt = raw[off]
                    off += 1
                    faces[i] = np.frombuffer(raw[off: off + 4 * cnt], np.int32)[:3]
                    off += 4 * cnt
        else:
            rows = [f.readline().split() for _ in range(n_verts)]
            verts = np.asarray([[float(r[names.index(a)]) for a in ("x", "y", "z")]
                                for r in rows], np.float32).reshape(n_verts, 3)
            colors = (np.asarray([[int(r[names.index(c)]) for c in ("red", "green", "blue")]
                                  for r in rows], np.uint8).reshape(n_verts, 3)
                      if has_rgb else None)
            faces = np.zeros((n_faces, 3), np.int32)
            for i in range(n_faces):
                vals = f.readline().split()
                faces[i] = [int(v) for v in vals[1:4]]
    return (verts, faces, colors) if return_colors else (verts, faces)


def sample_colors(tsdf, verts: np.ndarray) -> np.ndarray:
    """The fused colours at the vertices, trilinear, as uint8-range floats
    (the JAX package's ``export_mesh``, marching_cubes.py:208-228)."""
    vox = (verts - _host(tsdf.origin)[None]) / tsdf.voxel_size
    vol = _host(tsdf.colors).astype(np.float32)
    dims = np.asarray(vol.shape[:3])
    vox = np.clip(vox, 0.0, dims[None] - 1.0 - 1e-4)
    v0 = np.floor(vox).astype(np.int64)
    f = vox - v0
    rgb = np.zeros((len(verts), 3), np.float32)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((f[:, 0] if dx else 1 - f[:, 0])
                     * (f[:, 1] if dy else 1 - f[:, 1])
                     * (f[:, 2] if dz else 1 - f[:, 2]))
                idx = np.minimum(v0 + [dx, dy, dz], dims - 1)
                rgb += w[:, None] * vol[idx[:, 0], idx[:, 1], idx[:, 2]]
    return np.clip(rgb * 255.0, 0, 255)


def export_mesh(tsdf, path: str):
    """TSDF -> single-walled PLY mesh on disk; returns (verts, faces).

    A volume with fused colours (``TSDF.colors``) gives its vertices the
    trilinearly sampled RGB (reference fusers_helper.py:195-211)."""
    verts, faces = tsdf_to_mesh(tsdf)
    colors = sample_colors(tsdf, verts) if tsdf.colors is not None else None
    save_ply(path, verts, faces, colors=colors)
    return verts, faces
