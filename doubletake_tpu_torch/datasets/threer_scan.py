"""3RScan dataset reader (revisit evaluation).

Format parity with reference src/doubletake/datasets/threer_scan_dataset.py:
scans at ``<root>/<scan_id>/sensor_data/frame-%06d.{color.jpg,depth.pgm,
pose.txt}`` with ``_info.txt`` metadata (``key = value``, calibration
matrices inline, depthShift 1000, :237-285); rescan->reference 4x4
transforms parsed from ``3RScan.json`` with a forbidden-scan list
(:191-235); optional 90-degree image rotation with intrinsics axis swap.

Sensor streams ship as per-scan ``sequence.zip`` archives (reference
layout docstring :20-33); when the extracted ``sensor_data/`` tree is
absent this reader serves frames straight out of the zip (members at the
archive root or under ``sensor_data/``), so downloads never need a 2x-disk
extraction pass.
"""

from __future__ import annotations

import io
import json
import os
import threading
import zipfile
from collections import OrderedDict

import numpy as np

from doubletake_tpu_torch.datasets.generic_mvs_dataset import GenericMVSDataset
from doubletake_tpu_torch.utils.io import read_image_file, readlines


class ThreeRScanDataset(GenericMVSDataset):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._metadata_cache = {}
        self._rescan_map = None
        # zipfile.ZipFile reads are not thread-safe on a shared handle and
        # the DataLoader uses worker THREADS: keep one open handle per
        # (thread, scan) in thread-local storage.
        self._zip_local = threading.local()

    # ------------------------------------------------------------------ #

    def scan_path(self, scan_id):
        return os.path.join(self.dataset_path, scan_id)

    def _frame_path(self, scan_id, frame_id, suffix):
        return os.path.join(
            self.scan_path(scan_id), "sensor_data",
            f"frame-{int(frame_id):06d}.{suffix}",
        )

    def _zip_handle(self, scan_id):
        zpath = os.path.join(self.scan_path(scan_id), "sequence.zip")
        if not os.path.exists(zpath):
            return None
        cache = getattr(self._zip_local, "handles", None)
        if cache is None:
            cache = self._zip_local.handles = {}
        if scan_id not in cache:
            cache[scan_id] = zipfile.ZipFile(zpath)
        return cache[scan_id]

    def _sensor_file(self, scan_id, name):
        """Path or file-like for ``sensor_data/<name>``: the extracted tree
        when present, else the member inside ``sequence.zip``."""
        path = os.path.join(self.scan_path(scan_id), "sensor_data", name)
        if os.path.exists(path):
            return path
        zf = self._zip_handle(scan_id)
        if zf is not None:
            for member in (name, f"sensor_data/{name}"):
                try:
                    return io.BytesIO(zf.read(member))
                except KeyError:
                    continue
        raise FileNotFoundError(
            f"{scan_id}: no extracted sensor_data/{name} and no matching "
            f"member in sequence.zip"
        )

    def _frame_file(self, scan_id, frame_id, suffix):
        return self._sensor_file(
            scan_id, f"frame-{int(frame_id):06d}.{suffix}"
        )

    def get_frame_id_string(self, frame_id):
        return f"frame_{int(frame_id):06d}"

    def _metadata(self, scan_id):
        if scan_id not in self._metadata_cache:
            src = self._sensor_file(scan_id, "_info.txt")
            meta = {}
            f = open(src) if isinstance(src, str) else io.TextIOWrapper(src)
            with f:
                for line in f:
                    if " = " not in line:
                        continue
                    key, value = line.strip().split(" = ", 1)
                    if "calibration" in key.lower():
                        meta[key] = np.array(
                            [float(x) for x in value.split()], np.float32
                        ).reshape(4, 4)
                    else:
                        meta[key] = value
            self._metadata_cache[scan_id] = meta
        return self._metadata_cache[scan_id]

    # ------------------------------------------------------------------ #
    # revisit machinery                                                  #
    # ------------------------------------------------------------------ #

    @classmethod
    def parse_rescan_transforms(cls, dataset_path: str, scan_list,
                                forbidden_list_path="data_splits/3rscan/forbidden_list.txt"):
        """{reference_scan: {rescan_id: rescan->reference 4x4}} from
        3RScan.json; transforms stored row-major-transposed in the json."""
        with open(os.path.join(dataset_path, "3RScan.json")) as f:
            scene_metadata = json.load(f)
        forbidden = set()
        if os.path.exists(forbidden_list_path):
            forbidden = set(readlines(forbidden_list_path))
        rescan_map = {}
        for scene in scene_metadata:
            if scan_list is not None and scene["reference"] not in scan_list:
                continue
            rescans = OrderedDict()
            for rescan in scene.get("scans", []):
                if "transform" not in rescan or rescan["reference"] in forbidden:
                    continue
                rescans[rescan["reference"]] = (
                    np.array([float(x) for x in rescan["transform"]], np.float32)
                    .reshape(4, 4).T
                )
            if rescans:
                rescan_map[scene["reference"]] = rescans
        return rescan_map

    def revisit_source_scan(self, scan_id):
        """(first_visit_scan_id, first_T_second) for a rescan id."""
        if self._rescan_map is None:
            self._rescan_map = self.parse_rescan_transforms(self.dataset_path, None)
        for reference, rescans in self._rescan_map.items():
            if scan_id in rescans:
                return reference, rescans[scan_id]
        raise KeyError(f"no rescan transform for {scan_id}")

    # ------------------------------------------------------------------ #
    # loaders                                                            #
    # ------------------------------------------------------------------ #

    def load_pose(self, scan_id, frame_id):
        world_T_cam = np.genfromtxt(
            self._frame_file(scan_id, frame_id, "pose.txt")
        ).astype(np.float32).reshape(4, 4)
        if self.rotate_images:
            from doubletake_tpu_torch.utils.geometry import rotz

            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = rotz(-np.pi / 2)
            world_T_cam = world_T_cam @ T
        return world_T_cam, np.linalg.inv(world_T_cam).astype(np.float32)

    def load_color(self, scan_id, frame_id):
        cached = self._frame_path(scan_id, frame_id, f"color.{self.image_width}.png")
        path = cached if os.path.exists(cached) else self._frame_file(
            scan_id, frame_id, "color.jpg"
        )
        img = read_image_file(path, height=self.image_height, width=self.image_width)
        if self.rotate_images:
            img = np.rot90(img, k=3).copy()
        return img

    def load_high_res_color(self, scan_id, frame_id):
        meta = self._metadata(scan_id)
        img = read_image_file(
            self._frame_file(scan_id, frame_id, "color.jpg"),
            height=int(meta["m_colorHeight"]), width=int(meta["m_colorWidth"]),
        )
        if self.rotate_images:
            img = np.rot90(img, k=3).copy()
        return img

    def _load_depth(self, scan_id, frame_id, height, width):
        meta = self._metadata(scan_id)
        shift = float(meta.get("m_depthShift", 1000.0))
        cached = self._frame_path(scan_id, frame_id, f"depth.{width}.png")
        path = cached if os.path.exists(cached) else self._frame_file(
            scan_id, frame_id, "depth.pgm"
        )
        depth = read_image_file(
            path, height=height, width=width,
            value_scale_factor=1.0 / shift, resampling_mode="nearest",
        )
        mask_b = (depth > 0) & np.isfinite(depth)
        depth = np.where(mask_b, depth, np.nan).astype(np.float32)
        if self.rotate_images:
            depth = np.rot90(depth, k=3).copy()
            mask_b = np.rot90(mask_b, k=3).copy()
        return depth, mask_b.astype(np.float32), mask_b

    def load_target_size_depth_and_mask(self, scan_id, frame_id):
        return self._load_depth(scan_id, frame_id, self.depth_height, self.depth_width)

    def load_full_res_depth_and_mask(self, scan_id, frame_id):
        meta = self._metadata(scan_id)
        return self._load_depth(
            scan_id, frame_id, int(meta["m_depthHeight"]), int(meta["m_depthWidth"])
        )

    def load_intrinsics(self, scan_id, frame_id=None, flip=False):
        meta = self._metadata(scan_id)
        K = meta["m_calibrationColorIntrinsic"].astype(np.float32).copy()
        color_w = float(meta["m_colorWidth"])
        color_h = float(meta["m_colorHeight"])
        if flip:
            K[0, 2] = color_w - K[0, 2]
        # normalize then scale to target depth resolution (reference
        # threer_scan_dataset.py:600-640)
        K[0] /= color_w
        K[1] /= color_h

        def rotate_K(Km, h):
            out = Km.copy()
            out[0, 0], out[1, 1] = Km[1, 1], Km[0, 0]
            out[1, 2] = Km[0, 2]
            out[0, 2] = h - Km[1, 2]
            return out

        out = {}
        if self.include_full_depth_K:
            fk = K.copy()
            fk[0] *= float(meta["m_depthWidth"])
            fk[1] *= float(meta["m_depthHeight"])
            if self.rotate_images:
                fk = rotate_K(fk, float(meta["m_depthHeight"]))
            out["K_full_depth_b44"] = fk
            out["invK_full_depth_b44"] = np.linalg.inv(fk).astype(np.float32)

        K = K.copy()
        K[0] *= self.depth_width
        K[1] *= self.depth_height
        if self.rotate_images:
            K = rotate_K(K, self.depth_height)
        for i in range(5):
            Ks = K.copy()
            Ks[:2] /= 2**i
            out[f"K_s{i}_b44"] = Ks
            out[f"invK_s{i}_b44"] = np.linalg.inv(Ks).astype(np.float32)
        return out
