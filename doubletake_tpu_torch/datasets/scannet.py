"""ScanNetv2 dataset reader.

Format parity with reference src/doubletake/datasets/scannet_dataset.py:
scans laid out as ``scans*/<scan_id>/sensor_data/frame-%06d.{color.jpg,
depth.png,pose.txt}`` with per-scan metadata ``<scan_id>.txt`` and
``intrinsic/intrinsic_depth.txt``; depth pngs scale by 1e-3 (:521), invalids
NaN-coded; optional cached resized color/depth (``.512.png`` style);
pre-rendered depth-hint pngs scale 1/2048 for depth and 1/8192 for weights
with a 50%% partial-render choice at train time (:577-630); valid-frame
lists ``valid_frames.txt`` per scan; GT mesh at
``scans_test/<scan>/<scan>_vh_clean_2.ply`` (:298-309).
"""

from __future__ import annotations

import os
import random
from typing import Optional

import numpy as np

from doubletake_tpu_torch.datasets.generic_mvs_dataset import GenericMVSDataset
from doubletake_tpu_torch.utils.io import read_image_file, readlines


class ScannetDataset(GenericMVSDataset):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._metadata_cache = {}
        self._K_cache = {}

    # ------------------------------------------------------------------ #
    # paths                                                              #
    # ------------------------------------------------------------------ #

    def _scans_root(self):
        folder = "scans_test" if self.split in ("test",) else "scans"
        return os.path.join(self.dataset_path, folder)

    def scan_path(self, scan_id):
        return os.path.join(self._scans_root(), scan_id)

    def _frame_path(self, scan_id, frame_id, suffix):
        return os.path.join(
            self.scan_path(scan_id), "sensor_data", f"frame-{int(frame_id):06d}.{suffix}"
        )

    def get_gt_mesh_path(self, scan_id):
        return os.path.join(self.scan_path(scan_id), f"{scan_id}_vh_clean_2.ply")

    def get_frame_id_string(self, frame_id):
        return f"frame_{int(frame_id):06d}"

    # ------------------------------------------------------------------ #
    # metadata                                                           #
    # ------------------------------------------------------------------ #

    def _metadata(self, scan_id):
        if scan_id not in self._metadata_cache:
            path = os.path.join(self.scan_path(scan_id), f"{scan_id}.txt")
            data = {}
            for line in readlines(path):
                if " = " in line:
                    k, v = line.split(" = ")
                    data[k] = v
            self._metadata_cache[scan_id] = data
        return self._metadata_cache[scan_id]

    # ------------------------------------------------------------------ #
    # loaders                                                            #
    # ------------------------------------------------------------------ #

    def load_pose(self, scan_id, frame_id):
        pose_path = self._frame_path(scan_id, frame_id, "pose.txt")
        world_T_cam = np.genfromtxt(pose_path).astype(np.float32)
        cam_T_world = np.linalg.inv(world_T_cam).astype(np.float32)
        return world_T_cam, cam_T_world

    def load_color(self, scan_id, frame_id):
        # prefer a cached resized copy if present
        cached = self._frame_path(
            scan_id, frame_id, f"color.{self.image_width}.png"
        )
        path = cached if os.path.exists(cached) else self._frame_path(
            scan_id, frame_id, "color.jpg"
        )
        return read_image_file(
            path, height=self.image_height, width=self.image_width
        )

    def load_high_res_color(self, scan_id, frame_id):
        path = self._frame_path(scan_id, frame_id, "color.jpg")
        return read_image_file(path, height=480, width=640)

    def _load_depth(self, scan_id, frame_id, height, width):
        cached = self._frame_path(scan_id, frame_id, f"depth.{width}.png")
        path = cached if os.path.exists(cached) else self._frame_path(
            scan_id, frame_id, "depth.png"
        )
        depth = read_image_file(
            path, height=height, width=width,
            value_scale_factor=1e-3, resampling_mode="nearest",
        )
        mask_b = (depth > 0) & np.isfinite(depth)
        depth = np.where(mask_b, depth, np.nan).astype(np.float32)
        return depth, mask_b.astype(np.float32), mask_b

    def load_target_size_depth_and_mask(self, scan_id, frame_id):
        return self._load_depth(scan_id, frame_id, self.depth_height, self.depth_width)

    def load_full_res_depth_and_mask(self, scan_id, frame_id):
        meta = self._metadata(scan_id)
        return self._load_depth(
            scan_id, frame_id, int(meta["depthHeight"]), int(meta["depthWidth"])
        )

    def load_intrinsics(self, scan_id, frame_id=None, flip=False):
        meta = self._metadata(scan_id)
        if scan_id not in self._K_cache:
            path = os.path.join(self.scan_path(scan_id), "intrinsic", "intrinsic_depth.txt")
            self._K_cache[scan_id] = np.genfromtxt(path).astype(np.float32)
        K = self._K_cache[scan_id].copy()
        native_w = float(meta["depthWidth"])
        native_h = float(meta["depthHeight"])
        if flip:
            K[0, 2] = native_w - K[0, 2]

        out = {}
        if self.include_full_depth_K:
            out["K_full_depth_b44"] = K.copy()
            out["invK_full_depth_b44"] = np.linalg.inv(K).astype(np.float32)

        K = K.copy()
        K[0] *= self.depth_width / native_w
        K[1] *= self.depth_height / native_h
        for i in range(5):
            Ks = K.copy()
            Ks[:2] /= 2**i
            out[f"K_s{i}_b44"] = Ks
            out[f"invK_s{i}_b44"] = np.linalg.inv(Ks).astype(np.float32)
        return out

    # ------------------------------------------------------------------ #
    # depth hints (pre-rendered pngs for hint-augmented training)        #
    # ------------------------------------------------------------------ #

    def load_depth_hint(self, scan_id, frame_id, flip=False, mark_all_empty=False):
        h, w = self.image_height, self.image_width
        if mark_all_empty or self.depth_hint_dir is None:
            return self.empty_hint(h, w)

        # 50/50 full vs partial renders at train time (scannet_dataset.py:591-598)
        use_partial = self.split == "train" and random.random() < 0.5
        sub = "partial_renders" if use_partial else "renders"
        base = os.path.join(self.depth_hint_dir, scan_id, sub)
        depth_path = os.path.join(base, f"depth_{int(frame_id):06d}.png")
        weight_path = os.path.join(base, f"weights_{int(frame_id):06d}.png")
        if not os.path.exists(depth_path):
            return self.empty_hint(h, w)

        depth = read_image_file(
            depth_path, height=h, width=w, value_scale_factor=1.0 / 2048.0,
            resampling_mode="nearest",
        )
        weights = read_image_file(
            weight_path, height=h, width=w, value_scale_factor=1.0 / 8192.0,
            resampling_mode="nearest",
        )
        if flip:
            depth = depth[:, ::-1].copy()
            weights = weights[:, ::-1].copy()
        mask = depth > 0
        depth = np.where(mask, depth, np.nan).astype(np.float32)
        return {
            "depth_hint_bhw1": depth,
            "hint_mask_bhw1": mask,
            "sampled_weights_bhw1": weights.astype(np.float32),
        }

    # ------------------------------------------------------------------ #
    # valid frames                                                       #
    # ------------------------------------------------------------------ #

    def get_valid_frame_ids(self, scan_id) -> list:
        """Reads (or computes) valid_frames.txt: frames with finite pose."""
        path = os.path.join(self.scan_path(scan_id), "valid_frames.txt")
        if os.path.exists(path):
            return readlines(path)
        meta = self._metadata(scan_id)
        count = int(meta.get("numColorFrames", meta.get("numDepthFrames", 0)))
        valid = []
        dist_to_last_valid = 0
        for i in range(count):
            try:
                pose, _ = self.load_pose(scan_id, i)
                ok = np.isfinite(pose).all()
            except OSError:
                ok = False
            if ok:
                valid.append(f"{scan_id} {i:06d} {dist_to_last_valid}")
                dist_to_last_valid = 0
            else:
                dist_to_last_valid += 1
        return valid
