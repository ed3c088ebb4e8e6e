"""7Scenes dataset reader.

Format parity with reference src/doubletake/datasets/seven_scenes_dataset.py:
scans at ``<root>/<scene>/seq-XX/frame-%06d.{pose.txt,color.png,
depth.proj.png}`` with KinectFusion-projected depth stored x1000; fixed
intrinsics fx=fy=525, cx=320, cy=240 at 640x480 (:395-399); invalid depth
values (0 or 65535) NaN-coded.
"""

from __future__ import annotations

import os

import numpy as np

from doubletake_tpu_torch.datasets.generic_mvs_dataset import GenericMVSDataset
from doubletake_tpu_torch.utils.io import read_image_file, readlines


class SevenScenesDataset(GenericMVSDataset):
    NATIVE_W, NATIVE_H = 640, 480

    def scan_path(self, scan_id):
        # scan ids look like "chess/seq-01"
        return os.path.join(self.dataset_path, scan_id)

    def _frame_path(self, scan_id, frame_id, suffix):
        return os.path.join(self.scan_path(scan_id), f"frame-{self._fid(frame_id)}.{suffix}")

    @staticmethod
    def _fid(frame_id):
        return f"{int(frame_id):06d}" if str(frame_id).isdigit() else str(frame_id)

    def get_frame_id_string(self, frame_id):
        return f"frame_{self._fid(frame_id)}"

    def load_pose(self, scan_id, frame_id):
        world_T_cam = np.genfromtxt(
            self._frame_path(scan_id, frame_id, "pose.txt")
        ).astype(np.float32).reshape(4, 4)
        return world_T_cam, np.linalg.inv(world_T_cam).astype(np.float32)

    def load_color(self, scan_id, frame_id):
        cached = self._frame_path(scan_id, frame_id, f"color.{self.image_width}.png")
        path = cached if os.path.exists(cached) else self._frame_path(
            scan_id, frame_id, "color.png"
        )
        return read_image_file(path, height=self.image_height, width=self.image_width)

    def load_high_res_color(self, scan_id, frame_id):
        return read_image_file(
            self._frame_path(scan_id, frame_id, "color.png"),
            height=self.NATIVE_H, width=self.NATIVE_W,
        )

    def _load_depth(self, scan_id, frame_id, height, width):
        cached = self._frame_path(scan_id, frame_id, f"depth.proj.{width}.png")
        path = cached if os.path.exists(cached) else self._frame_path(
            scan_id, frame_id, "depth.proj.png"
        )
        depth = read_image_file(
            path, height=height, width=width,
            value_scale_factor=1e-3, resampling_mode="nearest",
        )
        # 65535 codes invalid in the raw Kinect data (65.535 after scaling)
        mask_b = (depth > 0) & (depth < 65.0) & np.isfinite(depth)
        depth = np.where(mask_b, depth, np.nan).astype(np.float32)
        return depth, mask_b.astype(np.float32), mask_b

    def load_target_size_depth_and_mask(self, scan_id, frame_id):
        return self._load_depth(scan_id, frame_id, self.depth_height, self.depth_width)

    def load_full_res_depth_and_mask(self, scan_id, frame_id):
        return self._load_depth(scan_id, frame_id, self.NATIVE_H, self.NATIVE_W)

    def load_intrinsics(self, scan_id=None, frame_id=None, flip=False):
        K = np.eye(4, dtype=np.float32)
        K[0, 0] = K[1, 1] = 525.0
        K[0, 2], K[1, 2] = 320.0, 240.0
        if flip:
            K[0, 2] = self.NATIVE_W - K[0, 2]
        out = {}
        if self.include_full_depth_K:
            out["K_full_depth_b44"] = K.copy()
            out["invK_full_depth_b44"] = np.linalg.inv(K).astype(np.float32)
        K = K.copy()
        K[0] *= self.depth_width / self.NATIVE_W
        K[1] *= self.depth_height / self.NATIVE_H
        for i in range(5):
            Ks = K.copy()
            Ks[:2] /= 2**i
            out[f"K_s{i}_b44"] = Ks
            out[f"invK_s{i}_b44"] = np.linalg.inv(Ks).astype(np.float32)
        return out

    def get_valid_frame_ids(self, scan_id):
        path = os.path.join(self.scan_path(scan_id), "valid_frames.txt")
        if os.path.exists(path):
            return readlines(path)
        frame_ids = sorted(
            f[len("frame-"):-len(".pose.txt")]
            for f in os.listdir(self.scan_path(scan_id))
            if f.endswith(".pose.txt")
        )
        valid = []
        for fid in frame_ids:
            pose, _ = self.load_pose(scan_id, fid)
            if np.isfinite(pose).all():
                valid.append(f"{scan_id} {fid}")
        return valid
