"""COLMAP text-format dataset reader (casual captures, no GT depth).

Format parity with reference src/doubletake/datasets/colmap_dataset.py:
scans at ``<root>/<scan>/`` with ``sparse/0/{cameras.txt, images.txt}``,
undistorted images in ``images/``, a metric ``scale.txt``, and the
rotx(-pi/2) world alignment + pose scaling (:270-311); camera models
SIMPLE_PINHOLE / PINHOLE / SIMPLE_RADIAL / RADIAL / OPENCV (:326-370);
optional FOV-targeted center crop to [58.18, 45.12] degrees (:312-376).
GT depth is unavailable — depth loaders return empty masks.
"""

from __future__ import annotations

import os

import numpy as np

from doubletake_tpu_torch.datasets.generic_mvs_dataset import GenericMVSDataset
from doubletake_tpu_torch.utils.geometry import qvec2rotmat, rotx
from doubletake_tpu_torch.utils.io import read_image_file

TARGET_FOV_DEG = (58.18, 45.12)


def fov_to_image_dimension(fov_degrees: float, focal_length: float) -> float:
    return 2.0 * focal_length * np.tan(np.radians(fov_degrees) / 2.0)


def parse_cameras_txt(path: str):
    """First camera entry: (w, h, fx, fy, cx, cy)."""
    with open(path) as f:
        for line in f:
            if not line.strip() or line.startswith("#"):
                continue
            els = line.split()
            model = els[1]
            w, h = float(els[2]), float(els[3])
            fx = fy = float(els[4])
            cx, cy = w / 2, h / 2
            if model == "SIMPLE_PINHOLE":
                cx, cy = float(els[5]), float(els[6])
            elif model == "PINHOLE":
                fy, cx, cy = float(els[5]), float(els[6]), float(els[7])
            elif model in ("SIMPLE_RADIAL", "RADIAL"):
                cx, cy = float(els[5]), float(els[6])
            elif model == "OPENCV":
                fy, cx, cy = float(els[5]), float(els[6]), float(els[7])
            return w, h, fx, fy, cx, cy
    raise ValueError(f"no camera found in {path}")


class ColmapDataset(GenericMVSDataset):
    def __init__(self, *args, modify_to_fov: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.modify_to_fov = modify_to_fov
        self.capture_poses = {}
        self._camera_cache = {}

    def scan_path(self, scan_id):
        return os.path.join(self.dataset_path, scan_id)

    def _sparse_dir(self, scan_id):
        return os.path.join(self.scan_path(scan_id), "sparse", "0")

    def _camera(self, scan_id):
        if scan_id not in self._camera_cache:
            self._camera_cache[scan_id] = parse_cameras_txt(
                os.path.join(self._sparse_dir(scan_id), "cameras.txt")
            )
        return self._camera_cache[scan_id]

    def get_frame_id_string(self, frame_id):
        return str(frame_id)

    # ------------------------------------------------------------------ #

    def load_capture_poses(self, scan_id):
        if scan_id in self.capture_poses:
            return
        self.capture_poses[scan_id] = {}
        bottom = np.array([[0.0, 0.0, 0.0, 1.0]])
        with open(os.path.join(self._sparse_dir(scan_id), "images.txt")) as f:
            i = 0
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                i += 1
                if i % 2 == 1:
                    els = line.split(" ")
                    image_id = "".join(els[9:]).strip().split(".")[0]
                    qvec = np.array(list(map(float, els[1:5])))
                    tvec = np.array(list(map(float, els[5:8])))
                    R = qvec2rotmat(-qvec)
                    m = np.concatenate(
                        [np.concatenate([R, tvec.reshape(3, 1)], 1), bottom], 0
                    )
                    self.capture_poses[scan_id][image_id] = np.linalg.inv(m)

    def _scale(self, scan_id):
        path = os.path.join(self.scan_path(scan_id), "scale.txt")
        if os.path.exists(path):
            with open(path) as f:
                return float(f.readline().strip())
        return 1.0

    def load_pose(self, scan_id, frame_id):
        self.load_capture_poses(scan_id)
        world_T_cam = self.capture_poses[scan_id][str(frame_id)].copy()
        R = rotx(-np.pi / 2)
        world_T_cam[:3, :3] = R @ world_T_cam[:3, :3]
        world_T_cam[:3, 3] = R @ world_T_cam[:3, 3] * self._scale(scan_id)
        world_T_cam = world_T_cam.astype(np.float32)
        return world_T_cam, np.linalg.inv(world_T_cam).astype(np.float32)

    def get_target_fov_hw(self, scan_id):
        _, _, fx, fy, _, _ = self._camera(scan_id)
        new_w = int(np.round(fov_to_image_dimension(TARGET_FOV_DEG[0], fx)))
        new_h = int(np.round(fov_to_image_dimension(TARGET_FOV_DEG[1], fy)))
        return new_h, new_w

    def load_color(self, scan_id, frame_id):
        path = os.path.join(self.scan_path(scan_id), "images", f"{frame_id}.jpg")
        if not os.path.exists(path):
            path = os.path.join(self.scan_path(scan_id), "images", f"{frame_id}.png")
        ratio = None
        if self.modify_to_fov:
            th, tw = self.get_target_fov_hw(scan_id)
            ratio = tw / th
        return read_image_file(
            path, height=self.image_height, width=self.image_width,
            target_aspect_ratio=ratio,
        )

    def load_high_res_color(self, scan_id, frame_id):
        path = os.path.join(self.scan_path(scan_id), "images", f"{frame_id}.jpg")
        if not os.path.exists(path):
            path = os.path.join(self.scan_path(scan_id), "images", f"{frame_id}.png")
        return read_image_file(path, height=480, width=640)

    def load_target_size_depth_and_mask(self, scan_id, frame_id):
        # no GT depth in COLMAP captures
        depth = np.full((self.depth_height, self.depth_width, 1), np.nan, np.float32)
        mask_b = np.zeros_like(depth, bool)
        return depth, mask_b.astype(np.float32), mask_b

    def load_full_res_depth_and_mask(self, scan_id, frame_id):
        depth = np.full((480, 640, 1), np.nan, np.float32)
        mask_b = np.zeros_like(depth, bool)
        return depth, mask_b.astype(np.float32), mask_b

    def load_intrinsics(self, scan_id, frame_id=None, flip=False):
        w, h, fx, fy, cx, cy = self._camera(scan_id)
        if self.modify_to_fov:
            th, tw = self.get_target_fov_hw(scan_id)
            cx -= (w - tw) / 2.0
            cy -= (h - th) / 2.0
            w, h = tw, th
        K = np.eye(4, dtype=np.float32)
        K[0, 0], K[1, 1], K[0, 2], K[1, 2] = fx, fy, cx, cy
        if flip:
            K[0, 2] = w - cx
        out = {}
        if self.include_full_depth_K:
            out["K_full_depth_b44"] = K.copy()
            out["invK_full_depth_b44"] = np.linalg.inv(K).astype(np.float32)
        K = K.copy()
        K[0] *= self.depth_width / w
        K[1] *= self.depth_height / h
        for i in range(5):
            Ks = K.copy()
            Ks[:2] /= 2**i
            out[f"K_s{i}_b44"] = Ks
            out[f"invK_s{i}_b44"] = np.linalg.inv(Ks).astype(np.float32)
        return out
