"""VDR (iPhone/ARKit capture) dataset reader.

Format parity with reference src/doubletake/datasets/vdr_dataset.py:
``capture.json`` with per-frame pose4x4 (OpenGL, column-major) and
intrinsics (fx, fy, cx, cy); pose converted GL->CV via the sign mask and a
rotx(-pi/2) world alignment (:185-219); RGB at ``frame_{id}.jpg``; ARKit
depth as raw float32 ``depth_{id}.bin`` at 256x192 with uint8
``depthConfidence_{id}.bin`` (invalid where confidence == 0); portrait
support via rotate_images with intrinsics axis swap (:266-284).
"""

from __future__ import annotations

import json
import os

import numpy as np

from doubletake_tpu_torch.datasets.generic_mvs_dataset import GenericMVSDataset
from doubletake_tpu_torch.utils.geometry import rotx
from doubletake_tpu_torch.utils.io import read_image_file

_GL_TO_CV = np.array(
    [[1, -1, -1, 1], [-1, 1, 1, -1], [-1, 1, 1, -1], [1, 1, 1, 1]], np.float32
)


class VDRDataset(GenericMVSDataset):
    NATIVE_DEPTH_W, NATIVE_DEPTH_H = 256, 192

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._capture_metadata = {}

    def scan_path(self, scan_id):
        return os.path.join(self.dataset_path, scan_id)

    def _metadata(self, scan_id):
        if scan_id not in self._capture_metadata:
            with open(os.path.join(self.scan_path(scan_id), "capture.json")) as f:
                self._capture_metadata[scan_id] = json.load(f)
        return self._capture_metadata[scan_id]

    def get_frame_id_string(self, frame_id):
        return str(frame_id)

    def load_pose(self, scan_id, frame_id):
        frame = self._metadata(scan_id)[int(frame_id)]
        world_T_cam = (
            np.asarray(frame["pose4x4"], np.float32).reshape(4, 4).T * _GL_TO_CV
        )
        R = rotx(-np.pi / 2).astype(np.float32)
        world_T_cam[:3, :3] = R @ world_T_cam[:3, :3]
        world_T_cam[:3, 3] = R @ world_T_cam[:3, 3]
        return world_T_cam, np.linalg.inv(world_T_cam).astype(np.float32)

    def load_color(self, scan_id, frame_id):
        cached = os.path.join(
            self.scan_path(scan_id), f"frame.{self.image_width}_{frame_id}.jpg"
        )
        path = cached if os.path.exists(cached) else os.path.join(
            self.scan_path(scan_id), f"frame_{frame_id}.jpg"
        )
        img = read_image_file(path, height=self.image_height, width=self.image_width)
        if self.rotate_images:
            img = np.rot90(img, k=3).copy()
        return img

    def load_high_res_color(self, scan_id, frame_id):
        path = os.path.join(self.scan_path(scan_id), f"frame_{frame_id}.jpg")
        img = read_image_file(path, height=480, width=640)
        if self.rotate_images:
            img = np.rot90(img, k=3).copy()
        return img

    def _read_bin_depth(self, scan_id, frame_id, width):
        """Raw float32 depth + uint8 confidence at a given width."""
        base = self.scan_path(scan_id)
        cached = os.path.join(base, f"depth.{width}_{frame_id}.bin")
        if os.path.exists(cached):
            depth = np.fromfile(cached, np.float32).reshape(-1, width)
            conf_path = os.path.join(base, f"depthConfidence.{width}_{frame_id}.bin")
        else:
            depth = np.fromfile(
                os.path.join(base, f"depth_{frame_id}.bin"), np.float32
            ).reshape(-1, self.NATIVE_DEPTH_W)
            conf_path = os.path.join(base, f"depthConfidence_{frame_id}.bin")
        conf = (
            np.fromfile(conf_path, np.uint8).reshape(depth.shape)
            if os.path.exists(conf_path)
            else np.ones_like(depth, np.uint8)
        )
        return depth, conf

    def _depth_and_mask(self, scan_id, frame_id, height, width):
        depth, conf = self._read_bin_depth(scan_id, frame_id, width)
        if depth.shape != (height, width):
            # nearest-resize raw arrays
            ys = np.floor(np.arange(height) * depth.shape[0] / height).astype(int)
            xs = np.floor(np.arange(width) * depth.shape[1] / width).astype(int)
            depth = depth[ys][:, xs]
            conf = conf[ys][:, xs]
        mask_b = (conf != 0) & np.isfinite(depth) & (depth > 0)
        depth = np.where(mask_b, depth, np.nan).astype(np.float32)[..., None]
        if self.rotate_images:
            depth = np.rot90(depth, k=3).copy()
            mask_b = np.rot90(mask_b, k=3).copy()
        mask_b = mask_b[..., None] if mask_b.ndim == 2 else mask_b
        return depth, mask_b.astype(np.float32), mask_b

    def load_target_size_depth_and_mask(self, scan_id, frame_id):
        return self._depth_and_mask(scan_id, frame_id, self.depth_height, self.depth_width)

    def load_full_res_depth_and_mask(self, scan_id, frame_id):
        return self._depth_and_mask(
            scan_id, frame_id, self.NATIVE_DEPTH_H, self.NATIVE_DEPTH_W
        )

    def load_intrinsics(self, scan_id, frame_id=None, flip=False):
        frame = self._metadata(scan_id)[int(frame_id)]
        img_w, img_h = frame["resolution"]
        fx, fy, cx, cy = frame["intrinsics"][:4]
        K = np.eye(4, dtype=np.float32)
        K[0, 0], K[1, 1], K[0, 2], K[1, 2] = fx, fy, cx, cy
        if flip:
            K[0, 2] = img_w - cx

        def rotate_K(Km, h):
            out = Km.copy()
            out[0, 0], out[1, 1] = Km[1, 1], Km[0, 0]
            out[1, 2] = Km[0, 2]
            out[0, 2] = h - Km[1, 2]
            return out

        out = {}
        if self.include_full_depth_K:
            fk = K.copy()
            fk[0] *= self.NATIVE_DEPTH_W / img_w
            fk[1] *= self.NATIVE_DEPTH_H / img_h
            if self.rotate_images:
                fk = rotate_K(fk, self.NATIVE_DEPTH_H)
            out["K_full_depth_b44"] = fk
            out["invK_full_depth_b44"] = np.linalg.inv(fk).astype(np.float32)

        K = K.copy()
        K[0] *= self.depth_width / img_w
        K[1] *= self.depth_height / img_h
        if self.rotate_images:
            K = rotate_K(K, self.depth_height)
        for i in range(5):
            Ks = K.copy()
            Ks[:2] /= 2**i
            out[f"K_s{i}_b44"] = Ks
            out[f"invK_s{i}_b44"] = np.linalg.inv(Ks).astype(np.float32)
        return out
