"""Generic MVS dataset: host-side frame/tuple loading (numpy, NHWC).

Capability parity with reference
src/doubletake/datasets/generic_mvs_dataset.py: tuple-file driven loading
(``scan_id ref_id src_id...``), per-frame dicts of image/depth/pose/
intrinsics-pyramid (+ optional hints, full-res depth, high-res color),
train-time horizontal flip, and DVMVS pose-penalty ordering of source
frames (:722-738).

Differences from the reference: arrays are NHWC numpy (the device pipeline
converts once per batch), key names use *_bhw3 / *_bhw1 / *_b44 suffixes
describing the batched layout, and there is no torch DataLoader — see
doubletake_tpu_torch/data/loader.py for the threaded prefetch loader.
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Optional

import numpy as np

from doubletake_tpu_torch.utils.io import imagenet_normalize, readlines


class GenericMVSDataset:
    """Base class. Subclasses implement the per-format loaders."""

    def __init__(
        self,
        dataset_path: str,
        split: str,
        mv_tuple_file_suffix: Optional[str],
        tuple_info_file_location: Optional[str] = None,
        limit_to_scan_id: Optional[str] = None,
        num_images_in_tuple: Optional[int] = None,
        image_height: int = 384,
        image_width: int = 512,
        image_depth_ratio: int = 2,
        include_high_res_color: bool = False,
        include_full_res_depth: bool = False,
        include_full_depth_K: bool = False,
        pass_frame_id: bool = False,
        shuffle_tuple: bool = False,
        fill_depth_hints: bool = False,
        depth_hint_aug: float = 0.0,
        depth_hint_dir: Optional[str] = None,
        load_empty_hints: bool = False,
        disable_flip: bool = True,
        rotate_images: bool = False,
        skip_frames: Optional[int] = None,
        skip_to_frame: Optional[int] = None,
    ):
        self.dataset_path = dataset_path
        self.split = split
        self.image_height = image_height
        self.image_width = image_width
        self.depth_height = image_height // image_depth_ratio
        self.depth_width = image_width // image_depth_ratio
        self.include_high_res_color = include_high_res_color
        self.include_full_res_depth = include_full_res_depth
        self.include_full_depth_K = include_full_depth_K
        self.pass_frame_id = pass_frame_id
        self.shuffle_tuple = shuffle_tuple
        self.fill_depth_hints = fill_depth_hints
        self.depth_hint_aug = depth_hint_aug
        self.depth_hint_dir = depth_hint_dir
        self.load_empty_hints = load_empty_hints
        self.disable_flip = disable_flip
        self.rotate_images = rotate_images
        self.num_images_in_tuple = num_images_in_tuple

        self.frame_tuples: List[str] = []
        if mv_tuple_file_suffix is not None and tuple_info_file_location is not None:
            tuple_file = os.path.join(
                tuple_info_file_location, f"{split}{mv_tuple_file_suffix}"
            )
            self.frame_tuples = readlines(tuple_file)
            if limit_to_scan_id is not None:
                self.frame_tuples = [
                    t for t in self.frame_tuples
                    if limit_to_scan_id == t.split(" ")[0]
                ]
            if skip_to_frame is not None:
                self.frame_tuples = self.frame_tuples[skip_to_frame:]
            if skip_frames is not None:
                self.frame_tuples = self.frame_tuples[::skip_frames]

    def __len__(self):
        return len(self.frame_tuples)

    # ------------------------------------------------------------------ #
    # per-format hooks                                                   #
    # ------------------------------------------------------------------ #

    def load_pose(self, scan_id, frame_id):
        """Returns (world_T_cam_44, cam_T_world_44) float32."""
        raise NotImplementedError

    def load_color(self, scan_id, frame_id):
        """Returns (H, W, 3) float32 RGB in [0, 1] at image resolution."""
        raise NotImplementedError

    def load_high_res_color(self, scan_id, frame_id):
        raise NotImplementedError

    def load_target_size_depth_and_mask(self, scan_id, frame_id):
        """Returns (depth_hw1 NaN-coded, mask_hw1 float, mask_b_hw1 bool)."""
        raise NotImplementedError

    def load_full_res_depth_and_mask(self, scan_id, frame_id):
        raise NotImplementedError

    def load_intrinsics(self, scan_id, frame_id=None, flip=False) -> Dict[str, np.ndarray]:
        """Returns K_s{i}_b44 / invK_s{i}_b44 for i in [0, 4] (+ full-depth K).
        K_s0 is at depth resolution."""
        raise NotImplementedError

    def load_depth_hint(self, scan_id, frame_id, flip=False, mark_all_empty=False):
        """Returns hint dict: depth_hint_bhw1 (NaN-coded), hint_mask_bhw1
        (bool), sampled_weights_bhw1 at image resolution. Default: empty."""
        h, w = self.image_height, self.image_width
        return self.empty_hint(h, w)

    @staticmethod
    def empty_hint(h, w):
        return {
            "depth_hint_bhw1": np.full((h, w, 1), np.nan, np.float32),
            "hint_mask_bhw1": np.zeros((h, w, 1), bool),
            "sampled_weights_bhw1": np.zeros((h, w, 1), np.float32),
        }

    def get_frame_id_string(self, frame_id):
        return str(frame_id)

    # ------------------------------------------------------------------ #
    # assembly                                                           #
    # ------------------------------------------------------------------ #

    def scale_intrinsics_pyramid(self, K_depth_44: np.ndarray, flip: bool = False,
                                 full_K: Optional[np.ndarray] = None,
                                 full_width: Optional[int] = None):
        """Build K_s0..K_s4 (+inverses) from depth-resolution intrinsics."""
        out = {}
        K = K_depth_44.astype(np.float32).copy()
        if flip:
            # flip must be applied in the native frame by callers that know
            # the native width; here we flip at depth res
            K[0, 2] = self.depth_width - K[0, 2]
        if full_K is not None:
            fk = full_K.astype(np.float32).copy()
            if flip and full_width is not None:
                fk[0, 2] = full_width - fk[0, 2]
            out["K_full_depth_b44"] = fk
            out["invK_full_depth_b44"] = np.linalg.inv(fk).astype(np.float32)
        for i in range(5):
            Ks = K.copy()
            Ks[:2] /= 2**i
            out[f"K_s{i}_b44"] = Ks
            out[f"invK_s{i}_b44"] = np.linalg.inv(Ks).astype(np.float32)
        return out

    def frame_image(self, key) -> np.ndarray:
        """The raw image of the frame ``key`` = (scan_id, frame_id, flip):
        (H, W, 3) float32 RGB in [0, 1] from ``load_color``, mirrored
        left-right where ``flip`` says so (a view where it is)."""
        scan_id, frame_id, flip = key
        image = self.load_color(scan_id, frame_id)
        return image[:, ::-1] if flip else image

    def get_frame(self, scan_id, frame_id, load_depth=True, flip=False,
                  load_depth_hint=False):
        """One frame's data dict (unbatched arrays, batched-layout names)."""
        out = {"image_bhw3": imagenet_normalize(self.frame_image((scan_id, frame_id, flip)))}
        out.update(self.frame_data(scan_id, frame_id, load_depth, flip, load_depth_hint))
        return out

    def frame_data(self, scan_id, frame_id, load_depth=True, flip=False,
                   load_depth_hint=False):
        """``get_frame`` without its image."""
        out = {}
        world_T_cam, cam_T_world = self.load_pose(scan_id, frame_id)

        if flip:
            T = np.eye(4, dtype=world_T_cam.dtype)
            T[0, 0] = -1.0
            world_T_cam = world_T_cam @ T
            cam_T_world = np.linalg.inv(world_T_cam)

        out["world_T_cam_b44"] = world_T_cam.astype(np.float32)
        out["cam_T_world_b44"] = cam_T_world.astype(np.float32)
        out.update(self.load_intrinsics(scan_id, frame_id, flip=flip))

        if load_depth:
            depth, mask, mask_b = self.load_target_size_depth_and_mask(scan_id, frame_id)
            if flip:
                depth = depth[:, ::-1].copy()
                mask = mask[:, ::-1].copy()
                mask_b = mask_b[:, ::-1].copy()
            out["depth_bhw1"] = depth
            out["mask_bhw1"] = mask
            out["mask_b_bhw1"] = mask_b

        if self.include_full_res_depth:
            fr_depth, fr_mask, fr_mask_b = self.load_full_res_depth_and_mask(
                scan_id, frame_id
            )
            if flip:
                fr_depth = fr_depth[:, ::-1].copy()
                fr_mask = fr_mask[:, ::-1].copy()
                fr_mask_b = fr_mask_b[:, ::-1].copy()
            out["full_res_depth_bhw1"] = fr_depth
            out["full_res_mask_bhw1"] = fr_mask
            out["full_res_mask_b_bhw1"] = fr_mask_b

        if self.include_high_res_color:
            hr = self.load_high_res_color(scan_id, frame_id)
            if flip:
                hr = hr[:, ::-1].copy()
            out["high_res_color_bhw3"] = imagenet_normalize(hr)

        if self.pass_frame_id:
            out["frame_id_string"] = self.get_frame_id_string(frame_id)

        if load_depth_hint:
            mark_empty = self.load_empty_hints or random.random() < self.depth_hint_aug
            out.update(
                self.load_depth_hint(scan_id, frame_id, flip=flip, mark_all_empty=mark_empty)
            )
        return out

    @staticmethod
    def stack_src_data(src_data_list):
        stacked = {}
        for name in src_data_list[0].keys():
            if "frame_id_string" in name:
                stacked[name] = [d[name] for d in src_data_list]
            else:
                stacked[name] = np.stack([d[name] for d in src_data_list], axis=0)
        return stacked

    def tuple_data(self, idx):
        """Tuple ``idx`` without its images: (cur, src, keys). ``cur`` and
        ``src`` are ``__getitem__``'s dicts less ``image_bhw3``; ``keys`` are
        the frames' (scan_id, frame_id, flip) in ``__getitem__``'s order, the
        reference first, then the sources in DVMVS pose-penalty order.
        ``frame_image`` gives each key's raw image."""
        flip = (
            not self.disable_flip
            and self.split == "train"
            and random.random() < 0.5
        )

        scan_id, *frame_ids = self.frame_tuples[idx].split(" ")
        if self.shuffle_tuple:
            rest = frame_ids[1:]
            random.shuffle(rest)
            frame_ids = [frame_ids[0]] + rest
        if self.num_images_in_tuple is not None:
            frame_ids = frame_ids[: self.num_images_in_tuple]

        frames = [
            self.frame_data(
                scan_id,
                frame_id,
                load_depth=True,
                flip=flip,
                load_depth_hint=(i == 0 and self.fill_depth_hints),
            )
            for i, frame_id in enumerate(frame_ids)
        ]
        cur_data, *src_list = frames
        order = range(len(src_list))

        if not self.shuffle_tuple:
            # order source frames by DVMVS pose penalty w.r.t. the reference
            cur_cam_T_world = cur_data["cam_T_world_b44"]
            penalties = []
            for s in src_list:
                rel = cur_cam_T_world @ s["world_T_cam_b44"]
                tr = np.trace(rel[:3, :3])
                r_m = np.sqrt(max(2 * (1 - min(3.0, tr) / 3), 0.0))
                t_m = np.linalg.norm(rel[:3, 3])
                penalties.append(np.sqrt(r_m**2 + t_m**2))
            order = np.argsort(penalties)
        keys = [(scan_id, frame_ids[0], flip)] + [(scan_id, frame_ids[1 + i], flip) for i in order]
        return cur_data, self.stack_src_data([src_list[i] for i in order]), keys

    def __getitem__(self, idx):
        cur_data, src_data, keys = self.tuple_data(idx)
        images = [imagenet_normalize(self.frame_image(key)) for key in keys]
        return ({"image_bhw3": images[0], **cur_data},
                {"image_bhw3": np.stack(images[1:], axis=0), **src_data})
