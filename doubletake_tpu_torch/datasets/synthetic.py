"""Procedural synthetic MVS dataset: consistent posed RGB-D without files.

No counterpart in the reference (which ships two demo VDR scans instead —
README.md:113-145); in this framework the synthetic dataset is the built-in
smoke/benchmark scene source: a seeded "room" (textured axis-aligned box
interior plus box obstacles) rendered analytically with ray/AABB
intersections, so depth maps, poses and multi-view photoconsistency are
exact by construction. Used by tests, the e2e runners (``--dataset
synthetic``) and bench.py.
"""

from __future__ import annotations

import threading

import numpy as np

from doubletake_tpu_torch.datasets.generic_mvs_dataset import GenericMVSDataset


class SyntheticScene:
    """A seeded room: interior of an AABB + a few solid boxes."""

    def __init__(self, seed: int = 0, room_size=(6.0, 4.0, 3.0), num_boxes: int = 4):
        rng = np.random.RandomState(seed)
        self.room_min = np.array([-room_size[0] / 2, -room_size[1] / 2, 0.0])
        self.room_max = np.array([room_size[0] / 2, room_size[1] / 2, room_size[2]])
        self.boxes = []
        for _ in range(num_boxes):
            # boxes sit on the floor and stay below z=0.9 so the camera
            # orbit (z ~1.2-1.6) always keeps >0.5 m clearance — guarantees
            # every rendered frame has valid GT depth beyond the eval
            # threshold
            half = np.array(
                [rng.uniform(0.2, 0.6), rng.uniform(0.2, 0.6), rng.uniform(0.2, 0.45)]
            )
            cx = rng.uniform(self.room_min[0] + half[0] + 0.2, self.room_max[0] - half[0] - 0.2)
            cy = rng.uniform(self.room_min[1] + half[1] + 0.2, self.room_max[1] - half[1] - 0.2)
            center = np.array([cx, cy, half[2]])
            self.boxes.append((center - half, center + half))
        self.tex_seed = rng.uniform(0, 10, 3)

    def _texture(self, pts_n3):
        """Procedural RGB from world position: smooth bands + checker."""
        s = self.tex_seed
        r = 0.5 + 0.5 * np.sin(3.1 * pts_n3[:, 0] + s[0]) * np.cos(2.3 * pts_n3[:, 1])
        g = 0.5 + 0.5 * np.sin(2.7 * pts_n3[:, 1] + s[1]) * np.cos(1.9 * pts_n3[:, 2])
        checker = ((np.floor(pts_n3[:, 0] * 2) + np.floor(pts_n3[:, 2] * 2)) % 2).astype(
            np.float32
        )
        b = 0.25 + 0.5 * checker + 0.1 * np.sin(5.0 * pts_n3[:, 1] + s[2])
        return np.clip(np.stack([r, g, b], -1), 0.0, 1.0).astype(np.float32)

    def gt_mesh(self):
        """The scene's exact surface as a triangle mesh: the room's box and
        every solid box, 8 corners and 12 triangles each. Returns (verts
        (8 * boxes, 3) float32, faces (12 * boxes, 3) int32)."""
        corners = np.array([[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)])
        # two triangles per side, corners indexed i * 4 + j * 2 + k
        quads = ((0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4),
                 (1, 5, 7, 3))
        tris = np.array([t for a, b, c, d in quads for t in ((a, b, c), (a, c, d))])
        verts, faces = [], []
        for n, (bmin, bmax) in enumerate([(self.room_min, self.room_max), *self.boxes]):
            verts.append(bmin + corners * (bmax - bmin))
            faces.append(tris + 8 * n)
        return np.concatenate(verts).astype(np.float32), np.concatenate(faces).astype(np.int32)

    @staticmethod
    def _ray_box_enter(origins, dirs, bmin, bmax):
        """Slab-method entry distance for rays vs a solid box; inf if miss."""
        with np.errstate(divide="ignore", invalid="ignore"):
            t1 = (bmin - origins) / dirs
            t2 = (bmax - origins) / dirs
        tmin = np.minimum(t1, t2).max(axis=-1)
        tmax = np.maximum(t1, t2).min(axis=-1)
        hit = (tmax >= tmin) & (tmax > 0) & (tmin > 1e-6)
        return np.where(hit, tmin, np.inf)

    @staticmethod
    def _ray_box_exit(origins, dirs, bmin, bmax):
        """Exit distance for rays starting inside a box (the room walls)."""
        with np.errstate(divide="ignore", invalid="ignore"):
            t1 = (bmin - origins) / dirs
            t2 = (bmax - origins) / dirs
        return np.maximum(t1, t2).min(axis=-1)

    def render(self, world_T_cam_44, K_44, height: int, width: int):
        """Render RGB (H, W, 3) in [0, 1] and z-depth (H, W) for a camera."""
        invK = np.linalg.inv(K_44)
        ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
        pix = np.stack(
            [xs + 0.5, ys + 0.5, np.ones_like(xs)], axis=-1
        ).reshape(-1, 3).astype(np.float64)
        rays_cam = pix @ invK[:3, :3].T  # unit-z camera rays
        R = world_T_cam_44[:3, :3]
        t = world_T_cam_44[:3, 3]
        dirs = rays_cam @ R.T
        origins = np.broadcast_to(t, dirs.shape)

        t_hit = self._ray_box_exit(origins, dirs, self.room_min, self.room_max)
        for bmin, bmax in self.boxes:
            t_box = self._ray_box_enter(origins, dirs, bmin, bmax)
            t_hit = np.minimum(t_hit, t_box)

        pts = origins + dirs * t_hit[:, None]
        rgb = self._texture(pts).reshape(height, width, 3)
        # rays have unit z in the camera frame, so the ray parameter IS the
        # z-depth (matches sensor depth-map semantics)
        return rgb, t_hit.reshape(height, width).astype(np.float32)


def synthetic_trajectory(num_frames: int, seed: int = 0):
    """A smooth orbit inside the room, camera looking at the room center."""
    rng = np.random.RandomState(seed + 123)
    poses = []
    for i in range(num_frames):
        ang = 2 * np.pi * i / max(num_frames, 1) * 0.75
        radius = 1.2 + 0.2 * np.sin(3 * ang)
        eye = np.array(
            [radius * np.cos(ang), radius * np.sin(ang), 1.4 + 0.2 * np.sin(2 * ang)]
        )
        target = np.array([0.35 * np.sin(ang * 2), 0.35 * np.cos(ang), 1.4])
        fwd = target - eye
        fwd = fwd / np.linalg.norm(fwd)
        up = np.array([0.0, 0.0, -1.0])
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        T = np.eye(4)
        T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = right, down, fwd, eye
        poses.append(T.astype(np.float32))
    return poses


class SyntheticDataset(GenericMVSDataset):
    """Tuple-compatible dataset over procedural scenes.

    scan ids are "synth{seed}"; tuples are sliding windows over an orbit
    trajectory (ref frame last 8 frames, DVMVS-style ordering applied by the
    base class).
    """

    def __init__(self, dataset_path="", split="test", mv_tuple_file_suffix=None,
                 num_frames: int = 40, num_scans: int = 1, tuple_size: int = 8,
                 scan_ids=None, **kwargs):
        kwargs.setdefault("tuple_info_file_location", None)
        super().__init__(dataset_path, split, None, **kwargs)
        self.num_frames = num_frames
        self.tuple_size = tuple_size
        self._scenes = {}
        self._poses = {}
        self._build_lock = threading.Lock()
        # frames are shared by up to tuple_size overlapping tuples: cache
        # renders so the host pipeline keeps up with the device
        self._render_cache = {}

        if scan_ids is None:
            scan_ids = [f"synth{s}" for s in range(num_scans)]
        self.frame_tuples = []
        for scan in scan_ids:
            for ref in range(tuple_size - 1, num_frames):
                ids = [str(ref)] + [str(ref - 1 - k) for k in range(tuple_size - 1)]
                self.frame_tuples.append(scan + " " + " ".join(ids))

        fx = 0.58 * self.image_width  # ~ScanNet-like FOV
        fy = 0.58 * self.image_width
        self.K_image = np.array(
            [
                [fx, 0, self.image_width / 2, 0],
                [0, fy, self.image_height / 2, 0],
                [0, 0, 1, 0],
                [0, 0, 0, 1],
            ],
            np.float32,
        )

    # ------------------------------------------------------------------ #

    @staticmethod
    def parse_scan_id(scan_id):
        """"synth{N}" or "synth{N}@{M}": scene seed N, trajectory seed M
        (rescans of the same scene use a different trajectory — the
        synthetic analogue of a 3RScan revisit)."""
        body = scan_id.replace("synth", "")
        if "@" in body:
            scene_seed, traj_seed = body.split("@")
            return int(scene_seed), int(traj_seed)
        return int(body), int(body)

    def scene(self, scan_id) -> SyntheticScene:
        # Loader worker threads race here: guard the build and only publish
        # _scenes[scan_id] AFTER _poses[scan_id] exists (a reader that sees
        # the scene assumes the poses are there too).
        if scan_id not in self._scenes:
            with self._build_lock:
                if scan_id not in self._scenes:
                    scene_seed, traj_seed = self.parse_scan_id(scan_id)
                    scene = SyntheticScene(seed=scene_seed)
                    self._poses[scan_id] = synthetic_trajectory(
                        self.num_frames, traj_seed
                    )
                    self._scenes[scan_id] = scene
        return self._scenes[scan_id]

    @staticmethod
    def revisit_source_scan(scan_id):
        """First-visit scan id + rescan->reference transform (identity for
        synthetic: both trajectories share the scene's world frame)."""
        scene_seed, _ = SyntheticDataset.parse_scan_id(scan_id)
        return f"synth{scene_seed}", np.eye(4, dtype=np.float32)

    def poses(self, scan_id):
        self.scene(scan_id)
        return self._poses[scan_id]

    def load_pose(self, scan_id, frame_id):
        world_T_cam = self.poses(scan_id)[int(frame_id)]
        return world_T_cam, np.linalg.inv(world_T_cam).astype(np.float32)

    def _render(self, scan_id, frame_id, height, width):
        key = (scan_id, int(frame_id), height, width)
        if key in self._render_cache:
            return self._render_cache[key]
        K = self.K_image.copy()
        K[0] *= width / self.image_width
        K[1] *= height / self.image_height
        pose = self.poses(scan_id)[int(frame_id)]
        out = self.scene(scan_id).render(pose, K, height, width)
        if len(self._render_cache) > 512:
            self._render_cache.clear()
        self._render_cache[key] = out
        return out

    def load_color(self, scan_id, frame_id):
        rgb, _ = self._render(scan_id, frame_id, self.image_height, self.image_width)
        return rgb

    def load_high_res_color(self, scan_id, frame_id):
        rgb, _ = self._render(scan_id, frame_id, 480, 640)
        return rgb

    def load_target_size_depth_and_mask(self, scan_id, frame_id):
        _, depth = self._render(scan_id, frame_id, self.depth_height, self.depth_width)
        depth = depth[..., None]
        mask_b = np.isfinite(depth) & (depth > 0)
        depth = np.where(mask_b, depth, np.nan).astype(np.float32)
        return depth, mask_b.astype(np.float32), mask_b

    def load_full_res_depth_and_mask(self, scan_id, frame_id):
        _, depth = self._render(scan_id, frame_id, 480, 640)
        depth = depth[..., None]
        mask_b = np.isfinite(depth) & (depth > 0)
        depth = np.where(mask_b, depth, np.nan).astype(np.float32)
        return depth, mask_b.astype(np.float32), mask_b

    def load_intrinsics(self, scan_id, frame_id=None, flip=False):
        K_depth = self.K_image.copy()
        K_depth[0] *= self.depth_width / self.image_width
        K_depth[1] *= self.depth_height / self.image_height
        K_full = self.K_image.copy()
        K_full[0] *= 640 / self.image_width
        K_full[1] *= 480 / self.image_height
        out = {}
        if flip:
            K_depth[0, 2] = self.depth_width - K_depth[0, 2]
            K_full[0, 2] = 640 - K_full[0, 2]
        if self.include_full_depth_K:
            out["K_full_depth_b44"] = K_full
            out["invK_full_depth_b44"] = np.linalg.inv(K_full).astype(np.float32)
        for i in range(5):
            Ks = K_depth.copy()
            Ks[:2] /= 2**i
            out[f"K_s{i}_b44"] = Ks
            out[f"invK_s{i}_b44"] = np.linalg.inv(Ks).astype(np.float32)
        return out

    def get_gt_mesh_bounds(self, scan_id):
        scene = self.scene(scan_id)
        return scene.room_min, scene.room_max

    def get_gt_mesh(self, scan_id):
        """(verts, faces) of the scan's scene surface (``SyntheticScene.gt_mesh``)."""
        return self.scene(scan_id).gt_mesh()
