"""DVMVS keyframe selection (host-side, numpy).

Counterpart of the JAX package's ``tools/keyframe_buffer.py`` (reference:
src/doubletake/tools/keyframe_buffer.py, itself derived from the public
DVMVS repo): pose-distance gated keyframes, a penalty ranking for
source-view selection, and online/simple/offline buffer variants. The same
numpy arithmetic as the JAX package's, ``np.argpartition`` ranking
included, so ties resolve alike and tuple files come out line for line
equal. Return codes match the reference:

  0 first frame accepted    1 keyframe accepted       2 rejected (too close)
  3 tracking lost, reset    4 still lost              5 pose missing, waiting
"""

from __future__ import annotations

from collections import deque

import numpy as np


class DVMVSConfig:
    """Constants (reference keyframe_buffer.py:12-22)."""

    train_minimum_pose_distance = 0.125
    train_maximum_pose_distance = 0.325
    train_crawl_step = 3
    test_keyframe_buffer_size = 30
    test_keyframe_pose_distance = 0.1
    test_optimal_t_measure = 0.15
    test_optimal_R_measure = 0.0


def pose_available(pose) -> bool:
    return bool(np.isfinite(pose).all())


def pose_distance(reference_pose, measurement_pose):
    """Combined DVMVS measure between two camera-to-world poses."""
    rel = np.linalg.inv(reference_pose) @ measurement_pose
    R, t = rel[:3, :3], rel[:3, 3]
    r_measure = np.sqrt(2 * (1 - min(3.0, np.trace(R)) / 3))
    t_measure = np.linalg.norm(t)
    return np.sqrt(t_measure**2 + r_measure**2), r_measure, t_measure


def is_valid_pair(reference_pose, measurement_pose, pose_dist_min, pose_dist_max,
                  t_norm_threshold=0.05, return_measure=False):
    combined, _, t_measure = pose_distance(reference_pose, measurement_pose)
    ok = pose_dist_min <= combined <= pose_dist_max and t_measure >= t_norm_threshold
    return (ok, combined) if return_measure else ok


def selection_penalty(t_score, r_score, optimal_t=0.15, optimal_r=0.0):
    """Quadratic penalty, 5x for too-close frames (keyframe_buffer.py:92-100)."""
    r_pen = abs(r_score - optimal_r) ** 2
    t_diff = t_score - optimal_t
    t_pen = (5.0 if t_diff < 0 else 1.0) * abs(t_diff) ** 2
    return r_pen + t_pen


class _BufferBase:
    def __init__(self, buffer_size, store_return_indices):
        self.buffer = deque([], maxlen=buffer_size)
        self._lost_counter = 0
        self._store_indices = store_return_indices

    def _entry(self, pose, image, index):
        if self._store_indices:
            if index is None:
                raise ValueError("index required when store_return_indices is set")
            return (pose, image, index)
        return (pose, image)

    def _handle_lost(self):
        self._lost_counter += 1
        if self._lost_counter > 30:
            if len(self.buffer) > 0:
                self.buffer.clear()
                return 3
            return 4
        return 5

    def _ranked_measurement_frames(self, frames, reference_pose, n_requested,
                                   optimal_t, optimal_r):
        n = min(n_requested, len(frames))
        if n <= 0:
            return []
        penalties = []
        for pose, *_ in frames:
            _, r_m, t_m = pose_distance(reference_pose, pose)
            penalties.append(selection_penalty(t_m, r_m, optimal_t, optimal_r))
        order = np.argpartition(penalties, n - 1)[:n]
        return [frames[i] for i in order]


class KeyframeBuffer(_BufferBase):
    """Online DVMVS buffer: accept a frame when it moved far enough from the
    last keyframe; rank past keyframes by penalty for source views."""

    def __init__(self, buffer_size=30, keyframe_pose_distance=0.1,
                 optimal_t_score=0.15, optimal_R_score=0.0,
                 store_return_indices=False):
        super().__init__(buffer_size, store_return_indices)
        self.keyframe_pose_distance = keyframe_pose_distance
        self.optimal_t_score = optimal_t_score
        self.optimal_R_score = optimal_R_score

    def try_new_keyframe(self, pose, image, dist_to_last_valid=None, index=None):
        if dist_to_last_valid is not None and dist_to_last_valid > 30:
            # gap in valid-frame indices implies a tracking gap: reset
            self.buffer.clear()
            self._lost_counter = 0
            self.buffer.append(self._entry(pose, image, index))
            return 3

        if not pose_available(pose):
            return self._handle_lost()

        self._lost_counter = 0
        if len(self.buffer) == 0:
            self.buffer.append(self._entry(pose, image, index))
            return 0
        last_pose = self.buffer[-1][0]
        combined, _, _ = pose_distance(pose, last_pose)
        if combined >= self.keyframe_pose_distance:
            self.buffer.append(self._entry(pose, image, index))
            return 1
        return 2

    def get_best_measurement_frames(self, n_requested):
        frames = list(self.buffer)
        reference_pose = frames[-1][0]
        return self._ranked_measurement_frames(
            frames[:-1], reference_pose, n_requested,
            self.optimal_t_score, self.optimal_R_score,
        )


class SimpleBuffer(_BufferBase):
    """Keeps the last N frames unconditionally (reference :195-251)."""

    def __init__(self, buffer_size, store_return_indices=False):
        super().__init__(buffer_size + 1, store_return_indices)

    def try_new_keyframe(self, pose, image, index=None):
        if not pose_available(pose):
            code = self._handle_lost()
            return {3: 2, 4: 3, 5: 4}[code]  # SimpleBuffer's compressed codes
        self._lost_counter = 0
        self.buffer.append(self._entry(pose, image, index))
        return 0 if len(self.buffer) == 1 else 1

    def get_measurement_frames(self):
        return list(self.buffer)[:-1]


class OfflineKeyframeBuffer(_BufferBase):
    """Bidirectional offline buffer: a frame must be far from *every* frame
    in the buffer; supports ranking for the first (0-index) frame using
    future frames (reference :254-395)."""

    def __init__(self, buffer_size=30, keyframe_pose_distance=0.1,
                 optimal_t_score=0.15, optimal_R_score=0.0,
                 store_return_indices=False):
        super().__init__(buffer_size, store_return_indices)
        self.keyframe_pose_distance = keyframe_pose_distance
        self.optimal_t_score = optimal_t_score
        self.optimal_R_score = optimal_R_score

    def try_new_keyframe(self, pose, image, index=None):
        if not pose_available(pose):
            return self._handle_lost()
        self._lost_counter = 0
        if len(self.buffer) == 0:
            self.buffer.append(self._entry(pose, image, index))
            return 0
        for buffer_pose, *_ in list(self.buffer):
            combined, _, _ = pose_distance(pose, buffer_pose)
            if combined < self.keyframe_pose_distance:
                return 2
        self.buffer.append(self._entry(pose, image, index))
        return 1

    def get_best_measurement_frames(self, n_requested):
        frames = list(self.buffer)
        reference_pose = frames[-1][0]
        return self._ranked_measurement_frames(
            frames[:-1], reference_pose, n_requested,
            self.optimal_t_score, self.optimal_R_score,
        )

    def get_best_measurement_frames_for_0index(self, n_requested):
        frames = list(self.buffer)[1:]
        if not frames:
            return []
        reference_pose = frames[0][0]
        # the reference ranks over ALL of frames (including the ref itself,
        # which scores maximal too-close penalty) and requests
        # min(n, len-1); replicate exactly
        n = min(n_requested, len(frames) - 1)
        if n <= 0:
            return []
        penalties = []
        for pose, *_ in frames:
            _, r_m, t_m = pose_distance(reference_pose, pose)
            penalties.append(
                selection_penalty(t_m, r_m, self.optimal_t_score, self.optimal_R_score)
            )
        order = np.argpartition(penalties, n - 1)[:n]
        return [frames[i] for i in order]
