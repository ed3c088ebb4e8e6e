"""DVMVS frame-tuple generation (host-side, numpy).

Counterpart of the JAX package's ``tools/tuple_generation.py`` (reference
scripts/data_scripts/generate_test_tuples.py and generate_train_tuples.py),
line for line equal in its output: the four test tuple
taxonomies (default / offline / dense / dense_offline — README.md:249-296)
built on the keyframe buffers, and the train-tuple crawl (pair gathering at
pose distance [0.125, 0.325] with loosening, plus the multi-pass long-tuple
crawl with usage thresholds and crawl step 3).

The ``default`` and ``dense`` types emit tuples of fewer than
``num_images_in_tuple`` frames at the start of a scan and after a buffer
reset, as the JAX package's generator does; a model built for 8 views
refuses such a line at its feature volume.
"""

from __future__ import annotations

from typing import List, Optional

from doubletake_tpu_torch.tools.keyframe_buffer import (
    DVMVSConfig,
    KeyframeBuffer,
    OfflineKeyframeBuffer,
    is_valid_pair,
)


def _new_online_buffer(store_indices=True, buffer_size=None):
    return KeyframeBuffer(
        buffer_size=buffer_size or DVMVSConfig.test_keyframe_buffer_size,
        keyframe_pose_distance=DVMVSConfig.test_keyframe_pose_distance,
        optimal_t_score=DVMVSConfig.test_optimal_t_measure,
        optimal_R_score=DVMVSConfig.test_optimal_R_measure,
        store_return_indices=store_indices,
    )


def _new_offline_buffer(buffer_size):
    return OfflineKeyframeBuffer(
        buffer_size=buffer_size,
        keyframe_pose_distance=DVMVSConfig.test_keyframe_pose_distance,
        optimal_t_score=DVMVSConfig.test_optimal_t_measure,
        optimal_R_score=DVMVSConfig.test_optimal_R_measure,
        store_return_indices=True,
    )


def _offline_tuple_indices(poses, n_measurement_frames, ref_index, buffer_size):
    """Bidirectional source selection around ref_index (compute_offline_tuple
    parity: alternate forward/backward filling an offline buffer)."""
    buf = _new_offline_buffer(buffer_size)
    buf.try_new_keyframe(poses[ref_index].copy(), None, index=ref_index)

    back = ref_index - 1
    fwd = ref_index + 1
    direction = True
    added = 0
    exhausted_f = exhausted_b = False
    while not (exhausted_f and exhausted_b):
        if direction:
            direction = False
            if fwd >= len(poses):
                exhausted_f = True
                continue
            idx = fwd
            fwd += 1
        else:
            direction = True
            if back < 0:
                exhausted_b = True
                continue
            idx = back
            back -= 1
        if buf.try_new_keyframe(poses[idx].copy(), None, index=idx) == 1:
            added += 1
        if added >= buffer_size:
            break

    frames = buf.get_best_measurement_frames_for_0index(n_measurement_frames)
    return [ref_index] + [idx for _, _, idx in frames]


def default_dvmvs_tuples(scan, poses, dists_to_last_valid, n_measurement_frames):
    """Online keyframe tuples: emit one tuple per accepted keyframe."""
    buf = _new_online_buffer()
    samples = []
    for i, pose in enumerate(poses):
        response = buf.try_new_keyframe(
            pose.copy(), None, dists_to_last_valid[i], index=i
        )
        if response == 1:
            frames = buf.get_best_measurement_frames(n_measurement_frames)
            samples.append({"scan": scan, "indices": [i] + [x for _, _, x in frames]})
    return samples


def offline_dvmvs_tuples(scan, poses, n_measurement_frames):
    """Offline tuples at online-selected keyframes, sources from both
    directions (buffer size 2x)."""
    buf = _new_online_buffer()
    samples = []
    for i, pose in enumerate(poses):
        if buf.try_new_keyframe(pose.copy(), None, index=i) != 1:
            continue
        indices = _offline_tuple_indices(
            poses, n_measurement_frames, i,
            DVMVSConfig.test_keyframe_buffer_size * 2,
        )
        if len(indices) > 1:
            samples.append({"scan": scan, "indices": indices})
    return samples


def dense_dvmvs_tuples(scan, poses, n_measurement_frames):
    """A tuple for EVERY frame: past frames only (online), offline-ranked."""
    samples = []
    for i in range(len(poses)):
        buf = _new_offline_buffer(DVMVSConfig.test_keyframe_buffer_size)
        buf.try_new_keyframe(poses[i].copy(), None, index=i)
        added = 0
        for j in range(i - 1, -1, -1):
            if buf.try_new_keyframe(poses[j].copy(), None, index=j) == 1:
                added += 1
            if added >= DVMVSConfig.test_keyframe_buffer_size:
                break
        frames = buf.get_best_measurement_frames_for_0index(n_measurement_frames)
        indices = [i] + [idx for _, _, idx in frames]
        if len(indices) > 1:
            samples.append({"scan": scan, "indices": indices})
    return samples


def dense_offline_dvmvs_tuples(scan, poses, n_measurement_frames):
    """A tuple for EVERY frame using both past and future."""
    samples = []
    for i in range(len(poses)):
        indices = _offline_tuple_indices(
            poses, n_measurement_frames, i,
            DVMVSConfig.test_keyframe_buffer_size * 2,
        )
        if len(indices) > 1:
            samples.append({"scan": scan, "indices": indices})
    return samples


def generate_test_tuples(scan, poses, frame_ids, frame_tuple_type: str,
                         num_images_in_tuple: int,
                         dists_to_last_valid: Optional[List] = None):
    """Tuple lines 'scan id0 id1 ...' for a scan, given valid-frame poses."""
    n_src = num_images_in_tuple - 1
    if dists_to_last_valid is None:
        dists_to_last_valid = [None] * len(poses)
    if frame_tuple_type == "default":
        samples = default_dvmvs_tuples(scan, poses, dists_to_last_valid, n_src)
    elif frame_tuple_type == "offline":
        samples = offline_dvmvs_tuples(scan, poses, n_src)
    elif frame_tuple_type == "dense":
        samples = dense_dvmvs_tuples(scan, poses, n_src)
    elif frame_tuple_type == "dense_offline":
        samples = dense_offline_dvmvs_tuples(scan, poses, n_src)
    else:
        raise ValueError(f"unknown frame_tuple_type {frame_tuple_type}")

    return [
        " ".join([scan] + [str(frame_ids[idx]) for idx in s["indices"]])
        for s in samples
    ]


# --------------------------------------------------------------------- #
# train tuples                                                          #
# --------------------------------------------------------------------- #


def gather_pairs_train(poses, used_pairs, is_backward,
                       initial_pose_dist_min, initial_pose_dist_max):
    """Two-frame pair crawl with distance-band loosening (reference
    generate_train_tuples.py:54-135 behavior)."""
    n = len(poses)
    pose_dist_min = initial_pose_dist_min
    pose_dist_max = initial_pose_dist_max
    used_measurement_indices = set()
    pairs = []

    if is_backward:
        i, step, first_limit, second_limit = n - 1, -1, 5, n - 5
    else:
        i, step, first_limit, second_limit = 0, 1, n - 5, 5

    check_future = False
    loosening_counter = 0
    while 0 <= i < n:
        pair = (i, -1)
        rng = (
            range(i + step, first_limit, step)
            if check_future
            else range(i - step, second_limit, -step)
        )
        for j in rng:
            if j in used_measurement_indices or (i, j) in used_pairs:
                continue
            if is_valid_pair(poses[i], poses[j], pose_dist_min, pose_dist_max):
                pair = (i, j)
                pairs.append(pair)
                used_pairs.add(pair)
                used_pairs.add((j, i))
                used_measurement_indices.add(j)
                pose_dist_min = initial_pose_dist_min
                pose_dist_max = initial_pose_dist_max
                i += step
                check_future = False
                loosening_counter = 0
                break
        if pair[1] == -1:
            if check_future:
                pose_dist_min = pose_dist_min / 1.1
                pose_dist_max = pose_dist_max * 1.1
                check_future = False
                loosening_counter += 1
                if loosening_counter > 1:
                    i += step
                    loosening_counter = 0
            else:
                check_future = True
        else:
            check_future = False
    return pairs


_LONG_CRAWL_PASSES = [
    (0, 1.0, False), (1, 0.666, True), (2, 1.5, False), (3, 0.8, True),
    (4, 1.25, False), (5, 1.0, True), (6, 0.666, False), (7, 1.5, True),
    (8, 0.8, False), (9, 1.25, True),
]


def gather_long_tuples_train(poses, subsequence_length: int,
                             crawl_step: int = DVMVSConfig.train_crawl_step,
                             usage_threshold: int = 1):
    """Multi-pass chained-pair crawl building N-frame train tuples
    (crawl_subprocess_long parity)."""
    n = len(poses)
    used_pairs = set()
    used_nodes = {i: 0 for i in range(n)}
    samples = []
    for offset, multiplier, is_backward in _LONG_CRAWL_PASSES:
        offset = offset % crawl_step
        if is_backward:
            start, step, limit = n - 1 - offset, -crawl_step, subsequence_length
        else:
            start, step, limit = offset, crawl_step, n - subsequence_length + 1
        for i in range(start, limit, step):
            if used_nodes[i] > usage_threshold:
                continue
            indices = [i]
            prev = i
            valid_counter = 1
            any_counter = 1
            reached_limit = False
            while valid_counter < subsequence_length:
                j = i - any_counter if is_backward else i + any_counter
                reached_limit = j < 0 or j >= n
                if reached_limit:
                    break
                ok = (
                    used_nodes[j] <= usage_threshold
                    and (prev, j) not in used_pairs
                    and is_valid_pair(
                        poses[prev], poses[j],
                        multiplier * DVMVSConfig.train_minimum_pose_distance,
                        multiplier * DVMVSConfig.train_maximum_pose_distance,
                        t_norm_threshold=(
                            multiplier * DVMVSConfig.train_minimum_pose_distance * 0.5
                        ),
                    )
                )
                if ok:
                    indices.append(j)
                    prev = j
                    valid_counter += 1
                any_counter += 1
            if not reached_limit and len(indices) == subsequence_length:
                prev_node = indices[0]
                used_nodes[prev_node] += 1
                for node in indices[1:]:
                    used_nodes[node] += 1
                    used_pairs.add((prev_node, node))
                    used_pairs.add((node, prev_node))
                    prev_node = node
                samples.append(indices)
    return samples


def generate_train_tuples(scan, poses, frame_ids, num_images_in_tuple: int):
    """Tuple lines for training: pairs when tuple size is 2, long crawl
    otherwise."""
    if num_images_in_tuple == 2:
        used_pairs = set()
        samples = []
        for multiplier, is_backward in [(1.0, False), (0.666, True), (1.5, False)]:
            pairs = gather_pairs_train(
                poses, used_pairs, is_backward,
                multiplier * DVMVSConfig.train_minimum_pose_distance,
                multiplier * DVMVSConfig.train_maximum_pose_distance,
            )
            samples.extend([list(p) for p in pairs])
    else:
        samples = gather_long_tuples_train(poses, num_images_in_tuple)
    return [
        " ".join([scan] + [str(frame_ids[idx]) for idx in indices])
        for indices in samples
    ]
