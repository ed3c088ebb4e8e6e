"""Threaded prefetching batch loader (host side).

Replaces the reference's torch DataLoader worker-process model
(train.py:79-183): a thread pool assembles each batch as numpy NHWC dicts
renamed for the model's batched layout (src keys get _bk* suffixes), with
a bounded prefetch queue overlapping host IO with device compute.

A batch carries its images staged: the tuples' frames overlap (a frame
sits in up to 8 consecutive tuples), so each distinct frame of the batch
is loaded once, raw (float32 in [0, 1], not normalised), into its row of
one ``frames_fhw3`` tensor, page-locked where CUDA is available, and
``frame_index_b`` (cur) / ``frame_index_bk`` (src) say which row each
tuple's reference and sources are. ``staged_images`` (through
``runners.common.device_batch``) copies the rows once, normalises them on
the device and gathers the images. Every other key is stacked as
``collate`` stacks it. The counters ``data.frames_staged`` and
``data.frames_referenced`` (``utils.tracing``) count the rows staged and
the images the tuples reference.

``shard=(rank, world)``: the data-parallel trainer's loader for one rank.
Every rank runs the same seeded order and renders only its block of rows,
``[rank * b / world, (rank + 1) * b / world)`` of every global batch of
``batch_size`` = b rows (the JAX step shards the global batch over its
mesh in such contiguous blocks), so the ranks together see exactly the
rows of the one-process loader.
"""

from __future__ import annotations

import functools
import queue
import re
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Tuple

import numpy as np
import torch

from doubletake_tpu_torch.utils.io import IMAGENET_MEAN, IMAGENET_STD
from doubletake_tpu_torch.utils.tracing import count, span

_SRC_RENAME = re.compile(r"_b(hw3|hw1|44|hw)$")


def _src_key(name: str) -> str:
    return _SRC_RENAME.sub(lambda m: "_bk" + m.group(1), name)


def collate(samples):
    """[(cur_dict, src_dict)] -> batched (cur_data, src_data)."""
    cur_list = [s[0] for s in samples]
    src_list = [s[1] for s in samples]
    cur = {}
    for k in cur_list[0]:
        if "frame_id_string" in k:
            cur[k] = [c[k] for c in cur_list]
        else:
            cur[k] = np.stack([c[k] for c in cur_list], 0)
    src = {}
    for k in src_list[0]:
        if "frame_id_string" in k:
            src[_src_key(k)] = [s[k] for s in src_list]
        else:
            src[_src_key(k)] = np.stack([s[k] for s in src_list], 0)
    return cur, src


def stage(dataset, pool, batch_idx):
    """The staged batch of tuples ``batch_idx`` of ``dataset`` (module doc):
    the tuples' non-image arrays on ``pool``'s threads, then each distinct
    frame's raw image, in order of first use, into its row."""
    tuples = list(pool.map(dataset.tuple_data, batch_idx))
    keys = list(dict.fromkeys(key for _, _, frame_keys in tuples for key in frame_keys))
    row = {key: i for i, key in enumerate(keys)}
    index = np.array([[row[key] for key in frame_keys] for _, _, frame_keys in tuples])
    frames = torch.empty((len(keys), dataset.image_height, dataset.image_width, 3),
                         dtype=torch.float32, pin_memory=torch.cuda.is_available())
    rows = frames.numpy()

    def load(i):
        rows[i] = dataset.frame_image(keys[i])

    list(pool.map(load, range(len(keys))))
    cur, src = collate([(c, s) for c, s, _ in tuples])
    cur["frames_fhw3"], cur["frame_index_b"] = frames, index[:, 0]
    src["frame_index_bk"] = index[:, 1:]
    count("data.frames_staged", len(keys))
    count("data.frames_referenced", index.size)
    return cur, src


@functools.lru_cache(maxsize=None)
def imagenet_stats(pinned: bool) -> torch.Tensor:
    """The ImageNet mean and std, (2, 3) float32 on the host, page-locked
    where ``pinned``: kept, so that no batch pins them again, and copied to
    the device by each batch (kept there, they would add a block to the
    device's peak memory)."""
    stats = torch.from_numpy(np.stack([IMAGENET_MEAN, IMAGENET_STD]))
    return stats.pin_memory() if pinned else stats


def to_device(array, device: torch.device) -> torch.Tensor:
    """``array`` on ``device`` without blocking the host: a host array
    bound for CUDA goes through page-locked memory (a pageable copy would
    synchronise)."""
    t = torch.as_tensor(array)
    if t.device.type == "cpu" and device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def staged_images(frames_fhw3: torch.Tensor, index_b, index_bk, device: torch.device):
    """(image_bhw3, image_bkhw3) on ``device`` from a staged batch: the raw
    frames copied once, normalised there as ``utils.io.imagenet_normalize``
    normalises (bit for bit: the mean and the std are float32 tensors; a
    division by a Python scalar would become a product with its
    reciprocal), and gathered by the index arrays; where the indices are
    0..F-1 in the row order of one tuple, views of the frames."""
    frames = frames_fhw3.to(device, non_blocking=True, copy=True)
    mean, std = imagenet_stats(device.type == "cuda").to(device, non_blocking=True)
    frames.sub_(mean).div_(std)
    b, k = index_bk.shape
    if b == 1 and np.array_equal(np.append(index_b, index_bk), np.arange(len(frames))):
        return frames[:1], frames[1:][None]
    image = frames.index_select(0, to_device(index_b, device))
    images = frames.index_select(0, to_device(index_bk.reshape(-1), device))
    return image, images.view(b, k, *frames.shape[1:])


class DataLoader:
    """Minimal map-style loader: shuffle, batch, threaded prefetch."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        num_workers: int = 4,
        prefetch: int = 2,
        drop_last: bool = False,
        seed: int = 0,
        infinite: bool = False,
        shard: Tuple[int, int] = (0, 1),
    ):
        rank, world = shard
        if batch_size % world or not 0 <= rank < world or (world > 1 and not drop_last):
            raise ValueError(f"shard {shard}: needs drop_last and a batch of {batch_size} "
                             "that divides into world equal blocks")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.seed = seed
        self.infinite = infinite
        self.shard = shard

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self, epoch: int):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.RandomState(self.seed + epoch)
            rng.shuffle(idx)
        end = len(idx) - (len(idx) % self.batch_size) if self.drop_last else len(idx)
        rank, world = self.shard
        block = self.batch_size // world
        for s in range(0, end, self.batch_size):
            yield idx[s: s + self.batch_size][rank * block: (rank + 1) * block]

    @staticmethod
    def _wait(q: queue.Queue, thread: threading.Thread):
        """The consumer's wait for the next item, retries included."""
        while True:
            try:
                return q.get(timeout=1.0)
            except queue.Empty:
                if thread.is_alive():
                    continue
                try:  # race: producer may put its last item, then exit
                    return q.get_nowait()
                except queue.Empty:
                    raise RuntimeError(
                        "DataLoader producer died (exception in a "
                        "dataset __getitem__ worker?)"
                    ) from None

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            """Blocking put that aborts when the consumer is gone — a plain
            q.put would block forever on a full queue after the consumer
            abandons the iterator (early `break`), leaking this thread AND
            its ThreadPoolExecutor workers for the life of the process."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            epoch = 0
            with ThreadPoolExecutor(self.num_workers) as pool:
                while not stop.is_set():
                    for batch_idx in self._index_batches(epoch):
                        if stop.is_set():
                            return
                        if not put(stage(self.dataset, pool, batch_idx)):
                            return
                    if not self.infinite:
                        put(None)
                        return
                    epoch += 1

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                with span("data.loader_wait"):
                    item = self._wait(q, thread)
                if item is None:
                    return
                yield item
        finally:
            stop.set()
