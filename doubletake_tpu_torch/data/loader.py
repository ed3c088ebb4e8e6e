"""Threaded prefetching batch loader (host side).

Replaces the reference's torch DataLoader worker-process model
(train.py:79-183): a thread pool maps dataset.__getitem__, batches are
assembled as numpy NHWC dicts and renamed for the model's batched layout
(src keys get _bk* suffixes), with a bounded prefetch queue overlapping
host IO with device compute.

``shard=(rank, world)``: the data-parallel trainer's loader for one rank.
Every rank runs the same seeded order and renders only its block of rows,
``[rank * b / world, (rank + 1) * b / world)`` of every global batch of
``batch_size`` = b rows (the JAX step shards the global batch over its
mesh in such contiguous blocks), so the ranks together see exactly the
rows of the one-process loader.
"""

from __future__ import annotations

import queue
import re
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Tuple

import numpy as np

from doubletake_tpu_torch.utils.tracing import span

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
                        samples = list(pool.map(self.dataset.__getitem__, batch_idx))
                        if not put(collate(samples)):
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
