"""The loader's staged batches (``data/loader.py``): each distinct frame of a
batch loaded once, raw, into one tensor, normalised and gathered by
``runners.common.device_batch``; held bit for bit to the batch that
``collate`` makes of ``__getitem__``'s tuples.

No JAX here: the card's test runs on the card with
``python -m pytest tests/test_torch_staging.py -m card --noconftest``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import itertools
import random
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from doubletake_tpu_torch.data.loader import DataLoader, collate, staged_images
from doubletake_tpu_torch.datasets.synthetic import SyntheticDataset
from doubletake_tpu_torch.runners import common
from doubletake_tpu_torch.utils import tracing
from doubletake_tpu_torch.utils.io import IMAGENET_MEAN, IMAGENET_STD, imagenet_normalize

STAGED = ("frames_fhw3", "frame_index_b", "frame_index_bk")
READER = Path(__file__).resolve().parents[1] / "benchmark" / "metrics" / "staged_frame_share.py"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: page-locked copies and the device's division")
    return torch.device("cuda")


def dataset(flip=False, pass_frame_id=False, height=24, width=32, num_frames=30):
    """A synthetic scan of ``num_frames`` frames, 8-frame tuples (23 of
    them at 30 frames); ``flip``: the training split with its 50% flips."""
    return SyntheticDataset(split="train" if flip else "test", disable_flip=not flip,
                            pass_frame_id=pass_frame_id, image_height=height,
                            image_width=width, num_frames=num_frames)


@contextlib.contextmanager
def joined_loaders():
    """Waits, on leaving, for the threads started inside (a loader's
    producer and its pool): a producer still running draws flips from
    ``random`` and bumps the counters."""
    before = set(threading.enumerate())
    try:
        yield
    finally:
        for thread in set(threading.enumerate()) - before:
            thread.join(timeout=30)
            assert not thread.is_alive(), thread


def take(loader, n):
    """The first ``n`` batches of ``loader``; the iterator closed after."""
    it = iter(loader)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


def counted(fn):
    """(fn(), each counter's increase while it ran)."""
    before = tracing.counters()
    out = fn()
    return out, {k: v - before.get(k, 0) for k, v in tracing.counters().items()}


def assert_same_batch(got, want):
    """A staged loader batch against ``collate``'s of the same tuples: the
    device tensors of ``device_batch`` bit for bit, and every other key."""
    for g, w in zip(common.device_batch(*got, "cpu"), common.device_batch(*want, "cpu")):
        assert list(g) == list(w)
        for key in g:
            assert torch.equal(g[key], w[key]), key
    for g, w in zip(got, want):
        assert sorted(k for k in g if k not in STAGED) == sorted(
            k for k in w if not k.startswith("image_"))
        for key, value in w.items():
            if key.startswith("image_"):
                continue
            if isinstance(value, list):
                assert g[key] == value, key
            else:
                assert g[key].dtype == value.dtype, key
                np.testing.assert_array_equal(g[key], value, err_msg=key)


CASES = [(b, shard, shuffle, flip, infinite, pass_frame_id)
         for (b, shard), shuffle, flip, infinite, pass_frame_id in itertools.product(
             [(1, (0, 1)), (16, (0, 1)), (16, (1, 2))], *[(False, True)] * 4)]


@pytest.mark.parametrize("b,shard,shuffle,flip,infinite,pass_frame_id", CASES)
def test_staged_batch_equals_collate(b, shard, shuffle, flip, infinite, pass_frame_id):
    """Each batch of the loader, through ``device_batch``, equals
    ``device_batch(*collate([ds[i], ...]))`` of the same tuples bit for bit,
    its other keys equal too, at b=1 and at b=16 over consecutive 8-frame
    tuples (the benchmark's overlap), shuffled or not, with the training
    split's flips, for a shard of the rows, over an epoch's end, with frame
    ids; the counters reference 8 images a row and stage each distinct
    frame once."""
    ds = dataset(flip=flip, pass_frame_id=pass_frame_id)
    kw = dict(shuffle=shuffle, num_workers=1 if flip else 3, drop_last=shard[1] > 1, seed=5,
              infinite=infinite, shard=shard)
    loader = DataLoader(ds, b, **kw)
    n = len(loader) + 2 if infinite else len(loader)
    order = [idx for epoch in range(2) for idx in loader._index_batches(epoch)][:n]
    random.seed(11)                                 # the flips, drawn a tuple at a time
    want = [collate([ds[i] for i in idx]) for idx in order]
    random.seed(11)
    with joined_loaders():
        got, counts = counted(lambda: take(loader, n))
    assert len(got) == n
    for g, w, idx in zip(got, want, order):
        assert_same_batch(g, w)
        staged, referenced = len(g[0]["frames_fhw3"]), len(g[0]["frame_index_b"]) + g[1][
            "frame_index_bk"].size
        ids = {f for i in idx for f in ds.frame_tuples[i].split(" ")[1:]}
        assert referenced == 8 * len(idx)
        assert staged == len(ids) or flip and len(ids) < staged <= referenced
    if not infinite:                # else the producer may have staged batches past the n
        assert counts == {"data.frames_staged": sum(len(g[0]["frames_fhw3"]) for g in got),
                          "data.frames_referenced": 8 * sum(map(len, order))}


@pytest.mark.parametrize("b,staged,referenced", [(16, 23, 128), (1, 8, 8)])
def test_staged_counters(b, staged, referenced, monkeypatch):
    """16 consecutive 8-frame tuples stage 23 frames and reference 128; one
    tuple stages its 8. The benchmark's ``staged_frame_share`` reads
    100 * staged / referenced over the process, and nothing where the
    counters are absent."""
    ds = dataset(num_frames=b + 7)      # b tuples: one batch, so no batch staged ahead

    def first_batch():
        with joined_loaders():
            return take(DataLoader(ds, b, num_workers=2), 1)

    [(cur, src)], counts = counted(first_batch)
    assert counts == {"data.frames_staged": staged, "data.frames_referenced": referenced}
    assert cur["frames_fhw3"].shape == (staged, 24, 32, 3)
    assert cur["frame_index_b"].shape == (b,) and src["frame_index_bk"].shape == (b, 7)
    spec = importlib.util.spec_from_file_location("staged_frame_share", READER)
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    c = tracing.counters()
    assert reader.read(None) == 100.0 * c["data.frames_staged"] / c["data.frames_referenced"]
    monkeypatch.setattr(tracing, "counters", dict)
    assert reader.read(None) is None


@pytest.mark.parametrize("gather", [False, True])
def test_normalisation_on_torch_is_imagenet_normalize(gather):
    """``staged_images`` normalises as ``imagenet_normalize`` does, bit for
    bit, over 1.2e6 values in [0, 1] with 0 and 1 among them, through the
    views of one tuple and through the gather; a product with the
    reciprocal of the std (what a division by a Python scalar becomes)
    differs from the division somewhere in the same draw."""
    rng = np.random.RandomState(0)
    x = rng.rand(8, 250, 200, 3).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[0, 0, 1] = 1.0
    want = imagenet_normalize(x)
    frames = torch.from_numpy(x.copy())
    index_b, index_bk = np.array([0]), np.arange(1, 8)[None]
    if gather:
        index_b, index_bk = np.array([7, 0]), np.array([[6, 5, 4, 3, 2, 1, 0], list(range(7))])
    image, images = staged_images(frames, index_b, index_bk, torch.device("cpu"))
    assert torch.equal(frames, torch.from_numpy(x))                 # the batch is left as it was
    got = torch.cat([image[:, None], images], 1).numpy()
    assert np.array_equal(got.view(np.uint32),
                          want[np.append(index_b[:, None], index_bk, 1)].view(np.uint32))
    mean, std = torch.from_numpy(IMAGENET_MEAN), torch.from_numpy(IMAGENET_STD)
    by_reciprocal = ((frames - mean) * (1.0 / std)).numpy()
    assert not np.array_equal(by_reciprocal.view(np.uint32), want.view(np.uint32))


@pytest.mark.card
def test_pinned_staging_on_the_card(cuda):
    """On the card: the staged batch's frames are page-locked; its device
    images equal the host path's (``collate``'s batch through
    ``device_batch``) bit for bit at b=1 and b=16; and a consumer that
    holds batch n while its copy still waits on the stream, and lets the
    loader run prefetch + 2 batches ahead, finds batch n's device images
    unchanged: the staged block is not handed out again while the copy
    reads it."""
    ds = dataset(height=192, width=256, num_frames=60)
    for b in (1, 16):
        with joined_loaders():
            it = iter(DataLoader(ds, b, num_workers=3))
            for bi in range(2):
                batch = next(it)
                assert batch[0]["frames_fhw3"].is_pinned()
                want = common.device_batch(*collate([ds[i] for i in range(bi * b, bi * b + b)]),
                                           cuda)
                got = common.device_batch(*batch, cuda)
                for g, w in zip(got, want):
                    for key in w:
                        assert torch.equal(g[key], w[key]), (b, bi, key)
            it.close()

    ds = dataset(height=192, width=256, num_frames=100)     # 93 tuples: 5 batches of 16
    prefetch = 2
    want = common.device_batch(*collate([ds[i] for i in range(16)]), cuda)
    torch.cuda.synchronize()
    with joined_loaders():
        it = iter(DataLoader(ds, 16, num_workers=3, prefetch=prefetch))
        batch = next(it)
        torch.cuda._sleep(2_000_000_000)            # the stream busy for about a second
        held = common.device_batch(*batch, cuda)    # its copy queued behind the sleep
        del batch
        for _ in range(prefetch + 2):
            next(it)                                # new staged blocks, filled while it waits
        it.close()
    torch.cuda.synchronize()
    for h, w in zip(held, want):
        for key in w:
            assert torch.equal(h[key], w[key]), key
