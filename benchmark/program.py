"""What the harness takes from the program under test (the PyTorch port,
``doubletake_tpu_torch``): its options, model, loader, runner steps and
stage clock. Only the harness imports this module; the reference never
does.

Frames reach the port as they would from a camera or a decoder: an
in-memory dataset on the port's own ``GenericMVSDataset`` (tuple assembly,
image normalisation, DVMVS ordering of the source views), batched on the
threads of the port's ``DataLoader``.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.frames import Scan, intrinsics_pyramid
from doubletake_tpu_torch.datasets.generic_mvs_dataset import GenericMVSDataset
from doubletake_tpu_torch.options import Options
from doubletake_tpu_torch.runners import common


def options(config: dict, traffic: dict, device: str) -> Options:
    """The port's Options for a configuration file and a traffic mix."""
    opts = Options()
    for key, value in config["options"].items():
        if not hasattr(opts, key):
            raise KeyError(f"configuration option {key!r} is not a field of the port's Options")
        setattr(opts, key, value)
    opts.batch_size = traffic["batch_size"]
    opts.device = device
    return opts


def build_model(opts: Options, state_dict: dict):
    """The port's model as its runners build it, with the given weights."""
    model = common.build_model(opts)
    model.load_state_dict(state_dict)
    return common.maybe_cast(opts, model).eval()


class ScanDataset(GenericMVSDataset):
    """One scan's tuples, served from host memory."""

    def __init__(self, scan: Scan, opts: Options, pass_frame_id: bool):
        super().__init__("", "test", None, image_height=opts.image_height,
                         image_width=opts.image_width, pass_frame_id=pass_frame_id)
        self.scan = scan
        self.frame_tuples = [" ".join([scan.scan_id] + [str(i) for i in t]) for t in scan.tuples]
        self.intrinsics = intrinsics_pyramid(scan.K_image, (self.image_height, self.image_width),
                                             (self.depth_height, self.depth_width))

    def load_pose(self, scan_id, frame_id):
        i = int(frame_id)
        return self.scan.world_T_cam[i], self.scan.cam_T_world[i]

    def load_color(self, scan_id, frame_id):
        return self.scan.images[int(frame_id)]

    def load_target_size_depth_and_mask(self, scan_id, frame_id):
        depth = self.scan.depths[int(frame_id)][..., None]
        mask = np.isfinite(depth) & (depth > 0)
        return np.where(mask, depth, np.nan).astype(np.float32), mask.astype(np.float32), mask

    def load_intrinsics(self, scan_id, frame_id=None, flip=False):
        return dict(self.intrinsics)

    def get_gt_mesh_bounds(self, scan_id):
        return self.scan.bounds


class SpanClock(common.StageClock):
    """The port's ``StageClock`` (CUDA events at the step's hint / model /
    fuse marks) that also opens a profiler range per stage, so that a
    traced run can say what the host was doing."""

    STAGES = {"start": "hint", "hint": "model", "model": "fuse"}

    def __init__(self, device):
        super().__init__(device)
        self.range = None

    def mark(self, name: str):
        if self.range is not None:
            self.range.__exit__(None, None, None)
            self.range = None
        super().mark(name)
        if name in self.STAGES:
            self.range = torch.profiler.record_function(self.STAGES[name])
            self.range.__enter__()
