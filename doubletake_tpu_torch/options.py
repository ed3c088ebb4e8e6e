"""Experiment flag system: Options dataclass + layered YAML/CLI merge.

Parity with reference src/doubletake/options.py: the same flag names (plus a
few port-specific ones at the bottom), the same layering — model YAML, then
data YAML, then CLI, last wins (:284-341) — and argparse auto-population
from the dataclass (:343-355). Differences by design: configs are plain
YAML mappings (no ``!!python/object`` tags); unknown YAML keys like
``model_type`` are kept in ``Options.extra`` instead of being monkey-patched
attributes. ``yaml`` is imported where a YAML file is read or written, so
hosts without it can build ``Options`` in code.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class Options:
    """Experiment flags. Grouped as in the reference."""

    random_seed: int = 0

    # logs
    name: str = "debug"
    log_dir: str = os.path.join(os.path.expanduser("~"), "tmp/tensorboard")
    notes: str = ""
    log_interval: int = 100
    image_log_interval: int = 1000
    val_interval: int = 1000
    val_batches: int = 100

    # data
    dataset: str = "scannet"
    dataset_path: str = "/datasets/scannetv2"
    num_workers: int = 12
    tuple_info_file_location: str = "data_splits/ScanNetv2/standard_split/"
    mv_tuple_file_suffix: str = "_eight_view_deepvmvs.txt"
    frame_tuple_type: str = "default"
    model_num_views: int = 8
    num_images_in_tuple: Optional[int] = None
    dataset_scan_split_file: str = (
        "data_splits/ScanNetv2/standard_split/scannetv2_train.txt"
    )
    split: str = "train"
    image_width: int = 512
    image_height: int = 384
    shuffle_tuple: bool = False
    test_keyframe_buffer_size: int = 30
    rotate_images: bool = False

    # hyperparameters
    lr: float = 1e-4
    wd: float = 1e-4
    num_sanity_val_steps: int = 0
    max_steps: int = 110000
    batch_size: int = 16
    val_batch_size: int = 16
    gpus: int = 2  # kept for config parity; maps to data-parallel devices
    precision: int = 16
    lr_steps: List[int] = field(default_factory=lambda: [70000, 80000])

    # models
    resume: Optional[str] = None
    load_weights_from_checkpoint: Optional[str] = None
    lazy_load_weights_from_checkpoint: Optional[str] = None
    image_encoder_name: str = "efficientnet"
    depth_decoder_name: str = "unet_pp"
    loss_type: str = "log_l1"
    matching_encoder_type: str = "resnet"
    matching_feature_dims: int = 16
    matching_scale: int = 1
    matching_num_depth_bins: int = 64
    min_matching_depth: float = 0.25
    max_matching_depth: float = 5.0
    cv_encoder_type: str = "multi_scale_encoder"
    feature_volume_type: str = "mlp_feature_volume"
    model_type: str = "depth_model"

    # inference
    output_base_path: str = "results"
    run_fusion: bool = False
    fuse_color: bool = False
    fusion_max_depth: float = 3.5
    fusion_resolution: float = 0.02
    depth_fuser: str = "ours"
    trim_tsdf_using_confience: bool = False
    extended_neg_truncation: bool = False
    single_debug_scan_id: Optional[str] = None
    skip_frames: Optional[int] = None
    skip_to_frame: Optional[int] = None
    mask_pred_depth: bool = False
    cache_depths: bool = False
    fusion_use_raw_lowest_cost: bool = False
    high_res_validation: bool = False
    fast_cost_volume: bool = False

    # visualization
    standard_fps: int = 30
    dump_depth_visualization: bool = False
    split_timing: bool = False  # incremental: sync after each stage, host-clock times
    viz_render_width: int = 640
    viz_render_height: int = 480
    cam_marker_size: float = 0.7
    back_face_alpha: float = 0.5
    viz_fixed_min_max: bool = False

    # depth hints
    fill_depth_hints: bool = False
    depth_hint_aug: float = 0.0
    depth_hint_dir: Optional[str] = None
    load_empty_hint: bool = False

    # ---- port-specific additions ----
    # torch device the runners build the model and volumes on; "cuda"
    # raises when no CUDA device is present (pass "cpu" explicitly)
    device: str = "cuda"
    # static plane chunk in the cost volume (memory/latency knob)
    plane_chunk: int = 16
    # number of devices for data-parallel training (0 = all visible)
    num_devices: int = 0
    # compute dtype for the network: "float32" or "bfloat16" (weights and
    # batch-norm statistics cast to bf16, K1 in its bf16 mode; every runner)
    compute_dtype: str = "float32"
    # hint raycast sample count; 0 = auto (minimal band-safe budget,
    # tools.tsdf.auto_raycast_samples)
    raycast_samples: int = 256
    # candidate-block mip march for the hint raycast; read by the
    # incremental runner only (the offline, revisit and no-hint runners run
    # as without it, as in the JAX package)
    raycast_mip: bool = False
    # write a profiler trace for train steps [20, 25) into this dir
    profile_dir: Optional[str] = None

    # any unrecognized config keys end up here
    extra: Dict[str, Any] = field(default_factory=dict)


class OptionsHandler:
    """Layered config loading: model YAML -> data YAML -> CLI, last wins."""

    def __init__(self, argv=None):
        self.parser = argparse.ArgumentParser(description="doubletake_tpu_torch options")
        self.parser.add_argument("--config_file", type=str, default=None)
        self.parser.add_argument("--data_config_file", type=str, default=None)
        self._populate_argparse()
        self.argv = argv

    def _populate_argparse(self):
        for f in dataclasses.fields(Options):
            if f.name == "extra":
                continue
            arg = f"--{f.name}"
            if f.type in ("bool", bool):
                self.parser.add_argument(arg, action="store_true", default=None)
            elif f.type in ("List[int]", List[int]):
                self.parser.add_argument(arg, type=int, nargs="*", default=None)
            else:
                base = {("int"): int, ("float"): float}.get(
                    str(f.type).replace("Optional[", "").replace("]", ""), str
                )
                self.parser.add_argument(arg, type=base, default=None)

    def parse_and_merge_options(self, ignore_cl_args: bool = False) -> Options:
        args = self.parser.parse_args([] if ignore_cl_args else self.argv)
        self.last_namespace = args  # scripts can read extra registered args
        opts = Options()

        for path_attr in ("config_file", "data_config_file"):
            path = getattr(args, path_attr)
            if path:
                self._merge_yaml(opts, path)

        known = {f.name for f in dataclasses.fields(Options)}
        for key, val in vars(args).items():
            if key in ("config_file", "data_config_file"):
                continue
            if val is not None and key in known:
                setattr(opts, key, val)
        return opts

    @staticmethod
    def _merge_yaml(opts: Options, path: str):
        import yaml

        with open(path) as f:
            raw = f.read()
        # tolerate reference-style "!!python/object:..." headers in configs
        raw = "\n".join(
            line for line in raw.splitlines() if not line.startswith("!!python/object")
        )
        data = yaml.safe_load(raw) or {}
        known = {f.name for f in dataclasses.fields(Options)}
        for key, val in data.items():
            if key in known:
                setattr(opts, key, val)
            else:
                opts.extra[key] = val

    @staticmethod
    def save_options_as_yaml(path: str, opts: Options):
        """Write the options as YAML; where ``yaml`` is not installed, as
        JSON (itself YAML)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        payload = dataclasses.asdict(opts)
        try:
            import yaml
        except ImportError:
            import json

            with open(path, "w") as f:
                json.dump(payload, f, indent=1)
            return
        with open(path, "w") as f:
            yaml.safe_dump(payload, f)

    @staticmethod
    def load_options_from_yaml(path: str) -> Options:
        opts = Options()
        OptionsHandler._merge_yaml(opts, path)
        return opts
