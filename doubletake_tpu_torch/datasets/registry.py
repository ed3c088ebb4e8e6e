"""Dataset registry (reference utils/dataset_utils.py:10-148 parity)."""

from __future__ import annotations

from doubletake_tpu_torch.datasets.scannet import ScannetDataset
from doubletake_tpu_torch.datasets.synthetic import SyntheticDataset


def get_dataset(dataset_name: str):
    """Returns the dataset class for a dataset name."""
    if dataset_name == "scannet":
        return ScannetDataset
    if dataset_name == "synthetic":
        return SyntheticDataset
    if dataset_name == "7scenes":
        from doubletake_tpu_torch.datasets.seven_scenes import SevenScenesDataset

        return SevenScenesDataset
    if dataset_name == "3rscan":
        from doubletake_tpu_torch.datasets.threer_scan import ThreeRScanDataset

        return ThreeRScanDataset
    if dataset_name == "vdr":
        from doubletake_tpu_torch.datasets.vdr import VDRDataset

        return VDRDataset
    if dataset_name == "colmap":
        from doubletake_tpu_torch.datasets.colmap import ColmapDataset

        return ColmapDataset
    if dataset_name in ("arkit", "scanniverse"):
        # the reference routes these names to ARKitDataset /
        # ScanniverseDataset (utils/dataset_utils.py:49-97) but never
        # shipped those classes
        raise NotImplementedError(
            f"'{dataset_name}' is a recognized dataset name, but its reader "
            "was not released in the reference (dataset_utils.py:49-97 "
            "references an undefined class); use 'vdr' for ARKit-style "
            "iPhone captures or 'colmap' for generic posed captures."
        )
    raise ValueError(f"Unknown dataset: {dataset_name}")


def dataset_from_opts(opts, split=None, limit_to_scan_id=None, **overrides):
    """Construct a dataset from an Options object."""
    cls = get_dataset(opts.dataset)
    kwargs = dict(
        dataset_path=opts.dataset_path,
        split=split or opts.split,
        mv_tuple_file_suffix=opts.mv_tuple_file_suffix,
        tuple_info_file_location=opts.tuple_info_file_location,
        limit_to_scan_id=limit_to_scan_id or opts.single_debug_scan_id,
        num_images_in_tuple=opts.num_images_in_tuple or opts.model_num_views,
        image_height=opts.image_height,
        image_width=opts.image_width,
        shuffle_tuple=opts.shuffle_tuple,
        fill_depth_hints=opts.fill_depth_hints,
        depth_hint_aug=opts.depth_hint_aug,
        depth_hint_dir=opts.depth_hint_dir,
        load_empty_hints=opts.load_empty_hint,
        rotate_images=opts.rotate_images,
        skip_frames=opts.skip_frames,
        skip_to_frame=opts.skip_to_frame,
    )
    kwargs.update(overrides)
    if cls is SyntheticDataset:
        kwargs.pop("mv_tuple_file_suffix", None)
        kwargs.pop("tuple_info_file_location", None)
        limit = kwargs.pop("limit_to_scan_id", None)
        if limit is not None:
            kwargs["scan_ids"] = [limit]
    return cls(**kwargs)


def get_scan_list(opts, split_file=None):
    """Reads the scan list file for scripts; synthetic yields synth scans."""
    if opts.dataset == "synthetic":
        return ["synth0"]
    from doubletake_tpu_torch.utils.io import readlines

    return readlines(split_file or opts.dataset_scan_split_file)
