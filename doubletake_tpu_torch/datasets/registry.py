"""Dataset registry (reference utils/dataset_utils.py:10-148 parity).

The port reads the synthetic scenes and ScanNet so far; the other readers
of the JAX package come with later slices.
"""

from __future__ import annotations

from doubletake_tpu_torch.datasets.scannet import ScannetDataset
from doubletake_tpu_torch.datasets.synthetic import SyntheticDataset


def get_dataset(dataset_name: str):
    """Returns the dataset class for a dataset name."""
    if dataset_name == "scannet":
        return ScannetDataset
    if dataset_name == "synthetic":
        return SyntheticDataset
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
