"""Write ``valid_frames.txt`` for every scan of a split (reference
precompute_valid_frames.py; the JAX package's
scripts/precompute_valid_frames.py).

Each line is ``<scan> <frame id> <frames since the last valid one>``, from
the dataset's ``get_valid_frame_ids`` (a frame is valid when its pose is
finite; ScanNet marks lost tracking with ``-inf`` poses). Host code only.

    python -m doubletake_tpu_torch.scripts.precompute_valid_frames \
        --dataset scannet --dataset_path DATA --split test \
        --dataset_scan_split_file SPLIT.txt
"""

from __future__ import annotations

import os

from doubletake_tpu_torch.datasets.registry import dataset_from_opts, get_scan_list
from doubletake_tpu_torch.options import OptionsHandler


def main(argv=None):
    """Write each scan's file; returns {scan: path} of the files written."""
    opts = OptionsHandler(argv).parse_and_merge_options()
    scans = get_scan_list(opts)
    ds = dataset_from_opts(opts, mv_tuple_file_suffix=None, tuple_info_file_location=None)
    paths = {}
    for scan in scans:
        valid = ds.get_valid_frame_ids(scan)
        path = os.path.join(ds.scan_path(scan), "valid_frames.txt")
        try:
            with open(path, "w") as f:
                f.write("\n".join(valid) + "\n")
            print(f"{scan}: {len(valid)} valid frames -> {path}")
            paths[scan] = path
        except OSError as e:
            print(f"{scan}: could not save valid_frames ({e})")
    return paths


if __name__ == "__main__":
    main()
