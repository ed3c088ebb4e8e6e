"""Generate DVMVS train tuple files (reference generate_train_tuples.py; the
JAX package's scripts/generate_train_tuples.py).

Each scan's valid frames go through
``tools.tuple_generation.generate_train_tuples``: the pair crawl for
2-frame tuples, the ten-pass long crawl otherwise. Writes
``{split}{suffix}`` into ``--tuple_info_file_location``. Host code only.

    python -m doubletake_tpu_torch.scripts.generate_train_tuples --dataset scannet \
        --dataset_path DATA --split train --dataset_scan_split_file SPLIT.txt \
        --tuple_info_file_location OUT [--num_images_in_tuple 2]
"""

from __future__ import annotations

import os

from doubletake_tpu_torch.datasets.registry import dataset_from_opts, get_scan_list
from doubletake_tpu_torch.options import OptionsHandler
from doubletake_tpu_torch.tools.tuple_generation import generate_train_tuples


def main(argv=None):
    """Write the split's tuple file; returns its path."""
    opts = OptionsHandler(argv).parse_and_merge_options()
    lines = []
    for scan in get_scan_list(opts):
        ds = dataset_from_opts(opts, mv_tuple_file_suffix=None, tuple_info_file_location=None)
        frame_ids = [line.split(" ")[1] for line in ds.get_valid_frame_ids(scan)]
        poses = [ds.load_pose(scan, fid)[0] for fid in frame_ids]
        lines.extend(generate_train_tuples(
            scan, poses, frame_ids, opts.num_images_in_tuple or opts.model_num_views))
        print(f"{scan}: {len(lines)} tuples so far")
    out_path = os.path.join(opts.tuple_info_file_location,
                            f"{opts.split}{opts.mv_tuple_file_suffix}")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {len(lines)} tuples to {out_path}")
    return out_path


if __name__ == "__main__":
    main()
