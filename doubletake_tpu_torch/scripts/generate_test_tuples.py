"""Generate DVMVS test tuple files (reference scripts/data_scripts/
generate_test_tuples.py; the JAX package's scripts/generate_test_tuples.py).

Each scan's valid frames (``get_valid_frame_ids``) and their poses go
through ``tools.tuple_generation.generate_test_tuples`` of
``--frame_tuple_type`` (default / offline / dense / dense_offline), one
scan after another in the split's order, as in the JAX script (which takes
``--num_workers`` and starts no pool). Writes
``{split}{suffix}`` into ``--tuple_info_file_location``, with
``_<type>`` before ``.txt`` for every type but ``default``. Host code only.

    python -m doubletake_tpu_torch.scripts.generate_test_tuples --dataset scannet \
        --dataset_path DATA --split test --dataset_scan_split_file SPLIT.txt \
        --tuple_info_file_location OUT --frame_tuple_type default
"""

from __future__ import annotations

import os

from doubletake_tpu_torch.datasets.registry import dataset_from_opts, get_scan_list
from doubletake_tpu_torch.options import OptionsHandler
from doubletake_tpu_torch.tools.tuple_generation import generate_test_tuples


def process_scan(opts, scan):
    """The tuple lines of one scan."""
    ds = dataset_from_opts(opts, mv_tuple_file_suffix=None, tuple_info_file_location=None)
    frame_ids, dists, poses = [], [], []
    for line in ds.get_valid_frame_ids(scan):
        parts = line.split(" ")
        frame_ids.append(parts[1])
        dists.append(int(parts[2]) if len(parts) > 2 else None)
        poses.append(ds.load_pose(scan, parts[1])[0])
    return generate_test_tuples(
        scan, poses, frame_ids, opts.frame_tuple_type,
        opts.num_images_in_tuple or opts.model_num_views,
        dists_to_last_valid=dists,
    )


def main(argv=None):
    """Write the split's tuple file; returns its path."""
    opts = OptionsHandler(argv).parse_and_merge_options()
    lines = []
    for scan in get_scan_list(opts):
        lines.extend(process_scan(opts, scan))
        print(f"{scan}: {len(lines)} tuples so far")
    suffix = opts.mv_tuple_file_suffix
    if opts.frame_tuple_type != "default":
        suffix = suffix.replace(".txt", f"_{opts.frame_tuple_type}.txt")
    out_path = os.path.join(opts.tuple_info_file_location, f"{opts.split}{suffix}")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {len(lines)} tuples to {out_path}")
    return out_path


if __name__ == "__main__":
    main()
