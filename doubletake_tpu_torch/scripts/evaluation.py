"""The published-score evaluation (reference scripts/evaluation.py; the JAX
package's scripts/evaluation.py).

The incremental runner with the score settings forced: fusion at 0.02 m to
3.5 m with extended negative truncation, over the dataset's tuple file
(DVMVS ``default`` tuples for the published scores). Runs on CUDA unless
``--device cpu`` is passed.

    python -m doubletake_tpu_torch.scripts.evaluation --config_file \
        configs/models/doubletake_model.yaml --dataset scannet --dataset_path DATA \
        --split test --tuple_info_file_location TUPLES \
        --load_weights_from_checkpoint weights.ckpt --fast_cost_volume
"""

from __future__ import annotations

from doubletake_tpu_torch.options import OptionsHandler
from doubletake_tpu_torch.runners import incremental


def score_options(opts):
    """``opts`` with the published-score settings forced (reference
    README.md:305-340), in place; returns ``opts``."""
    opts.run_fusion = True
    opts.extended_neg_truncation = True
    opts.fusion_resolution = 0.02
    opts.fusion_max_depth = 3.5
    return opts


def main(argv=None):
    """Run the evaluation; returns ``incremental.run``'s result."""
    return incremental.run(score_options(OptionsHandler(argv).parse_and_merge_options()))


if __name__ == "__main__":
    main()
