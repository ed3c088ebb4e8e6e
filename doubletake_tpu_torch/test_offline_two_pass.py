"""CLI: offline two-pass evaluation (reference test_offline_two_pass.py).

    python -m doubletake_tpu_torch.test_offline_two_pass --config_file \
        configs/models/doubletake_model.yaml --dataset synthetic \
        --batch_size 16 --fast_cost_volume --run_fusion --extended_neg_truncation \
        [--device cpu]
"""

from doubletake_tpu_torch.options import OptionsHandler
from doubletake_tpu_torch.runners import offline_two_pass

if __name__ == "__main__":
    opts = OptionsHandler().parse_and_merge_options()
    offline_two_pass.run(opts)
