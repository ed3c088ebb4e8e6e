"""CLI: incremental (online) evaluation (reference test_incremental.py).

    python -m doubletake_tpu_torch.test_incremental --config_file \
        configs/models/doubletake_model.yaml --dataset synthetic \
        --fast_cost_volume --extended_neg_truncation [--device cpu]
"""

from doubletake_tpu_torch.options import OptionsHandler
from doubletake_tpu_torch.runners import incremental

if __name__ == "__main__":
    opts = OptionsHandler().parse_and_merge_options()
    incremental.run(opts)
