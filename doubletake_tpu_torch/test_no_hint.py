"""CLI: no-hint depth evaluation (reference test_no_hint.py).

    python -m doubletake_tpu_torch.test_no_hint --config_file \
        configs/models/simplerecon_model.yaml --dataset synthetic \
        --batch_size 16 --fast_cost_volume --run_fusion [--device cpu]
"""

from doubletake_tpu_torch.options import OptionsHandler
from doubletake_tpu_torch.runners import no_hint

if __name__ == "__main__":
    opts = OptionsHandler().parse_and_merge_options()
    no_hint.run(opts)
