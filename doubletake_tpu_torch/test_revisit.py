"""CLI: revisit evaluation, hints from a first visit's volume
(reference test_revisit.py).

    python -m doubletake_tpu_torch.test_revisit --config_file \
        configs/models/doubletake_model.yaml --dataset synthetic \
        --single_debug_scan_id synth0@1 --batch_size 16 --fast_cost_volume \
        --run_fusion [--device cpu]
"""

from doubletake_tpu_torch.options import OptionsHandler
from doubletake_tpu_torch.runners import revisit

if __name__ == "__main__":
    opts = OptionsHandler().parse_and_merge_options()
    revisit.run(opts)
