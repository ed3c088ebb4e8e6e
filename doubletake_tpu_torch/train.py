"""CLI: training (reference train.py interface).

    python -m doubletake_tpu_torch.train --config_file \
        configs/models/doubletake_model.yaml --dataset synthetic \
        --name my_run --log_dir runs [--device cpu]
"""

from doubletake_tpu_torch.options import OptionsHandler
from doubletake_tpu_torch.training.train_loop import train

if __name__ == "__main__":
    opts = OptionsHandler().parse_and_merge_options()
    train(opts)
