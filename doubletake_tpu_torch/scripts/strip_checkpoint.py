"""Strip the optimizer state off a training state (reference
strip_checkpoint.py; the JAX package's scripts/strip_checkpoint.py).

``--src`` is a training state written by ``train()`` (``step_*.pt``) or a
weights ``.ckpt``; ``--dst`` is a reference-style ``.ckpt`` that
``--load_weights_from_checkpoint`` reads in both packages. Host code only.

    python -m doubletake_tpu_torch.scripts.strip_checkpoint \
        --src LOGS/NAME/checkpoints/step_00110000.pt --dst weights.ckpt
"""

from __future__ import annotations

import argparse

from doubletake_tpu_torch.checkpoints.io import strip_checkpoint


def main(argv=None):
    """Write ``--dst``; returns its path."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", required=True)
    parser.add_argument("--dst", required=True)
    args = parser.parse_args(argv)
    strip_checkpoint(args.src, args.dst)
    print(f"stripped {args.src} -> {args.dst}")
    return args.dst


if __name__ == "__main__":
    main()
