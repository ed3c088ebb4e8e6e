"""Checkpoint save/load: training state in torch's own format, final weights
as a reference-style ``.ckpt``.

Counterpart of ``doubletake_tpu/checkpoints/io.py`` (reference train.py:223-230
ModelCheckpoint, model_utils.py:20-68 load paths, scripts/strip_checkpoint.py):
full training-state checkpoints with resume (model, optimizer, step; the
newest ``keep`` kept), weights-only files, and stripping the optimizer off a
training state. The JAX package keeps training state with orbax, a JAX
library; the port keeps it with ``torch.save``.

Weights files are Lightning-style ``{"state_dict": ...}`` ``.ckpt`` files
under the reference's names, so the port's ``load_weights`` reads them as
they are and the JAX package's ``load_params`` converts them
(``doubletake_tpu/checkpoints/convert.py``).
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

import torch

from doubletake_tpu_torch.checkpoints.convert import load_weights

_STATE_FILE = re.compile(r"^step_(\d+)\.pt$")


def cast_floating(obj, dtype: torch.dtype):
    """Cast every floating parameter AND buffer of a module (in place; the
    module is returned) or every floating tensor of a state_dict (a new
    dict) to ``dtype``. The JAX package's ``cast_floating`` of the variables
    casts the batch statistics too (runners/common.py:84-91)."""
    if isinstance(obj, torch.nn.Module):
        return obj.to(dtype)
    return {k: v.to(dtype) if torch.is_floating_point(v) else v for k, v in obj.items()}


def save_params(path: str, state_dict: Dict[str, torch.Tensor]):
    """Write weights as a reference-style ``.ckpt`` ({"state_dict": ...}),
    on the host."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({"state_dict": {k: v.detach().cpu() for k, v in state_dict.items()}}, path)


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """A state_dict from a ``.ckpt``/``.pth`` or a JAX-package npz."""
    return load_weights(path)


def _state_files(ckpt_dir: str):
    """{step: path} of the training states in ``ckpt_dir``."""
    if not os.path.isdir(ckpt_dir):
        return {}
    return {int(m.group(1)): os.path.join(ckpt_dir, name)
            for name in os.listdir(ckpt_dir) if (m := _STATE_FILE.match(name))}


def save_train_state(ckpt_dir: str, step: int, model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer, keep: int = 2):
    """Write model, optimizer and step as ``step_{step}.pt``; keep the
    newest ``keep`` states."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step:08d}.pt")
    tmp = path + ".tmp"
    torch.save({"step": step, "model": model.state_dict(),
                "optimizer": optimizer.state_dict()}, tmp)
    os.replace(tmp, path)
    files = _state_files(ckpt_dir)
    for old in sorted(files)[:-keep]:
        os.remove(files[old])


def restore_train_state(ckpt_dir: str, model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer, step: Optional[int] = None):
    """Load the training state of ``step`` (the newest by default) into
    ``model`` and ``optimizer``; returns its step, or None when there is
    none."""
    files = _state_files(ckpt_dir)
    if not files:
        return None
    step = max(files) if step is None else step
    state = torch.load(files[step], map_location="cpu", weights_only=True)
    model.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    return int(state["step"])


def strip_checkpoint(src: str, dst: str):
    """Drop the optimizer state of a training state (or keep a weights
    file's weights): ``dst`` is a reference-style ``.ckpt``."""
    state = torch.load(src, map_location="cpu", weights_only=True)
    save_params(dst, state["model"] if "model" in state else state["state_dict"])
