"""Train-time color augmentation, on the device.

Counterpart of ``doubletake_tpu/training/augmentation.py``, whose reference
is CustomColorJitter around kornia ColorJiggle(0.2, 0.2, 0.2, 0.2) with
denormalize -> jitter -> renormalize (utils/augmentation_utils.py:13-53).
Factors are drawn per image: brightness, contrast and saturation are
multiplicative in [0.8, 1.2], hue shifts by [-0.2, 0.2] * pi radians.

Drawing the factors (``draw_jitter``, from an explicit ``torch.Generator``)
is apart from applying them (``apply_jitter``), so that a test can apply the
factors a JAX key draws: the two frameworks' generators give different
numbers from one seed.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from doubletake_tpu_torch.utils.io import IMAGENET_MEAN, IMAGENET_STD

# ITU-R 601 luma weights (kornia rgb_to_grayscale)
_LUMA = (0.299, 0.587, 0.114)
# RGB -> YIQ rows (the hue rotation, kornia adjust_hue's equivalent)
_YIQ = ((0.299, 0.587, 0.114),
        (0.59590059, -0.27455667, -0.32134392),
        (0.21153661, -0.52273617, 0.31119955))


def draw_jitter(b: int, generator: Optional[torch.Generator] = None, strength: float = 0.2,
                device=None) -> Dict[str, torch.Tensor]:
    """Per-image factors for a batch of ``b`` images, drawn on the host:
    brightness, contrast, saturation (b, 1, 1, 1) and hue (b, 1, 1)."""
    def uniform(shape):
        return torch.rand(shape, generator=generator) * (2 * strength) - strength

    out = {"brightness": 1.0 + uniform((b, 1, 1, 1)), "contrast": 1.0 + uniform((b, 1, 1, 1)),
           "saturation": 1.0 + uniform((b, 1, 1, 1)), "hue": uniform((b, 1, 1)) * math.pi}
    return {k: v.to(device) for k, v in out.items()}


def _hue_shift(img, hue):
    """Hue rotation in YIQ space."""
    yiq = torch.tensor(_YIQ, dtype=img.dtype, device=img.device)
    y, i0, q0 = (img @ yiq[r] for r in range(3))
    c, s = torch.cos(hue), torch.sin(hue)
    i = i0 * c - q0 * s
    q = i0 * s + q0 * c
    return torch.stack([y + 0.956 * i + 0.619 * q,
                        y - 0.272 * i - 0.647 * q,
                        y - 1.106 * i + 1.703 * q], -1)


def apply_jitter(image_bhw3, factors: Dict[str, torch.Tensor]):
    """Jitter an imagenet-normalised batch (B, H, W, 3) with ``factors``."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=image_bhw3.dtype, device=image_bhw3.device)
    std = torch.tensor(IMAGENET_STD, dtype=image_bhw3.dtype, device=image_bhw3.device)
    img = image_bhw3 * std + mean                                   # denormalise
    img = img * factors["brightness"]
    mean_c = img.mean((1, 2, 3), keepdim=True)
    img = (img - mean_c) * factors["contrast"] + mean_c
    gray = (img @ torch.tensor(_LUMA, dtype=img.dtype, device=img.device))[..., None]
    img = gray + (img - gray) * factors["saturation"]
    img = _hue_shift(img, factors["hue"])
    img = torch.clamp(img, 0.0, 1.0)
    return (img - mean) / std


def color_jitter(image_bhw3, generator: Optional[torch.Generator] = None,
                 strength: float = 0.2):
    """Draw per-image factors and apply them."""
    factors = draw_jitter(image_bhw3.shape[0], generator, strength, image_bhw3.device)
    return apply_jitter(image_bhw3, factors)
