"""Host-side IO helpers: file reading, image decode/resize, normalization.

Parity notes: PIL resize conventions follow the reference's
``read_image_file`` (utils/generic_utils.py:221-269): bilinear for color,
nearest for depth, value scale factors applied after decode; imagenet
normalization uses the standard mean/std (generic_utils.py:150-156).

PIL is imported where an image file is read, so hosts without it can run
everything that does not read images (the synthetic dataset, the runners).
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def readlines(filepath: str):
    with open(filepath) as f:
        return [line.rstrip() for line in f.readlines() if line.strip()]


def imagenet_normalize(image_hw3: np.ndarray) -> np.ndarray:
    return ((image_hw3 - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)


def reverse_imagenet_normalize(image_hw3: np.ndarray) -> np.ndarray:
    return image_hw3 * IMAGENET_STD + IMAGENET_MEAN


def copy_code_state(path: str):
    """Snapshot the port's source (the ``doubletake_tpu_torch`` package,
    kernels included) into ``path/doubletake_tpu_torch``, for reproducibility
    (reference generic_utils.py:17-34)."""
    package = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    shutil.copytree(package, os.path.join(path, os.path.basename(package)), dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))


def read_image_file(
    filepath: str,
    height: Optional[int] = None,
    width: Optional[int] = None,
    value_scale_factor: float = 1.0,
    resampling_mode: str = "bilinear",
    target_aspect_ratio: Optional[float] = None,
) -> np.ndarray:
    """Read an image to (H, W, C) float32, optionally resized and scaled.

    resampling_mode: "bilinear" (color) or "nearest" (depth, hints).
    """
    from PIL import Image

    resample = {"bilinear": Image.BILINEAR, "nearest": Image.NEAREST}[resampling_mode]
    img = Image.open(filepath)
    if target_aspect_ratio:
        img = crop_image_to_target_ratio(img, target_aspect_ratio)
    if height is not None and width is not None and img.size != (width, height):
        img = img.resize((width, height), resample=resample)
    raw = np.asarray(img)
    arr = raw.astype(np.float32)
    if raw.dtype == np.uint8:
        # torchvision to_tensor parity: 8-bit images scale to [0, 1];
        # 16/32-bit (depth pngs) keep raw values for the caller's scale factor
        arr = arr / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr * value_scale_factor


def crop_image_to_target_ratio(image, target_aspect_ratio: float = 4.0 / 3.0):
    """Center-crop a PIL image to an aspect ratio (generic_utils.py:272-301)."""
    actual = image.width / image.height
    if actual > target_aspect_ratio:
        new_width = image.height * target_aspect_ratio
        left = (image.width - new_width) / 2
        return image.crop((left, 0, (image.width + new_width) / 2, image.height))
    if actual < target_aspect_ratio:
        new_height = image.width / target_aspect_ratio
        top = (image.height - new_height) / 2
        return image.crop((0, top, image.width, (image.height + new_height) / 2))
    return image
