"""Figure-cropping helpers (reference: utils/cropping_utils.py:4-78; the
JAX package's ``utils/cropping.py``).

Used to trim white margins from exported visualization images so paper
figures line up. Vectorized (the reference scans rows/columns in Python).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def find_image_bounding_box(image: np.ndarray) -> Tuple[int, int, int, int]:
    """(left, top, bottom, right) bounds of non-white content in a uint8 image."""
    assert image.dtype == np.uint8
    fg = ~(image == 255).all(axis=2)
    rows = np.flatnonzero(fg.any(axis=1))
    cols = np.flatnonzero(fg.any(axis=0))
    if len(rows) == 0:
        return 0, 0, image.shape[0], image.shape[1]
    top, bottom = int(rows[0]), int(rows[-1]) + 1
    left, right = int(cols[0]), int(cols[-1]) + 1
    return left, top, bottom, right


def crop_to_content(image: np.ndarray, pad: int = 0) -> np.ndarray:
    """Crop white margins, optionally keeping ``pad`` pixels of margin."""
    left, top, bottom, right = find_image_bounding_box(image)
    h, w = image.shape[:2]
    top = max(0, top - pad)
    left = max(0, left - pad)
    bottom = min(h, bottom + pad)
    right = min(w, right + pad)
    return image[top:bottom, left:right]


def crop_images_to_shared_bounding_box(images) -> list:
    """Crop a set of same-size images to the union of their content boxes
    (so corresponding figure panels stay aligned)."""
    boxes = [find_image_bounding_box(im) for im in images]
    left = min(b[0] for b in boxes)
    top = min(b[1] for b in boxes)
    bottom = max(b[2] for b in boxes)
    right = max(b[3] for b in boxes)
    return [im[top:bottom, left:right] for im in images]
