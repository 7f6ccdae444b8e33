"""Image grid utilities (rebuild of the reference's ``utils/utils.py``
``save_images``/``merge``/``image_manifold_size`` — SURVEY.md §2 Misc utils;
a numpy copy of ``text_to_image_tpu/utils/images.py`` that writes its PNGs
without PIL).

Generators emit tanh-range float images; these helpers inverse-transform to
uint8, tile into manifold grids and write PNGs.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import numpy as np

from text_to_image_tpu_torch.utils.tensorboard import encode_png


def inverse_transform(images: np.ndarray) -> np.ndarray:
    """[-1, 1] float → [0, 255] uint8."""
    x = (np.asarray(images, dtype=np.float32) + 1.0) * 127.5
    return np.clip(x, 0, 255).astype(np.uint8)


def image_manifold_size(n: int) -> Tuple[int, int]:
    h = int(math.floor(math.sqrt(n)))
    while n % h != 0:
        h -= 1
    return h, n // h


def merge(images: np.ndarray, grid: Optional[Tuple[int, int]] = None
          ) -> np.ndarray:
    """Tile [N,H,W,C] into one [gh·H, gw·W, C] image."""
    n, h, w, c = images.shape
    gh, gw = grid or image_manifold_size(n)
    assert gh * gw == n, f"grid {gh}x{gw} != {n} images"
    out = np.zeros((gh * h, gw * w, c), dtype=images.dtype)
    for idx in range(n):
        i, j = divmod(idx, gw)
        out[i * h:(i + 1) * h, j * w:(j + 1) * w] = images[idx]
    return out


def save_images(images: np.ndarray, path: str,
                grid: Optional[Tuple[int, int]] = None) -> str:
    """Write a tanh-range image batch as one PNG grid (the port's own
    encoder, `utils.tensorboard.encode_png`: no image library needed)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(merge(inverse_transform(images), grid)))
    return path
