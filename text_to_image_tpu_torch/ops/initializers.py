"""Weight initializers matching the reference's TF1/DCGAN recipe
(counterpart of ``text_to_image_tpu/ops/initializers.py``): N(0, 0.02)
weights, N(1, 0.02) batch-norm scale, zero biases.  Values are drawn on the
CPU from a key (see `utils.prng`); callers move them to the device."""

from __future__ import annotations

import torch

from text_to_image_tpu_torch.utils import prng

DEFAULT_STDDEV = 0.02


def normal(key: int, shape, stddev: float = DEFAULT_STDDEV) -> torch.Tensor:
    return torch.randn(shape, generator=prng.generator(key)) * stddev


def bn_scale(key: int, shape) -> torch.Tensor:
    return 1.0 + torch.randn(shape, generator=prng.generator(key)) * 0.02


def zeros(shape) -> torch.Tensor:
    return torch.zeros(shape)
