"""Seed discipline (counterpart of ``text_to_image_tpu/utils/prng.py``).

JAX threads keys; here a "key" is a plain integer seed, derived keys come
from `fold_in`, and a `torch.Generator` is made from a key only where random
numbers are drawn.  `torch.Generator` and `jax.random` never produce the same
numbers, so tests hand the same numpy inputs to both packages instead.
"""

from __future__ import annotations

import zlib
from typing import Dict, Tuple

import numpy as np
import torch


def fold_in(key: int, data: int) -> int:
    """A new key from (key, data): stable across processes and platforms."""
    seq = np.random.SeedSequence([int(key) % 2**63, int(data) % 2**63])
    return int(seq.generate_state(1, np.uint64)[0] % 2**63)


def split_tree(key: int, names: Tuple[str, ...]) -> Dict[str, int]:
    """Named split: a dict of independent keys, order-insensitive."""
    # crc32 (not builtin hash) so key derivation is stable across processes
    return {n: fold_in(key, zlib.crc32(n.encode()) % (2**31)) for n in names}


def generator(key: int) -> torch.Generator:
    """A CPU generator seeded from `key`.  Draw on the CPU, then move the
    result to the device: the same key gives the same numbers everywhere."""
    return torch.Generator().manual_seed(int(key))
