"""Synthetic dataset with the TextDataset interface (numpy; a copy of
``text_to_image_tpu/data/synthetic.py``, so the same seed gives the same
data in both packages).

Used by tests and the benchmark harness (the environment has no network, so
Oxford-102/CUB can't be downloaded).  Generates class-structured fake data:
images are smooth class-colored noise, embeddings are class centroids plus
noise — enough structure that matching-aware losses and wrong-pair selection
are exercised meaningfully.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class SyntheticDataset:
    def __init__(self, num_examples: int = 256, image_size: int = 64,
                 embed_dim: int = 1024, num_classes: int = 8,
                 captions_per_image: int = 5, seed: int = 0,
                 raw_uint8: bool = True):
        self.raw_uint8 = raw_uint8  # uint8 out (device normalizes); see TextDataset
        rng = np.random.default_rng(seed)
        self.image_size = image_size
        self._num_classes = num_classes
        self.class_ids = rng.integers(0, num_classes, size=num_examples)
        centroids = rng.normal(size=(num_classes, embed_dim)).astype(np.float32)
        self.embeddings = (
            centroids[self.class_ids][:, None, :]
            + 0.1 * rng.normal(size=(num_examples, captions_per_image, embed_dim))
        ).astype(np.float32)
        colors = rng.uniform(0.2, 0.8, size=(num_classes, 3))
        noise = rng.uniform(-0.2, 0.2, size=(num_examples, image_size, image_size, 3))
        imgs = colors[self.class_ids][:, None, None, :] + noise
        self.images = (np.clip(imgs, 0, 1) * 255).astype(np.uint8)
        self._rng = np.random.default_rng(seed + 1)

    @property
    def num_examples(self) -> int:
        return len(self.images)

    @property
    def embed_dim(self) -> int:
        return int(self.embeddings.shape[-1])

    @property
    def num_classes(self) -> int:
        return self._num_classes

    def spawn(self, seed: int) -> "SyntheticDataset":
        """Shared-array view with an independent RNG (parallel workers)."""
        import copy
        clone = copy.copy(self)
        clone._rng = np.random.default_rng(seed)
        return clone

    def next_batch(self, batch_size: int, window: int = 4) -> Dict[str, np.ndarray]:
        n = self.num_examples
        idx = self._rng.integers(0, n, size=batch_size)
        # wrong image: different class, cheap rejection via roll
        wrong = self._rng.integers(0, n, size=batch_size)
        same = self.class_ids[wrong] == self.class_ids[idx]
        while same.any():
            wrong[same] = self._rng.integers(0, n, size=int(same.sum()))
            same = self.class_ids[wrong] == self.class_ids[idx]
        embs = self.embeddings[idx]
        c = embs.shape[1]
        if window < c:
            picks = self._rng.integers(0, c, size=(batch_size, window))
            embs = embs[np.arange(batch_size)[:, None], picks]
        if self.raw_uint8:
            real_out, wrong_out = self.images[idx], self.images[wrong]
        else:
            real_out = self.images[idx].astype(np.float32) / 127.5 - 1.0
            wrong_out = self.images[wrong].astype(np.float32) / 127.5 - 1.0
        return {"real": real_out, "wrong": wrong_out, "emb": embs.mean(axis=1)}

    def test_embeddings(self, n: Optional[int] = None) -> np.ndarray:
        embs = self.embeddings[:n] if n else self.embeddings
        return embs[:, 0, :]
